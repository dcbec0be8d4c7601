"""The fused cost-head statistics: the port's plain torch version
(ops/fused_head.py) against the JAX Pallas kernel run in interpret mode
with the same injected dropout bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_predictor_params, rel_err, to_jax, to_torch
from vae_extent_search_tpu.ops.fused_head_pallas import (
    fused_head_stats as jax_fused_head_stats,
)
from vae_extent_search_tpu_torch.models.predictor import pred_encode
from vae_extent_search_tpu_torch.ops.fused_head import (
    fused_head_stats,
    fused_head_stats_plain,
)

N, D, HID, L, HP, T, RATE = 300, 24, 128, 16, 128, 6, 0.1


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = np_predictor_params(rng, D, HID, L, HP)
    x = rng.standard_normal((N, D)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (T, N, HP), dtype=np.uint32)
    return params, x, bits


# The arithmetic is the same up to summation order: 1e-5 relative to each
# output's max |ref|, float32 (the CPU backend of jax has no bf16 x bf16
# -> f32 dot for the interpret-mode kernel; the card's test holds bf16).
@pytest.mark.parametrize("fused_encoder", [False, True])
def test_plain_matches_jax_kernel(fused_encoder):
    params, x, bits = _inputs(0)
    pj, pt = to_jax(params), to_torch(params)
    if fused_encoder:
        inp, enc_j, enc_t = x, (pj["encoder"], pj["fc_mu"]), (
            pt["encoder"], pt["fc_mu"])
    else:  # head only: the input is the latent mu
        with torch.no_grad():
            inp = pred_encode(pt, torch.as_tensor(x))[0].numpy()
        enc_j = enc_t = None
    ref = jax_fused_head_stats(
        pj["cost_predictor"], jnp.asarray(inp), 0, T=T, rate=RATE,
        interpret=True, mask_bits=jnp.asarray(bits), encoder=enc_j,
        mu_layout="none")
    ref = ref[1:] if fused_encoder else ref
    with torch.no_grad():
        got = fused_head_stats_plain(
            pt["cost_predictor"], torch.as_tensor(inp), T, RATE,
            mask_bits=torch.as_tensor(bits), encoder=enc_t)
    for name, g, r in zip(("cost", "gnorm", "mc_mean", "mc_var"), got, ref):
        assert g.dtype == torch.float32 and g.shape == (N,)
        assert rel_err(g.numpy(), r) < 1e-5, (name, rel_err(g.numpy(), r))


def test_wrapper_runs_plain_on_cpu_without_counting():
    params, x, bits = _inputs(1)
    pt = to_torch(params)
    enc = (pt["encoder"], pt["fc_mu"])
    xt, bt = torch.as_tensor(x), torch.as_tensor(bits)
    before = fused_head_stats.launches
    with torch.no_grad():
        got = fused_head_stats(pt["cost_predictor"], xt, 7, T=T, rate=RATE,
                               mask_bits=bt, encoder=enc)
        ref = fused_head_stats_plain(pt["cost_predictor"], xt, T, RATE,
                                     mask_bits=bt, encoder=enc)
        # without bits the CPU path draws them from a generator seeded by
        # `seed`: same seed, same words
        a = fused_head_stats(pt["cost_predictor"], xt, 7, T=T, rate=RATE,
                             encoder=enc)
        b = fused_head_stats(pt["cost_predictor"], xt, 7, T=T, rate=RATE,
                             encoder=enc)
    assert fused_head_stats.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for g, r in zip(a, b):
        assert torch.equal(g, r)
    assert torch.equal(a[0], got[0]) and torch.equal(a[1], got[1])


def test_rate_zero_keeps_every_unit():
    """rate 0: the threshold is 0, every word keeps its unit, so all T
    passes equal the deterministic cost (variance exactly 0)."""
    params, x, bits = _inputs(2)
    pt = to_torch(params)
    with torch.no_grad():
        cost, _, mean, var = fused_head_stats_plain(
            pt["cost_predictor"], torch.as_tensor(x), T, 0.0,
            mask_bits=torch.as_tensor(bits),
            encoder=(pt["encoder"], pt["fc_mu"]))
    assert torch.equal(mean, cost)
    assert torch.count_nonzero(var) == 0
