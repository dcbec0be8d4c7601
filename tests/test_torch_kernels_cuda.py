"""The CUDA kernels of the PyTorch port against their plain torch
versions, on the card. These tests need an NVIDIA GPU and nvcc; where
there is none they skip. They import neither jax nor the JAX package,
so they also run on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from vae_extent_search_tpu_torch.convert import params_from_numpy
from vae_extent_search_tpu_torch.models.predictor import pred_encode
from vae_extent_search_tpu_torch.ops import fused_head as fh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _params(rng, d, hid, lat, hp):
    def dense(i, o):
        bw, bb = np.sqrt(3.0 / i), np.sqrt(1.0 / i)
        return {"w": rng.uniform(-bw, bw, (i, o)), "b": rng.uniform(-bb, bb, o)}
    return {"encoder": [dense(d, hid), dense(hid, hid), dense(hid, hid)],
            "fc_mu": dense(hid, lat),
            "cost_predictor": [dense(lat, hp), dense(hp, hp), dense(hp, 1)]}


def _setup(dev, n, dtype, d=24, hid=256, lat=64, hp=256, T=10, seed=0):
    rng = np.random.default_rng(seed)
    p = params_from_numpy(_params(rng, d, hid, lat, hp), dev, dtype)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                        device=dev).to(dtype)
    bits = torch.as_tensor(
        rng.integers(0, 2 ** 32, (T, n, hp), dtype=np.uint32), device=dev)
    return p, x, bits


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


# f32: same arithmetic up to summation order; bf16: a summation-order
# difference can flip one bf16 rounding of an intermediate (2^-8 relative)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fused_encoder", [True, False])
def test_fused_head_kernel_matches_plain(dev, dtype, tol, fused_encoder):
    n, T = 1000, 10  # not a multiple of the 32-candidate block
    p, x, bits = _setup(dev, n, dtype, T=T)
    head = p["cost_predictor"]
    enc = (p["encoder"], p["fc_mu"])
    if not fused_encoder:  # head only: the input is the latent mu
        with torch.no_grad():
            x = pred_encode({**p, "fc_logvar": p["fc_mu"]}, x)[0].to(dtype)
        enc = None
    before = fh.fused_head_stats.launches
    got = fh.fused_head_stats(head, x.contiguous(), 0, T=T, rate=0.1,
                              mask_bits=bits, encoder=enc)
    torch.cuda.synchronize()
    assert fh.fused_head_stats.launches == before + 1
    ref = fh.fused_head_stats_plain(head, x, T, 0.1, mask_bits=bits,
                                    encoder=enc)
    for name, g, r in zip(("cost", "gnorm", "mc_mean", "mc_var"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= tol, (name, _rel(g, r))


# the gate's shape space and its edges: minimal widths with heavy
# dropout, odd T, rate 0 (every pass equals the cost, variance exactly 0),
# a wide per-store input (D = 5 * 164), widths off every power of two, a
# head wider than one 256-column pass, and T = 1 (variance 0 by definition)
@pytest.mark.parametrize("d,hid,lat,hp,T,rate", [
    (10, 128, 8, 128, 2, 0.5), (10, 256, 64, 256, 7, 0.1),
    (10, 128, 32, 128, 11, 0.0), (820, 256, 64, 256, 10, 0.1),
    (17, 200, 10, 100, 3, 0.2), (17, 64, 16, 300, 4, 0.1),
    (17, 256, 64, 256, 1, 0.1)])
def test_fused_head_kernel_shape_grid(dev, d, hid, lat, hp, T, rate):
    n = 333
    p, x, bits = _setup(dev, n, torch.float32, d, hid, lat, hp, T, seed=3)
    enc = (p["encoder"], p["fc_mu"])
    got = fh.fused_head_stats(p["cost_predictor"], x, 0, T=T, rate=rate,
                              mask_bits=bits, encoder=enc)
    ref = fh.fused_head_stats_plain(p["cost_predictor"], x, T, rate,
                                    mask_bits=bits, encoder=enc)
    for name, g, r in zip(("cost", "gnorm", "mc_mean", "mc_var"), got, ref):
        assert _rel(g, r) <= 1e-4, (name, _rel(g, r))
    if rate == 0.0 or T == 1:
        assert torch.count_nonzero(got[3]) == 0


def test_fused_head_philox_path(dev):
    n, T, seeds = 65_536, 10, 4
    p, x, bits = _setup(dev, n, torch.float32, T=T)
    head, enc = p["cost_predictor"], (p["encoder"], p["fc_mu"])
    inj = fh.fused_head_stats(head, x, 0, T=T, mask_bits=bits, encoder=enc)
    phil = fh.fused_head_stats(head, x, 1234, T=T, encoder=enc)
    again = fh.fused_head_stats(head, x, 1234, T=T, encoder=enc)
    torch.cuda.synchronize()
    # cost and gnorm do not depend on the dropout words
    assert torch.equal(phil[0], inj[0]) and torch.equal(phil[1], inj[1])
    # the same seed gives the same words
    for a, b in zip(phil, again):
        assert torch.equal(a, b)
    k_var, k_off, r_var, r_off = 0.0, 0.0, 0.0, 0.0
    for s in range(seeds):
        k = fh.fused_head_stats(head, x, 100 + s, T=T, encoder=enc)
        gen = torch.Generator(device=dev).manual_seed(200 + s)
        r = fh.fused_head_stats_plain(head, x, T, 0.1, generator=gen,
                                      encoder=enc)
        k_var += float(k[3].mean()) / seeds
        r_var += float(r[3].mean()) / seeds
        k_off += float((k[2] - k[0]).mean()) / seeds
        r_off += float((r[2] - r[0]).mean()) / seeds
    assert abs(k_var - r_var) <= 0.05 * r_var, (k_var, r_var)
    # the mean offset mc_mean - cost carries MC noise of variance
    # var / T per candidate on each side: 4 standard errors
    se = (2 * r_var / T / (n * seeds)) ** 0.5
    assert abs(k_off - r_off) <= 4 * se, (k_off, r_off, se)


def test_fused_head_rejects_bad_inputs(dev):
    p, x, bits = _setup(dev, 64, torch.float32, T=4)
    head, enc = p["cost_predictor"], (p["encoder"], p["fc_mu"])
    with pytest.raises(ValueError):
        fh.fused_head_stats(head, x, 0, T=4, mask_bits=bits.view(torch.int32),
                            encoder=enc)
    with pytest.raises(ValueError):
        fh.fused_head_stats(head, x.to(torch.float16), 0, T=4, encoder=enc)
    with pytest.raises(ValueError):
        fh.fused_head_stats(head, x.t(), 0, T=4, encoder=enc)
