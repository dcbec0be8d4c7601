"""Model layers of the PyTorch port against the JAX package on the same
parameters and inputs (drawn with numpy): forwards and losses agree to
1e-5 relative (float32, summation order is the only difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    np_mlp,
    np_predictor_params,
    np_vae_params,
    rel_err,
    to_jax,
    to_torch,
)
from vae_extent_search_tpu.models import modules as jm
from vae_extent_search_tpu.models import predictor as jp
from vae_extent_search_tpu.models import vae as jv
from vae_extent_search_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
)
from vae_extent_search_tpu_torch.models import modules as tm
from vae_extent_search_tpu_torch.models import predictor as tp
from vae_extent_search_tpu_torch.models import vae as tv

TOL = 1e-5
N, D, HID, LAT = 96, 17, 64, 8


def _data(seed, n=N, d=D):
    rng = np.random.default_rng(seed)
    return rng, rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("final_activation", [False, True])
def test_mlp_apply(final_activation):
    rng, x = _data(0)
    layers = np_mlp(rng, [D, HID, HID, 5])
    ref = jm.mlp_apply(to_jax(layers), jnp.asarray(x), final_activation)
    got = tm.mlp_apply(to_torch(layers), torch.as_tensor(x),
                       final_activation)
    assert rel_err(got.numpy(), ref) < TOL


def test_vae_encode_and_masked_loss():
    rng, x = _data(1)
    params = np_vae_params(rng, D, LAT, HID)
    mask = rng.random(N) < 0.7
    mu_j, lv_j = jv.vae_encode(to_jax(params), jnp.asarray(x))
    mu_t, lv_t = tv.vae_encode(to_torch(params), torch.as_tensor(x))
    assert rel_err(mu_t.numpy(), mu_j) < TOL
    assert rel_err(lv_t.numpy(), lv_j) < TOL
    # deterministic=True encodes z = mu: no sampling on either side
    for beta in (0.0, 0.01):
        tot_j, (rec_j, kld_j) = jv.masked_vae_loss(
            to_jax(params), jnp.asarray(x), jnp.asarray(mask), None, beta,
            1.0, deterministic=True)
        tot_t, (rec_t, kld_t) = tv.masked_vae_loss(
            to_torch(params), torch.as_tensor(x), torch.as_tensor(mask),
            None, beta, 1.0, deterministic=True)
        for g, r in ((tot_t, tot_j), (rec_t, rec_j), (kld_t, kld_j)):
            assert rel_err(g.numpy(), r) < TOL


def test_pred_forward():
    rng, x = _data(2)
    params = np_predictor_params(rng, D, HID, LAT, 32)
    ref = jp.pred_forward(to_jax(params), jnp.asarray(x))
    got = tp.pred_forward(to_torch(params), torch.as_tensor(x))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel_err(g.numpy(), r) < TOL


@pytest.mark.parametrize("masked", [False, True])
def test_pair_loss(masked):
    rng = np.random.default_rng(3)
    pred = rng.standard_normal(50).astype(np.float32)
    true = rng.standard_normal(50).astype(np.float32)
    true[10:20] = true[0]  # equal labels: sign 0 pairs
    mask = rng.random(50) < 0.6 if masked else None
    ref = jp.pair_loss(jnp.asarray(pred), jnp.asarray(true), 0.1,
                       None if mask is None else jnp.asarray(mask))
    got = tp.pair_loss(torch.as_tensor(pred), torch.as_tensor(true), 0.1,
                       None if mask is None else torch.as_tensor(mask))
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("masked", [False, True])
def test_compute_total_loss(masked):
    """dropout 0 and noise_std 0 make the loss deterministic (the smooth
    term is exactly 0 on both sides)."""
    rng, x = _data(4)
    params = np_predictor_params(rng, D, HID, LAT, 32)
    y = rng.standard_normal(N).astype(np.float32)
    mask = rng.random(N) < 0.5 if masked else None
    cfg = tp.PredictorConfig(dropout=0.0, noise_std=0.0).as_dict()
    cfg.pop("rank_warmup_epochs")
    tot_j, aux_j = jp.compute_total_loss(
        to_jax(params), jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0), cfg,
        None if mask is None else jnp.asarray(mask))
    tot_t, aux_t = tp.compute_total_loss(
        to_torch(params), torch.as_tensor(x), torch.as_tensor(y),
        torch.Generator().manual_seed(0), cfg,
        None if mask is None else torch.as_tensor(mask))
    assert rel_err(tot_t.detach().numpy(), tot_j) < TOL
    for k in ("reg", "pair", "smooth", "kld", "pred"):
        assert rel_err(aux_t[k].detach().numpy(), aux_j[k]) < TOL, k


def test_dense_init_bounds_and_generators():
    """torch.nn.Linear default bounds; numpy and torch draws both land
    inside them, and a Generator seed fixes the draw."""
    for gen in (np.random.default_rng(0), torch.Generator().manual_seed(0)):
        layer = tm.dense_init(gen, 16, 32)
        assert layer["w"].shape == (16, 32) and layer["b"].shape == (32,)
        assert float(layer["w"].abs().max()) <= np.sqrt(3.0 / 16)
        assert float(layer["b"].abs().max()) <= np.sqrt(1.0 / 16)
    a = tm.dense_init(torch.Generator().manual_seed(5), 8, 8)
    b = tm.dense_init(torch.Generator().manual_seed(5), 8, 8)
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_params_round_trip_keeps_the_jax_layout():
    params = np_predictor_params(np.random.default_rng(5), D, HID, LAT, 32)
    pt = params_from_numpy(params, "cpu")
    assert pt["encoder"][0]["w"].shape == (D, HID)  # [in, out]
    back = params_to_numpy(pt)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
