"""The headline experiment's other arms, port against the JAX package on
the CPU: the VIB predictor's loss and training, and
SelectionConfig(fused_head="off") (the initial sets and the loop's new
modes: ``tests/test_torch_arms_init.py``; the command line:
``tests/test_torch_arms_cli.py``).

Threefry and Philox never draw alike, so the VIB loss's
reparameterisation noise is injected, rebuilt from the JAX key's splits.
Tolerances: 1e-5 relative for one loss evaluation, 1e-4 for a 30-epoch
fit (see ``tests/test_torch_training.py``), exact for the selected
indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    np_predictor_params,
    rel_err,
    to_jax,
    to_torch,
    tree_rel_err,
)
from vae_extent_search_tpu.models import predictor as jp
from vae_extent_search_tpu.search import select as js
from vae_extent_search_tpu_torch.models import predictor as tp
from vae_extent_search_tpu_torch.search import select as ts

N, D, HID, LAT = 96, 17, 64, 8


# ---------------------------------------------------------------------------
# the VIB predictor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("huber", [False, True])
def test_vib_loss_matches_jax(huber, masked):
    """One evaluation of the VIB loss (sampled z, smooth-L1) with the
    JAX key's reparameterisation noise injected, no dropout and no
    smoothness noise. The labels are spread so that the delta of 0.5
    puts residuals on both sides of the smooth-L1 knee."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    params = np_predictor_params(rng, D, HID, LAT, 32)
    y = (2.0 * rng.standard_normal(N)).astype(np.float32)
    mask = rng.random(N) < 0.5 if masked else None
    cfg = tp.PredictorConfig(dropout=0.0, noise_std=0.0, stochastic_z=True,
                             huber_reg=huber, huber_delta=0.5).as_dict()
    cfg.pop("rank_warmup_epochs")
    key = jax.random.PRNGKey(7)
    tot_j, aux_j = jp.compute_total_loss(
        to_jax(params), jnp.asarray(x), jnp.asarray(y), key, cfg,
        None if mask is None else jnp.asarray(mask))
    _, _, k_z = jax.random.split(key, 3)
    eps = np.array(jax.random.normal(k_z, (N, LAT)))
    tot_t, aux_t = tp.compute_total_loss(
        to_torch(params), torch.as_tensor(x), torch.as_tensor(y),
        torch.Generator().manual_seed(0), cfg,
        None if mask is None else torch.as_tensor(mask),
        eps=torch.as_tensor(eps))
    resid = np.abs(np.asarray(aux_j["pred"]) - y)
    assert (resid < 0.5).any() and (resid > 0.5).any()
    assert rel_err(tot_t.detach().numpy(), tot_j) < 1e-5
    for k in ("reg", "pair", "smooth", "kld", "pred"):
        assert rel_err(aux_t[k].detach().numpy(), aux_j[k]) < 1e-5, k
    # the sample moved the prediction off the mean's
    cost_mu = tp.pred_forward(to_torch(params), torch.as_tensor(x))[0]
    assert rel_err(aux_t["pred"].detach().numpy(),
                   cost_mu.detach().numpy()) > 1e-4


def test_kld_beta_schedule_closed_form():
    """Linear from beta_start over the warm-up, then cosine towards 0
    floored at beta_start, at epochs 0, w - 1, w and epochs - 1."""
    beta, b0, w, epochs = 0.01, 0.002, 10, 30
    want = {
        0: b0,
        w - 1: b0 + (beta - b0) * (w - 1) / w,
        w: beta,
        epochs - 1: max(beta * 0.5 * (1 + np.cos(np.pi * (epochs - 1 - w)
                                                  / (epochs - w))), b0),
    }
    for e, v in want.items():
        assert tp.kld_beta(e, epochs, beta, b0, w) == pytest.approx(v,
                                                                    rel=1e-12)
    # the floor binds late in the decay
    assert tp.kld_beta(epochs - 1, epochs, beta, 0.005, w) == 0.005


@pytest.mark.parametrize("b0,masked", [(0.0, False), (0.005, True)])
def test_fit_predictor_vib_schedule_matches_jax(b0, masked):
    """30 epochs with the smooth-L1 term and the cosine KL warm-up
    (kld_warmup_epochs 10), no sampled z, no dropout, no noise: within
    1e-4 of the JAX scan (best parameters, best loss, every epoch's fixed
    loss). A strong KL weight makes the schedule move the run."""
    rng = np.random.default_rng(0)
    n, d = 80, 17
    params = np_predictor_params(rng, d, 32, 8, 32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x[:, :3].sum(1) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    mask = rng.random(n) < 0.6 if masked else np.ones(n, bool)
    kw = dict(dropout=0.0, noise_std=0.0, huber_reg=True, huber_delta=0.5,
              kld_cosine_warmup=True, kld_warmup_epochs=10, beta=1.0,
              kld_beta_start=b0, rank_warmup_epochs=10)
    best_j, info_j = jp.fit_predictor(
        to_jax(params), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        jax.random.PRNGKey(0), jp.PredictorConfig(**kw), 30)
    best_t, info_t = tp.fit_predictor(
        to_torch(params), torch.as_tensor(x), torch.as_tensor(y),
        torch.as_tensor(mask) if masked else None,
        torch.Generator().manual_seed(0), tp.PredictorConfig(**kw), 30)
    assert tree_rel_err(best_t, best_j) < 1e-4
    assert rel_err(info_t["best_loss"], info_j["best_loss"]) < 1e-4
    assert rel_err(info_t["losses"].numpy(), info_j["losses"]) < 1e-4
    # without the schedule the run ends elsewhere
    flat, _ = tp.fit_predictor(
        to_torch(params), torch.as_tensor(x), torch.as_tensor(y),
        torch.as_tensor(mask) if masked else None,
        torch.Generator().manual_seed(0),
        tp.PredictorConfig(**{**kw, "kld_cosine_warmup": False}), 30)
    assert tree_rel_err(flat, best_j) > 1e-3


# ---------------------------------------------------------------------------
# SelectionConfig(fused_head="off")
# ---------------------------------------------------------------------------


def test_fused_head_off_takes_the_unfused_path(monkeypatch):
    """With mask_bits given, "off" still takes the unfused path (no call
    of the fused head) and selects what JAX's "off" path selects. At
    dropout 0 neither side's MC draws move a score; w_unc > 0 runs the
    uncertainty stage."""
    n, hp, T = 400, 64, 4
    rng = np.random.default_rng(9)
    params = np_predictor_params(rng, D, HID, LAT, hp)
    x = rng.standard_normal((n, D)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (T, n, hp), dtype=np.uint32)
    used = np.zeros(n, bool)
    used[rng.choice(n, 48, replace=False)] = True
    sel = dict(num_select=24, T_mc=T, w_unc=0.3, dropout_rate=0.0,
               max_centers=128)
    calls = []
    orig = ts.fused_head_stats
    monkeypatch.setattr(ts, "fused_head_stats",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))

    def port(mode):
        with torch.no_grad():
            s, v, r, _ = ts.select_programs(
                to_torch(params), torch.as_tensor(x), torch.as_tensor(used),
                torch.as_tensor(~used), torch.Generator().manual_seed(0),
                ts.SelectionConfig(fused_head=mode, **sel),
                mask_bits=torch.as_tensor(bits))
        return s.numpy()[v.numpy()], r.numpy()

    got, rem_t = port("off")
    assert calls == []
    port("auto")
    assert calls == [1]
    sj, vj, rj, _ = js.select_programs(
        to_jax(params), jnp.asarray(x), jnp.asarray(used),
        jnp.asarray(~used), jax.random.PRNGKey(0),
        js.SelectionConfig(fused_head="off", **sel))
    assert got.tolist() == np.asarray(sj)[np.asarray(vj)].tolist()
    assert np.array_equal(rem_t, np.asarray(rj))
    assert len(got) == sel["num_select"]
