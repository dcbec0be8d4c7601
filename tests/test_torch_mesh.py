"""The port's mesh layer (``parallel/mesh.py``) against the JAX package's
(``parallel/mesh.py``) and against the port's single-device functions.

The sharded predictor step on a (data 2, model 2) mesh of four gloo ranks
agrees in loss and parameters with the JAX step on a (data 2, model 2)
mesh of the conftest's CPU devices, from the same numpy parameters, within
1e-5 (dropout and the smoothness noise off, so that both are
deterministic), and with the port's single-device step with them on. The
sharded scoring agrees with JAX's and with the single-device functions
within 1e-5; the active search on a 2-rank mesh finds the optimum, with
the same result on every rank."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mh import run_ranks
from _torch_parity import np_predictor_params, to_jax, to_torch
from vae_extent_search_tpu.models import predictor as jp
from vae_extent_search_tpu.parallel import mesh as jmesh
from vae_extent_search_tpu_torch.convert import (
    clone_params,
    params_to_numpy,
    tree_leaves,
)
from vae_extent_search_tpu_torch.models import predictor as tp
from vae_extent_search_tpu_torch.parallel import mesh as tmesh
from vae_extent_search_tpu_torch.search.select import z_grad_norms

TOL = 1e-5
N, D, HID, LAT, HP = 64, 12, 32, 8, 16
STEPS = 3
DETERMINISTIC = dict(dropout=0.0, noise_std=0.0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(params=np_predictor_params(rng, D, HID, LAT, HP),
                X=rng.standard_normal((N, D)).astype(np.float32),
                y=rng.standard_normal(N).astype(np.float32),
                mask=rng.random(N) < 0.8)


def _single_steps(data, cfg_kw, seed=5):
    """The port's single-device step, STEPS times: (losses, params)."""
    cfg = tp.PredictorConfig(**cfg_kw)
    params = clone_params(to_torch(data["params"]), requires_grad=True)
    opt = tp.make_predictor_optimizer(params, cfg.encoder_lr, cfg.head_lr,
                                      cfg.weight_decay)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for _ in range(STEPS):
        loss, _ = tp.compute_total_loss(
            params, torch.as_tensor(data["X"]), torch.as_tensor(data["y"]),
            gen, cfg.as_dict(), torch.as_tensor(data["mask"]))
        opt.zero_grad()
        loss.backward()
        tp.clip_by_global_norm_([t.grad for t in tree_leaves(params)],
                                cfg.grad_clip)
        opt.step()
        losses.append(float(loss.detach()))
    return losses, params_to_numpy(params)


def _jax_steps(data, cfg_kw):
    mesh = jmesh.make_mesh(4, data=2, model=2)
    step, init_opt = jmesh.make_sharded_train_step(
        mesh, jp.PredictorConfig(**cfg_kw))
    params = to_jax(data["params"])
    opt = init_opt(params)
    losses = []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(data["X"]),
                                 jnp.asarray(data["y"]),
                                 jnp.asarray(data["mask"]),
                                 jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.fixture(scope="module")
def sharded_steps(data, tmp_path_factory):
    """{(cfg name, data, model): every rank's (losses, params)}."""
    d = str(tmp_path_factory.mktemp("mesh"))
    out = {}
    for name, cfg_kw in (("deterministic", DETERMINISTIC), ("default", {})):
        for dm in ((2, 2), (2, 1)):
            out[(name,) + dm] = run_ranks(
                "train_step", dict(data, config=cfg_kw, steps=STEPS, seed=5,
                                   data=dm[0], model=dm[1]),
                dm[0] * dm[1], d)
    return out


@pytest.mark.parametrize("dm", [(2, 2), (2, 1)], ids=["d2m2", "d2m1"])
@pytest.mark.parametrize("cfg", ["deterministic", "default"])
def test_sharded_step_matches_single_device(data, sharded_steps, cfg, dm):
    """Every rank ends with the same parameters, equal to the
    single-device step's within 1e-5 (the same Generator draws, per row)."""
    ranks = sharded_steps[(cfg,) + dm]
    for r in ranks[1:]:
        assert _max_diff(r["params"], ranks[0]["params"]) == 0.0
        assert r["losses"] == ranks[0]["losses"]
    losses, params = _single_steps(
        data, DETERMINISTIC if cfg == "deterministic" else {})
    np.testing.assert_allclose(ranks[0]["losses"], losses, atol=TOL)
    assert _max_diff(ranks[0]["params"], params) < TOL


def test_sharded_step_matches_jax(data, sharded_steps):
    losses, params = _jax_steps(data, DETERMINISTIC)
    got = sharded_steps[("deterministic", 2, 2)][0]
    np.testing.assert_allclose(got["losses"], losses, atol=TOL)
    assert _max_diff(got["params"], params) < TOL


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_score_candidates(data, tmp_path, world):
    """cost, z-gradient norm and mu equal JAX's score within 1e-5; all
    four equal the single-device functions with the same Generator (each
    row's MC masks are its rows of the global draw)."""
    T, rate = 6, 0.1
    ranks = run_ranks("score", dict(params=data["params"], X=data["X"], T=T,
                                    rate=rate, seed=9, data=world),
                      world, str(tmp_path))
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(r, ranks[0]))
    cost, gnorm, mc_var, mu = ranks[0]
    jmesh_ = jmesh.make_mesh(world, data=world, model=1)
    jc, jg, jv, jmu = jmesh.sharded_score_candidates(jmesh_)(
        to_jax(data["params"]), jnp.asarray(data["X"]),
        jax.random.PRNGKey(0), T)
    for got, want in ((cost, jc), (gnorm, jg), (mu, jmu)):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    assert jv.shape == mc_var.shape and np.isfinite(mc_var).all()
    params = to_torch(data["params"])
    X = torch.as_tensor(data["X"])
    with torch.no_grad():
        m, _ = tp.pred_encode(params, X)
        _, v = tp.mc_predict(params, X, torch.Generator().manual_seed(9), T,
                             rate, mu=m)
    for got, want in ((cost, tp.predict_cost(params, m).detach()),
                      (gnorm, z_grad_norms(params, m)), (mu, m),
                      (mc_var, v)):
        np.testing.assert_allclose(got, want.numpy(), atol=TOL)


def test_one_rank_mesh_collectives():
    """Without a process group a mesh has one rank: every collective is
    the identity and a shard is the whole batch."""
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.world == 1
    x = torch.arange(12.0).view(6, 2)
    assert torch.equal(tmesh.shard_batch(x, mesh), x)
    assert torch.equal(tmesh.all_reduce(x, mesh), x)
    assert torch.equal(tmesh.all_gather(x, mesh)[0], x)
    assert np.array_equal(tmesh.host(x, mesh), x.numpy())
    assert tmesh.digest({"a": x}, mesh)
    with pytest.raises(ValueError):
        tmesh.make_mesh(data=2, device="cpu")


def test_param_sharding_matches_jax(data):
    """The same leaves split over "model", along the same dimension."""
    jm = jmesh.make_mesh(8, data=4, model=2)
    specs = jax.tree_util.tree_leaves(
        jmesh.param_sharding(to_jax(data["params"]), jm),
        is_leaf=lambda s: hasattr(s, "spec"))
    want = [None if all(a is None for a in s.spec) else
            [i for i, a in enumerate(s.spec) if a == "model"][0]
            for s in specs]
    got = tree_leaves(tmesh.param_sharding(
        to_torch(data["params"]), SimpleNamespace(shape={"model": 2})))
    # both trees list leaves in sorted-key order
    assert [g for g in got] == want
    assert want.count(None) >= 2 and 1 in want and 0 in want


def test_active_search_on_two_rank_mesh(tmp_path):
    """JAX ``tests/test_pipeline.py::test_active_search_on_device_mesh``'s
    search, on a 2-rank data mesh: it finds the optimum, and every rank
    returns the same result."""
    rng = np.random.default_rng(0)
    n, d = 512, 16
    feats = rng.integers(1, 64, (n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    labels = (feats @ w / d).astype(np.float32)
    kw = dict(measure_size=48, max_phases=8, vae_epochs=40, reg_epochs=60,
              sampling_seed=3)
    ranks = run_ranks("search", dict(feats=feats, labels=labels, kw=kw), 2,
                      str(tmp_path))
    assert ranks[0] == ranks[1]
    assert ranks[0]["found"], ranks[0]
    sel = ranks[0]["selected_order"]
    assert len(set(sel)) == len(sel) and all(0 <= i < n for i in sel)
