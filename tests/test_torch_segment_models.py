"""The per-store MLP cost model of the PyTorch port against the JAX
package (``models/segment.py``, first half): forward, the four ranking
losses and their gradients, the batch loader, one optimiser step, a short
fit, prediction, and the pickles both ways. Inputs and parameters are
drawn with numpy from a seed and handed to both packages; on the CPU the
port sums segments with its plain version.

Tolerances (relative to the largest reference value): 1e-5 for forwards and
losses (float32, sums in another order); 1e-4 for gradients of the pairwise
losses (n^2 terms) and for a short fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    np_segment_mlp_params,
    ragged_programs,
    rel_err,
    to_jax,
    to_torch,
    tree_rel_err,
)
from vae_extent_search_tpu.models import segment as js
from vae_extent_search_tpu_torch.models import segment as ts
from vae_extent_search_tpu_torch.ops.segment_sum import segment_ids_to_offsets

TOL = 1e-5
GRAD_TOL = 1e-4
LOSSES = ["rmse", "rankNet", "lambdaRank", "listNet"]


def flat_batch(rng, n_seg, dim, pad_rows=5):
    counts = rng.integers(0, 6, n_seg)
    ids = np.concatenate([np.repeat(np.arange(n_seg), counts),
                          np.full(pad_rows, n_seg)]).astype(np.int32)
    feats = rng.random((len(ids), dim)).astype(np.float32)
    feats[len(ids) - pad_rows:] = 0
    return feats, ids


@pytest.mark.parametrize("add_sigmoid", [False, True])
def test_segment_mlp_forward_matches_jax(add_sigmoid):
    rng = np.random.default_rng(0)
    params = np_segment_mlp_params(rng, 20, 32)
    feats, ids = flat_batch(rng, 24, 20)
    ref = js.segment_mlp_forward(to_jax(params), jnp.asarray(feats),
                                 jnp.asarray(ids), 24, add_sigmoid)
    offs = torch.as_tensor(segment_ids_to_offsets(ids, 24))
    for o in (offs, None):
        got = ts.segment_mlp_forward(to_torch(params), torch.as_tensor(feats),
                                     torch.as_tensor(ids), 24, add_sigmoid,
                                     offsets=o)
        assert got.shape == (24,)
        assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_gradient_match_jax(name, masked):
    rng = np.random.default_rng(1)
    n = 48
    # no ties among the predictions: lambdaRank sorts them
    preds = rng.permutation(n).astype(np.float32) * 0.07 - 1.0
    labels = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.7 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    ref, gref = jax.value_and_grad(js.LOSS_FNS[name])(
        jnp.asarray(preds), jnp.asarray(labels), jmask)
    p = torch.as_tensor(preds).requires_grad_(True)
    got = ts.LOSS_FNS[name](p, torch.as_tensor(labels),
                            None if mask is None else torch.as_tensor(mask))
    got.backward()
    assert rel_err(got.item(), ref) < TOL
    assert rel_err(p.grad.numpy(), gref) < GRAD_TOL
    if masked:
        assert not p.grad[~torch.as_tensor(mask)].any()


@pytest.mark.parametrize("form", ["list", "stacked", "stacked-bf16",
                                  "list-shuffled"])
def test_make_segment_batches_equal(form):
    rng = np.random.default_rng(2)
    feats = ragged_programs(rng, 150, 10, 0, 8)
    y = rng.random(150).astype(np.float32)
    norm = js.compute_fea_norm_vec(feats)
    kw = dict(stacked=form.startswith("stacked"))
    jkw, tkw = dict(kw), dict(kw)
    if form == "stacked-bf16":
        import ml_dtypes

        jkw["feature_dtype"] = ml_dtypes.bfloat16
        tkw["feature_dtype"] = torch.bfloat16
    if form == "list-shuffled":
        jkw["shuffle_rng"] = np.random.default_rng(9)
        tkw["shuffle_rng"] = np.random.default_rng(9)
    ref = js.make_segment_batches(feats, y, 64, norm, **jkw)
    got = ts.make_segment_batches(feats, y, 64, norm, **tkw)
    if kw["stacked"]:
        assert isinstance(got, ts.SegmentBatch)
        ref, got = [ref], [got]
    assert len(ref) == len(got) == (1 if kw["stacked"] else 3)
    for r, g in zip(ref, got):
        for f in js.SegmentBatch._fields:
            a, b = np.asarray(getattr(r, f)), getattr(g, f)
            if b.dtype == torch.bfloat16:
                a, b = a.astype(np.float32), b.float()
            assert a.dtype == b.numpy().dtype, f
            assert np.array_equal(a, b.numpy()), f
        # the offsets carried beside the ids describe the same segments
        ids = g.segment_ids.numpy().reshape(-1, g.segment_ids.shape[-1])
        offs = g.offsets.numpy().reshape(len(ids), -1)
        assert g.offsets.dtype == torch.int32 and offs.shape[1] == 65
        for i, o in zip(ids, offs):
            assert np.array_equal(o, segment_ids_to_offsets(i, 64))


def test_make_segment_batches_edge_cases():
    assert ts.make_segment_batches([], [], 8) == []
    # programs without rows, and a last batch shorter than the others
    feats = [np.zeros((0, 4), np.float32), np.ones((3, 4), np.float32),
             np.zeros((0, 4), np.float32)]
    (b0, b1) = ts.make_segment_batches(feats, [1.0, 2.0, 3.0], 2)
    assert b0.offsets.tolist() == [0, 0, 3] and b1.offsets.tolist() == [0, 0, 0]
    assert b1.valid.tolist() == [True, False]
    assert b0.segment_ids.tolist() == [1, 1, 1]
    assert b1.segment_ids.tolist() == [2, 2, 2]


def test_compute_fea_norm_vec_equal():
    rng = np.random.default_rng(3)
    feats = ragged_programs(rng, 40, 12, 0, 6, scale=5.0)
    for f in feats:
        f[:, 3] = 0.0
        f[:, 5] *= -1
    ref = js.compute_fea_norm_vec(feats)
    got = ts.compute_fea_norm_vec(feats)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert got[3] == 1.0


def _models(loss, params, **kw):
    """The JAX model and the port's, from the same numpy parameters."""
    jm = js.MLPModelInternal(in_dim=10, hidden_dim=24, loss_type=loss,
                             batch_size=64, fit_mode="host", **kw)
    tm = ts.MLPModelInternal(in_dim=10, hidden_dim=24, loss_type=loss,
                             batch_size=64, fit_mode="host", device="cpu",
                             **kw)
    jm.params, tm.params = to_jax(params), to_torch(params)
    return jm, tm


@pytest.mark.parametrize("loss", LOSSES)
def test_one_optimiser_step_equal(loss):
    """Global-norm clip at 0.5, then Adam at 7e-4: one step from the same
    parameters on the same batch."""
    rng = np.random.default_rng(4)
    params = np_segment_mlp_params(rng, 10, 24)
    feats = ragged_programs(rng, 64, 10)
    y = rng.random(64).astype(np.float32)
    jm, tm = _models(loss, params, n_epoch=1)
    (jb,) = js.make_segment_batches(feats, y, 64)
    tb = ts.make_segment_batches(feats, y, 64, stacked=True)
    optimizer, step = jm._make_step()
    jp, _, jl = step(jm.params, optimizer.init(jm.params), jb)
    tm._fit(tb)
    assert tm.fit_info["steps"] == 1
    assert rel_err(tm.fit_info["best_val"], jl) < TOL
    got = jax.tree_util.tree_map(lambda t: t.numpy(), tm.params)
    ref = jax.tree_util.tree_map(np.asarray, jp)
    # Adam's first step is lr * g / (|g| + 1e-8): it moves every weight by
    # ~lr, whatever the gradient's size, so an element whose gradient is
    # rounding noise (~1e-9; the decoder bias under the shift-invariant
    # rank losses, weights behind nearly dead units) steps by another
    # amount in each framework. Hold the typical element tightly and the
    # worst one to two steps.
    if loss != "rmse":
        got["decoder"]["b"] = ref["decoder"]["b"] = params["decoder"]["b"]
    for a, b, p0 in zip(*(jax.tree_util.tree_leaves(t)
                          for t in (got, ref, params))):
        diff = np.abs((a - p0) - (b - p0))
        assert np.median(diff) < 1e-3 * tm.lr
        assert diff.max() <= 2.001 * tm.lr
    if loss == "rmse":
        assert tree_rel_err(got, ref) < TOL


@pytest.mark.parametrize("loss", ["lambdaRank", "rmse"])
def test_fit_host_and_scan_agree_and_match_jax(loss):
    """As tests/test_models.py::test_mlp_scan_fit_matches_host_loop: the
    port's one device-resident loop, under either mode's name, follows the
    JAX per-batch fit from the same parameters (same batches, same
    optimiser sequence, same early-stop selection; an instance whose
    trajectories stay together, see tests/test_torch_training.py)."""
    rng = np.random.default_rng(5)
    params = np_segment_mlp_params(rng, 10, 24)
    feats = ragged_programs(rng, 200, 10, 2, 8)
    y = np.asarray([f.sum() * 0.05 for f in feats], np.float32)
    jm, host = _models(loss, params, n_epoch=12)
    _, scan = _models(loss, params, n_epoch=12)
    scan.fit_mode = "scan"
    jm.fit_base(feats, y)
    host.fit_base(feats, y)
    scan.fit_base(feats, y)
    assert host.fit_info["steps"] == scan.fit_info["steps"] >= 6 * 3
    assert host.fit_info["val_history"] == scan.fit_info["val_history"]
    ph, ps = host.predict_on_features(feats), scan.predict_on_features(feats)
    assert np.array_equal(ph, ps)
    pj = jm.predict_on_features(feats)
    got = jax.tree_util.tree_map(lambda t: t.numpy(), host.params)
    ref = jax.tree_util.tree_map(np.asarray, jm.params)
    if loss != "rmse":
        # a rank loss ignores a shift of every prediction: the decoder bias
        # drifts on rounding noise alone (see the one-step test), so it and
        # the predictions' common offset are left out
        got["decoder"]["b"] = ref["decoder"]["b"]
        ph, pj = ph - ph.mean(), pj - pj.mean()
    assert rel_err(ph, pj) < GRAD_TOL
    # lambdaRank's gradients are small next to their rounding noise on many
    # weights, and Adam steps by g / |g|: over ten seeds the parameters end
    # 1e-4 to 1.5e-3 apart (rmse: under 3e-5) while the predictions agree
    assert tree_rel_err(got, ref) < (GRAD_TOL if loss == "rmse" else 2e-3)
    assert np.array_equal(host.fea_norm_vec, jm.fea_norm_vec)


def test_fit_early_stop_and_bf16_storage():
    rng = np.random.default_rng(6)
    feats = ragged_programs(rng, 120, 10, 2, 8)
    y = rng.random(120).astype(np.float32)
    # lr 0 never improves after the first epoch: stops at the patience
    m = ts.MLPModelInternal(in_dim=10, hidden_dim=16, n_epoch=60, lr=0.0,
                            batch_size=64, fit_mode="scan", device="cpu")
    m.fit_base(feats, y)
    assert m.fit_info["epochs"] == 1 + max(5, 60 // 6)
    # bf16 storage ranks like f32 storage
    norm = ts.compute_fea_norm_vec(feats)
    preds = []
    for dtype in ("float32", "bfloat16"):
        m = ts.MLPModelInternal(in_dim=10, hidden_dim=16, n_epoch=10,
                                batch_size=64, device="cpu")
        m.fea_norm_vec = norm
        m.params = ts.init_segment_mlp_params(
            torch.Generator().manual_seed(0), 10, 16)
        stack = ts.make_segment_batches(feats, y, 64, norm, stacked=True,
                                        feature_dtype=dtype)
        assert str(stack.features.dtype) == "torch." + dtype
        preds.append(m._fit(stack).predict_on_features(feats))
    pa, pb = preds
    assert np.corrcoef(pa, pb)[0, 1] > 0.99


def test_predict_on_features_matches_jax_with_invalid_rows():
    rng = np.random.default_rng(7)
    params = np_segment_mlp_params(rng, 10, 24)
    feats = ragged_programs(rng, 150, 10)
    feats[3] = np.zeros((2, 10), np.float32)       # unlowerable state
    feats[140] = np.zeros((0, 10), np.float32)     # no rows at all
    jm, tm = _models("lambdaRank", params)
    jm.fea_norm_vec = tm.fea_norm_vec = js.compute_fea_norm_vec(feats)
    ref, got = jm.predict_on_features(feats), tm.predict_on_features(feats)
    assert got.dtype == np.float32 and got.shape == (150,)
    assert got[3] == got[140] == -np.inf and ref[3] == -np.inf
    ok = np.isfinite(ref)
    assert ok.sum() == 148 and rel_err(got[ok], ref[ok]) < TOL
    assert tm.predict_on_features([]).shape == (0,)
    # the workload-embedding columns do not decide validity
    tm.use_workload_embedding, tm.workload_embed_total_dim = True, 4
    emb = np.concatenate([np.zeros((2, 6), np.float32),
                          np.ones((2, 4), np.float32)], 1)
    assert tm.predict_on_features([emb])[0] == -np.inf


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_pickle_crosses_packages(direction, tmp_path):
    rng = np.random.default_rng(8)
    params = np_segment_mlp_params(rng, 10, 24)
    feats = ragged_programs(rng, 70, 10)
    jm, tm = _models("rmse", params)
    jm.fea_norm_vec = tm.fea_norm_vec = js.compute_fea_norm_vec(feats)
    src, dst_cls, kw = ((jm, ts.MLPModelInternal, {"device": "cpu"})
                        if direction == "jax_to_torch"
                        else (tm, js.MLPModelInternal, {}))
    src.use_workload_embedding, src.workload_embed_total_dim = True, 2
    path = str(tmp_path / "mlp.pkl")
    src.save(path)
    loaded = dst_cls.load(path, **kw)
    assert loaded.use_workload_embedding
    assert loaded.workload_embed_total_dim == 2
    assert loaded.loss_type == "rmse" and loaded.hidden_dim == 24
    assert rel_err(loaded.predict_on_features(feats),
                   src.predict_on_features(feats)) < TOL
    # the blob holds numpy arrays only
    import pickle

    with open(path, "rb") as f:
        blob = pickle.load(f)
    leaves = jax.tree_util.tree_leaves(blob["params"])
    assert leaves and all(type(a) is np.ndarray for a in leaves)


def test_fit_checkpoint_resume(tmp_path):
    """As tests/test_models.py::test_fit_checkpoint_resume: the snapshot
    written mid-fit loads and predicts; the last write is the fitted
    model. The generic loader takes it too."""
    from vae_extent_search_tpu_torch.models import load_model_pickle

    rng = np.random.default_rng(9)
    feats = ragged_programs(rng, 12, 20, 4, 5)
    y = rng.random(12).astype(np.float32)
    m = ts.MLPModelInternal(in_dim=20, hidden_dim=16, n_epoch=6,
                            device="cpu")
    ckpt = str(tmp_path / "tmp_mlp.pkl")
    m.fit_base(feats, y, checkpoint_path=ckpt, checkpoint_every=2)
    m2 = load_model_pickle(ckpt, device="cpu")
    assert isinstance(m2, ts.MLPModelInternal)
    preds = m2.predict_on_features(feats)
    assert preds.shape == (12,) and np.isfinite(preds).all()
    assert tree_rel_err(m2.params, jax.tree_util.tree_map(
        lambda t: t.numpy(), m.params)) == 0.0
    # keep_norm reuses the scaling; a refit starts from the loaded weights
    norm = m2.fea_norm_vec.copy()
    m2.fit_base([f * 3 for f in feats], y, keep_norm=True)
    assert np.array_equal(m2.fea_norm_vec, norm)


def test_fit_mode_and_device_rules():
    rng = np.random.default_rng(10)
    feats = ragged_programs(rng, 10, 6)
    y = rng.random(10).astype(np.float32)
    m = ts.MLPModelInternal(in_dim=6, hidden_dim=8, n_epoch=2, device="cpu")
    assert m.fit_mode == "auto"
    assert m.fit_base(feats, y).fit_info["epochs"] == 2
    with pytest.raises(ValueError):
        ts.MLPModelInternal(fit_mode="jit")
    with pytest.raises(ValueError):
        ts.MLPModelInternal(loss_type="hinge")
    if not torch.cuda.is_available():
        # the default device is CUDA and is never swapped for the CPU
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            ts.MLPModelInternal(in_dim=6, hidden_dim=8).fit_base(feats, y)


def test_rmse_fit_stalls_on_the_dense_synthetic_corpus_in_both_packages():
    """On ``make_segment_corpus`` (dense uniform features, 4-23 rows per
    program) at the full hidden width the summed hidden rows drive the
    sigmoid head to ~0 within the first steps: its gradient vanishes and the
    rmse fit stalls at the labels' root mean square, in the JAX package as
    in the port, each from its own initialisation. The rank loss, which has
    no sigmoid, orders the same corpus in both."""
    from vae_extent_search_tpu_torch.data.segment_corpus import (
        make_segment_corpus,
    )

    feats, y = make_segment_corpus(600, 164, seed=0)
    kw = dict(in_dim=164, hidden_dim=256, batch_size=512, n_epoch=8)
    flat = float(np.sqrt(np.mean(y ** 2)))
    for loss in ("rmse", "lambdaRank"):
        jm = js.MLPModelInternal(loss_type=loss, **kw).fit_base(feats, y)
        tm = ts.MLPModelInternal(loss_type=loss, device="cpu",
                                 **kw).fit_base(feats, y)
        pj, pt = jm.predict_on_features(feats), tm.predict_on_features(feats)
        if loss == "rmse":
            hist = tm.fit_info["val_history"]
            assert max(hist) - min(hist) < 1e-5          # never moves
            for p in (pj, pt):
                # saturated at 0: the fit sits at the labels' rms, 1e-4
                assert np.median(p) < 1e-6 and p.max() < 0.05
                assert abs(np.sqrt(np.mean((p - y) ** 2)) - flat) < 1e-4
                assert np.corrcoef(p, y)[0, 1] < 0
        else:
            for p in (pj, pt):
                assert np.corrcoef(p, y)[0, 1] > 0.99
