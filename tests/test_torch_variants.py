"""The port's sequence cost models (models/variants.py: the LSTM, the MHA,
TabNet with its entmax / sparsemax masks and ghost batch norm, and their
SequenceModelInternal) against the JAX package on the CPU, at small
widths (hidden 16, T <= 6, a handful of programs). Parameters cross as
numpy through convert.py. Tolerances are stated per test: 1e-6 for the
masks and their gradients, 1e-5 for the forward passes, the training
steps and the loaded pickles.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads per worker)
from vae_extent_search_tpu.models import variants as jv
from vae_extent_search_tpu_torch.cli import make_dataset, train_model
from vae_extent_search_tpu_torch.convert import (
    params_to_numpy,
    tree_map,
    variant_from_numpy,
    variant_to_numpy,
)
from vae_extent_search_tpu_torch.models import load_model_pickle
from vae_extent_search_tpu_torch.models import variants as tv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET18 = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")
D, H = 12, 16
ARCHS = ("lstm", "mha", "tabnet")


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_trees_close(got, ref, tol):
    g, r = leaves(got), leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def programs(seed, n=7, t_max=6, d=D):
    """Ragged programs of 1..t_max rows, one all-zero program (scored
    -inf) and non-negative features, as per-store rows are."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(0, 3, (int(rng.integers(1, t_max + 1)), d))
           .astype(np.float32) for _ in range(n)]
    out[2] = np.zeros((3, d), np.float32)
    return out, rng.uniform(0.1, 1.0, n).astype(np.float32)


def padded(seed, S=5, T=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(S, T, D)).astype(np.float32)
    mask = np.zeros((S, T), bool)
    for i, n in enumerate([6, 3, 1, 5, 0][:S]):
        mask[i, :n] = True            # the last program has no row
    return feats, mask


# ---------------------------------------------------------------------------
# the masks: values and gradients within 1e-6
# ---------------------------------------------------------------------------

def _mask_inputs(case):
    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, 9)).astype(np.float32)
    if case == "ties":
        z[0, :4] = 1.25               # four equal leaders
        z[1] = np.round(z[1])         # many ties across the row
        z[2, ::2] = -0.5
    elif case == "one_support":
        z[:, 0] = 40.0                # a single element carries the mass
    elif case == "wide":
        z = rng.normal(size=(3, 64)).astype(np.float32) * 4
    return z


@pytest.mark.parametrize("case", ["random", "ties", "one_support", "wide"])
@pytest.mark.parametrize("fn", ["sparsemax", "entmax15"])
def test_mask_values_and_gradients(fn, case):
    z = _mask_inputs(case)
    w = np.random.default_rng(4).normal(size=z.shape).astype(np.float32)
    jf, tf = getattr(jv, fn), getattr(tv, fn)
    ref = np.asarray(jf(jnp.asarray(z)))
    gref = np.asarray(jax.grad(lambda x: (jf(x) * w).sum())(jnp.asarray(z)))
    zt = torch.as_tensor(z).requires_grad_(True)
    got = tf(zt)
    (got * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), gref, atol=1e-6)
    np.testing.assert_allclose(got.detach().sum(-1).numpy(), 1.0, atol=1e-6)
    assert np.isfinite(zt.grad.numpy()).all()
    if case == "one_support":
        assert (got.detach()[:, 1:] == 0).all()
    # along another axis
    np.testing.assert_allclose(tf(torch.as_tensor(z.T), dim=0).numpy(),
                               np.asarray(jf(jnp.asarray(z.T), axis=0)),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# ghost batch norm: train and eval, the tail chunk, the running statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("vb", [8, 1 << 30], ids=["vb8", "one_batch"])
def test_ghost_batch_norm(training, vb):
    """21 rows in virtual batches of 8 (the tail chunk of 5 padded with the
    batch mean) or in one; momentum 0.02 and 0.01. Within 1e-5."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(21, 10)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2, 10).astype(np.float32),
         "bias": rng.normal(size=10).astype(np.float32)}
    st = {"mean": rng.normal(size=10).astype(np.float32),
          "var": rng.uniform(0.5, 2, 10).astype(np.float32)}
    mom = 0.02 if vb == 8 else 0.01
    jy, jst = jv._gbn_apply(jax.tree_util.tree_map(jnp.asarray, p),
                            jax.tree_util.tree_map(jnp.asarray, st),
                            jnp.asarray(x), training, momentum=mom,
                            virtual_batch=vb)
    tp, tst = variant_from_numpy(p)[0], variant_from_numpy(st)[0]
    ty, tnew = tv._gbn_apply(tp, tst, torch.as_tensor(x), training,
                             momentum=mom, virtual_batch=vb)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert_trees_close(params_to_numpy(tnew), jst, 1e-5)


# ---------------------------------------------------------------------------
# the forward passes on the JAX parameters: within 1e-5
# ---------------------------------------------------------------------------

_SMALL_TABNET = dict(n_d=8, n_a=8, n_steps=3)


@pytest.mark.parametrize("arch", ["lstm", "mha", "tabnet_eval",
                                  "tabnet_train"])
def test_forward_on_jax_parameters(arch):
    """Rows of padding included: the LSTM keeps its carry there, the MHA
    masks the keys with -1e9 (a program with no row stays finite), TabNet
    encodes every S x T row (its batch statistics see the padding) and
    sums the valid ones. Within 1e-5 of max |score| (and of the new
    batch-norm statistics)."""
    feats, mask = padded(8)
    jf, jm = jnp.asarray(feats), jnp.asarray(mask)
    tf, tm = torch.as_tensor(feats), torch.as_tensor(mask)
    key = jax.random.PRNGKey(11)
    if arch in ("lstm", "mha"):
        init = getattr(jv, f"init_{arch}_params")
        p = init(key, D, H)
        ref = np.asarray(getattr(jv, f"{arch}_forward")(p, jf, jm))
        tp, _ = variant_from_numpy(p)
        got = getattr(tv, f"{arch}_forward")(tp, tf, tm).numpy()
    else:
        training = arch == "tabnet_train"
        p, st = jv.init_tabnet_params(key, D, H,
                                      jv.TabNetConfig(**_SMALL_TABNET))
        ref, rst = jv.tabnet_forward(p, st, jf, jm, training,
                                     jv.TabNetConfig(**_SMALL_TABNET))
        tp, tst = variant_from_numpy(p, st)
        got, gst = tv.tabnet_forward(tp, tst, tf, tm, training,
                                     tv.TabNetConfig(**_SMALL_TABNET))
        got, ref = got.numpy(), np.asarray(ref)
        assert_trees_close(params_to_numpy(gst), rst, 1e-5)
    assert got.shape == (5,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_pad_segments_matches():
    feats, _ = programs(1)
    jf, jm = jv.pad_segments(feats)
    tf, tm = tv.pad_segments(feats)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert tf.shape == (7, max(len(f) for f in feats), D)


# ---------------------------------------------------------------------------
# SequenceModelInternal: training steps, pickles, the command line
# ---------------------------------------------------------------------------

N_STEPS = 3


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """Per arch: the JAX model's initial parameters (its fit_base draws
    them from PRNGKey(seed)), the model after N_STEPS full-batch steps,
    and its pickle."""
    feats, labels = programs(2)
    out = {}
    for arch in ARCHS:
        init = jv.SequenceModelInternal(arch, in_dim=D, hidden_dim=H,
                                        n_epoch=N_STEPS, seed=4)
        params0 = init._init(jax.random.PRNGKey(4))
        bn0 = getattr(init, "bn_state", None)
        model = jv.SequenceModelInternal(arch, in_dim=D, hidden_dim=H,
                                         n_epoch=N_STEPS, seed=4)
        model.fit_base(feats, labels)
        path = str(tmp_path_factory.mktemp("jax") / f"{arch}.pkl")
        model.save(path)
        out[arch] = (params0, bn0, model, path)
    return feats, labels, out


@pytest.mark.parametrize("arch", ["lstm", "mha"])
def test_clipped_adam_steps_equal(arch, jax_fits):
    """From the JAX model's initial parameters, N_STEPS full-batch steps
    of fit_base (rmse, clip by global norm 0.5, Adam lr 7e-4, eps 1e-8)
    give the JAX fit_base's parameters within 1e-5. (TabNet's float32
    gradients carry ~1e-3 of relative rounding noise in either package,
    against float64: its step is held in float64 below.)"""
    feats, labels, fits = jax_fits
    params0, bn0, jmodel, _ = fits[arch]
    model = tv.SequenceModelInternal(arch, in_dim=D, hidden_dim=H,
                                     n_epoch=N_STEPS, seed=4, device="cpu")
    model.params, model.bn_state = variant_from_numpy(params0, bn0)
    model.fit_base(feats, labels)
    assert_trees_close(params_to_numpy(model.params), jmodel.params, 1e-5)
    moved = max(np.abs(a - b).max() for a, b in
                zip(leaves(jmodel.params), leaves(params0)))
    assert moved > 1e-4          # the steps moved the parameters
    assert model.fit_info["epochs"] == N_STEPS
    assert np.isfinite(model.fit_info["rmse"])


def _jax_steps_f64(arch, params, bn, feats, mask, labels, n):
    """The JAX package's full-batch step (variants.py fit_base: rmse, then
    optax clip_by_global_norm(0.5) and adam(7e-4)) in float64."""
    import optax

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        params, feats, labels = f64(params), f64(feats), f64(labels)
        bn = None if bn is None else f64(bn)
        mask = jnp.asarray(mask)
        tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(7e-4))
        opt = tx.init(params)
        for _ in range(n):
            def loss(p):
                if arch == "tabnet":
                    pr, st = jv.tabnet_forward(p, bn, feats, mask, True)
                else:
                    pr = getattr(jv, f"{arch}_forward")(p, feats, mask)
                    st = None
                return jnp.sqrt(jnp.mean((pr - labels) ** 2)), st
            (_, new_bn), g = jax.value_and_grad(loss, has_aux=True)(params)
            upd, opt = tx.update(g, opt, params)
            params = optax.apply_updates(params, upd)
            bn = new_bn if arch == "tabnet" else bn
        return (jax.tree_util.tree_map(np.asarray, params),
                None if bn is None else jax.tree_util.tree_map(np.asarray,
                                                                bn))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_steps_equal_in_float64(arch, jax_fits):
    """fit_base on float64 parameters (it trains in their dtype) against
    the JAX package's step in float64, from the JAX initial parameters,
    N_STEPS steps: parameters and TabNet's running statistics within
    1e-5 (they agree to ~1e-11)."""
    feats, labels, fits = jax_fits
    params0, bn0, _, _ = fits[arch]
    model = tv.SequenceModelInternal(arch, in_dim=D, hidden_dim=H,
                                     n_epoch=N_STEPS, device="cpu")
    model.params, model.bn_state = (
        None if t is None else tree_map(lambda x: x.double(), t)
        for t in variant_from_numpy(params0, bn0))
    model.fit_base(feats, labels)
    padded_feats, mask = jv.pad_segments(
        [f / model.fea_norm_vec for f in feats])
    ref, ref_bn = _jax_steps_f64(arch, params0, bn0, padded_feats, mask,
                                 labels, N_STEPS)
    got = tree_map(lambda t: t.detach().numpy(), model.params)
    assert all(a.dtype == np.float64 for a in leaves(got))
    assert_trees_close(got, ref, 1e-5)
    if arch == "tabnet":
        assert_trees_close(tree_map(lambda t: t.numpy(), model.bn_state),
                           ref_bn, 1e-5)
    moved = max(np.abs(a - b).max() for a, b in
                zip(leaves(ref), leaves(params0)))
    assert moved > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_pickle_predicts_the_same(arch, jax_fits):
    """A pickle saved by the JAX package loads in the port (through
    load_model_pickle) and scores within 1e-5 in float64 (its parameters
    cast in both packages), within 1e-4 of max |score| in float32."""
    feats, _, fits = jax_fits
    jmodel, path = fits[arch][2], fits[arch][3]
    model = load_model_pickle(path, device="cpu")
    assert isinstance(model, tv.SequenceModelInternal) and \
        model.arch == arch and model.device == "cpu"
    test_feats, _ = programs(9, n=6)
    # the JAX model writes -inf into a read-only array: it scores only
    # programs with rows; the port's all-zero program scores -inf
    live = [f for i, f in enumerate(test_feats) if i != 2]
    got = model.predict_on_features(live)
    ref = jmodel.predict_on_features(live)
    assert np.isfinite(ref).all()
    # float32: rounding through TabNet's seven entmax steps reaches ~2e-5
    # of max |score| in either package against float64
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    assert np.isneginf(model.predict_on_features(test_feats)[2])
    # float64: the same pickle's parameters in both packages, within 1e-5
    model.params = tree_map(lambda t: t.double(), model.params)
    if model.bn_state is not None:
        model.bn_state = tree_map(lambda t: t.double(), model.bn_state)
    got64 = model.predict_on_features(live)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        feats, mask = jv.pad_segments([f / jmodel.fea_norm_vec for f in live])
        if arch == "tabnet":
            ref64 = jv.tabnet_forward(f64(jmodel.params),
                                      f64(jmodel.bn_state), f64(feats),
                                      jnp.asarray(mask))[0]
        else:
            ref64 = getattr(jv, f"{arch}_forward")(
                f64(jmodel.params), f64(feats), jnp.asarray(mask))
        ref64 = np.asarray(ref64)
    np.testing.assert_allclose(got64, ref64, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_pickle_round_trip(arch, tmp_path):
    """The port's own fit saves the JAX layout (numpy trees, bn_state
    None for the LSTM and the MHA), loads back to the same scores, and
    loads in the JAX package."""
    feats, labels = programs(5)
    model = tv.SequenceModelInternal(arch, in_dim=D, hidden_dim=H,
                                     n_epoch=2, seed=1, device="cpu")
    model.fit_base(feats, labels)
    model.use_workload_embedding = True
    path = str(tmp_path / "m.pkl")
    model.save(path)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["arch"] == arch and blob["use_workload_embedding"]
    assert all(isinstance(x, np.ndarray) for x in leaves(blob["params"]))
    assert (blob["bn_state"] is None) == (arch != "tabnet")
    again = tv.SequenceModelInternal.load(path, device="cpu")
    assert again.hidden_dim == (128 if arch == "tabnet" else H)
    assert np.array_equal(again.predict_on_features(feats),
                          model.predict_on_features(feats))
    # ... and in the JAX package (the programs with rows: the JAX model
    # writes -inf into a read-only array), within 1e-4 of max |score|
    live = [f for i, f in enumerate(feats) if i != 2]
    ref = jv.SequenceModelInternal.load(path).predict_on_features(live)
    np.testing.assert_allclose(again.predict_on_features(live), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    p, s = variant_to_numpy(again.params, again.bn_state)
    assert_trees_close(p, blob["params"], 0)
    if s is not None:
        assert_trees_close(s, blob["bn_state"], 0)


def test_fresh_fit_learns_and_needs_cuda():
    """A fresh draw (the port's own generator) fits on the CPU; without
    CUDA the default device refuses before any work."""
    feats, labels = programs(7, n=12)
    model = tv.SequenceModelInternal("lstm", in_dim=D, hidden_dim=H,
                                     n_epoch=60, lr=1e-2, device="cpu")
    model.fit_base(feats, labels)
    first = tv.SequenceModelInternal("lstm", in_dim=D, hidden_dim=H,
                                     n_epoch=1, lr=1e-2, device="cpu")
    first.fit_base(feats, labels)
    assert model.fit_info["rmse"] < first.fit_info["rmse"]
    with pytest.raises(ValueError):
        tv.SequenceModelInternal("gru")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            tv.SequenceModelInternal("mha", in_dim=D).fit_base(feats, labels)


def test_train_model_sequence_models_on_cpu(tmp_path, monkeypatch, capsys):
    """train_model --models lstm,mha,tabnet --device cpu at the default
    widths (hidden 256, TabNet 128) and 100 epochs on resnet-18's 128
    records: finite metrics, loadable pickles in the JAX layout."""
    monkeypatch.chdir(tmp_path)
    make_dataset.main([RESNET18, "--min-sample-size", "8",
                       "--out-file", "ds.pkl"])
    res = train_model.main(["--dataset", "ds.pkl", "--models",
                            "lstm,mha,tabnet", "--device", "cpu"])
    assert set(res) == set(ARCHS)
    for arch, metrics in res.items():
        assert list(metrics) == train_model.METRIC_NAMES
        assert all(np.isfinite(v) for v in metrics.values()), arch
        model = load_model_pickle(f"{arch}.pkl", device="cpu")
        assert model.arch == arch and model.in_dim == 174
        assert model.hidden_dim == (128 if arch == "tabnet" else 256)
        assert model.use_workload_embedding
        assert model.workload_embed_total_dim == 10
    assert "===== tabnet =====" in capsys.readouterr().out
