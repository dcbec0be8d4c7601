"""The port's boosters against the JAX package's: the numpy host engine
(models/boost.py) bit for bit, and the device engine
(models/boost_device.py, run here on the CPU through the plain
histogram) against boost_tpu's XLA path on continuous data, where the
two engines' float32-vs-fixed-point sums cannot flip a split."""

import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (caps torch's threads per worker)
from vae_extent_search_tpu.models import boost as jb
from vae_extent_search_tpu.models import boost_tpu as jbt
from vae_extent_search_tpu_torch.models import boost as tb
from vae_extent_search_tpu_torch.models import boost_device as tbd


def _pack_problem(n_prog, seed, d=8):
    rng = np.random.default_rng(seed)
    rows, labels, pack_ids = [], [], []
    for i in range(n_prog):
        k = int(rng.integers(2, 7))
        F = rng.random((k, d)).astype(np.float32)
        rows.append(F)
        s = F.sum(0)
        labels.append(np.sin(3 * s[0]) + s[1] * s[2] + 0.5 * s[3])
        pack_ids.extend([i] * k)
    return (np.concatenate(rows), np.asarray(labels, np.float32),
            np.asarray(pack_ids, np.int64))


def _plain_problem(seed=7, n=400, d=9):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (2 * X[:, 0] + np.sin(X[:, 1]) + 0.1 * rng.standard_normal(n)
         ).astype(np.float32)
    return X, y


def _protocol(mod):
    fe = [mod.pack_sum_rmse, mod.pack_sum_average_peak_score(1)]
    return dict(obj=mod.pack_sum_square_error, fevals=fe, metric="tr-rmse")


def _lines(fn):
    buf = io.StringIO()
    with redirect_stdout(buf):
        bst = fn()
    return bst, buf.getvalue().strip().splitlines()


def _run(mod, train_fn, case, depth=6, **extra):
    """Train ``case`` with package ``mod``'s DMatrix and fevals through
    ``train_fn``: -> (booster, printed eval lines, train rows). The JAX
    device engine compiles a tree of static depth, so its comparisons
    run at depth 4 to stay quick."""
    if case == "plain":
        X, y = _plain_problem()
        d = mod.DMatrix(X, label=y)
        return _lines(lambda: train_fn({"max_depth": 4, "eta": 0.3}, d,
                                       num_boost_round=12, verbose_eval=0,
                                       **extra)) + (X,)
    rows, labels, pack_ids = _pack_problem(100, seed=3)
    w = (np.maximum(labels, 0.1)[pack_ids].astype(np.float32)
         if case == "weighted" else None)
    d = mod.DMatrix(rows, label=labels[pack_ids], pack_ids=pack_ids,
                    weight=w, group_sizes=[len(labels)])
    params = {"max_depth": depth, "eta": 0.2, "gamma": 0.003,
              "min_child_weight": 2}
    stop = 100
    if case == "lossguide":
        params = {"grow_policy": "lossguide", "num_leaves": 31, "eta": 0.16,
                  "min_child_weight": 4, "seed": 0,
                  "feature_fraction": 0.84375, "bagging_fraction": 0.89435,
                  "bagging_freq": 4}
    if case == "early_stop":
        stop = 3
        params = dict(params, eta=0.9)
    return _lines(lambda: train_fn(
        params, d, num_boost_round=40, evals=[(d, "tr")],
        stopping_rounds=stop, verbose_eval=5, **_protocol(mod), **extra)
    ) + (rows,)


def _features(bst):
    return [t.feature for t in bst.trees]


def _shape(tree, node=0):
    """A tree's split features, left child first (the host grower numbers
    its nodes in another order than the device engines' conversion)."""
    if tree.feature[node] < 0:
        return None
    return (tree.feature[node], _shape(tree, tree.left[node]),
            _shape(tree, tree.right[node]))


@pytest.mark.parametrize("case", ["plain", "pack_sum", "weighted",
                                  "lossguide", "early_stop"])
def test_host_engine_bit_identical(case):
    b1, l1, X = _run(jb, jb.train, case)
    b2, l2, _ = _run(tb, tb.train, case)
    assert l1 == l2
    assert len(b1.trees) == len(b2.trees)
    assert _features(b1) == _features(b2)
    assert np.array_equal(b1.predict(X), b2.predict(X))


def test_dmatrix_binning_identical():
    rng = np.random.default_rng(0)
    X = rng.random((3000, 5)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1] * 20)          # few distinct values
    X[:, 2] = 1.0                             # constant: no edges
    d1, d2 = jb.DMatrix(X), tb.DMatrix(X)
    d1._ensure_binned()
    d2._ensure_binned()
    assert np.array_equal(d1._binned, d2._binned)
    assert d2._binned.dtype == np.uint8 and d2._binned.shape == (5, 3000)
    for a, b in zip(d1._thresholds, d2._thresholds):
        assert np.array_equal(a, b)


# predictions of the two device engines within 1e-4 (float32 sums in the
# JAX engine, fixed-point sums and float64 gains in the port), the same
# split features in every tree, the same rounds printed and kept, and
# protocol scores within 2e-5 (the JAX package's own device-vs-numpy bar)
@pytest.mark.parametrize("case", ["plain", "pack_sum", "early_stop"])
def test_device_engine_matches_jax_device_engine(case):
    b1, l1, X = _run(jb, jbt.train, case, depth=4)
    b2, l2, _ = _run(tb, tbd.train, case, depth=4, device="cpu")
    assert len(b1.trees) == len(b2.trees)
    assert _features(b1) == _features(b2)
    assert np.abs(b1.predict(X) - b2.predict(X)).max() < 1e-4
    assert len(l1) == len(l2)
    for a, b in zip(l1, l2):
        fa = re.findall(r"([\w@-]+): ([\d.]+)", a)
        fb = re.findall(r"([\w@-]+): ([\d.]+)", b)
        assert [k for k, _ in fa] == [k for k, _ in fb]
        for (_, va), (_, vb) in zip(fa, fb):
            assert abs(float(va) - float(vb)) < 2e-5, (a, b)


def test_device_engine_weighted_pack_sum():
    """Per-row weights flow through the weighted grad/hess path. With
    weighted hessians, small nodes often hold exact ties between features
    that split their few rows alike, which each engine breaks by its own
    rounding, so this holds the pack predictions as the JAX package's own
    weighted device-vs-numpy test does (test_boost.py:691)."""
    b1, _, X = _run(jb, jbt.train, "weighted", depth=4)
    b2, _, _ = _run(tb, tbd.train, "weighted", depth=4, device="cpu")
    _, _, pack_ids = _pack_problem(100, seed=3)
    p1 = jb.pack_sum_predict_throughput(b1.predict(X), pack_ids)
    p2 = tb.pack_sum_predict_throughput(b2.predict(X), pack_ids)
    assert np.corrcoef(p1, p2)[0, 1] > 0.999
    assert np.abs(p1 - p2).max() < 1e-3 * max(1.0, np.abs(p1).max())


def test_device_engine_foreign_eval_set_and_early_stop():
    """A held-out eval set is binned against the TRAIN thresholds, so its
    per-round device predictions equal tree.predict on raw floats; early
    stopping on it truncates the ensemble as the JAX engine does."""
    rng = np.random.default_rng(11)
    X = rng.random((300, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2).astype(np.float32)
    captured = []

    def feval_rmse(preds, dm):
        captured.append(np.array(preds))
        return "rmse", float(np.sqrt(np.mean((preds - dm.label) ** 2)))

    def run(mod, train_fn, stop, **extra):
        dtrain = mod.DMatrix(X[:250], label=y[:250])
        dval = mod.DMatrix(X[250:], label=y[250:])
        bst = train_fn({"max_depth": 3, "eta": 0.4}, dtrain,
                       num_boost_round=30, fevals=[feval_rmse],
                       evals=[(dval, "te")], metric="te-rmse",
                       stopping_rounds=stop, verbose_eval=0, **extra)
        return bst, dval

    bst, dval = run(tb, tbd.train, 100, device="cpu")
    assert len(bst.trees) == 30
    assert np.allclose(captured[-1], bst.predict(dval), atol=1e-5)
    b1, _ = run(jb, jbt.train, 3)
    b2, _ = run(tb, tbd.train, 3, device="cpu")
    assert len(b1.trees) == len(b2.trees) < 30
    assert b1.attr("best_iteration") == b2.attr("best_iteration")
    assert np.abs(b1.predict(X) - b2.predict(X)).max() < 1e-4


def test_device_engine_matches_host_engine_and_repeats():
    """On continuous data the device engine grows the host engine's trees
    (test_boost.py:252 holds the JAX engines so); a second run gives the
    same ensemble bit for bit."""
    X, y = _plain_problem(seed=13)

    def fit(fn, **extra):
        return fn({"max_depth": 4, "eta": 0.3}, tb.DMatrix(X, label=y),
                  num_boost_round=12, verbose_eval=0, **extra)

    host = fit(tb.train)
    dev1 = fit(tbd.train, device="cpu")
    dev2 = fit(tbd.train, device="cpu")
    assert [_shape(t) for t in host.trees] == [_shape(t) for t in dev1.trees]
    assert np.abs(host.predict(X) - dev1.predict(X)).max() < 1e-4
    assert _features(dev1) == _features(dev2)
    assert np.array_equal(dev1.predict(X), dev2.predict(X))
