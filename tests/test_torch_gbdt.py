"""The port's GBDT cost model and the gbdt baseline arm of the search
against the JAX package's, with the numpy grower on both sides (the JAX
model pinned to backend="xgb", which resolves to its in-repo booster,
with VES_BOOST_TPU=0), and the device engine on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch's threads per worker)
from vae_extent_search_tpu.models import gbdt as jg
from vae_extent_search_tpu.search import active_loop as ja
from vae_extent_search_tpu_torch.data.pool import load_pool
from vae_extent_search_tpu_torch.models import gbdt as tg
from vae_extent_search_tpu_torch.search import active_loop as ta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _programs(seed, n_prog=60, d=16, rows=(2, 6)):
    rng = np.random.default_rng(seed)
    feats = [rng.random((int(rng.integers(*rows)), d)).astype(np.float32)
             for _ in range(n_prog)]
    y = np.asarray([f[:, :2].sum() + np.sin(f[:, 3].sum()) for f in feats],
                   np.float32)
    return feats, y


@pytest.mark.parametrize("kw,d", [({}, 16),
                                  ({"use_weight": True}, 16),
                                  ({"augment_buffer_swap": True}, 120)])
def test_native_fit_predict_bit_identical(monkeypatch, kw, d):
    monkeypatch.setenv("VES_BOOST_TPU", "0")
    feats, y = _programs(1, d=d)
    feats[5] = np.zeros_like(feats[5])        # an unlowerable program
    jm = jg.GBDTModelInternal(backend="xgb", n_estimators=40)
    jm.fit_base(feats, y, **kw)
    tm = tg.GBDTModelInternal(n_estimators=40, device="cpu")
    tm.fit_base(feats, y, **kw)
    assert jm.backend == tm.backend == "native"
    pj, pt = jm.predict_on_features(feats), tm.predict_on_features(feats)
    assert np.array_equal(pj, pt)
    assert pt[5] == -np.inf and np.isfinite(np.delete(pt, 5)).all()


def test_device_engine_model_on_cpu(monkeypatch, tmp_path):
    """engine="device" fits through boost_device (the plain histogram on
    the CPU) and predicts like the JAX device engine (VES_BOOST_TPU=1);
    the fitted model saves and loads."""
    feats, y = _programs(5, n_prog=60)
    monkeypatch.setenv("VES_BOOST_TPU", "1")
    jm = jg.GBDTModelInternal(backend="xgb", n_estimators=30, max_depth=4)
    jm.fit_base(feats, y)
    tm = tg.GBDTModelInternal(n_estimators=30, max_depth=4, engine="device",
                              device="cpu")
    tm.fit_base(feats, y)
    pj, pt = jm.predict_on_features(feats), tm.predict_on_features(feats)
    assert np.corrcoef(pj, pt)[0, 1] > 0.999
    assert np.corrcoef(pt, y)[0, 1] > 0.9
    path = str(tmp_path / "gbdt.pkl")
    tm.save(path)
    assert np.array_equal(tg.GBDTModelInternal.load(path)
                          .predict_on_features(feats), pt)


def test_engine_and_backend_resolution():
    for backend in ("auto", "xgb", "lgb", "native"):
        assert tg.GBDTModelInternal(backend=backend).backend == "native"
    with pytest.raises(ValueError):
        tg.GBDTModelInternal(backend="sklearn")
    with pytest.raises(ValueError):
        tg.GBDTModelInternal(engine="tpu")
    # auto on the CPU is the numpy grower at any row count
    m = tg.GBDTModelInternal(device="cpu")
    assert m._native_train_fn(10 ** 7) is tg.boost.train
    assert tg.GBDTModelInternal(engine="device", device="cpu") \
        ._native_train_fn(10).func is tg.boost_device.train
    if not torch.cuda.is_available():
        # CUDA is the default and is never swapped for the CPU
        with pytest.raises(RuntimeError, match="is_available"):
            tg.GBDTModelInternal().fit_base(*_programs(2, n_prog=10))


def test_random_model_matches():
    feats, _ = _programs(3, n_prog=20)
    assert np.array_equal(
        jg.RandomModelInternal(seed=4).predict_on_features(feats),
        tg.RandomModelInternal(seed=4).predict_on_features(feats))


class _Recorder:
    """Wraps a package's GBDTModelInternal to record, per phase, the
    measured row indices it was fitted on and its predictions."""

    def __init__(self, cls, **forced):
        self.fits, self.preds = [], []
        rec = self

        class Model(cls):
            def __init__(self, **kw):
                super().__init__(**{**kw, **forced})

            def fit_base(self, features_list, labels, **kw):
                base = features_list[0].base
                rec.fits.append([
                    (f.ctypes.data - base.ctypes.data) // base.strides[0]
                    for f in features_list])
                return super().fit_base(features_list, labels, **kw)

            def predict_on_features(self, features_list):
                out = super().predict_on_features(features_list)
                rec.preds.append(out)
                return out

        self.cls = Model


# the committed pool (773 candidates x 17 extent features); measure size
# 32; the first phases of two seeds, with 100 trees per phase as the arm
# fits them. Both arms draw from numpy with the same seed and fit the same
# numpy trees, so everything must match exactly.
@pytest.mark.parametrize("seed,max_phases", [(2000, 60), (2001, 3)])
def test_gbdt_arm_matches_jax_arm(monkeypatch, seed, max_phases):
    feats, labels, _ = load_pool()
    monkeypatch.setenv("VES_BOOST_TPU", "0")
    jrec = _Recorder(jg.GBDTModelInternal, backend="xgb")
    trec = _Recorder(tg.GBDTModelInternal)
    monkeypatch.setattr(jg, "GBDTModelInternal", jrec.cls)
    monkeypatch.setattr(ta, "GBDTModelInternal", trec.cls)
    rj = ja.run_gbdt_baseline_search(feats, labels, measure_size=32,
                                     max_phases=max_phases,
                                     sampling_seed=seed)
    rt = ta.run_gbdt_baseline_search(feats, labels, measure_size=32,
                                     max_phases=max_phases,
                                     sampling_seed=seed, engine="host",
                                     device="cpu")
    assert (rt.found, rt.phase, rt.train_size) == \
        (rj.found, rj.phase, rj.train_size)
    assert rt.top1_hits == rj.top1_hits
    assert rt.final_optimum_rank == rj.final_optimum_rank
    assert len(trec.fits) == len(jrec.fits) == rt.phase
    assert trec.fits == jrec.fits
    for a, b in zip(trec.preds, jrec.preds):
        assert np.array_equal(a, b)
    # the port's selected order, cut into phases, is the measured set the
    # next phase fits on (and, at the end, the final measured set)
    order = rt.selected_order
    assert len(order) == rt.train_size == len(set(order))
    for p, fitted in enumerate(trec.fits):
        assert sorted(order[:32 * (p + 1)]) == fitted
    if seed == 2000:
        assert rt.found and int(np.argmax(labels)) in order


def test_cli_gbdt_arm_on_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "vae_extent_search_tpu_torch.cli."
         "vae_extent_search", "--arm", "gbdt", "--device", "cpu",
         "--seeds", "2000", "--measure-size", "32", "--max-phases", "2",
         "--out-dir", str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (csv_path,) = tmp_path.glob("gbdt_search_*.csv")
    rows = csv_path.read_text().splitlines()
    assert rows[0] == ("measure_size,phase,train_size,used_time,top-1,"
                       "optimum_rank,found,sampling_seed")
    assert len(rows) == 2
