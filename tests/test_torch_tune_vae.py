"""The port's online SegmentVAE tuning arm (``cli/tune_vae.py``) against
the JAX package's ``scripts/vae_experiments/tune_vae.py``, on the CPU.

With random selection the loop's picks and costs depend on numpy's
generator and the analytic runner only, so both packages pick the same
candidates, write the same costs and find the same best. With model
selection the picks come from trained models, whose random streams differ
by package (``torch.Generator`` against JAX keys); there the regression's
scores under the same injected numpy parameters are held within 1e-5 and
their top-k picks equal. The JAX side runs on its Python paths (its GA
without the native engine, its per-store featuriser without the native
batch), the paths the port has.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from _torch_parity import np_segment_predictor_params
from vae_extent_search_tpu.features import per_store as jps
from vae_extent_search_tpu.models import segment as jseg
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records.task import SearchTask as JTask
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu_torch.cli import tune_vae
from vae_extent_search_tpu_torch.convert import params_from_numpy
from vae_extent_search_tpu_torch.features.per_store import (
    get_per_store_features_from_states,
)
from vae_extent_search_tpu_torch.models.segment import compute_fea_norm_vec
from vae_extent_search_tpu_torch.ops import segment_sum as tss
from vae_extent_search_tpu_torch.records import make_workload_key
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records.task import SearchTask as TTask
from vae_extent_search_tpu_torch.search import measure as tm
from vae_extent_search_tpu_torch.search.sketch import make_states
from _torch_parity import pin_port_python_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TGT = "llvm -mcpu=skylake-avx512"
WK = make_workload_key("conv2d_layer", (1, 14, 14, 32, 32, 3, 3, [1, 1],
                                        [1, 1]))
SMALL = dict(n_candidates=48, measure_size=8, n_phases=2, vae_epochs=10,
             reg_epochs=15)
PORT_TIMER = f"{sys.executable} -m vae_extent_search_tpu_torch.cli.toy_timer"


@pytest.fixture(scope="module")
def jtv():
    """The JAX script as a module, on its Python paths."""
    sys.path.insert(0, ROOT)
    from scripts.vae_experiments import tune_vae as mod

    mp = pytest.MonkeyPatch()
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native_recs",
               lambda *a, **k: None)
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native",
               lambda *a, **k: None)
    for m in (jps, mod):
        mp.setattr(m, "get_per_store_features_from_states",
                   functools.partial(jps.get_per_store_features_from_states,
                                     use_native=False))
    pin_port_python_paths(mp)
    yield mod
    mp.undo()


def _log(path, serde):
    return [(r.inp.step_records, r.res.costs, r.res.error_no)
            for r in serde.load_records(path)]


@pytest.mark.parametrize("runner", ["analytic", "analytic_hf"])
def test_random_selection_equals_jax(jtv, tmp_path, capsys, runner):
    """The same picks, in the same order, the same log costs and the same
    best cost as the JAX run_tuning."""
    logs = [str(tmp_path / f"{side}.json") for side in ("port", "jax")]
    details = {}
    best, _ = tune_vae.run_tuning(
        TTask(WK, TGT), **SMALL, select="random", log_file=logs[0],
        runner=tm.runner_from_spec(runner, noise=0.2, seed=2023),
        device="cpu", details=details)
    from vae_extent_search_tpu.search.measure import runner_from_spec

    jbest, _ = jtv.run_tuning(
        JTask(WK, TGT), **SMALL, select="random", log_file=logs[1],
        runner=runner_from_spec(runner, noise=0.2, seed=2023))
    got, want = _log(logs[0], tserde), _log(logs[1], jserde)
    assert len(got) == 16 and got == want
    assert best == jbest == min(c[0] for _, c, e in got if e == 0)
    out = capsys.readouterr().out
    assert "phase 1: measured 16" in out
    secs = details["seconds"]
    assert len(secs["phases"]) == 2 and secs["pretrain"] > 0
    assert details["measured"].sum() == 16 and details["n_seg"] == 48


def test_random_selection_on_a_cuda_target_equals_jax(jtv, tmp_path):
    """A cuda task: the GA's GPU-target rules give the candidates, the
    per-store featuriser its GPU rows, analytic_hf their GPU roofline; the
    same picks, log costs and best as the JAX run_tuning."""
    logs = [str(tmp_path / f"{side}.json") for side in ("port", "jax")]
    details = {}
    best, _ = tune_vae.run_tuning(
        TTask(WK, "cuda"), **SMALL, select="random", log_file=logs[0],
        runner=tm.runner_from_spec("analytic_hf", noise=0.0, seed=2023),
        device="cpu", details=details)
    from vae_extent_search_tpu.search.measure import runner_from_spec

    jbest, _ = jtv.run_tuning(
        JTask(WK, "cuda"), **SMALL, select="random", log_file=logs[1],
        runner=runner_from_spec("analytic_hf", noise=0.0, seed=2023))
    got, want = _log(logs[0], tserde), _log(logs[1], jserde)
    assert len(got) == 16 and got == want
    assert best == jbest == min(c[0] for _, c, e in got if e == 0)
    assert all(any(r[0] == "CHR" for r in recs) for recs, _, _ in got)
    assert details["n_seg"] == 48


def test_model_selection_through_the_command_runner(tmp_path, monkeypatch):
    """Model selection measuring through the external timer: a finite best,
    equal to the log's minimum over its successful records; every segment
    sum on the CPU runs the plain version (no kernel launch)."""
    monkeypatch.setenv("PYTHONPATH", ROOT)
    log = str(tmp_path / "tune.json")
    f0, b0 = tss.segment_sum.launches, tss.segment_sum.backward_launches
    details = {}
    best, _ = tune_vae.run_tuning(
        TTask(WK, TGT), **SMALL, select="model", log_file=log,
        runner=tm.CommandRunner(PORT_TIMER, timeout=120), verbose=False,
        device="cpu", details=details)
    recs = tserde.load_records(log)
    assert len(recs) == 16 and np.isfinite(best)
    assert best == min(r.res.costs[0] for r in recs if r.res.error_no == 0)
    assert (tss.segment_sum.launches, tss.segment_sum.backward_launches) \
        == (f0, b0)
    assert len({repr(r.inp.step_records) for r in recs}) == 16
    assert details["pred_params"] is not None


def test_flatten_features_offsets_once(tmp_path):
    task = TTask(WK, TGT)
    feats = get_per_store_features_from_states(make_states(task, 12, seed=1),
                                               task)
    rows, ids, offs, n_seg = tune_vae.flatten_features(
        feats, compute_fea_norm_vec(feats))
    assert n_seg == 12 and rows.dtype == torch.float32
    assert ids.dtype == offs.dtype == torch.int32
    lens = np.diff(offs.numpy())
    assert lens.tolist() == [len(f) for f in feats]
    assert offs[-1] == rows.shape[0] == ids.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_model_scores_equal_jax_under_injected_parameters(jtv, seed):
    """segment_predictor_encode + segment_predict_cost over the candidates'
    rows: the port's scores within 1e-5 of the JAX package's, and the same
    top-16 picks over the unmeasured candidates."""
    task = TTask(WK, TGT)
    feats = get_per_store_features_from_states(make_states(task, 48, seed=3),
                                               task)
    norm = compute_fea_norm_vec(feats)
    rng = np.random.default_rng(seed)
    params = np_segment_predictor_params(rng, 164, 64, 16, 64)
    rows, ids, offs, n_seg = tune_vae.flatten_features(feats, norm)
    _, got = tune_vae.encode_candidates(params_from_numpy(params), rows,
                                        ids, offs, n_seg)
    jrows, jids, jn = jtv.flatten_features(feats, norm)
    mu, _, _ = jseg.segment_predictor_encode(params, jrows, jids, jn)
    want = np.asarray(jseg.segment_predict_cost(params, mu))
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-5 * scale
    remaining = np.flatnonzero(rng.random(48) < 0.6)
    assert list(remaining[np.argsort(-got[remaining])][:16]) == \
        list(remaining[np.argsort(-want[remaining])][:16])


def test_cli_main_with_vae_hparam_search(tmp_path, capsys):
    log = str(tmp_path / "tune.json")
    best, _ = tune_vae.main([
        "--workload-key", WK, "--n-candidates", "24", "--measure-size", "6",
        "--n-phases", "1", "--select", "model", "--log-file", log,
        "--runner", "analytic_hf", "--noise", "0.1", "--tune-vae-hparams",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "vae hparam search best:" in out and "best cost:" in out
    assert np.isfinite(best) and len(tserde.load_records(log)) == 6


def test_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    with pytest.raises(RuntimeError, match="is_available"):
        tune_vae.run_tuning(TTask(WK, TGT), **SMALL, device="cuda")
