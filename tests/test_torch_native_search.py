"""The port's native record-level GA, the analytic runner's record-level
batch and the command lines over the host library, against the JAX
package on the CPU: ``make_state_records`` and ``_evolutionary_search_native``
give the JAX native GA's step records in its order, ``run_record_lists`` the State path's
costs bit for bit at both fidelities, ``make_dataset --n-threads 4`` the
dataset of ``--n-threads 1`` and of the JAX script, ``dump_programs`` the
JAX script's pool.
"""

import os
import pickle
import sys

import numpy as np
import pytest

from _torch_parity import jax_native_lib
from vae_extent_search_tpu.features import per_store as jps
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records.task import SearchTask as JTask
from vae_extent_search_tpu.search import measure as jm
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu_torch.cli import dump_programs, make_dataset
from vae_extent_search_tpu_torch.cli.measure_programs import remeasure_file
from vae_extent_search_tpu_torch.features import per_store as tps
from vae_extent_search_tpu_torch.records import fast_parser as tfp
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records import workload as twl
from vae_extent_search_tpu_torch.records.task import SearchTask as TTask
from vae_extent_search_tpu_torch.search import measure as tm
from vae_extent_search_tpu_torch.search import sketch as tsketch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET50 = os.path.join(ROOT, "result", "corpus", "resnet_50-B1-llvm.json")
TARGETS = ["llvm -mcpu=skylake-avx512", "cuda"]
CONV = ("conv2d_layer", (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1]))
GA_WORKLOADS = [CONV, ("matmul_auto_scheduler_test", (128, 128, 128)),
                ("depthwise_conv2d_layer", (1, 14, 14, 96, 3, 3, [1, 1],
                                            [1, 1]))]


def _tasks(wk, args, target):
    key = twl.make_workload_key(wk, args)
    return JTask(key, target), TTask(key, target)


def _jax_scripts():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from scripts import dump_programs as jdump
    from scripts import make_dataset as jmake
    from scripts import measure_programs as jmeasure

    return jdump, jmake, jmeasure


# ---------------------------------------------------------------------------
# the GA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library, the GA's independent reference
    (built by g++ from the same sources and flags as the port's): a host
    where its loader fails fails the GA tests rather than letting them
    compare the port with itself."""
    assert jax_native_lib(), "the JAX package's native library did not load"


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("wk,args", GA_WORKLOADS,
                         ids=[w for w, _ in GA_WORKLOADS])
def test_make_state_records_equal_jax(wk, args, target, jax_native):
    """The record-level pool (the random model): unique native keys, every
    record replays, and the JAX native GA's records in its order; the
    States make_states builds from them print alike."""
    jt, tt = _tasks(wk, args, target)
    kw = dict(evo_population=48, min_population=16, seed=9)
    tfp.FALLBACKS.clear()
    got = tsketch.make_state_records(tt, 120, **kw)
    assert got and len(got) <= 120
    keys = tfp.featurize_perstore_records_native(tt, got,
                                                 with_features=False)[1]
    assert len(set(keys.tolist())) == len(got)
    states = tsketch.make_states(tt, 120, **kw)
    assert [tt.compute_dag.infer_bound(tt.compute_dag.apply_steps(r))
            .to_str() for r in got] == [s.to_str() for s in states]
    assert not {k for k in tfp.FALLBACKS if not k.startswith("ga:status1")}
    assert got == jsketch.make_state_records(jt, 120, **kw)
    assert [s.to_str() for s in states] == \
        [s.to_str() for s in jsketch.make_states(jt, 120, **kw)]


def _det_model(sketch, per_store):
    """A deterministic model scoring per-store features, in one package."""

    class DetModel(sketch.PythonCostModel):
        def predict(self, task, states):
            return self.predict_on_feature_list(
                task, per_store.get_per_store_features_from_states(states,
                                                                   task))

        def predict_on_feature_list(self, task, feats):
            return np.asarray([f.sum() % 7.0 for f in feats], np.float32)

    return DetModel()


@pytest.mark.parametrize("target", TARGETS)
def test_native_ga_with_a_feature_model(target, jax_native):
    """_evolutionary_search_native scored through predict_on_feature_list:
    unique States, the best no worse than the initial population's, and the
    JAX native GA's States in its order."""
    jt, tt = _tasks(*CONV, target)
    model = _det_model(tsketch, tps)
    pol = tsketch.SketchPolicy(tt, model, seed=11)
    init = pol.sample_initial_population(24)
    out = pol._evolutionary_search_native(init, 16)
    assert out and len({s.to_str() for s in out}) == len(out)
    assert max(model.predict(tt, out)) >= max(model.predict(tt, init))
    jpol = jsketch.SketchPolicy(jt, _det_model(jsketch, jps), seed=11)
    jout = jpol._evolutionary_search_native(
        jpol.sample_initial_population(24), 16)
    assert [s.to_str() for s in out] == [s.to_str() for s in jout]


def test_ga_declines_where_the_jax_ga_does():
    """A model without predict_on_feature_list, or one whose predict comes
    from a subclass, sends the GA down the State path, counted."""
    _, tt = _tasks(*CONV, TARGETS[0])

    class NoFeatures(tsketch.PythonCostModel):
        def predict(self, task, states):
            return np.arange(len(states), dtype=np.float32)

    class OwnPredict(tsketch.RandomCostModel):
        def predict(self, task, states):
            return np.zeros(len(states), np.float32)

    for model, reason in ((NoFeatures(), "ga:no_feature_predict"),
                          (OwnPredict(), "ga:no_feature_predict")):
        pol = tsketch.SketchPolicy(tt, model, seed=1,
                                   params={"evolutionary_search_population":
                                           32})
        init = pol.sample_initial_population(8)
        tfp.FALLBACKS.clear()
        assert pol._evolutionary_search_native(init, 8) is None
        assert tfp.FALLBACKS[reason] == 1
        assert pol.evolutionary_search(init, 8)
    assert tsketch.RandomCostModel.feature_free


# ---------------------------------------------------------------------------
# the analytic runner's record-level batch and the command lines
# ---------------------------------------------------------------------------


def _pool(tmp_path, tt, n=40):
    recs = tsketch.make_state_records(tt, n, evo_population=48,
                                      min_population=16, seed=9)
    path = str(tmp_path / "pool.json")
    tserde.save_records(path, [tserde.make_record(tt, r, costs=[0.0],
                                                  timestamp=0)
                               for r in recs], mode="w")
    return path, recs


def _log(path, serde):
    return [(r.inp.step_records, r.res.costs, r.res.error_no)
            for r in serde.load_records(path)]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("fidelity", ["low", "high"])
def test_remeasure_fast_path_identical(tmp_path, fidelity, target):
    """remeasure_file through run_record_lists writes the State path's
    costs, error codes and steps bit for bit, and the JAX script's."""
    _, tt = _tasks(*CONV, target)
    pool, recs = _pool(tmp_path, tt)
    kw = dict(noise=0.1, seed=5, fidelity=fidelity)
    fast, slow = str(tmp_path / "fast.json"), str(tmp_path / "slow.json")
    tfp.FALLBACKS.clear()
    assert remeasure_file(pool, fast, tm.AnalyticRunner(**kw)) == len(recs)
    assert not tfp.FALLBACKS, dict(tfp.FALLBACKS)
    runner = tm.AnalyticRunner(**kw)
    runner.run_record_lists = None  # the State path
    assert remeasure_file(pool, slow, runner) == len(recs)
    got = _log(fast, tserde)
    assert got == _log(slow, tserde)
    assert [r for r, _, _ in got] == recs
    assert len({c[0] for _, c, e in got if e == 0}) > 0.9 * len(recs)
    jout = str(tmp_path / "jax.json")
    _jax_scripts()[2].remeasure_file(pool, jout, jm.AnalyticRunner(**kw))
    assert got == _log(jout, jserde)


def test_fast_path_abort_keeps_the_records_before_it(tmp_path):
    """150 errors in a row stop the record-level path as the measurer
    stops: the records up to the abort are written first, as the JAX
    script writes them."""
    _, tt = _tasks(*CONV, TARGETS[0])
    pool, recs = _pool(tmp_path, tt, 200)

    def failing(cls):
        class Failing(cls):
            def run_record_lists(self, task, record_lists):
                res = super().run_record_lists(task, record_lists)
                for r in res[20:]:
                    r.error_no = 4
                    r.costs = [1e10]
                return res
        return Failing()

    out, jout = str(tmp_path / "out.json"), str(tmp_path / "jout.json")
    with pytest.raises(RuntimeError, match="continuous"):
        remeasure_file(pool, out, failing(tm.AnalyticRunner))
    with pytest.raises(RuntimeError, match="continuous"):
        _jax_scripts()[2].remeasure_file(pool, jout,
                                         failing(jm.AnalyticRunner))
    got = _log(out, tserde)
    assert len(got) == 170 and got == _log(jout, jserde)


def test_symbolic_extents_take_the_state_path():
    """A sparse task (a data-dependent reduction extent) is not taken by
    the native analytic batch: run_record_lists returns None, counted, and
    the caller runs the State path."""
    _, tt = _tasks("sparse_dense", (16, 32, 32, [8, 4, 4], [8], [9]),
                   TARGETS[0])
    tfp.FALLBACKS.clear()
    assert tfp.analytic_batch_native(tt, [[], []]) is None
    assert tm.AnalyticRunner().run_record_lists(tt, [[]]) is None
    assert dict(tfp.FALLBACKS) == {"analytic:symbolic": 3}


def _datasets_equal(a, b, exact=True):
    assert list(a.features) == list(b.features) and len(a) > 0
    for task in a.features:
        fa, fb = a.features[task], b.features[task]
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            assert x.shape == y.shape
            assert np.array_equal(x, y) if exact else \
                np.allclose(x, y, atol=1e-4)
        assert np.array_equal(a.throughputs[task], b.throughputs[task])
        assert a.min_latency[task] == b.min_latency[task]


def test_make_dataset_threads_and_the_jax_script(tmp_path, monkeypatch):
    """make_dataset --n-threads 4 writes the dataset of --n-threads 1 bit for
    bit, and the JAX script's (bit for bit where it runs its native
    featuriser, else within 1e-4 of its Python one). Each run in a
    directory of its own: the feature caches live in the working
    directory."""
    out = {}
    for name, argv in (("one", ["--n-threads", "1"]),
                       ("four", ["--n-threads", "4"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        make_dataset.main([RESNET50, "--out-file", "ds.pkl", *argv])
        with open(d / "ds.pkl", "rb") as f:
            out[name] = pickle.load(f)
    _datasets_equal(out["four"], out["one"])
    assert len(out["one"].tasks()) == 26
    d = tmp_path / "jax"
    d.mkdir()
    monkeypatch.chdir(d)
    jmake = _jax_scripts()[1]
    monkeypatch.setattr(sys, "argv", ["make_dataset.py", RESNET50,
                                      "--out-file", "ds.pkl",
                                      "--n-threads", "4"])
    jmake.main()
    with open(d / "ds.pkl", "rb") as f:
        ref = pickle.load(f)
    # (the two packages' LearningTask namedtuples compare as tuples)
    _datasets_equal(out["four"], ref, exact=jax_native_lib())


@pytest.mark.parametrize("target", TARGETS)
def test_dump_programs_takes_the_native_ga(tmp_path, monkeypatch, target,
                                           jax_native):
    """dump_programs writes the native GA's records without building the
    States of make_states, and the JAX script's pool."""
    jt, tt = _tasks(*CONV, target)
    out = str(tmp_path / "pool.json")

    def refuse(*a, **k):
        raise AssertionError("make_states called")

    monkeypatch.setattr(dump_programs, "make_states", refuse)
    assert dump_programs.main(["--workload-key", tt.workload_key,
                               "--target", target, "--n-states", "64",
                               "--seed", "2023", "--out", out]) == {out: 64}
    got = [r.inp.step_records for r in tserde.load_records(out)]
    assert got == tsketch.make_state_records(tt, 64, seed=2023)
    jout = str(tmp_path / "jax.json")
    _jax_scripts()[0].dump_task(jt, jout, 64, seed=2023)
    assert got == [r.inp.step_records for r in jserde.load_records(jout)]
