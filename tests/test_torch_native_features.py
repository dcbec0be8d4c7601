"""The port's native featurisers (``records/fast_parser.py``, the host
library built by g++) against the JAX package, on the CPU: within 1e-4 of
the JAX package's Python featuriser (``use_native=False``, the JAX
tests/test_native.py tolerance) and of the port's own, and bit for bit
against the JAX native path where the JAX package's loader gives its
library. States, inputs, record lists and whole logs; the extent
featuriser; rfactor, conv3d and partially bound GA states; n_threads 1
against 4, bit for bit. Where the Python path runs is counted
(``fast_parser.FALLBACKS``).
"""

import gzip
import os

import numpy as np
import pytest

from _torch_parity import jax_native_lib
from vae_extent_search_tpu.features import extent as jext
from vae_extent_search_tpu.features import per_store as jps
from vae_extent_search_tpu.records import fast_parser as jfp
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records.task import HardwareParams as JHW
from vae_extent_search_tpu.records.task import SearchTask as JTask
from vae_extent_search_tpu_torch.features import extent as text
from vae_extent_search_tpu_torch.features import per_store as tps
from vae_extent_search_tpu_torch.records import fast_parser as tfp
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records import workload as twl
from vae_extent_search_tpu_torch.records.task import HardwareParams as THW
from vae_extent_search_tpu_torch.records.task import SearchTask as TTask
from vae_extent_search_tpu_torch.search import sketch as tsketch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET18 = os.path.join(ROOT, "result", "corpus", "resnet_18-B1-llvm.json")
RESNET50 = os.path.join(ROOT, "result", "corpus", "resnet_50-B1-llvm.json")
POOL = os.path.join(ROOT, "result", "conv2d_4k_chip", "pool_conv2d_4k.json.gz")
TARGETS = ["llvm -mcpu=skylake-avx512", "cuda"]
ATOL = 1e-4

# the workload families of the JAX package's tests/test_native.py
FAMILIES = [
    ("max_pool2d_auto_scheduler_test", (1, 14, 14, 64, 1)),
    ("min_nm_auto_scheduler_test", (32, 512)),
    ("softmax_abcd_auto_scheduler_test", (1, 4, 64, 64)),
    ("depthwise_conv2d_layer", (1, 14, 14, 96, 3, 3, [1, 1], [1, 1])),
    ("batch_matmul", (4, 64, 64, 32)),
    ("group_conv2d_layer", (1, 14, 14, 64, 64, 3, 3, 1, 1, 8)),
    ("conv2d_transpose_layer", (1, 8, 8, 64, 128, 4, 4, 2, 1)),
    ("avg_pool2d_layer", (1, 14, 14, 64, 7, 1, 0)),
    ("max_pool2d_layer", (1, 112, 112, 64, 3, 2, 1)),
]


def _tasks(wk, args, target, **hw):
    key = twl.make_workload_key(wk, args)
    if hw:
        return (JTask(key, target, hardware_params=JHW(**hw)),
                TTask(key, target, hardware_params=THW(**hw)))
    return JTask(key, target), TTask(key, target)


def _recs(states):
    return [[s.to_record() for s in st.transform_steps] for st in states]


def _jax_states(jt, recs):
    return [jt.compute_dag.apply_steps(r) for r in recs]


def _close(got, want, atol=ATOL):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.allclose(a, b, atol=atol), i


def _equal(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), i


def _hold_states(jt, tt, states):
    """The port's native features of ``states`` against the JAX Python
    path, the port's Python path and the JAX native path."""
    recs = _recs(states)
    js = _jax_states(jt, recs)
    tfp.FALLBACKS.clear()
    got = tps.get_per_store_features_from_states(states, tt)
    assert not tfp.FALLBACKS, dict(tfp.FALLBACKS)
    _close(got, jps.get_per_store_features_from_states(js, jt,
                                                       use_native=False))
    _close(got, tps.get_per_store_features_from_states(states, tt,
                                                       use_native=False))
    if jax_native_lib():
        _equal(got, jps.get_per_store_features_from_states(js, jt,
                                                           use_native=True))
    return got


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("wk,args", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_workload_families(wk, args, target):
    """Every workload family of the JAX tests on both targets: the GA's
    states featurised natively, all of them without the Python path."""
    jt, tt = _tasks(wk, args, target)
    states = tsketch.make_states(tt, 6, evo_population=10, min_population=4,
                                 seed=2)
    assert states
    _hold_states(jt, tt, states)


def test_rfactor_states():
    """Rfactor sketches (softmax on a one-lane machine) replay natively:
    their features match both Python paths."""
    hw = dict(num_cores=18, vector_unit_bytes=64, cache_line_bytes=64,
              max_shared_memory_per_block=2**31 - 1,
              max_local_memory_per_block=2**31 - 1,
              max_threads_per_block=2**31 - 1, max_vthread_extent=1,
              warp_size=1)
    jt, tt = _tasks("softmax_nm_auto_scheduler_test", (4, 2048),
                    "llvm -mcpu=skylake-avx512", **hw)
    states = tsketch.make_states(tt, 32, evo_population=48,
                                 min_population=16, seed=6)
    assert any(r[0] == "RF" for recs in _recs(states) for r in recs)
    _hold_states(jt, tt, states)


def test_conv3d_states():
    """5-dim spatial ops run the whole native stack."""
    jt, tt = _tasks("conv3d_layer",
                    (1, 4, 14, 14, 32, 32, 3, 3, 3, [1, 1, 1], [1, 1, 1]),
                    "llvm -mcpu=skylake-avx512")
    states = tsketch.make_states(tt, 12, evo_population=16, min_population=8,
                                 seed=2)
    _hold_states(jt, tt, states)


@pytest.mark.parametrize("target", TARGETS)
def test_partially_bound_ga_states(target, monkeypatch):
    """The State GA's children (compute_at resets the moved stage's
    ranges: partially bound) featurise natively as the Python path re-infers
    them."""
    jt, tt = _tasks("conv2d_layer", (1, 14, 14, 64, 64, 3, 3, [1, 1], [1, 1]),
                    target)
    monkeypatch.setattr(tsketch.SketchPolicy,
                        "_evolutionary_search_native", lambda *a, **k: None)
    pol = tsketch.SketchPolicy(tt, seed=3,
                               params={"evolutionary_search_population": 64})
    states = pol.evolutionary_search(pol.sample_initial_population(16), 48)
    assert any(st.stages[-1].iters and st.stages[-1].iters[0].range is None
               or any(it.range is None for sg in st.stages for it in sg.iters)
               for st in states)
    _hold_states(jt, tt, states)


# ---------------------------------------------------------------------------
# whole logs, inputs and record lists
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool_cut(tmp_path_factory):
    """The first 200 CUDA-target records of the committed headline pool."""
    path = tmp_path_factory.mktemp("pool") / "pool200.json"
    with gzip.open(POOL, "rt") as f:
        path.write_text("".join(next(f) for _ in range(200)))
    return str(path)


@pytest.mark.parametrize("log,max_lines", [(RESNET18, None),
                                           (RESNET50, 300), ("pool", None)],
                         ids=["resnet_18", "resnet_50_300", "pool_cuda_200"])
def test_dataset_arrays_from_a_log(log, max_lines, pool_cut):
    """get_per_store_features_from_file (the native parser and batch):
    features within 1e-4 of both Python paths, bit for bit with the JAX
    native path; throughputs, task ids and min costs equal."""
    log = pool_cut if log == "pool" else log
    tfp.FALLBACKS.clear()
    got = tps.get_per_store_features_from_file(log, max_lines=max_lines)
    assert not tfp.FALLBACKS, dict(tfp.FALLBACKS)
    for ref in (jps.get_per_store_features_from_file(
            log, max_lines=max_lines, use_native=False),
            tps.get_per_store_features_from_file(
            log, max_lines=max_lines, use_native=False)):
        _close(got[0], ref[0])
        for a, b in zip(got[1:], ref[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    if jax_native_lib():
        ref = jps.get_per_store_features_from_file(log, max_lines=max_lines,
                                                   use_native=True)
        _equal(got[0], ref[0])
    feats, status = tfp.featurize_perstore_native(log, max_lines=max_lines or
                                                  -1)
    assert (status == 0).all() and not tfp.FALLBACKS, dict(tfp.FALLBACKS)


def test_measure_pairs_inputs():
    """The cost-model update path (MeasureInputs of several tasks, grouped
    per task natively)."""
    jr, tr = jserde.load_records(RESNET18), tserde.load_records(RESNET18)
    got = tps.get_per_store_features_from_measure_pairs(
        [r.inp for r in tr], [r.res for r in tr])
    ref = jps.get_per_store_features_from_measure_pairs(
        [r.inp for r in jr], [r.res for r in jr], use_native=False)
    _close(got[0], ref[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[1:], ref[1:]))
    if jax_native_lib():
        _equal(got[0], jps.get_per_store_features_from_measure_pairs(
            [r.inp for r in jr], [r.res for r in jr])[0])
    assert len({r.inp.task.workload_key for r in tr}) == 8


@pytest.mark.parametrize("with_features", [True, False])
def test_record_lists_keys_and_statuses(pool_cut, with_features):
    """The GA's generation batch: features, dedup keys and statuses equal
    the JAX native batch's; keys do not depend on feature emission."""
    tr = tserde.load_records(pool_cut)
    task = tr[0].inp.task
    recs = [r.inp.step_records for r in tr]
    feats, keys, status = tfp.featurize_perstore_records_native(
        task, recs, with_features=with_features)
    # (the committed pool repeats some structures: 184 keys for 200)
    assert (status == 0).all() and len(set(keys.tolist())) > 0.9 * len(recs)
    full = tfp.featurize_perstore_records_native(task, recs)
    assert np.array_equal(keys, full[1])
    if with_features:
        _close(feats, tps.get_per_store_features_from_states(
            [task.compute_dag.apply_steps(r) for r in recs], task,
            use_native=False))
    else:
        assert all(f is None for f in feats)
    if jax_native_lib():
        jt = JTask(task.workload_key, task.target)
        jf, jk, js = jfp.featurize_perstore_records_native(
            jt, recs, with_features=with_features)
        assert np.array_equal(keys, jk) and np.array_equal(status, js)
        if with_features:
            _equal(feats, jf)


@pytest.mark.parametrize("log", [RESNET18, "pool"], ids=["resnet_18", "pool"])
def test_extent_featuriser(log, pool_cut):
    """featurize_extents_native: labels and statuses as the JAX native
    pipeline's, vectors bit for bit with it and within 1e-4 of the Python
    extent_vector of each recovered state (both packages)."""
    log = pool_cut if log == "pool" else log
    vecs, labels, status = tfp.featurize_extents_native(log)
    assert (status == 0).all() and len(vecs) == len(labels) > 0
    for path_records, ev in ((tserde.load_records(log), text.extent_vector),
                             (jserde.load_records(log), jext.extent_vector)):
        ref = [ev(r.inp.recover_state(infer_bound=True))
               for r in path_records]
        _close(vecs, [np.asarray(v, np.float32) for v in ref])
    if jax_native_lib():
        jv, jl, js = jfp.featurize_extents_native(log)
        _equal(vecs, jv)
        assert np.array_equal(labels, jl) and np.array_equal(status, js)


# ---------------------------------------------------------------------------
# threads, and where the Python path runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["file", "states", "inputs", "records",
                                   "extents"])
def test_threads_do_not_change_a_bit(entry, pool_cut):
    """n_threads 4 gives n_threads 1's output bit for bit."""
    tr = tserde.load_records(pool_cut)
    task = tr[0].inp.task

    def run(n):
        if entry == "file":
            return tfp.featurize_perstore_native(pool_cut, n_threads=n)[0]
        if entry == "states":
            return tfp.featurize_perstore_states_native(
                task, [r.inp.recover_state() for r in tr], n_threads=n)
        if entry == "inputs":
            return tfp.featurize_perstore_inputs_native(
                [r.inp for r in tr], n_threads=n)
        if entry == "records":
            return tfp.featurize_perstore_records_native(
                task, [r.inp.step_records for r in tr], n_threads=n)[0]
        return tfp.featurize_extents_native(pool_cut, n_threads=n)[0]

    _equal(run(4), run(1))


def test_python_path_only_where_asked(monkeypatch):
    """use_native=False or a max_n_bufs other than the default take the
    Python featuriser; the default never does."""
    tr = tserde.load_records(RESNET18, max_lines=8)
    task = tr[0].inp.task
    states = [r.inp.recover_state() for r in tr if r.inp.task == task]
    calls = []
    real = tps.get_per_store_features_from_state
    monkeypatch.setattr(tps, "get_per_store_features_from_state",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tps.get_per_store_features_from_states(states, task)
    tps.get_per_store_features_from_measure_pairs(
        [r.inp for r in tr], [r.res for r in tr])
    assert calls == []
    tps.get_per_store_features_from_states(states, task, use_native=False)
    assert len(calls) == len(states)
    tps.get_per_store_features_from_states(states, task, max_n_bufs=3)
    assert len(calls) == 2 * len(states)
