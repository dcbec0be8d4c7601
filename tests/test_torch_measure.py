"""The port's measurement layer against the JAX package, on the CPU: the
FLOP-repeat policy, the low- and high-fidelity analytic runners (the
high-fidelity one also on CUDA-target records of the committed pool),
replay, the external-timer bridge with each package's toy timer, the
tracker/server service (a port runner against a JAX server too),
``runner_from_spec``, and the collection command lines (dump_programs,
measure_programs / remeasure, print_programs). Host code over the same
inputs: costs are held equal bit for bit.

The JAX package takes native paths where its library is built (the
record-level GA, the per-store featuriser, ``run_record_lists``); the
port has none, so the JAX side is held on its Python paths here, which
its own tests hold equal to the native ones.
"""

import functools
import gzip
import os
import sys

import numpy as np
import pytest

from vae_extent_search_tpu.features import per_store as jps
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records.task import SearchTask as JTask
from vae_extent_search_tpu.search import analytic_hf as jhf
from vae_extent_search_tpu.search import measure as jm
from vae_extent_search_tpu.search import measure_service as jsvc
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu_torch.cli import (
    common,
    dump_programs,
    measure_programs,
    print_programs,
    remeasure,
)
from vae_extent_search_tpu_torch.records import make_workload_key
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records.task import SearchTask as TTask
from vae_extent_search_tpu_torch.search import analytic_hf as thf
from vae_extent_search_tpu_torch.search import measure as tm
from vae_extent_search_tpu_torch.search import measure_service as tsvc
from vae_extent_search_tpu_torch.search import sketch as tsketch
from vae_extent_search_tpu_torch.search.platforms import PLATFORMS
from _torch_parity import pin_port_python_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_LOG = os.path.join(ROOT, "result/conv2d_4k_chip/pool_conv2d_4k.json.gz")
RESNET18 = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")
TGT = "llvm -mcpu=skylake-avx512"
TASKS = {
    "conv2d": make_workload_key("conv2d_layer",
                                (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1])),
    "matmul": make_workload_key("matmul_auto_scheduler_test", (64, 64, 64)),
}
CPU_PLATFORMS = sorted(n for n, p in PLATFORMS.items() if not p.is_gpu)
PORT_TIMER = f"{sys.executable} -m vae_extent_search_tpu_torch.cli.toy_timer"
JAX_TIMER = f"{sys.executable} {os.path.join(ROOT, 'tools', 'toy_timer.py')}"


def _jax_python_paths(mp):
    """Hold the JAX package on its Python paths: its GA without the native
    engine, its per-store featuriser without the native batch."""
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native_recs",
               lambda *a, **k: None)
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native",
               lambda *a, **k: None)
    mp.setattr(jps, "get_per_store_features_from_states",
               functools.partial(jps.get_per_store_features_from_states,
                                 use_native=False))
    pin_port_python_paths(mp)


@pytest.fixture(scope="module")
def jax_python():
    mp = pytest.MonkeyPatch()
    _jax_python_paths(mp)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pools(jax_python):
    """64 states of each task from each package's make_states (seed 7)."""
    out = {}
    for name, wk in TASKS.items():
        jt, tt = JTask(wk, TGT), TTask(wk, TGT)
        js = jsketch.make_states(jt, 64, seed=7)
        ts = tsketch.make_states(tt, 64, seed=7)
        assert [s.to_str() for s in ts] == [s.to_str() for s in js]
        out[name] = (jt, js, tt, ts)
    return out


def _costs(results):
    return [(r.costs, r.error_no) for r in results]


@pytest.fixture
def port_pythonpath(monkeypatch):
    """The port's timer runs as ``python -m``: its package on the path."""
    monkeypatch.setenv("PYTHONPATH", ROOT)


# ---------------------------------------------------------------------------
# the repeat policy and the analytic runners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flop,want", [
    (1.0, 10), (2097152.0, 10), (2097153.0, 8), (834928639.0, 8),
    (834928640.0, 6), (2416443391.0, 6), (2416443392.0, 4), (1e12, 4)])
def test_flop_repeat_count(flop, want):
    assert tm.flop_repeat_count(flop) == jm.flop_repeat_count(flop) == want


@pytest.mark.parametrize("platform", ["auto"] + CPU_PLATFORMS)
@pytest.mark.parametrize("repeat", [1, 4])
@pytest.mark.parametrize("noise", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(TASKS))
def test_analytic_low_fidelity_bit_identical(pools, name, noise, repeat,
                                             platform):
    jt, js, tt, ts = pools[name]
    kw = dict(noise=noise, seed=3, repeat=repeat, platform=platform)
    got = _costs(tm.AnalyticRunner(**kw).run(tt, ts))
    want = _costs(jm.AnalyticRunner(**kw).run(jt, js))
    assert got == want
    assert all(len(c) == repeat and e == 0 for c, e in got)


def test_analytic_custom_constants_pin_no_platform(pools):
    jt, js, tt, ts = pools["conv2d"]
    kw = dict(peak_gflops=50.0, num_cores=4, noise=0.2)
    r = tm.AnalyticRunner(**kw)
    assert r.platform is None
    assert _costs(r.run(tt, ts)) == _costs(jm.AnalyticRunner(**kw).run(jt, js))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hf_cost_on_random_features(seed):
    """Random feature matrices in the featuriser's ranges (slog values,
    one-hots, the is_gpu flag on some rows)."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 6))
        f = rng.uniform(0, 20, (n, 164)).astype(np.float32)
        f[:, thf.F_IS_GPU] = rng.integers(0, 2, n)
        f[rng.random((n, 164)) < 0.3] = 0.0
        hw = PLATFORMS[sorted(PLATFORMS)[int(rng.integers(len(PLATFORMS)))]].hf
        got = thf.hf_cost_from_features(f, hw)
        assert got == jhf.hf_cost_from_features(f, hw)
        assert np.isfinite(got) and got > 0
    mats = [rng.uniform(0, 10, (3, 164)) for _ in range(4)]
    assert thf.hf_costs_batch(mats) == jhf.hf_costs_batch(mats)


def test_hf_error_conventions():
    inf = float("inf")
    for f in (np.zeros((1, 164), np.float32), np.zeros((0, 164)),
              np.ones(164)):
        assert thf.hf_cost_from_features(f) == inf
        assert jhf.hf_cost_from_features(f) == inf
    batch = [None, np.zeros((1, 164), np.float32), np.ones((2, 164))]
    assert thf.hf_costs_batch(batch) == jhf.hf_costs_batch(batch)
    assert thf.hf_costs_batch(batch)[:2] == [inf, inf]


@pytest.fixture(scope="module")
def hf_pool(jax_python):
    """The CPU pool of the JAX package's high-fidelity tests: 400 states
    of a 32-channel conv2d (population 512, minimum 64, seed 3)."""
    wk = make_workload_key("conv2d_layer",
                           (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1]))
    jt, tt = JTask(wk, TGT), TTask(wk, TGT)
    kw = dict(evo_population=512, min_population=64, seed=3)
    return jt, jsketch.make_states(jt, 400, **kw), tt, \
        tsketch.make_states(tt, 400, **kw)


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_hf_runner_on_the_cpu_pool(hf_pool, noise):
    jt, js, tt, ts = hf_pool
    assert len(ts) == 400
    got = _costs(tm.AnalyticRunner(fidelity="high", noise=noise,
                                   seed=5).run(tt, ts))
    want = _costs(jm.AnalyticRunner(fidelity="high", noise=noise,
                                    seed=5).run(jt, js))
    assert got == want
    costs = [c[0] for c, e in got if e == 0]
    assert len(costs) == 400 and len(set(costs)) > 200


def _cuda_records(n):
    with gzip.open(POOL_LOG, "rt") as f:
        lines = [next(f) for _ in range(n)]
    return ([tserde.record_from_json(x) for x in lines],
            [jserde.record_from_json(x) for x in lines])


@pytest.mark.parametrize("platform", ["auto", "k80", "t4"])
def test_hf_gpu_branch_on_committed_cuda_records(jax_python, platform):
    """64 CUDA-target records of the committed pool, recovered with bound
    inference: the GPU pricing rows (is_gpu, thread and block extents)."""
    trecs, jrecs = _cuda_records(64)
    tt, jt = trecs[0].inp.task, jrecs[0].inp.task
    assert tt.target.split()[0] == "cuda"
    ts = [r.inp.recover_state(infer_bound=True) for r in trecs]
    js = [r.inp.recover_state(infer_bound=True) for r in jrecs]
    from vae_extent_search_tpu_torch.features.per_store import (
        get_per_store_features_from_states,
    )
    feats = get_per_store_features_from_states(ts, tt)
    assert all(f[:, thf.F_IS_GPU].max() == 1.0 for f in feats)
    hw = (PLATFORMS[platform] if platform != "auto" else PLATFORMS["k80"]).hf
    assert thf.hf_costs_batch(feats, hw) == jhf.hf_costs_batch(feats, hw)
    kw = dict(fidelity="high", noise=0.3, platform=platform)
    got = _costs(tm.AnalyticRunner(**kw).run(tt, ts))
    assert got == _costs(jm.AnalyticRunner(**kw).run(jt, js))
    costs = [c[0] for c, e in got if e == 0]
    assert len(costs) == 64 and all(np.isfinite(costs))
    assert len(set(costs)) >= 0.9 * len(costs)


def test_run_record_lists_defers_to_the_state_path(pools):
    """The record-level batch gives the State path's costs bit for bit,
    and a record the native replay refuses (an annotation outside the
    enum) is measured down the State path, one record, counted."""
    from vae_extent_search_tpu_torch.records import fast_parser as tfp

    _, _, tt, ts = pools["matmul"]
    recs = [[s.to_record() for s in st.transform_steps] for st in ts]
    bad = [list(r) for r in recs[0]]
    i = next(k for k, r in enumerate(bad) if r[0] == "AN")
    bad[i] = ["AN", bad[i][1], bad[i][2], 99]
    tfp.FALLBACKS.clear()
    got = tm.AnalyticRunner(noise=0.2).run_record_lists(tt, recs + [bad])
    assert dict(tfp.FALLBACKS) == {"analytic:state_path": 1}
    # the States as a record replays them (remeasure_file's State path)
    states = [tt.compute_dag.infer_bound(tt.compute_dag.apply_steps(r))
              for r in recs] + [tt.compute_dag.apply_steps(bad)]
    assert _costs(got) == _costs(tm.AnalyticRunner(noise=0.2).run(tt, states))


# ---------------------------------------------------------------------------
# replay, the external timer, the service
# ---------------------------------------------------------------------------


def test_record_replay_hit_and_miss(pools):
    jt, js, tt, ts = pools["conv2d"]
    res = tm.AnalyticRunner(noise=0.2).run(tt, ts[:40])
    trecs = [tserde.make_record(tt, st.transform_steps, r.costs, r.error_no,
                                r.all_cost, r.timestamp)
             for st, r in zip(ts, res)]
    jrecs = [jserde.record_from_json(tserde.record_to_json(r)) for r in trecs]
    got = tm.RecordReplayRunner(trecs).run(tt, ts)
    want = jm.RecordReplayRunner(jrecs).run(jt, js)
    assert [(r.costs, r.error_no) for r in got] == \
        [(r.costs, r.error_no) for r in want]
    assert [r.costs for r in got[:40]] == [r.costs for r in res]
    assert all(r.error_no == tserde.ERROR_RUNTIME_DEVICE
               and r.costs == [tserde.MAX_FLOAT] for r in got[40:])
    assert all(r.costs == [0.0] for r in tm.EmptyRunner().run(tt, ts[:3]))


def _timer_pair(timeout=120, repeat=1):
    return (tm.CommandRunner(PORT_TIMER, timeout=timeout, repeat=repeat),
            jm.CommandRunner(JAX_TIMER, timeout=timeout, repeat=repeat))


def test_command_runner_round_trip(pools, port_pythonpath, tmp_path):
    """The port's timer and the JAX one write the same lines: the analytic
    cost at 9 significant digits; measured through ProgramMeasurer, the
    records land in the log."""
    jt, js, tt, ts = pools["matmul"]
    trun, jrun = _timer_pair()
    log = str(tmp_path / "rec.json")
    measurer = tm.ProgramMeasurer(tm.EmptyBuilder(), trun,
                                  callbacks=[tm.RecordToFile(log)])
    got = measurer.measure(tt, ts[:8])
    assert _costs(got) == _costs(jrun.run(jt, js[:8]))
    direct = tm.AnalyticRunner(noise=0.2).run(tt, ts[:8])
    assert [r.costs for r in got] == \
        [[float(f"{c:.9g}") for c in r.costs] for r in direct]
    recs = tserde.load_records(log)
    assert [r.res.costs for r in recs] == [r.costs for r in got]
    assert measurer.best_cost[tt.workload_key] == min(r.costs[0] for r in got)


def test_command_runner_error_lines(pools, port_pythonpath, monkeypatch):
    monkeypatch.setenv("TOY_TIMER_FAIL_EVERY", "3")
    jt, js, tt, ts = pools["matmul"]
    trun, jrun = _timer_pair()
    got = trun.run(tt, ts[:6])
    assert _costs(got) == _costs(jrun.run(jt, js[:6]))
    assert [i for i, r in enumerate(got)
            if r.error_no == tserde.ERROR_RUNTIME_DEVICE] == [2, 5]


def test_command_runner_timeout(pools, port_pythonpath, monkeypatch):
    monkeypatch.setenv("TOY_TIMER_SLEEP", "30")
    jt, js, tt, ts = pools["matmul"]
    trun, jrun = _timer_pair(timeout=3)
    got = trun.run(tt, ts[:2])
    assert _costs(got) == _costs(jrun.run(jt, js[:2]))
    assert all(r.error_no == tserde.ERROR_RUNTIME_DEVICE for r in got)


def test_command_runner_repeat_contract(pools, port_pythonpath):
    """repeat > 1 goes on the timer's argv; every line carries that many
    comma-separated costs, the first equal to the single-repeat one."""
    jt, js, tt, ts = pools["matmul"]
    trun, jrun = _timer_pair(repeat=6)
    got = trun.run(tt, ts[:5])
    assert _costs(got) == _costs(jrun.run(jt, js[:5]))
    assert all(len(r.costs) == 6 and r.error_no == 0 for r in got)
    one = _timer_pair()[0].run(tt, ts[:5])
    assert [r.costs[0] for r in got] == [r.costs[0] for r in one]


def test_measure_service_tracker_topology(pools, tmp_path):
    """Two servers under one key: the runner round-robins batches over
    them through the tracker; costs equal the backend's bit for bit."""
    jt, js, tt, ts = pools["conv2d"]
    tracker = tsvc.MeasureTracker()
    servers = []
    try:
        for _ in range(2):
            servers.append(tsvc.MeasureServer(
                tm.AnalyticRunner(noise=0.2), key="h100",
                tracker_addr=tracker.addr))
        runner = tsvc.ServiceRunner("h100", *tracker.addr, timeout=60)
        log = str(tmp_path / "svc.json")
        measurer = tm.ProgramMeasurer(tm.EmptyBuilder(), runner,
                                      callbacks=[tm.RecordToFile(log)])
        got = measurer.measure(tt, ts[:4]) + measurer.measure(tt, ts[4:8])
        want = jm.AnalyticRunner(noise=0.2).run(jt, js[:8])
        assert _costs(got) == _costs(want)
        assert len(tserde.load_records(log)) == 8
        assert tracker._rr["h100"] == 1
    finally:
        for s in servers:
            s.close()
        tracker.close()


def test_measure_service_failover_and_unknown_key(pools):
    jt, js, tt, ts = pools["conv2d"]
    tracker = tsvc.MeasureTracker()
    dead = tsvc.MeasureServer(tm.AnalyticRunner(), key="h100",
                              tracker_addr=tracker.addr)
    dead.close()  # registered, but gone
    live = tsvc.MeasureServer(tm.AnalyticRunner(noise=0.2), key="h100",
                              tracker_addr=tracker.addr)
    try:
        runner = tsvc.ServiceRunner("h100", *tracker.addr, timeout=10)
        want = _costs(jm.AnalyticRunner(noise=0.2).run(jt, js[:3]))
        for _ in range(2):
            assert _costs(runner.run(tt, ts[:3])) == want
        assert tracker._servers["h100"] == [live.addr]
        nobody = tsvc.ServiceRunner("v100", *tracker.addr, timeout=5)
        assert all(r.error_no == tserde.ERROR_RUNTIME_DEVICE
                   for r in nobody.run(tt, ts[:3]))
    finally:
        live.close()
        tracker.close()


def test_local_service_measure_context(pools):
    jt, js, tt, ts = pools["conv2d"]
    with tsvc.LocalServiceMeasureContext() as ctx:
        got = ctx.runner.run(tt, ts[:6])
    assert _costs(got) == _costs(jm.AnalyticRunner(noise=0.2).run(jt, js[:6]))


@pytest.mark.parametrize("side", ["port_runner_jax_server",
                                  "jax_runner_port_server"])
def test_service_wire_format_across_packages(pools, side):
    """A runner of one package measures through the tracker and server of
    the other: the same newline-delimited JSON record lines."""
    jt, js, tt, ts = pools["conv2d"]
    srv_mod, srv_runner, cli_mod, task, states = (
        (jsvc, jm.AnalyticRunner(noise=0.2), tsvc, tt, ts)
        if side == "port_runner_jax_server"
        else (tsvc, tm.AnalyticRunner(noise=0.2), jsvc, jt, js))
    tracker = srv_mod.MeasureTracker()
    server = srv_mod.MeasureServer(srv_runner, key="k",
                                   tracker_addr=tracker.addr)
    try:
        got = cli_mod.ServiceRunner("k", *tracker.addr,
                                    timeout=60).run(task, states[:8])
    finally:
        server.close()
        tracker.close()
    assert _costs(got) == _costs(tm.AnalyticRunner(noise=0.2).run(tt, ts[:8]))


# ---------------------------------------------------------------------------
# runner_from_spec
# ---------------------------------------------------------------------------


def _replay_log(tmp_path, pools):
    _, _, tt, ts = pools["matmul"]
    path = str(tmp_path / "replay.json")
    res = tm.AnalyticRunner().run(tt, ts[:4])
    tserde.save_records(path, [
        tserde.make_record(tt, st.transform_steps, r.costs, 0, 0.0, 0.0)
        for st, r in zip(ts, res)], mode="w")
    return path


@pytest.mark.parametrize("spec", [
    "analytic", "analytic:epyc-7452", "analytic_hf", "analytic_hf:t4",
    "replay", "command:toy --flag", "service:h100@127.0.0.1:9190"])
def test_runner_from_spec_shared_specs(spec, pools, tmp_path):
    log = _replay_log(tmp_path, pools) if spec == "replay" else None
    got = tm.runner_from_spec(spec, noise=0.05, seed=3, replay_log=log)
    want = jm.runner_from_spec(spec, noise=0.05, seed=3, replay_log=log)
    assert type(got).__name__ == type(want).__name__
    for attr in ("noise", "seed", "fidelity", "platform", "repeat",
                 "command", "timeout", "key", "tracker_addr"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    if spec == "replay":
        assert got.by_state.keys() == want.by_state.keys()


@pytest.mark.parametrize("spec,cls,dtype", [
    ("cuda_matmul", "MatmulRunner", "bfloat16"),
    ("cuda_matmul:float32", "MatmulRunner", "float32"),
    ("cuda_conv2d", "Conv2dRunner", "bfloat16"),
    ("cuda_conv2d:float32", "Conv2dRunner", "float32"),
    ("cuda_kernels", "KernelRunner", "bfloat16"),
    ("cuda_kernels:float32", "KernelRunner", "float32")])
def test_runner_from_spec_cuda_kernels(spec, cls, dtype):
    r = tm.runner_from_spec(spec)
    assert type(r).__name__ == cls and r.dtype == dtype and r.verbose
    assert r.device.type == "cuda"


@pytest.mark.parametrize("spec,match", [
    ("replay", "needs --replay-log"),
    ("pallas_matmul", "cuda_matmul"),
    ("pallas_matmul:float32", "cuda_matmul"),
    ("pallas_conv2d", "cuda_conv2d"),
    ("pallas_conv2d:bfloat16", "cuda_conv2d"),
    ("pallas", "cuda_kernels"),
    ("pallas:float32", "cuda_kernels"),
    ("bogus", "unknown --runner")])
def test_runner_from_spec_exits(spec, match):
    with pytest.raises(SystemExit, match=match):
        tm.runner_from_spec(spec)


def test_analytic_rejects_unknown_fidelity():
    with pytest.raises(ValueError):
        tm.AnalyticRunner(fidelity="medium")


# ---------------------------------------------------------------------------
# the collection command lines
# ---------------------------------------------------------------------------


def _to_measure(path, task, states, repeat=1):
    tserde.save_records(path, [
        tserde.make_record(task, st.transform_steps, [0.0], 0, 0.0, 0)
        for st in states] * repeat, mode="w")
    return path


def _jax_state_costs(path, runner, target=None):
    """The JAX AnalyticRunner over the states the JAX package recovers
    from the file's records (its State path), in batches of 64."""
    recs = jserde.load_records(path)
    task = recs[0].inp.task
    if target:
        task = JTask(task.workload_key, target)
    out = []
    for s in range(0, len(recs), 64):
        states = [r.inp.recover_state(infer_bound=True)
                  for r in recs[s:s + 64]]
        out += _costs(runner.run(task, states))
    return task.target, out


@pytest.mark.parametrize("flop_repeats", [True, False])
@pytest.mark.parametrize("fidelity", ["low", "high"])
def test_remeasure_file_equals_the_jax_state_path(pools, tmp_path,
                                                  flop_repeats, fidelity):
    _, _, tt, ts = pools["matmul"]
    src = _to_measure(str(tmp_path / "pool.json"), tt, ts)
    out = str(tmp_path / "out.json")
    n = measure_programs.remeasure_file(
        src, out, tm.AnalyticRunner(noise=0.3, fidelity=fidelity),
        flop_repeats=flop_repeats)
    repeat = tm.flop_repeat_count(tt.compute_dag.flop_ct) \
        if flop_repeats else 1
    assert n == 64 and repeat == 10 ** flop_repeats
    _, want = _jax_state_costs(src, jm.AnalyticRunner(
        noise=0.3, fidelity=fidelity, repeat=repeat))
    got = tserde.load_records(out)
    assert [(r.res.costs, r.res.error_no) for r in got] == want
    assert all(len(r.res.costs) == repeat for r in got)


def test_remeasure_file_retargets_within_a_kind(pools, tmp_path):
    _, _, tt, ts = pools["conv2d"]
    src = _to_measure(str(tmp_path / "pool.json"), tt, ts[:16])
    out = str(tmp_path / "out.json")
    target = PLATFORMS["epyc-7452"].target
    measure_programs.remeasure_file(src, out, tm.AnalyticRunner(noise=0.3),
                                    target=target)
    got = tserde.load_records(out)
    assert {r.inp.task.target for r in got} == {target}
    jtarget, want = _jax_state_costs(src, jm.AnalyticRunner(
        noise=0.3, repeat=tm.flop_repeat_count(tt.compute_dag.flop_ct)),
        target=target)
    assert [(r.res.costs, r.res.error_no) for r in got] == want
    with pytest.raises(SystemExit, match="does not match the pool's kind"):
        measure_programs.remeasure_file(src, out, tm.AnalyticRunner(),
                                        target="cuda -model=t4")


class _FailAfter:
    """A runner whose first ``ok`` states measure and every later one
    fails; ``errors`` is the result type's module."""

    def __init__(self, serde, ok):
        self.serde, self.ok, self.seen = serde, ok, 0

    def run(self, task, states):
        out = []
        for _ in states:
            self.seen += 1
            good = self.seen <= self.ok
            out.append(self.serde.MeasureResult(
                [1e-3 * self.seen] if good else [self.serde.MAX_FLOAT],
                0 if good else self.serde.ERROR_RUNTIME_DEVICE, 0.0, 0.0))
        return out


def test_remeasure_file_aborts_after_150_errors_keeping_earlier_batches(
        pools, tmp_path):
    """Ten good states, then errors: the 150th error in a row falls in the
    third batch of 64; the first two batches stay in the log, as with the
    JAX package's State path."""
    _, _, tt, ts = pools["matmul"]
    src = _to_measure(str(tmp_path / "pool.json"), tt, ts, repeat=4)
    out = str(tmp_path / "out.json")
    with pytest.raises(RuntimeError, match="continuous measurement errors"):
        measure_programs.remeasure_file(src, out, _FailAfter(tserde, 10))
    sys.path.insert(0, ROOT)
    from scripts.measure_programs import remeasure_file as jremeasure

    jout = str(tmp_path / "jout.json")
    with pytest.raises(RuntimeError, match="continuous measurement errors"):
        jremeasure(src, jout, _FailAfter(jserde, 10))
    got, want = tserde.load_records(out), jserde.load_records(jout)
    assert len(got) == len(want) == 128
    assert [(r.res.costs, r.res.error_no) for r in got] == \
        [(r.res.costs, r.res.error_no) for r in want]


def test_dump_task_equals_records_of_jax_make_states(jax_python, tmp_path):
    wk = TASKS["conv2d"]
    out = str(tmp_path / "pool.json")
    assert dump_programs.dump_task(TTask(wk, TGT), out, 64, seed=11) == 64
    jt = JTask(wk, TGT)
    want = [jserde.record_to_json(jserde.make_record(
        jt, [s.to_record() for s in st.transform_steps], costs=[0.0],
        timestamp=0)) for st in jsketch.make_states(jt, 64, seed=11)]
    with open(out) as f:
        assert f.read().splitlines() == want


@pytest.fixture
def dataset_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name in ("DATASET_ROOT", "NETWORK_INFO_FOLDER",
                 "MEASURE_RECORD_FOLDER", "TO_MEASURE_PROGRAM_FOLDER"):
        monkeypatch.setattr(common, name, getattr(common, name))
    common.set_dataset_root(str(tmp_path / "ds"))
    return tmp_path


def test_collection_pipeline_through_the_command_lines(dataset_root, capsys):
    """dump_programs -> measure_programs --runner analytic_hf (FLOP
    repeats) -> remeasure --runner replay reproduces the measured log's
    costs bit for bit; --resume skips; print_programs prints it."""
    wk = TASKS["matmul"]
    got = dump_programs.main(["--workload-key", wk, "--target", TGT,
                              "--n-states", "48", "--seed", "5"])
    (pool, n), = got.items()
    assert n == 48 and pool == os.path.join(
        common.TO_MEASURE_PROGRAM_FOLDER,
        common.clean_name((wk, "llvm")) + ".json")
    measured = measure_programs.main(["--runner", "analytic_hf", "--noise",
                                      "0.3"])
    (out, n), = measured.items()
    assert n == 48 and out == os.path.join(common.MEASURE_RECORD_FOLDER,
                                           os.path.basename(pool))
    recs = tserde.load_records(out)
    assert all(len(r.res.costs) == 10 and r.res.error_no == 0 for r in recs)
    assert measure_programs.main(["--runner", "analytic", "--resume"]) == {}
    assert "exists, skip" in capsys.readouterr().out
    replayed = str(dataset_root / "replayed.json")
    assert remeasure.main([pool, replayed, "--runner", "replay",
                           "--replay-log", out]) == 48
    again = tserde.load_records(replayed)
    assert [r.res.costs for r in again] == [r.res.costs for r in recs]
    assert [r.inp.step_records for r in again] == \
        [r.inp.step_records for r in recs]
    capsys.readouterr()
    states = print_programs.main([out, "--idx", "0"])
    text = capsys.readouterr().out
    assert len(states) == 1 and text.startswith("=== program 0  cost ")
    assert states[0][0].to_str(True) in text


def test_measure_programs_target_folder_and_shards(dataset_root, pools):
    _, _, tt, ts = pools["conv2d"]
    os.makedirs(common.TO_MEASURE_PROGRAM_FOLDER)
    for i in range(3):
        _to_measure(os.path.join(common.TO_MEASURE_PROGRAM_FOLDER,
                                 f"p{i}.json"), tt, ts[8 * i:8 * i + 8])
    target = PLATFORMS["graviton2"].target
    got = measure_programs.main(["--target", target, "--start-idx", "1",
                                 "--step-idx", "1", "--no-flop-repeats"])
    folder = os.path.join(common.MEASURE_RECORD_FOLDER, "graviton2")
    assert got == {os.path.join(folder, f"p{i}.json"): 8 for i in (1, 2)}
    for path in got:
        recs = tserde.load_records(path)
        assert {r.inp.task.target for r in recs} == {target}
        assert all(len(r.res.costs) == 1 for r in recs)


def test_print_programs_equals_jax(capsys, monkeypatch):
    sys.path.insert(0, ROOT)
    from scripts import print_programs as jprint

    for argv in (["--max-lines", "6"], ["--max-lines", "12", "--idx", "3"]):
        print_programs.main([RESNET18] + argv)
        got = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["print_programs.py", RESNET18]
                            + argv)
        jprint.main()
        assert got == capsys.readouterr().out and got.count("=== program")


def test_dispatcher_default_measurer_is_analytic(pools, tmp_path):
    """ApplyHistoryBestOrSample without a measurer measures its samples
    with AnalyticRunner and writes them to log_file through RecordToFile."""
    from vae_extent_search_tpu_torch.records.dispatcher import (
        ApplyHistoryBestOrSample,
    )

    log = str(tmp_path / "sampled.json")
    wk = TASKS["matmul"]
    d = ApplyHistoryBestOrSample([], num_measure=3, log_file=log)
    assert np.isfinite(d.best_cost("llvm", wk))
    recs = tserde.load_records(log)
    assert len(recs) == 3
    task = recs[0].inp.task
    states = [r.inp.recover_state() for r in recs]
    assert [r.res.costs for r in recs] == \
        [r.costs for r in tm.AnalyticRunner().run(task, states)]
