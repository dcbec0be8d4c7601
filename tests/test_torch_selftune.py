"""The rest of self-tuning on the CPU: the fused head's and the histogram's
schedule quotients, snaps and launch plans, their runners under stand-in
timers, the composite runner, ``cli.tune_kernel_suite`` against the JAX
script, and the tuned configs reaching ``select_programs`` and
``boost_device.train`` through the process kernel library.

The JAX side runs its Python GA (``_torch_parity.pin_jax_python_paths``)
at a population of 48, as the port does here."""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import (
    np_predictor_params,
    pin_jax_python_paths,
    pin_port_python_paths,
    small_ga_population,
    to_torch,
)
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.search import pallas_tuner as jpt
from vae_extent_search_tpu_torch.cli import tune_kernel_suite as tks
from vae_extent_search_tpu_torch.ir.schedule_api import (
    state_fuse,
    state_reorder,
    state_split,
)
from vae_extent_search_tpu_torch.models import boost, boost_device
from vae_extent_search_tpu_torch.ops import fused_head as fh
from vae_extent_search_tpu_torch.ops import hist as th
from vae_extent_search_tpu_torch.ops import kernel_library as kl
from vae_extent_search_tpu_torch.records import SearchTask, make_workload_key
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records.serde import (
    ERROR_BUILD_TIMEOUT,
    ERROR_NO_ERROR,
)
from vae_extent_search_tpu_torch.search import kernel_tuner as kt
from vae_extent_search_tpu_torch.search import select as ts
from vae_extent_search_tpu_torch.search.measure import (
    EmptyBuilder,
    ProgramMeasurer,
    RecordToFile,
    runner_from_spec,
)
from vae_extent_search_tpu_torch.search.sketch import make_states

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = (773, 17, 256, 64, 10)
CENSUS = (120000, 164, 98, 6, 8, 12)
POP = 48


def _fh_task(dims=MAIN, target="llvm"):
    return SearchTask(make_workload_key("fused_head_layer", dims), target)


def _gh_task(dims=CENSUS, target="llvm"):
    return SearchTask(make_workload_key("gbdt_hist_layer", dims), target)


def _mc_stage(st):
    return next(i for i, s in enumerate(st.stages) if s.op.name == "MC")


def _hist_stage(st):
    return next(i for i, s in enumerate(st.stages) if s.op.name == "hist")


@pytest.fixture
def python_paths():
    mp = pytest.MonkeyPatch()
    pin_jax_python_paths(mp)
    pin_port_python_paths(mp)
    small_ga_population(mp, POP)
    yield mp
    mp.undo()


# ---------------------------------------------------------------------------
# schedule -> config quotients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,seed", [(MAIN, 5), ((262144, 24, 256, 64, 10),
                                                    11),
                                       ((4096, 24, 256, 64, 7), 3)])
def test_fusedhead_config_equals_jax_on_ga_states(tmp_path, dims, seed):
    """The port's GA states, written as records and recovered by both
    packages, quotient onto the same (block, mc_chunk) in both."""
    task = _fh_task(dims)
    states = make_states(task, 24, evo_population=48, min_population=12,
                         seed=seed)
    path = str(tmp_path / "fh.json")
    tserde.save_records(path, [
        tserde.make_record(task, st.transform_steps, [1.0]) for st in states],
        mode="w")
    mine = [kt.state_to_fusedhead_config(r.inp.recover_state())
            for r in tserde.load_records(path)]
    want = [jpt.state_to_fusedhead_config(r.inp.recover_state())
            for r in jserde.load_records(path)]
    assert mine == want
    cfgs = {c for c, _ in mine if c is not None}
    assert len(cfgs) >= 3 and len([c for c, _ in mine if c]) >= 20


def test_fusedhead_config_hand_tiled_equals_jax():
    """A hand-tiled MC nest (the JAX test's): i tiles inside the outermost
    reduction give the block, t tiles the MC chunk, and the A1 stage's
    like-named k loop does not take the cut."""
    from vae_extent_search_tpu.ir import schedule_api as jsa
    from vae_extent_search_tpu.records import SearchTask as JTask

    dims = (4096, 24, 256, 64, 10)
    got = []
    for task, api, fn in (
            (_fh_task(dims), (state_split, state_reorder),
             kt.state_to_fusedhead_config),
            (JTask(make_workload_key("fused_head_layer", dims), "llvm"),
             (jsa.state_split, jsa.state_reorder),
             jpt.state_to_fusedhead_config)):
        split, reorder = api
        st = task.compute_dag.init_state.copy()
        sid = _mc_stage(st)
        t_it, i_it, k_it = st.stages[sid].iters
        t0, t1 = split(st, sid, t_it, [2])
        i0, i1, i2 = split(st, sid, i_it, [4, 512])
        k0, k1 = split(st, sid, k_it, [16])
        reorder(st, sid, [t0, i0, k0, t1, i1, k1, i2])
        got.append(fn(st))
    assert got[0] == got[1] == ((4 * 512, 2), None)


@pytest.mark.parametrize("T,tc,G", [
    (10, 10, 1), (10, 99, 1), (10, 5, 3), (10, 3, 5), (10, 2, 6),
    (10, 1, 11), (10, 0, 11), (7, 3, 4), (1, 1, 1), (40, 1, 32)])
def test_snap_fused_groups(T, tc, G):
    """G = 1 where the MC chunk covers the T passes, else 1 + ceil(T /
    tc), clamped to [1, min(T + 1, MAX_GROUPS)]; the block maps onto
    nothing, and every G is one the kernel takes."""
    assert fh.snap_fused_groups(773, T, 1024, tc) == G
    assert fh.snap_fused_groups(262144, T, 32, tc) == G
    assert fh.pass_bounds(T, G)[-1] == T


def test_default_config_state_is_the_hand_default():
    """The fused head's default state snaps onto launch_plan's G at 132
    SMs (5 at the main shape, 1 at the bench shape); the histogram's is
    the unsplit state, read as launch_plan's own plan (0, 0)."""
    for dims, G in ((MAIN, 5), ((262144, 24, 256, 64, 10), 1),
                    ((773, 17, 256, 64, 7), 5)):
        task = _fh_task(dims)
        st = task.compute_dag.infer_bound(kt.default_config_state(task))
        raw, why = kt.state_to_fusedhead_config(st)
        assert why is None
        assert fh.snap_fused_groups(dims[0], dims[4], *raw) == G
        assert kt.default_config(task) == (G,) == (
            fh.launch_plan(dims[0], dims[4], 132)[0],)
    task = _gh_task()
    st = kt.default_config_state(task)
    assert kt.state_to_hist_plan(st) == ((0, 0), None)
    assert kt.default_config(task) == (0, 0)
    assert kt.default_config_state(SearchTask(make_workload_key(
        "matmul_auto_scheduler_test", (64, 64, 64)), "llvm")) is None


def _split_hist(splits, fuse=False):
    """The gbdt_hist_layer state with the hist stage's axes split by
    ``splits`` {axis index: factors} (f 0, b 1, m 2, r 3), optionally with
    b moved outermost and fused with f's outermost tile (the parallel
    fuse of the CPU sketch)."""
    task = _gh_task((4096, 40, 10, 4, 4, 4))
    st = task.compute_dag.init_state.copy()
    sid = _hist_stage(st)
    its = list(st.stages[sid].iters)
    for ax in sorted(splits, reverse=True):
        state_split(st, sid, its[ax], splits[ax])
    if fuse:
        its = list(st.stages[sid].iters)
        b = next(it for it in its if it.name == "b")
        state_reorder(st, sid, [b] + [it for it in its if it is not b])
        its = list(st.stages[sid].iters)
        state_fuse(st, sid, its[:2])
    return task.compute_dag.infer_bound(st)


@pytest.mark.parametrize("splits,fuse,want", [
    ({}, False, (0, 0)),
    ({0: [2, 5]}, False, (10, 0)),
    ({0: [2, 5]}, True, (10, 0)),
    ({0: [4, 5]}, True, (20, 0)),
    ({3: [512]}, False, (0, 8)),
    ({0: [4], 3: [128, 8]}, False, (4, 4)),
    ({1: [16], 2: [4]}, False, (0, 0))])
def test_state_to_hist_plan_hand_built(splits, fuse, want):
    """f's inner tiles multiply innermost-first up to a fused one or the
    outermost (the cap on features per block); r's outermost tile is the
    row ranges; an unsplit axis is launch_plan's own choice (0), whatever
    b and m do."""
    assert kt.state_to_hist_plan(_split_hist(splits, fuse)) == (want, None)


def test_state_to_hist_plan_on_ga_pool():
    task = _gh_task()
    plans = set()
    for st in make_states(task, 30, evo_population=48, min_population=12,
                          seed=2):
        plan, why = kt.state_to_hist_plan(st)
        assert why is None and all(v >= 0 for v in plan)
        plans.add(kt.snap_hist_plan(*CENSUS[:2], 256, *plan))
    assert len(plans) >= 3


@pytest.mark.parametrize("d,n,nb,features,chunks", [
    (164, 1_000_000, 256, 8, 3), (164, 1_000_000, 256, 64, 1),
    (164, 120_000, 256, 1, 29), (164, 120_000, 256, 200, 1000),
    (9, 700, 40, 2, 5), (164, 1_000_000, 256, None, 7)])
def test_launch_plan_caps_are_legal_at_every_level(d, n, nb, features,
                                                   chunks):
    """A tuned plan is clamped at every level of a depth-6 tree: a block's
    histograms fit in shared memory, no block takes more features than the
    cap (or than launch_plan's own), the row ranges cover every row in
    multiples of 4, and there are no more of them than asked for nor than
    the rows allow."""
    for lv in range(6):
        m = 1 << lv
        own_F, own_rows = th.launch_plan(d, n, m, nb)
        F, rows = th.launch_plan(d, n, m, nb, 132, features, chunks)
        assert 1 <= F <= own_F and F * th.feature_smem_bytes(m, nb) <= \
            th.HIST_SMEM_BYTES
        if features:
            assert F <= features
        assert rows % 4 == 0 or rows == n
        nch = -(-n // rows)
        assert 1 <= nch and nch * rows >= n
        if chunks:
            assert nch <= chunks
            assert nch <= max(1, n // max(th.MIN_ROWS, 4 * m * nb))
        else:
            assert rows == own_rows
    # no cap is launch_plan's own plan
    assert th.launch_plan(d, n, 1, nb, 132, None, None) == \
        th.launch_plan(d, n, 1, nb, 132, 0, 0) == th.launch_plan(d, n, 1, nb)


@pytest.mark.parametrize("plan", [(8, 3), (1, 1), (0, 5), (40, 0)])
def test_hist_takes_a_plan_on_the_cpu(plan):
    """On CPU tensors the plain path ignores the plan: the same histograms
    under every plan, equal to hist_plain."""
    rng = np.random.default_rng(4)
    d, n, m, nb = 6, 500, 4, 30
    bins = torch.as_tensor(rng.integers(0, nb, (d, n)), dtype=torch.uint8)
    node = torch.as_tensor(rng.integers(0, m, n), dtype=torch.int32)
    g = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    h = torch.as_tensor(rng.random(n), dtype=torch.float32)
    got = th.hist(bins, node, g, h, m, nb, plan=plan)
    want = th.hist_plain(bins, node, g, h, m, nb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_snap_hist_plan_shares_a_measurement():
    R, F = CENSUS[:2]
    assert kt.snap_hist_plan(R, F, 256, 0, 0) == (0, 0)
    # a cap of F features or more is no cap
    assert kt.snap_hist_plan(R, F, 256, 500, 0) == \
        kt.snap_hist_plan(R, F, 256, F, 0) == (0, 0)
    # more row ranges than the rows allow clamp to the most
    most = R // max(th.MIN_ROWS, 4 * 256)
    assert kt.snap_hist_plan(R, F, 256, 0, 120000) == \
        kt.snap_hist_plan(R, F, 256, 0, most)
    assert kt.snap_hist_plan(R, F, 256, 2, 3) == (2, 3)
    assert kt.census_bins(164, 98, 6, 8, 12) == 256
    assert kt.census_bins(26, 0, 6, 8, 12) == 128
    assert kt.census_bins(6, 6, 0, 0, 0) == 2


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------


def _fake_fh(N, D, H, L, T, G):
    return kt.predicted_fusedhead_seconds(N, D, H, L, T, G)


def _fake_hist(*a):
    return kt.predicted_hist_seconds(*a)


@pytest.mark.parametrize("family", ["fusedhead", "gbdthist"])
def test_runner_times_each_config_once(family):
    if family == "fusedhead":
        task = _fh_task()
        runner = kt.FusedHeadRunner(time_fn=_fake_fh, device="cpu")

        def key(st):
            return (fh.snap_fused_groups(MAIN[0], MAIN[4],
                                         *kt.state_to_fusedhead_config(
                                             st)[0]),)
    else:
        task = _gh_task()
        runner = kt.HistRunner(time_fn=_fake_hist, device="cpu")

        def key(st):
            return kt.snap_hist_plan(*CENSUS[:2], 256,
                                     *kt.state_to_hist_plan(st)[0])
    states = [task.compute_dag.infer_bound(st) for st in make_states(
        task, 30, evo_population=48, min_population=12, seed=9)]
    m = ProgramMeasurer(EmptyBuilder(), runner, max_continuous_error=10**9)
    res = m.measure(task, states)
    assert all(r.error_no == ERROR_NO_ERROR for r in res)
    cfgs = {key(st) for st in states}
    assert runner.n_timed == len(cfgs) < len(states)
    again = runner.run(task, states)
    assert runner.n_timed == len(cfgs)
    assert [r.costs[0] for r in again] == [r.costs[0] for r in res]
    assert {c for c, _, _ in runner.measured_configs()} == cfgs


def test_fusedhead_runner_refuses_slow_configs_before_the_card():
    """The predicted time (the card's peaks) refuses a config before any
    kernel is built or launched, on a runner told cuda without a card."""
    task = _fh_task((262144, 24, 256, 64, 10))
    st = kt.default_config_state(task)
    est = kt.predicted_fusedhead_seconds(262144, 24, 256, 64, 10, 1,
                                         "bfloat16")
    assert 0 < est < 2.0
    r = kt.FusedHeadRunner(max_seconds=est / 2, device="cuda")
    assert r.run(task, [st])[0].error_no == ERROR_BUILD_TIMEOUT
    assert r.launches_per_config == {} and r.n_verified == 0
    # f32 runs at a fourteenth of the bf16 peak
    assert kt.predicted_fusedhead_seconds(262144, 24, 256, 64, 10, 1,
                                          "float32") > 10 * est


def test_runners_need_a_card_without_a_stand_in_timer():
    for runner, task in ((kt.FusedHeadRunner(device="cpu"), _fh_task()),
                         (kt.HistRunner(device="cpu"), _gh_task())):
        with pytest.raises(ValueError, match="CUDA device"):
            runner.run(task, [task.compute_dag.init_state])
    with pytest.raises(ValueError, match="fused_head_layer"):
        kt.FusedHeadRunner.task_dims(_gh_task())
    with pytest.raises(ValueError, match="gbdt_hist_layer"):
        kt.HistRunner.task_dims(_fh_task())


@pytest.mark.parametrize("name,args,family", [
    ("matmul_auto_scheduler_test", (64, 64, 64), "matmul"),
    ("conv2d_layer", (1, 8, 8, 16, 16, 3, 3, [1, 1], [1, 1]), "conv"),
    ("fused_head_layer", MAIN, "fusedhead"),
    ("gbdt_hist_layer", CENSUS, "hist")])
def test_kernel_runner_dispatches_by_workload(name, args, family):
    calls = []

    def timer(tag):
        def fn(*a):
            calls.append(tag)
            return 1e-3
        return fn

    r = kt.KernelRunner(matmul_time_fn=timer("matmul"),
                        conv_time_fn=timer("conv"),
                        fusedhead_time_fn=timer("fusedhead"),
                        hist_time_fn=timer("hist"), device="cpu",
                        repeats=1)
    task = SearchTask(make_workload_key(name, args), "llvm")
    assert r.family(task) is getattr(r, family)
    res = r.run(task, [task.compute_dag.init_state.copy()])
    assert res[0].error_no == ERROR_NO_ERROR and calls == [family]
    assert r.n_timed == 1 == getattr(r, family).n_timed
    assert r.hist.repeats == 1


def test_kernel_runner_refuses_other_workloads_and_sums_n_timed():
    r = kt.KernelRunner(device="cpu", matmul_time_fn=lambda *a: 1e-3,
                        fusedhead_time_fn=lambda *a: 1e-3)
    with pytest.raises(ValueError, match="no kernel family"):
        r.family(SimpleNamespace(workload_key=json.dumps(
            ["softmax_layer", 1, 64])))
    for task in (_fh_task(), SearchTask(make_workload_key(
            "matmul_auto_scheduler_test", (64, 64, 64)), "llvm")):
        r.run(task, [task.compute_dag.init_state.copy()])
    assert r.n_timed == 2
    spec = runner_from_spec("cuda_kernels:float32")
    assert isinstance(spec, kt.KernelRunner) and spec.fusedhead.dtype == \
        "float32" and spec.hist.device.type == "cuda"


def test_hist_runner_corpus_is_the_jax_runners():
    """The census corpus is the JAX runner's numpy draws, in the port's
    DMatrix: the same rows, labels and pack ids, and the census it was
    made for."""
    shape = (600, 12, 3, 2, 2, 2)
    dm = kt.HistRunner(device="cpu").dmatrix(*shape)
    want = jpt.BoostHistRunner()._get_dmatrix(*shape)
    assert np.array_equal(dm.data, want.data)
    assert np.array_equal(dm.get_label(), want.get_label())
    assert np.array_equal(dm.pack_ids, want.pack_ids)
    census = boost_device.hist_census(dm._thresholds)
    assert census == (12, 3, 2, 2, 2)


def test_hist_runner_times_training_rounds_on_the_cpu(monkeypatch):
    """With the card's timing path run on the CPU (the runner told cpu
    and its device check lifted), a config is boost_device.train under the
    plan: the plan reaches every level's hist call, 10 rounds of depth 6,
    the first run discarded."""
    seen = []
    real = boost_device.hist

    def rec(*a, plan=None):
        seen.append(plan)
        return real(*a, plan=plan)

    monkeypatch.setattr(boost_device, "hist", rec)
    r = kt.HistRunner(device="cpu", repeats=1, rounds=2, depth=3)
    monkeypatch.setattr(r, "_check_device", lambda: None)
    shape = (400, 6, 2, 1, 1, 1)
    sec = r._time_config(shape, 2, 3)
    assert sec > 0 and seen == [(2, 3)] * (2 * 2 * 3)


# ---------------------------------------------------------------------------
# the suite's command line
# ---------------------------------------------------------------------------


def _shape_only(*a):
    """A stand-in timer of the workload's shape alone (the two packages
    snap configs onto different lattices, so a config-dependent time
    would differ)."""
    return 1e-6 * (1 + sum(int(v) % 97 for v in a[:3]))


def _log_rows(path, serde):
    return [(r.inp.task.workload_key, r.inp.step_records, r.res.costs,
             r.res.error_no) for r in serde.load_records(path)]


def test_suite_cli_equals_jax_script(python_paths, tmp_path, monkeypatch,
                                     capsys):
    """matmul + conv2d suite, --fake-timer, plain sketch, 24 trials of 8:
    with both runners on the same time function, the port's log holds the
    JAX script's step lists and costs in the same order."""
    mp = python_paths
    sys.path.insert(0, ROOT)
    from scripts import tune_kernel_suite as jsuite

    for name in ("predicted_seconds", "predicted_conv_seconds"):
        mp.setattr(jsuite, name, _shape_only)
    mp.setattr(tks, "fake_timers", lambda dtype: dict(
        matmul_time_fn=_shape_only, conv_time_fn=_shape_only))
    suite = ["matmul:256x256x256:2", "conv2d:1x8x8x32x32x3x3"]
    argv = ["--fake-timer", "--policy", "sketch", "--suite", *suite,
            "--n-trials", "24", "--measures-per-round", "8"]
    tks.main(argv + ["--device", "cpu", "--log-file",
                     str(tmp_path / "port.json")])
    mp.setattr(sys, "argv", ["x", *argv, "--log-file",
                             str(tmp_path / "jax.json")])
    jsuite.main()
    capsys.readouterr()
    got = _log_rows(tmp_path / "port.json", tserde)
    want = _log_rows(tmp_path / "jax.json", jserde)
    assert len(got) == len(want) >= 24
    assert got == want
    targets = {r.inp.task.target
               for r in tserde.load_records(str(tmp_path / "port.json"))}
    assert targets == {"cuda -model=bfloat16"}


def test_suite_cli_all_families_end_to_end(python_paths, tmp_path, capsys):
    """All four families through the composite runner: each hand default
    measured into the log first, a library built from the log with a
    config for every entry, tuned against the default for the fused head
    and the histogram."""
    log = str(tmp_path / "suite.json")
    summary, runner = tks.main([
        "--fake-timer", "--device", "cpu", "--policy", "sketch",
        "--dtype", "float32", "--suite", "matmul:128x128x128",
        "conv2d:1x8x8x32x32x3x3", "fusedhead:773x17x256x64x10:4",
        "gbdthist:120000x164x98x6x8x12", "--n-trials", "32",
        "--measures-per-round", "8", "--log-file", log])
    out = capsys.readouterr().out
    assert out.count("seeded hand-default config") == 2
    assert "default[G=5]" in out and "default[features=0 chunks=0]" in out
    recs = tserde.load_records(log)
    assert recs[0].inp.task.workload_key == _fh_task().workload_key
    assert len(recs) >= 34
    assert summary["library"] == 4 and runner.n_timed >= 4
    for row in summary["entries"]:
        assert row["tuned_s"] is not None
        if row["family"] in ("fusedhead", "gbdthist"):
            assert row["tuned_s"] <= row["default_s"]
    lib = kl.KernelLibrary.from_file(log)
    assert lib.matmul_config(128, 128, 128, "float32") is not None
    assert lib.conv2d_config(1, 8, 8, 32, 32, 3, 3, 1, 1,
                             "float32") is not None
    G = lib.fused_head_config(*MAIN, dtype="float32")
    assert 1 <= G <= 11
    # the histogram's records carry -model=float32, and its lookup asks
    # bfloat16 as the JAX library does: they never match
    assert lib.hist_plan(*CENSUS) is None


def test_suite_cli_needs_cuda_or_a_stand_in_timer(tmp_path):
    with pytest.raises(SystemExit, match="--fake-timer"):
        tks.main(["--device", "cpu", "--suite", "matmul:64x64x64",
                  "--log-file", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
    with pytest.raises(SystemExit, match="unknown suite family"):
        tks.parse_suite_entry("pool:1x2")
    with pytest.raises(SystemExit, match="census"):
        tks.parse_suite_entry("gbdthist:100x4x2x2x2x2")
    assert tks.parse_suite_entry("fusedhead:773x17x256x64x10:4") == (
        "fusedhead", MAIN, 4.0)


# ---------------------------------------------------------------------------
# tuned configs on the main paths
# ---------------------------------------------------------------------------


def _record_log(path, task, state, cost=1e-4):
    tserde.save_records(str(path), [tserde.make_record(
        task, state.transform_steps, [cost])], mode="w")
    return str(path)


def _fh_state(task, tc):
    st = task.compute_dag.init_state.copy()
    sid = _mc_stage(st)
    t_it, i_it, k_it = st.stages[sid].iters
    t0, t1 = state_split(st, sid, t_it, [tc])
    k0, k1 = state_split(st, sid, k_it, [8])
    state_reorder(st, sid, [t0, i_it, k0, t1, k1])
    return st


@pytest.mark.parametrize("env,want", [("log", 4), ("off", None),
                                      ("none", None)])
def test_select_programs_launches_the_librarys_G(tmp_path, monkeypatch,
                                                 env, want):
    """select_programs asks the process library for the fused head's G at
    its shape and dtype and passes it on (seen through the kernel's tap;
    the CPU path computes the same stats under any G). A record at
    another dtype does not apply."""
    N, D, H, L, T = 96, 12, 32, 8, 6
    cfg = ts.SelectionConfig(num_select=8, T_mc=T, topk_factor=2,
                             compute_dtype="float32")
    task = _fh_task((N, D, H, L, T), "cuda -model=float32")
    log = _record_log(tmp_path / "fh.json", task, _fh_state(task, 2))
    monkeypatch.setenv(kl.LIBRARY_ENV, log if env == "log" else env)
    rng = np.random.default_rng(0)
    params = to_torch(np_predictor_params(rng, D, H, L, H))
    X = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32)
    seen = []
    monkeypatch.setattr(fh.fused_head_stats, "tap",
                        lambda x, T_, groups: seen.append(groups))
    used = torch.zeros(N, dtype=torch.bool)
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, (T, N, H),
                                         dtype=np.uint32))
    idx, valid, _, _ = ts.select_programs(
        params, X, used, ~used, torch.Generator().manual_seed(0), cfg,
        mask_bits=bits)
    assert seen == [want]
    assert kl.tuned_fused_head_config(N, D, H, L, T, "bfloat16") is None
    # the same picks as with no library
    monkeypatch.setenv(kl.LIBRARY_ENV, "off")
    idx2, _, _, _ = ts.select_programs(
        params, X, used, ~used, torch.Generator().manual_seed(0), cfg,
        mask_bits=bits)
    assert torch.equal(idx, idx2)


def test_boost_device_train_takes_the_librarys_plan(tmp_path, monkeypatch):
    """Without a plan, boost_device.train asks the library at its (rows,
    census) shape and every level's hist call gets that plan; a plan given
    by the caller wins; with the library off hist gets None; the trees are
    the same under every plan."""
    rng = np.random.default_rng(1)
    n = 600
    rows = np.stack([rng.integers(0, 2, n), rng.integers(0, 10, n),
                     rng.random(n), rng.random(n)], 1).astype(np.float32)
    dm = boost.DMatrix(rows, label=rows[:, 2] + 0.1 * rows[:, 1])
    dm._ensure_binned()
    census = boost_device.hist_census(dm._thresholds)
    assert census[:3] == (4, 1, 1)
    task = _gh_task((n, *census), "cuda -model=bfloat16")
    st = task.compute_dag.init_state.copy()
    sid = _hist_stage(st)
    f_it, _, _, r_it = st.stages[sid].iters
    state_split(st, sid, r_it, [200])
    state_split(st, sid, f_it, [2])
    log = _record_log(tmp_path / "gh.json", task, st)
    seen = []
    real = boost_device.hist

    def rec(*a, plan=None):
        seen.append(plan)
        return real(*a, plan=plan)

    monkeypatch.setattr(boost_device, "hist", rec)
    params = {"max_depth": 3, "eta": 0.3}
    trees = []
    for env, plan, want in ((log, None, (2, 3)), (log, (5, 1), (5, 1)),
                            ("off", None, None)):
        monkeypatch.setenv(kl.LIBRARY_ENV, env)
        seen.clear()
        bst = boost_device.train(params, dm, num_boost_round=2,
                                 verbose_eval=0, device="cpu",
                                 hist_plan=plan)
        assert seen == [want] * 6
        trees.append(bst.predict(dm))
    assert all(np.array_equal(trees[0], t) for t in trees[1:])
