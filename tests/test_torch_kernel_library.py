"""The port's kernel library (``ops/kernel_library.py``) on the CPU: logs of
the card's records load, exact, compatible and nearest queries follow the
JAX library (``vae_extent_search_tpu/ops/kernel_library.py``) on the same
records, dtypes partition, the best record wins, the environment reloads
the default library, the dispatching ops fall back to PyTorch in the open,
and no record of another target kind (the JAX package's TPU logs under
``result/selftune/``) ever applies."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from vae_extent_search_tpu.ops import kernel_library as jkl
from vae_extent_search_tpu_torch.ops import conv2d as oc
from vae_extent_search_tpu_torch.ops import kernel_library as kl
from vae_extent_search_tpu_torch.records import SearchTask, make_workload_key
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records.serde import ERROR_NO_ERROR
from vae_extent_search_tpu_torch.search import kernel_tuner as kt
from vae_extent_search_tpu_torch.search.measure import (
    EmptyBuilder,
    ProgramMeasurer,
    RecordToFile,
)
from vae_extent_search_tpu_torch.search.sketch import make_states

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELFTUNE = sorted(glob.glob(os.path.join(ROOT, "result", "selftune",
                                         "*.json")))
CONV = (1, 8, 8, 32, 32, 3, 3, 1, 1)


def _fake_matmul_timer(M, N, K, bm, bn, bk):
    # deterministic and config-dependent: big blocks win, bm breaks ties
    return 1.0 / (bm * bn * bk) + 1e-6 * bm


def _fake_conv_timer(*a):
    boh, bco, bci = a[-3:]
    return 1.0 / (boh * bco * bci + 1.0)


def _tune_log(path, task_key, runner, n_states=24, seed=7,
              dtype="bfloat16"):
    donor = SearchTask(task_key, "llvm")
    record_task = SearchTask(task_key, f"cuda -model={dtype}")
    states = [donor.compute_dag.infer_bound(s) for s in make_states(
        donor, n_states, evo_population=64, min_population=20, seed=seed)]
    ProgramMeasurer(EmptyBuilder(), runner, callbacks=[RecordToFile(path)],
                    max_continuous_error=10 ** 9).measure(record_task,
                                                          states)
    return path


@pytest.fixture(scope="module")
def matmul_log(tmp_path_factory):
    runner = kt.MatmulRunner(time_fn=_fake_matmul_timer, device="cpu")
    path = str(tmp_path_factory.mktemp("kl") / "tune_matmul.json")
    wk = make_workload_key("matmul_auto_scheduler_test", (64, 64, 64))
    return _tune_log(path, wk, runner), runner


def _retarget(path, out, target):
    """The records of ``path`` with their target replaced."""
    recs = tserde.load_records(path)
    for r in recs:
        r.inp.task = SearchTask(r.inp.task.workload_key, target)
    tserde.save_records(out, recs, mode="w")
    return out


def test_library_loads_and_exact_query(matmul_log):
    log, runner = matmul_log
    lib = kl.KernelLibrary.from_file(log)
    assert len(lib) == 1   # one (workload, dtype) key, the best kept
    cfg = lib.matmul_config(64, 64, 64, "bfloat16")
    ok = [(c, s) for c, s, e in runner.measured_configs()
          if e == ERROR_NO_ERROR]
    assert cfg == min(ok, key=lambda cs: cs[1])[0]


def test_dtype_partitions_records(matmul_log):
    lib = kl.KernelLibrary.from_file(matmul_log[0])
    assert lib.matmul_config(64, 64, 64, "float32") is None
    assert lib.query(make_workload_key("matmul_auto_scheduler_test",
                                       (64, 64, 64)), "float32") is None


def test_compatible_match_rescales_to_query_shape(matmul_log):
    log, _ = matmul_log
    lib = kl.KernelLibrary.from_file(log)
    cfg = lib.matmul_config(128, 64, 64, "bfloat16")
    assert cfg is not None
    assert kt.om.config_is_valid(128, 64, 64, *cfg)[0]
    # non-dividing args never match (reference utils.py:82-130)
    assert lib.matmul_config(96, 64, 64, "bfloat16") is None
    strict = kl.KernelLibrary.from_file(log, include_compatible=False)
    assert strict.matmul_config(128, 64, 64, "bfloat16") is None


@pytest.mark.parametrize("shape", [(64, 64, 64), (128, 64, 64),
                                   (96, 64, 64), (64, 128, 256)])
def test_query_picks_the_jax_librarys_record(matmul_log, shape):
    """Exact and compatible queries pick the record the JAX library picks
    on the same log (the JAX library read with the records under the
    TPU target, which is all it takes)."""
    log, _ = matmul_log
    jlog = _retarget(log, log + f".tpu{shape[0]}{shape[2]}.json",
                     "tpu -model=bfloat16")
    wk = make_workload_key("matmul_auto_scheduler_test", shape)
    mine = kl.KernelLibrary.from_file(log).query(wk, "bfloat16")
    want = jkl.PallasKernelLibrary.from_file(jlog).query(wk, "bfloat16")
    assert (mine is None) == (want is None)
    if mine is not None:
        assert mine.inp.step_records == want.inp.step_records
        assert mine.res.costs == want.res.costs


def test_best_record_wins_on_update(matmul_log, tmp_path):
    log, runner = matmul_log
    lib = kl.KernelLibrary.from_file(log)
    (_, best), = lib._best.values()
    ok = [s for _, s, e in runner.measured_configs() if e == ERROR_NO_ERROR]
    assert best.res.mean_cost == pytest.approx(min(ok))
    # a faster record of the same key replaces it; a failed one never does
    faster = tserde.make_record(best.inp.task, best.inp.step_records,
                                [best.res.mean_cost / 2])
    failed = tserde.make_record(best.inp.task, [], [1e-30], error_no=1)
    lib.update([failed, faster])
    assert lib._best[next(iter(lib._best))][0] == best.res.mean_cost / 2


def test_dispatching_matmul_numerics(matmul_log):
    """A matched record gives the kernel's wrapper at its config (on the
    CPU its plain version): float32 equal to torch.matmul of the inputs
    rounded to bf16."""
    lib = kl.KernelLibrary.from_file(matmul_log[0])
    fn, prov = lib.matmul(64, 64, 64, "bfloat16")
    assert prov[0] == "cuda" and prov[1:] == lib.matmul_config(64, 64, 64)
    rng = np.random.default_rng(3)
    a, b = (torch.as_tensor(rng.standard_normal((64, 64), np.float32))
            for _ in range(2))
    got = fn(a, b)
    want = torch.matmul(a.bfloat16().float(), b.bfloat16().float())
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_library_falls_back_to_torch(dtype):
    """No record: ("torch",), the PyTorch call itself, whose numbers equal
    torch.matmul / F.conv2d + bias + ReLU of the inputs rounded to the
    dtype."""
    lib = kl.KernelLibrary()
    fn, prov = lib.matmul(32, 48, 16, dtype)
    assert prov == ("torch",)
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    a = torch.as_tensor(rng.standard_normal((32, 16), np.float32))
    b = torch.as_tensor(rng.standard_normal((16, 48), np.float32))
    assert torch.equal(fn(a, b), torch.matmul(a.to(dt).float(),
                                              b.to(dt).float()))
    conv, prov = lib.conv2d(*CONV, dtype=dtype)
    assert prov == ("torch",)
    x = torch.as_tensor(rng.standard_normal((1, 8, 8, 32), np.float32))
    w = torch.as_tensor(rng.standard_normal((3, 3, 32, 32), np.float32))
    bias = torch.as_tensor(rng.standard_normal(32, np.float32))
    got = conv(x, w, bias)
    want = oc.conv2d_plain(x.to(dt), w.to(dt), bias.to(dt).float(), 1)
    assert got.shape == (1, 8, 8, 32)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_conv2d_library_roundtrip(tmp_path):
    runner = kt.Conv2dRunner(dtype="bfloat16", time_fn=_fake_conv_timer,
                             device="cpu")
    N, H, W, CO, CI, KH, KW, stride, pad = CONV
    wk = make_workload_key("conv2d_layer", (N, H, W, CO, CI, KH, KW,
                                            [stride] * 2, [pad] * 2))
    log = _tune_log(str(tmp_path / "conv.json"), wk, runner, 16, 11)
    lib = kl.KernelLibrary.from_file(log)
    cfg = lib.conv2d_config(*CONV, dtype="bfloat16")
    ok = [(c, s) for c, s, e in runner.measured_configs()
          if e == ERROR_NO_ERROR]
    assert cfg == min(ok, key=lambda cs: cs[1])[0]
    fn, prov = lib.conv2d(*CONV, dtype="bfloat16")
    assert prov == ("cuda",) + cfg
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((N, H, W, CI), np.float32))
    w = torch.as_tensor(rng.standard_normal((KH, KW, CI, CO), np.float32))
    bias = torch.as_tensor(rng.standard_normal(CO, np.float32))
    want = lib.__class__().conv2d(*CONV, dtype="bfloat16")[0](x, w, bias)
    got = fn(x, w, bias)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def _self_kernel_log(tmp_path, dims_fh, dims_gh, fh_tc=2, gh_split=(2, 300)):
    """A log of one fused_head_layer and one gbdt_hist_layer record on the
    card's target."""
    from vae_extent_search_tpu_torch.ir.schedule_api import (
        state_reorder,
        state_split,
    )

    fh_task = SearchTask(make_workload_key("fused_head_layer", dims_fh),
                         "cuda -model=bfloat16")
    st = fh_task.compute_dag.init_state.copy()
    sid = next(i for i, s in enumerate(st.stages) if s.op.name == "MC")
    t_it, i_it, k_it = st.stages[sid].iters
    t0, t1 = state_split(st, sid, t_it, [fh_tc])
    k0, k1 = state_split(st, sid, k_it, [8])
    state_reorder(st, sid, [t0, i_it, k0, t1, k1])
    gh_task = SearchTask(make_workload_key("gbdt_hist_layer", dims_gh),
                         "cuda -model=bfloat16")
    gs = gh_task.compute_dag.init_state.copy()
    gid = next(i for i, s in enumerate(gs.stages) if s.op.name == "hist")
    f_it, _, _, r_it = gs.stages[gid].iters
    state_split(gs, gid, r_it, [gh_split[1]])
    state_split(gs, gid, f_it, [gh_split[0]])
    path = str(tmp_path / "self.json")
    tserde.save_records(path, [
        tserde.make_record(fh_task, st.transform_steps, [1e-4]),
        tserde.make_record(gh_task, gs.transform_steps, [1e-2])], mode="w")
    return path


def test_nearest_shape_matching_for_the_self_kernel_families(tmp_path):
    """The fused head's and the histogram's records match by nearest
    log-shape distance, not divisibility; far shapes return None."""
    log = _self_kernel_log(tmp_path, (262144, 24, 256, 64, 10),
                           (120000, 164, 98, 6, 8, 12))
    lib = kl.KernelLibrary.from_file(log)
    # features: the inner f tile (2); chunks: 120000 / 300
    assert lib.hist_plan(120000, 164, 98, 6, 8, 12) == (2, 400)
    assert lib.hist_plan(800000, 173, 100, 8, 10, 14) == (2, 400)
    assert lib.hist_plan(5000, 20, 4, 1, 1, 2) is None
    assert lib.fused_head_config(262144, 24, 256, 64, 10) == 6
    assert lib.fused_head_config(131072, 24, 256, 64, 10) == 6
    # the record's MC chunk re-snaps onto the query's T
    assert lib.fused_head_config(131072, 24, 256, 64, 3) == 3
    assert lib.fused_head_config(64, 17, 256, 64, 10) is None
    assert lib.fused_head_config(262144, 24, 256, 64, 10,
                                 "float32") is None


def test_hist_plan_asks_bfloat16_whatever_the_suite_ran(tmp_path):
    """As the JAX library does, hist_plan queries under bfloat16: the
    same record written under float32 never matches."""
    log = _self_kernel_log(tmp_path, (1024, 24, 256, 64, 10),
                           (120000, 164, 98, 6, 8, 12))
    f32 = _retarget(log, str(tmp_path / "f32.json"), "cuda -model=float32")
    assert kl.KernelLibrary.from_file(log).hist_plan(*(120000, 164, 98, 6,
                                                       8, 12)) == (2, 400)
    lib = kl.KernelLibrary.from_file(f32)
    assert len(lib) == 2 and lib.hist_plan(120000, 164, 98, 6, 8, 12) is None
    assert lib.fused_head_config(1024, 24, 256, 64, 10, "float32") == 6


@pytest.mark.parametrize("path", SELFTUNE,
                         ids=[os.path.basename(p) for p in SELFTUNE])
def test_committed_tpu_logs_yield_no_config(path, tmp_path):
    """Each JAX-package log under result/selftune/ holds TPU schedules
    only: the port's library reads none of its records, so no lookup
    returns a config; the same records under the card's target would."""
    n = sum(r.res.error_no == 0 for r in tserde.load_records(path))
    lib = kl.KernelLibrary.from_file(path)
    assert len(lib) == 0 and lib.n_skipped == n > 0
    keys = {r.inp.task.workload_key for r in tserde.load_records(path)}
    assert all(lib.query(k, "bfloat16") is None and
               lib.query_nearest(k, "bfloat16") is None for k in keys)
    assert lib.fused_head_config(262144, 24, 256, 64, 10) is None
    assert lib.hist_plan(120000, 164, 98, 6, 8, 12) is None
    assert lib.matmul_config(1536, 1536, 1536) is None
    assert lib.conv2d_config(1, 56, 56, 128, 128, 3, 3, 1, 1) is None
    cuda = kl.KernelLibrary.from_file(_retarget(
        path, str(tmp_path / "cuda.json"), "cuda -model=bfloat16"))
    assert len(cuda) > 0 and cuda.n_skipped == 0


def test_default_library_never_loads_the_tpu_logs(monkeypatch):
    """Unset, the default library holds the port's committed logs of the
    card, of which there are none yet: it is empty, and result/selftune/
    is not among its paths. Named in the variable, the TPU logs still
    give no record."""
    monkeypatch.delenv(kl.LIBRARY_ENV, raising=False)
    assert kl.committed_log_paths() == []
    assert len(kl.default_library()) == 0
    assert kl.tuned_fused_head_config(262144, 24, 256, 64, 10) is None
    assert kl.tuned_hist_plan(120000, 164, 98, 6, 8, 12) is None
    assert len(SELFTUNE) == 4
    monkeypatch.setenv(kl.LIBRARY_ENV, os.pathsep.join(SELFTUNE))
    lib = kl.default_library()
    assert len(lib) == 0 and lib.n_skipped == sum(
        r.res.error_no == 0 for p in SELFTUNE
        for r in tserde.load_records(p)) == 190
    assert kl.tuned_matmul(1536, 1536, 1536)[1] == ("torch",)
    assert kl.tuned_conv2d(1, 56, 56, 128, 128, 3, 3, 1, 1)[1] == ("torch",)


@pytest.mark.parametrize("off", ["none", "off", "0", "OFF", " None "])
def test_default_library_env_reload_and_off_values(matmul_log, monkeypatch,
                                                   off):
    log, _ = matmul_log
    monkeypatch.setenv(kl.LIBRARY_ENV, log)
    assert len(kl.default_library()) == 1
    assert kl.tuned_matmul(64, 64, 64)[1][0] == "cuda"
    monkeypatch.setenv(kl.LIBRARY_ENV, off)
    assert len(kl.default_library()) == 0
    assert kl.tuned_matmul(64, 64, 64)[1] == ("torch",)
    # missing paths are passed over
    monkeypatch.setenv(kl.LIBRARY_ENV,
                       log + os.pathsep + "/nonexistent/tuned.json")
    assert len(kl.default_library()) == 1
    assert kl.LIBRARY_OFF_VALUES == jkl.LIBRARY_OFF_VALUES
    assert kl.LIBRARY_ENV == jkl.LIBRARY_ENV


@pytest.mark.parametrize("target,applies", [
    ("cuda -model=bfloat16", True), ("cuda", True),
    ("cuda -keys=cuda,gpu -model=float32", True),
    ("tpu -model=bfloat16", False), ("llvm -mcpu=skylake-avx512", False),
    ("llvm -keys=cuda", False)])
def test_only_the_cards_records_apply(matmul_log, tmp_path, target, applies):
    """A record applies where its target's kind is cuda, whatever its
    other attributes; the JAX package's TPU target and the CPU donor's do
    not."""
    log = _retarget(matmul_log[0], str(tmp_path / "t.json"), target)
    lib = kl.KernelLibrary.from_file(log)
    assert (len(lib) == 1) == applies and lib.n_skipped == (
        0 if applies else len(tserde.load_records(log)))
    rec = json.loads(open(SELFTUNE[0]).readline())
    assert rec["i"][0][1].split()[0] == "tpu"
