"""The self-tuning path on the CPU: the schedule -> block-config
quotients, the kernel runners with a stand-in timer, the online active
loop against the JAX package's, and ``cli.tune_kernel`` end to end with
``--fake-timer --device cpu``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_predictor_params, np_vae_params, to_jax, to_torch
from vae_extent_search_tpu.models import predictor as jp
from vae_extent_search_tpu.search import active_loop as ja
from vae_extent_search_tpu.search import select as js
from vae_extent_search_tpu_torch.ir.schedule_api import (
    state_reorder,
    state_split,
)
from vae_extent_search_tpu_torch.models import predictor as tp
from vae_extent_search_tpu_torch.ops import conv2d as oc
from vae_extent_search_tpu_torch.ops import matmul as om
from vae_extent_search_tpu_torch.records import SearchTask, make_workload_key
from vae_extent_search_tpu_torch.records.serde import (
    ERROR_BUILD_TIMEOUT,
    ERROR_INSTANTIATION,
    ERROR_NO_ERROR,
)
from vae_extent_search_tpu_torch.search import active_loop as ta
from vae_extent_search_tpu_torch.search import select as ts
from vae_extent_search_tpu_torch.search.kernel_tuner import (
    Conv2dRunner,
    MatmulRunner,
    state_loops,
    state_to_conv_config,
    state_to_matmul_config,
)
from vae_extent_search_tpu_torch.search.measure import (
    EmptyBuilder,
    ProgramMeasurer,
)
from vae_extent_search_tpu_torch.search.sketch import make_states

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV = (1, 56, 56, 256, 256, 3, 3, 1, 1)


def _task(M=64, N=64, K=64):
    return SearchTask(
        make_workload_key("matmul_auto_scheduler_test", (M, N, K)), "llvm")


def _conv_task(N=1, H=56, W=56, CO=256, CI=256, KH=3, KW=3, stride=1, pad=1):
    wk = make_workload_key("conv2d_layer", (N, H, W, CO, CI, KH, KW,
                                            [stride, stride], [pad, pad]))
    return SearchTask(wk, "llvm")


def _bound(task, n, seed):
    dag = task.compute_dag
    return [dag.infer_bound(s) for s in make_states(task, n, seed=seed)]


def _fake_mm(M, N, K, bm, bn, bk):
    return om.predicted_seconds(M, N, K, bm, bn, bk)


def _fake_conv(*a):
    return oc.predicted_conv_seconds(*a)


# ---------------------------------------------------------------------------
# state -> config quotients
# ---------------------------------------------------------------------------

def test_state_to_config_canonical_tiling():
    task = _task(256, 256, 256)
    st = task.compute_dag.init_state.copy()
    cid = next(i for i, s in enumerate(st.stages) if s.op.name == "C")
    i_it, j_it, k_it = st.stages[cid].iters
    i0, i1, i2 = state_split(st, cid, i_it, [4, 8])
    j0, j1, j2 = state_split(st, cid, j_it, [2, 16])
    k0, k1 = state_split(st, cid, k_it, [32])
    state_reorder(st, cid, [i0, j0, k0, i1, j1, k1, i2, j2])
    exts = {it.name: it.range[1] for it in st.stages[cid].iters}
    cfg, why = state_to_matmul_config(st)
    assert why is None
    assert cfg == (exts["i.1"] * exts["i.2"], exts["j.1"] * exts["j.2"],
                   exts["k.1"])
    # depth grows by at most one from one printed loop to the next
    loops = state_loops(st)
    assert all(d1 <= d0 + 1 for (_, _, d0), (_, _, d1) in zip(loops,
                                                              loops[1:]))


def test_state_to_config_unsplit_reduction():
    st = _task().compute_dag.init_state.copy()
    assert state_to_matmul_config(st) == ((1, 1, 64), None)
    st = _conv_task().compute_dag.init_state.copy()
    raw, why = state_to_conv_config(st)
    # the whole channel reduction sits inside the block
    assert why is None and raw[2] == 256


def test_bound_pools_quotient_onto_the_lattice():
    task = _task(1536, 1536, 1536)
    for st in _bound(task, 60, 11):
        raw, why = state_to_matmul_config(st)
        assert raw is not None, why
        assert all(1536 % v == 0 for v in raw)
        cfg = om.snap_config_to_hw(1536, 1536, 1536, *raw)
        assert om.config_is_valid(1536, 1536, 1536, *cfg)[0]
    for st in _bound(_conv_task(), 60, 11):
        raw, why = state_to_conv_config(st)
        assert raw is not None, why
        assert 56 % raw[0] == 0 and 256 % raw[1] == 0 and 256 % raw[2] == 0
        cfg = oc.snap_conv_config_to_hw(*CONV, *raw)
        assert oc.conv_config_is_valid(*CONV, *cfg)[0]


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["matmul", "conv2d"])
def test_runner_times_each_config_once(family):
    if family == "matmul":
        task, runner = _task(1536, 1536, 1536), MatmulRunner(
            time_fn=_fake_mm, device="cpu")
        to_raw = state_to_matmul_config

        def snap(raw):
            return om.snap_config_to_hw(1536, 1536, 1536, *raw)
    else:
        task, runner = _conv_task(), Conv2dRunner(time_fn=_fake_conv,
                                                  device="cpu")
        to_raw = state_to_conv_config

        def snap(raw):
            return oc.snap_conv_config_to_hw(*CONV, *raw)
    states = _bound(task, 40, 7)
    m = ProgramMeasurer(EmptyBuilder(), runner, max_continuous_error=10**9)
    res = m.measure(task, states)
    assert len(res) == len(states)
    assert all(r.error_no == ERROR_NO_ERROR for r in res)
    cfgs = {snap(to_raw(s)[0]) for s in states}
    assert runner.n_timed == len(cfgs) < len(states)
    again = runner.run(task, states)
    assert runner.n_timed == len(cfgs)  # fully cached
    assert [r.costs[0] for r in again] == [r.costs[0] for r in res]
    assert {c for c, _, _ in runner.measured_configs()} == cfgs
    best = min(res, key=lambda r: r.costs[0])
    assert m.best_cost[task.workload_key] == best.costs[0]


@pytest.mark.parametrize("dims", [(7, 33, 5), (64, 64, 20)])
def test_ragged_bf16_task_is_not_refused_by_shape(dims):
    """A bf16 matmul task whose K or N is off a multiple of 8 (TMA's
    16-byte rows): every state maps onto a valid config and is timed, none
    is refused (the wrapper stages the operands)."""
    task = _task(*dims)
    runner = MatmulRunner(time_fn=_fake_mm, device="cpu")
    assert runner.dtype == "bfloat16"
    states = _bound(task, 30, 3)
    res = ProgramMeasurer(EmptyBuilder(), runner,
                          max_continuous_error=10**9).measure(task, states)
    assert len(res) == len(states)
    assert all(r.error_no == ERROR_NO_ERROR for r in res)
    assert runner.n_timed >= 1
    for cfg, _, err in runner.measured_configs():
        assert err == ERROR_NO_ERROR
        assert om.config_is_valid(*dims, *cfg) == (True, None)


def test_runner_rejects_invalid_and_slow_configs():
    # a stride-2 conv maps onto a config but never fits the stride-1 kernel
    t2 = _conv_task(CO=64, CI=64, stride=2)
    res = Conv2dRunner(time_fn=_fake_conv, device="cpu").run(
        t2, [t2.compute_dag.init_state.copy()])
    assert res[0].error_no == ERROR_INSTANTIATION
    # an axis with no tiling on the float32 lattice (a prime N, too wide
    # for one block's threads; the bf16 kernel masks ragged tiles and
    # takes it)
    t3 = _task(8, 32639, 8)
    r3 = MatmulRunner(dtype="float32", time_fn=_fake_mm, device="cpu")
    res = r3.run(t3, [t3.compute_dag.init_state.copy()])
    assert res[0].error_no == ERROR_INSTANTIATION and r3.n_timed == 0
    # too slow: on the timing path, the prediction guard rejects the
    # config before any kernel is built or launched (bf16: the raw (1, 1,
    # 8) snaps to the narrowest tile, 64 x 16 x 16, predicted at ~26 ms)
    task = _task(8192, 8192, 8192)
    st = task.compute_dag.init_state.copy()
    cid = next(i for i, s in enumerate(st.stages) if s.op.name == "C")
    state_split(st, cid, st.stages[cid].iters[2], [8])
    assert state_to_matmul_config(st)[0] == (1, 1, 8)
    assert om.predicted_seconds(8192, 8192, 8192, 64, 16, 16) > 0.01
    r = MatmulRunner(max_seconds=0.01, device="cuda")  # no time_fn
    assert r.run(task, [st])[0].error_no == ERROR_BUILD_TIMEOUT
    assert r.launches_per_config == {}


def test_runner_needs_a_card_without_a_stand_in_timer():
    task = _task()
    with pytest.raises(ValueError, match="CUDA device"):
        MatmulRunner(device="cpu").run(task, [task.compute_dag.init_state])
    with pytest.raises(ValueError, match="conv2d_layer"):
        Conv2dRunner.task_params(task)


# ---------------------------------------------------------------------------
# the online active loop
# ---------------------------------------------------------------------------

def _online_problem():
    rng = np.random.default_rng(0)
    N, D = 400, 12
    X = rng.integers(1, 64, size=(N, D)).astype(np.float32)
    truth = (X @ rng.standard_normal(D) / 10.0).astype(np.float32)
    return X, truth


def test_online_random_arm_matches_jax():
    X, truth = _online_problem()
    calls = {"jax": [], "torch": []}

    def measure(name):
        def fn(idxs):
            calls[name].append(list(idxs))
            return truth[np.asarray(idxs)]
        return fn

    rj = ja.run_active_search_online(X, measure("jax"), measure_size=16,
                                     max_phases=5, select="random",
                                     sampling_seed=2001)
    rt = ta.run_active_search_online(X, measure("torch"), measure_size=16,
                                     max_phases=5, select="random",
                                     sampling_seed=2001, device="cpu")
    assert calls["torch"] == [[int(i) for i in c] for c in calls["jax"]]
    assert rt.selected_order == [int(i) for i in rj.selected_order]
    assert (rt.best_index, rt.n_measured, rt.phases) == (
        rj.best_index, rj.n_measured, rj.phases) == (rt.best_index, 96, 5)
    assert rt.best_history == pytest.approx(rj.best_history)


def test_online_model_arm_measures_progressively():
    X, truth = _online_problem()
    calls = []

    def measure_fn(idxs):
        calls.append(list(idxs))
        return truth[np.asarray(idxs)]

    res = ta.run_active_search_online(
        X, measure_fn, measure_size=16, max_phases=3, vae_epochs=30,
        reg_epochs=40, latent_dim=16, hidden_dim=64,
        selection=ts.SelectionConfig(num_select=16), device="cpu")
    assert res.n_measured == sum(len(c) for c in calls) == 64
    assert len(set(res.selected_order)) == len(res.selected_order)
    assert res.best_index in res.selected_order
    assert res.best_label == pytest.approx(truth[res.best_index])
    assert all(b1 >= b0 for b0, b1 in zip(res.best_history,
                                          res.best_history[1:]))
    assert len(res.fit_seconds) == len(res.select_seconds) == 3
    assert len(res.measure_seconds) == 4 and res.vae_seconds > 0


def test_online_model_phase_matches_jax():
    """One phase of the model arm as each loop composes it: the JAX loop
    fits on a 256-row gather of the measured rows padded with row 0 and
    masked, the port on the measured rows alone; with the same parameters
    (no dropout or noise) and the same dropout bits they select the same
    candidates."""
    X, truth = _online_problem()
    xs, _ = ta.standardize(X)
    # head width 128: the JAX package takes its fused head, and with it
    # the injected dropout bits, only at a multiple of 128
    n, hid, lat, T = xs.shape[0], 128, 16, 4
    rng = np.random.default_rng(2000)
    order = list(rng.choice(n, size=48, replace=False))
    labels = np.full(n, -1e9, np.float32)
    labels[order] = truth[order]
    prng = np.random.default_rng(5)
    vae = np_vae_params(prng, xs.shape[1], lat, hid)
    params = np_predictor_params(prng, xs.shape[1], hid, lat, hid)
    params = {**params, "encoder": vae["encoder"], "fc_mu": vae["fc_mu"],
              "fc_logvar": vae["fc_logvar"]}
    bits = prng.integers(0, 2 ** 32, (T, n, hid), dtype=np.uint32)
    cfg = dict(dropout=0.0, noise_std=0.0)
    sel = dict(num_select=16, T_mc=T, max_centers=512)
    used = np.zeros(n, bool)
    used[order] = True
    cidx = np.zeros(sel["max_centers"], np.int64)
    cidx[:len(order)] = order
    cval = np.arange(sel["max_centers"]) < len(order)

    midx = np.zeros(256, np.int32)
    midx[:len(order)] = order
    X_j = jnp.asarray(xs)
    pj, _ = jp.fit_predictor(to_jax(params), X_j[midx],
                             jnp.asarray(labels)[midx],
                             jnp.arange(256) < len(order),
                             jax.random.PRNGKey(0), jp.PredictorConfig(**cfg),
                             25)
    sj, vj, _, _ = js.select_programs(
        pj, X_j, jnp.asarray(used), jnp.asarray(~used), jax.random.PRNGKey(1),
        js.SelectionConfig(fused_interpret=True, **sel),
        gate_uncertainty_to_remaining=True, mask_bits=jnp.asarray(bits),
        center_idx=jnp.asarray(cidx.astype(np.int32)),
        center_valid=jnp.asarray(cval))

    X_t = torch.as_tensor(xs)
    mt = torch.as_tensor(np.asarray(order))
    pt, _ = tp.fit_predictor(to_torch(params), X_t[mt],
                             torch.as_tensor(labels[order]), None,
                             torch.Generator().manual_seed(0),
                             tp.PredictorConfig(**cfg), 25)
    with torch.no_grad():
        st, vt, _, _ = ts.select_programs(
            pt, X_t, torch.as_tensor(used), torch.as_tensor(~used),
            torch.Generator().manual_seed(1), ts.SelectionConfig(**sel),
            gate_uncertainty_to_remaining=True,
            mask_bits=torch.as_tensor(bits), center_idx=torch.as_tensor(cidx),
            center_valid=torch.as_tensor(cval))
    got = st.numpy()[vt.numpy()]
    assert len(got) == 16
    assert set(got.tolist()) == set(np.asarray(sj)[np.asarray(vj)].tolist())


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _cli(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run(
        [sys.executable, "-m", "vae_extent_search_tpu_torch.cli.tune_kernel",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300, **kw)


@pytest.mark.parametrize("workload", [
    ["--workload", "matmul", "--dim", "128"],
    ["--workload", "conv2d", "--conv", "1", "14", "14", "64", "32", "3",
     "3"]])
def test_cli_tunes_end_to_end_on_the_cpu(tmp_path, workload):
    log, out_csv = tmp_path / "tune.json", tmp_path / "tune.csv"
    proc = _cli(workload + [
        "--fake-timer", "--device", "cpu", "--n-candidates", "120",
        "--measure-size", "8", "--n-phases", "2", "--vae-epochs", "5",
        "--reg-epochs", "5", "--dtype", "float32", "--log-file", str(log),
        "--out-csv", str(out_csv)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "best config" in proc.stdout
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert len(recs) == 24  # 8 initial + 2 phases of 8
    assert {r["i"][0][1] for r in recs} == {"cuda -model=float32"}
    assert any(r["r"][1] == ERROR_NO_ERROR for r in recs)
    rows = out_csv.read_text().splitlines()
    assert len(rows) == 2 and rows[0].startswith("arm,workload,shape")


def test_cli_needs_cuda_or_a_stand_in_timer(tmp_path):
    base = ["--dim", "64", "--n-candidates", "20", "--log-file",
            str(tmp_path / "t.json")]
    if not torch.cuda.is_available():
        proc = _cli(base)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
    proc = _cli(base + ["--device", "cpu"])
    assert proc.returncode != 0 and "--fake-timer" in proc.stderr
    assert not (tmp_path / "t.json").exists()
