"""The port's tuning loop (``search/task_scheduler.py``,
``search/auto_schedule.py``, ``SketchPolicy.preload_measured_states``,
``cli/tune_network.py``, ``cli/ansor.py``) against the JAX package on the
CPU.

With the random model the loop's picks and costs depend on the GA's
``random.Random``, numpy's generators and the analytic runner only, so
both packages pick the same tasks, measure the same step lists and reach
the same best costs bit for bit. The JAX side runs its Python paths (its
GA without the native engine, its per-store featuriser without the native
batch), the ones the port has, and every policy of both packages evolves
48 states per generation instead of 2,048 to keep the runs short.
"""

import os
import sys

import numpy as np
import pytest

from _torch_parity import (pin_jax_python_paths, pin_port_python_paths,
                           small_ga_population)
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records import task as jtask
from vae_extent_search_tpu.records import workload as jwl
from vae_extent_search_tpu.records.networks import \
    get_network_tasks as jnet
from vae_extent_search_tpu.search import auto_schedule as jas
from vae_extent_search_tpu.search import measure as jm
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu.search import task_scheduler as jts
from vae_extent_search_tpu_torch.cli import ansor as tansor
from vae_extent_search_tpu_torch.cli import tune_network as ttn
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records import task as ttask
from vae_extent_search_tpu_torch.records import workload as twl
from vae_extent_search_tpu_torch.records.networks import \
    get_network_tasks as tnet
from vae_extent_search_tpu_torch.search import auto_schedule as tas
from vae_extent_search_tpu_torch.search import measure as tm
from vae_extent_search_tpu_torch.search import sketch as tsketch
from vae_extent_search_tpu_torch.search import task_scheduler as tts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TGT = "llvm -mcpu=skylake-avx512"
POP = 48

PORT = dict(ts=tts, m=tm, task=ttask, serde=tserde, sketch=tsketch,
            wl=twl, net=tnet, auto=tas)
JAX = dict(ts=jts, m=jm, task=jtask, serde=jserde, sketch=jsketch, wl=jwl,
           net=jnet, auto=jas)


@pytest.fixture(autouse=True)
def python_paths():
    mp = pytest.MonkeyPatch()
    pin_jax_python_paths(mp)
    pin_port_python_paths(mp)
    small_ga_population(mp, POP)
    yield
    mp.undo()


def _tasks(pkg, workloads):
    """(tasks, weights): a network's (name str) or the four small matmuls
    (None) of the JAX pipeline tests."""
    if workloads is not None:
        return pkg["net"](workloads, 1, 224, TGT)
    return ([pkg["task"].SearchTask(pkg["wl"].make_workload_key(
        "matmul_auto_scheduler_test", (n, n, n)), "llvm")
        for n in (32, 48, 64, 96)], None)


def _log(path, serde):
    return [(r.inp.task.workload_key, r.inp.step_records, r.res.costs,
             r.res.error_no) for r in serde.load_records(path)]


def _tsv(path):
    """total_latency.tsv without its elapsed-time column."""
    with open(path) as f:
        return [ln.rstrip("\n").split("\t")[2:] for ln in f]


# ---------------------------------------------------------------------------
# similarity groups and the gradient strategy's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["llvm", "cuda"])
@pytest.mark.parametrize("network", ["resnet_18", "resnet_50",
                                     "mobilenet_v2", "dcgan", "bert_tiny"])
def test_similarity_tags_equal(network, target):
    size = 128 if network.startswith("bert") else 224
    got = [tts.derive_similarity_tag(t)
           for t in tnet(network, 1, size, target)[0]]
    want = [jts.derive_similarity_tag(t)
            for t in jnet(network, 1, size, target)[0]]
    assert got == want and len(got) > 0 and all(got)


def _schedulers(seed):
    """The two packages' schedulers over resnet_18's 14 tasks with the
    same injected state: best costs, rounds, histories, a dead task."""
    rng = np.random.default_rng(seed)
    out = []
    for pkg in (PORT, JAX):
        tasks, weights = pkg["net"]("resnet_18", 1, 224, TGT)
        out.append(pkg["ts"].TaskScheduler(tasks, weights, callbacks=[],
                                           seed=seed))
    n = len(out[0].tasks)
    best = rng.uniform(1e-4, 1e-2, n)
    best[rng.integers(n)] = 1e10            # one task not measured yet
    cts = rng.integers(0, 9, n).tolist()
    hist = [sorted(rng.uniform(1e-4, 2e-2, c), reverse=True)
            for c in cts]
    dead = {int(rng.integers(n))}
    for s in out:
        s.best_costs = best.copy()
        s.task_cts = list(cts)
        s.task_costs_history = [list(h) for h in hist]
        s.dead_tasks = set(dead)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gradient_parts_equal(seed):
    port, ref = _schedulers(seed)
    assert port.group_task_ids == ref.group_task_ids
    assert any(len(g) > 1 for g in port.group_task_ids)
    for i in range(len(port.tasks)):
        for name in ("_predicted_next_cost", "_history_slope",
                     "_objective_sensitivity"):
            assert getattr(port, name)(i) == getattr(ref, name)(i), (name, i)
    assert [port._gradient_select() for _ in range(5)] == \
        [ref._gradient_select() for _ in range(5)]


def test_gradient_tie_break_draws_the_same_tasks():
    """When every gradient is equal (every task dead here), the pick is
    the scheduler's default_rng(seed) draw, the same in both packages."""
    port, ref = _schedulers(7)
    for s in (port, ref):
        s.dead_tasks = set(range(len(s.tasks)))
    got = [port._gradient_select() for _ in range(12)]
    assert got == [ref._gradient_select() for _ in range(12)]
    assert len(set(got)) > 1


# ---------------------------------------------------------------------------
# the scheduler's loop with the random model
# ---------------------------------------------------------------------------


def _tune(pkg, workloads, strategy, d, trials, **kw):
    tasks, weights = _tasks(pkg, workloads)
    os.makedirs(d, exist_ok=True)
    log, tsv = os.path.join(d, "log.json"), os.path.join(d, "lat.tsv")
    sched = pkg["ts"].TaskScheduler(
        tasks, weights, strategy=strategy,
        callbacks=[pkg["ts"].PrintTableInfo(),
                   pkg["ts"].LogEstimatedLatency(tsv)])
    picks = []
    orig = sched._tune_task
    sched._tune_task = lambda i: (picks.append(i), orig(i))[1]
    opts = pkg["task"].TuningOptions(
        num_measure_trials=trials, num_measures_per_round=8,
        builder=pkg["m"].EmptyBuilder(),
        runner=pkg["m"].AnalyticRunner(noise=0.2),
        measure_callbacks=[pkg["m"].RecordToFile(log)])
    sched.tune(opts, **kw)
    return sched, picks, log, tsv


@pytest.mark.parametrize("strategy", ["round-robin", "gradient"])
@pytest.mark.parametrize("workloads", ["dcgan", None],
                         ids=["dcgan", "matmuls"])
def test_random_policy_scheduler_equals_jax(tmp_path, capsys, strategy,
                                            workloads):
    """The task picked each round, the step lists measured, the best
    costs bit for bit, the trial counts, the printed tables and the
    latency trace."""
    port, p_picks, p_log, p_tsv = _tune(PORT, workloads, strategy,
                                        tmp_path / "port", 96)
    p_out = capsys.readouterr().out
    ref, j_picks, j_log, j_tsv = _tune(JAX, workloads, strategy,
                                       tmp_path / "jax", 96)
    j_out = capsys.readouterr().out
    assert p_picks == j_picks and len(p_picks) >= 12
    assert _log(p_log, tserde) == _log(j_log, jserde)
    assert np.array_equal(port.best_costs, ref.best_costs)
    assert (port.ct, port.task_cts, port.task_costs_history) == \
        (ref.ct, ref.task_cts, ref.task_costs_history)
    assert all(c < 1e9 for c in port.best_costs)
    assert p_out == j_out and "Estimated total latency" in p_out
    assert _tsv(p_tsv) == _tsv(j_tsv) and len(_tsv(p_tsv)) == len(p_picks) + 1


def test_invalid_strategy_refused():
    tasks, _ = _tasks(PORT, None)
    sched = tts.TaskScheduler(tasks, strategy="nope", callbacks=[])
    opts = ttask.TuningOptions(num_measure_trials=64,
                               num_measures_per_round=4,
                               runner=tm.AnalyticRunner())
    with pytest.raises(ValueError, match="invalid strategy"):
        sched.tune(opts)


# ---------------------------------------------------------------------------
# restore and preload
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def matmul_log(tmp_path_factory):
    """A log both packages wrote alike: the four matmuls, 144 trials."""
    d = tmp_path_factory.mktemp("restore")
    mp = pytest.MonkeyPatch()
    pin_jax_python_paths(mp)
    pin_port_python_paths(mp)
    small_ga_population(mp, POP)
    try:
        _, _, p_log, _ = _tune(PORT, None, "round-robin", d / "port", 144)
        _, _, j_log, _ = _tune(JAX, None, "round-robin", d / "jax", 144)
    finally:
        mp.undo()
    assert _log(p_log, tserde) == _log(j_log, jserde)
    return p_log


def test_preload_measured_states_equals_jax(matmul_log):
    tasks = {"port": _tasks(PORT, None)[0], "jax": _tasks(JAX, None)[0]}
    for i in range(4):
        port = tsketch.SketchPolicy(tasks["port"][i], seed=i)
        ref = jsketch.SketchPolicy(tasks["jax"][i], seed=i)
        n = port.preload_measured_states(matmul_log)
        assert n == ref.preload_measured_states(matmul_log) > 0
        assert port.measured_state_keys == ref.measured_state_keys
        assert len(port.measured_state_keys) == n
    assert tsketch.SketchPolicy(tasks["port"][0]).preload_measured_states(
        matmul_log + ".absent") == 0


def test_restore_status_from_log_equals_jax(matmul_log):
    """After tune() built the policies: the trial counts (records // 16),
    best costs, histories and the preloaded state keys."""
    out = []
    for pkg in (PORT, JAX):
        tasks, _ = _tasks(pkg, None)
        s = pkg["ts"].TaskScheduler(tasks, callbacks=[])
        s.num_measures_per_round = 16
        s.search_policies = [pkg["sketch"].SketchPolicy(t, seed=i)
                             for i, t in enumerate(tasks)]
        pkg["ts"].restore_status_from_log(s, matmul_log)
        out.append(s)
    port, ref = out
    assert port.task_cts == ref.task_cts and min(port.task_cts) >= 2
    assert np.array_equal(port.best_costs, ref.best_costs)
    assert port.task_costs_history == ref.task_costs_history
    assert port.cur_score == ref.cur_score < 1e9
    assert [p.measured_state_keys for p in port.search_policies] == \
        [p.measured_state_keys for p in ref.search_policies]
    assert all(p.measured_state_keys for p in port.search_policies)


def test_restore_faults_of_the_tune_network_route_kept(matmul_log):
    """tune_network restores before tune(): no policy exists yet, so no
    state is preloaded, and the counts divide by the default 64, not by
    the 16 that tune() sets later. Both packages do the same."""
    recs = tserde.load_records(matmul_log)
    per_task = {}
    for r in recs:
        if r.res.error_no == 0:
            k = r.inp.task.workload_key
            per_task[k] = per_task.get(k, 0) + 1
    out = []
    for pkg in (PORT, JAX):
        tasks, _ = _tasks(pkg, None)
        s = pkg["ts"].TaskScheduler(tasks, callbacks=[])
        pkg["ts"].restore_status_from_log(s, matmul_log)
        assert not hasattr(s, "search_policies")
        out.append(s.task_cts)
    want = [max(1, per_task[t.workload_key] // 64)
            for t in _tasks(PORT, None)[0]]
    assert out[0] == out[1] == want
    assert want != [max(1, per_task[t.workload_key] // 16)
                    for t in _tasks(PORT, None)[0]]


# ---------------------------------------------------------------------------
# auto_schedule and EmptyPolicy
# ---------------------------------------------------------------------------


def _one_task(pkg):
    return pkg["task"].SearchTask(pkg["wl"].make_workload_key(
        "matmul_auto_scheduler_test", (64, 64, 64)), "llvm")


@pytest.mark.parametrize("early_stopping", [-1, 8])
def test_auto_schedule_equals_jax(early_stopping):
    out = []
    for pkg in (PORT, JAX):
        task = _one_task(pkg)
        opts = pkg["task"].TuningOptions(
            num_measure_trials=40, num_measures_per_round=8,
            early_stopping=early_stopping,
            runner=pkg["m"].AnalyticRunner(noise=0.2))
        st, cost = pkg["auto"].auto_schedule(
            task, pkg["sketch"].SketchPolicy(task, seed=3), opts)
        out.append((st.to_str(), cost))
    assert out[0] == out[1] and np.isfinite(out[0][1])


def test_auto_schedule_without_runner_and_empty_policy():
    """No runner (or no trials): the policy's best guess and an infinite
    cost; EmptyPolicy's rounds sample, bind and never repeat a state."""
    out = []
    for pkg in (PORT, JAX):
        task = _one_task(pkg)
        guess, cost = pkg["auto"].auto_schedule(
            task, pkg["sketch"].SketchPolicy(task, seed=1),
            pkg["task"].TuningOptions(num_measure_trials=0,
                                      num_measures_per_round=4))
        empty = pkg["auto"].EmptyPolicy(task, seed=5)
        rounds = [[s.to_str() for s in empty.continue_search_one_round(6)]
                  for _ in range(3)]
        init = [s.to_str() for s in empty.sample_initial_population(4)]
        out.append((guess.to_str(), cost, rounds, init))
    assert out[0] == out[1]
    guess, cost, rounds, _ = out[0]
    assert cost == float("inf") and guess
    flat = [s for r in rounds for s in r]
    assert len(flat) == len(set(flat)) == 18


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jscripts():
    sys.path.insert(0, ROOT)
    from scripts import tune_network
    from scripts.vae_experiments import ansor

    return tune_network, ansor


def _tsv_rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split("\t")[:-1] for ln in f]


def test_tune_network_cli_equals_jax(jscripts, tmp_path, monkeypatch,
                                     capsys):
    """dcgan at 40 trials, then --continue-tuning for 24 more, then
    --eval-only, through the port's command line (--device cpu) and the
    JAX script's tune_and_evaluate with the same arguments: the same log
    records, the same estimated latency each time (the sum of weight x
    best recorded cost), the same results.tsv rows (timestamps aside)."""
    jtn = jscripts[0]
    steps = [(40, False, False), (24, True, False), (128, False, True)]
    lat = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        lat[side] = []
        for trials, cont, eval_only in steps:
            if side == "port":
                argv = ["--network", "dcgan", "--log-file", "dcgan.json",
                        "--num-measure-trials", str(trials), "--device",
                        "cpu"] + ["--continue-tuning"] * cont + \
                    ["--eval-only"] * eval_only
                lat[side].append(ttn.main(argv)[0])
            else:
                lat[side].append(jtn.tune_and_evaluate(
                    "dcgan", 1, 224, TGT, "dcgan.json", trials,
                    runner=jm.runner_from_spec("analytic", noise=0.2),
                    continue_tuning=cont, eval_only=eval_only)[0])
        capsys.readouterr()
    recs = tserde.load_records(str(tmp_path / "port" / "dcgan.json"))
    assert _log(tmp_path / "port" / "dcgan.json", tserde) == \
        _log(tmp_path / "jax" / "dcgan.json", jserde)
    assert lat["port"] == lat["jax"] and lat["port"][1] == lat["port"][2]
    tasks, weights = tnet("dcgan", 1, 224, TGT)
    best = {}
    for r in recs:
        if r.res.error_no == 0:
            k = r.inp.task.workload_key
            best[k] = min(best.get(k, np.inf), r.res.mean_cost)
    assert len(recs) > 80 and len(best) == 5
    assert lat["port"][2] == sum(best[t.workload_key] * w
                                 for t, w in zip(tasks, weights))
    rows = [_tsv_rows(tmp_path / s / "results.tsv") for s in ("port", "jax")]
    assert rows[0] == rows[1] and len(rows[0]) == 3
    assert rows[0][0][:6] == ["llvm", "simulated", "network", "dcgan.B1",
                              "ours", "vae-extent-search"]
    assert _tsv(tmp_path / "port" / "total_latency.tsv") == \
        _tsv(tmp_path / "jax" / "total_latency.tsv")


def test_ansor_cli_equals_jax_and_caches_its_tasks(jscripts, tmp_path,
                                                   monkeypatch, capsys):
    """cli.ansor --network dcgan (--device cpu) and the JAX script with the
    same arguments: the same records and estimated latency; the second
    run in the same work dir takes its tasks from the pickle cache."""
    jans = jscripts[1]
    argv = ["--network", "dcgan", "--num-measure-trials", "32",
            "--work-dir", "w"]
    monkeypatch.chdir(tmp_path)
    got = [tansor.main(argv + ["--device", "cpu"]) for _ in range(2)]
    out = capsys.readouterr().out
    assert out.count("Extract tasks...") == 1
    assert out.count("Total tasks length : 5") == 2
    monkeypatch.setattr(sys, "argv", ["ansor.py", *argv[:-1], "wj"])
    jans.main()
    jout = capsys.readouterr().out
    want = float(jout.split("Estimated network latency: ")[1].split()[0])
    logs = [os.listdir(tmp_path / w / "measure_records") for w in ("w", "wj")]
    assert logs[0] == logs[1] and len(logs[0]) == 1
    p_recs = _log(tmp_path / "w" / "measure_records" / logs[0][0], tserde)
    j_recs = _log(tmp_path / "wj" / "measure_records" / logs[0][0], jserde)
    assert p_recs[:len(j_recs)] == j_recs
    assert len(p_recs) == 2 * len(j_recs) >= 80
    assert round(got[0] * 1e3, 3) == want and got[1] <= got[0]
    assert os.path.exists(tmp_path / "w" / "dcgan-B1_total_latency.tsv")
