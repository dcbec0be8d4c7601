"""The PyTorch port stands alone: importing every module of it (and the
on-card smoke script) loads neither jax nor the JAX package, and its
command line runs on CUDA unless told otherwise, with no silent move to
the CPU. Each check runs in its own interpreter (this test process has
jax loaded already)."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "vae_extent_search_tpu_torch"
TARGET = "llvm -mcpu=skylake-avx512"

IMPORT_ALL = f"""
import importlib, pkgutil, sys
import {PKG}
mods = [m.name for m in pkgutil.walk_packages({PKG}.__path__, "{PKG}.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "optax",
                                    "vae_extent_search_tpu"))
print(len(mods), bad)
assert not bad, bad
need = {{"models.boost", "models.boost_device", "models.gbdt", "ops.build",
         "ops.hist", "ops.fused_head", "data.boost_corpus",
         "search.active_loop", "cli.vae_extent_search",
         "ir.expr", "ir.tensor", "ir.state", "ir.steps", "ir.schedule_api",
         "ir.intset", "ir.bound", "ir.dag", "records.workload",
         "records.workload_library", "records.task", "records.serde",
         "features.extent", "search.sketch", "search.measure",
         "search.kernel_tuner", "ops.matmul", "ops.conv2d",
         "cli.tune_kernel", "ops.segment_sum", "models.segment",
         "models.embedding", "features.per_store", "data.dataset",
         "cli.make_dataset", "cli.train_model", "cli.eval_model_on_dataset",
         "utils", "utils.misc", "cli.trace_summary", "cli.matmul_sweep",
         "records.networks", "records.tenset_workloads",
         "records.dispatcher", "search.platforms", "search.analytic_hf",
         "utils.schedule_selector", "models.variants", "cli.common",
         "cli.dump_network_info", "cli.estimate_network_latency",
         "cli.search", "search.measure_service", "cli.dump_programs",
         "cli.measure_programs", "cli.remeasure", "cli.print_programs",
         "cli.toy_timer", "cli.tune_vae", "cli.print_all_tasks",
         "cli.json_to_task_pkl", "cli.network2measure_records",
         "cli.few_shot_eval", "cli.hyperparameter_opt", "search.cost_model",
         "search.task_scheduler", "search.auto_schedule",
         "cli.tune_network", "cli.ansor", "ops.kernel_library",
         "cli.tune_kernel_suite", "frontend", "frontend.torch_fx",
         "frontend.zoo", "ir.layout", "records.fast_parser",
         "records.task_desc", "records.expr_desc", "parallel",
         "parallel.mesh", "parallel.multihost", "search.select_sharded",
         "cli.full_sweep", "cli.collect_master", "cli.collect_worker",
         "cli.gather_master"}}
missing = need - {{m.split(".", 1)[1] for m in mods}}
assert not missing and len(mods) >= 95, (missing, mods)
"""


def _run(args, env_extra=None, cwd=ROOT, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # pytest workers run side by side
    env.update(env_extra or {})
    if cwd != ROOT:
        env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_no_jax():
    proc = _run(["-c", IMPORT_ALL])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_needs_cuda_unless_told_cpu(tmp_path):
    cli = ["-m", f"{PKG}.cli.vae_extent_search", "--seeds", "2000",
           "--measure-size", "32", "--vae-epochs", "2", "--reg-epochs", "2",
           "--hidden-dim", "32", "--latent-dim", "8", "--max-phases", "2",
           "--out-dir", str(tmp_path)]
    if not torch.cuda.is_available():
        proc = _run(cli)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert not (tmp_path / "vae_extent_total_avg.csv").exists()
    proc = _run(cli + ["--device", "cpu"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = (tmp_path / "vae_extent_total_avg.csv").read_text().splitlines()
    assert rows[0] == ("measure_size,weights,phase,train_size,used_time,"
                       "top-1,found,n_seeds")
    assert len(rows) == 2


@pytest.mark.parametrize("opts", [
    ["--arm", "grid"], ["--encoder", "vib"], ["--init-mode", "kmeans"],
    ["--init-mode", "diversity"], ["--profile-dir", "trace"]],
    ids=["grid", "vib", "kmeans", "diversity", "profile-dir"])
def test_new_cli_options_need_cuda(tmp_path, opts):
    """Each of the experiment's other options asks for CUDA unless given
    --device cpu (their CPU runs: tests/test_torch_arms_cli.py); the
    profiler does not turn the failure into a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    opts = [str(tmp_path / o) if o == "trace" else o for o in opts]
    proc = _run(["-m", f"{PKG}.cli.vae_extent_search", "--seeds", "2000",
                 "--out-dir", str(tmp_path / "out"), "--vae-epochs", "1",
                 "--reg-epochs", "1", *opts])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "out" / "vae_extent_total_avg.csv").exists()


def test_matmul_sweep_needs_cuda():
    """The f32 lattice sweep times the card and has no CPU mode: without
    CUDA it refuses before it times or prints anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    proc = _run(["-m", f"{PKG}.cli.matmul_sweep", "--dims", "64"])
    assert proc.returncode != 0 and proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


def _network_root(tmp_path):
    """A dataset root holding resnet_50's task pickle and its 26 per-task
    record files (the first 48 records each), and a tiny MLP pickle."""
    import json
    import pickle

    import numpy as np

    from vae_extent_search_tpu_torch.cli import common
    from vae_extent_search_tpu_torch.records.networks import (
        get_network_tasks,
    )

    root = tmp_path / "ds"
    (root / "network_info").mkdir(parents=True)
    (root / "measure_records").mkdir()
    tasks, weights = get_network_tasks("resnet_50", 1, 224, TARGET)
    name = common.clean_name((("resnet_50", [1, 224]), TARGET))
    with open(root / "network_info" / f"{name}.task.pkl", "wb") as f:
        pickle.dump(([t.to_record() for t in tasks], weights), f)
    groups = {}
    with open(os.path.join(ROOT, "result/corpus/resnet_50-B1-llvm.json")) \
            as f:
        for line in f:
            groups.setdefault(json.loads(line)["i"][0][0], []).append(line)
    for key, lines in groups.items():
        path = root / "measure_records" / (
            common.clean_name((key, "llvm")) + ".json")
        path.write_text("".join(lines[:48]))
    rng = np.random.default_rng(0)
    dense = lambda i, o: {  # noqa: E731
        "w": rng.normal(0, 0.1, (i, o)).astype(np.float32),
        "b": np.zeros(o, np.float32)}
    with open(tmp_path / "mlp.pkl", "wb") as f:
        pickle.dump({"config": {"in_dim": 174, "hidden_dim": 8},
                     "params": {"segment_encoder": [dense(174, 8),
                                                    dense(8, 8)],
                                "l0": [dense(8, 8)], "l1": [dense(8, 8)],
                                "decoder": dense(8, 1)},
                     "fea_norm_vec": np.ones(174, np.float32),
                     "use_workload_embedding": True,
                     "workload_embed_total_dim": 10}, f)
    return root



def test_network_entry_points_need_cuda_unless_told_cpu(tmp_path):
    """The network workflow's entry points that run a model
    (train_model with a sequence model, eval_model_on_dataset --networks)
    refuse without CUDA unless given --device cpu, and never move to the
    CPU on their own; the host-only ones (dump_network_info,
    estimate_network_latency, search) take no device."""
    import pickle

    root = _network_root(tmp_path)
    env = {"VES_DATASET_ROOT": str(root)}
    corpus = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")
    ev = ["-m", f"{PKG}.cli.eval_model_on_dataset", "--model",
          str(tmp_path / "mlp.pkl"), "--networks", "resnet_50", "--target",
          TARGET, "--cache-dir", str(tmp_path / "cache")]
    mk = ["-m", f"{PKG}.cli.make_dataset", corpus, "--min-sample-size", "8",
          "--out-file", str(tmp_path / "ds.pkl")]
    assert _run(mk, env_extra=env).returncode == 0
    tr = ["-m", f"{PKG}.cli.train_model", "--dataset",
          str(tmp_path / "ds.pkl"), "--models", "lstm"]
    if not torch.cuda.is_available():
        for cmd in (ev, tr):
            proc = _run(cmd, env_extra=env, cwd=tmp_path)
            assert proc.returncode != 0
            assert "torch.cuda.is_available() is False" in proc.stderr
        assert not (tmp_path / "lstm.pkl").exists()
        assert not (tmp_path / "cache").exists()
    proc = _run(ev + ["--device", "cpu"], env_extra=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "=== resnet_50 (26 tasks) ===" in proc.stdout
    assert "top-5 score" in proc.stdout
    proc = _run(tr + ["--device", "cpu"], env_extra=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(tmp_path / "lstm.pkl", "rb") as f:
        assert pickle.load(f)["arch"] == "lstm"
    for cmd, want in (
            (["-m", f"{PKG}.cli.dump_network_info", "--networks",
              "resnet_18", "--target", TARGET], "all_tasks.pkl: "),
            (["-m", f"{PKG}.cli.estimate_network_latency",
              os.path.join(ROOT, "result/corpus/resnet_50-B1-llvm.json"),
              "--target", TARGET], "estimated latency 9.400 ms (0 tasks"),
            (["-m", f"{PKG}.cli.search", corpus, "--network", "resnet_18",
              "--target", TARGET], "default_search estimated latency")):
        proc = _run(cmd, env_extra={**env, "CUDA_VISIBLE_DEVICES": ""},
                    cwd=tmp_path)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert want in proc.stdout


def test_tune_vae_needs_cuda_unless_told_cpu(tmp_path):
    """The online tuning arm puts its rows on CUDA by default and refuses
    without a card; the collection command lines do host work only and
    take no device."""
    cli = ["-m", f"{PKG}.cli.tune_vae", "--n-candidates", "16",
           "--measure-size", "4", "--n-phases", "1", "--log-file",
           str(tmp_path / "tune.json")]
    if not torch.cuda.is_available():
        proc = _run(cli)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert not (tmp_path / "tune.json").exists()
    for mod in ("dump_programs", "measure_programs", "remeasure",
                "print_programs"):
        proc = _run(["-m", f"{PKG}.cli.{mod}", "--help"])
        assert proc.returncode == 0 and "--device" not in proc.stdout, mod
    # the toy timer, run on its own, loads neither jax nor the JAX package
    code = ("import sys, runpy; sys.argv = ['toy_timer', 'in', 'out']\n"
            "try:\n    runpy.run_module('" + PKG + ".cli.toy_timer', "
            "run_name='__main__')\nexcept FileNotFoundError:\n    pass\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'vae_extent_search_tpu')]\n"
            "assert not bad, bad")
    proc = _run(["-c", code], cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_few_shot_and_hyperparameter_opt_need_cuda_unless_told_cpu(tmp_path):
    """few_shot_eval and hyperparameter_opt train models: without CUDA
    they refuse unless given --device cpu, and write nothing first."""
    import json

    root = _network_root(tmp_path)
    # the first two resnet-50 tasks (~97 records each)
    keys, lines = [], []
    with open(os.path.join(ROOT, "result/corpus/resnet_50-B1-llvm.json")) \
            as f:
        for line in f:
            key = json.loads(line)["i"][0][0]
            keys += [key] if key not in keys else []
            if keys.index(key) < 2:
                lines.append(line)
    (tmp_path / "two.json").write_text("".join(lines))
    mk = ["-m", f"{PKG}.cli.make_dataset", str(tmp_path / "two.json"),
          "--out-file", str(tmp_path / "ds.pkl")]
    assert _run(mk, env_extra={"VES_DATASET_ROOT": str(root)},
                cwd=tmp_path).returncode == 0
    fs = ["-m", f"{PKG}.cli.few_shot_eval", "--base",
          str(tmp_path / "mlp.pkl"), "--dataset", str(tmp_path / "ds.pkl"),
          "--k", "8", "--modes", "zero", "local",
          "--out-csv", str(tmp_path / "fs.csv")]
    hp = ["-m", f"{PKG}.cli.hyperparameter_opt", "--dataset",
          str(tmp_path / "ds.pkl"), "--n-random", "1", "--n-local", "0"]
    if not torch.cuda.is_available():
        for cmd in (fs, hp):
            proc = _run(cmd, cwd=tmp_path)
            assert proc.returncode != 0
            assert "torch.cuda.is_available() is False" in proc.stderr
        assert not (tmp_path / "fs.csv").exists()
    proc = _run(fs + ["--device", "cpu"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "fs.csv").read_text().startswith(
        "mode,k,pairwise,peak@1,peak@5,n_tasks,wall_s")
    proc = _run(hp + ["--device", "cpu"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BEST: " in proc.stdout


def test_tuning_loop_clis_need_cuda_unless_told_cpu(tmp_path):
    """tune_network and ansor run on CUDA by default, whatever the policy:
    without a card they refuse before they extract a task or write a log,
    a latency trace, results.tsv or a work directory. Their CPU runs
    (--device cpu) are held against the JAX scripts in
    tests/test_torch_tuning_loop.py."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    for cli in (["-m", f"{PKG}.cli.tune_network", "--network", "dcgan",
                 "--num-measure-trials", "16", "--log-file", "tn.json"],
                ["-m", f"{PKG}.cli.tune_network", "--network", "dcgan",
                 "--search-policy", "sketch.mlp", "--log-file", "tn.json"],
                ["-m", f"{PKG}.cli.ansor", "--network", "dcgan",
                 "--num-measure-trials", "16", "--work-dir", "w"]):
        proc = _run(cli, cwd=tmp_path)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert "extracted" not in proc.stdout
        assert "Extract tasks" not in proc.stdout
        assert os.listdir(tmp_path) == [], os.listdir(tmp_path)
    for mod in ("tune_network", "ansor"):
        proc = _run(["-m", f"{PKG}.cli.{mod}", "--help"])
        assert proc.returncode == 0 and "--device" in proc.stdout, mod


def test_kernel_suite_and_runner_need_cuda_unless_told_cpu(tmp_path):
    """cli.tune_kernel_suite times the card by default: without one it
    refuses before it measures or writes a log; --device cpu runs only with
    the stand-in timer (--fake-timer). --runner cuda_kernels, the composite
    card runner, refuses on a host without a card before it writes a
    record; its CPU mode is a runner told cpu with a stand-in timer
    (tests/test_torch_selftune.py)."""
    suite = ["-m", f"{PKG}.cli.tune_kernel_suite", "--policy", "sketch",
             "--suite", "matmul:64x64x64", "fusedhead:256x12x32x8x4",
             "--n-trials", "8", "--log-file", "suite.json"]
    if not torch.cuda.is_available():
        for extra in ([], ["--fake-timer"]):
            proc = _run(suite + extra, cwd=tmp_path)
            assert proc.returncode != 0
            assert "torch.cuda.is_available() is False" in proc.stderr
            assert "seeded hand-default" not in proc.stdout
            assert os.listdir(tmp_path) == [], os.listdir(tmp_path)
    proc = _run(suite + ["--device", "cpu"], cwd=tmp_path)
    assert proc.returncode != 0 and "--fake-timer" in proc.stderr
    assert os.listdir(tmp_path) == []
    proc = _run(suite + ["--device", "cpu", "--fake-timer"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "default[G=" in proc.stdout and (tmp_path / "suite.json").exists()
    if torch.cuda.is_available():
        return
    from vae_extent_search_tpu_torch.records import serde

    recs = serde.load_records(str(tmp_path / "suite.json"))
    (tmp_path / "in.json").write_text("".join(
        serde.record_to_json(r) + "\n" for r in recs[:4]))
    for spec in ("cuda_kernels", "cuda_kernels:float32"):
        out = tmp_path / f"out_{spec.replace(':', '_')}.json"
        proc = _run(["-m", f"{PKG}.cli.measure_programs", "--in-file",
                     str(tmp_path / "in.json"), "--out-file", str(out),
                     "--runner", spec], cwd=tmp_path)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr
        assert not out.exists() or out.read_text() == ""


HOST_LIB = f"""
import os
from {PKG}.records import fast_parser
feats, status = fast_parser.featurize_perstore_native(
    "result/corpus/resnet_18-B1-llvm.json")
assert len(feats) == 128 and (status == 0).all(), status
path = os.path.realpath(fast_parser.LIB.library)
build = os.path.realpath(os.path.join("{PKG}", "build"))
assert os.path.dirname(path) == build, (path, build)
maps = [l.split()[-1] for l in open("/proc/self/maps") if ".so" in l]
ours = [m for m in maps if "libves" in m]
assert ours == [path] * len(ours) and ours, ours
assert not [m for m in maps if "vae_extent_search_tpu/" in m], maps
print(path)
"""


def test_host_library_is_the_ports_own():
    """The host library the port loads is its own build under
    ``vae_extent_search_tpu_torch/build/``, never the JAX package's
    ``native/libves_native.so``, even with ``VES_NATIVE_LIB`` pointing at
    it (fresh interpreter; its mapped libraries read from /proc)."""
    jax_lib = os.path.join(ROOT, "vae_extent_search_tpu", "native",
                           "libves_native.so")
    proc = _run(["-c", HOST_LIB], env_extra={"VES_NATIVE_LIB": jax_lib})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.basename(proc.stdout.strip()).startswith("libves_host-")


def test_no_port_module_reads_the_jax_native_library():
    """No module of the port, and not the smoke script, names the JAX
    package's native directory, its library or its library override
    (``VES_NATIVE_LIB``)."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, PKG)):
        paths += [os.path.join(base, n) for n in files if n.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if "VES_NATIVE_LIB" in text or \
                "vae_extent_search_tpu/native" in text or \
                "libves_native" in text:
            offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders
