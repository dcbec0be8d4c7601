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
         "utils", "utils.misc", "cli.trace_summary", "cli.matmul_sweep"}}
missing = need - {{m.split(".", 1)[1] for m in mods}}
assert not missing and len(mods) >= 56, (missing, mods)
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # pytest workers run side by side
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
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
