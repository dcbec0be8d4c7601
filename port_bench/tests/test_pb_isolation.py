"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package,
and the reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from pb_helpers import REPO, add_cell, cell_limits

FORBIDDEN = {"jax", "jaxlib", "flax", "vae_extent_search_tpu"}

PROBE = """
import json, sys
sys.argv = ["run.py", "--workload", {name!r}, "--seed", "5",
            "--seconds", "0.3", "--trace", "1", "--rehearse-cpu"]
sys.path.insert(0, "port_bench")
import runpy
try:
    runpy.run_path("port_bench/run.py", run_name="__main__")
except SystemExit as e:
    code = e.code
print(json.dumps({{"code": code, "modules": sorted(
    {{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_rehearsal_loads_no_jax(checkout):
    cfg = json.loads((REPO / "port_bench/configs/vae_extent.json")
                     .read_text())
    cfg.update(hidden_dim=32, latent_dim=16, predictor_hidden=32)
    name = add_cell(checkout, "tiny_extent", "small",
                    cell_limits("vae_extent.select_262k"), config_body=cfg)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", PROBE.format(name=name)],
                       cwd=checkout, env=env, capture_output=True,
                       text=True, timeout=600)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["code"] == 0, p.stderr[-3000:]
    assert "vae_extent_search_tpu_torch" in out["modules"]
    assert not FORBIDDEN & set(out["modules"])


def test_reference_imports_nothing_of_the_port():
    for path in (REPO / "port_bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & (FORBIDDEN | {"vae_extent_search_tpu_torch",
                                             "port_bench"}), path
