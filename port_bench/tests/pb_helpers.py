"""Helpers of the benchmark's CPU tests: a scratch checkout holding
BENCHMARK.json and a copy of ``port_bench/``, and cells added to it as
files, the way a later change adds a cell."""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a pool small enough for the port's plain kernel version on the CPU
SMALL_TRAFFIC = {"pool_rows": 1024, "episode_phases": 8,
                 "initial_measured": 32, "warmup_phases": 8}


def add_cell(root: Path, config: str, traffic: str, limits: dict,
             config_body: dict = None, traffic_body: dict = None) -> str:
    """Add the cell ``config.traffic`` to the checkout at ``root`` as files
    and entries of BENCHMARK.json alone; returns its name."""
    bench = root / "port_bench"
    if config_body is not None:
        (bench / "configs" / f"{config}.json").write_text(
            json.dumps(config_body))
    if traffic_body is not None:
        (bench / "traffic" / f"{traffic}.json").write_text(
            json.dumps(traffic_body))
    name = f"{config}.{traffic}"
    (bench / "limits" / f"{name}.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if config_body is not None:
        spec["configs"].append({
            "name": config, "source": "test", "reduced": [], "why": "test",
            "file": f"port_bench/configs/{config}.json"})
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return name




def make_checkout(tmp_path: Path) -> Path:
    """A scratch checkout with the benchmark's committed files and the
    small traffic ``small`` beside ``select_262k``."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "port_bench" / "traffic" / "small.json").write_text(
        json.dumps(SMALL_TRAFFIC))
    return tmp_path


def cell_limits(name: str) -> dict:
    return json.loads((REPO / "port_bench" / "limits" / f"{name}.json")
                      .read_text())
