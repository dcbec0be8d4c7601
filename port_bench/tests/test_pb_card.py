"""Each committed cell on the card: a short run ends with a result line
that is correct and holds the contract's keys. Run on a machine with a
card: ``python -m pytest port_bench/tests -m cuda``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from pb_helpers import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "1", "--trace", trace],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu"
    if trace == "1":
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
