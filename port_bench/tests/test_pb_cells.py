"""A cell added as files alone is found by name and runs; the command
refuses to run without a card or without the port."""

import json
import os
import subprocess
import sys

import pytest
import torch

from pb_helpers import REPO, add_cell, cell_limits

METRIC = '''"""Phases per second of the traced window."""


def read(ctx):
    return ctx["phases"] / ctx["trace"].window_s()
'''


def run(root, *args, port=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) if port else ""
    return subprocess.run([sys.executable, "port_bench/run.py", *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)


def test_a_cell_added_as_files_runs(checkout):
    cfg = json.loads((REPO / "port_bench/configs/vae_extent.json")
                     .read_text())
    cfg.update(hidden_dim=32, latent_dim=16, predictor_hidden=32)
    name = add_cell(checkout, "tiny_extent", "tiny_loop",
                    cell_limits("vae_extent.select_262k"), config_body=cfg,
                    traffic_body={"pool_rows": 512, "episode_phases": 4,
                                  "initial_measured": 8,
                                  "warmup_phases": 4})
    (checkout / "port_bench/layer_metrics/phases_per_s.py").write_text(
        METRIC)
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "phases_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "whole phase",
        "moves": "cands_per_s", "workloads": [name]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))

    for trace in ("0", "1"):
        p = run(checkout, "--workload", name, "--seed", str(2 ** 33 + 1),
                "--seconds", "0.5", "--trace", trace, "--rehearse-cpu")
        assert p.returncode == 0, p.stderr[-3000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        assert list(res)[-1] == "compared"
        assert p.stderr.strip().splitlines()[-1].startswith("kcenter_gap")
        if trace == "0":
            assert set(res["metrics"]) == {"cands_per_s", "phase_p95_ms",
                                           "peak_mem_gib", "setup_s"}
        else:
            assert res["metrics"]["phases_per_s"]["value"] > 0


def test_refuses_without_a_card(checkout):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = run(checkout, "--workload", "vae_extent.select_262k", "--seed", "1",
            "--seconds", "1")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_without_the_port(checkout):
    p = run(checkout, "--workload", "vae_extent.select_262k", "--seed", "1",
            "--seconds", "1", "--rehearse-cpu", port=False)
    assert p.returncode != 0 and p.stdout.strip() == ""
