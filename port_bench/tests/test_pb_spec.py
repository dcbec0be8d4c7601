"""BENCHMARK.json keeps to the format the benchmark's contract sets, and
every name it gives is found as a file."""

import json
import re

from pb_helpers import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text(c["why"]) and text(c["source"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    cells = SPEC["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert {w["config"] for w in cells} == set(names)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and text(w["why"]) and w["chips"] == 1
        assert (REPO / "port_bench/traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert (REPO / "port_bench/limits" / f"{w['name']}.json").is_file()


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "port_bench/layer_metrics" / f"{m['name']}.py"
                ).is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m.get("layer", "x") and text(m.get("layer", "x"))


def test_limits_name_every_number():
    from port_bench.check import NUMBERS

    for w in SPEC["workloads"]:
        limits = json.loads((REPO / "port_bench/limits" / f"{w['name']}.json"
                             ).read_text())
        assert list(limits) == list(NUMBERS)
        assert all(v is None or v >= 0 for v in limits.values())
        assert any(limits[k] is not None for k in NUMBERS
                   if k.startswith("gnorm"))
