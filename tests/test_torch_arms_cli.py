"""The headline experiment's command line in the port against the JAX
package on the CPU: the grid arm's config expansion and filter,
``utils.misc`` (the trace scope included), and the new options
``--arm grid``, ``--encoder vib``, ``--init-mode`` and ``--profile-dir``
at tiny widths."""

import csv
import glob
import importlib.util
import json
import os

import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads per worker)
from vae_extent_search_tpu.search import active_loop as ja
from vae_extent_search_tpu.utils import misc as jmisc
from vae_extent_search_tpu_torch.cli import trace_summary as tsum
from vae_extent_search_tpu_torch.cli import vae_extent_search as tcli
from vae_extent_search_tpu_torch.search import active_loop as ta
from vae_extent_search_tpu_torch.utils import misc as tmisc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    """scripts/vae_extent_search.py as a module (its DEFAULT_GRID)."""
    spec = importlib.util.spec_from_file_location(
        "jax_vae_extent_search_script",
        os.path.join(ROOT, "scripts", "vae_extent_search.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the grid arm's configs
# ---------------------------------------------------------------------------


def _prefill(path, pairs):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["measure_size", "weights", "phase", "train_size",
                    "used_time", "top-1", "found", "n_seeds"])
        for ms, wt in pairs:
            w.writerow([ms, str(tuple(wt)), 1, 64, 0.1, 0, 1, 1])


def test_grid_expansion_and_filter_match_jax(tmp_path):
    script = _jax_script()
    assert tcli.DEFAULT_GRID == script.DEFAULT_GRID
    grid = tcli.DEFAULT_GRID
    rows_t = ta.expand_hyper_grid(grid)
    assert rows_t == ja.expand_hyper_grid(grid) and len(rows_t) == 24
    flt = [lambda r: r["grad_num"] == 2, lambda r: r["measure_size"] == 64]
    assert ta.expand_hyper_grid(grid, flt) == ja.expand_hyper_grid(grid, flt)
    avg = tmp_path / "avg.csv"
    keys = ["measure_size", "weights"]
    assert ta.filter_already_measured(rows_t, str(avg), keys) == rows_t
    _prefill(avg, [(32, (0.5, 0.3, 0.2)), (64, (0.7, 0.2, 0.1))])
    kept = ta.filter_already_measured(rows_t, str(avg), keys)
    assert kept == ja.filter_already_measured(rows_t, str(avg), keys)
    assert len(kept) == 16


# ---------------------------------------------------------------------------
# utils.misc
# ---------------------------------------------------------------------------


def test_misc_helpers_match_jax():
    for x in (1.23456789, [1, 2.5, (3.0, "a")], {"a": 0.1, "b": [2.0]}, 7,
              "s"):
        assert tmisc.to_str_round(x, 3) == jmisc.to_str_round(x, 3)
    assert tmisc.array_mean([1, 2, 4.5]) == jmisc.array_mean([1, 2, 4.5])
    assert tmisc.array_mean([]) == jmisc.array_mean([])
    pt = tmisc.PathManager("root", "resnet_18", "cuda -model=a100")
    pj = jmisc.PathManager("root", "resnet_18", "cuda -model=a100")
    key = '["conv2d", 1, 56]'
    for attr in ("network_info_dir", "to_measure_dir", "records_dir"):
        assert getattr(pt, attr) == getattr(pj, attr)
    assert pt.task_pkl() == pj.task_pkl()
    assert pt.record_log(key) == pj.record_log(key)
    assert pt.latency_tsv() == pj.latency_tsv()


def _trace_files(path):
    return glob.glob(os.path.join(str(path), "*.pt.trace.json"))


def test_trace_profile_off_and_on(tmp_path):
    with tmisc.trace_profile(None) as prof:
        torch.ones(4).sum()
    assert prof is None
    with tmisc.trace_profile(str(tmp_path / "off"), enabled=False) as prof:
        torch.ones(4).sum()
    assert prof is None and not (tmp_path / "off").exists()
    with tmisc.trace_profile(str(tmp_path / "on")):
        with torch.profiler.record_function("span"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (f,) = _trace_files(tmp_path / "on")
    events = json.load(open(f))["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert "cpu_op" in cats
    assert any(e.get("name") == "span" for e in events)


def test_trace_profile_lets_exceptions_through(tmp_path):
    with pytest.raises(KeyError):
        with tmisc.trace_profile(str(tmp_path)):
            torch.ones(2).sum()
            raise KeyError("inside")
    assert len(_trace_files(tmp_path)) == 1


# ---------------------------------------------------------------------------
# the command line on the CPU
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--seeds", "2000", "--vae-epochs", "2",
        "--reg-epochs", "3", "--hidden-dim", "32", "--latent-dim", "8"]
# the per-run CSV's columns, as scripts/vae_extent_search.py writes them
RUN_COLUMNS = ["measure_size", "weights", "uncertainty_topk", "grad_num",
               "rand_num", "phase", "used_time", "train_size", "val_reg_r2",
               "top-1", "optimum_rank", "found", "sampling_seed"]
AVG_COLUMNS = ["measure_size", "weights", "phase", "train_size",
               "used_time", "top-1", "found", "n_seeds"]


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_cli_grid_runs_only_unmeasured_configs(tmp_path, monkeypatch):
    pairs = sorted({(r["measure_size"], r["weights"])
                    for r in ta.expand_hyper_grid(tcli.DEFAULT_GRID)})
    left = (32, (0.4, 0.3, 0.3))
    _prefill(tmp_path / "vae_extent_total_avg.csv",
             [p for p in pairs if p != left])
    pretrains = []
    orig = tcli.pretrain_pool_vae
    monkeypatch.setattr(tcli, "pretrain_pool_vae",
                        lambda *a, **kw: pretrains.append(1) or orig(*a, **kw))
    tcli.main(["--arm", "grid", "--out-dir", str(tmp_path), "--max-phases",
               "1", *TINY])
    rows = _csv(tmp_path / "vae_extent_total_avg.csv")[len(pairs) - 1:]
    assert len(rows) == 4 and len(pretrains) == 1
    assert {(r["measure_size"], r["weights"]) for r in rows} == {
        (str(left[0]), str(left[1]))}
    assert list(rows[0]) == AVG_COLUMNS
    # every config measured now: a second sweep runs nothing
    _prefill(tmp_path / "vae_extent_total_avg.csv", pairs)
    tcli.main(["--arm", "grid", "--out-dir", str(tmp_path), *TINY])
    assert len(pretrains) == 1


@pytest.mark.parametrize("opts", [["--encoder", "vib"],
                                  ["--init-mode", "kmeans"],
                                  ["--init-mode", "diversity"]],
                         ids=["vib", "kmeans", "diversity"])
def test_cli_new_arms_write_the_jax_columns(tmp_path, opts):
    tcli.main(["--out-dir", str(tmp_path), "--measure-size", "32",
               "--max-phases", "2", *TINY, *opts])
    (run_csv,) = glob.glob(str(tmp_path / "vae_extent_search_*.csv"))
    rows = _csv(run_csv)
    assert len(rows) == 1 and list(rows[0]) == RUN_COLUMNS
    avg = _csv(tmp_path / "vae_extent_total_avg.csv")
    assert len(avg) == 1 and list(avg[0]) == AVG_COLUMNS


def test_cli_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("VES_TRACE_DIR", str(tmp_path / "env"))
    tcli.main(["--out-dir", str(tmp_path / "out"), "--measure-size", "32",
               "--max-phases", "1", "--profile-dir", str(tmp_path / "trace"),
               *TINY])
    (f,) = _trace_files(tmp_path / "trace")
    names = {e.get("name") for e in json.load(open(f))["traceEvents"]}
    assert {"vae_pretrain", "fit_predictor", "select_programs"} <= names
    assert not (tmp_path / "env").exists()


# ---------------------------------------------------------------------------
# reading a trace
# ---------------------------------------------------------------------------


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 0,
            "ts": ts, "dur": dur}


def test_trace_summary_unions_kernel_intervals(tmp_path):
    """Overlapping kernels count once; a span's busy time is the kernel
    time inside its host bounds; flow and metadata events are skipped."""
    events = [
        _x("cpu_op", "aten::mm", 0.0, 1000.0),
        _x("user_annotation", "fit_predictor", 100.0, 400.0),
        _x("user_annotation", "select_programs", 600.0, 300.0),
        _x("kernel", "k_a", 150.0, 100.0),     # inside the fit
        _x("kernel", "k_b", 200.0, 100.0),     # overlaps k_a: 150-300
        _x("kernel", "k_a", 450.0, 100.0),     # straddles the fit's end
        _x("kernel", "fused_head_kernel", 700.0, 50.0),
        _x("gpu_memcpy", "Memcpy DtoH", 800.0, 10.0),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 5.0, "id": 1},
        {"ph": "M", "name": "process_name", "pid": 0},
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tsum.summarize(str(path), top=2)
    assert s["window_ms"] == pytest.approx(1.0)
    # 150-300, 450-550, 700-750
    assert s["busy_ms"] == pytest.approx(0.3)
    assert s["idle_share"] == pytest.approx(0.7)
    assert s["kernel_events"] == 4
    assert s["kernels_by_name"]["k_a"] == [2, pytest.approx(0.2)]
    assert [n for n, _ in s["top_kernels_ms"]] == ["k_a", "k_b"]
    assert s["memcpy_memset"] == {"count": 1, "ms": pytest.approx(0.01)}
    (fit,) = s["spans"]["fit_predictor"]
    assert fit["busy_ms"] == pytest.approx(0.2)   # 150-300 and 450-500
    assert fit["idle_share"] == pytest.approx(0.5)
    assert fit["kernels"] == 3
    (sel,) = s["spans"]["select_programs"]
    assert sel["busy_ms"] == pytest.approx(0.05) and sel["kernels"] == 1
    assert any("fit_predictor 1" in ln for ln in tsum.report(s))


def test_trace_summary_reads_a_cpu_trace(tmp_path, capsys):
    with tmisc.trace_profile(str(tmp_path)):
        with torch.profiler.record_function("fit_predictor"):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
        with tmisc.span("select_programs"):
            for _ in range(3):
                with tmisc.span("select.sync"):
                    torch.ones(4).sum()
            with tmisc.span("fused_head.launch"):
                torch.ones(4).sum()
    (f,) = _trace_files(tmp_path)
    tsum.main([f])
    out = capsys.readouterr().out.splitlines()
    s = json.loads(out[-1])
    assert s["kernel_events"] == 0 and s["idle_share"] == 1.0
    assert len(s["spans"]["fit_predictor"]) == 1
    assert len(s["spans"]["select_programs"]) == 1
    assert set(s["stages"]) == {"select.sync", "fused_head.launch"}
    assert s["stages"]["select.sync"]["count"] == 3
    assert s["stages"]["select.sync"]["idle_share"] == 1.0
    assert any(ln.startswith("select.sync x3:") for ln in out)


def test_trace_summary_sums_the_stage_ranges_by_name(tmp_path):
    """Ranges named by a stage prefix are summed by name: wall time, the
    kernel time inside them and the idle share that leaves."""
    events = [
        _x("user_annotation", "select_programs", 0.0, 1000.0),
        _x("user_annotation", "select.sync", 100.0, 100.0),
        _x("user_annotation", "select.sync", 500.0, 300.0),
        _x("user_annotation", "fused_head.launch", 250.0, 50.0),
        _x("user_annotation", "other.range", 0.0, 50.0),
        _x("kernel", "fused_head_kernel", 150.0, 500.0),
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tsum.summarize(str(path))
    assert set(s["stages"]) == {"select.sync", "fused_head.launch"}
    sync = s["stages"]["select.sync"]
    # 400 us of ranges; the kernel covers 150-200 and 500-650 of them
    assert sync["count"] == 2
    assert sync["wall_ms"] == pytest.approx(0.4)
    assert sync["busy_ms"] == pytest.approx(0.2)
    assert sync["idle_share"] == pytest.approx(0.5)
    assert sync["kernels"] == 1
    launch = s["stages"]["fused_head.launch"]
    assert launch["busy_ms"] == pytest.approx(0.05)
    assert launch["idle_share"] == pytest.approx(0.0)
