"""The readings of a run that do not need a card: the idle gaps of the
device attributed to the host range open where each starts, and the
per-layer metrics read by the host's clock from the unprofiled window."""

import importlib.util

import pytest

from pb_helpers import REPO
from port_bench.trace import Trace, idle_gaps, union_length


def metric(name):
    path = REPO / "port_bench/layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_test_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert union_length(iv) == 4.0
    assert idle_gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]


def test_gaps_go_to_the_innermost_open_host_range():
    tr = Trace(device_ops=[("k", 0.0, 1.0), ("k", 2.0, 3.0),
                           ("k", 5.0, 6.0), ("k", 8.5, 10.0)],
               host_ops=[("pb.phase", 0.0, 7.0), ("sync", 1.5, 1.8),
                         ("launch", 2.9, 4.0), ("pb.phase", 8.0, 10.0)],
               window=(0.0, 10.0))
    # gaps: [1, 2) in pb.phase, [3, 5) in launch, [6, 8.5) in pb.phase
    got = dict(tr.gaps_by_host())
    assert got == pytest.approx({"pb.phase": 1.0 + 2.5, "launch": 2.0})
    tr.host_ops = [("pb.phase", 0.0, 5.5), ("pb.phase", 8.0, 10.0)]
    got = dict(tr.gaps_by_host())
    assert got["(no host operation)"] == pytest.approx(2.5)


def test_host_clock_metrics_read_the_unprofiled_window():
    timed = [(0.0, 0.010, 0.012), (0.012, 0.030, 0.031)]
    ctx = {"timed": timed, "window_s": 0.031, "trace": None,
           "config": {"compute_dtype": "float32", "T_mc": 10,
                      "input_dim": 17, "hidden_dim": 256, "latent_dim": 64,
                      "predictor_hidden": 256, "encoder_layers": 3},
           "N": 1024, "phases": 5}
    assert metric("select_host_ms").read(ctx) == pytest.approx(14.0)
    mfu = metric("select_mfu").read(ctx)
    from port_bench.layers import phase_ops, peak_flops
    assert mfu == pytest.approx(
        100 * phase_ops(ctx) / (0.031 / 2) / peak_flops(ctx))
    ctx["timed"] = []
    assert metric("select_host_ms").read(ctx) is None
    assert metric("select_mfu").read(ctx) is None
