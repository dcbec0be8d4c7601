"""The per-layer metrics that read the port's own host ranges and its sync
counter, on a synthetic traced window: known values, the split of the
``select_programs`` span into host work and sync waits, an idle gap that
straddles a span's edge, and nothing read from a program without them."""

import pytest

from pb_helpers import REPO  # noqa: F401  (puts the repository on the path)
from port_bench.spans import overlap
from port_bench.trace import Trace
from test_pb_trace import metric
from vae_extent_search_tpu_torch.search import select

# two phases in a window of 0-20 (seconds on the profiler's clock)
HOST = [
    ("pb.phase", 0.0, 10.0),
    ("select_programs", 1.0, 7.0),
    ("select.prepare", 1.0, 1.5),
    ("select.sync", 1.5, 2.5),
    ("fused_head.launch", 2.5, 3.0),
    ("select.sync", 4.0, 4.5),
    ("pb.phase", 10.0, 20.0),
    ("select_programs", 11.0, 15.0),
    ("select.sync", 11.5, 12.0),
    ("fused_head.launch", 12.0, 12.25),
    ("select.sync", 14.0, 15.5),      # reaches past its phase's span
]
DEVICE = [
    ("fused_head_kernel", 0.0, 2.0),   # idle 2-3.5 inside select_programs
    ("k", 3.5, 6.0),                   # idle 6-12: 6-7 and 11-12 inside
    ("fused_head_kernel", 12.0, 14.5),
    ("k", 16.0, 20.0),                 # idle 14.5-16: 14.5-15 inside
]


def ctx(host=HOST, device=DEVICE):
    return {"trace": Trace(device_ops=list(device), host_ops=list(host),
                           window=(0.0, 20.0)),
            "phases": 2, "timed": [(0, 0, 0)] * 4,
            "traffic": {"warmup_phases": 8}}


def read(name, c=None):
    return metric(name).read(c or ctx())


def test_overlap_of_two_unions():
    assert overlap([(0, 2), (1, 3)], [(2.5, 5)]) == pytest.approx(0.5)
    assert overlap([(0, 1)], [(2, 3)]) == 0.0


def test_select_span_splits_into_work_and_waits():
    # select_programs: 6 + 4 = 10 s; syncs inside it: 1 + 0.5 + 0.5 + 1
    work, wait = read("select_host_work_ms"), read("select_sync_wait_ms")
    assert wait == pytest.approx(1e3 * 3.0 / 2)
    assert work == pytest.approx(1e3 * 7.0 / 2)
    # the two add up to the mean select_programs span, nothing twice
    spans = [b - a for n, a, b in HOST if n == "select_programs"]
    assert work + wait == pytest.approx(1e3 * sum(spans) / len(spans))


def test_idle_inside_the_select_spans():
    # 2-3.5 (1.5), 6-7 (1), 11-12 (1), 14.5-15 (0.5 of a gap that runs on
    # to 16, past the span's end)
    assert read("select_idle_ms") == pytest.approx(1e3 * 4.0 / 2)
    c = ctx(device=[])
    assert read("select_idle_ms", c) is None


def test_fused_head_host_time():
    assert read("fused_head_host_ms") == pytest.approx(1e3 * 0.75 / 2)


def test_syncs_a_phase_from_the_ports_counter(monkeypatch):
    monkeypatch.setattr(select.select_programs, "host_syncs", 434,
                        raising=False)
    # 8 set-up phases, 4 measured, 2 traced
    assert read("select_syncs") == pytest.approx(434 / 14)
    monkeypatch.delattr(select.select_programs, "host_syncs")
    assert read("select_syncs") is None


@pytest.mark.parametrize("name", ["select_host_work_ms",
                                  "select_sync_wait_ms", "select_idle_ms",
                                  "fused_head_host_ms"])
def test_nothing_to_read_without_the_ports_ranges(name):
    bench_only = [h for h in HOST if h[0].startswith("pb.")]
    assert read(name, ctx(host=bench_only)) is None
