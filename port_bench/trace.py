"""The traced window reduced to intervals: device operations by name and
time, the benchmark's own host spans, and the host operations running
while the device waited.

Times are seconds on the profiler's clock, which it shares between host
and device events.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[float, float]
# the benchmark's own host ranges (harness.py) start with this
SPAN_PREFIX = "pb."
# kernel names are cut to this many characters in the breakdown
NAME_CHARS = 160


def union_length(intervals: List[Interval]) -> float:
    """Total length covered by the (start, end) intervals (copied from the
    port's ``cli/trace_summary.py``)."""
    covered, reach = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > reach:
            covered += b - max(a, reach)
            reach = b
    return covered


def idle_gaps(intervals: List[Interval], lo: float, hi: float
              ) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    gaps, reach = [], lo
    for a, b in sorted(intervals):
        if a > reach:
            gaps.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


@dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Interval = (0.0, 0.0)

    def clip(self) -> List[Tuple[str, float, float]]:
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.device_ops
                if b > lo and a < hi]

    def busy_s(self) -> float:
        return union_length([(a, b) for _, a, b in self.clip()])

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, a, b in self.clip():
            total[name] += b - a
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def gaps_by_host(self, n: int = 10) -> List[List]:
        """Idle seconds of the device in the window, summed by the
        innermost host operation open where each gap starts (host ranges
        of one thread nest, so the open ones form a stack)."""
        total: Dict[str, float] = defaultdict(float)
        ops, i, stack = self.host_ops, 0, []
        for a, b in idle_gaps([(x, y) for _, x, y in self.clip()],
                              *self.window):
            while i < len(ops) and ops[i][1] <= a:
                while stack and stack[-1][2] < ops[i][1]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][2] < a:
                stack.pop()
            total[stack[-1][0] if stack else "(no host operation)"] += b - a
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]


def from_profiler(prof, window_span: str) -> Trace:
    """A Trace of a finished ``torch.profiler.profile``; the window is the
    first to the last host range named ``window_span``."""
    from torch.autograd import DeviceType

    tr = Trace()
    spans = []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            # a host range mirrored onto the device's timeline is no
            # operation of the device
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                tr.device_ops.append((e.name[:NAME_CHARS], a, b))
        elif e.device_type == DeviceType.CPU:
            tr.host_ops.append((e.name, a, b))
            if e.name == window_span:
                spans.append((a, b))
    tr.host_ops.sort(key=lambda x: x[1])
    if spans:
        tr.window = (min(a for a, _ in spans), max(b for _, b in spans))
    return tr
