"""Readings of the port's own host ranges in the traced window: the
``select_programs`` span of each phase, the ``select.sync`` spans around
each place where the host waits for the card, and the fused head's
``fused_head.launch`` (``vae_extent_search_tpu_torch/utils/misc.py::span``).

The port opens these ranges only while a profiler runs, so they lie on
the profiler's clock with the device operations. A program without them
gives no intervals, and each reading is then None.
"""

from __future__ import annotations

from typing import List, Optional

from port_bench.trace import Interval, Trace, idle_gaps, union_length

SELECT = "select_programs"
SYNC = "select.sync"
LAUNCH = "fused_head.launch"


def host_spans(tr: Trace, name: str) -> List[Interval]:
    """The host ranges named ``name`` inside the window, clipped to it."""
    lo, hi = tr.window
    return [(max(a, lo), min(b, hi)) for n, a, b in tr.host_ops
            if n == name and b > lo and a < hi]


def overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Length of the intersection of the union of ``xs`` with the union
    of ``ys``: |X| + |Y| - |X u Y|."""
    return union_length(xs) + union_length(ys) - union_length(xs + ys)


def per_phase_ms(ctx, seconds: float) -> float:
    return 1e3 * seconds / ctx["phases"]


def select_split(ctx) -> Optional[tuple]:
    """(work, wait): host seconds of the window inside ``select_programs``
    and outside its ``select.sync`` spans, and inside them; None where the
    trace holds no ``select_programs`` span."""
    sel = host_spans(ctx["trace"], SELECT)
    if not sel:
        return None
    wait = overlap(sel, host_spans(ctx["trace"], SYNC))
    return union_length(sel) - wait, wait


def select_idle_s(ctx) -> Optional[float]:
    """Device-idle seconds of the window that fall inside the
    ``select_programs`` spans; None without device operations or spans."""
    tr = ctx["trace"]
    sel = host_spans(tr, SELECT)
    ops = [(a, b) for _, a, b in tr.clip()]
    if not sel or not ops:
        return None
    return overlap(idle_gaps(ops, *tr.window), sel)
