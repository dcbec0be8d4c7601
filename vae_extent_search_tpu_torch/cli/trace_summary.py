"""What a ``torch.profiler`` Chrome trace says of the card: the trace that
``cli/vae_extent_search.py --profile-dir`` (``utils/misc.py::trace_profile``)
writes.

    python -m vae_extent_search_tpu_torch.cli.trace_summary DIR/*.pt.trace.json

It prints the traced window (the first event's start to the last event's
end), the device busy time (the union of the CUDA kernel intervals) and
the idle share that leaves, the kernel count and the top kernels by
summed device time, and the same busy time and idle share inside each
host-side range the port marks with ``utils/misc.py::span`` (``SPANS``:
the VAE pretrain, each predictor fit, each selection phase), and summed
by name over the ranges inside a phase (``STAGE_PREFIXES``: the stages of
``select_programs``, ``select.prepare`` to ``select.random``, its host
syncs ``select.sync``, and the fused head's ``fused_head.launch``); then
the whole summary as one JSON line. Kernels run after their launch, so a
range's busy time counts the kernel time inside the range's host bounds;
each of the ``SPANS`` ends in a host read of a device result.
"""

from __future__ import annotations

import argparse
import bisect
import json
from typing import Dict, List, Tuple

SPANS = ("vae_pretrain", "fit_predictor", "select_programs")
STAGE_PREFIXES = ("select.", "fused_head.")


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals."""
    covered, reach = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > reach:
            covered += b - max(a, reach)
            reach = b
    return covered


def summarize(path: str, top: int = 5) -> Dict:
    """The summary of the Chrome trace at ``path`` (times in ms)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events if e.get("cat") == "kernel")
    starts = [a for a, _, _ in kern]
    longest = max((b - a for a, b, _ in kern), default=0.0)
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy = union_length([(a, b) for a, b, _ in kern])
    by_name: Dict[str, List[float]] = {}
    for a, b, n in kern:
        c = by_name.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) / 1e3

    def span(lo, hi):
        i = bisect.bisect_left(starts, lo - longest)
        j = bisect.bisect_left(starts, hi)
        inside = [(max(a, lo), min(b, hi)) for a, b, _ in kern[i:j]
                  if b > lo]
        sb = union_length(inside)
        return {"wall_ms": (hi - lo) / 1e3, "busy_ms": sb / 1e3,
                "idle_share": 1.0 - sb / (hi - lo) if hi > lo else 0.0,
                "kernels": sum(lo <= a < hi for a, _, _ in kern[i:j])}

    spans: Dict[str, List[Dict]] = {}
    stages: Dict[str, Dict] = {}
    for e in sorted(events, key=lambda e: float(e["ts"])):
        if e.get("cat") != "user_annotation":
            continue
        lo = float(e["ts"])
        if e["name"] in SPANS:
            spans.setdefault(e["name"], []).append(
                span(lo, lo + float(e["dur"])))
        elif e["name"].startswith(STAGE_PREFIXES):
            r = span(lo, lo + float(e["dur"]))
            c = stages.setdefault(e["name"], dict.fromkeys(
                ("count", "wall_ms", "busy_ms", "kernels"), 0))
            c["count"] += 1
            for k in ("wall_ms", "busy_ms", "kernels"):
                c[k] += r[k]
    for c in stages.values():
        c["idle_share"] = (1.0 - c["busy_ms"] / c["wall_ms"]
                           if c["wall_ms"] > 0 else 0.0)
    copies = [float(e["dur"]) for e in events
              if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    return {
        "events": len(events), "window_ms": (t1 - t0) / 1e3,
        "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / (t1 - t0),
        "kernel_events": len(kern),
        "memcpy_memset": {"count": len(copies), "ms": sum(copies) / 1e3},
        "kernels_by_name": by_name,
        "top_kernels_ms": sorted(((n, c[1]) for n, c in by_name.items()),
                                 key=lambda x: -x[1])[:top],
        "spans": spans,
        "stages": stages,
    }


def report(s: Dict) -> List[str]:
    """Readable lines of a summary."""
    lines = [
        f"traced window {s['window_ms']:.1f} ms, {s['events']} events; "
        f"device busy (union of kernel intervals) {s['busy_ms']:.1f} ms; "
        f"idle share {s['idle_share']:.4f}",
        f"CUDA kernel events {s['kernel_events']} of "
        f"{len(s['kernels_by_name'])} kernels; memcpy/memset "
        f"{s['memcpy_memset']['count']} events, "
        f"{s['memcpy_memset']['ms']:.3f} ms",
    ]
    for n, ms in s["top_kernels_ms"]:
        lines.append(f"  {ms:10.3f} ms {s['kernels_by_name'][n][0]:8d}x "
                     f"{n[:110]}")
    for name, rows in s["spans"].items():
        for i, r in enumerate(rows):
            lines.append(f"{name} {i + 1}: wall {r['wall_ms']:.1f} ms, "
                         f"device busy {r['busy_ms']:.1f} ms, idle share "
                         f"{r['idle_share']:.4f}, {r['kernels']} kernels")
    for name, c in s["stages"].items():
        lines.append(f"{name} x{c['count']}: wall {c['wall_ms']:.3f} ms, "
                     f"device busy {c['busy_ms']:.3f} ms, idle share "
                     f"{c['idle_share']:.4f}, {c['kernels']} kernels")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace", help="a Chrome trace (.pt.trace.json)")
    p.add_argument("--top", type=int, default=5,
                   help="kernels to list by summed device time")
    args = p.parse_args(argv)
    s = summarize(args.trace, args.top)
    for line in report(s):
        print(line)
    print(json.dumps(s))


if __name__ == "__main__":
    main()
