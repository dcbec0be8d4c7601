"""Extent featurization for the VAE-extent-search experiment.

Parity target: scripts/pre_experiments/model_myself/utils/extent.py:94-136
and vae_extent_search.py:166-176 — the feature of a schedule is the list of
loop extents in printed order (regex ``\\(0,\\s*(\\d+)\\)`` over the state
text after the "Placeholder" header, trivial (0,1) loops already elided by
the printer), concatenated with the stage ``auto_unroll`` pragma values
(default [0.0]).

We provide the text path (bit-compatible with the regex) and a structural
path that walks the state's print traversal directly — identical output,
no string round-trip, and O(loops) per state.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ir.state import AT_ROOT, State

_EXTENT_RE = re.compile(r"\(0,\s*(\d+)\)")
_UNROLL_RE = re.compile(r"auto_unroll:\s*(\d+)")
_UNIT_FOR_RE = re.compile(r"for\s+(\S+)\s+\(0,\s*1\)")


def extent_vector_from_text(state_text: str) -> np.ndarray:
    """Feature from printed state text (reference regex behavior)."""
    schedule = state_text.split("Placeholder")[-1][2:]
    extents = [float(x) for x in _EXTENT_RE.findall(schedule)]
    unrolls = [float(x) for x in _UNROLL_RE.findall(schedule)]
    if not unrolls:
        unrolls = [0.0]
    return np.asarray(extents + unrolls, dtype=np.float32)


def extent_vector(state: State, delete_trivial_loop: bool = True) -> np.ndarray:
    """Structural extraction: walks stages in print order, collecting
    extents of non-trivial loops and auto_unroll values — equal to
    ``extent_vector_from_text(state.to_str())`` by construction."""
    extents: List[float] = []
    unrolls: List[float] = []

    def visit(stage_id: int):
        stage = state.stages[stage_id]
        if stage.attrs.auto_unroll_max_step != 0:
            unrolls.append(float(stage.attrs.auto_unroll_max_step))
        for i, it in enumerate(stage.iters):
            trivial = (
                delete_trivial_loop
                and it.range is not None
                and it.range[1] == 1
            )
            if (not trivial and it.range is not None and it.range[0] == 0
                    and isinstance(it.range[1], int)):
                # symbolic (data-dependent) extents are skipped, exactly
                # like the reference's regex \(0,\s*(\d+)\) which only
                # matches integer extents (vae_extent_search.py:166-176)
                extents.append(float(it.range[1]))
            attached = state.attach_map.iter_to_attached_stages.get(
                (stage_id, i)
            )
            if attached:
                for a_sid in attached:
                    visit(a_sid)

    for sid, stage in enumerate(state.stages):
        if stage.op_type == "placeholder":
            continue
        if stage.compute_at == AT_ROOT:
            visit(sid)
    if not unrolls:
        unrolls = [0.0]
    return np.asarray(extents + unrolls, dtype=np.float32)


def find_common_unit_loops(schedules: Sequence[str]) -> set:
    """Loop names with extent (0,1) present in every schedule (reference
    utils/extent.py:8-29 find_common_for_loops)."""
    common = None
    for schedule in schedules:
        names = set()
        for line in schedule.split("\n"):
            m = _UNIT_FOR_RE.match(line.lstrip())
            if m:
                names.add(m.group(1))
        common = names if common is None else (common & names)
    return common or set()


def label_from_costs(costs: Sequence[float]) -> float:
    """Search label: -log(mean cost + 1e-8)
    (reference vae_extent_search.py:49-51)."""
    mean = sum(costs) / max(1, len(costs))
    return -math.log(mean + 1e-8)


def extent_features_from_records(
    records,
    max_cost: float = 1e6,
    length_mode: str = "modal",
    infer_bound: bool = True,
):
    """Featurize a list of MeasureRecords into a dense matrix + labels.

    Mirrors the offline experiment's input pipeline (vae_extent_search.py
    :44-56,166-176): replay each record's state, print-order extents +
    unrolls, label = -log(mean cost), records with costs[0] > max_cost
    skipped. Ragged lengths are resolved per ``length_mode``:

    - "modal": keep only vectors of the most common length (the reference
      implicitly requires uniform length at np.array() time)
    - "pad": right-pad with zeros to the max length

    Returns (features [n, d] float32, labels [n] float32, kept_indices).
    """
    vecs, labels, kept = [], [], []
    for i, rec in enumerate(records):
        if rec.res.error_no != 0 or not rec.res.costs:
            continue
        if rec.res.costs[0] > max_cost:
            continue
        st = rec.inp.recover_state(infer_bound=infer_bound)
        vecs.append(extent_vector(st))
        labels.append(label_from_costs(rec.res.costs))
        kept.append(i)

    if not vecs:
        return (np.zeros((0, 0), np.float32), np.zeros((0,), np.float32), [])

    lengths = [len(v) for v in vecs]
    if length_mode == "modal":
        from collections import Counter

        modal = Counter(lengths).most_common(1)[0][0]
        sel = [j for j, l in enumerate(lengths) if l == modal]
        feats = np.stack([vecs[j] for j in sel])
        labs = np.asarray([labels[j] for j in sel], np.float32)
        kept = [kept[j] for j in sel]
        return feats, labs, kept
    elif length_mode == "pad":
        d = max(lengths)
        feats = np.zeros((len(vecs), d), np.float32)
        for j, v in enumerate(vecs):
            feats[j, : len(v)] = v
        return feats, np.asarray(labels, np.float32), kept
    raise ValueError(f"unknown length_mode {length_mode}")
