"""Schedule-driven layout rewriting for layout-free placeholders (a copy
of ``vae_extent_search_tpu/ir/layout.py``).

Parity target: ComputeDAG::RewriteLayout (reference compute_dag.cc:893-1020
with GetOrigLayout :789 / GetNewLayout :822): conv weights (placeholders
consumed only by ops needing multi-level tiling) are re-laid-out to match
the chosen schedule's loop order, so the kernel reads them contiguously.
The new layout is derived from the bound state's final loop nest — each
leaf iterator (attach prefix included, fused iterators decomposed into
their components) whose base axis indexes the placeholder contributes one
tiled dimension, in loop order.

This is the host-side weight pre-packing step; the returned
``transform_array`` recipe is a reshape + transpose of a numpy array.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import expr as E
from .state import State
from .tensor import ComputeOp, PlaceholderOp


def _base_name(name: str) -> str:
    """'ff.0' -> 'ff'; fused components are split by the caller."""
    return name.split(".")[0]


def _full_extents(stage) -> Dict[int, int]:
    """uid -> full extent over the relation log (forward pass)."""
    full: Dict[int, int] = {}
    for it in stage.iters:
        full[it.uid] = it.range[1] if it.range is not None else 1
    for uid, dim in stage.root_of.items():
        full.setdefault(uid, dim.extent)
    for rel in stage.relations:
        if rel.kind == "split":
            p = full.get(rel.parent)
            if p is None or rel.factor is None:
                continue
            if not rel.by_nparts:
                full.setdefault(rel.inner, rel.factor)
                full.setdefault(rel.outer, -(-p // rel.factor))
            else:
                full.setdefault(rel.outer, rel.factor)
                full.setdefault(rel.inner, -(-p // rel.factor))
        else:
            o = full.get(rel.outer)
            i = full.get(rel.inner) if rel.inner is not None else 1
            if o is not None and i is not None:
                full.setdefault(rel.fused, o * i)
    return full


def _leaf_components(stage, it) -> List[Tuple[str, int]]:
    """(base axis name, extent) per primitive component of a leaf iterator
    (fused leaves decompose through the fuse relations; names recover from
    the '@'-joined fused name)."""
    full = _full_extents(stage)
    fuse_children = {}
    for rel in stage.relations:
        if rel.kind == "fuse":
            kids = [rel.outer] + ([rel.inner] if rel.inner is not None else [])
            fuse_children[rel.fused] = kids

    def expand(uid):
        kids = fuse_children.get(uid)
        if kids is None:
            return [uid]
        out = []
        for k in kids:
            out.extend(expand(k))
        return out

    comps = expand(it.uid)
    if len(comps) == 1:
        return [(_base_name(it.name), full.get(it.uid, 1))]
    names = [n for n in it.name.split("@") if n]
    if len(names) != len(comps):  # unparsable fused name: fall back
        return [(_base_name(it.name), full.get(it.uid, 1))]
    return [
        (_base_name(n), full.get(uid, 1)) for n, uid in zip(names, comps)
    ]


def get_orig_layout(op: ComputeOp, placeholder) -> List[Tuple[str, int]]:
    """[(axis name, extent)] per placeholder dim from the consumer's read
    (GetOrigLayout, compute_dag.cc:789: each index must be a single axis
    var or the constant 0)."""
    for r in E.collect_reads(op.body):
        if r.tensor.op.uid != placeholder.uid:
            continue
        layout = []
        for d, idx in enumerate(r.indices):
            if isinstance(idx, E.Var):
                layout.append((idx.name, placeholder.shape[d]))
            elif isinstance(idx, E.IntImm) and idx.value == 0:
                layout.append(("IntImm", placeholder.shape[d]))
            else:
                return []  # non-trivial access: not layout-free
        return layout
    return []


def get_new_layout(state: State, stage_id: int,
                   placeholder_axes: Dict[str, int]) -> List[Tuple[str, int]]:
    """[(axis name, extent)] of the rewritten placeholder in loop order
    (GetNewLayout, compute_dag.cc:822): attach-prefix iterators map to the
    stage's own axis names at the same offset."""
    stage = state.stages[stage_id]
    pieces: List[Tuple[str, int]] = []
    iters_before_attach = 0

    attach = state.attach_map.stage_to_attach_iter.get(stage_id)
    if attach is not None:
        a_sid, a_pos = attach
        a_stage = state.stages[a_sid]
        for it in a_stage.iters[: a_pos + 1]:
            pieces.extend(_leaf_components(a_stage, it))
        iters_before_attach = len(pieces)
    for it in stage.iters:
        pieces.extend(_leaf_components(stage, it))

    names = [n for n, _ in pieces]
    layout = []
    for i, (name, ext) in enumerate(pieces):
        if i < iters_before_attach:
            # the attach-target's loops correspond positionally to the
            # attached stage's own first-level iterators
            j = i + iters_before_attach
            name = names[j] if j < len(names) else name
        if name in placeholder_axes:
            layout.append((name, ext))
    return layout


def transform_array(array, orig_layout: List[Tuple[str, int]],
                    new_layout: List[Tuple[str, int]]):
    """Repack a weight array from the original to the rewritten layout:
    reshape each original dim into its tile factors, then transpose into
    loop order (one relayout copy)."""
    splits: Dict[str, List[int]] = {}
    for name, ext in new_layout:
        splits.setdefault(name, []).append(ext)
    shape, owner = [], []
    for name, ext in orig_layout:
        facs = splits.get(name, [ext])
        prod = 1
        for f in facs:
            prod *= f
        if prod != ext:
            raise ValueError(
                f"axis {name}: tile product {prod} != extent {ext}"
            )
        shape.extend(facs)
        owner.extend((name, k) for k in range(len(facs)))
    arr = np.asarray(array).reshape(shape)
    counters: Dict[str, int] = {}
    perm = []
    for name, _ in new_layout:
        k = counters.get(name, 0)
        counters[name] = k + 1
        perm.append(owner.index((name, k)))
    return arr.transpose(perm)


def rewrite_layout(dag, state_or_steps,
                   layout_free: Optional[List[str]] = None):
    """Rewrite layout-free placeholders of ``dag`` to the loop order of the
    given schedule. Returns (new_dag, {placeholder name: (orig, new)})
    where orig/new are [(axis, extent)] layout specs; placeholders whose
    tile products do not divide evenly are skipped.

    ``layout_free`` selects placeholders by name; the default is every
    placeholder read only by multi-level-tiled ops (conv weights — the
    reference's layout_free_placeholders op attribute set by topi).
    """
    from ..search.sketch import AccessAnalysis
    from .dag import ComputeDAG

    state = (dag.apply_steps(state_or_steps)
             if not isinstance(state_or_steps, State) else state_or_steps)
    state = dag.infer_bound(state)

    analysis = AccessAnalysis(dag)
    layouts: Dict[str, Tuple[list, list]] = {}
    replacements = {}  # placeholder uid -> (new_op, orig_layout, new_layout)

    for stage_id, stage in enumerate(state.stages):
        op = stage.op
        if not isinstance(op, ComputeOp):
            continue
        if not analysis.needs_multi_level_tiling.get(op.uid):
            continue
        for t in op.input_tensors():
            pop = t.op
            if not isinstance(pop, PlaceholderOp) or pop.uid in replacements:
                continue
            if layout_free is not None and pop.name not in layout_free:
                continue
            orig = get_orig_layout(op, pop)
            if not orig:
                continue
            axes = {n: e for n, e in orig if n != "IntImm"}
            new = get_new_layout(state, stage_id, axes)
            if not new:
                continue
            # tile products must reproduce the original extents exactly
            prods: Dict[str, int] = {}
            for n, e in new:
                prods[n] = prods.get(n, 1) * e
            if any(prods.get(n) != e for n, e in orig if n != "IntImm"):
                continue
            new_shape = tuple(e for _, e in new)
            new_op = PlaceholderOp(pop.name, new_shape, pop.dtype)
            replacements[pop.uid] = (new_op, orig, new, op.uid)
            layouts[pop.name] = (orig, new)

    if not replacements:
        return dag, layouts

    # rebuild the op list: swap placeholders, rewrite consumer reads
    new_ops = []
    uid_to_tensor = {}
    for op in dag.ops:
        if isinstance(op, PlaceholderOp):
            rep = replacements.get(op.uid)
            new_op = rep[0] if rep else op
            new_ops.append(new_op)
            uid_to_tensor[op.uid] = new_op.output()
            continue
        # substitute reads (of replaced placeholders and of any rebuilt
        # producer) in the body
        def walk(e):
            if isinstance(e, E.TensorRead):
                idx = tuple(walk(i) for i in e.indices)
                src_uid = e.tensor.op.uid
                rep = replacements.get(src_uid)
                if rep is not None:
                    _, orig, new, _ = rep
                    # new index per tiled dim: (axis // stride) % extent
                    axis_expr = {n: idx[d] for d, (n, _) in enumerate(orig)}
                    strides: Dict[str, int] = {}
                    new_idx = []
                    for n, ext in reversed(new):
                        s = strides.get(n, 1)
                        base = axis_expr.get(n, E.IntImm(0))
                        ie = base
                        if s > 1:
                            ie = E.FloorDiv(ie, E.IntImm(s))
                        ie = E.FloorMod(ie, E.IntImm(ext))
                        new_idx.append(ie)
                        strides[n] = s * ext
                    new_idx.reverse()
                    return E.TensorRead(uid_to_tensor[src_uid],
                                        tuple(new_idx))
                if src_uid in uid_to_tensor:
                    return E.TensorRead(uid_to_tensor[src_uid], idx)
                return E.TensorRead(e.tensor, idx)
            if isinstance(e, (E.IntImm, E.FloatImm, E.Var)):
                return e
            if isinstance(e, E._Bin):
                return type(e)(walk(e.a), walk(e.b))
            if isinstance(e, E.Cmp):
                return E.Cmp(e.op, walk(e.a), walk(e.b))
            if isinstance(e, E.And):
                return E.And(tuple(walk(p) for p in e.parts))
            if isinstance(e, E.Or):
                return E.Or(tuple(walk(p) for p in e.parts))
            if isinstance(e, E.Select):
                return E.Select(walk(e.cond), walk(e.true_value),
                                walk(e.false_value))
            if isinstance(e, E.Cast):
                return E.Cast(walk(e.value), e.dtype)
            if isinstance(e, E.Call):
                return E.Call(e.func, tuple(walk(a) for a in e.args))
            if isinstance(e, E.Reduce):
                return E.Reduce(e.combiner, walk(e.value), e.axes, e.init)
            return e

        body = walk(op.body)
        # reuse the original axis IterDims: the rewritten body still
        # references their vars (reduce axes come from the Reduce node)
        new_op = ComputeOp(op.name, op.axes, body, dtype=op.dtype,
                           tag=op.tag, attrs=op.attrs)
        new_ops.append(new_op)
        uid_to_tensor[op.uid] = new_op.output()

    return ComputeDAG([new_ops[-1].output()]), layouts
