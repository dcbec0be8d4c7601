"""Per-store 164-dim program features (counterpart of
``vae_extent_search_tpu/features/per_store.py``: its Python featuriser; the
native batch featuriser is not part of the port, so there is no
``use_native`` option here).

Parity target: src/auto_scheduler/feature.cc — for every store statement of
a lowered program, a fixed 164-float vector:

- group 1 (57): math-op counts x outer loop product, vectorize/unroll/
  parallel loop stats with one-hot position types (upstream hardcodes
  kPosMixed when present, feature.cc:764-790), is_gpu + 7 thread extents
- group 2 (5 bufs x 18): access type one-hot, bytes/unique_bytes/lines/
  unique_lines, reuse type one-hot + distances/counts and /reuse variants,
  stride — buffers sorted by (reuse_dis_bytes, unique_bytes, unique_lines,
  acc_type) taking the first 5 (feature.cc:1126-1142)
- group 3 (10): arithmetic-intensity curve samples (feature.cc:954-986)
- group 4 (4): allocation features (feature.cc:989-1001)
- group 5 (3): outer_prod, num_loops, auto_unroll_max_step

All slog-transformed (slog(x) = sign(x)*log2(|x|+1), feature.cc:1051)
except one-hots, is_gpu and the intensity curve.

Instead of lowering through TIR, we reconstruct each store's realized loop
nest and globalized index expressions directly from the bound-inferred
loop state: leaf loop vars, PassUpIndex-style reconstruction through the
split/fuse relation log (split: parent = outer*factor + inner; fuse:
outer = fused // inner_ext, inner = fused % inner_ext), attach-offset
composition for compute_at stages, and inline substitution for inlined
producers. Interval arithmetic over these expressions reproduces the
progressive-binding touched-region analysis (feature.cc:812-853).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ir import expr as E
from ..ir.state import (
    ANNOTATION_BLOCK_X,
    ANNOTATION_BLOCK_Y,
    ANNOTATION_BLOCK_Z,
    ANNOTATION_PARALLEL,
    ANNOTATION_THREAD_X,
    ANNOTATION_THREAD_Y,
    ANNOTATION_THREAD_Z,
    ANNOTATION_UNROLL,
    ANNOTATION_VECTORIZE,
    ANNOTATION_VTHREAD,
    AT_INLINED,
    AT_ROOT,
    State,
)
from ..ir.tensor import ComputeOp, PlaceholderOp

FEATURE_VEC_LEN = 164
DEFAULT_MAX_N_BUFS = 5
CURVE_SAMPLES = 10

# access types (feature.cc BufferAccessType)
ACC_READ, ACC_WRITE, ACC_READ_WRITE = 0, 1, 2
# reuse types (feature.cc ReuseType)
REUSE_LOOP_MULTI_READ, REUSE_SERIAL_RW, REUSE_NONE = 0, 1, 2

_THREAD_ANN = {
    ANNOTATION_BLOCK_X: "blockIdx.x",
    ANNOTATION_BLOCK_Y: "blockIdx.y",
    ANNOTATION_BLOCK_Z: "blockIdx.z",
    ANNOTATION_THREAD_X: "threadIdx.x",
    ANNOTATION_THREAD_Y: "threadIdx.y",
    ANNOTATION_THREAD_Z: "threadIdx.z",
    ANNOTATION_VTHREAD: "vthread",
}


def slog(x: float) -> float:
    return math.copysign(math.log2(abs(x) + 1.0), x)


@dataclass
class LoopInfo:
    var: E.Var
    extent: int
    annotation: int
    is_thread: bool = False


@dataclass
class StoreInfo:
    """One store statement: its loop nest and globalized expressions."""

    stage_id: int
    op: ComputeOp
    loop_stack: List[LoopInfo]  # outermost -> innermost (non-trivial only)
    store_indices: List[E.Expr]  # global dim exprs of the written buffer
    value: E.Expr  # RHS with globalized + inlined reads
    auto_unroll_max_step: int
    alloc_extents: List[int]  # realized buffer bounds
    dtype_bytes: int = 4


def _reconstruct_dim_exprs(stage, zero_inner_after: Optional[int] = None):
    """axis IterDim -> expr over the stage's leaf loop vars (PassUpIndex).

    When ``zero_inner_after`` is given, leaves at positions > that index
    are replaced by 0 (used to compute attach offsets = region minimum).
    """
    exprs: Dict[int, E.Expr] = {}
    leaf_vars: Dict[int, E.Var] = {}
    ext_map: Dict[int, int] = {}
    for pos, it in enumerate(stage.iters):
        v = E.Var(it.name)
        leaf_vars[it.uid] = v
        ext = it.range[1] if it.range is not None else 1
        if not isinstance(ext, int):
            ext = 1  # data-dependent extents: GetLoopExtent convention
        ext_map[it.uid] = ext
        if zero_inner_after is not None and pos > zero_inner_after:
            exprs[it.uid] = E.IntImm(0)
        elif ext == 1:
            exprs[it.uid] = E.IntImm(0)  # trivial loops are simplified out
        else:
            exprs[it.uid] = v

    # full extents of intermediate nodes via forward pass (for fuse strides)
    full: Dict[int, int] = dict(ext_map)
    for uid, dim in stage.root_of.items():
        if isinstance(dim.extent, int):
            full.setdefault(uid, dim.extent)
        else:
            full.setdefault(uid, 1)
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

    # backward pass: derive parents from children
    for rel in reversed(stage.relations):
        if rel.kind == "split":
            o = exprs.get(rel.outer)
            i = exprs.get(rel.inner)
            if o is None or i is None:
                continue
            if not rel.by_nparts:
                stride = rel.factor or full.get(rel.inner, 1)
            else:
                stride = full.get(rel.inner, 1)
            exprs[rel.parent] = _simp_add(_simp_mul(o, stride), i)
        else:
            f = exprs.get(rel.fused)
            if f is None:
                continue
            if rel.inner is None:
                exprs[rel.outer] = f
                continue
            i_ext = full.get(rel.inner, 1)
            if i_ext == 1:
                exprs[rel.outer] = f
                exprs[rel.inner] = E.IntImm(0)
            else:
                exprs[rel.outer] = E.FloorDiv(f, E.IntImm(i_ext))
                exprs[rel.inner] = E.FloorMod(f, E.IntImm(i_ext))

    dim_exprs = {}
    for uid, dim in stage.root_of.items():
        dim_exprs[id(dim)] = exprs.get(uid, E.IntImm(0))
    return dim_exprs, leaf_vars


def _simp_mul(e: E.Expr, c: int) -> E.Expr:
    if c == 1:
        return e
    if isinstance(e, E.IntImm):
        return E.IntImm(e.value * c)
    return E.Mul(e, E.IntImm(c))


def _simp_add(a: E.Expr, b: E.Expr) -> E.Expr:
    if isinstance(a, E.IntImm) and a.value == 0:
        return b
    if isinstance(b, E.IntImm) and b.value == 0:
        return a
    if isinstance(a, E.IntImm) and isinstance(b, E.IntImm):
        return E.IntImm(a.value + b.value)
    return E.Add(a, b)


def _globalize_body(state: State, stage_id: int, dim_exprs) -> E.Expr:
    """The store RHS: stage op's body with axis vars -> global dim exprs,
    reduce axis vars kept as loop vars, inlined producer bodies
    substituted, and the reduction rewritten as an update read-add."""
    stage = state.stages[stage_id]
    op = stage.op
    inner = op.inner_expr()

    # substitution for this op's own vars (spatial AND reduce dims: both
    # reconstruct from the stage's realized loop vars)
    sub = {}
    for d in list(op.axes) + list(op.reduce_axes):
        if id(d) in dim_exprs:
            sub[d.var] = dim_exprs[id(d)]
    body = E.substitute(inner, sub)
    body = _inline_reads(state, body)

    if isinstance(op.body, E.Reduce):
        own_read = E.TensorRead(
            op.output(), tuple(dim_exprs[id(d)] for d in op.axes)
        )
        comb = op.body.combiner
        if comb == "sum":
            body = E.Add(own_read, body)
        elif comb == "max":
            body = E.Max(own_read, body)
        elif comb == "min":
            body = E.Min(own_read, body)
    return body


def _inline_reads(state: State, body: E.Expr) -> E.Expr:
    """Substitute reads of inlined stages with their (globalized) bodies."""
    inlined = {}
    for s in state.stages:
        if s.compute_at == AT_INLINED and isinstance(s.op, ComputeOp):
            inlined[s.op.uid] = s.op

    def walk(e: E.Expr) -> E.Expr:
        if isinstance(e, E.TensorRead):
            idx = tuple(walk(i) for i in e.indices)
            op = inlined.get(e.tensor.op.uid)
            if op is not None:
                sub = {d.var: idx[k] for k, d in enumerate(op.axes)}
                return walk(E.substitute(op.inner_expr(), sub))
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
        return e

    return walk(body)


def build_store_infos(state: State, is_gpu: bool = False) -> List[StoreInfo]:
    """Walk the state in print order building one StoreInfo per non-inlined
    compute stage (== one store statement in the lowered program; the
    reduction init store is subsumed by last-write-wins,
    feature.cc:832-834)."""
    infos: List[StoreInfo] = []

    def visit(stage_id: int, outer_loops: List[LoopInfo],
              attach_offsets: Dict[int, E.Expr]):
        stage = state.stages[stage_id]
        op = stage.op
        # build this stage's dim exprs (+ attach offsets)
        dim_exprs, leaf_vars = _reconstruct_dim_exprs(stage)
        if attach_offsets:
            for d_id, off in attach_offsets.items():
                if d_id in dim_exprs:
                    dim_exprs[d_id] = _simp_add(off, dim_exprs[d_id])

        # the stage's own loops (non-trivial), in iter order; collect the
        # loop infos for positions and recurse into attachments
        own_loops: List[LoopInfo] = []
        for pos, it in enumerate(stage.iters):
            ext = it.range[1] if it.range is not None else 1
            if not isinstance(ext, int):
                # data-dependent extent: GetLoopExtent returns 1 for
                # non-const loop extents (reference feature.cc)
                ext = 1
            if ext != 1:
                li = LoopInfo(leaf_vars[it.uid], ext, it.annotation,
                              is_thread=it.annotation in _THREAD_ANN)
                own_loops.append(li)
            attached = state.attach_map.iter_to_attached_stages.get(
                (stage_id, pos)
            )
            if attached:
                for a_sid in attached:
                    a_stage = state.stages[a_sid]
                    offsets = _attach_offsets(
                        state, stage_id, pos, a_stage, dim_exprs, leaf_vars
                    )
                    visit(a_sid, outer_loops + own_loops[:],
                          offsets)

        loop_stack = outer_loops + own_loops
        # store indices: global exprs of the spatial dims
        store_idx = [dim_exprs[id(d)] for d in op.axes]
        body = _globalize_body(state, stage_id, dim_exprs)
        # realized allocation bounds: the stage's root extents
        alloc = []
        for d in op.axes:
            e = _dim_realized_extent(stage, d)
            alloc.append(e)
        infos.append(
            StoreInfo(
                stage_id, op, loop_stack, store_idx, body,
                stage.attrs.auto_unroll_max_step, alloc,
                dtype_bytes=_dtype_bytes(op.dtype),
            )
        )

    for sid, stage in enumerate(state.stages):
        if stage.op_type == "placeholder" or stage.compute_at != AT_ROOT:
            continue
        visit(sid, [], {})
    return infos


def _dtype_bytes(dtype: str) -> int:
    if dtype.endswith("64"):
        return 8
    if dtype.endswith("16"):
        return 2
    if dtype.endswith("8"):
        return 1
    return 4


def _dim_realized_extent(stage, dim) -> int:
    """Realized extent of an output dim = what pass-down saw as its root
    extent: recover from the leaf extents through the relation tree by
    taking the product of the dim's leaf extents."""
    # collect leaves deriving from this dim
    derived = {None}
    # map root uid for dim
    root_uid = None
    for uid, d in stage.root_of.items():
        if d is dim:
            root_uid = uid
            break
    if root_uid is None:
        return dim.extent
    frontier = {root_uid}
    for rel in stage.relations:
        if rel.kind == "split" and rel.parent in frontier:
            frontier.discard(rel.parent)
            frontier.add(rel.outer)
            frontier.add(rel.inner)
        elif rel.kind == "fuse" and (
            rel.outer in frontier
            or (rel.inner is not None and rel.inner in frontier)
        ):
            # fused with another dim; fall back to the full extent
            return dim.extent
    ext = 1
    leaf_ext = {it.uid: (it.range[1] if it.range else 1)
                for it in stage.iters}
    for uid in frontier:
        ext *= leaf_ext.get(uid, 1)
    return min(ext, dim.extent) if ext > 0 else dim.extent


def _attach_offsets(state: State, t_sid: int, pos: int, a_stage,
                    t_dim_exprs, t_leaf_vars):
    """Offsets of an attached stage's output dims: the consumer's access
    index with inner loop vars (positions > pos) zeroed — the region
    minimum as an expression of the outer loop vars."""
    t_stage = state.stages[t_sid]
    # consumer dim exprs with inner leaves zeroed (region minimum),
    # expressed on the consumer's own loop vars
    dim_min = _dims_min_on_vars(t_stage, pos, t_leaf_vars)

    if not isinstance(t_stage.op, ComputeOp) or not isinstance(
        a_stage.op, ComputeOp
    ):
        return {}
    # find the consumer's read of the attached op (through inlines)
    sub = {d.var: dim_min[id(d)] for d in t_stage.op.axes}
    body = E.substitute(t_stage.op.inner_expr(), sub)
    body = _inline_reads(state, body)
    reads = [
        r for r in E.collect_reads(body)
        if r.tensor.op.uid == a_stage.op.uid
    ]
    if not reads:
        return {}
    read = reads[0]
    offsets = {}
    for d, dim in enumerate(a_stage.op.axes):
        if d < len(read.indices):
            offsets[id(dim)] = read.indices[d]
    return offsets


def _dims_min_on_vars(stage, pos: int, leaf_vars: Dict[int, E.Var]):
    """Like _reconstruct_dim_exprs(zero_inner_after=pos) but expressed on
    the provided leaf vars (so offsets share the consumer's loop vars)."""
    exprs: Dict[int, E.Expr] = {}
    full: Dict[int, int] = {}
    for p, it in enumerate(stage.iters):
        ext = it.range[1] if it.range is not None else 1
        full[it.uid] = ext
        if p > pos or ext == 1:
            exprs[it.uid] = E.IntImm(0)
        else:
            exprs[it.uid] = leaf_vars[it.uid]
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
    for rel in reversed(stage.relations):
        if rel.kind == "split":
            o, i = exprs.get(rel.outer), exprs.get(rel.inner)
            if o is None or i is None:
                continue
            stride = (rel.factor if not rel.by_nparts else
                      full.get(rel.inner, 1)) or full.get(rel.inner, 1)
            exprs[rel.parent] = _simp_add(_simp_mul(o, stride), i)
        else:
            f = exprs.get(rel.fused)
            if f is None:
                continue
            if rel.inner is None:
                exprs[rel.outer] = f
                continue
            i_ext = full.get(rel.inner, 1)
            if i_ext == 1:
                exprs[rel.outer] = f
                exprs[rel.inner] = E.IntImm(0)
            else:
                exprs[rel.outer] = E.FloorDiv(f, E.IntImm(i_ext))
                exprs[rel.inner] = E.FloorMod(f, E.IntImm(i_ext))
    return {
        id(dim): exprs.get(uid, E.IntImm(0))
        for uid, dim in stage.root_of.items()
    }


# ---------------------------------------------------------------------------
# Feature computation over StoreInfos (mirrors feature.cc:727-1010)
# ---------------------------------------------------------------------------


def _collect_accesses(info: StoreInfo):
    """{buffer op uid: (tensor, acc_type, [index tuples])} — write first,
    then reads (BufferAccessExtractor semantics: same-buffer read+write ->
    kReadWrite)."""
    accesses: Dict[int, list] = {}
    order: List[int] = []

    own = info.op.output()
    accesses[own.op.uid] = [own, ACC_WRITE, [tuple(info.store_indices)]]
    order.append(own.op.uid)

    for r in E.collect_reads(info.value):
        uid = r.tensor.op.uid
        ent = accesses.get(uid)
        if ent is None:
            accesses[uid] = [r.tensor, ACC_READ, [tuple(r.indices)]]
            order.append(uid)
        else:
            if ent[1] == ACC_WRITE:
                ent[1] = ACC_READ_WRITE
            ent[2].append(tuple(r.indices))
    return [(accesses[u][0], accesses[u][1], accesses[u][2]) for u in order]


def _region_extents(index_tuples, env) -> List[int]:
    """ComputeRegion (feature.cc:469-496): per-dim union interval width."""
    if not index_tuples:
        return []
    ndim = len(index_tuples[0])
    out = []
    for d in range(ndim):
        lo, hi = None, None
        for idx in index_tuples:
            iv = E.eval_interval(idx[d], env)
            lo = iv.lo if lo is None else min(lo, iv.lo)
            hi = iv.hi if hi is None else max(hi, iv.hi)
        out.append(max(1, hi - lo + 1))
    return out


def _coefficient_of(expr: E.Expr, var: E.Var):
    """(coefficient, var_present) for the first-order coefficient of var
    (CoefficientExtractor semantics, feature.cc:387-442: returns 2 when the
    pattern is not a simple multiplication)."""
    if isinstance(expr, E.Var):
        return (1, True) if expr is var else (None, False)
    if isinstance(expr, E.Mul):
        a, b = expr.a, expr.b
        if isinstance(a, E.Var) and a is var and isinstance(b, E.IntImm):
            return (b.value, True)
        if isinstance(b, E.Var) and b is var and isinstance(a, E.IntImm):
            return (a.value, True)
        ca, fa = _coefficient_of(a, var)
        if fa:
            return (2 if ca is None else ca, True)
        cb, fb = _coefficient_of(b, var)
        if fb:
            return (2 if cb is None else cb, True)
        return (None, False)
    if isinstance(expr, (E.Add, E.Sub)):
        ca, fa = _coefficient_of(expr.a, var)
        if fa:
            return (1 if ca is None else ca, True)
        cb, fb = _coefficient_of(expr.b, var)
        if fb:
            return (1 if cb is None else cb, True)
        return (None, False)
    if isinstance(expr, (E.FloorDiv, E.FloorMod, E.Select, E.Min, E.Max,
                         E.Cast)):
        if var in E.collect_vars(expr):
            return (2, True)  # unknown pattern -> default stride 2
        return (None, False)
    if var in E.collect_vars(expr):
        return (2, True)
    return (None, False)


def _compute_stride(index_tuples, shape, var: E.Var) -> int:
    """ComputeStride (feature.cc:445-465): min over accesses of
    |coefficient| * shape-stride of the innermost dim containing the var."""
    min_stride = None
    for idx in index_tuples:
        shape_stride = 1
        for d in range(len(idx) - 1, -1, -1):
            coeff, present = _coefficient_of(idx[d], var)
            if present:
                s = abs(coeff) * shape_stride
                min_stride = s if min_stride is None else min(min_stride, s)
                break
            shape_stride *= shape[d] if d < len(shape) else 1
    return min_stride if min_stride is not None else 0


def _compute_reuse(buf_uid, index_tuples, loop_stack, touch_regions):
    """ComputeReuse (feature.cc:500-605)."""
    reuse_dis_iter = 1.0
    reuse_dis_bytes = -1.0
    reuse_ct = 1.0
    scan_status = 0

    for i in range(len(loop_stack) - 1, -1, -1):
        li = loop_stack[i]
        extent = li.extent
        find = any(
            li.var in E.collect_vars(e)
            for idxs in index_tuples
            for idx in idxs
            for e in idx
        )
        if scan_status == 0:
            if find:
                reuse_dis_iter *= extent
                reuse_dis_bytes = 0.0
                for _, accs in touch_regions[i].items():
                    for (_, touched, ebytes) in accs:
                        reuse_dis_bytes += touched * ebytes
            else:
                if reuse_dis_bytes < 0:
                    reuse_dis_bytes = 0.0
                    for _, accs in touch_regions[i].items():
                        for (_, touched, ebytes) in accs:
                            reuse_dis_bytes += 1 * ebytes
                scan_status = 1
                reuse_ct *= extent
        elif scan_status == 1:
            if find:
                return (REUSE_LOOP_MULTI_READ, reuse_dis_iter,
                        reuse_dis_bytes, reuse_ct)
            else:
                reuse_ct *= extent

        accs_here = touch_regions[i].get(buf_uid, [])
        serial_reuse = len(accs_here) - 1
        if serial_reuse > 0:
            cur_extent = extent
            rdi = min(float(t) for (_, t, _) in accs_here)
            rdb = 0.0
            for _, accs in touch_regions[i].items():
                for (at, touched, ebytes) in accs:
                    if at == ACC_READ:
                        rdb += touched * ebytes
            rct = 1.0
            for j in range(i, -1, -1):
                rct *= loop_stack[j].extent
            return (REUSE_SERIAL_RW, rdi / cur_extent, rdb / cur_extent, rct)

    if scan_status == 0:
        return (REUSE_NONE, 0.0, 0.0, 0.0)
    return (REUSE_LOOP_MULTI_READ, reuse_dis_iter, reuse_dis_bytes, reuse_ct)


def _count_ops_with_indices(value: E.Expr) -> Dict[str, float]:
    """MathOpCounter over the store RHS including index arithmetic
    (feature.cc:251-330: TensorRead index expressions contribute int ops)."""
    return E.count_math_ops(value)


def extract_store_features(info: StoreInfo, is_gpu: bool,
                           cache_line_size: int = 64,
                           max_n_bufs: int = DEFAULT_MAX_N_BUFS) -> List[float]:
    loop_stack = info.loop_stack
    outer_prod = 1.0
    for li in loop_stack:
        outer_prod *= li.extent

    counts = _count_ops_with_indices(info.value)
    fea: List[float] = []

    # ----- group 1 -----
    fea.append(slog(0.0))  # float_mad (upstream never fills it)
    fea.append(slog(outer_prod * counts["float_add_sub"]))
    fea.append(slog(outer_prod * counts["float_mul"]))
    fea.append(slog(outer_prod * counts["float_div_mod"]))
    fea.append(slog(outer_prod * counts["float_cmp"]))
    fea.append(slog(outer_prod * counts["float_math"]))
    fea.append(slog(0.0))  # float_other_func
    fea.append(slog(0.0))  # int_mad
    fea.append(slog(outer_prod * counts["int_add_sub"]))
    fea.append(slog(outer_prod * counts["int_mul"]))
    fea.append(slog(outer_prod * counts["int_div_mod"]))
    fea.append(slog(outer_prod * counts["int_cmp"]))
    fea.append(slog(outer_prod * counts["int_math"]))
    fea.append(slog(0.0))  # int_other_func
    fea.append(slog(outer_prod * counts["bool_op"]))
    fea.append(slog(outer_prod * counts["select_op"]))

    POS_NONE_ONEHOT = [1.0] + [0.0] * 7
    POS_MIXED_ONEHOT = [0.0] * 7 + [1.0]

    for ann in (ANNOTATION_VECTORIZE, ANNOTATION_UNROLL, ANNOTATION_PARALLEL):
        anns = [li for li in loop_stack if li.annotation == ann]
        num = float(len(anns))
        if anns:
            length = float(anns[-1].extent)
            prod = 1.0
            for li in anns:
                prod *= li.extent
            fea.extend([slog(num), slog(prod), slog(length)])
            fea.extend(POS_MIXED_ONEHOT)
        else:
            fea.extend([slog(0.0), slog(0.0), slog(0.0)])
            fea.extend(POS_NONE_ONEHOT)

    thread_lens = {name: 1.0 for name in
                   ("blockIdx.x", "blockIdx.y", "blockIdx.z", "threadIdx.x",
                    "threadIdx.y", "threadIdx.z", "vthread")}
    for li in loop_stack:
        name = _THREAD_ANN.get(li.annotation)
        if name == "vthread":
            thread_lens["vthread"] *= li.extent
        elif name is not None:
            thread_lens[name] = float(li.extent)
    fea.append(1.0 if is_gpu else 0.0)
    for name in ("blockIdx.x", "blockIdx.y", "blockIdx.z", "threadIdx.x",
                 "threadIdx.y", "threadIdx.z", "vthread"):
        fea.append(slog(thread_lens[name]))

    # ----- group 2 prep: progressive-binding touched regions -----
    accesses = _collect_accesses(info)
    # env: all loop vars pinned to [0,0] initially; bind one at a time
    env: Dict[E.Var, E.Interval] = {}
    touch_regions: List[Dict[int, list]] = [dict() for _ in loop_stack]
    mem_bytes_list: List[float] = []
    compute_ops_list: List[float] = []
    cur_compute_ops = (
        counts["float_add_sub"] + counts["float_mul"]
        + counts["float_div_mod"] + counts["float_cmp"]
        + counts["float_math"]
    )
    for i in range(len(loop_stack) - 1, -1, -1):
        li = loop_stack[i]
        env[li.var] = E.Interval(0, li.extent - 1)
        mem_bytes = 0.0
        for tensor, acc_type, idxs in accesses:
            region = _region_extents(idxs, env)
            touched = 1
            for r in region:
                touched *= r
            ebytes = _dtype_bytes(tensor.dtype)
            touch_regions[i].setdefault(tensor.op.uid, []).append(
                (acc_type, touched, ebytes)
            )
            mem_bytes += touched * ebytes
        mem_bytes_list.append(math.log2(max(mem_bytes, 1e-10)))
        cur_compute_ops *= li.extent
        compute_ops_list.append(math.log2(max(cur_compute_ops, 1e-10)))

    # ----- group 2: per-buffer features -----
    buf_feats = []
    for tensor, acc_type, idxs in accesses:
        ebytes = _dtype_bytes(tensor.dtype)
        shape = list(tensor.shape)
        if not loop_stack:
            unique_bytes, stride, lines, unique_lines = float(ebytes), 0, 1.0, 1.0
        else:
            first = touch_regions[0][tensor.op.uid][0]
            unique_bytes = first[1] * ebytes
            stride = 0
            reduce_ratio = 1.0
            i = len(loop_stack) - 1
            while i >= 0:
                stride = _compute_stride(idxs, shape, loop_stack[i].var)
                if stride != 0:
                    break
                reduce_ratio *= loop_stack[-1].extent  # upstream quirk
                i -= 1
            lines = max(
                outer_prod / reduce_ratio
                * min(1.0, stride * ebytes / cache_line_size), 1.0,
            )
            stride = stride if i == len(loop_stack) - 1 else 0
            # n_continuous: trailing dims fully touched at the innermost
            # binding level
            inner_region = _region_extents(
                idxs, {loop_stack[-1].var: E.Interval(
                    0, loop_stack[-1].extent - 1)}
            )
            n_continuous = float(ebytes)
            for d in range(min(len(inner_region), len(shape)) - 1, -1, -1):
                if inner_region[d] == shape[d]:
                    n_continuous *= inner_region[d]
                    break
            unique_lines = max(
                unique_bytes / min(n_continuous, float(cache_line_size)), 1.0
            )

        reuse_type, rdi, rdb, rct = _compute_reuse(
            tensor.op.uid, [idxs], loop_stack, touch_regions
        )
        bytes_total = outer_prod * ebytes
        if rct > 0.5:
            d_bytes, d_unique = bytes_total / rct, unique_bytes / rct
            d_lines, d_ulines = lines / rct, unique_lines / rct
        else:
            d_bytes, d_unique = bytes_total * 2, unique_bytes * 2
            d_lines, d_ulines = lines * 2, unique_lines * 2
        buf_feats.append({
            "acc_type": acc_type, "bytes": bytes_total,
            "unique_bytes": unique_bytes, "lines": lines,
            "unique_lines": unique_lines, "reuse_type": reuse_type,
            "reuse_dis_iter": rdi, "reuse_dis_bytes": rdb, "reuse_ct": rct,
            "bytes_d": d_bytes, "unique_bytes_d": d_unique,
            "lines_d": d_lines, "unique_lines_d": d_ulines,
            "stride": float(stride),
        })

    # sort by (reuse_dis_bytes, unique_bytes, unique_lines, acc_type)
    order = sorted(
        range(len(buf_feats)),
        key=lambda k: (
            buf_feats[k]["reuse_dis_bytes"], buf_feats[k]["unique_bytes"],
            buf_feats[k]["unique_lines"], float(buf_feats[k]["acc_type"]),
        ),
    )[:max_n_bufs]
    for k in order:
        bf = buf_feats[k]
        for j in range(3):
            fea.append(1.0 if j == bf["acc_type"] else 0.0)
        fea.append(slog(bf["bytes"]))
        fea.append(slog(bf["unique_bytes"]))
        fea.append(slog(bf["lines"]))
        fea.append(slog(bf["unique_lines"]))
        for j in range(3):
            fea.append(1.0 if j == bf["reuse_type"] else 0.0)
        fea.append(slog(bf["reuse_dis_iter"]))
        fea.append(slog(bf["reuse_dis_bytes"]))
        fea.append(slog(bf["reuse_ct"]))
        fea.append(slog(bf["bytes_d"]))
        fea.append(slog(bf["unique_bytes_d"]))
        fea.append(slog(bf["lines_d"]))
        fea.append(slog(bf["unique_lines_d"]))
        fea.append(slog(bf["stride"]))
    for _ in range(max_n_bufs - len(order)):
        fea.extend([0.0] * 18)

    # ----- group 3: arithmetic-intensity curve -----
    if cur_compute_ops <= 0 or not compute_ops_list:
        fea.extend([0.0] * CURVE_SAMPLES)
    else:
        pt = 0
        for i in range(CURVE_SAMPLES):
            target = compute_ops_list[-1] * (i + 1) / CURVE_SAMPLES
            while compute_ops_list[pt] < target - 1e-4:
                pt += 1
            if pt == 0:
                value = compute_ops_list[0] / mem_bytes_list[0]
            else:
                base = compute_ops_list[pt - 1] / mem_bytes_list[pt - 1]
                slope = (
                    compute_ops_list[pt] / mem_bytes_list[pt]
                    - compute_ops_list[pt - 1] / mem_bytes_list[pt - 1]
                ) / (compute_ops_list[pt] - compute_ops_list[pt - 1])
                value = base + slope * (target - compute_ops_list[pt - 1])
            fea.append(value)

    # ----- group 4: allocation -----
    alloc_size = float(info.dtype_bytes)
    for e in info.alloc_extents:
        alloc_size *= e
    alloc_elems = alloc_size / info.dtype_bytes
    fea.append(slog(alloc_size))
    fea.append(slog(alloc_elems * outer_prod))  # alloc_prod
    fea.append(slog(outer_prod))  # alloc_outer_prod
    fea.append(slog(1.0))  # alloc_inner_prod (outer_prod/outer_prod)

    # ----- group 5: outer scope -----
    fea.append(slog(outer_prod))
    fea.append(slog(float(len(loop_stack))))
    fea.append(slog(float(info.auto_unroll_max_step)))

    assert len(fea) == FEATURE_VEC_LEN, len(fea)
    return fea


def get_per_store_features_from_state(state: State, task,
                                      max_n_bufs: int = DEFAULT_MAX_N_BUFS
                                      ) -> np.ndarray:
    """[n_stores, 164] float32 for one bound-inferred state."""
    is_gpu = task.is_gpu
    cache_line = task.hardware_params.cache_line_bytes
    infos = build_store_infos(state, is_gpu)
    rows = [
        extract_store_features(info, is_gpu, cache_line, max_n_bufs)
        for info in infos
    ]
    if not rows:
        return np.zeros((0, FEATURE_VEC_LEN), np.float32)
    return np.asarray(rows, np.float32)


def get_per_store_features_from_states(states, task,
                                       max_n_bufs: int = DEFAULT_MAX_N_BUFS):
    """List of [n_stores_i, 164] arrays; unlowerable states yield a single
    all-zero row (feature.cc:1365-1367 error convention)."""
    out = []
    for st in states:
        try:
            # always re-infer: search states can be partially bound (a
            # compute_at resets the moved stage's ranges) and the
            # reference always re-lowers from steps (feature.cc:1336)
            st = task.compute_dag.infer_bound(st)
            feats = get_per_store_features_from_state(st, task, max_n_bufs)
            if feats.shape[0] == 0:
                feats = np.zeros((1, FEATURE_VEC_LEN), np.float32)
            out.append(feats)
        except Exception:
            out.append(np.zeros((1, FEATURE_VEC_LEN), np.float32))
    return out


def get_per_store_features_from_measure_pairs(inputs, results,
                                              skip_first_n_feature=0,
                                              max_n_bufs=DEFAULT_MAX_N_BUFS):
    """(features, normalized_throughputs, task_ids, min_costs): throughput
    normalized per task, min_cost / cost (feature.cc:1457-1535). A record
    that does not replay or lower yields a single all-zero row."""
    features = []
    throughputs = []
    task_ids = []
    task_keys = {}
    min_costs = []

    for inp, res in zip(inputs, results):
        key = (inp.task.workload_key, inp.task.target)
        if key not in task_keys:
            task_keys[key] = len(task_keys)
            min_costs.append(float("inf"))
        tid = task_keys[key]
        cost = res.mean_cost if res.error_no == 0 else float("inf")
        if cost < min_costs[tid]:
            min_costs[tid] = cost
        task_ids.append(tid)
        try:
            st = inp.recover_state(infer_bound=True)
            feats = get_per_store_features_from_state(
                st, inp.task, max_n_bufs
            )
        except Exception:
            feats = np.zeros((1, FEATURE_VEC_LEN), np.float32)
        features.append(feats)
        throughputs.append(cost)

    throughputs = np.asarray(
        [
            (min_costs[tid] / c) if np.isfinite(c) and c > 0 else 0.0
            for tid, c in zip(task_ids, throughputs)
        ],
        np.float32,
    )
    return (features, throughputs, np.asarray(task_ids, np.int32),
            np.asarray(min_costs, np.float32))


def get_per_store_features_from_file(filename, max_lines=None,
                                     max_n_bufs=DEFAULT_MAX_N_BUFS):
    """:func:`get_per_store_features_from_measure_pairs` over the records
    of a log (NDJSON, or gzip-compressed as ``*.gz``)."""
    from ..records.serde import load_records

    records = load_records(filename, max_lines)
    inputs = [r.inp for r in records]
    results = [r.res for r in records]
    return get_per_store_features_from_measure_pairs(
        inputs, results, max_n_bufs=max_n_bufs
    )


def perstore_features_from_records(records, max_cost: float = 1e6,
                                   length_mode: str = "modal"):
    """Per-store (164-dim) feature matrix for the offline search loop.

    The reference's design lineage ablates the VAE/regression input
    between printed-extent vectors and the full per-store feature rows
    (pre_experiments/model_myself/regression_mlp_feature.ipynb,
    vae_reg_feature_ansor*.ipynb, "feature" input mode); this is that
    input pipeline with extent_features_from_records' exact filtering
    and label conventions (error_no != 0 and costs[0] > max_cost rows
    dropped, label = -log(mean cost + 1e-8)).

    Each record's [n_stores, 164] block is flattened row-major; ragged
    store counts are resolved per ``length_mode`` ("modal" keeps the
    most common count like the extent pipeline, "pad" zero-pads to the
    max). Returns (features [n, S*164] float32, labels [n], kept
    indices into ``records``).
    """
    from .extent import label_from_costs

    kept0, labels0 = [], []
    for i, rec in enumerate(records):
        if rec.res.error_no != 0 or not rec.res.costs:
            continue
        if rec.res.costs[0] > max_cost:
            continue
        kept0.append(i)
        labels0.append(label_from_costs(rec.res.costs))
    if not kept0:
        return (np.zeros((0, 0), np.float32), np.zeros((0,), np.float32),
                [])

    blocks = []
    for i in kept0:
        inp = records[i].inp
        st = inp.recover_state(infer_bound=True)
        blocks.append(np.asarray(
            get_per_store_features_from_state(st, inp.task), np.float32))

    counts = [b.shape[0] for b in blocks]
    if length_mode == "modal":
        from collections import Counter

        modal = Counter(counts).most_common(1)[0][0]
        sel = [j for j, c in enumerate(counts) if c == modal]
        feats = np.stack([blocks[j].reshape(-1) for j in sel])
        labs = np.asarray([labels0[j] for j in sel], np.float32)
        kept = [kept0[j] for j in sel]
        return feats, labs, kept
    elif length_mode == "pad":
        smax = max(counts)
        d = smax * blocks[0].shape[1]
        feats = np.zeros((len(blocks), d), np.float32)
        for j, b in enumerate(blocks):
            feats[j, : b.size] = b.reshape(-1)
        return feats, np.asarray(labels0, np.float32), kept0
    raise ValueError(f"unknown length_mode {length_mode}")
