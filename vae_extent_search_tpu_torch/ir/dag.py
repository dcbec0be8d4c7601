"""ComputeDAG: the workload's op graph + schedule replay utilities.

Mirrors the capability surface of the reference's ComputeDAG
(src/auto_scheduler/compute_dag.cc): init state construction, FLOP
estimation (:549), step replay (ApplySteps :1157), structural DAG rewrite
for cache_read / cache_write / rfactor (ReplayAndGetDAG :1379), and bound
inference (InferBound :1302, implemented in ``bound.py`` as demand
propagation rather than TVM's te::InferBound).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from . import expr as E
from .tensor import (
    ComputeOp,
    IterDim,
    Op,
    PlaceholderOp,
    Tensor,
    estimate_flops,
    topo_sort_ops,
)
from .state import Stage, State


def _retarget_reads(body: E.Expr, mapping: dict) -> E.Expr:
    """Rewrite TensorRead(old op uid) -> TensorRead(new tensor) in a body.

    ``mapping`` is {old_op_uid: new Tensor}.
    """

    def walk(e: E.Expr) -> E.Expr:
        if isinstance(e, E.TensorRead):
            idx = tuple(walk(i) for i in e.indices)
            new_t = mapping.get(e.tensor.op.uid)
            if new_t is not None:
                return E.TensorRead(new_t, idx)
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
            return E.Select(walk(e.cond), walk(e.true_value), walk(e.false_value))
        if isinstance(e, E.Cast):
            return E.Cast(walk(e.value), e.dtype)
        if isinstance(e, E.Call):
            return E.Call(e.func, tuple(walk(a) for a in e.args))
        if isinstance(e, E.Reduce):
            return E.Reduce(e.combiner, walk(e.value), e.axes, e.init)
        raise ValueError(f"cannot retarget {type(e).__name__}")

    return walk(body)


def _clone_spatial_axes(op: ComputeOp, suffix: str = ""):
    """Fresh IterDims matching op's spatial axes (optionally renamed)."""
    return [IterDim(d.name + suffix, d.extent, "spatial") for d in op.axes]


class ComputeDAG:
    def __init__(self, tensors: Sequence[Tensor]):
        self.tensors = list(tensors)
        self.ops: List[Op] = topo_sort_ops(self.tensors)
        self.flop_ct = estimate_flops(self.ops)

    @property
    def init_state(self) -> State:
        st = State([Stage(op) for op in self.ops], dag=self)
        return st

    # ------------------------------------------------------------------
    # Structural rewrites (reference ReplayAndGetDAG, compute_dag.cc:1379;
    # te::Schedule::cache_read / cache_write / rfactor semantics)
    # ------------------------------------------------------------------

    def replay_and_get_ops(self, modifiable_steps) -> List[Op]:
        """Apply stage-modifiable steps to the original op list, returning
        the rewritten op list (consumers retargeted to cache tensors)."""
        from . import steps as ST

        mods = list(modifiable_steps)
        ops = list(self.ops)
        i = 0
        while i < len(mods):
            step = mods[i]
            if isinstance(step, ST.CacheReadStep):
                ops = _apply_cache_read(ops, step)
                i += 1
            elif isinstance(step, ST.CacheWriteStep):
                ops = _apply_cache_write(ops, step)
                i += 1
            elif isinstance(step, (ST.FuseStep, ST.SplitStep)):
                # gather [FU?] SP RF triple
                fuse_step = None
                if isinstance(step, ST.FuseStep):
                    fuse_step = step
                    i += 1
                    step = mods[i]
                assert isinstance(step, ST.SplitStep)
                split_step = step
                rf_step = mods[i + 1]
                assert isinstance(rf_step, ST.RfactorStep)
                ops = _apply_rfactor(ops, fuse_step, split_step, rf_step)
                i += 2
            else:
                raise ValueError(f"unexpected modifiable step: {step}")
        return ops

    def infer_bound(self, state: State, relax_threads: bool = True) -> State:
        from .bound import infer_bound

        return infer_bound(self, state, relax_threads=relax_threads)

    def apply_steps(self, records_or_steps) -> State:
        from .steps import apply_steps_to_state

        return apply_steps_to_state(self, records_or_steps)

    def print_steps_as_python(self, state: State) -> str:
        """Render the transform steps as TVM-style python schedule code
        (reference ComputeDAG::PrintStepsAsPython, compute_dag.cc:1202 +
        per-step PrintAsPythonAPI): an axis-unpacking header per compute
        stage followed by one schedule call per step, with iterator names
        tracked through the incremental replay."""
        from . import steps as ST

        def clean(n):
            return n.replace(".", "_").replace("@", "_")

        st = self.init_state.copy()
        lines = []
        for sid, stage in enumerate(st.stages):
            if stage.op_type == "placeholder":
                continue
            op = stage.op
            names = ", ".join(clean(it.name) for it in stage.iters)
            rhs = f"tuple({op.name}.op.axis)"
            if op.reduce_axes:
                rhs += f" + tuple({op.name}.op.reduce_axis)"
            lines.append(f"{names}, = {rhs}" if "," not in names
                         else f"{names} = {rhs}")

        for step in state.transform_steps:
            stage = st.stages[step.stage_id]
            op_name = stage.op.name
            # pre-apply snapshots for renaming steps
            pre_names = [it.name for it in stage.iters]
            st.transform_steps.append(step)
            step.apply_to_state(st)
            post = st.stages[step.stage_id] \
                if step.stage_id < len(st.stages) else stage

            if isinstance(step, ST.SplitStep):
                old = pre_names[step.iter_id]
                news = [
                    clean(it.name)
                    for it in post.iters[
                        step.iter_id:step.iter_id + len(step.lengths) + 1
                    ]
                ]
                fac = ", ".join(str(l) for l in step.lengths)
                lines.append(
                    f"{', '.join(news)} = s[{op_name}].split("
                    f"{clean(old)}, factors=[{fac}])"
                )
                continue
            if isinstance(step, (ST.FollowSplitStep,
                                 ST.FollowFusedSplitStep)):
                old = pre_names[step.iter_id]
                n_out = (step.n_split + 1
                         if isinstance(step, ST.FollowSplitStep) else 2)
                news = [
                    clean(it.name)
                    for it in post.iters[step.iter_id:step.iter_id + n_out]
                ]
                lines.append(
                    f"{', '.join(news)} = s[{op_name}].split("
                    f"{clean(old)}, factors=follow({step.to_record()!r}))"
                )
                continue
            if isinstance(step, ST.FuseStep):
                olds = [clean(pre_names[i]) for i in step.fused_ids]
                new = clean(post.iters[step.fused_ids[0]].name)
                lines.append(
                    f"{new} = s[{op_name}].fuse({', '.join(olds)})"
                )
                continue
            if isinstance(step, ST.ReorderStep):
                order = [clean(pre_names[i]) for i in step.after_ids]
                lines.append(f"s[{op_name}].reorder({', '.join(order)})")
            elif isinstance(step, ST.AnnotationStep):
                from .state import ANNOTATION_STRINGS, THREAD_ANNOTATIONS

                it = clean(pre_names[step.iter_id])
                ann = ANNOTATION_STRINGS[step.annotation]
                if step.annotation in THREAD_ANNOTATIONS:
                    lines.append(
                        f"s[{op_name}].bind({it}, "
                        f"te.thread_axis(\"{ann}\"))"
                    )
                else:
                    lines.append(f"s[{op_name}].{ann}({it})")
            elif isinstance(step, ST.PragmaStep):
                it = clean(pre_names[step.iter_id]) if pre_names else "None"
                if "$" in step.pragma_type:
                    name, val = step.pragma_type.split("$", 1)
                    lines.append(
                        f"s[{op_name}].pragma({it}, \"{name}\", {val})"
                    )
                else:
                    lines.append(
                        f"s[{op_name}].pragma({it}, "
                        f"\"{step.pragma_type}\")"
                    )
            elif isinstance(step, ST.StorageAlignStep):
                it = clean(pre_names[step.iter_id])
                lines.append(
                    f"s[{op_name}].storage_align({it}, {step.factor}, "
                    f"{step.offset})"
                )
            elif isinstance(step, ST.ComputeAtStep):
                tgt = st.stages[step.target_stage_id]
                it = clean(tgt.iters[step.target_iter_id].name)
                lines.append(
                    f"s[{op_name}].compute_at(s[{tgt.op.name}], {it})"
                )
            elif isinstance(step, ST.ComputeInlineStep):
                lines.append(f"s[{op_name}].compute_inline()")
            elif isinstance(step, ST.ComputeRootStep):
                lines.append(f"s[{op_name}].compute_root()")
            elif isinstance(step, ST.CacheReadStep):
                readers = ", ".join(
                    st.stages[r].op.name for r in step.reader_stage_ids
                )
                lines.append(
                    f"{op_name}_{step.scope_name} = s.cache_read("
                    f"{op_name}, \"{step.scope_name}\", [{readers}])"
                )
            elif isinstance(step, ST.CacheWriteStep):
                lines.append(
                    f"{op_name}_{step.scope_name} = s.cache_write("
                    f"{op_name}, \"{step.scope_name}\")"
                )
            elif isinstance(step, ST.RfactorStep):
                it = clean(pre_names[step.iter_id])
                lines.append(
                    f"{op_name}_rf = s.rfactor({op_name}, {it}, "
                    f"{step.factor_iter_id})"
                )
        return "\n".join(lines) + "\n"

    def __repr__(self):
        return f"ComputeDAG({[op.name for op in self.ops]}, flops={self.flop_ct:g})"


def _apply_cache_read(ops, step):
    """X -> X + X.scope copy-stage; readers retargeted.

    te names the cache tensor ``<src>.<scope>`` (te/schedule/schedule_dataflow
    _rewrite semantics); the new op reads the source elementwise.
    """
    src = ops[step.stage_id]
    src_tensor = src.output()
    axes = [
        IterDim(f"ax{d}", src_tensor.shape[d], "spatial")
        for d in range(len(src_tensor.shape))
    ]
    body = E.TensorRead(src_tensor, tuple(a.var for a in axes))
    cache_op = ComputeOp(f"{src.name}.{step.scope_name}", axes, body,
                         dtype=src_tensor.dtype)
    cache_tensor = cache_op.output()

    new_ops = list(ops)
    new_ops.insert(step.stage_id + 1, cache_op)
    # retarget the recorded readers (pre-insertion stage ids)
    for rid in step.reader_stage_ids:
        new_rid = rid + 1 if rid > step.stage_id else rid
        reader = new_ops[new_rid]
        assert isinstance(reader, ComputeOp)
        new_body = _retarget_reads(reader.body, {src.uid: cache_tensor})
        new_reader = ComputeOp(reader.name, reader.axes, new_body,
                               dtype=reader.dtype, tag=reader.tag,
                               attrs=reader.attrs)
        _replace_op(new_ops, new_rid, reader, new_reader)
    return new_ops


def _apply_cache_write(ops, step):
    """X -> X.scope (the compute) + X (a copy); consumers keep reading X."""
    src = ops[step.stage_id]
    assert isinstance(src, ComputeOp)

    # cache op: the original computation on fresh axes named like te's "i.c"
    new_spatial = [IterDim(f"{d.name}.c", d.extent, "spatial") for d in src.axes]
    sub = {d.var: nd.var for d, nd in zip(src.axes, new_spatial)}
    new_body = E.substitute(src.body, sub)
    cache_op = ComputeOp(f"{src.name}.{step.scope_name}", new_spatial, new_body,
                         dtype=src.dtype, tag=src.tag, attrs=src.attrs)
    cache_tensor = cache_op.output()

    # the original op becomes a pure copy of the cache tensor
    copy_axes = _clone_spatial_axes(src)
    copy_body = E.TensorRead(cache_tensor, tuple(a.var for a in copy_axes))
    copy_op = ComputeOp(src.name, copy_axes, copy_body, dtype=src.dtype,
                        tag=src.tag)  # the copy is elementwise: no FLOP attr

    new_ops = list(ops)
    new_ops[step.stage_id] = copy_op
    new_ops.insert(step.stage_id, cache_op)
    # consumers of src now read copy_op's output (cascading)
    _cascade_retarget(new_ops, step.stage_id + 2, {src.uid: copy_op.output()})
    return new_ops


def _apply_rfactor(ops, fuse_step, split_step, rf_step):
    """X -> X.rf (partial reduction, factored axis spatial) + X (reduction
    over the factored axis). Mirrors te::Schedule::rfactor as used by
    Ansor's AddRfactor rule (sketch_policy_rules.cc CPU rules)."""
    src = ops[rf_step.stage_id]
    assert isinstance(src, ComputeOp)
    assert isinstance(src.body, E.Reduce)
    red_axes = src.reduce_axes
    n_spatial = len(src.axes)

    # reduce domain = fused reduce axes in fuse order (or the single axis)
    total = 1
    for d in red_axes:
        total *= d.extent

    lengths = split_step.lengths
    assert len(lengths) == 1 and lengths[0] is not None, (
        "rfactor expects a single concrete split factor (Ansor AddRfactor)"
    )
    inner_len = lengths[0]
    outer_len = -(-total // inner_len)

    # which split part becomes the rf spatial axis: stage axes at replay
    # time are [spatial..., outer, inner]
    if rf_step.iter_id == n_spatial:
        rf_extent, other_extent, rf_is_outer = outer_len, inner_len, True
    elif rf_step.iter_id == n_spatial + 1:
        rf_extent, other_extent, rf_is_outer = inner_len, outer_len, False
    else:
        raise ValueError("rfactor iter_id must point at a reduce split part")

    rf_dim = IterDim("k.rf", rf_extent, "spatial")
    other_red = IterDim("k.other", other_extent, "reduce")

    # fused index r = outer * inner_len + inner
    if rf_is_outer:
        r_expr = rf_dim.var * inner_len + other_red.var
    else:
        r_expr = other_red.var * inner_len + rf_dim.var

    # unflatten r over the original reduce extents (row-major, fuse order)
    sub = {}
    rem = r_expr
    strides = []
    s = 1
    for d in reversed(red_axes):
        strides.append(s)
        s *= d.extent
    strides = strides[::-1]
    for d, stride in zip(red_axes, strides):
        idx = rem // stride if stride > 1 else rem
        if d is not red_axes[0]:
            idx = E.FloorMod(rem, E.IntImm(stride * d.extent)) // stride \
                if stride > 1 else E.FloorMod(rem, E.IntImm(d.extent))
        sub[d.var] = idx

    inner_expr = E.substitute(src.inner_expr(), sub)
    if outer_len * inner_len != total:
        guard = E.Cmp("<", r_expr, E.IntImm(total))
        zero = E.FloatImm(0.0) if src.body.combiner == "sum" else None
        if zero is not None:
            inner_expr = E.Select(guard, inner_expr, zero)

    rf_spatial = list(src.axes)
    rf_spatial.insert(rf_step.factor_iter_id, rf_dim)
    rf_body = E.Reduce(src.body.combiner, inner_expr, (other_red,),
                       src.body.init)
    rf_op = ComputeOp(f"{src.name}.rf", rf_spatial, rf_body, dtype=src.dtype,
                      tag=src.tag, attrs=src.attrs)

    # the original op becomes a reduction of X.rf over the rf axis
    new_axes = _clone_spatial_axes(src)
    new_red = IterDim("k.v", rf_extent, "reduce")
    read_idx = [a.var for a in new_axes]
    read_idx.insert(rf_step.factor_iter_id, new_red.var)
    new_body = E.Reduce(src.body.combiner,
                        E.TensorRead(rf_op.output(), tuple(read_idx)),
                        (new_red,), src.body.init)
    new_src = ComputeOp(src.name, new_axes, new_body, dtype=src.dtype,
                        tag=src.tag)  # reduction of X.rf: derived, no attr

    new_ops = list(ops)
    new_ops[rf_step.stage_id] = new_src
    new_ops.insert(rf_step.stage_id, rf_op)
    _cascade_retarget(new_ops, rf_step.stage_id + 2, {src.uid: new_src.output()})
    return new_ops


def _replace_op(ops, idx, old_op, new_op):
    """Replace ops[idx] and cascade-retarget every transitive consumer.

    Replacing an op creates a new object, so its consumers must be rebuilt
    too (and theirs, recursively) — otherwise stage ops would keep reading
    stale producer objects.
    """
    ops[idx] = new_op
    mapping = {old_op.uid: new_op.output()}
    _cascade_retarget(ops, idx + 1, mapping)


def _cascade_retarget(ops, start, mapping):
    for j in range(start, len(ops)):
        op = ops[j]
        if not isinstance(op, ComputeOp):
            continue
        reads = op.reads_of_uids(set(mapping))
        if not reads:
            continue
        nb = _retarget_reads(op.body, mapping)
        new_op = ComputeOp(op.name, op.axes, nb, dtype=op.dtype, tag=op.tag,
                           attrs=op.attrs)
        ops[j] = new_op
        mapping[op.uid] = new_op.output()
