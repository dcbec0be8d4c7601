"""Sketch generation + evolutionary candidate search.

Parity target: the reference's SketchPolicy
(src/auto_scheduler/search_policy/sketch_policy.cc and
sketch_policy_rules.cc): hierarchical sketch rules (CPU order: AlwaysInline,
MultiLevelTilingWithFusion, MultiLevelTiling, SkipStage — sketch_policy.cc
:96-104), init-population rules (FillTileSize, Parallel, Unroll,
Vectorization — :106-126), and evolutionary search with cost-model-scored
heap + prefix-sum parent selection + weighted mutation (no crossover;
:487-624). Default params follow search_policy.py:179-194 (population 2048,
iters 4, mutation 0.85, tiling structure "SSRSRS", max innermost split
factor 64, auto-unroll candidates {0,16,64,512}).

A copy of ``vae_extent_search_tpu/search/sketch.py``. The GA runs on the
port's native record-level engine (``_evolutionary_search_native_recs``:
candidates stay step records, and the host library replays them, keys
them and featurises them, ``records/fast_parser.py``) and
``make_state_records`` drives it for pool generation, as in the JAX
package; the State-level Python GA runs where the JAX one does: a cost
model without ``predict_on_feature_list`` (or whose ``predict`` and
``predict_on_feature_list`` come from different classes), or a population
of which the native side replays no record (rfactor sketches). The
measure-round methods (``continue_search_one_round`` and its eps-greedy
pick) serve ``records/dispatcher.py``. Both rule sets are kept: the
CPU-target rules above, and for a GPU task (``cuda`` targets; GPU order
AlwaysInline, MultiLevelTilingWithFusion with structure "SSSRRSRS",
AddCacheRead("shared"), CrossThreadReduction — sketch_policy.cc:128-147)
the thread binding of ``init_thread_bind``, the shared-memory cache reads
with cooperative fetching, the cross-thread reduction, the GPU
auto-unroll candidates {0,16,64,512,1024} and the GPU mutation weights
(tile .90 / unroll .10).
"""

from __future__ import annotations

import functools
import heapq
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ir import schedule_api  # noqa: F401  (installs State methods)
from ..ir import expr as E
from ..ir.state import (AT_INLINED, AT_ITER, AT_ROOT, KIND_REDUCTION,
                        KIND_SPATIAL, State)
from ..ir.steps import SplitStep
from ..ir.tensor import ComputeOp, PlaceholderOp
from ..records.task import SearchTask

AUTO_UNROLL_CANDIDATES_CPU = [0, 16, 64, 512]
AUTO_UNROLL_CANDIDATES_GPU = [0, 16, 64, 512, 1024]


# ---------------------------------------------------------------------------
# Access analysis (reference compute_dag.cc AccessAnalyzer)
# ---------------------------------------------------------------------------


class AccessAnalysis:
    def __init__(self, dag):
        self.dag = dag
        # an op is an output if nothing in the dag reads it
        read_uids = set()
        for op in dag.ops:
            if isinstance(op, ComputeOp):
                for t in op.input_tensors():
                    read_uids.add(t.op.uid)
        self.is_output = {
            op.uid: (op.uid not in read_uids) for op in dag.ops
        }
        self.needs_multi_level_tiling = {}
        self.is_strictly_inlineable = {}
        self.is_simple_access = {}
        # op uid -> iter names indexing const tensors (the reference's
        # simplify_const_tensor_indices op attr, set by topi for winograd
        # data_pack/inverse; here derived: a const tensor is a ComputeOp
        # whose body reads nothing)
        self.const_tensor_indices = {}
        # producer uid -> consumer uids; (consumer, producer) -> number
        # of common outer iterators (reference access analyzer,
        # compute_dag.cc:277-306)
        self.read_by_uids = {}
        self.edge_common_outer = {}
        self._rank = {
            op.uid: (len(op.axes) if isinstance(op, ComputeOp)
                     else len(op.shape))
            for op in dag.ops
        }
        for op in dag.ops:
            if not isinstance(op, ComputeOp):
                continue
            self.is_simple_access[op.uid] = self._simple_access(op)
            self.needs_multi_level_tiling[op.uid] = self._needs_mlt(op)
            self._build_common_outer(op)
            reads = E.collect_reads(op.body)
            self.const_tensor_indices[op.uid] = \
                self._const_tensor_indices(op, reads)
            self.is_strictly_inlineable[op.uid] = (
                self.is_simple_access[op.uid]
                and not op.reduce_axes
                and not self._has_expensive_op(op)
                # branches (Select / if_then_else) are never strictly
                # inlined — padding stays a separate stage whose location
                # the ChangeComputeLocation rules tune
                # (compute_dag.cc:336-356)
                and not self._has_branch(op)
                and not self._reorders_axes(op, reads)
            )
            if not reads:  # constant tensor (compute_dag.cc:354-356)
                self.is_strictly_inlineable[op.uid] = True

    def _simple_access(self, op: ComputeOp) -> bool:
        """Every read index is an axis var, a constant, or var +/- const
        (the reference's AccessAnalyzer treats constant-shifted axes —
        e.g. padding's h - pad — as simple accesses)."""

        def ok(idx):
            if isinstance(idx, (E.Var, E.IntImm)):
                return True
            if isinstance(idx, (E.Add, E.Sub)):
                a, b = idx.a, idx.b
                return (isinstance(a, E.Var) and isinstance(b, E.IntImm)) or (
                    isinstance(a, E.IntImm) and isinstance(b, E.Var)
                )
            return False

        for r in E.collect_reads(op.body):
            for idx in r.indices:
                if not ok(idx):
                    return False
        return True

    def _has_expensive_op(self, op: ComputeOp) -> bool:
        counts = E.count_math_ops(op.body)
        return counts["float_math"] > 0 or counts["float_div_mod"] > 0

    def _const_tensor_indices(self, op: ComputeOp, reads):
        const_uids = set()
        for other in self.dag.ops:
            if isinstance(other, ComputeOp) and \
                    not E.collect_reads(other.body):
                const_uids.add(other.uid)
        names = set()
        var_name = {d.var: d.name for d in
                    list(op.axes) + list(op.reduce_axes)}
        for r in reads:
            if r.tensor.op.uid not in const_uids:
                continue
            for idx in r.indices:
                for v in E.collect_vars(idx):
                    if v in var_name:
                        names.add(var_name[v])
        return names

    def _has_branch(self, op: ComputeOp) -> bool:
        found = False

        def walk(e):
            nonlocal found
            if found:
                return
            if isinstance(e, E.Select):
                found = True
                return
            if isinstance(e, E.Call) and e.func == "if_then_else":
                found = True
                return
            for attr in ("a", "b", "cond", "true_value", "false_value",
                         "value"):
                v = getattr(e, attr, None)
                if isinstance(v, E.Expr):
                    walk(v)
            for attr in ("parts", "args", "indices"):
                v = getattr(e, attr, None)
                if v:
                    for x in v:
                        if isinstance(x, E.Expr):
                            walk(x)

        walk(op.body)
        return found

    def _reorders_axes(self, op: ComputeOp, reads) -> bool:
        """Transposed / duplicated axis access — not strictly inlined
        (compute_dag.cc:336-339 same_order / axis_duplicated)."""
        axis_pos = {d.var: i for i, d in enumerate(op.axes)}
        for r in reads:
            seq = []
            for idx in r.indices:
                for v in E.collect_vars(idx):
                    if v in axis_pos:
                        seq.append(axis_pos[v])
            if len(set(seq)) != len(seq):
                return True
            if seq != sorted(seq):
                return True
        return False

    def _needs_mlt(self, op: ComputeOp) -> bool:
        """Reference AccessAnalyzer needs_multi_level_tiling
        (compute_dag.cc:360-390) verbatim: per READ TENSOR, a spatial
        axis with extent > 1 absent from every access to it counts one
        "missing"; the op needs multi-level tiling when two inputs each
        miss an axis, or one does and the op reduces. Extent-1 axes
        never count (adaptive_pool's collapsed spatial dims read as
        pure-reduce accesses but carry no reuse)."""
        reads_by_tensor: dict = {}
        for r in E.collect_reads(op.body):
            reads_by_tensor.setdefault(r.tensor.op.uid, []).append(r)
        n_missing = 0
        for accesses in reads_by_tensor.values():
            used = set()
            for r in accesses:
                for idx in r.indices:
                    used |= E.collect_vars(idx)
            for d in op.axes:
                ext = d.extent if isinstance(d.extent, int) else 2
                if ext > 1 and d.var not in used:
                    n_missing += 1
                    break
            if n_missing >= 2 or (n_missing >= 1 and op.reduce_axes):
                return True
        return False

    @staticmethod
    def _const_shift_equal(var, idx) -> bool:
        """idx is `var` or `var +/- const` (reference IsConstShiftEqual,
        utils.h — the injectivity test of the common-outer scan)."""
        if idx is var:
            return True
        if isinstance(idx, (E.Add, E.Sub)):
            a, b = idx.a, idx.b
            return (a is var and isinstance(b, E.IntImm)) or (
                isinstance(a, E.IntImm) and b is var)
        return False

    def _build_common_outer(self, op: ComputeOp):
        """Per read edge: number of leading output dims where consumer
        and producer shapes agree and every access index is the
        consumer's own axis (const-shifted) — reference
        compute_dag.cc:277-306."""
        by_producer: dict = {}
        for r in E.collect_reads(op.body):
            by_producer.setdefault(r.tensor.op.uid, []).append(r)
        out_shape = [d.extent if isinstance(d.extent, int) else -1
                     for d in op.axes]
        for puid, accesses in by_producer.items():
            self.read_by_uids.setdefault(puid, set()).add(op.uid)
            prod_shape = list(accesses[0].tensor.shape)
            n_common = 0
            for i in range(min(len(out_shape), len(prod_shape))):
                if out_shape[i] < 0 or out_shape[i] != prod_shape[i]:
                    break
                if not all(
                    len(r.indices) > i
                    and self._const_shift_equal(op.axes[i].var,
                                                r.indices[i])
                    for r in accesses
                ):
                    break
                n_common += 1
            self.edge_common_outer[(op.uid, puid)] = n_common

    def num_common_outer(self, op, target_uid) -> int:
        """Chain-min of per-edge common-outer counts from ``op`` through
        its consumers to ``target_uid`` (reference
        GetNumCommonOuterIterator, compute_dag.cc:477-499)."""
        best = None

        def traverse(uid, cur):
            nonlocal best
            if uid == target_uid:
                best = cur if best is None else min(best, cur)
                return
            for cons in self.read_by_uids.get(uid, ()):
                edge = self.edge_common_outer.get((cons, uid), 0)
                traverse(cons, min(cur, edge))

        traverse(op.uid, self._rank.get(op.uid, 0))
        return best if best is not None else 0

    def consumers(self, state: State, stage_id: int) -> List[int]:
        """Stage ids reading this stage's output, resolved THROUGH inlined
        stages (an inlined consumer's consumers become ours — mirrors the
        access analyzer's elementwise-match through inlined ops)."""
        out = []
        seen = set()

        def direct(uid):
            res = []
            for sid, s in enumerate(state.stages):
                if not isinstance(s.op, ComputeOp) or s.op.uid == uid:
                    continue
                if any(t.op.uid == uid for t in s.op.input_tensors()):
                    res.append(sid)
            return res

        frontier = [state.stages[stage_id].op.uid]
        while frontier:
            uid = frontier.pop()
            for sid in direct(uid):
                if sid in seen:
                    continue
                seen.add(sid)
                if state.stages[sid].compute_at == AT_INLINED:
                    frontier.append(state.stages[sid].op.uid)
                else:
                    out.append(sid)
        return sorted(out)


# ---------------------------------------------------------------------------
# Multi-level tiling (reference search_policy/utils.cc DoMultiLevelTiling)
# ---------------------------------------------------------------------------


def do_multi_level_tiling(state: State, stage_id: int, structure: str = "SSRSRS"):
    """Split each spatial axis into count('S') parts and each reduce axis
    into count('R') parts, then reorder by the structure string.

    Returns the list of split step ids for the spatial splits (needed by
    follow_split in the fusion rule)."""
    n_space = structure.count("S")
    n_reduce = structure.count("R")

    stage = state.stages[stage_id]
    space_levels: List[List] = [[] for _ in range(n_space)]
    reduce_levels: List[List] = [[] for _ in range(n_reduce)]
    spatial_split_step_ids = []

    # iterate original iters; split each in place (positions shift)
    orig = list(stage.iters)
    for it in orig:
        if it.kind == KIND_SPATIAL:
            if n_space == 1:
                space_levels[0].append(it)
            else:
                spatial_split_step_ids.append(len(state.transform_steps))
                parts = state.split(stage_id, it, [None] * (n_space - 1))
                for lv, p in enumerate(parts):
                    space_levels[lv].append(p)
        else:  # reduction
            if n_reduce == 1:
                reduce_levels[0].append(it)
            else:
                parts = state.split(stage_id, it, [None] * (n_reduce - 1))
                for lv, p in enumerate(parts):
                    reduce_levels[lv].append(p)

    order = []
    si, ri = 0, 0
    for ch in structure:
        if ch == "S":
            order.extend(space_levels[si])
            si += 1
        else:
            order.extend(reduce_levels[ri])
            ri += 1
    state.reorder(stage_id, order)
    return spatial_split_step_ids


# ---------------------------------------------------------------------------
# Sketch generation (CPU and GPU rule sets)
# ---------------------------------------------------------------------------


def _fuse_into_consumer(st: State, stage_id: int, target: int,
                        split_ids: List[int], n_split: int):
    """Follow-split the consumer's spatial axes to the first levels of the
    tiled stage, reorder level-major, attach the tiled stage at the last
    iterator of the (n_split-1)-th level (MultiLevelTilingWithFusion,
    sketch_policy_rules.cc fuse-level semantics; e.g. conv2d.json:
    FSP n_split=3 x4 + RE + CA at 3*4-1=11)."""
    t_stage = st.stages[target]
    offset = 0
    n_axes = 0
    for i, it in enumerate(list(t_stage.iters)):
        if i >= len(split_ids):
            break
        st.follow_split(target, offset, split_ids[i], n_split)
        offset += n_split + 1
        n_axes += 1
    order = []
    for lv in range(n_split + 1):
        for ax in range(n_axes):
            order.append(ax * (n_split + 1) + lv)
    st.reorder(target, order)
    attach_pos = n_split * n_axes - 1
    st.compute_at(stage_id, target, attach_pos)


def _cum_space_reduce_len(op: ComputeOp):
    space = 1
    for d in op.axes:
        space *= d.extent if isinstance(d.extent, int) else 1
    red = 1
    for d in op.reduce_axes:
        # symbolic (data-dependent) extents count as 1 — otherwise the
        # product becomes an Expr and comparisons a truthy Cmp object
        red *= d.extent if isinstance(d.extent, int) else 1
    return space, red


def _needs_rfactor(op: ComputeOp, analysis, hw) -> bool:
    """Reference NeedsRfactor (utils.h:319-341): multi-level-tiling
    stages rfactor when the space domain is smaller than both the
    reduction and num_cores*16; plain reduction stages whenever the
    reduction exceeds the core count."""
    if not op.reduce_axes:
        return False
    space, red = _cum_space_reduce_len(op)
    if analysis.needs_multi_level_tiling.get(op.uid):
        return space <= red and space <= hw.num_cores * 16
    return red > 1 and red > hw.num_cores


def _single_consumer_id(st: State, cons) -> "int | None":
    """Resolve multiple consumers to their common compute root
    (reference GetSingleConsumerId, utils.h:193-230: consumers attached
    under one root stage count as that single root)."""
    if not cons:
        return None
    if len(cons) == 1:
        return cons[0]
    root = None
    for c in cons:
        stg = st.stages[c]
        if stg.compute_at == AT_ROOT:
            r = c
        elif stg.compute_at == AT_ITER:
            at = st.attach_map.stage_to_attach_iter.get(c)
            if at is None:
                return None
            r = at[0]
        else:
            return None
        if root is None:
            root = r
        elif root != r:
            return None
    return root


def _needs_cross_thread(op: ComputeOp, analysis, hw) -> bool:
    """Reference RuleCrossThreadReduction::MeetCondition
    (sketch_policy_rules.cc:330-370): for multi-level-tiling stages,
    cross-thread applies when the space domain fits one thread block
    and the reduction dominates it; for plain reduction stages, when
    the fused reduction exceeds a warp."""
    if not op.reduce_axes:
        return False
    space, red = _cum_space_reduce_len(op)
    if analysis.needs_multi_level_tiling.get(op.uid):
        return space <= hw.max_threads_per_block and space < red
    return red > 1 and red > hw.warp_size


def _generate_main_sketch(task: SearchTask, use_rfactor: bool = False,
                          cross_thread: bool = False,
                          fuse_level: int = None,
                          fuse_consumer: bool = True,
                          rfactor_inner: bool = True) -> State:
    """One sketch: AlwaysInline for strictly inlineable non-output stages;
    for tilable stages MultiLevelTilingWithFusion (or AddCacheWrite when
    no fusible consumer exists — the cache copy becomes the consumer), GPU
    AddCacheRead("shared"); optionally the AddRfactor / CrossThreadReduction
    alternatives for reduction-heavy small-spatial stages
    (sketch_policy.cc:96-147 rule order)."""
    dag = task.compute_dag
    analysis = AccessAnalysis(dag)
    is_gpu = task.is_gpu
    structure = "SSSRRSRS" if is_gpu else "SSRSRS"
    n_split = fuse_level if fuse_level is not None else (3 if is_gpu else 2)
    n_space_levels = structure.count("S")

    st = dag.init_state.copy()
    st.tiled_stage_split_ids = {}  # op name -> spatial split step ids
    # stages added by cache_read are never re-visited by the reference's
    # enumeration (GenerateSketches walks stage ids strictly downward
    # and cache stages insert above the producer position,
    # sketch_policy.cc:314-382) — without this the GPU greedy-inline
    # rule would swallow the shared caches it just created
    cache_stage_uids = set()
    stage_id = len(st.stages) - 1
    while stage_id >= 0:
        stage = st.stages[stage_id]
        op = stage.op
        if isinstance(op, PlaceholderOp) or stage.compute_at == AT_INLINED \
                or op.uid in cache_stage_uids:
            stage_id -= 1
            continue
        uid = op.uid
        # GPU greedily inlines EVERY reduce-free non-output compute op
        # — including padding and transposed-access ops that CPU leaves
        # for ChangeComputeLocation to tune (reference
        # ShouldAlwaysBeInlined, sketch_policy_rules.cc:57-76: the
        # IsStrictlyInlineable check applies only to CPU tasks).
        # Golden: conv2d.json cuda records CI pad_temp after
        # cache-reading it (CI x2 per record).
        inlinable = (
            (isinstance(op, ComputeOp) and not op.reduce_axes)
            if is_gpu else analysis.is_strictly_inlineable.get(uid)
        )
        if inlinable and not analysis.is_output.get(uid):
            # RuleSpecialComputeLocationGPU (sketch_policy_rules.cc:425):
            # a to-be-inlined producer of a const-simplified consumer is
            # computed_at just before the consumer's unrolled region
            has_producers = isinstance(op, ComputeOp) and bool(
                E.collect_reads(op.body)
            )
            if is_gpu and has_producers:
                cons = analysis.consumers(st, stage_id)
                if len(cons) == 1 and analysis.const_tensor_indices.get(
                    st.stages[cons[0]].op.uid
                ):
                    tgt = st.stages[cons[0]]
                    placed = False
                    for i, it in enumerate(tgt.iters):
                        if it.annotation == 1 and i > 0:  # first unroll
                            st.compute_at(stage_id, cons[0], i - 1)
                            placed = True
                            break
                    if placed:
                        stage_id -= 1
                        continue
            st.compute_inline(stage_id)
            stage_id -= 1
            continue
        cti = analysis.const_tensor_indices.get(uid)
        if cti:
            # RuleSimplifyComputeWithConstTensor (:293-328): unroll the
            # const-tensor indices, 2-level-tile the other space iters,
            # reorder [outer..., inner..., unrolled...]
            it_infos = [(it.name, it.kind) for it in stage.iters]
            pos = 0
            outer_groups = []
            unrolled = []
            for name, kind in it_infos:
                if name in cti:
                    st.unroll(stage_id, pos)
                    unrolled.append(pos)
                    pos += 1
                elif kind == KIND_SPATIAL:
                    st.split(stage_id, pos, [None])
                    outer_groups.append([pos, pos + 1])
                    pos += 2
                else:
                    unrolled.append(pos)  # stray reduce: keep innermost
                    pos += 1
            order = [g[0] for g in outer_groups] + \
                [g[1] for g in outer_groups] + unrolled
            st.reorder(stage_id, order)
            stage_id -= 1
            continue
        if not analysis.needs_multi_level_tiling.get(uid):
            if op.reduce_axes and (
                _needs_cross_thread(op, analysis, task.hardware_params)
                if is_gpu else
                _needs_rfactor(op, analysis, task.hardware_params)
            ):
                if use_rfactor and not is_gpu:
                    # AddRfactor (sketch_policy_rules.cc:248-300): fuse
                    # all reduce iters, split by {1}, rfactor either the
                    # outer or the inner split part (rfactor_inner
                    # selects the reference's second variant, which
                    # also reorders the rf stage's space iter innermost
                    # for vectorization). The split factor is reset to
                    # undefined afterwards so init-population samples
                    # it (the reference's rfactor hack,
                    # sketch_policy.cc:355-378).
                    red_pos = [
                        i for i, it in enumerate(stage.iters)
                        if it.kind != KIND_SPATIAL
                    ]
                    if len(red_pos) >= 1:
                        if len(red_pos) > 1:
                            st.fuse(stage_id, red_pos)
                        fused_pos = red_pos[0]
                        n_space = fused_pos  # spatial iters precede
                        st.split(stage_id, fused_pos, [1])
                        rf_iter = fused_pos + (1 if rfactor_inner else 0)
                        st.rfactor(stage_id, rf_iter, n_space)
                        sp = st.transform_steps[-2]
                        st.transform_steps[-2] = SplitStep(
                            sp.stage_id, sp.iter_id, sp.extent, [None],
                            sp.inner_to_outer,
                        )
                        if rfactor_inner:
                            # move the space iter at n_space innermost
                            rst = st.stages[stage_id]
                            order = [i for i in range(len(rst.iters))
                                     if i != n_space] + [n_space]
                            st.reorder(stage_id, order)
                elif cross_thread and is_gpu:
                    # CrossThreadReduction (sketch_policy_rules.cc:372-420):
                    # fuse the reduce iters; when the (single, possibly
                    # inline-resolved) consumer shares outer iterators
                    # and needs no multi-level tiling, FOLLOW the
                    # consumer's thread split and compute_at the
                    # reduction inside it (the softmax pattern of
                    # resnet-18-cuda records: SP on norm, FSP+CA on
                    # expsum/maxelem); otherwise bind a plain
                    # warp-sized split
                    red_pos = [
                        i for i, it in enumerate(stage.iters)
                        if it.kind != KIND_SPATIAL
                    ]
                    if red_pos:
                        if len(red_pos) > 1:
                            st.fuse(stage_id, red_pos)
                        fused_pos = red_pos[0]
                        stage = st.stages[stage_id]
                        warp = task.hardware_params.warp_size
                        cons = analysis.consumers(st, stage_id)
                        fuse_target = None
                        c = _single_consumer_id(st, cons)
                        if c is not None:
                            nco = analysis.num_common_outer(
                                op, st.stages[c].op.uid)
                            if nco > 0 and not \
                                    analysis.needs_multi_level_tiling.get(
                                        st.stages[c].op.uid):
                                fuse_target = (c, nco)
                        if fuse_target is not None:
                            c, nco = fuse_target
                            split_ids = [
                                si for si, s in
                                enumerate(st.transform_steps)
                                if isinstance(s, SplitStep) and s.stage_id == c
                            ]
                            if not split_ids:
                                # simple reduce-free consumer: give it
                                # the thread split to follow
                                last = len(st.stages[c].iters) - 1
                                parts = st.split(c, last, [warp])
                                st.bind(c, parts[1], "threadIdx.x")
                                split_ids = [len(st.transform_steps) - 2]
                            parts = st.follow_split(
                                stage_id, fused_pos, split_ids[0], 1)
                            st.bind(stage_id, parts[1], "threadIdx.x")
                            st.compute_at(stage_id, c, nco - 1)
                        else:
                            parts = st.split(
                                stage_id, fused_pos, [warp])
                            st.bind(stage_id, parts[1], "threadIdx.x")
            stage_id -= 1
            continue

        consumers = analysis.consumers(st, stage_id)
        fusible = [
            c
            for c in consumers
            if analysis.is_output.get(st.stages[c].op.uid)
            and st.stages[c].compute_at == AT_ROOT
            and not st.stages[c].op.reduce_axes
        ]
        had_fusible_consumer = bool(fusible)
        if not fusible:
            # AddCacheWrite: [cache compute at stage_id, copy at
            # stage_id + 1]; the copy becomes the fusion consumer
            scope = "local" if is_gpu else "global"
            st.cache_write(stage_id, scope)
            fusible = [stage_id + 1]

        stage = st.stages[stage_id]
        op = stage.op
        split_ids = do_multi_level_tiling(st, stage_id, structure)
        # keyed by op NAME: cache-read steps clone downstream ops (new
        # uids) but preserve names
        st.tiled_stage_split_ids[op.name] = split_ids
        n_axes = len(split_ids)
        # CPU generates BOTH the fused and the plain tiling variant
        # (RuleMultiLevelTilingWithFusion is kApply there, so the rule
        # chain falls through to plain RuleMultiLevelTiling;
        # sketch_policy_rules.cc MeetCondition). Cache-write stages
        # always fuse into their copy stage.
        if fusible and (fuse_consumer or not had_fusible_consumer):
            _fuse_into_consumer(st, stage_id, fusible[0], split_ids, n_split)
        if is_gpu:
            # AddCacheRead: shared caches for the tiled stage's inputs,
            # attached at the LAST reduce iterator of the OUTERMOST
            # reduce tile (reference GetLastReduceIteratorInOutermost-
            # ReduceTile, utils.h:503: the first reduction iterator
            # whose fused name covers every reduce axis — which sits
            # after the LEADING space levels, not after all of them;
            # golden: conv2d.json cuda records attach at iter 14 =
            # 3*n_axes + n_reduce - 1 for structure "SSSRRSRS")
            n_reduce_axes = len(op.reduce_axes)
            leading_s = structure.index("R") if "R" in structure \
                else n_space_levels
            attach_pos = leading_s * n_axes + n_reduce_axes - 1
            for tensor in op.input_tensors():
                # find the producer stage id in the current state
                src_sid = None
                for sid2, s2 in enumerate(st.stages):
                    if s2.op.uid == tensor.op.uid and \
                            s2.compute_at != AT_INLINED:
                        src_sid = sid2
                        break
                if src_sid is None:
                    continue
                added = st.cache_read(src_sid, "shared", [stage_id])
                cache_stage_uids.add(st.stages[added].op.uid)
                # ids after insertion: our stage shifted if behind
                tgt = stage_id + 1 if stage_id >= added else stage_id
                st.compute_at(added, tgt, attach_pos)
                if stage_id >= added:
                    stage_id += 1
        stage_id -= 1
    return st


def generate_sketches(task: SearchTask, seed: int = 0) -> List[State]:
    """All sketch variants for the task (the reference's rule BFS yields
    multiple sketches; we enumerate the rule alternatives explicitly):
    one per consumer-fusion level (CPU levels {1, 2}, GPU {3} — the
    reference's follow_tiling_levels) plus the rfactor /
    cross-thread-reduction alternative when a small-spatial reduction
    qualifies."""
    levels = [3] if task.is_gpu else [2, 1]
    sketches = []
    seen = set()
    for lv in levels:
        try:
            sk = _generate_main_sketch(task, fuse_level=lv)
        except Exception:
            continue
        key = sk.to_str()
        if key not in seen:
            seen.add(key)
            sketches.append(sk)
    if not task.is_gpu:
        # the plain (unfused) multi-level-tiling variant — CPU's
        # RuleMultiLevelTilingWithFusion is kApply, so the reference's
        # BFS also reaches plain RuleMultiLevelTiling
        try:
            sk = _generate_main_sketch(task, fuse_consumer=False)
            if sk.to_str() not in seen:
                seen.add(sk.to_str())
                sketches.append(sk)
        except Exception:
            pass
    if not sketches:
        sketches = [_generate_main_sketch(task)]
    dag = task.compute_dag
    # rfactor / cross-thread-reduction alternatives when some stage
    # qualifies (GPU gating is the reference CrossThreadReduction
    # MeetCondition; CPU is the AddRfactor condition)
    _an = AccessAnalysis(dag)
    if task.is_gpu:
        has_small_reduce = any(
            isinstance(op, ComputeOp)
            and _needs_cross_thread(op, _an, task.hardware_params)
            for op in dag.ops
        )
        variants = [dict(cross_thread=True)] if has_small_reduce else []
    else:
        has_small_reduce = any(
            isinstance(op, ComputeOp)
            and _needs_rfactor(op, _an, task.hardware_params)
            for op in dag.ops
        )
        # the reference's AddRfactor emits BOTH split-part variants
        # (outer and inner-with-reorder, sketch_policy_rules.cc:248-300)
        variants = [
            dict(use_rfactor=True, rfactor_inner=False),
            dict(use_rfactor=True, rfactor_inner=True),
        ] if has_small_reduce else []
    for kw in variants:
        try:
            alt = _generate_main_sketch(task, **kw)
            if alt.to_str() not in {sk.to_str() for sk in sketches}:
                sketches.append(alt)
        except Exception:
            pass
    return sketches


def init_thread_bind(state: State, task: SearchTask,
                     rng: random.Random) -> State:
    """GPU thread binding (InitThreadBind, sketch_policy_rules.cc:780-910):

    - root multi-level-tiled stages: fuse space level 0 -> blockIdx.x,
      level 1 -> vthread, level 2 -> threadIdx.x
    - trivial root stages: fuse all space iters -> blockIdx.x (+ threadIdx
      split by warp size)
    - ".shared" cache stages: cooperative fetching — fuse all iters, split
      {1} + vectorize, follow_fused_split over the attach target's spatial
      split steps at level 1 -> threadIdx.x
    """
    split_ids_of = getattr(state, "tiled_stage_split_ids", {})
    warp = task.hardware_params.warp_size

    def _has_cross_thread(sid):
        """threadIdx-bound reduce iter in the stage or a stage attached
        to it (reference HasCrossThreadReduction, utils.h:445-470)."""
        def chk(stg):
            return any(it.annotation == 6 and it.kind == KIND_REDUCTION
                       for it in stg.iters)

        if chk(state.stages[sid]):
            return True
        for iid in range(len(state.stages[sid].iters)):
            for att in state.attach_map.iter_to_attached_stages.get(
                    (sid, iid), ()):
                if chk(state.stages[att]):
                    return True
        return False

    for sid in range(len(state.stages)):
        stage = state.stages[sid]
        if stage.op_type == "placeholder" or stage.compute_at == AT_INLINED:
            continue
        name = stage.op.name
        if _has_cross_thread(sid):
            # cross-thread-reduction stages: the reduction is already
            # threadIdx-bound; a root stage just gets its outer space
            # prefix (stopping at reduce/annotated/attach-carrying
            # iters) bound to blockIdx (reference InitThreadBind
            # cross-thread branch + FuseAllOuterSpaceIterators,
            # utils.h:597-619). Attached stages are left alone.
            if stage.compute_at != AT_ROOT:
                continue
            space = []
            for i, it in enumerate(stage.iters):
                if it.kind == KIND_REDUCTION or it.annotation != 0:
                    break
                if i > 0 and (sid, i - 1) in \
                        state.attach_map.iter_to_attached_stages:
                    break
                space.append(i)
            if not space:
                continue
            fused = state.fuse(sid, space) if len(space) > 1 else \
                stage.iters[space[0]]
            state.bind(sid, fused, "blockIdx.x")
            continue
        if any(it.annotation == 6 for it in stage.iters):
            continue  # already threadIdx-annotated
        if stage.compute_at == AT_ROOT:
            # multi-level-tiled roots carry >= 3 space levels; two-level
            # stages (e.g. const-simplified winograd data_pack) take the
            # FuseAllOuterSpaceIterators path instead
            is_mlt_root = any(it.name.endswith(".2") for it in stage.iters)
            if is_mlt_root:
                n_axes = sum(
                    1 for it in stage.iters if it.name.endswith(".0")
                )
                # level-major layout: [lv0 x n_axes][lv1 x n_axes]...
                lv0 = state.fuse(sid, list(range(0, n_axes)))
                state.bind(sid, lv0, "blockIdx.x")
                lv1 = state.fuse(sid, list(range(1, 1 + n_axes)))
                state.bind(sid, lv1, "vthread")
                lv2 = state.fuse(sid, list(range(2, 2 + n_axes)))
                state.bind(sid, lv2, "threadIdx.x")
            else:
                # FuseAllOuterSpaceIterators: the leading unannotated
                # space prefix -> blockIdx (+ threadIdx by warp size)
                space = []
                for i, it in enumerate(stage.iters):
                    if it.kind != KIND_SPATIAL or it.annotation != 0:
                        break
                    space.append(i)
                if not space:
                    continue
                fused = state.fuse(sid, space)
                ext = fused.range[1] if fused.range else warp * 2
                if ext <= warp:
                    state.bind(sid, fused, "threadIdx.x")
                else:
                    parts = state.split(sid, fused, [warp])
                    state.bind(sid, parts[0], "blockIdx.x")
                    state.bind(sid, parts[1], "threadIdx.x")
        elif stage.compute_at == AT_ITER and name.endswith(".shared"):
            # cooperative fetching
            attach = state.attach_map.stage_to_attach_iter.get(sid)
            if attach is None:
                continue
            target_sid = attach[0]
            spatial_split_ids = split_ids_of.get(
                state.stages[target_sid].op.name
            )
            if not spatial_split_ids:
                continue
            fused = state.fuse(sid, list(range(len(stage.iters))))
            iters0 = state.split(sid, fused, [1])
            state.vectorize(sid, iters0[1])
            iters1 = state.follow_fused_split(
                sid, iters0[0], spatial_split_ids, 1, True
            )
            state.bind(sid, iters1[1], "threadIdx.x")
    return state


# ---------------------------------------------------------------------------
# Init-population rules (sketch_policy_rules.cc:493-696)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=65536)
def _divisors(n: int) -> tuple:
    """All divisors of n ascending, via sqrt-bounded trial division.

    Extents reach 10^6-10^7 where schedules fuse batch x spatial axes
    (e.g. max_pool batch 8 @ 112x112x64 = 6.4M); a ``range(1, n+1)``
    scan would make every tile-size sample/mutation O(extent).
    Ascending order is load-bearing: rng.choice over the same list
    keeps pools bit-identical to the old enumeration."""
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    large.reverse()
    return tuple(small + large)


def _random_factorization(extent: int, n: int, rng: random.Random,
                          max_innermost: int = 64) -> List[int]:
    """Sample lengths [l1..ln] with prod | extent and ln <= max_innermost."""
    lengths = []
    rem = max(1, extent)
    for i in range(n):
        divisors = _divisors(rem)
        if i == n - 1:
            divisors = [d for d in divisors if d <= max_innermost]
        l = rng.choice(divisors)
        lengths.append(l)
        rem //= l
    return lengths


def init_fill_tile_size(state: State, rng: random.Random,
                        max_innermost: int = 64) -> State:
    """Fill every undefined SplitStep with a random factorization
    (InitFillTileSize, sketch_policy_rules.cc:493-531): replays all steps
    with sampled lengths."""
    new_records = []
    for step in state.transform_steps:
        if isinstance(step, SplitStep) and any(
            l is None for l in step.lengths
        ):
            extent = step.extent or 1
            lengths = _random_factorization(
                extent, len(step.lengths), rng, max_innermost
            )
            new_records.append(
                SplitStep(step.stage_id, step.iter_id, step.extent, lengths,
                          step.inner_to_outer).to_record()
            )
        else:
            new_records.append(step.to_record())
    out = state.dag.apply_steps(new_records)
    # carry sketch metadata through the replay (split step ids are
    # positional and replay-stable)
    out.tiled_stage_split_ids = dict(
        getattr(state, "tiled_stage_split_ids", {})
    )
    return out


def init_parallel(state: State, task: SearchTask, rng: random.Random) -> State:
    """Fuse + parallel outermost space iters of root stages until the
    parallel degree exceeds num_cores*16 (InitParallel, :580-643)."""
    num_cores = max(1, task.hardware_params.num_cores)
    for sid, stage in enumerate(state.stages):
        if stage.op_type == "placeholder" or stage.compute_at != AT_ROOT:
            continue
        to_fuse = []
        degree = 1
        for pos, it in enumerate(stage.iters):
            if it.kind != KIND_SPATIAL or it.annotation != 0:
                break
            if (sid, pos) in state.attach_map.iter_to_attached_stages:
                to_fuse.append(it)
                break
            to_fuse.append(it)
            if it.range:
                degree *= it.range[1]
            if degree > num_cores * 16:
                break
        if not to_fuse:
            continue
        if len(to_fuse) == 1:
            state.parallel(sid, to_fuse[0])
        else:
            fused = state.fuse(sid, to_fuse)
            state.parallel(sid, fused)
    return state


def init_unroll(state: State, task: SearchTask, rng: random.Random) -> State:
    """Random auto_unroll pragma on stages with reductions (InitUnroll)."""
    cands = (
        AUTO_UNROLL_CANDIDATES_GPU if task.is_gpu else AUTO_UNROLL_CANDIDATES_CPU
    )
    for sid, stage in enumerate(state.stages):
        if stage.op_type == "placeholder" or stage.compute_at == AT_INLINED:
            continue
        if isinstance(stage.op, ComputeOp) and stage.op.reduce_axes:
            v = rng.choice(cands)
            if v:
                state.pragma(sid, 0, f"auto_unroll_max_step${v}")
    return state


def init_vectorization(state: State, task: SearchTask,
                       rng: random.Random) -> State:
    """Fuse + vectorize innermost contiguous spatial iters (InitVectorization
    :645-696, simplified: vectorize the innermost spatial loop)."""
    for sid, stage in enumerate(state.stages):
        if stage.op_type == "placeholder" or stage.compute_at == AT_INLINED:
            continue
        iters = stage.iters
        if not iters:
            continue
        it = iters[-1]
        if (
            it.kind == KIND_SPATIAL
            and it.annotation == 0
            and it.range is not None
            and 1 < it.range[1] <= task.hardware_params.vector_unit_bytes * 4
        ):
            state.vectorize(sid, len(iters) - 1)
    return state


# ---------------------------------------------------------------------------
# Compute-location candidates (utils.cc:68-155 GetComputeLocationCandidates)
# ---------------------------------------------------------------------------

# (dag, analysis) pairs: holding the dag pins its id so a collected dag's
# reused id can never alias a stale analysis
_ANALYSIS_CACHE: Dict[int, Tuple[object, "AccessAnalysis"]] = {}


def _analysis_for(dag) -> "AccessAnalysis":
    hit = _ANALYSIS_CACHE.get(id(dag))
    if hit is not None and hit[0] is dag:
        return hit[1]
    a = AccessAnalysis(dag)
    _ANALYSIS_CACHE[id(dag)] = (dag, a)
    if len(_ANALYSIS_CACHE) > 256:  # bounded
        _ANALYSIS_CACHE.clear()
        _ANALYSIS_CACHE[id(dag)] = (dag, a)
    return a


def _is_tiled_stage(stage) -> bool:
    """More iterators than original dims => splits applied (utils.h:478)."""
    op = stage.op
    if not isinstance(op, ComputeOp):
        return False
    return len(stage.iters) != len(op.axes) + len(op.reduce_axes)


def _iter_extent(it) -> int:
    return it.range[1] if it.range is not None else 1


def get_compute_location_candidates(analysis, state: State,
                                    stage_id: int) -> List[Tuple[int, int]]:
    """(target_stage, iter position) pairs where this stage could be
    computed_at: its single consumer's outer loops (stopping at reduce
    boundaries / unroll regions / existing attachments), plus the
    consumer's own attach target when the consumer is itself attached."""
    cons = analysis.consumers(state, stage_id)
    if len(cons) != 1:
        return []
    tgt = cons[0]
    target_stage = state.stages[tgt]
    target_compute_at_other = target_stage.compute_at == AT_ITER
    target_is_tiled = _is_tiled_stage(target_stage)

    cands: List[Tuple[int, int]] = []
    visited_reduce = False
    for i, it in enumerate(target_stage.iters):
        if it.kind == KIND_REDUCTION:
            visited_reduce = True
            if not target_is_tiled:  # do not go into reduce iters
                break
        elif it.kind == KIND_SPATIAL and visited_reduce:
            break  # do not go into the inner tile
        if it.annotation == 1:  # unroll region
            break
        if _iter_extent(it) == 1:
            continue
        if (target_compute_at_other and it.kind == KIND_SPATIAL
                and it.name.endswith(".0")):
            continue  # first-level iters are length-1 under compute_at
        cands.append((tgt, i))
        if (tgt, i) in state.attach_map.iter_to_attached_stages:
            break

    if target_compute_at_other:
        ttid, _ = state.attach_map.stage_to_attach_iter[tgt]
        tts = state.stages[ttid]
        for i, it in enumerate(tts.iters):
            if it.kind == KIND_REDUCTION or (
                (ttid, i) in state.attach_map.iter_to_attached_stages
            ):
                break
            if it.annotation == 1:
                break
            if _iter_extent(it) == 1:
                continue
            cands.append((ttid, i))
    return cands


def init_change_compute_location(state: State, task: SearchTask,
                                 rng: random.Random) -> State:
    """Randomly re-place non-tiled stages among inline / root / candidate
    compute_at locations (InitChangeComputeLocation,
    sketch_policy_rules.cc:533-579)."""
    analysis = _analysis_for(state.dag)
    for stage_id in range(len(state.stages) - 1, -1, -1):
        stage = state.stages[stage_id]
        if stage.op_type == "placeholder" or stage.compute_at == AT_INLINED:
            continue
        if _is_tiled_stage(stage) or analysis.needs_multi_level_tiling.get(
            stage.op.uid
        ):
            continue
        cands = get_compute_location_candidates(analysis, state, stage_id)
        choice = rng.randrange(len(cands) + 2)
        if choice == 0:
            has_reduce = isinstance(stage.op, ComputeOp) and \
                stage.op.reduce_axes
            if not has_reduce and \
                    stage_id in state.attach_map.stage_to_attach_iter:
                state.compute_inline(stage_id)
        elif choice == 1:
            state.compute_root(stage_id)
        else:
            tgt, pos = cands[choice - 2]
            state.compute_at(stage_id, tgt, pos)
    return state


def _stage_inc(steps, step_id: int) -> int:
    """Stage-id shift of steps[step_id].stage_id in the final state
    (utils.h:542 GetTargetStageIDInState): later cache/rfactor steps at
    lower-or-equal ids push it up."""
    from ..ir.steps import CacheReadStep, CacheWriteStep, RfactorStep

    inc = 0
    base = steps[step_id].stage_id
    for s in steps[step_id + 1:]:
        if isinstance(s, (CacheReadStep, CacheWriteStep, RfactorStep)):
            if s.stage_id <= base + inc:
                inc += 1
    return inc


def mutate_compute_location(state: State, task: SearchTask,
                            rng: random.Random) -> Optional[State]:
    """Re-sample the target of one ComputeAt step (MutateComputeLocation,
    sketch_policy_rules.cc:1055-1117)."""
    from ..ir.steps import ComputeAtStep

    analysis = _analysis_for(state.dag)
    steps = state.transform_steps
    ca_steps = []
    for i, st_ in enumerate(steps):
        if not isinstance(st_, ComputeAtStep):
            continue
        cur_id = st_.stage_id + _stage_inc(steps, i)
        if cur_id >= len(state.stages):
            continue
        stage = state.stages[cur_id]
        if _is_tiled_stage(stage) or analysis.needs_multi_level_tiling.get(
            stage.op.uid
        ):
            continue
        ca_steps.append((i, cur_id))
    if not ca_steps:
        return None
    step_id, cur_id = ca_steps[rng.randrange(len(ca_steps))]
    cands = get_compute_location_candidates(analysis, state, cur_id)
    if not cands:
        return None
    tgt, pos = cands[rng.randrange(len(cands))]
    inc = _stage_inc(steps, step_id)
    recs = [s.to_record() for s in steps]
    ps = steps[step_id]
    recs[step_id] = ComputeAtStep(ps.stage_id, tgt - inc, pos).to_record()
    try:
        return state.dag.apply_steps(recs)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Mutations (sketch_policy_rules.cc:912-1054)
# ---------------------------------------------------------------------------


def _apply(state: State, recs: Optional[List[list]]) -> Optional[State]:
    """The state that step records ``recs`` give, or None (no mutation, or
    one that does not replay)."""
    if recs is None:
        return None
    try:
        return state.dag.apply_steps(recs)
    except Exception:
        return None


def mutate_tile_size(state: State, rng: random.Random,
                     max_innermost: int = 64) -> Optional[State]:
    """Move a random factor between two positions of a random SplitStep
    (MutateTileSize), working on the state's step records."""
    return _apply(state, _mutate_tile_size_recs(
        [s.to_record() for s in state.transform_steps], rng, max_innermost))


def mutate_parallel(state: State, task: SearchTask,
                    rng: random.Random) -> Optional[State]:
    """Re-sample the outer fuse+parallel granularity of a root stage
    (MutateParallel, sketch_policy_rules.cc:1118)."""
    return _apply(state, _mutate_parallel_recs(
        [s.to_record() for s in state.transform_steps], rng))


def mutate_auto_unroll(state: State, task: SearchTask,
                       rng: random.Random) -> Optional[State]:
    """Re-draw one auto_unroll_max_step pragma (MutateAutoUnroll)."""
    return _apply(state, _mutate_auto_unroll_recs(
        [s.to_record() for s in state.transform_steps], task.is_gpu, rng))


# The mutations on step records: one implementation for both GA paths (the
# same RNG stream). A child shares every step record but the mutated one
# with its parent, by reference, which the native GA's encoder caches on.


def _mutate_tile_size_recs(recs: List[list], rng: random.Random,
                           max_innermost: int = 64) -> Optional[List[list]]:
    split_ids = []
    for i, r in enumerate(recs):
        if r[0] != "SP":
            continue
        extent, lengths = r[3], r[4]
        if not extent or any(l is None for l in lengths):
            continue
        if (lengths[-1] if lengths else 1) > max_innermost:
            continue
        split_ids.append(i)
    if not split_ids:
        return None
    for _ in range(4 * len(split_ids)):
        step_id = rng.choice(split_ids)
        _, stage_id, iter_id, extent, lens, ito = recs[step_id]
        if extent and extent > 1:
            break
    else:
        return None

    lengths = [1] + list(lens)
    prod = 1
    for l in lens:
        prod *= l
    lengths[0] = extent // prod if prod else extent

    perm = list(range(len(lengths)))
    rng.shuffle(perm)
    for i, src_idx in enumerate(perm):
        length = lengths[src_idx]
        if length <= 1:
            continue
        dst_idx = perm[(i + 1) % len(perm)]
        factors = [d for d in _divisors(length) if d >= 2]
        if dst_idx == len(lengths) - 1:
            factors = [
                f for f in factors if f * lengths[dst_idx] <= max_innermost
            ]
        if not factors:
            continue
        divide = rng.choice(factors)
        new_lengths = list(lengths)
        new_lengths[src_idx] = lengths[src_idx] // divide
        new_lengths[dst_idx] = lengths[dst_idx] * divide
        out = list(recs)
        out[step_id] = ["SP", stage_id, iter_id, extent, new_lengths[1:],
                        ito]
        return out
    return None


def _mutate_parallel_recs(recs: List[list],
                          rng: random.Random) -> Optional[List[list]]:
    """Find a trailing FuseStep whose fused iterator is parallel-annotated
    and change the number of fused outer iterators."""
    for i in range(len(recs) - 1, 0, -1):
        r = recs[i]
        if not (r[0] == "AN" and r[3] == 3):
            continue
        prev = recs[i - 1]
        if not (prev[0] == "FU" and prev[1] == r[1]
                and r[2] == prev[2][0]):
            continue
        n_old = len(prev[2])
        n_new = rng.choice([n for n in (1, 2, 3, 4) if n != n_old])
        base = prev[2][0]
        out = list(recs)
        if n_new == 1:
            out[i - 1:i + 1] = [["AN", r[1], base, 3]]
        else:
            out[i - 1] = ["FU", prev[1], list(range(base, base + n_new))]
        return out
    return None


def _mutate_auto_unroll_recs(recs: List[list], is_gpu: bool,
                             rng: random.Random) -> Optional[List[list]]:
    pragma_ids = [
        i for i, r in enumerate(recs)
        if r[0] == "PR" and isinstance(r[3], str)
        and r[3].startswith("auto_unroll_max_step")
    ]
    if not pragma_ids:
        return None
    cands = (
        AUTO_UNROLL_CANDIDATES_GPU if is_gpu else AUTO_UNROLL_CANDIDATES_CPU
    )
    step_id = rng.choice(pragma_ids)
    out = list(recs)
    out[step_id] = ["PR", recs[step_id][1], recs[step_id][2],
                    f"auto_unroll_max_step${rng.choice(cands)}"]
    return out


# ---------------------------------------------------------------------------
# Cost models for generation
# ---------------------------------------------------------------------------


def _parent_probs(scores: np.ndarray) -> np.ndarray:
    """Prefix-sum parent-selection distribution over raw scores; -inf
    (unlowerable) scores get zero weight and non-finite sums degrade to
    uniform."""
    w = np.where(np.isfinite(scores), scores, -np.inf)
    finite = w[np.isfinite(w)]
    lo = finite.min() if finite.size else 0.0
    w = np.where(np.isfinite(w), w - lo + 1e-6, 0.0)
    tot = w.sum()
    if not np.isfinite(tot) or tot <= 0:
        w = np.ones_like(w)
        tot = w.sum()
    return np.cumsum(w / tot)


class PythonCostModel:
    """Interface parity: cost_model/cost_model.py PythonBasedModel."""

    def update(self, inputs, results):
        pass

    def predict(self, task: SearchTask, states: Sequence[State]) -> np.ndarray:
        raise NotImplementedError


class RandomCostModel(PythonCostModel):
    # scores never read the feature rows: the native GA may skip feature
    # emission entirely (keys and validity only)
    feature_free = True

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def predict(self, task, states):
        return self.rng.random(len(states)).astype(np.float32)

    def predict_on_feature_list(self, task, feats):
        return self.rng.random(len(feats)).astype(np.float32)


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------


class SketchPolicy:
    """CPU/GPU sketch policy over our schedule IR.

    Parameters follow SketchPolicy.DEFAULT_PARAMS
    (python search_policy.py:179-210)."""

    def __init__(self, task: SearchTask, cost_model: PythonCostModel = None,
                 params: Optional[Dict] = None, seed: int = 2023,
                 verbose: int = 0):
        self.task = task
        self.cost_model = cost_model or RandomCostModel(seed)
        self.params = {
            "evolutionary_search_population": 2048,
            "evolutionary_search_num_iters": 4,
            "evolutionary_search_mutation_prob": 0.85,
            "sample_init_min_population": 50,
            "max_innermost_split_factor": 64,
            "eps_greedy": 0.05,
        }
        self.params.update(params or {})
        self.rng = random.Random(seed)
        self.verbose = verbose
        self.sketches = generate_sketches(task, seed)
        self.measured_state_keys = set()

    def sample_initial_population(self, num: Optional[int] = None) -> List[State]:
        num = num or self.params["sample_init_min_population"]
        out, seen = [], set()
        tries = 0
        max_inner = self.params["max_innermost_split_factor"]
        while len(out) < num and tries < num * 20:
            tries += 1
            sketch = self.rng.choice(self.sketches)
            try:
                st = init_fill_tile_size(sketch, self.rng, max_inner)
                if self.task.is_gpu:
                    # GPU init rules: FillTileSize -> ThreadBind -> Unroll
                    # (sketch_policy.cc:128-147)
                    st = init_thread_bind(st, self.task, self.rng)
                    st = init_unroll(st, self.task, self.rng)
                    st = self.task.compute_dag.infer_bound(st)
                else:
                    st = init_change_compute_location(st, self.task,
                                                      self.rng)
                    st = init_parallel(st, self.task, self.rng)
                    st = init_unroll(st, self.task, self.rng)
                    st = self.task.compute_dag.infer_bound(st)
                    st = init_vectorization(st, self.task, self.rng)
                key = st.to_str()
            except Exception:
                continue
            if key in seen:
                continue
            seen.add(key)
            out.append(st)
        return out

    def evolutionary_search(self, init_population: List[State],
                            out_size: int) -> List[State]:
        """Cost-model-scored GA (sketch_policy.cc:487-624): keep a heap of
        the best unique states; parents sampled by prefix-sum probability
        over scores; mutations only (no crossover). The generation batches
        (replay, dedup keys, 164-dim features) run in the host library
        unless ``_evolutionary_search_native`` declines the population."""
        if not init_population:
            return []
        native = self._evolutionary_search_native(init_population,
                                                  out_size)
        if native is not None:
            return native
        population = self.params["evolutionary_search_population"]
        iters = self.params["evolutionary_search_num_iters"]
        mut_prob = self.params["evolutionary_search_mutation_prob"]

        heap: List[Tuple[float, int, State]] = []  # (score, tiebreak, state)
        in_heap = set()
        counter = 0

        def push(states, scores):
            nonlocal counter
            for st, sc in zip(states, scores):
                key = st.to_str()
                if key in in_heap:
                    continue
                if len(heap) < out_size:
                    heapq.heappush(heap, (float(sc), counter, st))
                    in_heap.add(key)
                    counter += 1
                elif sc > heap[0][0]:
                    heapq.heappushpop(heap, (float(sc), counter, st))
                    in_heap.add(key)
                    counter += 1

        cur = list(init_population)
        scores = np.asarray(self.cost_model.predict(self.task, cur))
        push(cur, scores)
        for _ in range(iters):
            # parent selection by prefix-sum probability over raw scores
            probs = _parent_probs(scores)
            nxt = []
            while len(nxt) < min(population, 4 * max(1, len(cur))):
                parent = cur[
                    min(int(np.searchsorted(probs, self.rng.random())),
                        len(cur) - 1)
                ]
                if self.rng.random() < mut_prob:
                    # mutation weights mirror sketch_policy.cc:113-152
                    # (CPU: tile .90 / unroll .04 / compute-location .05 /
                    # parallel .01; GPU: tile .90 / unroll .10)
                    r = self.rng.random()
                    if self.task.is_gpu:
                        if r < 0.90:
                            child = mutate_tile_size(
                                parent, self.rng,
                                self.params["max_innermost_split_factor"],
                            )
                        else:
                            child = mutate_auto_unroll(parent, self.task,
                                                       self.rng)
                    elif r < 0.90:
                        child = mutate_tile_size(
                            parent, self.rng,
                            self.params["max_innermost_split_factor"],
                        )
                    elif r < 0.94:
                        child = mutate_auto_unroll(parent, self.task, self.rng)
                    elif r < 0.99:
                        child = mutate_compute_location(parent, self.task,
                                                        self.rng)
                    else:
                        child = mutate_parallel(parent, self.task, self.rng)
                    if child is not None:
                        nxt.append(child)
                else:
                    nxt.append(parent)
                if len(nxt) >= len(cur) * 4:
                    break
            try:
                nxt = [self.task.compute_dag.infer_bound(s)
                       if s.stages[0].iters and s.stages[-1].iters
                       and s.stages[-1].iters[0].range is None else s
                       for s in nxt]
            except Exception:
                pass
            cur = nxt
            scores = np.asarray(self.cost_model.predict(self.task, cur))
            push(cur, scores)

        best = sorted(heap, key=lambda t: -t[0])
        return [st for _, _, st in best]

    def _evolutionary_search_native(self, init_population: List[State],
                                    out_size: int) -> Optional[List[State]]:
        """The record-level GA on States: None where it declines (see
        ``_evolutionary_search_native_recs``)."""
        cur_recs = [[st_.to_record() for st_ in s.transform_steps]
                    for s in init_population]
        res = self._evolutionary_search_native_recs(cur_recs, out_size)
        if res is None:
            return None
        out = []
        for recs in res[0]:
            try:
                out.append(self.task.compute_dag.apply_steps(recs))
            except Exception:
                continue
        return out

    def _evolutionary_search_native_recs(
            self, cur_recs: List[list], out_size: int
    ) -> Optional[Tuple[List[list], List[int]]]:
        """Record-level native GA: candidates live as serialized
        transform-step records end to end (replay, dedup keys and
        features all native); Python States are built only for the 5%
        compute-location mutations. Returns (step-record lists, native
        dedup keys) sorted by score descending, or None where the JAX
        package's GA declines too, each counted in ``fast_parser.
        FALLBACKS``: a cost model without ``predict_on_feature_list`` (or
        whose ``predict`` comes from another class), or a first batch of
        which the native side replays no record (rfactor sketches)."""
        from ..records.fast_parser import (
            count_fallback,
            featurize_perstore_records_native,
            make_encode_ctx,
        )

        score_fn = getattr(self.cost_model, "predict_on_feature_list", None)

        # a subclass overriding predict() but inheriting
        # predict_on_feature_list would be scored inconsistently: both
        # methods must come from the same class
        def _definer(name):
            for c in type(self.cost_model).__mro__:
                if name in c.__dict__:
                    return c
            return None

        if score_fn is None or (_definer("predict")
                                is not _definer("predict_on_feature_list")):
            count_fallback("ga:no_feature_predict")
            return None
        encode_ctx = make_encode_ctx()

        population = self.params["evolutionary_search_population"]
        iters = self.params["evolutionary_search_num_iters"]
        mut_prob = self.params["evolutionary_search_mutation_prob"]
        max_inner = self.params["max_innermost_split_factor"]
        is_gpu = self.task.is_gpu
        # feature-free models (RandomCostModel pool generation) let the
        # native pass skip store building and feature emission, about
        # half the per-candidate native cost
        with_features = not getattr(self.cost_model, "feature_free", False)

        def featurize(recs_list):
            feats, keys, status = featurize_perstore_records_native(
                self.task, recs_list, encode_ctx=encode_ctx,
                with_features=with_features)
            # status 1 (an rfactor step) is dropped, as the JAX GA does
            count_fallback("ga:status1_dropped", (status == 1).sum())
            keep, kfeats, kkeys = [], [], []
            for i, recs in enumerate(recs_list):
                if status[i] == 0:
                    keep.append(recs)
                    kfeats.append(feats[i])
                    kkeys.append(int(keys[i]))
            return keep, kfeats, kkeys

        heap: List[tuple] = []  # (score, tiebreak, key, recs)
        in_heap = set()
        counter = 0

        def push(recs_list, keys, scores):
            nonlocal counter
            for recs, key, sc in zip(recs_list, keys, scores):
                if key in in_heap:
                    continue
                if len(heap) < out_size:
                    heapq.heappush(heap, (float(sc), counter, key, recs))
                    in_heap.add(key)
                    counter += 1
                elif sc > heap[0][0]:
                    heapq.heappushpop(heap, (float(sc), counter, key, recs))
                    in_heap.add(key)
                    counter += 1

        cur, feats, keys = featurize(cur_recs)
        if not cur:
            count_fallback("ga:no_native_record")
            return None
        scores = np.asarray(score_fn(self.task, feats))
        push(cur, keys, scores)

        for _ in range(iters):
            probs = _parent_probs(scores)
            nxt = []
            while len(nxt) < min(population, 4 * max(1, len(cur))):
                parent = cur[
                    min(int(np.searchsorted(probs, self.rng.random())),
                        len(cur) - 1)
                ]
                if self.rng.random() < mut_prob:
                    # the State GA's mutation weights (see evolutionary_search)
                    r = self.rng.random()
                    if is_gpu:
                        if r < 0.90:
                            child = _mutate_tile_size_recs(parent, self.rng,
                                                           max_inner)
                        else:
                            child = _mutate_auto_unroll_recs(parent, is_gpu,
                                                             self.rng)
                    elif r < 0.90:
                        child = _mutate_tile_size_recs(parent, self.rng,
                                                       max_inner)
                    elif r < 0.94:
                        child = _mutate_auto_unroll_recs(parent, is_gpu,
                                                         self.rng)
                    elif r < 0.99:
                        # compute-location needs stage structure: replay
                        # the parent in Python for this 5% of mutations
                        child = None
                        try:
                            pst = self.task.compute_dag.apply_steps(parent)
                            cst = mutate_compute_location(pst, self.task,
                                                          self.rng)
                            if cst is not None:
                                child = [s_.to_record()
                                         for s_ in cst.transform_steps]
                        except Exception:
                            child = None
                    else:
                        child = _mutate_parallel_recs(parent, self.rng)
                    if child is not None:
                        nxt.append(child)
                else:
                    nxt.append(parent)
                if len(nxt) >= len(cur) * 4:
                    break
            cur, feats, keys = featurize(nxt)
            if not cur:
                break
            scores = np.asarray(score_fn(self.task, feats))
            push(cur, keys, scores)

        best = sorted(heap, key=lambda t: -t[0])
        return [t[3] for t in best], [t[2] for t in best]

    def _measured_key(self, st: State) -> str:
        """Canonical dedup key: the bound state's printed form (candidate
        states arrive both bound and unbound depending on the path)."""
        try:
            return self.task.compute_dag.infer_bound(st).to_str()
        except Exception:
            return st.to_str()

    def preload_measured_states(self, log_path: str) -> int:
        """Mark states recorded for this task as already measured so
        pick_states_eps_greedy never re-measures them (reference
        PreloadMeasuredStates init callback + TaskScheduler restore).
        Returns how many of the log's records belong to this task."""
        import os

        from ..records import iter_records

        if not os.path.exists(log_path):
            return 0
        n = 0
        for rec in iter_records(log_path):
            if rec.inp.task.workload_key != self.task.workload_key:
                continue
            try:
                st = self.task.compute_dag.apply_steps(
                    rec.inp.step_records
                )
                self.measured_state_keys.add(self._measured_key(st))
                n += 1
            except Exception:
                continue
        return n

    def continue_search_one_round(self, num_measure: int) -> List[State]:
        """One search round: sample init population -> evolutionary search
        -> eps-greedy pick (SketchPolicyNode::ContinueSearchOneRound,
        sketch_policy.cc:242-283; measurement happens in the caller)."""
        init_pop = self.sample_initial_population()
        if not init_pop:
            return []
        best_states = self.evolutionary_search(init_pop, num_measure * 2)
        random_states = self.sample_initial_population(num_measure)
        picked = self.pick_states_eps_greedy(best_states, random_states,
                                             num_measure)
        out = []
        for st in picked:
            try:
                out.append(self.task.compute_dag.infer_bound(st))
            except Exception:
                continue
        return out

    def pick_states_eps_greedy(self, best_states: List[State],
                               random_states: List[State],
                               num_measure: int) -> List[State]:
        """Interleave best and eps-greedy random picks, dedup vs measured
        (sketch_policy.cc:626-667)."""
        num_rand = int(num_measure * self.params["eps_greedy"])
        inputs = []
        bi = ri = 0
        while len(inputs) < num_measure:
            if len(inputs) < num_measure - num_rand and bi < len(best_states):
                st = best_states[bi]
                bi += 1
            elif ri < len(random_states):
                st = random_states[ri]
                ri += 1
            else:
                break
            key = self._measured_key(st)
            if key not in self.measured_state_keys:
                self.measured_state_keys.add(key)
                inputs.append(st)
        return inputs


def _make_pool_policy(task, evo_population, min_population, seed):
    return SketchPolicy(
        task,
        RandomCostModel(seed),
        params={
            "evolutionary_search_num_iters": 4,
            "evolutionary_search_population": evo_population,
            "sample_init_min_population": min_population,
        },
        seed=seed,
    )


def make_state_records(task: SearchTask, size: int,
                       evo_population: int = 512,
                       min_population: int = 50,
                       seed: int = 2023) -> Optional[List[list]]:
    """Record-level candidate-pool generation: the make_states loop with
    candidates kept as serialized step records and deduped by the native
    featurizer's keys; no Python State is built but the initial
    population's. Returns None where the native GA declines (callers then
    run make_states' State loop)."""
    policy = _make_pool_policy(task, evo_population, min_population, seed)
    init = policy.sample_initial_population(min_population)
    if not init:
        return None
    cur_recs = [[st_.to_record() for st_ in s.transform_steps]
                for s in init]
    res = policy._evolutionary_search_native_recs(cur_recs, size)
    if res is None:
        return None
    seen: Dict[int, list] = {}
    for r, k in zip(*res):
        seen.setdefault(k, r)
    rounds = 1
    while len(seen) < size and rounds < 50:
        rounds += 1
        pool = list(seen.values())[-min(len(seen), evo_population):]
        res = policy._evolutionary_search_native_recs(pool, size)
        if res is None or not res[0]:
            break
        for r, k in zip(*res):
            seen.setdefault(k, r)
    return list(seen.values())[:size]


def make_states(task: SearchTask, size: int, evo_population: int = 512,
                min_population: int = 50, seed: int = 2023) -> List[State]:
    """Candidate-pool generation (reference vae_experiments/tuning.py:9-62
    make_states: sample + evolutionary until `size` unique states).

    Runs the record-level native loop (``make_state_records``) and builds
    the States once at the end, bound; the State-level loop below where
    the native GA declines."""
    recs_list = make_state_records(task, size, evo_population,
                                   min_population, seed)
    if recs_list is not None:
        out = []
        for recs in recs_list:
            try:
                # bound inference so compute-at extents match what a
                # record round-trip (recover_state) sees: consumers
                # (AnalyticRunner, extent featurization) read extents
                out.append(task.compute_dag.infer_bound(
                    task.compute_dag.apply_steps(recs)))
            except Exception:
                continue
        return out
    policy = _make_pool_policy(task, evo_population, min_population, seed)
    states = policy.sample_initial_population(min_population)
    seen = {s.to_str(): s for s in states}
    rounds = 0
    while len(seen) < size and rounds < 50:
        rounds += 1
        more = policy.evolutionary_search(states, size)
        for s in more:
            seen.setdefault(s.to_str(), s)
        states = list(seen.values())[-min(len(seen), evo_population):]
    return list(seen.values())[:size]
