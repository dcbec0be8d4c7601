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

A copy of ``vae_extent_search_tpu/search/sketch.py`` with the State-level
Python GA only (``SketchPolicy.sample_initial_population``,
``evolutionary_search``, ``make_states``): the JAX package's native (C++)
record-level GA and ``make_state_records`` which drives it have no
counterpart here, so ``make_states`` always runs the Python loop; the
measure-round methods (``continue_search_one_round`` and its eps-greedy
pick) serve ``records/dispatcher.py``. Only the CPU-target rules are kept
(the self-tuning path samples its schedule space from an ``llvm`` task);
the GPU-target rules (thread binding, shared-memory cache reads,
cross-thread reduction) are not ported, and a GPU task is refused.
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
# Sketch generation (CPU rule set v1)
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


def _generate_main_sketch(task: SearchTask, use_rfactor: bool = False,
                          fuse_level: int = None,
                          fuse_consumer: bool = True,
                          rfactor_inner: bool = True) -> State:
    """One CPU sketch: AlwaysInline for strictly inlineable non-output
    stages; for tilable stages MultiLevelTilingWithFusion (or AddCacheWrite
    when no fusible consumer exists — the cache copy becomes the
    consumer); optionally the AddRfactor alternative for reduction-heavy
    small-spatial stages (sketch_policy.cc:96-104 rule order)."""
    dag = task.compute_dag
    analysis = AccessAnalysis(dag)
    structure = "SSRSRS"
    n_split = fuse_level if fuse_level is not None else 2

    st = dag.init_state.copy()
    st.tiled_stage_split_ids = {}  # op name -> spatial split step ids
    stage_id = len(st.stages) - 1
    while stage_id >= 0:
        stage = st.stages[stage_id]
        op = stage.op
        if isinstance(op, PlaceholderOp) or stage.compute_at == AT_INLINED:
            stage_id -= 1
            continue
        uid = op.uid
        if analysis.is_strictly_inlineable.get(uid) \
                and not analysis.is_output.get(uid):
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
            if op.reduce_axes and use_rfactor and _needs_rfactor(
                    op, analysis, task.hardware_params):
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
            st.cache_write(stage_id, "global")
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
        stage_id -= 1
    return st


def generate_sketches(task: SearchTask, seed: int = 0) -> List[State]:
    """All sketch variants for the task (the reference's rule BFS yields
    multiple sketches; we enumerate the rule alternatives explicitly):
    one per consumer-fusion level (CPU levels {1, 2} — the reference's
    follow_tiling_levels), the plain multi-level tiling, and the rfactor
    alternatives when a small-spatial reduction qualifies."""
    levels = [2, 1]
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
    # the plain (unfused) multi-level-tiling variant — CPU's
    # RuleMultiLevelTilingWithFusion is kApply, so the reference's BFS also
    # reaches plain RuleMultiLevelTiling
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
    # the rfactor alternatives when some stage qualifies (the reference's
    # AddRfactor condition); AddRfactor emits BOTH split-part variants
    # (outer and inner-with-reorder, sketch_policy_rules.cc:248-300)
    _an = AccessAnalysis(dag)
    has_small_reduce = any(
        isinstance(op, ComputeOp)
        and _needs_rfactor(op, _an, task.hardware_params)
        for op in dag.ops
    )
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
    for sid, stage in enumerate(state.stages):
        if stage.op_type == "placeholder" or stage.compute_at == AT_INLINED:
            continue
        if isinstance(stage.op, ComputeOp) and stage.op.reduce_axes:
            v = rng.choice(AUTO_UNROLL_CANDIDATES_CPU)
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
    recs = [s.to_record() for s in state.transform_steps]
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
        recs[step_id] = ["SP", stage_id, iter_id, extent, new_lengths[1:],
                         ito]
        return _apply(state, recs)
    return None


def mutate_parallel(state: State, task: SearchTask,
                    rng: random.Random) -> Optional[State]:
    """Re-sample the outer fuse+parallel granularity of a root stage
    (MutateParallel, sketch_policy_rules.cc:1118): find a trailing
    FuseStep whose fused iterator is parallel-annotated and change the
    number of fused outer iterators."""
    recs = [s.to_record() for s in state.transform_steps]
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
        if n_new == 1:
            recs[i - 1:i + 1] = [["AN", r[1], base, 3]]
        else:
            recs[i - 1] = ["FU", prev[1], list(range(base, base + n_new))]
        return _apply(state, recs)
    return None


def mutate_auto_unroll(state: State, task: SearchTask,
                       rng: random.Random) -> Optional[State]:
    """Re-draw one auto_unroll_max_step pragma (MutateAutoUnroll)."""
    recs = [s.to_record() for s in state.transform_steps]
    pragma_ids = [
        i for i, r in enumerate(recs)
        if r[0] == "PR" and isinstance(r[3], str)
        and r[3].startswith("auto_unroll_max_step")
    ]
    if not pragma_ids:
        return None
    step_id = rng.choice(pragma_ids)
    recs[step_id] = ["PR", recs[step_id][1], recs[step_id][2],
                     "auto_unroll_max_step$"
                     f"{rng.choice(AUTO_UNROLL_CANDIDATES_CPU)}"]
    return _apply(state, recs)


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
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def predict(self, task, states):
        return self.rng.random(len(states)).astype(np.float32)


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------


class SketchPolicy:
    """CPU sketch policy over our schedule IR.

    Parameters follow SketchPolicy.DEFAULT_PARAMS
    (python search_policy.py:179-210)."""

    def __init__(self, task: SearchTask, cost_model: PythonCostModel = None,
                 params: Optional[Dict] = None, seed: int = 2023,
                 verbose: int = 0):
        if task.is_gpu:
            raise ValueError(f"target {task.target!r}: only CPU-target "
                             "sketch rules are ported")
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
                st = init_change_compute_location(st, self.task, self.rng)
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
        over scores; mutations only (no crossover)."""
        if not init_population:
            return []
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
                    # mutation weights mirror sketch_policy.cc:113-126
                    # (tile .90 / unroll .04 / compute-location .05 /
                    # parallel .01)
                    r = self.rng.random()
                    if r < 0.90:
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

    def _measured_key(self, st: State) -> str:
        """Canonical dedup key: the bound state's printed form (candidate
        states arrive both bound and unbound depending on the path)."""
        try:
            return self.task.compute_dag.infer_bound(st).to_str()
        except Exception:
            return st.to_str()

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


def make_states(task: SearchTask, size: int, evo_population: int = 512,
                min_population: int = 50, seed: int = 2023) -> List[State]:
    """Candidate-pool generation (reference vae_experiments/tuning.py:9-62
    make_states: sample + evolutionary until `size` unique states).

    The JAX package runs its native record-level GA here when its library
    is built; the port always runs this State-level loop, which is the
    JAX package's own path without that library."""
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
