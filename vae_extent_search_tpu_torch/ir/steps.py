"""The 14 Ansor transform-step kinds: apply-to-state + record serialization.

Parity targets (behavior verified against the reference TVM fork):
- record keys and field order: src/auto_scheduler/transform_step.cc
  (WriteToRecord per step; prefixes AN/FU/PR/RE/SP/FSP/FFSP/SA/CA/CI/CR/
  CHR/CHW/RF, include/tvm/auto_scheduler/transform_step.h:283-1166)
- apply-to-state semantics: transform_step.cc ApplyToState methods
  (split math transform_step.cc:820-900; fuse :490-580; cache read/write
  :1545-1700; rfactor :1784-1810).

Implementation is our own: steps mutate our Python ``State`` and log binary
split/fuse relations per stage for the demand-driven bound inference.
"""

from __future__ import annotations

import math
from typing import List, Optional

from . import state as S
from .state import (
    AT_INLINED,
    AT_ITER,
    AT_ROOT,
    ANNOTATION_NONE,
    KIND_MIXED,
    Iterator,
    Relation,
    Stage,
    State,
)


class Step:
    KEY = "?"
    stage_id: int

    def to_record(self) -> list:
        raise NotImplementedError

    def apply_to_state(self, st: State):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}{tuple(self.to_record()[1:])}"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _apply_split_common(st: State, stage_id: int, iter_id: int,
                        lengths: List[Optional[int]], inner_to_outer: bool):
    """Shared split application (reference ApplySplitToState,
    transform_step.cc:820-900): computes the new iterators, updates the
    attach map, and records binary split relations mirroring how
    te.split / te.split_by_nparts chain up for PassDownDomain."""
    stage = st.stages[stage_id].shallow_copy()
    it = stage.iters[iter_id]
    old_iter_size = len(stage.iters)
    concrete = True

    if it.range is not None:
        # the extent may be a symbolic Expr (data-dependent loops); te keeps
        # it symbolic: defined inner factors get concrete ranges, the
        # remaining part a symbolic ceildiv extent (transform_step.cc
        # ApplySplitToState: "Extent can be a irreducible expression")
        tosplit_min, tosplit_extent = it.range
    else:
        tosplit_min = tosplit_extent = None

    outs: List[Iterator] = []
    for i in range(len(lengths)):
        if inner_to_outer:
            l = lengths[len(lengths) - 1 - i]
            name = f"{it.name}.{len(lengths) - i}"
        else:
            l = lengths[i]
            name = f"{it.name}.{i}"
        if l is not None and tosplit_min is not None and tosplit_extent is not None:
            res = Iterator(name, (tosplit_min, l), it.kind, ANNOTATION_NONE)
            tosplit_min = 0
            if isinstance(tosplit_extent, int):
                tosplit_extent = _ceil_div(tosplit_extent, l)
            elif l != 1:
                tosplit_extent = (tosplit_extent + (l - 1)) // l
        else:
            res = Iterator(name, None, it.kind, ANNOTATION_NONE)
            tosplit_min = tosplit_extent = None
            if l is None:
                concrete = False
        outs.append(res)

    rng = None
    if tosplit_min is not None and tosplit_extent is not None:
        rng = (tosplit_min, tosplit_extent)
    if inner_to_outer:
        outs.append(Iterator(f"{it.name}.0", rng, it.kind, ANNOTATION_NONE))
        outs = outs[::-1]
    else:
        outs.append(
            Iterator(f"{it.name}.{len(lengths)}", rng, it.kind, ANNOTATION_NONE)
        )

    # Record the binary relation chain for bound inference.
    # inner_to_outer (te split by factor, innermost factor first):
    #   split(P, f=l[k-1]) -> (t, outs[k]); split(t, f=l[k-2]) -> (t', outs[k-1]);
    #   ... ; split(t'', f=l[0]) -> (outs[0], outs[1])
    # by nparts: split_by_nparts(P, n=l[0]) -> (outs[0], t); ... ->
    #   (outs[k-1], outs[k])
    k = len(lengths)
    if inner_to_outer:
        cur_parent = it.uid
        for j in range(k - 1, 0, -1):
            tmp_uid = S._fresh_iter_uid()
            stage.relations.append(
                Relation("split", parent=cur_parent, outer=tmp_uid,
                         inner=outs[j + 1].uid, factor=lengths[j],
                         by_nparts=False)
            )
            cur_parent = tmp_uid
        stage.relations.append(
            Relation("split", parent=cur_parent, outer=outs[0].uid,
                     inner=outs[1].uid, factor=lengths[0], by_nparts=False)
        )
    else:
        cur_parent = it.uid
        for j in range(k):
            inner_uid = outs[j + 1].uid if j == k - 1 else S._fresh_iter_uid()
            stage.relations.append(
                Relation("split", parent=cur_parent, outer=outs[j].uid,
                         inner=inner_uid, factor=lengths[j], by_nparts=True)
            )
            cur_parent = inner_uid

    stage.iters = (
        stage.iters[:iter_id] + outs + stage.iters[iter_id + 1:]
    )
    st.stages[stage_id] = stage
    st.concrete = st.concrete and concrete

    from_iters = [(stage_id, i) for i in range(iter_id, old_iter_size)]
    to_iters = [(stage_id, i + len(lengths)) for i in range(iter_id, old_iter_size)]
    st.attach_map.update_iters(from_iters, to_iters)
    return outs


class AnnotationStep(Step):
    KEY = "AN"

    def __init__(self, stage_id, iter_id, annotation):
        self.stage_id, self.iter_id, self.annotation = stage_id, iter_id, annotation

    def to_record(self):
        return [self.KEY, self.stage_id, self.iter_id, self.annotation]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3])

    def apply_to_state(self, st: State):
        stage = st.stages[self.stage_id].shallow_copy()
        it = stage.iters[self.iter_id]
        assert it.annotation == ANNOTATION_NONE, "re-annotating an iterator"
        stage.iters[self.iter_id] = it.with_annotation(self.annotation)
        st.stages[self.stage_id] = stage
        return stage.iters[self.iter_id]


class FuseStep(Step):
    KEY = "FU"

    def __init__(self, stage_id, fused_ids):
        self.stage_id = stage_id
        self.fused_ids = list(fused_ids)

    def to_record(self):
        return [self.KEY, self.stage_id, list(self.fused_ids)]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2])

    def apply_to_state(self, st: State):
        stage = st.stages[self.stage_id].shallow_copy()
        old_iter_size = len(stage.iters)

        new_name = ""
        new_extent = 1
        new_kind = None
        orig_iters = []
        for i, fid in enumerate(self.fused_ids):
            if i > 0:
                assert fid == self.fused_ids[i - 1] + 1, "fuse ids must be consecutive"
            if i != len(self.fused_ids) - 1:
                if (self.stage_id, fid) in st.attach_map.iter_to_attached_stages:
                    raise ValueError(
                        "invalid fuse: iterator has attached stages"
                    )
            it = stage.iters[fid]
            orig_iters.append(it)
            new_name += it.name + "@"
            if it.range is not None and new_extent is not None:
                new_extent *= it.range[1]
            else:
                new_extent = None
            if i == 0:
                new_kind = it.kind
            elif new_kind != it.kind:
                new_kind = KIND_MIXED

        rng = (0, new_extent) if new_extent is not None else None
        new_it = Iterator(new_name, rng, new_kind, ANNOTATION_NONE, orig_iters)

        # binary fuse relation chain (outer-to-inner, te fuse semantics)
        if len(orig_iters) >= 2:
            cur = orig_iters[0].uid
            for j in range(1, len(orig_iters)):
                fused_uid = (
                    new_it.uid if j == len(orig_iters) - 1 else S._fresh_iter_uid()
                )
                stage.relations.append(
                    Relation("fuse", outer=cur, inner=orig_iters[j].uid,
                             fused=fused_uid)
                )
                cur = fused_uid
        elif len(orig_iters) == 1:
            # degenerate fuse of one iterator: alias via a 1-part split
            stage.relations.append(
                Relation("fuse", outer=orig_iters[0].uid, inner=None,
                         fused=new_it.uid)
            )

        if not self.fused_ids:
            stage.iters = [new_it]
        else:
            b, e = self.fused_ids[0], self.fused_ids[-1]
            stage.iters = stage.iters[:b] + [new_it] + stage.iters[e + 1:]
        st.stages[self.stage_id] = stage

        if self.fused_ids:
            b, e = self.fused_ids[0], self.fused_ids[-1]
            from_iters, to_iters = [], []
            for i in range(old_iter_size):
                if i <= b:
                    continue
                elif i > e:
                    from_iters.append((self.stage_id, i))
                    to_iters.append((self.stage_id, i - e + b))
                else:
                    from_iters.append((self.stage_id, i))
                    to_iters.append((self.stage_id, b))
            st.attach_map.update_iters(from_iters, to_iters)
        return new_it


class PragmaStep(Step):
    KEY = "PR"

    def __init__(self, stage_id, iter_id, pragma_type):
        self.stage_id, self.iter_id, self.pragma_type = stage_id, iter_id, pragma_type

    def to_record(self):
        return [self.KEY, self.stage_id, self.iter_id, self.pragma_type]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3])

    def apply_to_state(self, st: State):
        if self.pragma_type == "debug_skip_region":
            st.attach_map.delete_stage(self.stage_id)
        elif self.pragma_type.startswith("auto_unroll_max_step"):
            stage = st.stages[self.stage_id].shallow_copy()
            val = int(self.pragma_type.split("$")[1])
            stage.attrs.auto_unroll_max_step = val
            st.stages[self.stage_id] = stage
        else:
            raise ValueError(f"unsupported pragma: {self.pragma_type}")


class ReorderStep(Step):
    KEY = "RE"

    def __init__(self, stage_id, after_ids):
        self.stage_id = stage_id
        self.after_ids = list(after_ids)

    def to_record(self):
        return [self.KEY, self.stage_id, list(self.after_ids)]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2])

    def apply_to_state(self, st: State):
        stage = st.stages[self.stage_id].shallow_copy()
        stage.iters = [stage.iters[x] for x in self.after_ids]
        st.stages[self.stage_id] = stage


class SplitStep(Step):
    KEY = "SP"

    def __init__(self, stage_id, iter_id, extent, lengths, inner_to_outer):
        self.stage_id, self.iter_id = stage_id, iter_id
        self.extent = extent  # informational; 0 when unknown
        self.lengths = list(lengths)
        self.inner_to_outer = bool(inner_to_outer)

    def to_record(self):
        return [self.KEY, self.stage_id, self.iter_id, self.extent or 0,
                list(self.lengths), int(self.inner_to_outer)]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3], rec[4], rec[5])

    def apply_to_state(self, st: State):
        return _apply_split_common(st, self.stage_id, self.iter_id,
                                   self.lengths, self.inner_to_outer)


class FollowSplitStep(Step):
    KEY = "FSP"

    def __init__(self, stage_id, iter_id, src_step_id, n_split):
        self.stage_id, self.iter_id = stage_id, iter_id
        self.src_step_id, self.n_split = src_step_id, n_split

    def to_record(self):
        return [self.KEY, self.stage_id, self.iter_id, self.src_step_id,
                self.n_split]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3], rec[4])

    def extract_split_lengths(self, transform_steps):
        """reference transform_step.cc:1059-1096 ExtractSplitLengths"""
        src = transform_steps[self.src_step_id]
        assert isinstance(src, SplitStep)
        assert self.n_split <= len(src.lengths) + 1
        lengths = list(src.lengths[: self.n_split - 1])
        last = 1
        for l in src.lengths[self.n_split - 1:]:
            if l is None:
                last = None
                break
            last *= l
        lengths.append(last)
        return lengths

    def apply_to_state(self, st: State):
        lengths = self.extract_split_lengths(st.transform_steps)
        return _apply_split_common(st, self.stage_id, self.iter_id, lengths, True)


class FollowFusedSplitStep(Step):
    KEY = "FFSP"

    def __init__(self, stage_id, iter_id, src_step_ids, level, factor_or_nparts):
        self.stage_id, self.iter_id = stage_id, iter_id
        self.src_step_ids = list(src_step_ids)
        self.level = level
        self.factor_or_nparts = bool(factor_or_nparts)

    def to_record(self):
        return [self.KEY, self.stage_id, self.iter_id, list(self.src_step_ids),
                self.level, int(self.factor_or_nparts)]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3], rec[4], rec[5])

    def extract_split_length(self, transform_steps):
        """reference transform_step.cc:1178-1195 ExtractSplitLength"""
        ret = 1
        for sid in self.src_step_ids:
            src = transform_steps[sid]
            assert isinstance(src, SplitStep)
            l = src.lengths[self.level]
            if l is None:
                return None
            ret *= l
        return ret

    def apply_to_state(self, st: State):
        length = self.extract_split_length(st.transform_steps)
        return _apply_split_common(st, self.stage_id, self.iter_id, [length],
                                   self.factor_or_nparts)


class StorageAlignStep(Step):
    KEY = "SA"

    def __init__(self, stage_id, iter_id, factor, offset):
        self.stage_id, self.iter_id = stage_id, iter_id
        self.factor, self.offset = factor, offset

    def to_record(self):
        return [self.KEY, self.stage_id, self.iter_id, self.factor, self.offset]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3], rec[4])

    def apply_to_state(self, st: State):
        stage = st.stages[self.stage_id].shallow_copy()
        stage.attrs.storage_offset = self.offset
        st.stages[self.stage_id] = stage


class ComputeAtStep(Step):
    KEY = "CA"

    def __init__(self, stage_id, target_stage_id, target_iter_id):
        self.stage_id = stage_id
        self.target_stage_id, self.target_iter_id = target_stage_id, target_iter_id

    def to_record(self):
        return [self.KEY, self.stage_id, self.target_stage_id,
                self.target_iter_id]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3])

    def apply_to_state(self, st: State):
        stage = st.stages[self.stage_id].shallow_copy()
        # ranges become stale after compute_at (transform_step.cc:1315-1330)
        stage.iters = [it.with_range(None) for it in stage.iters]
        stage.compute_at = AT_ITER
        st.stages[self.stage_id] = stage
        st.attach_map.set_compute_at_iter(
            self.stage_id, self.target_stage_id, self.target_iter_id
        )


class ComputeInlineStep(Step):
    KEY = "CI"

    def __init__(self, stage_id):
        self.stage_id = stage_id

    def to_record(self):
        return [self.KEY, self.stage_id]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1])

    def apply_to_state(self, st: State):
        for i in range(len(st.stages[self.stage_id].iters)):
            if (self.stage_id, i) in st.attach_map.iter_to_attached_stages:
                raise ValueError("invalid compute_inline: stage has attachments")
        stage = st.stages[self.stage_id].shallow_copy()
        stage.compute_at = AT_INLINED
        st.stages[self.stage_id] = stage
        st.attach_map.delete_stage(self.stage_id)


class ComputeRootStep(Step):
    KEY = "CR"

    def __init__(self, stage_id):
        self.stage_id = stage_id

    def to_record(self):
        return [self.KEY, self.stage_id]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1])

    def apply_to_state(self, st: State):
        stage = st.stages[self.stage_id].shallow_copy()
        stage.iters = [it.with_range(None) for it in stage.iters]
        stage.compute_at = AT_ROOT
        st.stages[self.stage_id] = stage
        st.attach_map.delete_stage(self.stage_id)


def _stage_modifiable_steps(current_step, transform_steps):
    """Steps that change the op list, up to current_step (reference
    transform_step.cc:1478-1508 GetFormerStageModifiableSteps)."""
    ret = []
    for i, step in enumerate(transform_steps):
        if isinstance(step, (CacheWriteStep, CacheReadStep)):
            ret.append(step)
        elif isinstance(step, RfactorStep):
            if i >= 2 and isinstance(transform_steps[i - 2], FuseStep):
                if transform_steps[i - 2].stage_id == step.stage_id:
                    ret.append(transform_steps[i - 2])
            assert isinstance(transform_steps[i - 1], SplitStep)
            assert transform_steps[i - 1].stage_id == step.stage_id
            ret.append(transform_steps[i - 1])
            ret.append(step)
        if step is current_step:
            break
    return ret


class CacheReadStep(Step):
    KEY = "CHR"

    def __init__(self, stage_id, scope_name, reader_stage_ids):
        self.stage_id = stage_id
        self.scope_name = scope_name
        self.reader_stage_ids = list(reader_stage_ids)

    def to_record(self):
        return [self.KEY, self.stage_id, self.scope_name,
                list(self.reader_stage_ids)]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3])

    def apply_to_state(self, st: State):
        # incremental op rewrite on the state's current ops — keeps op/axis
        # object identity stable across successive cache steps (TVM replays
        # from scratch but swaps every later stage's op to the new DAG's,
        # which we mirror; see CacheReadStepNode::ApplyToState)
        from .dag import _apply_cache_read

        new_ops = _apply_cache_read(st.current_ops or st.dag.ops, self)
        added = self.stage_id + 1
        # target keeps its iterators, only the op is swapped
        tgt = st.stages[self.stage_id].shallow_copy()
        tgt.op = new_ops[self.stage_id]
        st.stages[self.stage_id] = tgt
        st.stages.insert(added, Stage(new_ops[added]))
        for i in range(added + 1, len(st.stages)):
            s = st.stages[i].shallow_copy()
            s.op = new_ops[i]
            st.stages[i] = s
        st.attach_map.apply_stage_id_offset(added)
        st.current_ops = new_ops
        return added


class CacheWriteStep(Step):
    KEY = "CHW"

    def __init__(self, stage_id, scope_name):
        self.stage_id = stage_id
        self.scope_name = scope_name

    def to_record(self):
        return [self.KEY, self.stage_id, self.scope_name]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2])

    def apply_to_state(self, st: State):
        from .dag import _apply_cache_write

        cur = st.current_ops or st.dag.ops
        last_size = len(cur)
        new_ops = _apply_cache_write(cur, self)
        added_ops = len(new_ops) - last_size
        assert added_ops >= 1
        st.stages.insert(self.stage_id, Stage(new_ops[self.stage_id]))
        st.stages[self.stage_id + 1] = Stage(new_ops[self.stage_id + 1])
        next_id = self.stage_id + 2
        if added_ops == 2:
            st.stages.insert(next_id, Stage(new_ops[next_id]))
            next_id += 1
        for i in range(next_id, len(new_ops)):
            s = st.stages[i].shallow_copy()
            s.op = new_ops[i]
            st.stages[i] = s
        st.attach_map.apply_stage_id_offset(self.stage_id, added_ops)
        st.current_ops = new_ops
        return self.stage_id


class RfactorStep(Step):
    KEY = "RF"

    def __init__(self, stage_id, iter_id, factor_iter_id):
        self.stage_id, self.iter_id = stage_id, iter_id
        self.factor_iter_id = factor_iter_id

    def to_record(self):
        return [self.KEY, self.stage_id, self.iter_id, self.factor_iter_id]

    @classmethod
    def from_record(cls, rec):
        return cls(rec[1], rec[2], rec[3])

    def apply_to_state(self, st: State):
        from .dag import _apply_rfactor

        compute_at_type = st.stages[self.stage_id].compute_at
        # the required FU (optional) + SP context directly precede this step
        steps = st.transform_steps
        idx = len(steps) - 1
        assert steps[idx] is self
        split_step = steps[idx - 1]
        assert isinstance(split_step, SplitStep)
        fuse_step = None
        if idx >= 2 and isinstance(steps[idx - 2], FuseStep) and \
                steps[idx - 2].stage_id == self.stage_id:
            fuse_step = steps[idx - 2]
        new_ops = _apply_rfactor(st.current_ops or st.dag.ops, fuse_step,
                                 split_step, self)
        st.stages.insert(self.stage_id, Stage(new_ops[self.stage_id]))
        tgt = Stage(new_ops[self.stage_id + 1])
        tgt.compute_at = compute_at_type
        st.stages[self.stage_id + 1] = tgt
        for i in range(self.stage_id + 2, len(st.stages)):
            s = st.stages[i].shallow_copy()
            s.op = new_ops[i]
            st.stages[i] = s
        st.attach_map.apply_stage_id_offset(self.stage_id)
        st.current_ops = new_ops
        return self.stage_id


STEP_CLASSES = {
    cls.KEY: cls
    for cls in (
        AnnotationStep, FuseStep, PragmaStep, ReorderStep, SplitStep,
        FollowSplitStep, FollowFusedSplitStep, StorageAlignStep,
        ComputeAtStep, ComputeInlineStep, ComputeRootStep, CacheReadStep,
        CacheWriteStep, RfactorStep,
    )
}


def step_from_record(rec: list) -> Step:
    return STEP_CLASSES[rec[0]].from_record(rec)


def apply_steps_to_state(dag, records_or_steps) -> State:
    """Replay a list of steps (or serialized records) onto the DAG's initial
    state; mirrors ComputeDAG::InferBound's replay prologue
    (compute_dag.cc:1308-1318)."""
    st = dag.init_state.copy()
    for rec in records_or_steps:
        step = rec if isinstance(rec, Step) else step_from_record(rec)
        st.transform_steps.append(step)
        step.apply_to_state(st)
    return st
