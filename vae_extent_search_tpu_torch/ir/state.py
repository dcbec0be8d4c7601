"""Ansor-compatible loop-nest schedule state.

A ``State`` is a lightweight symbolic schedule: a list of stages (one per
DAG op), each with an ordered list of iterators, plus an attach map for
compute_at relations and the recorded list of transform steps.

Behavior parity targets (cited into the reference TVM fork):
- stage/iterator/attach-map model: src/auto_scheduler/loop_state.cc and
  include/tvm/auto_scheduler/loop_state.h
- the pretty-printer text format: loop_state.cc:354-440 (PrintStage /
  PrintState) — the VAE-extent experiment regex-parses this text, so the
  format must match byte-for-byte.

The implementation (iterator uid lineage + per-stage split/fuse relation
logs used by the demand-driven bound inference in ``bound.py``) is our own
design; TVM instead re-lowers through te::Schedule.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from .tensor import ComputeOp, IterDim, Op, PlaceholderOp

# Iterator annotation enum — integer values are part of the record format
# (reference transform_step.cc:110-123 IteratorAnnotationString order).
ANNOTATION_NONE = 0
ANNOTATION_UNROLL = 1
ANNOTATION_VECTORIZE = 2
ANNOTATION_PARALLEL = 3
ANNOTATION_VTHREAD = 4
ANNOTATION_BLOCK_X = 5
ANNOTATION_THREAD_X = 6
ANNOTATION_BLOCK_Y = 7
ANNOTATION_THREAD_Y = 8
ANNOTATION_BLOCK_Z = 9
ANNOTATION_THREAD_Z = 10
ANNOTATION_TENSORIZE = 11

ANNOTATION_STRINGS = [
    "for",
    "unroll",
    "vectorize",
    "parallel",
    "vthread",
    "blockIdx.x",
    "threadIdx.x",
    "blockIdx.y",
    "threadIdx.y",
    "blockIdx.z",
    "threadIdx.z",
    "tensorize",
]

THREAD_ANNOTATIONS = frozenset(
    {
        ANNOTATION_VTHREAD,
        ANNOTATION_BLOCK_X,
        ANNOTATION_THREAD_X,
        ANNOTATION_BLOCK_Y,
        ANNOTATION_THREAD_Y,
        ANNOTATION_BLOCK_Z,
        ANNOTATION_THREAD_Z,
    }
)

# Iterator kinds (loop_state.h IteratorKind)
KIND_SPATIAL = "spatial"
KIND_REDUCTION = "reduction"
KIND_MIXED = "mixed"
KIND_SPECIAL = "special"

# Stage compute locations (loop_state.h ComputeAtKind)
AT_ROOT = "root"
AT_ITER = "iter"
AT_INLINED = "inlined"

_iter_uid = itertools.count()


class Iterator:
    """One loop iterator of a stage.

    ``uid`` is the stable lineage identity: preserved through annotation and
    range-clearing copies; fresh for iterators created by split/fuse.
    """

    __slots__ = ("name", "range", "kind", "annotation", "orig_iters", "uid")

    def __init__(self, name, range_, kind, annotation=ANNOTATION_NONE,
                 orig_iters=(), uid=None):
        self.name = name
        self.range = range_  # None (undefined) or (min:int, extent:int)
        self.kind = kind
        self.annotation = annotation
        self.orig_iters = tuple(orig_iters)
        self.uid = _fresh_iter_uid() if uid is None else uid

    def with_annotation(self, annotation) -> "Iterator":
        return Iterator(self.name, self.range, self.kind, annotation,
                        self.orig_iters, uid=self.uid)

    def with_range(self, range_) -> "Iterator":
        return Iterator(self.name, range_, self.kind, self.annotation,
                        self.orig_iters, uid=self.uid)

    @property
    def extent(self) -> Optional[int]:
        return None if self.range is None else self.range[1]

    def __repr__(self):
        return f"Iterator({self.name}, {self.range}, {self.kind}, {ANNOTATION_STRINGS[self.annotation]})"


def _fresh_iter_uid() -> int:
    return next(_iter_uid)


class Relation:
    """Binary iterator derivation used for bound inference.

    kind == "split": parent -> (outer, inner); ``factor`` with
        ``by_nparts=False`` means inner has the fixed factor (te split);
        by_nparts=True means outer has the fixed part count
        (te split_by_nparts). Extent math mirrors te PassDownDomain
        (reference src/te/schedule/message_passing.cc:109-143).
    kind == "fuse": (outer, inner) -> fused, extent = product.
    """

    __slots__ = ("kind", "parent", "outer", "inner", "fused", "factor", "by_nparts")

    def __init__(self, kind, parent=None, outer=None, inner=None, fused=None,
                 factor=None, by_nparts=False):
        self.kind = kind
        self.parent = parent  # uid
        self.outer = outer  # uid
        self.inner = inner  # uid
        self.fused = fused  # uid
        self.factor = factor  # Optional[int]
        self.by_nparts = by_nparts


class StageAttrs:
    __slots__ = ("auto_unroll_max_step", "storage_offset")

    def __init__(self, auto_unroll_max_step=0, storage_offset=0):
        self.auto_unroll_max_step = auto_unroll_max_step
        self.storage_offset = storage_offset

    def copy(self):
        return StageAttrs(self.auto_unroll_max_step, self.storage_offset)


class Stage:
    """Schedule state of one op."""

    __slots__ = ("op", "op_type", "iters", "compute_at", "attrs",
                 "relations", "root_of")

    def __init__(self, op: Op, op_type=None, iters=None, compute_at=AT_ROOT,
                 attrs=None, relations=None, root_of=None):
        self.op = op
        if op_type is None:
            op_type = "placeholder" if isinstance(op, PlaceholderOp) else "compute"
        self.op_type = op_type
        if iters is None:
            iters, root_of = _init_iters(op)
        self.iters = list(iters)
        self.compute_at = compute_at
        self.attrs = attrs if attrs is not None else StageAttrs()
        # relation log for bound inference (reset when the stage is re-created
        # fresh by cache_read/cache_write/rfactor)
        self.relations: List[Relation] = list(relations) if relations else []
        # uid -> IterDim for the stage's original axes
        self.root_of: Dict[int, IterDim] = dict(root_of) if root_of else {}

    def shallow_copy(self) -> "Stage":
        return Stage(self.op, self.op_type, list(self.iters), self.compute_at,
                     self.attrs.copy(), list(self.relations), dict(self.root_of))

    def __repr__(self):
        return f"Stage({self.op.name}, {len(self.iters)} iters, {self.compute_at})"


def _init_iters(op: Op):
    iters: List[Iterator] = []
    root_of: Dict[int, IterDim] = {}
    if isinstance(op, ComputeOp):
        for d in op.axes:
            it = Iterator(d.name, (0, d.extent), KIND_SPATIAL)
            root_of[it.uid] = d
            iters.append(it)
        for d in op.reduce_axes:
            it = Iterator(d.name, (0, d.extent), KIND_REDUCTION)
            root_of[it.uid] = d
            iters.append(it)
    return iters, root_of


class AttachMap:
    """stage -> attach point and its inverse (ordered list per iterator).

    Mirrors loop_state.h AttachMap / loop_state.cc UpdateIters,
    ApplyStageIdOffset semantics.
    """

    def __init__(self):
        self.stage_to_attach_iter: Dict[int, Tuple[int, int]] = {}
        self.iter_to_attached_stages: Dict[Tuple[int, int], List[int]] = {}

    def copy(self) -> "AttachMap":
        am = AttachMap()
        am.stage_to_attach_iter = dict(self.stage_to_attach_iter)
        am.iter_to_attached_stages = {
            k: list(v) for k, v in self.iter_to_attached_stages.items()
        }
        return am

    def set_compute_at_iter(self, stage_id, target_stage_id, target_iter_id):
        self.delete_stage(stage_id)
        self.stage_to_attach_iter[stage_id] = (target_stage_id, target_iter_id)
        self.iter_to_attached_stages.setdefault(
            (target_stage_id, target_iter_id), []
        ).append(stage_id)

    def delete_stage(self, stage_id):
        old = self.stage_to_attach_iter.pop(stage_id, None)
        if old is not None:
            lst = self.iter_to_attached_stages.get(old, [])
            if stage_id in lst:
                lst.remove(stage_id)
            if not lst:
                self.iter_to_attached_stages.pop(old, None)

    def update_iters(self, from_iters, to_iters):
        """Remap (stage, iter) keys after split/fuse shifts iterator ids."""
        mapping = dict(zip(from_iters, to_iters))
        new_i2s: Dict[Tuple[int, int], List[int]] = {}
        for key, stages in self.iter_to_attached_stages.items():
            new_key = mapping.get(key, key)
            new_i2s.setdefault(new_key, []).extend(stages)
        self.iter_to_attached_stages = new_i2s
        for sid, key in list(self.stage_to_attach_iter.items()):
            self.stage_to_attach_iter[sid] = mapping.get(key, key)

    def apply_stage_id_offset(self, start_id, offset=1):
        """Shift all stage ids >= start_id by offset (new stage inserted)."""
        new_s2i = {}
        for sid, (tsid, tiid) in self.stage_to_attach_iter.items():
            new_s2i[sid + offset if sid >= start_id else sid] = (
                tsid + offset if tsid >= start_id else tsid,
                tiid,
            )
        self.stage_to_attach_iter = new_s2i
        new_i2s = {}
        for (tsid, tiid), stages in self.iter_to_attached_stages.items():
            key = (tsid + offset if tsid >= start_id else tsid, tiid)
            new_i2s[key] = [s + offset if s >= start_id else s for s in stages]
        self.iter_to_attached_stages = new_i2s


class State:
    """A schedule state: stages + transform step log + attach map."""

    def __init__(self, stages: List[Stage], dag=None):
        self.stages = list(stages)
        self.transform_steps: list = []
        self.attach_map = AttachMap()
        self.concrete = True
        self.dag = dag  # owning ComputeDAG (for cache/rfactor replay)
        # op list after stage-modifiable steps (cache read/write, rfactor);
        # None means the DAG's original ops
        self.current_ops = None

    def copy(self) -> "State":
        st = State([s for s in self.stages], dag=self.dag)
        st.transform_steps = list(self.transform_steps)
        st.attach_map = self.attach_map.copy()
        st.concrete = self.concrete
        st.current_ops = self.current_ops
        return st

    # ---------------- printing (format parity: loop_state.cc:354-440) ------

    def to_str(self, delete_trivial_loop: bool = True) -> str:
        out = []
        placeholders = [
            s.op.name for s in self.stages if s.op_type == "placeholder"
        ]
        out.append("Placeholder: " + ", ".join(placeholders) + "\n")
        for i, stage in enumerate(self.stages):
            if stage.op_type == "placeholder":
                continue
            if stage.compute_at == AT_ROOT:
                self._print_stage(out, i, 0, delete_trivial_loop)
        return "".join(out)

    def _print_stage(self, out, stage_id, base_indent, delete_trivial_loop):
        stage = self.stages[stage_id]
        if stage.attrs.auto_unroll_max_step != 0:
            out.append(" " * base_indent)
            out.append(
                f"{stage.op.name} auto_unroll: {stage.attrs.auto_unroll_max_step}\n"
            )
        if stage.attrs.storage_offset != 0:
            out.append(" " * base_indent)
            out.append(
                f"{stage.op.name} storage_offset: {stage.attrs.storage_offset}\n"
            )
        indent = 0
        for i, it in enumerate(stage.iters):
            trivial = (
                delete_trivial_loop and it.range is not None and it.range[1] == 1
            )
            if not trivial:
                out.append(" " * (base_indent + indent))
                out.append(ANNOTATION_STRINGS[it.annotation] + " ")
                if it.range is not None:
                    ext = it.range[1]
                    if not isinstance(ext, int):
                        # data-dependent extent: print the expression (the
                        # reference prints the te PrimExpr; the extent-
                        # feature regex only matches integer extents either
                        # way, vae_extent_search.py:166-176)
                        from .expr import expr_str
                        ext = expr_str(ext)
                    out.append(f"{it.name} ({it.range[0]},{ext})")
                else:
                    out.append(f"{it.name} (None)")
                out.append("\n")
                indent += 2
            attached = self.attach_map.iter_to_attached_stages.get((stage_id, i))
            if attached:
                for a_sid in attached:
                    self._print_stage(out, a_sid, base_indent + indent,
                                      delete_trivial_loop)
        out.append(" " * (base_indent + indent))
        out.append(f"{stage.op.name} = ...\n")

    def __str__(self):
        return self.to_str(True)

    def __repr__(self):
        return self.to_str(True)
