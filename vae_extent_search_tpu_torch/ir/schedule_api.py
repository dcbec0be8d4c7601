"""Schedule-primitive methods on State.

Parity target: python/tvm/auto_scheduler/loop_state.py:138-607 (bind,
parallel, unroll, vectorize, fuse, pragma, reorder, split, follow_split,
follow_fused_split, storage_align, compute_at, compute_inline,
compute_root, cache_read, cache_write, rfactor). Each method records the
step in transform_steps and applies it to the state.

Iterators are referenced by object (position resolved at call time) or by
position; stages by id or op name.
"""

from __future__ import annotations

from . import steps as ST
from .state import (
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
    Iterator,
    State,
)

_THREAD_NAMES = {
    "blockIdx.x": ANNOTATION_BLOCK_X,
    "threadIdx.x": ANNOTATION_THREAD_X,
    "blockIdx.y": ANNOTATION_BLOCK_Y,
    "threadIdx.y": ANNOTATION_THREAD_Y,
    "blockIdx.z": ANNOTATION_BLOCK_Z,
    "threadIdx.z": ANNOTATION_THREAD_Z,
    "vthread": ANNOTATION_VTHREAD,
}


def _iter_index(state: State, stage_id: int, it) -> int:
    if isinstance(it, int):
        return it
    iters = state.stages[stage_id].iters
    for i, x in enumerate(iters):
        if x is it or x.uid == getattr(it, "uid", None):
            return i
    raise ValueError(f"iterator {it} not found in stage {stage_id}")


def _push(state: State, step):
    state.transform_steps.append(step)
    return step.apply_to_state(state)


def _annotate(state, stage_id, it, ann):
    return _push(state, ST.AnnotationStep(stage_id, _iter_index(state, stage_id, it), ann))


def state_bind(state, stage_id, it, thread_name: str):
    return _annotate(state, stage_id, it, _THREAD_NAMES[thread_name])


def state_parallel(state, stage_id, it):
    return _annotate(state, stage_id, it, ANNOTATION_PARALLEL)


def state_unroll(state, stage_id, it):
    return _annotate(state, stage_id, it, ANNOTATION_UNROLL)


def state_vectorize(state, stage_id, it):
    return _annotate(state, stage_id, it, ANNOTATION_VECTORIZE)


def state_fuse(state, stage_id, iters):
    ids = [_iter_index(state, stage_id, it) for it in iters]
    return _push(state, ST.FuseStep(stage_id, ids))


def state_pragma(state, stage_id, it, pragma_type: str):
    return _push(state, ST.PragmaStep(stage_id, _iter_index(state, stage_id, it), pragma_type))


def state_reorder(state, stage_id, order):
    ids = [_iter_index(state, stage_id, it) for it in order]
    return _push(state, ST.ReorderStep(stage_id, ids))


def state_split(state, stage_id, it, lengths, inner_to_outer=True):
    idx = _iter_index(state, stage_id, it)
    iterator = state.stages[stage_id].iters[idx]
    # te records the extent only when it is a concrete integer; symbolic
    # (data-dependent) extents serialize as 0 (transform_step.cc:976-982
    # "Extent can be a irreducible expression in some special cases")
    extent = iterator.range[1] if iterator.range is not None else 0
    if not isinstance(extent, int):
        extent = 0
    return _push(
        state, ST.SplitStep(stage_id, idx, extent, list(lengths), inner_to_outer)
    )


def state_follow_split(state, stage_id, it, src_step_id, n_split):
    idx = _iter_index(state, stage_id, it)
    return _push(state, ST.FollowSplitStep(stage_id, idx, src_step_id, n_split))


def state_follow_fused_split(state, stage_id, it, src_step_ids, level,
                             factor_or_nparts):
    idx = _iter_index(state, stage_id, it)
    return _push(
        state,
        ST.FollowFusedSplitStep(stage_id, idx, list(src_step_ids), level,
                                factor_or_nparts),
    )


def state_storage_align(state, stage_id, it, factor, offset):
    idx = _iter_index(state, stage_id, it)
    return _push(state, ST.StorageAlignStep(stage_id, idx, factor, offset))


def state_compute_at(state, stage_id, target_stage_id, target_it):
    idx = _iter_index(state, target_stage_id, target_it)
    return _push(state, ST.ComputeAtStep(stage_id, target_stage_id, idx))


def state_compute_inline(state, stage_id):
    return _push(state, ST.ComputeInlineStep(stage_id))


def state_compute_root(state, stage_id):
    return _push(state, ST.ComputeRootStep(stage_id))


def state_cache_read(state, stage_id, scope_name, reader_stage_ids):
    return _push(state, ST.CacheReadStep(stage_id, scope_name,
                                         list(reader_stage_ids)))


def state_cache_write(state, stage_id, scope_name):
    return _push(state, ST.CacheWriteStep(stage_id, scope_name))


def state_rfactor(state, stage_id, it, factor_iter_id):
    idx = _iter_index(state, stage_id, it)
    return _push(state, ST.RfactorStep(stage_id, idx, factor_iter_id))


# attach as State methods (loop_state.py parity surface)
State.bind = state_bind
State.parallel = state_parallel
State.unroll = state_unroll
State.vectorize = state_vectorize
State.fuse = state_fuse
State.pragma = state_pragma
State.reorder = state_reorder
State.split = state_split
State.follow_split = state_follow_split
State.follow_fused_split = state_follow_fused_split
State.storage_align = state_storage_align
State.compute_at = state_compute_at
State.compute_inline = state_compute_inline
State.compute_root = state_compute_root
State.cache_read = state_cache_read
State.cache_write = state_cache_write
State.rfactor = state_rfactor
