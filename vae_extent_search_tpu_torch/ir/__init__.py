"""The schedule IR: tensor expressions, loop States, transform steps,
bound inference and the ComputeDAG (a copy of
``vae_extent_search_tpu/ir/`` without ``layout.py``)."""

from . import expr
from .bound import infer_bound
from .dag import ComputeDAG
from .state import State, Stage, Iterator, AttachMap
from .steps import (
    STEP_CLASSES,
    AnnotationStep,
    CacheReadStep,
    CacheWriteStep,
    ComputeAtStep,
    ComputeInlineStep,
    ComputeRootStep,
    FollowFusedSplitStep,
    FollowSplitStep,
    FuseStep,
    PragmaStep,
    ReorderStep,
    RfactorStep,
    SplitStep,
    Step,
    StorageAlignStep,
    apply_steps_to_state,
    step_from_record,
)
from .tensor import (
    ComputeOp,
    IterDim,
    PlaceholderOp,
    Tensor,
    compute,
    estimate_flops,
    max_reduce,
    min_reduce,
    placeholder,
    reduce_axis,
    sum_reduce,
    topo_sort_ops,
)
