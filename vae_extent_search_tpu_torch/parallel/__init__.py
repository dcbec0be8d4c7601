"""Multi-device layer on ``torch.distributed`` (counterpart of
``vae_extent_search_tpu/parallel``): one process per rank, each with an
explicit device."""

from .mesh import (
    make_mesh,
    make_sharded_train_step,
    shard_batch,
    sharded_score_candidates,
)
from .multihost import (
    maybe_initialize_distributed,
    merge_record_logs,
    shard_tasks,
)
