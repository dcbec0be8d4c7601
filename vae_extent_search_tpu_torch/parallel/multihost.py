"""Multi-process runtime: ``torch.distributed`` set-up and task sharding
(counterpart of ``vae_extent_search_tpu/parallel/multihost.py``).

Every process of a cluster runs the same program. Tasks (one task = one
independent search) shard disjointly by rank, the reference's
``--start/--end/--step-idx`` contract, and the per-process append-only
record logs merge afterwards by line concatenation and deduplication.

Env contract (the JAX package's):

- ``VES_COORDINATOR``   host:port of rank 0's rendezvous (a TCP store)
- ``VES_NUM_PROCESSES`` the world size
- ``VES_PROCESS_ID``    this process's rank (0-based)

Explicit arguments win over the variables; with neither,
``maybe_initialize_distributed`` is a no-op that returns (0, 1).

The backend is chosen once, explicitly, and logged: ``nccl`` when every
rank has a card of its own, ``gloo`` otherwise (on the CPU, or with ranks
sharing one card: NCCL refuses two ranks on one GPU). It is never switched
after a failure.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger("vae_extent_search_tpu_torch.parallel")


def default_backend(world: int, device: str = "cuda") -> str:
    """``nccl`` when ``device`` is CUDA and this host has a card for each
    of ``world`` ranks (ranks of one host assumed), else ``gloo``."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if not torch.distributed.is_nccl_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def local_device(device: str = "cuda", rank: int = 0) -> torch.device:
    """This rank's device: ``cuda:<rank mod cards>`` for CUDA (ranks
    beyond the card count share cards), the CPU otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def maybe_initialize_distributed(
        coordinator: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        timeout_s: int = 60,
        backend: Optional[str] = None,
        device: str = "cuda") -> Tuple[int, int]:
    """Join the process group when a cluster is configured; return
    (rank, world).

    ``backend`` None takes :func:`default_backend` for ``device``; the
    choice is logged and printed. Every rendezvous and collective is held
    to ``timeout_s``. Already initialised: returns the group's (rank,
    world)."""
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("VES_COORDINATOR")
    if not coordinator:
        return 0, 1
    world = int(num_processes or os.environ["VES_NUM_PROCESSES"])
    rank = int(process_id if process_id is not None
               else os.environ["VES_PROCESS_ID"])
    backend = backend or default_backend(world, device)
    msg = (f"torch.distributed: rank {rank}/{world}, backend {backend}, "
           f"tcp://{coordinator}")
    logger.info(msg)
    print(msg, flush=True)
    kw = {}
    if backend == "nccl":
        # NCCL binds a communicator to one card per rank
        dev = local_device(device, rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return rank, world


def shard_tasks(tasks: Sequence, process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List:
    """This rank's disjoint round-robin task shard (round-robin, not
    blocks, so the expensive networks of a grid spread evenly). Without
    indices it reads the process group (rank 0 of 1 when there is
    none)."""
    if process_index is None or process_count is None:
        dist = torch.distributed
        if dist.is_initialized():
            process_index, process_count = (dist.get_rank(),
                                            dist.get_world_size())
        else:
            process_index, process_count = 0, 1
    return list(tasks)[process_index::process_count]


def merge_record_logs(in_paths: Sequence[str], out_path: str,
                      dedup: bool = True) -> int:
    """Concatenate per-process record logs into ``out_path`` (appended);
    returns the number of lines written. With ``dedup``, a line already in
    ``out_path`` or earlier in this merge is dropped, so a retried merge
    writes nothing twice; ``out_path`` itself among ``in_paths`` and
    missing inputs are skipped."""
    seen = set()
    if dedup and os.path.exists(out_path):
        with open(out_path) as f:
            seen.update(ln.rstrip("\n") for ln in f if ln.strip())
    out_real = os.path.realpath(out_path)
    n = 0
    with open(out_path, "a") as out:
        for path in in_paths:
            if not os.path.exists(path) \
                    or os.path.realpath(path) == out_real:
                continue
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    if dedup:
                        if line in seen:
                            continue
                        seen.add(line)
                    out.write(line + "\n")
                    n += 1
    return n
