"""Workload registry: workload_key <-> compute definition (a copy of
``vae_extent_search_tpu/records/workload.py`` without the TenSet
hash-key inference).

Parity target: python/tvm/auto_scheduler/workload_registry.py:55-165
(register_workload, make_workload_key, workload_key_to_tensors) and
utils.py:46 (decode_workload_key). Keys are JSON lists
``[func_name_or_dag_hash, *args]``.

Hash-keyed workloads (relay-extracted TenSet tasks) are supported through
``register_workload_shape_builder``: a builder receives the key's shape
args and returns output tensors — the equivalent of the reference loading
pre-registered DAGs from ``all_tasks.pkl`` (scripts/common.py:68-75).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..ir.dag import ComputeDAG
from ..ir.tensor import Tensor

WORKLOAD_FUNC_REGISTRY: Dict[str, Callable] = {}
# hash -> builder(args) for relay-extracted workloads
WORKLOAD_HASH_REGISTRY: Dict[str, Callable] = {}


def register_workload(func_name, f=None, override=False):
    """Register a workload by name. Usable as decorator or call."""

    def register(myf):
        if func_name in WORKLOAD_FUNC_REGISTRY and not override:
            raise RuntimeError(f"{func_name} has been registered already")
        WORKLOAD_FUNC_REGISTRY[func_name] = myf
        return myf

    if f:
        return register(f)
    if callable(func_name):
        myf = func_name
        name = myf.__name__
        if name in WORKLOAD_FUNC_REGISTRY and not override:
            raise RuntimeError(f"{name} has been registered already")
        WORKLOAD_FUNC_REGISTRY[name] = myf
        return myf
    return register


def register_workload_shape_builder(dag_hash: str, builder: Callable,
                                    override=False):
    """Register a DAG builder for a relay-style hash workload key."""
    if dag_hash in WORKLOAD_HASH_REGISTRY and not override:
        raise RuntimeError(f"{dag_hash} has been registered already")
    WORKLOAD_HASH_REGISTRY[dag_hash] = builder
    return builder


def make_workload_key(func, args) -> str:
    if callable(func):
        name = func.__name__
    else:
        name = func
    return json.dumps([name] + list(args))


def decode_workload_key(workload_key: str):
    """Decode into (name, args) — reference utils.py:46."""
    tokens = json.loads(workload_key)
    return tokens[0], tokens[1:]


def workload_key_to_tensors(workload_key: str) -> List[Tensor]:
    name, args = decode_workload_key(workload_key)
    if name in WORKLOAD_FUNC_REGISTRY:
        result = WORKLOAD_FUNC_REGISTRY[name](*args)
    elif name in WORKLOAD_HASH_REGISTRY:
        result = WORKLOAD_HASH_REGISTRY[name](args)
    else:
        # the JAX package infers TenSet hash workloads here
        # (records/tenset_workloads.py); the port has no copy of it yet
        raise KeyError(f"workload '{name}' is not registered")
    if isinstance(result, Tensor):
        result = [result]
    return list(result)


_DAG_CACHE: Dict[str, ComputeDAG] = {}


def workload_key_to_dag(workload_key: str) -> ComputeDAG:
    dag = _DAG_CACHE.get(workload_key)
    if dag is None:
        dag = ComputeDAG(workload_key_to_tensors(workload_key))
        _DAG_CACHE[workload_key] = dag
    return dag
