"""SearchTask / HardwareParams / TuningOptions.

Parity: python/tvm/auto_scheduler/search_task.py:44-139 and the record
serialization order in src/auto_scheduler/measure_record.cc:110-180
(task = [workload_key, target, hardware_params(8 ints), target_host,
layout_rewrite_option, task_input_names]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .workload import workload_key_to_dag


@dataclass
class HardwareParams:
    num_cores: int = -1
    vector_unit_bytes: int = 64
    cache_line_bytes: int = 64
    max_shared_memory_per_block: int = 65536
    max_local_memory_per_block: int = 2147483647
    max_threads_per_block: int = 1024
    max_vthread_extent: int = 8
    warp_size: int = 32

    def to_record(self) -> list:
        return [
            self.num_cores,
            self.vector_unit_bytes,
            self.cache_line_bytes,
            self.max_shared_memory_per_block,
            self.max_local_memory_per_block,
            self.max_threads_per_block,
            self.max_vthread_extent,
            self.warp_size,
        ]

    @classmethod
    def from_record(cls, rec):
        return cls(*rec[:8])

    @classmethod
    def default_for_target(cls, target: str) -> "HardwareParams":
        import os

        if target.startswith("cuda"):
            return cls(num_cores=-1, vector_unit_bytes=16, cache_line_bytes=64,
                       max_shared_memory_per_block=49152,
                       max_local_memory_per_block=2147483647,
                       max_threads_per_block=1024, max_vthread_extent=8,
                       warp_size=32)
        # non-default platform profiles (search/platforms.py) shape the
        # CPU schedule space with the platform's core count and vector
        # ISA (InitParallel fuses to num_cores*16; reference
        # sketch_policy_rules.cc:580-643). The default platform — bare
        # llvm and the historical skylake target — keeps the reference's
        # host-cpu-count behavior (GetDefaultHardwareParams), so
        # pre-registry pools regenerate identically.
        from ..search.platforms import is_default_cpu_platform, \
            platform_for_target

        p = platform_for_target(target)
        if not is_default_cpu_platform(p):
            return cls(num_cores=p.num_cores,
                       vector_unit_bytes=p.vector_unit_bytes,
                       cache_line_bytes=64,
                       max_shared_memory_per_block=2147483647,
                       max_local_memory_per_block=2147483647,
                       max_threads_per_block=2147483647,
                       max_vthread_extent=1, warp_size=1)
        # llvm / cpu-style default (search_task.py GetDefaultHardwareParams)
        return cls(num_cores=os.cpu_count() or 1, vector_unit_bytes=64,
                   cache_line_bytes=64,
                   max_shared_memory_per_block=2147483647,
                   max_local_memory_per_block=2147483647,
                   max_threads_per_block=2147483647, max_vthread_extent=1,
                   warp_size=1)


@dataclass
class SearchTask:
    workload_key: str
    target: str
    hardware_params: Optional[HardwareParams] = None
    target_host: str = ""
    layout_rewrite_option: int = 0
    task_input_names: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.hardware_params is None:
            self.hardware_params = HardwareParams.default_for_target(self.target)

    @property
    def compute_dag(self):
        return workload_key_to_dag(self.workload_key)

    @property
    def is_gpu(self) -> bool:
        kind = self.target.split()[0] if self.target else ""
        return kind in ("cuda", "rocm", "opencl", "metal", "vulkan")

    def to_record(self) -> list:
        return [
            self.workload_key,
            self.target,
            self.hardware_params.to_record(),
            self.target_host or "",
            int(self.layout_rewrite_option),
            list(self.task_input_names),
        ]

    @classmethod
    def from_record(cls, rec):
        workload_key = rec[0]
        target = rec[1]
        hw = HardwareParams.from_record(rec[2]) if len(rec) > 2 else None
        target_host = rec[3] if len(rec) > 3 else ""
        layout = rec[4] if len(rec) > 4 else 0
        inputs = tuple(rec[5]) if len(rec) > 5 else ()
        return cls(workload_key, target, hw, target_host, layout, inputs)


@dataclass
class TuningOptions:
    """python/tvm/auto_scheduler/search_task.py:93-139."""

    num_measure_trials: int = 0
    early_stopping: int = -1
    num_measures_per_round: int = 64
    verbose: int = 1
    builder: object = None
    runner: object = None
    measure_callbacks: Optional[list] = None
