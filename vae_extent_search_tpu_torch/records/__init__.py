"""Workload registry, search tasks and measure-record serde (a copy of
``vae_extent_search_tpu/records/``'s ``workload``, ``workload_library``,
``task`` and ``serde``), and the binding of the port's host library
(``fast_parser``, with the descriptors ``task_desc`` and ``expr_desc``)."""

from . import workload_library  # registers the standard workloads
from .serde import (
    LOG_VERSION,
    MeasureInput,
    MeasureRecord,
    MeasureResult,
    iter_records,
    load_records,
    make_record,
    record_from_json,
    record_to_json,
    save_records,
)
from .task import HardwareParams, SearchTask, TuningOptions
from .workload import (
    decode_workload_key,
    make_workload_key,
    register_workload,
    register_workload_shape_builder,
    workload_key_to_dag,
    workload_key_to_tensors,
)
