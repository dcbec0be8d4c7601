"""Program measurement: the builder/runner split (counterpart of
``vae_extent_search_tpu/search/measure.py``; parity target
src/auto_scheduler/measure.cc + python measure.py).

``ProgramMeasurer`` batches (state -> MeasureResult) through a Builder and
a Runner, tracks best-per-workload, aborts after ``max_continuous_error``
(measure.cc:269-336), and streams results to record-log callbacks
(``RecordToFile``). The runners that time the port's own CUDA kernels are
in ``search/kernel_tuner.py``; the JAX package's replay, analytic,
command and service runners are not ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from ..ir.state import State
from ..records.serde import (
    ERROR_NO_ERROR,
    MAX_FLOAT,
    MeasureResult,
    make_record,
    save_records,
)
from ..records.task import SearchTask


class Builder:
    def build(self, task: SearchTask, states: Sequence[State]) -> List[int]:
        """Return per-state error_no (0 = ok)."""
        raise NotImplementedError


class Runner:
    def run(self, task: SearchTask, states: Sequence[State]) -> List[MeasureResult]:
        raise NotImplementedError


class EmptyBuilder(Builder):
    def build(self, task, states):
        return [ERROR_NO_ERROR] * len(states)


class RecordToFile:
    """Measure callback appending records to an NDJSON log
    (measure_record.cc:348-352)."""

    def __init__(self, filename: str):
        self.filename = filename

    def callback(self, task, states, results):
        records = [
            make_record(task, st.transform_steps, res.costs, res.error_no,
                        res.all_cost, res.timestamp)
            for st, res in zip(states, results)
        ]
        save_records(self.filename, records, mode="a")


class ProgramMeasurer:
    """Batched measurement with best-tracking and error abort
    (measure.cc:269-336)."""

    def __init__(self, builder: Builder, runner: Runner,
                 callbacks: Optional[list] = None,
                 max_continuous_error: int = 150, verbose: int = 0):
        self.builder = builder
        self.runner = runner
        self.callbacks = callbacks or []
        self.max_continuous_error = max_continuous_error
        self.verbose = verbose
        self.best_cost: Dict[str, float] = {}
        self.best_state: Dict[str, State] = {}
        self.error_ct = 0

    def measure(self, task: SearchTask, states: Sequence[State]
                ) -> List[MeasureResult]:
        build_errors = self.builder.build(task, states)
        results = self.runner.run(task, states)
        out = []
        for st, berr, res in zip(states, build_errors, results):
            if berr != ERROR_NO_ERROR:
                res = MeasureResult([MAX_FLOAT], berr, 0.0, time.time())
            out.append(res)
            if res.error_no == ERROR_NO_ERROR:
                self.error_ct = 0
                cost = res.mean_cost
                wk = task.workload_key
                if cost < self.best_cost.get(wk, float("inf")):
                    self.best_cost[wk] = cost
                    self.best_state[wk] = st
            else:
                self.error_ct += 1
                if self.error_ct >= self.max_continuous_error:
                    raise RuntimeError(
                        "too many continuous measurement errors"
                    )
        for cb in self.callbacks:
            cb.callback(task, states, out)
        return out
