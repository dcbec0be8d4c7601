"""Measure-record NDJSON serialization.

Bit-compatible with the reference's log format
(src/auto_scheduler/measure_record.cc:315-346):

    {"i": [task, [stages=[], transform_steps]],
     "r": [[costs...], error_no, all_cost, timestamp],
     "v": "v0.6"}

one record per line; lines starting with '#' or blank are comments.
A copy of ``vae_extent_search_tpu/records/serde.py``; the port's reader
also takes a gzip-compressed log (``*.gz``) as it is.
"""

from __future__ import annotations

import gzip
import json
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from ..ir.steps import Step, step_from_record
from .task import SearchTask

LOG_VERSION = "v0.6"  # reference measure_record.h:37

# MeasureErrorNo (reference python/tvm/auto_scheduler/measure.py:613-627)
ERROR_NO_ERROR = 0
ERROR_INSTANTIATION = 1
ERROR_COMPILE_HOST = 2
ERROR_COMPILE_DEVICE = 3
ERROR_RUNTIME_DEVICE = 4
ERROR_WRONG_ANSWER = 5
ERROR_BUILD_TIMEOUT = 6
ERROR_RUN_TIMEOUT = 7
ERROR_UNKNOWN = 8

MAX_FLOAT = 1e10  # error cost placeholder (search_policy.py)


@dataclass
class MeasureInput:
    task: SearchTask
    step_records: List[list]  # serialized transform steps

    @property
    def steps(self) -> List[Step]:
        return [step_from_record(r) for r in self.step_records]

    def recover_state(self, infer_bound: bool = True):
        """Rebuild the full loop State by replaying steps onto the task's
        DAG (reference measure.py:204-240 recover_measure_input)."""
        dag = self.task.compute_dag
        st = dag.apply_steps(self.step_records)
        if infer_bound:
            st = dag.infer_bound(st)
        return st


@dataclass
class MeasureResult:
    costs: List[float]
    error_no: int = 0
    all_cost: float = 0.0
    timestamp: float = 0.0

    @property
    def mean_cost(self) -> float:
        return sum(self.costs) / max(1, len(self.costs))


@dataclass
class MeasureRecord:
    inp: MeasureInput
    res: MeasureResult
    log_version: str = LOG_VERSION


def record_to_json(rec: MeasureRecord) -> str:
    obj = {
        "i": [rec.inp.task.to_record(), [[], rec.inp.step_records]],
        "r": [
            list(rec.res.costs),
            rec.res.error_no,
            rec.res.all_cost,
            int(rec.res.timestamp),
        ],
        "v": rec.log_version,
    }
    return json.dumps(obj, separators=(", ", ": "))


def record_from_json(line: str) -> MeasureRecord:
    return _record_from_obj(json.loads(line))


def _record_from_obj(obj) -> MeasureRecord:
    task_rec, state_rec = obj["i"]
    task = SearchTask.from_record(task_rec)
    step_records = state_rec[1]
    costs, error_no, all_cost, timestamp = obj["r"]
    return MeasureRecord(
        MeasureInput(task, step_records),
        MeasureResult([float(c) for c in costs], int(error_no),
                      float(all_cost), float(timestamp)),
        obj.get("v", LOG_VERSION),
    )


def iter_records(path: str, max_lines: Optional[int] = None,
                 skip_lines: int = 0) -> Iterator[MeasureRecord]:
    """Stream records from an NDJSON log (reference
    measure_record.py:94-131 RecordReader.read_lines).

    Tolerates kill-corrupted append logs: a process killed mid-write
    leaves a truncated line, and the next append continues ON that
    line — so a "line" can hold a partial record glued to complete
    ones. Such lines are split with raw_decode; undecodable fragments
    (the truncated head) are dropped, matching the append-only-log
    recovery model (every intact record survives)."""
    n = 0
    dec = json.JSONDecoder()
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#") or line.startswith(" "):
                continue
            if i < skip_lines:
                continue
            # TypeError/IndexError: valid JSON that is not a record
            # shape (null, a number, short "i" list) — same recovery
            # as undecodable text: drop the fragment, keep scanning
            try:
                recs = [record_from_json(line)]
            except (json.JSONDecodeError, KeyError, ValueError,
                    TypeError, IndexError):
                recs = []
                pos = 0
                while pos < len(line):
                    nxt = line.find('{"i"', pos + 1)
                    try:
                        obj, end = dec.raw_decode(line, pos)
                        recs.append(_record_from_obj(obj))
                        pos = end
                        while pos < len(line) and line[pos] in " \t":
                            pos += 1
                    except (json.JSONDecodeError, KeyError, ValueError,
                            TypeError, IndexError):
                        # truncated fragment: resync at the next
                        # record opener, or give up on this line
                        if nxt == -1:
                            break
                        pos = nxt
            for rec in recs:
                yield rec
                n += 1
                if max_lines is not None and n >= max_lines:
                    return


def load_records(path: str, max_lines=None, skip_lines=0) -> List[MeasureRecord]:
    return list(iter_records(path, max_lines, skip_lines))


def save_records(path: str, records: List[MeasureRecord], mode: str = "a"):
    """Append records to an NDJSON log (reference RecordToFile callback,
    measure_record.cc:348-352)."""
    with open(path, mode) as f:
        for rec in records:
            f.write(record_to_json(rec))
            f.write("\n")


def make_record(task: SearchTask, steps, costs, error_no=0, all_cost=0.0,
                timestamp=None) -> MeasureRecord:
    step_records = [
        s.to_record() if isinstance(s, Step) else s for s in steps
    ]
    return MeasureRecord(
        MeasureInput(task, step_records),
        MeasureResult(list(costs), error_no, all_cost,
                      time.time() if timestamp is None else timestamp),
    )
