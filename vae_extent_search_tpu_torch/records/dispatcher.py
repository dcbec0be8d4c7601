"""Best-schedule dispatch context.

Parity target: python/tvm/auto_scheduler/dispatcher.py ApplyHistoryBest —
load measure records keyed by (target key, workload hash, flattened args)
keeping the min-cost entry (:149-261); queries match exact args first, then
the best distance-factor-scaled compatible workload (:263-308, factor math
utils.py:82 calc_workload_dis_factor), plus utils.py:46
decode_workload_key flattening.

A copy of ``vae_extent_search_tpu/records/dispatcher.py``. On a miss,
``ApplyHistoryBestOrSample`` samples through the port's ``SketchPolicy``
(its CPU-target rules) and measures with the measurer it is given, or
with the analytic runner (``search/measure.py``) as the JAX package does.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Tuple

from .serde import MeasureRecord, iter_records


def decode_workload_key_flat(workload_key: str):
    """(name, flattened args tuple) — reference utils.py:46-79."""

    def flatten(inp):
        out = []
        for e in inp:
            if isinstance(e, list):
                out.extend(flatten(e))
            else:
                out.append(e)
        return out

    try:
        key_list = json.loads(workload_key)
        if isinstance(key_list, list) and len(key_list) >= 1:
            return key_list[0], tuple(flatten(key_list[1:]))
    except json.JSONDecodeError:
        pass
    return workload_key, None


def calc_workload_dis_factor(target_pair, pair) -> float:
    """reference utils.py:82-130."""
    target_key, target_args = target_pair
    key, args = pair
    target_args = target_args or ()
    args = args or ()
    if key != target_key or len(target_args) != len(args):
        return float("inf")
    dis_f = 1.0
    for ta, a in zip(target_args, args):
        if isinstance(ta, int):
            if ta == 0 or a == 0:
                if ta != a:
                    return float("inf")
            elif ta % a != 0:
                return float("inf")
            else:
                dis_f *= ta / a
        elif ta != a:
            return float("inf")
    return dis_f


def target_keys_of(target: str):
    """The matchable keys of a target string: its kind plus -keys values."""
    parts = target.split()
    keys = [parts[0]] if parts else []
    for p in parts[1:]:
        if p.startswith("-keys="):
            keys.extend(p[len("-keys="):].split(","))
    return keys


def target_model_of(target: str) -> str:
    """The -model=xxx attribute of a target string ("unknown" when absent
    — TVM's default Target.model)."""
    for p in target.split():
        if p.startswith("-model="):
            return p[len("-model="):]
    return "unknown"


class ApplyHistoryBest:
    """Min-cost schedule lookup over record logs."""

    def __init__(self, records: Optional[Iterable] = None,
                 include_compatible: bool = True):
        # (key, wkl_name, args) -> (record, cost); three tables with the
        # reference precedence (dispatcher.py:156-158, 298-317):
        # user-defined overrides > by target -model= attr > by target key
        self.best_by_targetkey: Dict[Tuple, Tuple[MeasureRecord, float]] = {}
        self.best_by_model: Dict[Tuple, Tuple[MeasureRecord, float]] = {}
        self._best_user_defined: Dict[Tuple, Tuple[MeasureRecord, float]] = {}
        self.include_compatible = include_compatible
        if records is not None:
            self.update(records)

    @classmethod
    def from_file(cls, path: str, **kw) -> "ApplyHistoryBest":
        return cls(iter_records(path), **kw)

    def update(self, records: Iterable[MeasureRecord]):
        for rec in records:
            if rec.res.error_no != 0:
                continue
            cost = rec.res.mean_cost
            name, args = decode_workload_key_flat(rec.inp.task.workload_key)
            model = target_model_of(rec.inp.task.target)
            if model != "unknown":
                key = (model, name, args)
                cur = self.best_by_model.get(key)
                if cur is None or cost < cur[1]:
                    self.best_by_model[key] = (rec, cost)
            for tkey in target_keys_of(rec.inp.task.target):
                key = (tkey, name, args)
                cur = self.best_by_targetkey.get(key)
                if cur is None or cost < cur[1]:
                    self.best_by_targetkey[key] = (rec, cost)

    def override(self, target: str, workload_key: str, record: MeasureRecord,
                 cost: float = 0.0):
        """User-defined best entry, queried before any loaded record
        (reference DispatchContext.update -> _best_user_defined)."""
        name, args = decode_workload_key_flat(workload_key)
        model = target_model_of(target)
        if model != "unknown":
            self._best_user_defined[(model, name, args)] = (record, cost)
        for tkey in target_keys_of(target):
            self._best_user_defined[(tkey, name, args)] = (record, cost)

    def _match(self, table: Dict, key: str, name, args):
        """Exact args first, else the closest compatible workload under
        the same first key, scaled by its distance factor."""
        exact = table.get((key, name, args))
        if exact is not None:
            return exact[0]
        if not self.include_compatible:
            return None
        best, best_cost = None, float("inf")
        for (k, k_name, k_args), (rec, cost) in table.items():
            if k != key:
                continue
            f = calc_workload_dis_factor((name, args), (k_name, k_args))
            if f == float("inf"):
                continue
            scaled = cost * f
            if scaled < best_cost:
                best_cost, best = scaled, rec
        return best

    def query(self, target: str, workload_key: str):
        """Best record for (target, workload) — precedence: user-defined
        by model, records by model, user-defined by target key, records
        by target key (reference _query_inside :298-317)."""
        name, args = decode_workload_key_flat(workload_key)
        model = target_model_of(target)
        if model != "unknown":
            for table in (self._best_user_defined, self.best_by_model):
                rec = self._match(table, model, name, args)
                if rec is not None:
                    return rec
        for tkey in target_keys_of(target):
            for table in (self._best_user_defined, self.best_by_targetkey):
                rec = self._match(table, tkey, name, args)
                if rec is not None:
                    return rec
        return None

    def best_cost(self, target: str, workload_key: str) -> float:
        rec = self.query(target, workload_key)
        if rec is None:
            return float("inf")
        name, args = decode_workload_key_flat(workload_key)
        r_name, r_args = decode_workload_key_flat(rec.inp.task.workload_key)
        factor = calc_workload_dis_factor((name, args), (r_name, r_args))
        factor = 1.0 if not (factor < float("inf")) else factor
        return rec.res.mean_cost * factor


class ApplyHistoryBestOrSample(ApplyHistoryBest):
    """ApplyHistoryBest that, on a miss, runs a short sampling search for
    the workload and uses its best result (reference dispatcher.py:328-415
    ApplyHistoryBestOrSample: sample an init population with zero GA
    iterations, measure the top picks, reload, re-query).

    The measurer is injected (analytic by default: a ``ProgramMeasurer``
    over ``AnalyticRunner``, which appends to ``log_file`` where given).
    """

    def __init__(self, records=None, include_compatible: bool = True,
                 cost_model=None, num_measure: int = 8,
                 sample_simple_workloads: bool = False, measurer=None,
                 log_file: Optional[str] = None):
        super().__init__(records, include_compatible=include_compatible)
        self.cost_model = cost_model
        self.num_measure = max(1, num_measure)
        self.sample_simple_workloads = sample_simple_workloads
        self.measurer = measurer
        self.log_file = log_file

    def _sample(self, target: str, workload_key: str):
        from ..search.measure import (
            AnalyticRunner,
            EmptyBuilder,
            ProgramMeasurer,
            RecordToFile,
        )
        from ..search.sketch import RandomCostModel, SketchPolicy
        from .serde import MeasureInput, MeasureRecord
        from .task import SearchTask

        task = SearchTask(workload_key, target)
        policy = SketchPolicy(
            task,
            self.cost_model or RandomCostModel(0),
            params={
                "eps_greedy": 0.01,
                "sample_init_min_population": 64,
                "evolutionary_search_num_iters": 0,
            },
        )
        states = policy.continue_search_one_round(self.num_measure)
        if not states:
            return
        callbacks = [RecordToFile(self.log_file)] if self.log_file else []
        measurer = self.measurer or ProgramMeasurer(
            EmptyBuilder(), AnalyticRunner(), callbacks=callbacks
        )
        results = measurer.measure(task, states)
        recs = [
            MeasureRecord(
                MeasureInput(task, [s.to_record()
                                    for s in st.transform_steps]),
                res,
            )
            for st, res in zip(states, results)
        ]
        self.update(recs)

    def query(self, target: str, workload_key: str):
        rec = super().query(target, workload_key)
        if rec is not None:
            name, args = decode_workload_key_flat(workload_key)
            r = decode_workload_key_flat(rec.inp.task.workload_key)
            if (name, args) == r:
                return rec  # exact hit: no sampling needed
        self._sample(target, workload_key)
        return super().query(target, workload_key)
