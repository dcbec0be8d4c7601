"""Single-task tuning entry + EmptyPolicy (counterpart of
``vae_extent_search_tpu/search/auto_schedule.py``).

Parity: src/auto_scheduler/auto_schedule.cc:87 (the ``auto_schedule``
entry: run the policy's search under TuningOptions, return the best
state) and search_policy/empty_policy.cc (EmptyPolicy: no cost model, no
evolution — random init population straight to the measurer; used by
measure_programs.py replay and tests). Host work only: the policy's
cost model, if it is a learned one, lives where its caller put it.
"""

from __future__ import annotations

from typing import Optional

from ..records.task import SearchTask, TuningOptions
from .measure import EmptyBuilder, ProgramMeasurer
from .sketch import SketchPolicy


class EmptyPolicy:
    """Random-sampling policy without evolution or a cost model."""

    def __init__(self, task: SearchTask, seed: int = 0):
        self.task = task
        self._policy = SketchPolicy(task, seed=seed)
        self.measured_state_keys = set()

    def sample_initial_population(self, num=None):
        return self._policy.sample_initial_population(num)

    def continue_search_one_round(self, num_measure: int):
        states = self._policy.sample_initial_population(num_measure * 2)
        out = []
        for st in states:
            key = st.to_str()
            if key in self.measured_state_keys:
                continue
            self.measured_state_keys.add(key)
            try:
                out.append(self.task.compute_dag.infer_bound(st))
            except Exception:
                continue
            if len(out) >= num_measure:
                break
        return out


def auto_schedule(task: SearchTask,
                  search_policy=None,
                  tuning_options: Optional[TuningOptions] = None):
    """Run the search; returns (best_state, best_cost) — the reference
    returns (schedule, args) built from the best state; without a TVM
    backend the state itself is the result (apply it via an external
    build adapter or ApplyHistoryBest)."""
    opts = tuning_options or TuningOptions()
    policy = search_policy or SketchPolicy(task)
    if opts.num_measure_trials <= 0 or opts.runner is None:
        # search without measurement (negative trials semantics,
        # task_scheduler.py:360-365): return the policy's best guess
        states = policy.continue_search_one_round(
            max(1, opts.num_measures_per_round)
        )
        return (states[0] if states else None), float("inf")

    measurer = ProgramMeasurer(
        opts.builder or EmptyBuilder(), opts.runner,
        callbacks=opts.measure_callbacks or [],
    )
    ct = 0
    best_cost = float("inf")
    no_improve_rounds = 0
    while ct < opts.num_measure_trials:
        states = policy.continue_search_one_round(opts.num_measures_per_round)
        if not states:
            break
        results = measurer.measure(task, states)
        ct += len(states)
        prev_best = best_cost
        for res in results:
            if res.error_no == 0:
                best_cost = min(best_cost, res.mean_cost)
        if opts.early_stopping > 0:
            no_improve_rounds = (
                0 if best_cost < prev_best else no_improve_rounds + 1
            )
            if no_improve_rounds * opts.num_measures_per_round >= \
                    opts.early_stopping:
                break
    best_state = measurer.best_state.get(task.workload_key)
    return best_state, measurer.best_cost.get(task.workload_key,
                                              float("inf"))
