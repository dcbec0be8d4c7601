"""Multi-task tuning-time allocation (counterpart of
``vae_extent_search_tpu/search/task_scheduler.py``).

Parity target: python/tvm/auto_scheduler/task_scheduler.py — round-robin
and the Ansor gradient strategy (grad = chain_grad * (alpha*backward_grad
+ (1-alpha)*forward_grad), :418-474), similarity groups by op tag +
log-FLOPs (:175-202), warm-up round (:404-408), restore from log, and the
PrintTableInfo / LogEstimatedLatency callbacks (:279-283, total_latency.tsv).

The allocation, the GA and the measuring are host work. A learned cost
model (``search_policy="sketch.<kind>"``) lives on the scheduler's
``device``: CUDA by default, the CPU only when the caller asks for it.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

import numpy as np

from ..records.task import SearchTask, TuningOptions
from .measure import EmptyBuilder, ProgramMeasurer
from .sketch import SketchPolicy


def derive_similarity_tag(task: SearchTask, log_base: float = 1.618):
    """Group tag: op names + floor(log(flop_ct)) (reference
    task_scheduler.py:175-202 derive_similarity_tag)."""
    dag = task.compute_dag
    names = ",".join(
        sorted({op.name.split(".")[0] for op in dag.ops
                if not op.is_placeholder})
    )
    if dag.flop_ct <= 0:
        return ""
    return f"{names}-{int(math.log(dag.flop_ct) / math.log(log_base))}"


def _measured_score(scheduler):
    """(estimated latency over MEASURED tasks only, #unmeasured).

    Before warm-up completes, unmeasured tasks still sit at the 1e10
    dead-cost sentinel; summing those prints astronomical garbage (the
    reference callback shares the flaw). The scheduler's own cur_score
    keeps the sentinel semantics (the gradient strategy needs them) —
    only the human-facing callbacks mask."""
    costs = np.where(scheduler.best_costs < 1e9, scheduler.best_costs,
                     0.0)
    n_unmeasured = int(np.sum(scheduler.best_costs >= 1e9))
    return scheduler._compute_score(costs), n_unmeasured


class PrintTableInfo:
    def callback(self, scheduler):
        print("| ID | Latency (ms) | Speed (GFLOPS) | Trials |")
        for i, task in enumerate(scheduler.tasks):
            cost = scheduler.best_costs[i]
            gflops = (
                task.compute_dag.flop_ct / cost / 1e9
                if cost < 1e9 else 0.0
            )
            lat = f"{cost * 1e3:12.3f}" if cost < 1e9 else f"{'-':>12}"
            print(f"| {i:2d} | {lat} | {gflops:14.2f} "
                  f"| {scheduler.task_cts[i]:6d} |")
        score, miss = _measured_score(scheduler)
        suffix = f" ({miss} tasks unmeasured)" if miss else ""
        print(f"Estimated total latency: {score * 1e3:.3f} ms"
              f"{suffix}  Trials: {scheduler.ct}")


class LogEstimatedLatency:
    def __init__(self, log_file: str = "total_latency.tsv"):
        self.log_file = log_file

    def callback(self, scheduler):
        score, miss = _measured_score(scheduler)
        with open(self.log_file, "a") as f:
            f.write(
                f"ElapsedTime(s)\t{time.time() - scheduler.tic:.0f}\t"
                f"EstimatedLatency(ms)\t{score * 1e3:.3f}\t"
                f"Trials\t{scheduler.ct}\t"
                f"Unmeasured\t{miss}\n"
            )


class TaskScheduler:
    """Allocate measurement trials across tasks. ``device`` is where a
    ``sketch.<kind>`` policy's learned model lives."""

    def __init__(self, tasks: List[SearchTask],
                 task_weights: Optional[List[float]] = None,
                 objective_func: Optional[Callable] = None,
                 strategy: str = "gradient", alpha: float = 0.2,
                 beta: float = 2.0, backward_window_size: int = 3,
                 callbacks=None, seed: int = 0, device="cuda"):
        self.tasks = tasks
        self.task_weights = task_weights or [1.0] * len(tasks)
        self.objective_func = objective_func or (
            lambda costs: sum(c * w for c, w in zip(costs, self.task_weights))
        )
        self.strategy = strategy
        self.alpha = alpha
        self.beta = beta
        self.backward_window_size = backward_window_size
        self.callbacks = callbacks if callbacks is not None else [
            PrintTableInfo(), LogEstimatedLatency()
        ]
        self.rng = np.random.default_rng(seed)
        self.device = device

        n = len(tasks)
        self.best_costs = np.full(n, 1e10)
        self.task_cts = [0] * n
        self.task_best_cts = [0] * n
        self.task_costs_history: List[List[float]] = [[] for _ in range(n)]
        self.dead_tasks = set()
        self.flop_cts = [t.compute_dag.flop_ct for t in tasks]
        self.ct = 0
        self.tic = time.time()
        self.cur_score = self._compute_score(self.best_costs)

        # similarity groups
        self.task_tags = []
        self.tag_to_group_id = {}
        self.group_task_ids: List[List[int]] = []
        for i, task in enumerate(tasks):
            tag = derive_similarity_tag(task)
            self.task_tags.append(tag)
            if not tag:
                continue
            gid = self.tag_to_group_id.get(tag)
            if gid is None:
                gid = len(self.tag_to_group_id)
                self.tag_to_group_id[tag] = gid
                self.group_task_ids.append([])
            self.group_task_ids[gid].append(i)

    def _compute_score(self, costs) -> float:
        return float(self.objective_func(list(costs)))

    # ------------------------------------------------------------------
    def tune(self, tune_option: TuningOptions, search_policy="sketch",
             search_policy_params=None, policies=None, cost_model=None,
             per_task_early_stopping=None, load_model_file=None):
        n = len(self.tasks)
        self.measurer = ProgramMeasurer(
            tune_option.builder or EmptyBuilder(),
            tune_option.runner,
            callbacks=tune_option.measure_callbacks or [],
        )
        self.num_measures_per_round = tune_option.num_measures_per_round
        self.cost_model = cost_model
        if policies is not None:
            self.search_policies = policies
        elif isinstance(search_policy, str) and "." in search_policy:
            from .cost_model import make_search_policies

            self.search_policies, self.cost_model = make_search_policies(
                search_policy, self.tasks,
                load_model_file=load_model_file,
                num_measures_per_round=self.num_measures_per_round,
                device=self.device,
            )
        else:
            self.search_policies = [
                SketchPolicy(t, params=search_policy_params, seed=i)
                for i, t in enumerate(self.tasks)
            ]

        # warm-up round robin (reference :404-408)
        for i in range(n):
            if not self.task_cts[i]:
                self._tune_task(i)

        task_idx = -1
        while self.ct < tune_option.num_measure_trials and \
                len(self.dead_tasks) < n:
            if self.strategy == "round-robin":
                task_idx = (task_idx + 1) % n
                while task_idx in self.dead_tasks:
                    task_idx = (task_idx + 1) % n
            elif self.strategy == "gradient":
                task_idx = self._gradient_select()
            else:
                raise ValueError(f"invalid strategy {self.strategy}")
            self._tune_task(task_idx)
        for cb in self.callbacks:
            cb.callback(self)

    def _objective_sensitivity(self, i: int, delta: float = 1e-4) -> float:
        """d(objective)/d(cost_i) by finite difference — how much the
        whole-suite score moves if task i's best latency improves (the
        chain-rule outer term of Ansor §6's allocation gradient)."""
        probe = list(self.best_costs)
        probe[i] -= delta
        return (self._compute_score(self.best_costs)
                - self._compute_score(probe)) / delta

    def _history_slope(self, i: int) -> float:
        """Observed per-round improvement of task i over the backward
        window (zero until the window fills)."""
        hist = self.task_costs_history[i]
        last = self.task_cts[i] - 1
        first = last - self.backward_window_size
        if last >= len(hist) or first < 0:
            return 0.0
        return (hist[last] - hist[first]) / self.backward_window_size

    def _predicted_next_cost(self, i: int) -> float:
        """Optimistic next-round latency for task i: the per-round decay
        extrapolation, capped by the similarity-group bound (a task
        cannot beat beta x its group's best achieved FLOPS)."""
        rounds = max(self.task_cts[i], 1)
        decay_estimate = self.best_costs[i] * (1.0 - 1.0 / rounds)
        group_bound = self.beta * 1e30
        gid = self.tag_to_group_id.get(self.task_tags[i])
        if gid is not None and len(self.group_task_ids[gid]) > 1:
            group_best_flops = max(
                self.flop_cts[j] / self.best_costs[j]
                for j in self.group_task_ids[gid]
            )
            group_bound = self.beta * self.flop_cts[i] / group_best_flops
        return min(decay_estimate, group_bound)

    def _gradient_select(self) -> int:
        """Pick the task whose next round most decreases the suite
        objective (Ansor §6; reference task_scheduler.py:418-474):
        allocation gradient = sensitivity x blend of the observed
        history slope (weight alpha) and the optimistic forecast
        improvement (weight 1 - alpha); most-negative gradient wins."""
        gradients = []
        for i in range(len(self.tasks)):
            if i in self.dead_tasks:
                gradients.append(0.0)
                continue
            forecast_improvement = (
                self._predicted_next_cost(i) - self.best_costs[i])
            blended = (self.alpha * self._history_slope(i)
                       + (1 - self.alpha) * forecast_improvement)
            gradients.append(
                min(self._objective_sensitivity(i) * blended, 0.0))

        if max(gradients) == min(gradients):
            return int(self.rng.integers(len(gradients)))
        return int(np.argmin(gradients))

    def _tune_task(self, idx: int):
        policy = self.search_policies[idx]
        task = self.tasks[idx]
        states = policy.continue_search_one_round(
            self.num_measures_per_round
        )
        if not states:
            self.dead_tasks.add(idx)
            return
        results = self.measurer.measure(task, states)
        # unconditional, as in the JAX package: a '-no-update' policy's
        # freeze does not reach a model handed in as cost_model (the
        # PlusMix delta of transfer_tune's stage 2; see transfer_tune)
        if getattr(self, "cost_model", None) is not None:
            from ..records.serde import MeasureInput

            inputs = [
                MeasureInput(task, [s.to_record()
                                    for s in st.transform_steps])
                for st in states
            ]
            self.cost_model.update(inputs, results)
        self.ct += len(states)
        self.task_cts[idx] += 1
        for res in results:
            if res.error_no == 0:
                cost = res.mean_cost
                if cost < self.best_costs[idx]:
                    self.best_costs[idx] = cost
                    self.task_best_cts[idx] = self.task_cts[idx]
        self.task_costs_history[idx].append(float(self.best_costs[idx]))
        self.cur_score = self._compute_score(self.best_costs)
        for cb in self.callbacks:
            cb.callback(self)


def restore_status_from_log(scheduler: TaskScheduler, log_file: str):
    """Rebuild per-task trial counts and best costs from an existing log
    (reference task_scheduler.py:386-388,150 _restore_status).

    Two faults of the JAX package's route are kept as they are (its
    ``scripts/tune_network.py:55-62`` calls this before ``tune()``):

    - the policies are built by ``tune()``, so on that route
      ``search_policies`` does not exist yet and no policy reaches
      ``preload_measured_states``: ``--continue-tuning`` may measure
      recorded states again;
    - ``tune()`` sets ``num_measures_per_round`` too, so on that route a
      restored task's trial count is ``records // 64``, not ``// 16``.
    """
    import os

    from ..records.serde import iter_records

    if not os.path.exists(log_file):
        return scheduler
    key_to_idx = {t.workload_key: i for i, t in enumerate(scheduler.tasks)}
    counts = [0] * len(scheduler.tasks)
    for rec in iter_records(log_file):
        idx = key_to_idx.get(rec.inp.task.workload_key)
        if idx is None or rec.res.error_no != 0:
            continue
        counts[idx] += 1
        cost = rec.res.mean_cost
        if cost < scheduler.best_costs[idx]:
            scheduler.best_costs[idx] = cost
    for i, c in enumerate(counts):
        if c:
            scheduler.task_cts[i] = max(
                1, c // max(1, getattr(scheduler, "num_measures_per_round", 64))
            )
            scheduler.task_costs_history[i].append(
                float(scheduler.best_costs[i])
            )
    scheduler.cur_score = scheduler._compute_score(scheduler.best_costs)
    # mark recorded states as measured on each policy so tuning resumes
    # without re-measuring them (reference PreloadMeasuredStates)
    for policy in getattr(scheduler, "search_policies", None) or []:
        if hasattr(policy, "preload_measured_states"):
            try:
                policy.preload_measured_states(log_file)
            except Exception:
                pass
    return scheduler


def transfer_tune(scheduler: TaskScheduler, tune_option,
                  search_policy="sketch", load_model_file=None,
                  **tune_kwargs):
    """Two-stage tuning (reference task_scheduler.py:498-583): tune the
    first half of the tasks with the (optionally pretrained) model, then
    rebuild the cost model as BASE + DELTA — the pretrained base stays
    frozen and a fresh calibrated delta model trains on the residuals of
    the first half's measurements (``plus_mix_task``,
    mlp_model.py:446-474) — and tune the second half with the combined
    model. The delta keeps refitting as second-half measurements arrive;
    the base never moves. Both stages' models live on the scheduler's
    ``device``.

    A fault of the reference kept for parity with the JAX package: with a
    ``sketch.<kind>-no-update`` policy only stage 1's model is frozen.
    Stage 2's ``_tune_task`` calls ``cost_model.update`` on every round
    whatever the policy said, so the delta still refits there
    (``tests/test_torch_cost_model.py::
    test_transfer_tune_no_update_still_refits_the_delta_in_stage_2``)."""
    import copy

    n = len(scheduler.tasks)
    half = max(1, n // 2)
    first = TaskScheduler(
        scheduler.tasks[:half], scheduler.task_weights[:half],
        strategy=scheduler.strategy, callbacks=[], device=scheduler.device,
    )
    opts1 = copy.copy(tune_option)
    opts1.num_measure_trials = tune_option.num_measure_trials // 2
    first.tune(opts1, search_policy=search_policy,
               load_model_file=load_model_file, **tune_kwargs)

    # -- plus_mix refit: frozen base + delta on the stage-1 residuals --
    policies = None
    stage1_model = getattr(first, "cost_model", None)
    if stage1_model is not None and hasattr(stage1_model, "internal"):
        from .cost_model import (
            LearnedCostModel,
            PlusMixCostModel,
            parse_search_policy,
        )

        kind = "mlp"
        if isinstance(search_policy, str) and "." in search_policy:
            kind = parse_search_policy(search_policy)[0]
        if load_model_file:
            # reference: reload the PRISTINE pretrained base for stage 2
            # (make_search_policies loads load_model_file afresh,
            # task_scheduler.py:569-574) — stage-1 online updates to the
            # shared model do not leak into the frozen base
            base = LearnedCostModel.load(load_model_file, kind,
                                         device=scheduler.device)
        else:
            base = stage1_model
        mixed = PlusMixCostModel(base, kind=kind)
        # seed the delta with everything stage 1 measured; a frozen
        # ('-no-update') stage-1 model accumulated nothing, so fall back
        # to the measurement log (the reference fits local from
        # load_log_file, task_scheduler.py:570-574)
        mixed._inputs = list(stage1_model._inputs)
        mixed._results = list(stage1_model._results)
        if not mixed._inputs:
            import os

            for cb in tune_option.measure_callbacks or []:
                log = getattr(cb, "filename", None)
                if log and os.path.exists(log):
                    from ..records.serde import load_records

                    for rec in load_records(log):
                        mixed._inputs.append(rec.inp)
                        mixed._results.append(rec.res)
                    break
        mixed.update(None, None)
        policies = [
            SketchPolicy(t, mixed, seed=1000 + i)
            for i, t in enumerate(scheduler.tasks[half:])
        ]

    second = TaskScheduler(
        scheduler.tasks[half:], scheduler.task_weights[half:],
        strategy=scheduler.strategy, callbacks=[], device=scheduler.device,
    )
    opts2 = copy.copy(tune_option)
    opts2.num_measure_trials = (
        tune_option.num_measure_trials - opts1.num_measure_trials
    )
    if policies is not None:
        second.tune(opts2, policies=policies, cost_model=mixed,
                    **tune_kwargs)
    else:
        second.tune(opts2, search_policy=search_policy,
                    load_model_file=load_model_file, **tune_kwargs)

    # merge results back
    scheduler.best_costs[:half] = first.best_costs
    scheduler.best_costs[half:] = second.best_costs
    scheduler.ct = first.ct + second.ct
    scheduler.cur_score = scheduler._compute_score(scheduler.best_costs)
    # expose the stage-2 combined model for inspection / reuse
    scheduler.transfer_model = mixed if policies is not None else None
    return scheduler
