"""One run of a cell: set-up, the measured window of closed-loop selection
phases, the per-layer reading of a traced window, and the comparison with
the plain reference that decides ``correct``.

A phase is what one step of the search does after its predictor fit:
fresh parameters (the fit's result), ``select_programs`` over the whole
pool with the measured set as its k-center centers, the host fetch of
the picks, and the measured set and its center ring updated on the host.
Each phase waits for the one before, as a search does.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, workload
from .trace import from_profiler

HERE = Path(__file__).resolve().parent
WINDOW_SPAN = "pb.phase"


@dataclass
class Kept:
    """What the check needs of one phase: its inputs and its outputs."""
    gen_state: torch.Tensor
    params: Dict
    remaining_in: torch.Tensor
    center_idx: torch.Tensor
    center_valid: torch.Tensor
    gated: bool
    outputs: tuple = ()


@dataclass
class Episode:
    measured: List[int]
    used: torch.Tensor
    remaining: torch.Tensor
    center_buf: np.ndarray
    center_n: int


@dataclass
class Run:
    """The state of one run: its cell, inputs and what the window saw."""
    cell: workload.Cell
    seed: int
    device: torch.device
    select_fn: Callable
    rehearse: bool = False
    phase_times: List[tuple] = field(default_factory=list)
    failed: int = 0
    kept: Dict[int, Kept] = field(default_factory=dict)

    def __post_init__(self):
        from vae_extent_search_tpu_torch.search.select import SelectionConfig

        c = self.cell.config
        self.scfg = SelectionConfig(
            num_select=c["num_select"], w_cost=c["w_cost"],
            w_unc=c["w_unc"], w_div=c["w_div"], grad_num=c["grad_num"],
            rand_num=c["rand_num"], T_mc=c["T_mc"],
            uncertainty_topk=c["uncertainty_topk"],
            topk_factor=c["topk_factor"], dropout_rate=c["dropout_rate"],
            max_centers=c["max_centers"], compute_dtype=c["compute_dtype"])
        self.X = workload.draw_pool(c, self.cell.traffic, self.seed,
                                    self.device)
        self.weights = workload.WeightSource(c, self.seed, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(workload.sub_seed(self.seed, workload.SELECT))
        self.sampler = np.random.default_rng(
            workload.sub_seed(self.seed, workload.SAMPLE))
        self.seen = [0] * int(self.cell.traffic["episode_phases"])
        self.center_pos = torch.arange(c["max_centers"], device=self.device)
        self.episode_no = 0
        self.ep: Optional[Episode] = None
        self.span = contextlib.nullcontext

    def start_episode(self):
        m = workload.episode_start(self.cell.traffic, self.seed,
                                   self.episode_no)
        self.episode_no += 1
        n = self.X.shape[0]
        used = torch.zeros(n, dtype=torch.bool, device=self.device)
        used[torch.as_tensor(m, device=self.device)] = True
        buf = np.zeros(self.scfg.max_centers, np.int64)
        cn = min(len(m), self.scfg.max_centers)
        buf[:cn] = m[:cn]
        self.ep = Episode(m.tolist(), used, ~used, buf, cn)

    def _mask_bits(self):
        """The kernel's dropout words for the seed the phase will draw
        (the CPU rehearsal's seam: the port's plain version takes them
        where the card's kernel draws them itself)."""
        from .reference.philox import dropout_words

        state = self.gen.get_state()
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self.gen,
                                 device=self.gen.device))
        self.gen.set_state(state)
        rows = torch.arange(self.X.shape[0])
        H0 = self.cell.config["predictor_hidden"]
        words = torch.stack([dropout_words(seed, t, rows, H0)
                             for t in range(self.scfg.T_mc)])
        words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
        return words.to(torch.int32).view(torch.uint32).contiguous()

    def phase(self, keep: bool, window: bool):
        """One selection phase: its ``Kept`` record where ``keep`` (else
        None) and its (start, select returned, end) host times."""
        ep, cfg = self.ep, self.scfg
        with self.span(WINDOW_SPAN):
            t0 = time.perf_counter()
            with self.span("pb.draw_params"):
                params = self.weights.draw()
            gated = len(ep.measured) < cfg.uncertainty_topk
            center_idx = torch.as_tensor(ep.center_buf, device=self.device)
            center_valid = self.center_pos < min(ep.center_n,
                                                 cfg.max_centers)
            rec = None
            if keep:
                rec = Kept(self.gen.get_state(), params, ep.remaining,
                           center_idx, center_valid, gated)
            extra = {"mask_bits": self._mask_bits()} if self.rehearse else {}
            with torch.no_grad(), self.span("pb.select_programs"):
                out = self.select_fn(
                    params, self.X, ep.used, ep.remaining, self.gen, cfg,
                    gate_uncertainty_to_remaining=gated,
                    center_idx=center_idx, center_valid=center_valid,
                    **extra)
            t1 = time.perf_counter()
            sel_idx, sel_valid, remaining, _ = out
            with self.span("pb.fetch_picks"):
                sel = sel_idx.cpu().numpy()[sel_valid.cpu().numpy()]
            with self.span("pb.update_measured"):
                for i in sel.tolist():
                    ep.center_buf[ep.center_n % cfg.max_centers] = i
                    ep.center_n += 1
                ep.used[torch.as_tensor(sel, device=self.device)] = True
                ep.measured.extend(sel.tolist())
                ep.remaining = remaining
            t2 = time.perf_counter()
        if window and len(sel) < cfg.num_select:
            self.failed += 1
        if rec is not None:
            rec.outputs = out
        return rec, (t0, t1, t2)

    def episodes(self, n_phases: int = 0, deadline: float = -float("inf"),
                 window: bool = True):
        """Phases until ``n_phases`` have run and the deadline has passed;
        episodes restart every ``episode_phases``."""
        E = len(self.seen)
        done = 0
        while done < n_phases or time.perf_counter() < deadline:
            pos = done % E
            if pos == 0:
                self.start_episode()
            keep = False
            if window:
                # a sample of one phase per episode position, uniform over
                # the window's episodes (reservoir sampling)
                self.seen[pos] += 1
                keep = self.sampler.integers(self.seen[pos]) == 0
            rec, times = self.phase(keep, window)
            if window:
                self.phase_times.append(times)
                if rec is not None:
                    self.kept[pos] = rec
            done += 1


def _load_metric(name: str):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_layer_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell_metrics(root: Path, cell: str, kind: str) -> List[Dict]:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, t_start: float, rehearse: bool = False,
             select_fn: Optional[Callable] = None, min_phases: int = 0
             ) -> Dict:
    """The result of one run (the dict printed as the last line).

    The measured window runs ``seconds``; a traced run follows it with a
    profiled window of the same length, whose device operations give the
    per-layer readings of the device, while the readings by the host's
    clock come from the unprofiled window."""
    from vae_extent_search_tpu_torch.ops import fused_head
    from vae_extent_search_tpu_torch.search.select import select_programs

    fused_head_stats = fused_head.fused_head_stats
    cell = workload.load_cell(root, cell_name)
    device = torch.device("cpu" if rehearse else "cuda")
    build_s = 0.0
    if device.type == "cuda":
        # the kernel's library, built by nvcc on a checkout's first run
        t_build = time.perf_counter()
        fused_head.LIB.load()
        build_s = time.perf_counter() - t_build
    run = Run(cell, seed, device, select_fn or select_programs, rehearse)
    cfg, traffic = cell.config, cell.traffic
    N = int(traffic["pool_rows"])

    # set-up: every shape of the traffic (gated and ungated phases) once
    run.episodes(n_phases=int(traffic["warmup_phases"]), window=False)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    sync()
    mem = torch.cuda if device.type == "cuda" else None
    setup_peak = mem.max_memory_allocated() if mem else 0
    if mem:
        mem.reset_peak_memory_stats()
    # the set-up's objects leave the collector's generations, so that a
    # collection inside the window walks only the window's own objects
    gc.collect()
    gc.freeze()
    launches0 = fused_head_stats.launches
    routes0 = dict(fused_head_stats.routes)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    # the window runs at least one phase
    run.episodes(n_phases=max(min_phases, 1), deadline=t0 + seconds)
    sync()
    timed = list(run.phase_times)
    window_s = timed[-1][2] - t0
    window_peak = mem.max_memory_allocated() if mem else 0

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        run.span = torch.profiler.record_function
        run.episodes(n_phases=1, deadline=time.perf_counter() + seconds)
        sync()
        prof.__exit__(None, None, None)
    phases = len(run.phase_times)

    durations = [c - a for a, _, c in timed]
    result = {
        "correct": False, "attempted": phases, "failed": run.failed,
        "metrics": {},
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(max(
                setup_peak, mem.max_memory_allocated() if mem else 0))},
    }
    counters = {
        "fused_head_launches_per_phase":
            (fused_head_stats.launches - launches0) / phases,
        "fused_head_routes": {k: v - routes0[k] for k, v in
                              fused_head_stats.routes.items()
                              if v != routes0[k]}}

    if not trace:
        known = {
            "cands_per_s": (len(timed) * N / window_s, "cands/s"),
            "phase_p95_ms": (1e3 * float(np.percentile(durations, 95)), "ms"),
            "peak_mem_gib": (window_peak / 2 ** 30, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        for m in _cell_metrics(root, cell_name, "end_to_end"):
            value, unit = known[m["name"]]
            result["metrics"][m["name"]] = {"value": value, "unit": unit}
    else:
        tr = from_profiler(prof, WINDOW_SPAN)
        ctx = {"trace": tr, "phases": phases - len(timed), "config": cfg,
               "traffic": traffic, "N": N, "timed": timed,
               "window_s": window_s}
        for m in _cell_metrics(root, cell_name, "per_layer"):
            value = _load_metric(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if device.type == "cuda":
            result["device"]["busy_s"] = tr.busy_s()
            result["device"]["window_s"] = tr.window_s()
            result["breakdown"] = {"device_ops": tr.top_ops(),
                                   "idle_gaps": tr.gaps_by_host()}
        del tr, prof
    result["counters"] = counters
    result["build_s"] = build_s

    # the comparison, once the window's state is gone but for the sample
    kept = run.kept
    X = run.X
    del run
    if mem:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(kept, X, cfg)
    result["check_s"] = time.perf_counter() - t_check
    result["correct"] = bool(kept) and check.passes(numbers, cell.limits)
    result["checked_phases"] = len(kept)
    compared = check.compared(cell.limits)
    result["not_compared"] = {k: v for k, v in numbers.items()
                              if k not in compared}
    result["compared"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                          for k in compared}
    return result
