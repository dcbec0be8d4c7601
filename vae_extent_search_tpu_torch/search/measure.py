"""Program measurement: the builder/runner split (counterpart of
``vae_extent_search_tpu/search/measure.py``; parity target
src/auto_scheduler/measure.cc + python measure.py).

``ProgramMeasurer`` batches (state -> MeasureResult) through a Builder and
a Runner, tracks best-per-workload, aborts after ``max_continuous_error``
(measure.cc:269-336), and streams results to record-log callbacks
(``RecordToFile``). The runners:

- EmptyBuilder / EmptyRunner      no-ops (measure.py:288-305 parity)
- RecordReplayRunner              costs looked up from an existing log by
                                  printed state (the offline arm)
- AnalyticRunner                  deterministic roofline-style simulator
                                  over the schedule structure (low
                                  fidelity) or over its per-store features
                                  (high fidelity, search/analytic_hf.py)
- CommandRunner                   an external timer process
- ServiceRunner                   the tracker/server service
                                  (search/measure_service.py)
- MatmulRunner / Conv2dRunner     the port's own CUDA kernels, timed on the
                                  card (search/kernel_tuner.py)

All of them but the last two do host work only. ``AnalyticRunner`` also
measures straight from step records (``run_record_lists``, over the port's
native replay, ``records/fast_parser.py::analytic_batch_native``), with
the State path's costs bit for bit.
"""

from __future__ import annotations

import math
import os
import time
import zlib
from typing import Dict, List, Optional, Sequence

from ..ir.state import AT_INLINED, AT_ROOT, State
from ..records.serde import (
    ERROR_NO_ERROR,
    ERROR_RUNTIME_DEVICE,
    MAX_FLOAT,
    MeasureInput,
    MeasureRecord,
    MeasureResult,
    make_record,
    save_records,
)
from ..records.task import SearchTask


class Builder:
    def build(self, task: SearchTask, states: Sequence[State]) -> List[int]:
        """Return per-state error_no (0 = ok)."""
        raise NotImplementedError


def flop_repeat_count(flop_ct: float) -> int:
    """FLOP-dependent hardware-timing repeat policy (reference
    scripts/measure_programs.py:107-120): small kernels are timed more
    often because per-launch noise dominates, big kernels less because a
    single run already averages it out. Thresholds are the reference's
    verbatim."""
    if flop_ct >= 2416443392.0:
        return 4
    if flop_ct >= 834928640.0:
        return 6
    if flop_ct <= 2097152.0:
        return 10
    return 8


class Runner:
    #: timing repetitions per candidate; runners that model real timing
    #: emit ``repeat`` cost entries per record (reference
    #: measurer_kwargs['repeat'], scripts/measure_programs.py:107-120)
    repeat: int = 1

    def run(self, task: SearchTask, states: Sequence[State]) -> List[MeasureResult]:
        raise NotImplementedError


class EmptyBuilder(Builder):
    def build(self, task, states):
        return [ERROR_NO_ERROR] * len(states)


class EmptyRunner(Runner):
    def run(self, task, states):
        now = time.time()
        return [
            MeasureResult([0.0], ERROR_NO_ERROR, 0.0, now) for _ in states
        ]


class RecordReplayRunner(Runner):
    """Reveal recorded costs: the offline experiment's 'measurement'."""

    def __init__(self, records: Sequence[MeasureRecord],
                 infer_bound: bool = True):
        self.by_state: Dict[str, MeasureResult] = {}
        for rec in records:
            st = rec.inp.recover_state(infer_bound=infer_bound)
            self.by_state[st.to_str()] = rec.res

    def run(self, task, states):
        out = []
        now = time.time()
        for st in states:
            res = self.by_state.get(st.to_str())
            if res is None:
                out.append(
                    MeasureResult([MAX_FLOAT], ERROR_RUNTIME_DEVICE, 0.0, now)
                )
            else:
                out.append(res)
        return out


def _needs_bound(st: State) -> bool:
    return bool(st.stages and st.stages[-1].iters
                and st.stages[-1].iters[0].range is None)


class AnalyticRunner(Runner):
    """Deterministic roofline-style simulator.

    Scores a schedule from its loop structure: compute time = FLOPs /
    (peak * parallel_eff * vector_eff), plus penalties for poor locality
    (innermost tile volume against the cache) and unroll overhead. It is
    not a real machine: it lets the whole search stack (generation ->
    featurise -> train -> select -> measure) run end to end
    deterministically. With ``fidelity="high"`` the cost is the roofline
    over per-store features of ``search/analytic_hf.py``.
    """

    def __init__(self, peak_gflops: float = 100.0, num_cores: int = 8,
                 vector_width: int = 16, l1_elems: float = 4096.0,
                 noise: float = 0.0, seed: int = 0,
                 fidelity: str = "low", repeat: int = 1,
                 platform: Optional[str] = "auto"):
        self.peak = peak_gflops * 1e9
        self.num_cores = num_cores
        self.vector_width = vector_width
        self.l1_elems = l1_elems
        self.noise = noise
        self.seed = seed
        self.repeat = max(1, int(repeat))
        if fidelity not in ("low", "high"):
            raise ValueError(f"fidelity must be low|high, got {fidelity!r}")
        self.fidelity = fidelity
        # platform: "auto" resolves the task's target to an analytic
        # hardware profile per measure call (search/platforms.py); a
        # platform name pins one profile; None keeps the constructor
        # constants. Explicit constructor constants imply None.
        custom = (peak_gflops, num_cores, vector_width, l1_elems) != \
            (100.0, 8, 16, 4096.0)
        self.platform = None if (custom and platform == "auto") else platform

    def _apply_platform(self, task):
        """Bind the task's platform constants onto the runner; returns the
        HFHardware profile for the high-fidelity path. For the default
        platform (bare llvm / skylake / bare cuda) this leaves the
        historical constants as they are."""
        from .analytic_hf import DEFAULT_HW

        if self.platform is None:
            return DEFAULT_HW
        from .platforms import platform_by_name, platform_for_target

        p = (platform_for_target(task.target) if self.platform == "auto"
             else platform_by_name(self.platform))
        b = p.base
        self.peak = b.peak_gflops * 1e9
        self.num_cores = b.num_cores
        self.vector_width = b.vector_width
        self.l1_elems = b.l1_elems
        return p.hf

    def _rep_costs(self, key: bytes, t: float) -> List[float]:
        """Expand one simulated cost into ``repeat`` timing entries. Repeat
        0 is the base cost; later repeats get extra deterministic jitter
        keyed by (state, rep), so noise=0 stays exactly reproducible."""
        if self.repeat == 1:
            return [t]
        out = [t]
        for r in range(1, self.repeat):
            out.append(max(self._jitter(key + b"#rep%d" % r, t), 1e-9))
        return out

    def _cost(self, task: SearchTask, state: State) -> float:
        flops = task.compute_dag.flop_ct
        par = 1.0
        vec = 1.0
        tile_vol = 1.0
        unroll_pen = 1.0
        for stage in state.stages:
            if stage.op_type == "placeholder" or stage.compute_at == AT_INLINED:
                continue
            for it in stage.iters:
                ext = it.range[1] if it.range else 1
                if not isinstance(ext, int):
                    ext = 1  # data-dependent extent (GetLoopExtent rule)
                if it.annotation == 3:  # parallel
                    par = max(par, min(ext, self.num_cores))
                if it.annotation == 2:  # vectorize
                    eff = min(ext, self.vector_width) / self.vector_width
                    # over-long vectors spill registers
                    if ext > self.vector_width * 4:
                        eff *= self.vector_width * 4 / ext
                    vec = max(vec * 0.0 + (0.25 + 0.75 * eff), 0.05)
            if stage.compute_at != AT_ROOT:
                # inner tile volume = product of the stage's loop extents
                v = 1.0
                for it in stage.iters:
                    e2 = it.range[1] if it.range else 1
                    v *= e2 if isinstance(e2, int) else 1
                tile_vol = max(tile_vol, v)
            if stage.attrs.auto_unroll_max_step > 512:
                unroll_pen *= 1.1
        locality = 1.0
        if tile_vol > self.l1_elems:
            locality = 1.0 + math.log2(tile_vol / self.l1_elems)
        t = flops / (self.peak * par * vec) * locality * unroll_pen
        if self.noise:
            # deterministic per-state jitter; zlib.crc32, not hash():
            # Python's string hash is salted per process
            h = zlib.crc32(
                f"{state.to_str()}|{self.seed}".encode()
            ) % 10000 / 10000.0
            t *= 1.0 + self.noise * (h - 0.5)
        return max(t, 1e-9)

    def _jitter(self, key_text: bytes, t: float) -> float:
        """Deterministic per-state cost jitter (zlib.crc32, as above)."""
        if not self.noise:
            return t
        h = zlib.crc32(key_text + f"|{self.seed}".encode()) % 10000 / 10000.0
        return t * (1.0 + self.noise * (h - 0.5))

    def run(self, task, states):
        now = time.time()
        hw = self._apply_platform(task)
        if self.fidelity == "high":
            return self._run_hf(task, states, now, hw)
        out = []
        for st in states:
            try:
                if _needs_bound(st):
                    st = task.compute_dag.infer_bound(st)
                cost = self._cost(task, st)
                out.append(MeasureResult(
                    self._rep_costs(st.to_str().encode(), cost),
                    ERROR_NO_ERROR, 0.001, now))
            except Exception:
                out.append(MeasureResult([MAX_FLOAT], ERROR_RUNTIME_DEVICE,
                                         0.0, now))
        return out

    def _run_hf(self, task, states, now, hw=None):
        """High-fidelity path: roofline cost over per-store features (one
        featuriser call for the whole batch); the noise key is the printed
        bound state."""
        from ..features.per_store import get_per_store_features_from_states
        from .analytic_hf import DEFAULT_HW, hf_cost_from_features

        if hw is None:
            hw = DEFAULT_HW
        feats = get_per_store_features_from_states(states, task)
        out = []
        for st, fm in zip(states, feats):
            cost = hf_cost_from_features(fm, hw)
            if not math.isfinite(cost):
                out.append(MeasureResult([MAX_FLOAT], ERROR_RUNTIME_DEVICE,
                                         0.0, now))
                continue
            try:
                if _needs_bound(st):
                    st = task.compute_dag.infer_bound(st)
                key = st.to_str().encode()
            except Exception:
                out.append(MeasureResult([MAX_FLOAT], ERROR_RUNTIME_DEVICE,
                                         0.0, now))
                continue
            out.append(MeasureResult(
                self._rep_costs(key, max(self._jitter(key, cost), 1e-9)),
                ERROR_NO_ERROR, 0.001, now))
        return out

    def _cost_from_summary(self, flops: float, text: bytes,
                           stage_rows, iter_rows) -> float:
        """``_cost`` over the native schedule summary (the same expressions
        in the same order, so results equal the State path's bit for bit);
        the noise key hashes the native byte-exact printed state."""
        par = 1.0
        vec = 1.0
        tile_vol = 1.0
        unroll_pen = 1.0
        ii = 0
        for ca, au, ni in stage_rows:
            its = iter_rows[ii:ii + ni]
            ii += ni
            if ca == -1 or ca == 2:  # placeholder or inlined
                continue
            for ext, ann in its:
                ext = int(ext) if ext >= 0 else 1
                if ann == 3:  # parallel
                    par = max(par, min(ext, self.num_cores))
                if ann == 2:  # vectorize
                    eff = min(ext, self.vector_width) / self.vector_width
                    if ext > self.vector_width * 4:
                        eff *= self.vector_width * 4 / ext
                    vec = max(vec * 0.0 + (0.25 + 0.75 * eff), 0.05)
            if ca != 0:  # not at root: inner tile volume
                v = 1.0
                for ext, _ in its:
                    v *= int(ext) if ext >= 0 else 1
                tile_vol = max(tile_vol, v)
            if au > 512:
                unroll_pen *= 1.1
        locality = 1.0
        if tile_vol > self.l1_elems:
            locality = 1.0 + math.log2(tile_vol / self.l1_elems)
        t = flops / (self.peak * par * vec) * locality * unroll_pen
        if self.noise:
            h = zlib.crc32(text + f"|{self.seed}".encode()) % 10000 / 10000.0
            t *= 1.0 + self.noise * (h - 0.5)
        return max(t, 1e-9)

    def run_record_lists(self, task, record_lists):
        """Batch measurement straight from serialized step records: the
        native replay and bound inference give the byte-exact printed state
        (the noise key) and a schedule summary, so no Python State is
        built; the costs equal the State path's bit for bit. Records the
        native side cannot replay take the State path one by one. Returns
        None for a task the native side does not take (symbolic extents:
        the caller then runs ``run``)."""
        from ..records.fast_parser import (
            count_fallback,
            analytic_batch_native,
            featurize_perstore_records_native,
        )

        batch = analytic_batch_native(task, record_lists)
        if batch is None:
            return None
        statuses, texts, stage_rows, iter_rows = batch
        now = time.time()
        hw = self._apply_platform(task)
        flops = task.compute_dag.flop_ct
        hf_feats = None
        if self.fidelity == "high":
            hf_feats, _keys, _st = featurize_perstore_records_native(
                task, record_lists)
        out = []
        for i, recs in enumerate(record_lists):
            if statuses[i] == 0 and hf_feats is not None \
                    and hf_feats[i] is not None:
                from .analytic_hf import hf_cost_from_features

                cost = hf_cost_from_features(hf_feats[i], hw)
                if math.isfinite(cost):
                    out.append(MeasureResult(
                        self._rep_costs(
                            texts[i],
                            max(self._jitter(texts[i], cost), 1e-9)),
                        ERROR_NO_ERROR, 0.001, now))
                else:
                    out.append(MeasureResult([MAX_FLOAT],
                                             ERROR_RUNTIME_DEVICE, 0.0, now))
                continue
            if statuses[i] == 0 and self.fidelity == "low":
                out.append(MeasureResult(
                    self._rep_costs(
                        texts[i],
                        self._cost_from_summary(flops, texts[i],
                                                stage_rows[i],
                                                iter_rows[i])),
                    ERROR_NO_ERROR, 0.001, now))
                continue
            count_fallback("analytic:state_path")
            try:  # the State path (a native miss, or a bad record)
                st = task.compute_dag.apply_steps(recs)
                out.extend(self.run(task, [st]))
            except Exception:
                out.append(MeasureResult([MAX_FLOAT], ERROR_RUNTIME_DEVICE,
                                         0.0, now))
        return out


class CommandRunner(Runner):
    """External measurement adapter (reference LocalRunner/RPCRunner,
    measure.py:375-611): the bridge to a timer in another process.

    The batch is written as a record log (costs all zero) to a temp file;
    ``command`` is invoked as `command <in.json> <out.json> [repeat]` and
    must write, per line of <out.json> in input order, either the string
    "error" or one or more float costs (seconds) separated by commas or
    spaces, one per timing repeat. ``repeat`` (see flop_repeat_count) is
    appended to the argv only when > 1, so single-repeat timers keep
    working. Timeouts and bad lines map to error records.
    ``cli/toy_timer.py`` is such a timer.
    """

    def __init__(self, command: str, timeout: float = 600.0,
                 repeat: int = 1):
        self.command = command
        self.timeout = timeout
        self.repeat = max(1, int(repeat))

    def run(self, task, states):
        import subprocess
        import tempfile

        now = time.time()
        recs = [
            MeasureRecord(
                MeasureInput(task, [s.to_record() for s in st.transform_steps]),
                MeasureResult([0.0], 0, 0.0, now),
            )
            for st in states
        ]
        with tempfile.TemporaryDirectory() as td:
            inp = os.path.join(td, "in.json")
            outp = os.path.join(td, "out.json")
            save_records(inp, recs, mode="w")
            argv = [*self.command.split(), inp, outp]
            if self.repeat > 1:
                argv.append(str(self.repeat))
            try:
                subprocess.run(
                    argv,
                    timeout=self.timeout, check=True,
                    capture_output=True,
                )
                with open(outp) as f:
                    lines = f.read().splitlines()
            except Exception:
                lines = []
            out = []
            for i in range(len(states)):
                try:
                    costs = [float(v)
                             for v in lines[i].replace(",", " ").split()]
                    if not costs:
                        raise ValueError("empty cost line")
                    out.append(MeasureResult(costs, 0, sum(costs),
                                             time.time()))
                except (IndexError, ValueError):
                    out.append(MeasureResult([MAX_FLOAT],
                                             ERROR_RUNTIME_DEVICE, 0.0,
                                             time.time()))
        return out


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


# consecutive failed measurements after which a measurer aborts
MAX_CONTINUOUS_ERROR = 150


class ProgramMeasurer:
    """Batched measurement with best-tracking and error abort
    (measure.cc:269-336)."""

    def __init__(self, builder: Builder, runner: Runner,
                 callbacks: Optional[list] = None,
                 max_continuous_error: int = MAX_CONTINUOUS_ERROR,
                 verbose: int = 0):
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


def _spec_arg(spec: str, name: str, default: Optional[str]) -> Optional[str]:
    """The part after ``name:`` in ``spec``, ``default`` for a bare
    ``name``, None when ``spec`` is neither."""
    if spec == name:
        return default
    if spec.startswith(name + ":"):
        return spec.split(":", 1)[1]
    return None


def runner_from_spec(spec: str, noise: float = 0.0, seed: int = 0,
                     replay_log: Optional[str] = None) -> Runner:
    """One parser for the command lines' ``--runner`` spec:

    - ``analytic[:<platform>]``         the analytic simulator; the
                                        optional platform name pins one
                                        hardware profile, by default the
                                        task's target picks it
                                        (search/platforms.py)
    - ``analytic_hf[:<platform>]``      the high-fidelity variant: roofline
                                        over per-store features
                                        (search/analytic_hf.py)
    - ``replay``                        costs replayed from ``replay_log``
    - ``command:<cmd>``                 an external timer, invoked as
                                        ``<cmd> in.json out.json``
    - ``service:<key>@<host>:<port>``   measure through the tracker/server
                                        service
    - ``cuda_matmul[:<dtype>]``         time the port's CUDA matmul kernel
                                        on the card (search/kernel_tuner.py)
    - ``cuda_conv2d[:<dtype>]``         the same for its conv2d kernel
    - ``cuda_kernels[:<dtype>]``        the composite runner: each task
                                        to its family's runner (matmul,
                                        conv2d, the fused head, the GBDT
                                        histogram)

    The JAX package's TPU specs (``pallas_matmul``, ``pallas_conv2d``,
    ``pallas``) exit with the name of their counterpart here.
    """
    plat = _spec_arg(spec, "analytic", "auto")
    if plat is not None:
        return AnalyticRunner(noise=noise, seed=seed, platform=plat)
    plat = _spec_arg(spec, "analytic_hf", "auto")
    if plat is not None:
        return AnalyticRunner(noise=noise, seed=seed, fidelity="high",
                              platform=plat)
    if spec == "replay":
        if not replay_log:
            raise SystemExit("--runner replay needs --replay-log")
        from ..records.serde import load_records
        return RecordReplayRunner(load_records(replay_log))
    if spec.startswith("command:"):
        return CommandRunner(spec.split(":", 1)[1])
    for name, cls in (("cuda_matmul", "MatmulRunner"),
                      ("cuda_conv2d", "Conv2dRunner"),
                      ("cuda_kernels", "KernelRunner")):
        dtype = _spec_arg(spec, name, "bfloat16")
        if dtype is not None:
            from . import kernel_tuner
            return getattr(kernel_tuner, cls)(dtype=dtype, verbose=True)
    if spec.startswith("service:"):
        from .measure_service import ServiceRunner
        key, addr = spec.split(":", 1)[1].split("@")
        host, port = addr.rsplit(":", 1)
        return ServiceRunner(key, host, int(port))
    for name, ported in (("pallas_matmul", "cuda_matmul"),
                         ("pallas_conv2d", "cuda_conv2d"),
                         ("pallas", "cuda_kernels")):
        if _spec_arg(spec, name, "") is not None:
            raise SystemExit(
                f"--runner {spec!r} times a TPU kernel; its counterpart on "
                f"the card is --runner {ported}[:<dtype>]")
    raise SystemExit(f"unknown --runner {spec!r}")
