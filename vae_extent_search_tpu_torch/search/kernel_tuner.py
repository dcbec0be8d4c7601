"""Self-tuning: the active search tunes the port's own CUDA kernels
(counterpart of ``vae_extent_search_tpu/search/pallas_tuner.py``).

- The candidate pool is the ordinary sketch-GA pool for a matmul or
  conv2d task (``search/sketch.py``: the SSRSRS multi-level tilings Ansor
  samples, sketch_policy.cc:96-151).
- Each schedule's tile structure maps onto a block configuration of the
  port's kernel, ``(bm, bn, bk)`` for ``ops/matmul.py`` and ``(boh, bco,
  bci)`` for ``ops/conv2d.py`` (``state_to_matmul_config``,
  ``state_to_conv_config``), snapped onto the kernel's Hopper lattice.
- ``MatmulRunner`` and ``Conv2dRunner`` time that kernel on the card with
  :func:`cuda_seconds`: device time, read by CUDA events around calls that
  were all enqueued behind a blocking matrix product, so that what the host
  spends per call (the wrapper, ctypes, ``torch.empty``) cannot hide in the
  window. At the tuning shapes one call of the tensor-core kernels runs in
  tens of microseconds, about what the host takes to enqueue it; timed
  back to back, every config would read the host. The host's own ms per
  call is kept beside. Operands stay the same across launches, so at the
  benchmark shapes (which fit in the 50 MB L2) the kernel runs warm, as on
  the TPU, after the first call of each window.

Many states collapse onto one configuration; the runners time each novel
configuration once and answer the rest from a cache (the reference's
measured-state dedup, sketch_policy.cc:626-631). Before it times a
configuration, a runner holds the kernel at that configuration against its
plain version (relative error <= 2e-2), so that a configuration that
computes the wrong thing (a template instance that skips work, say) cannot
win the search. On a CUDA device a runner
launches the kernel or raises; it never times the plain version or a
library call in its place. ``time_fn`` replaces the timing (tests and the
CPU stand-in, ``--fake-timer``).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ir.state import AT_ROOT, State
from ..ops import conv2d as oc
from ..ops import fused_head as fh
from ..ops import hist as th
from ..ops import matmul as om
from ..records.serde import (
    ERROR_BUILD_TIMEOUT,
    ERROR_COMPILE_DEVICE,
    ERROR_INSTANTIATION,
    ERROR_NO_ERROR,
    MAX_FLOAT,
    MeasureResult,
)
from ..records.task import SearchTask
from ..records.workload import decode_workload_key
from .measure import Runner

VERIFY_REL_TOL = 2e-2


class NoCardError(RuntimeError):
    """A runner told to time on CUDA found no card: the measurement stops
    here rather than charging every config a failure."""


# ---------------------------------------------------------------------------
# state -> block config
# ---------------------------------------------------------------------------

def state_loops(state: State) -> List[Tuple[str, int, int]]:
    """(iterator name, extent, nest depth) in print order — the print
    traversal of ir/state.py::_print_stage, including trivial (0,1) loops
    so tile products are exact.  Depth counts every enclosing iterator
    (the printed tree's nesting), so "descendants of loop at index p" is
    exactly the run of following entries with depth > loops[p].depth."""
    loops: List[Tuple[str, int, int]] = []

    def visit(sid: int, base: int):
        stage = state.stages[sid]
        depth = base
        for i, it in enumerate(stage.iters):
            if it.range is not None and isinstance(it.range[1], int):
                loops.append((it.name, it.range[1], depth))
            depth += 1
            attached = state.attach_map.iter_to_attached_stages.get((sid, i))
            if attached:
                for a_sid in attached:
                    visit(a_sid, depth)

    for sid, stage in enumerate(state.stages):
        if stage.op_type == "placeholder":
            continue
        if stage.compute_at == AT_ROOT:
            visit(sid, 0)
    return loops


def _roots(name: str) -> set:
    # split names: "i.0"; fused names: "i.0@j.0@"; suffixed: "k.1"
    return {part.split(".")[0] for part in name.split("@") if part}


def state_to_matmul_config(
    state: State, m_root: str = "i", n_root: str = "j", k_root: str = "k",
) -> Tuple[Optional[Tuple[int, int, int]], Optional[str]]:
    """Quotient a schedule onto ``(bm, bn, bk)``.

    The cut is the outermost reduction loop: everything outside it is the
    grid of blocks, everything inside is the block. For the canonical CPU
    tiling i0 j0 i1 j1 k0 i2 j2 k1 i3 j3 (SSRSRS + reduce split,
    sketch_policy.cc:96-104) this yields bm=i2*i3, bn=j2*j3, bk=k1 —
    grid (i0*i1, j0*j1), K steps k0.  Degenerate schedules (no tiling) map
    to degenerate configs; the runner measures or rejects them on merit.
    """
    loops = state_loops(state)
    kpos = None
    for idx, (name, _, _) in enumerate(loops):
        if k_root in _roots(name):
            kpos = idx
            break
    if kpos is None:
        return None, "no reduction loop in the nest"
    k_depth = loops[kpos][2]
    bm = bn = bk = 1
    saw_k_inner = False
    for name, ext, depth in loops[kpos + 1:]:
        if depth <= k_depth:
            break  # left the outermost reduction loop's subtree
        roots = _roots(name)
        if m_root in roots:
            bm *= ext
        if n_root in roots:
            bn *= ext
        if k_root in roots:
            bk *= ext
            saw_k_inner = True
    if not saw_k_inner:
        # unsplit reduction: the single k loop IS the block's k extent
        bk = loops[kpos][1]
    return (bm, bn, bk), None


def state_to_conv_config(
    state: State,
) -> Tuple[Optional[Tuple[int, int, int]], Optional[str]]:
    """Quotient a conv2d_layer schedule onto ``(boh, bco, bci)``.

    Same cut as the matmul quotient: the outermost reduction loop
    (roots rc/ry/rx — records/workload_library.py:62-64) splits grid
    from block.  Inside it, yy extents multiply into boh (spatial output
    rows per block), ff into bco (output channels), rc into bci (input
    channels).  xx (output width: the kernel always takes full OW rows)
    and ry/rx (the kernel steps kh and kw inside the block) are quotiented
    away — interleavings the implicit-GEMM kernel cannot express collapse
    onto the same config, exactly like the matmul map.
    """
    reduce_roots = {"rc", "ry", "rx"}
    loops = state_loops(state)
    kpos = None
    for idx, (name, _, _) in enumerate(loops):
        if _roots(name) & reduce_roots:
            kpos = idx
            break
    if kpos is None:
        return None, "no reduction loop in the nest"
    k_depth = loops[kpos][2]
    boh = bco = bci = 1
    saw_rc_inner = False
    for name, ext, depth in loops[kpos + 1:]:
        if depth <= k_depth:
            break
        roots = _roots(name)
        if "yy" in roots:
            boh *= ext
        if "ff" in roots:
            bco *= ext
        if "rc" in roots:
            bci *= ext
            saw_rc_inner = True
    if not saw_rc_inner and "rc" in _roots(loops[kpos][0]):
        # unsplit channel reduction: the cut loop itself is rc
        bci = loops[kpos][1]
    return (boh, bco, bci), None


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

class Timing(NamedTuple):
    seconds: float        # device seconds per call
    host_seconds: float   # host seconds per call to enqueue it


class CudaClock:
    """What :func:`cuda_seconds` needs from the card: timing events on the
    current stream, a blocking product of known device time, a sync, and
    the host's clock. Tests hand the timer a simulated clock instead."""

    BLOCKER_N = 4096   # an f32 [4096, 4096] product, ~2.7 ms on an H100

    def __init__(self, device=None):
        self.device = torch.device("cuda") if device is None else device
        self._mat = None
        self._blocker_ms = None

    host = staticmethod(time.perf_counter)

    def event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def elapsed_ms(a, b) -> float:
        return a.elapsed_time(b)

    def sync(self):
        torch.cuda.synchronize(self.device)

    def block(self, n: int):
        if self._mat is None:
            g = torch.Generator(device=self.device).manual_seed(0)
            self._mat = torch.rand(self.BLOCKER_N, self.BLOCKER_N, generator=g,
                                   device=self.device)
            self._out = torch.empty_like(self._mat)
        for _ in range(n):
            torch.mm(self._mat, self._mat, out=self._out)

    def blocker_ms(self) -> float:
        """Device ms of one blocking product (measured once)."""
        if self._blocker_ms is None:
            self.block(2)
            a = self.event()
            self.block(3)
            b = self.event()
            self.sync()
            self._blocker_ms = self.elapsed_ms(a, b) / 3
        return self._blocker_ms


_CLOCKS: Dict[str, CudaClock] = {}
PROBE_CALLS = 5        # calls that estimate the host's and device's ms
MAX_HOST_MS = 40.0     # host enqueueing per window, at most
# calls per window, at most: the stream's queue of pending launches is
# finite (about a thousand), and a call may launch several kernels (a
# library call or a plain version); once the queue is full the host waits
# for the device and the blocker no longer hides it
MAX_CALLS = 200
BLOCK_MARGIN = 2.0     # the blocker lasts this many times the host's estimate
BLOCK_SLACK_MS = 1.0   # ... plus this


def cuda_seconds(fn: Callable[[], object], target_ms: float = 10.0,
                 repeats: int = 3, warmup: int = 2,
                 clock: Optional[CudaClock] = None) -> Timing:
    """Device seconds per call of ``fn`` (which launches work on the current
    CUDA stream), and the host's seconds per call beside.

    ``warmup`` calls; ``PROBE_CALLS`` calls back to back on the host's
    clock give the host's cost per call; then each window enqueues a
    blocking product (:class:`CudaClock`) long enough to outlast the host's
    enqueueing of the window's calls, records an event, enqueues the calls
    and records another, so that the calls wait in the stream while the
    host enqueues them and the two events see the device alone. A first
    window of ``PROBE_CALLS`` sizes the rest: ``iters`` calls, enough for
    ``target_ms`` of device time but at most ``MAX_HOST_MS`` of host time
    and ``MAX_CALLS`` calls; the minimum over ``repeats`` windows is
    returned. A window whose enqueueing outlasted its blocker is retried
    once with a blocker sized to the host time it measured; if the host is
    behind again, this raises.
    """
    clock = clock or _CLOCKS.setdefault(str(torch.cuda.current_device()),
                                        CudaClock())
    for _ in range(warmup):
        fn()
    clock.sync()
    t0 = clock.host()
    for _ in range(PROBE_CALLS):
        fn()
    host_ms = (clock.host() - t0) * 1e3 / PROBE_CALLS
    clock.sync()
    blocker = clock.blocker_ms()

    def window(iters, per_call_ms):
        need = iters * per_call_ms * BLOCK_MARGIN + BLOCK_SLACK_MS
        start = clock.event()
        clock.block(max(1, math.ceil(need / blocker)))
        mid = clock.event()
        t = clock.host()
        for _ in range(iters):
            fn()
        host = (clock.host() - t) * 1e3
        end = clock.event()
        clock.sync()
        blocked = clock.elapsed_ms(start, mid)
        dev = clock.elapsed_ms(mid, end) / iters
        return dev, host / iters, host < blocked, (host, blocked)

    def covered(iters):
        dev, host, ok, (h, b) = window(iters, host_ms)
        if not ok:
            dev, host, ok, (h, b) = window(iters, h / iters)
        if not ok:
            raise RuntimeError(
                f"the host was still enqueueing when the blocking product "
                f"ended: {iters} calls took {h:.3f} ms to enqueue, the "
                f"blocker {b:.3f} ms")
        return dev, host

    est, _ = covered(PROBE_CALLS)
    iters = max(1, min(math.ceil(target_ms / max(est, 1e-4)),
                       int(MAX_HOST_MS / max(host_ms, 1e-6)), MAX_CALLS))
    runs = [covered(iters) for _ in range(repeats)]
    return Timing(min(d for d, _ in runs) / 1e3,
                  float(np.median([h for _, h in runs])) / 1e3)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _run_cached(runner, states: Sequence[State], *, to_raw, snap, valid,
                time_cfg, shape_key: tuple, flops: float,
                names: Tuple[str, ...]) -> List[MeasureResult]:
    """Shared measure loop of the kernel runners: quotient each state onto
    a snapped block config, memoize one timing per novel config (the
    economics of the reference's measured-state dedup,
    sketch_policy.cc:626-631)."""
    out: List[MeasureResult] = []
    for st in states:
        now = time.time()
        raw, _why = to_raw(st)
        if raw is None:
            out.append(MeasureResult([MAX_FLOAT], ERROR_INSTANTIATION,
                                     0.0, now))
            continue
        cfg = snap(raw)
        key = shape_key + cfg
        res = runner.cache.get(key)
        if res is None:
            ok, _why = valid(cfg)
            if not ok:
                res = MeasureResult([MAX_FLOAT], ERROR_INSTANTIATION,
                                    0.0, now)
                runner.cache[key] = res
        if res is None:
            t0 = time.time()
            try:
                sec = time_cfg(cfg)
                res = MeasureResult([sec], ERROR_NO_ERROR,
                                    time.time() - t0, now)
            except TimeoutError:
                res = MeasureResult([MAX_FLOAT], ERROR_BUILD_TIMEOUT,
                                    time.time() - t0, now)
            except NoCardError:
                raise
            except Exception as exc:
                # a launch the kernel refused, a wrong result at the
                # verification, or a device fault: the config is charged
                # ERROR_COMPILE_DEVICE and the cause logged
                first = str(exc).splitlines()[0] if str(exc) else ""
                print(f"  config {cfg} FAILED "
                      f"{type(exc).__name__}: {first[:200]}",
                      file=sys.stderr)
                res = MeasureResult([MAX_FLOAT], ERROR_COMPILE_DEVICE,
                                    time.time() - t0, now)
            runner.cache[key] = res
            runner.n_timed += 1
            runner.timing_seconds += time.time() - t0
            if runner.verbose and res.error_no == ERROR_NO_ERROR:
                gf = flops / res.costs[0] / 1e9
                cfg_s = " ".join(f"{n}={v:<5d}" for n, v in zip(names, cfg))
                print(f"  config {cfg_s} {res.costs[0]*1e3:8.3f} ms "
                      f"{gf:10.1f} GFLOP/s")
        out.append(res)
    return out


class _KernelRunner(Runner):
    """What the matmul and conv2d runners share: options, the cache of
    timed configs, the verification of each, and the timing itself."""

    kernel: Callable = None      # the wrapper whose ``launches`` count
    n_shape: int = 0             # length of a cache key's shape part

    def __init__(self, dtype: str = "bfloat16", target_ms: float = 10.0,
                 repeats: int = 3, max_seconds: float = 2.0,
                 time_fn: Optional[Callable] = None, verbose: bool = False,
                 device="cuda"):
        if dtype not in om.DTYPES:
            raise ValueError(f"dtype must be float32 or bfloat16: {dtype!r}")
        self.dtype = dtype
        self.target_ms = target_ms
        self.repeats = repeats
        self.max_seconds = max_seconds
        self.time_fn = time_fn  # test hook: (shape..., config...) -> seconds
        self.verbose = verbose
        self.device = torch.device(device)
        self.cache: Dict[tuple, MeasureResult] = {}
        self.n_timed = 0
        self.timing_seconds = 0.0
        # kernel launches made while timing each config (verification
        # launches not counted)
        self.launches_per_config: Dict[tuple, int] = {}
        # the host's seconds per call of each timed config
        self.host_seconds: Dict[tuple, float] = {}
        # configs held against the plain version, and the largest relative
        # error among them
        self.n_verified = 0
        self.verify_rel_err: Optional[float] = None
        self._operands = {}
        self._plain_out = {}

    def _time_launches(self, shape: tuple, cfg,
                       call: Callable[[], torch.Tensor],
                       plain: Callable[[], torch.Tensor],
                       tol: float = VERIFY_REL_TOL,
                       checked: Callable = lambda out: out) -> float:
        """Hold ``call`` (the kernel at ``cfg``) against the plain version
        on the operands of ``shape`` (``checked`` picks the output held,
        within ``tol``), then time it on the card: device seconds per call
        (the host's go to ``host_seconds``)."""
        got = checked(call())
        torch.cuda.synchronize(self.device)
        want = self._plain_out.get(shape)
        if want is None:
            want = self._plain_out[shape] = plain()
        err = _rel_err(got, want)
        if not err <= tol:
            raise RuntimeError(f"kernel numerics off: rel err {err:g}")
        self.n_verified += 1
        self.verify_rel_err = max(err, self.verify_rel_err or 0.0)
        before = type(self).kernel.launches
        timing = cuda_seconds(call, self.target_ms, self.repeats)
        self.launches_per_config[cfg] = type(self).kernel.launches - before
        self.host_seconds[cfg] = timing.host_seconds
        return timing.seconds

    def _require_card(self):
        """Raise :class:`NoCardError` where the runner's CUDA device is
        absent (called before a config first touches the card)."""
        try:
            resolve_device(self.device)
        except RuntimeError as exc:
            raise NoCardError(str(exc)) from None

    def _check_device(self):
        if self.time_fn is None and self.device.type != "cuda":
            raise ValueError("timing a kernel needs a CUDA device; pass "
                             "time_fn (the --fake-timer stand-in) on the CPU")

    def measured_configs(self) -> List[Tuple[Tuple[int, ...], float, int]]:
        """(config, seconds, error_no) per distinct measured config."""
        return [(k[self.n_shape:], r.costs[0], r.error_no)
                for k, r in self.cache.items()]


class MatmulRunner(_KernelRunner):
    """Times the port's CUDA matmul (``ops/matmul.py``) on the card at the
    block config each schedule maps onto. Costs are seconds per kernel
    call, so records written through RecordToFile replay like any other
    measurement log."""

    kernel = om.matmul
    n_shape = 3

    @staticmethod
    def task_dims(task: SearchTask) -> Tuple[int, int, int]:
        """(M, N, K) in matmul terms from the workload key.
        matmul_auto_scheduler_test(N, M, K): A=(N,K) B=(K,M) C=(N,M),
        i over N(arg0), j over M(arg1) (workload_library.py) — so the
        kernel's M=args[0], N=args[1], K=args[2]."""
        name, args = decode_workload_key(task.workload_key)
        if "matmul" not in name:
            raise ValueError(
                f"MatmulRunner needs a matmul workload, got {name!r}")
        return int(args[0]), int(args[1]), int(args[2])

    def operands(self, M: int, N: int, K: int):
        """A [M, K] and B [K, N], standard normal from numpy seed 0, in
        the runner's dtype on its device (made once per shape)."""
        key = (M, N, K)
        ops = self._operands.get(key)
        if ops is None:
            rng = np.random.default_rng(0)
            dt = om.DTYPES[self.dtype][0]
            ops = self._operands[key] = tuple(
                torch.as_tensor(rng.standard_normal(s, np.float32)).to(
                    self.device, dt) for s in ((M, K), (K, N)))
        return ops

    def _time_config(self, M: int, N: int, K: int,
                     bm: int, bn: int, bk: int) -> float:
        """Seconds per kernel call (raises on a failed launch)."""
        if self.time_fn is not None:
            return float(self.time_fn(M, N, K, bm, bn, bk))
        est = om.predicted_seconds(M, N, K, bm, bn, bk, self.dtype)
        if est > self.max_seconds:
            raise TimeoutError(
                f"predicted {est:.2f}s/call exceeds --max-seconds "
                f"{self.max_seconds:g}")
        self._require_card()
        a, b = self.operands(M, N, K)
        return self._time_launches(
            (M, N, K), (bm, bn, bk), lambda: om.matmul(a, b, bm, bn, bk),
            lambda: om.matmul_plain(a, b))

    def run(self, task: SearchTask, states: Sequence[State]
            ) -> List[MeasureResult]:
        M, N, K = self.task_dims(task)
        self._check_device()
        return _run_cached(
            self, states,
            to_raw=state_to_matmul_config,
            snap=lambda raw: om.snap_config_to_hw(M, N, K, *raw,
                                                  dtype=self.dtype),
            valid=lambda cfg: om.config_is_valid(M, N, K, *cfg,
                                                 dtype=self.dtype),
            time_cfg=lambda cfg: self._time_config(M, N, K, *cfg),
            shape_key=(M, N, K),
            flops=2.0 * M * N * K,
            names=("bm", "bn", "bk"),
        )


class Conv2dRunner(_KernelRunner):
    """Times the port's CUDA conv2d + bias + ReLU (``ops/conv2d.py``) on the
    card: conv2d_layer schedules (records/workload_library.py:141, the
    reference's flagship tutorial workload) quotient onto its block
    configs."""

    kernel = oc.conv2d
    n_shape = 9

    @staticmethod
    def task_params(task: SearchTask) -> Tuple[int, ...]:
        """(N, H, W, CO, CI, KH, KW, stride, pad) from the workload key
        (conv2d_layer arg order, workload_library.py:141)."""
        name, args = decode_workload_key(task.workload_key)
        if "conv2d_layer" not in name:
            raise ValueError(
                f"Conv2dRunner needs a conv2d_layer workload, got {name!r}")
        N, H, W, CO, CI, KH, KW, stride, pad = args[:9]

        def scalar(v):
            return int(v[0]) if isinstance(v, (list, tuple)) else int(v)

        return (int(N), int(H), int(W), int(CO), int(CI), int(KH),
                int(KW), scalar(stride), scalar(pad))

    def operands(self, N, H, W, CO, CI, KH, KW):
        """x [N, H, W, CI], w [KH, KW, CI, CO] in the runner's dtype and
        bias [CO] (rounded to it, kept as float32), standard normal from
        numpy seed 0, on its device (made once per shape)."""
        key = (N, H, W, CO, CI, KH, KW)
        ops = self._operands.get(key)
        if ops is None:
            rng = np.random.default_rng(0)
            dt = om.DTYPES[self.dtype][0]
            x, w, bias = (
                torch.as_tensor(rng.standard_normal(s, np.float32)).to(
                    self.device, dt)
                for s in ((N, H, W, CI), (KH, KW, CI, CO), (CO,)))
            ops = self._operands[key] = (x, w, bias.float())
        return ops

    def _time_config(self, params: Tuple[int, ...],
                     boh: int, bco: int, bci: int) -> float:
        if self.time_fn is not None:
            return float(self.time_fn(*params, boh, bco, bci))
        N, H, W, CO, CI, KH, KW, stride, pad = params
        est = oc.predicted_conv_seconds(*params, boh, bco, bci, self.dtype)
        if est > self.max_seconds:
            raise TimeoutError(
                f"predicted {est:.2f}s/call exceeds --max-seconds "
                f"{self.max_seconds:g}")
        self._require_card()
        x, w, bias = self.operands(N, H, W, CO, CI, KH, KW)
        return self._time_launches(
            params, (boh, bco, bci),
            lambda: oc.conv2d(x, w, bias, pad, boh, bco, bci),
            lambda: oc.conv2d_plain(x, w, bias, pad))

    def run(self, task: SearchTask, states: Sequence[State]
            ) -> List[MeasureResult]:
        params = self.task_params(task)
        self._check_device()
        N, H, W, CO, CI, KH, KW, stride, pad = params
        OH = oc.conv_out_size(H, KH, stride, pad)
        OW = oc.conv_out_size(W, KW, stride, pad)
        return _run_cached(
            self, states,
            to_raw=state_to_conv_config,
            snap=lambda raw: oc.snap_conv_config_to_hw(*params, *raw,
                                                       dtype=self.dtype),
            valid=lambda cfg: oc.conv_config_is_valid(*params, *cfg,
                                                      dtype=self.dtype),
            time_cfg=lambda cfg: self._time_config(params, *cfg),
            shape_key=params,
            flops=2.0 * N * OH * OW * CO * KH * KW * CI,
            names=("boh", "bco", "bci"),
        )


# ---------------------------------------------------------------------------
# the library yardsticks (printed beside the tuned kernel, never tuned)
# ---------------------------------------------------------------------------

def time_library_matmul(M: int, N: int, K: int, dtype: str = "bfloat16",
                        target_ms: float = 10.0, repeats: int = 3,
                        device="cuda") -> Timing:
    """Device (and host) seconds per ``torch.matmul`` (cuBLAS) at the same
    shapes and input dtype, on the same operands as the runner and with the
    same timing —
    the line the tuned kernel is judged against. cuBLAS accumulates in
    float32 but writes its result in the input dtype (bf16: half the
    kernel's output bytes)."""
    a, b = MatmulRunner(dtype, device=device).operands(M, N, K)
    return cuda_seconds(lambda: torch.matmul(a, b), target_ms, repeats)


def time_library_conv2d(N: int, H: int, W: int, CO: int, CI: int,
                        KH: int, KW: int, stride: int, pad: int,
                        dtype: str = "bfloat16", target_ms: float = 10.0,
                        repeats: int = 3, device="cuda") -> Timing:
    """Device (and host) seconds per cuDNN convolution (``F.conv2d`` on channels-last
    tensors, TF32 off) + bias + ReLU at the same shapes and dtype, on the
    same operands as the runner and with the same timing."""
    import torch.nn.functional as F

    x, w, bias = Conv2dRunner(dtype, device=device).operands(
        N, H, W, CO, CI, KH, KW)
    xn = x.permute(0, 3, 1, 2)                       # NHWC memory, NCHW view
    wn = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bn = bias.to(x.dtype)

    def call():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return torch.relu(F.conv2d(xn, wn, bn, stride=stride,
                                       padding=pad))

    return cuda_seconds(call, target_ms, repeats)


# ---------------------------------------------------------------------------
# the fused cost head and the GBDT histogram: the port's own kernels
# ---------------------------------------------------------------------------

# the fused head's cost against its plain version, relative to max |cost|
FUSED_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _subtree_loops(state: State, root_name: str):
    """state_loops restricted to one root stage's subtree (the stage and
    everything compute_at-attached under it), for carrier DAGs whose
    stages reuse axis names so the flattened walk would mix nests."""
    loops: List[Tuple[str, int, int]] = []

    def visit(sid: int, base: int):
        stage = state.stages[sid]
        depth = base
        for i, it in enumerate(stage.iters):
            if it.range is not None and isinstance(it.range[1], int):
                loops.append((it.name, it.range[1], depth))
            depth += 1
            attached = state.attach_map.iter_to_attached_stages.get((sid, i))
            if attached:
                for a_sid in attached:
                    visit(a_sid, depth)

    for sid, stage in enumerate(state.stages):
        if (stage.op.name == root_name and stage.op_type != "placeholder"
                and stage.compute_at == AT_ROOT):
            visit(sid, 0)
            break
    return loops


def state_to_fusedhead_config(
    state: State,
) -> Tuple[Optional[Tuple[int, int]], Optional[str]]:
    """Quotient a fused_head_layer schedule onto ``(block, mc_chunk)``.

    Same cut as the matmul quotient, applied to the MC subtree only
    (the carrier DAG reuses axis names across its three stages, so the
    flattened state_loops walk would find A1's reduction first):
    candidate tiles (root ``i``) inside the outermost reduction loop
    multiply into the kernel's candidate block, MC-pass tiles (root
    ``t``) into its MC chunk.
    """
    loops = _subtree_loops(state, "MC")
    if not loops:
        return None, "no MC stage in the state"
    kpos = None
    for idx, (name, _, _) in enumerate(loops):
        if "k" in _roots(name):
            kpos = idx
            break
    if kpos is None:
        return None, "no reduction loop in the MC nest"
    k_depth = loops[kpos][2]
    block = tc = 1
    for name, ext, depth in loops[kpos + 1:]:
        if depth <= k_depth:
            break
        roots = _roots(name)
        if "i" in roots:
            block *= ext
        if "t" in roots:
            tc *= ext
    return (block, tc), None


def state_to_hist_plan(
    state: State,
) -> Tuple[Optional[Tuple[int, int]], Optional[str]]:
    """Quotient a gbdt_hist_layer schedule onto the CUDA ``hist`` kernel's
    own knobs, ``(features, chunks)`` for ``ops/hist.py::hist(plan=)``.

    The JAX package reads this state as a TPU tier ladder (windows over
    the bin axis ``b``, ``state_to_hist_ladder``). The CUDA kernel has no
    tiers: it takes every bin count up to 256 in one launch. Its knobs are
    the features a block holds and the row ranges the rows are cut into
    (``ops/hist.py::launch_plan``), so the state is read onto those, in
    the stage that carries the row reduction ``r`` (the cache-write stage
    where there is one):

    - ``features``: the product of the feature axis ``f``'s inner tiles,
      from the innermost outward up to the first one fused with another
      axis (its own extent is lost there) or to the outermost, which is
      left out (it counts the blocks): a cap on features per block;
    - ``chunks``: the extent of the outermost tile of ``r``: the number of
      row ranges;
    - 0 where the axis is not split: ``launch_plan``'s own choice for that
      knob. An unsplit state is ``(0, 0)``, the hand default.
    """
    loops = None
    for stage in state.stages:
        if stage.op_type == "placeholder" or not stage.op.name.startswith(
                "hist"):
            continue
        if any("r" in _roots(it.name) for it in stage.iters):
            loops = [(it.name, it.range[1]) for it in stage.iters
                     if it.range is not None and isinstance(it.range[1], int)]
            break
    if loops is None:
        return None, "no hist stage with the row reduction in the state"
    features = 0
    f_loops = [(n, e) for n, e in loops if "f" in _roots(n)]
    if any("." in n for n, _ in f_loops):
        features = 1
        for pos in range(len(f_loops) - 1, 0, -1):
            name, ext = f_loops[pos]
            if len(_roots(name)) > 1:
                break  # fused with other axes: its own extent is lost
            features *= ext
    r_loops = [(n, e) for n, e in loops if _roots(n) == {"r"}]
    chunks = 0
    if any("." in n for n, _ in r_loops):
        chunks = r_loops[0][1]
    return (features, chunks), None


def census_bins(F: int, c2: int, c16: int, c64: int, c128: int) -> int:
    """The most bins a feature of a gbdt_hist_layer census takes (the
    histogram's nb): 256 where some of the F features are continuous,
    else the widest class's bound."""
    if F > c2 + c16 + c64 + c128:
        return 256
    for bins, count in ((128, c128), (64, c64), (16, c16), (2, c2)):
        if count:
            return bins
    return 2


def snap_hist_plan(R: int, F: int, nb: int, features: int, chunks: int,
                   depth: int = 6) -> Tuple[int, int]:
    """A raw ``(features, chunks)`` clamped as ``launch_plan`` clamps it at
    the root level (a cap of F features or more is no cap; row ranges at
    most R // max(MIN_ROWS, 4 nb)), and ``(0, 0)`` where the plan launches
    as the hand default at every level of a depth-``depth`` tree, so that
    raw plans that run the same kernels share one measurement. Snapped on
    an H100's 132 SMs."""
    features = max(0, int(features))
    chunks = max(0, int(chunks))
    if features >= F:
        features = 0
    if chunks:
        chunks = max(1, min(chunks, R // max(th.MIN_ROWS, 4 * nb)))

    def plans(f, c):
        return [th.launch_plan(F, R, 1 << lv, nb, th.NUM_SMS, f or None,
                               c or None) for lv in range(depth)]

    if (features, chunks) != (0, 0) and plans(features, chunks) == plans(
            0, 0):
        return 0, 0
    return features, chunks


def fusedhead_block_flops(D: int, H: int, L: int, T: int,
                          groups: int) -> float:
    """Operations of the fused head's longest block per candidate: the
    encoder (D -> H -> H -> H -> L) and the head's forward, which every
    group runs, then the backward alone (group 0, where G > 1) or the
    longest group's share of the T MC passes (H -> H -> 1 each); with one
    group, all of them."""
    enc = D * H + 2 * H * H + H * L
    fwd = L * H + H * H + H
    bwd = H * H + H * L
    mc = H * H + H
    if groups == 1:
        return 2.0 * (enc + fwd + bwd + T * mc)
    return 2.0 * (enc + fwd + max(bwd, -(-T // (groups - 1)) * mc))


def predicted_fusedhead_seconds(N: int, D: int, H: int, L: int, T: int,
                                groups: int,
                                dtype: str = "float32") -> float:
    """A stand-in for the fused head's time on an H100 at G = ``groups``:
    the longest block's operations (:func:`fusedhead_block_flops` for
    ``BM`` candidates) at one SM's share of the dtype's peak (f32 CUDA
    cores 67 TFLOP/s, bf16 tensor cores 989), times the waves of tiles x G
    blocks over 132 SMs, plus a launch (two where G > 1). Used to refuse
    configs that would run for seconds and as the ``--fake-timer`` timer.
    Not a claim about the kernel's speed: the point is to measure."""
    blocks = -(-N // fh.BM) * groups
    block_s = fh.BM * fusedhead_block_flops(D, H, L, T, groups) / (
        om.PEAK_FLOPS[dtype] / om.NUM_SMS)
    return (math.ceil(blocks / om.NUM_SMS) * block_s
            + om.LAUNCH_S * (1 + (groups > 1)))


def predicted_hist_seconds(R: int, F: int, c2: int, c16: int, c64: int,
                           c128: int, features: int, chunks: int,
                           depth: int = 6) -> float:
    """A stand-in for ``hist``'s time per tree of depth ``depth`` on an
    H100 under the plan ``(features, chunks)``: per level, the bytes the
    launch moves (the bins once, node, grad and hess once per feature
    group, the two histograms out, and with more than one row range the
    partial sums written and read) over 3.35 TB/s, plus a launch per level
    and one per row range. Not a claim about the kernel's speed (which is
    bound by its shared atomics, not bytes): the ``--fake-timer`` timer."""
    nb = census_bins(F, c2, c16, c64, c128)
    s = 0.0
    for lv in range(depth):
        m = 1 << lv
        Fb, rows = th.launch_plan(F, R, m, nb, th.NUM_SMS, features or None,
                                  chunks or None)
        nch = -(-R // rows)
        nbytes = (F * R + -(-F // Fb) * 12 * R + 2 * F * m * nb * 4
                  + (nch > 1) * 2 * nch * F * 2 * m * nb * 8)
        s += nbytes / om.HBM_BYTES_S + om.LAUNCH_S * (1 + nch)
    return s


class FusedHeadRunner(_KernelRunner):
    """Times the port's fused cost head (``ops/fused_head.py``) on the card
    at the group count G each fused_head_layer schedule maps onto
    (``state_to_fusedhead_config``, then ``snap_fused_groups``). Costs are
    seconds per ``fused_head_stats`` call (the kernel and, at G > 1, its
    finishing kernel), with the predictor's encoder run first, at the
    workload's (N, D, H, L, T) and dropout rate 0.1."""

    kernel = fh.fused_head_stats
    n_shape = 5

    @staticmethod
    def task_dims(task: SearchTask) -> Tuple[int, int, int, int, int]:
        name, args = decode_workload_key(task.workload_key)
        if name != "fused_head_layer":
            raise ValueError(
                f"FusedHeadRunner needs fused_head_layer, got {name!r}")
        return tuple(int(a) for a in args[:5])

    def operands(self, N: int, D: int, H: int, L: int):
        """X [N, D] in the runner's dtype and the predictor's parameters
        (encoder D -> H -> H -> H, fc_mu H -> L, head L -> H -> H -> 1),
        drawn from a torch generator seeded 0 on the runner's device (made
        once per shape; timing only)."""
        from ..models.predictor import init_predictor_params

        key = (N, D, H, L)
        ops = self._operands.get(key)
        if ops is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            x = torch.randn(N, D, generator=gen, device=self.device)
            params = init_predictor_params(
                gen, D, hidden_dim=H, latent_dim=L, predictor_hidden=H,
                device=self.device)
            ops = self._operands[key] = (
                x.to(om.DTYPES[self.dtype][0]).contiguous(), params)
        return ops

    def _time_config(self, N: int, D: int, H: int, L: int, T: int,
                     groups: int) -> float:
        if self.time_fn is not None:
            return float(self.time_fn(N, D, H, L, T, groups))
        est = predicted_fusedhead_seconds(N, D, H, L, T, groups, self.dtype)
        if est > self.max_seconds:
            raise TimeoutError(
                f"predicted {est:.2f}s/call exceeds --max-seconds "
                f"{self.max_seconds:g}")
        self._require_card()
        x, params = self.operands(N, D, H, L)
        head = params["cost_predictor"]
        enc = (params["encoder"], params["fc_mu"])

        # the deterministic output (cost) is held against the plain
        # version; the MC statistics depend on the dropout bits
        return self._time_launches(
            (N, D, H, L), (groups,),
            lambda: fh.fused_head_stats(head, x, 7, T=T, rate=0.1,
                                        encoder=enc, groups=groups),
            lambda: fh.fused_head_passes_plain(head, x, 0, 0.1,
                                               encoder=enc)[0],
            tol=FUSED_TOL[self.dtype], checked=lambda out: out[0])

    def run(self, task: SearchTask, states: Sequence[State]
            ) -> List[MeasureResult]:
        N, D, H, L, T = self.task_dims(task)
        self._check_device()
        return _run_cached(
            self, states,
            to_raw=state_to_fusedhead_config,
            snap=lambda raw: (fh.snap_fused_groups(N, T, *raw),),
            valid=lambda cfg: (True, None),
            time_cfg=lambda cfg: self._time_config(N, D, H, L, T, *cfg),
            shape_key=(N, D, H, L, T),
            flops=N * fusedhead_block_flops(D, H, L, T, 1),
            names=("G",),
        )


class HistRunner(_KernelRunner):
    """Times the device GBDT (``models/boost_device.py``) under a ``hist``
    launch plan on the card: the cost recorded is seconds per boosting
    round of ``boost_device.train`` (depth 6, eta 0.03, 10 rounds, the
    pack-sum objective; the best of ``repeats`` runs after a warm-up run
    that is discarded) on the JAX runner's synthetic census corpus of the
    workload's (R, F, c2, c16, c64, c128), made with numpy from seed 0.
    A config is a plan ``(features, chunks)`` (``state_to_hist_plan``;
    ``(0, 0)`` = ``launch_plan``'s own, the hand default). Each round
    launches the kernel once per level; the grower's other per-level ops
    run in every round too."""

    kernel = th.hist
    n_shape = 6

    def __init__(self, dtype: str = "bfloat16", repeats: int = 2,
                 rounds: int = 10, depth: int = 6,
                 time_fn: Optional[Callable] = None, verbose: bool = False,
                 device="cuda", **_ignored):
        super().__init__(dtype=dtype, repeats=repeats, time_fn=time_fn,
                         verbose=verbose, device=device)
        self.rounds = rounds
        self.depth = depth
        self._dmats = {}

    @staticmethod
    def task_dims(task: SearchTask) -> Tuple[int, ...]:
        name, args = decode_workload_key(task.workload_key)
        if name != "gbdt_hist_layer":
            raise ValueError(
                f"HistRunner needs gbdt_hist_layer, got {name!r}")
        return tuple(int(a) for a in args[:6])

    def dmatrix(self, R: int, F: int, c2: int, c16: int, c64: int,
                c128: int):
        """The JAX runner's synthetic census corpus (its
        ``_get_dmatrix``, the same numpy draws): c2 binary columns, c16
        with 12 levels, c64 with 50, c128 with 100, the rest continuous;
        ~20 rows per pack, labels from the first column's pack sums."""
        from ..models import boost

        key = (R, F, c2, c16, c64, c128)
        dm = self._dmats.get(key)
        if dm is None:
            rng = np.random.default_rng(0)
            cols = []
            for _ in range(c2):
                cols.append((rng.random(R) < rng.uniform(0.05, 0.95))
                            .astype(np.float32))
            for _ in range(c16):
                cols.append(rng.integers(0, 12, R).astype(np.float32))
            for _ in range(c64):
                cols.append(rng.integers(0, 50, R).astype(np.float32))
            for _ in range(c128):
                cols.append(rng.integers(0, 100, R).astype(np.float32))
            for _ in range(max(0, F - c2 - c16 - c64 - c128)):
                cols.append(rng.random(R, dtype=np.float32))
            rows = np.stack(cols[:F], axis=1)
            n_packs = max(1, R // 20)
            pack_ids = np.sort(rng.integers(0, n_packs, R))
            _, pack_ids = np.unique(pack_ids, return_inverse=True)
            n_packs = int(pack_ids.max()) + 1
            w = 0.01 * rng.standard_normal(n_packs).astype(np.float32)
            np.add.at(w, pack_ids, rows[:, 0])
            labels = ((w - w.min()) / (w.max() - w.min() + 1e-9)
                      ).astype(np.float32)
            dm = boost.DMatrix(rows, label=labels[pack_ids],
                               pack_ids=pack_ids.astype(np.int64),
                               group_sizes=[len(labels)])
            dm._ensure_binned()
            self._dmats[key] = dm
        return dm

    def train(self, shape: Tuple[int, ...], plan: Tuple[int, int]):
        """One ``boost_device.train`` of ``rounds`` rounds under ``plan``
        on the workload's corpus (the booster)."""
        from ..models import boost, boost_device

        # eta low enough not to diverge on the synthetic corpus
        params = {"max_depth": self.depth, "eta": 0.03, "gamma": 0.003,
                  "min_child_weight": 2}
        return boost_device.train(
            params, self.dmatrix(*shape), num_boost_round=self.rounds,
            obj=boost.pack_sum_square_error, verbose_eval=0,
            hist_plan=plan, device=self.device)

    def _time_config(self, shape: Tuple[int, ...],
                     features: int, chunks: int) -> float:
        if self.time_fn is not None:
            return float(self.time_fn(*shape, features, chunks))
        self._require_card()
        plan = (features, chunks)
        before = th.hist.launches
        times = []
        for _ in range(self.repeats + 1):   # the first run warms up
            t0 = time.perf_counter()
            self.train(shape, plan)         # ends reading its trees back
            times.append(time.perf_counter() - t0)
        self.launches_per_config[plan] = th.hist.launches - before
        return min(times[1:]) / self.rounds

    def run(self, task: SearchTask, states: Sequence[State]
            ) -> List[MeasureResult]:
        shape = self.task_dims(task)
        self._check_device()
        R, F = shape[0], shape[1]
        nb = census_bins(*shape[1:])
        return _run_cached(
            self, states,
            to_raw=state_to_hist_plan,
            snap=lambda raw: snap_hist_plan(R, F, nb, *raw,
                                            depth=self.depth),
            valid=lambda cfg: (True, None),
            time_cfg=lambda cfg: self._time_config(shape, *cfg),
            shape_key=shape,
            flops=2.0 * R * F * 256 * 16,
            names=("features", "chunks"),
        )


def default_config_state(task: SearchTask) -> Optional[State]:
    """The hand default of a kernel family as an explicit State (the
    reference's PreloadMeasuredStates role): the suite measures it through
    the same runner into the same log, so that the library's min-cost
    query never falls below the hand default even where the GA misses it.

    - fused_head_layer: the MC chunk whose ``snap_fused_groups`` is
      ``launch_plan``'s G on an H100's 132 SMs (t split by it; i by ``BM``
      where it divides N, else N; k by L);
    - gbdt_hist_layer: the unsplit state, read as ``(0, 0)``:
      ``launch_plan``'s own choice at every level.
    None for the other families, whose hand default is no schedule."""
    from ..ir.schedule_api import state_reorder, state_split

    name, args = decode_workload_key(task.workload_key)
    st = task.compute_dag.init_state.copy()
    if name == "fused_head_layer":
        N, D, H, L, T = (int(a) for a in args[:5])
        G = fh.launch_plan(N, T, om.NUM_SMS)[0]
        tc = max((c for c in range(1, T + 1)
                  if fh.snap_fused_groups(N, T, 0, c) == G), default=T)
        sid = next(i for i, s in enumerate(st.stages) if s.op.name == "MC")
        t_it, i_it, k_it = st.stages[sid].iters
        block = fh.BM if N % fh.BM == 0 else N
        t0, t1 = state_split(st, sid, t_it, [tc])
        i0, i1 = state_split(st, sid, i_it, [block])
        k0, k1 = state_split(st, sid, k_it, [L])
        state_reorder(st, sid, [t0, i0, k0, t1, i1, k1])
        return st
    if name == "gbdt_hist_layer":
        return st
    return None


def default_config(task: SearchTask) -> Optional[Tuple[int, ...]]:
    """The hand default's config as its runner keys it: ``(G,)`` for the
    fused head, ``(0, 0)`` for ``hist``; None for the other families."""
    name, args = decode_workload_key(task.workload_key)
    if name == "fused_head_layer":
        return (fh.launch_plan(int(args[0]), int(args[4]), om.NUM_SMS)[0],)
    if name == "gbdt_hist_layer":
        return (0, 0)
    return None


class KernelRunner(Runner):
    """The composite runner over every kernel family the port tunes
    (counterpart of the JAX ``PallasKernelRunner``). The task scheduler
    tunes many tasks through one runner (the reference allocates one
    measurer across all tasks); this dispatches each task to its family's
    runner by workload name, so a mixed suite (``cli/tune_kernel_suite``)
    tunes through the gradient strategy like a network's task set."""

    def __init__(self, dtype: str = "bfloat16",
                 matmul_time_fn: Optional[Callable] = None,
                 conv_time_fn: Optional[Callable] = None,
                 fusedhead_time_fn: Optional[Callable] = None,
                 hist_time_fn: Optional[Callable] = None, device="cuda",
                 **kw):
        self.dtype = dtype
        self.device = torch.device(device)
        self.verbose = kw.get("verbose", False)
        self.matmul = MatmulRunner(dtype=dtype, time_fn=matmul_time_fn,
                                   device=device, **kw)
        self.conv = Conv2dRunner(dtype=dtype, time_fn=conv_time_fn,
                                 device=device, **kw)
        self.fusedhead = FusedHeadRunner(dtype=dtype,
                                         time_fn=fusedhead_time_fn,
                                         device=device, **kw)
        self.hist = HistRunner(
            dtype=dtype, time_fn=hist_time_fn, device=device,
            **{k: v for k, v in kw.items() if k in ("repeats", "verbose")})

    def family(self, task: SearchTask) -> Runner:
        """The family runner of ``task`` (the JAX ``_dispatch``)."""
        name, _ = decode_workload_key(task.workload_key)
        if "conv2d_layer" in name:
            return self.conv
        if name == "fused_head_layer":
            return self.fusedhead
        if name == "gbdt_hist_layer":
            return self.hist
        if "matmul" in name:
            return self.matmul
        raise ValueError(
            f"no kernel family for workload {name!r} (tunable: "
            "matmul_auto_scheduler_test, conv2d_layer, fused_head_layer, "
            "gbdt_hist_layer)")

    def run(self, task: SearchTask, states: Sequence[State]
            ) -> List[MeasureResult]:
        return self.family(task).run(task, states)

    @property
    def n_timed(self) -> int:
        return (self.matmul.n_timed + self.conv.n_timed
                + self.fusedhead.n_timed + self.hist.n_timed)
