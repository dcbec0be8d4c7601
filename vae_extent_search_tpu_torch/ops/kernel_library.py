"""Tuned-kernel dispatch: ApplyHistoryBest for the port's own kernels
(counterpart of ``vae_extent_search_tpu/ops/kernel_library.py``).

The reference's production story has two stages: tune once, then every
build consults ``ApplyHistoryBest`` for the best recorded schedule
(reference python/tvm/auto_scheduler/dispatcher.py:149-308, mirrored in
``records/dispatcher.py``). Self-tuning (``cli/tune_kernel_suite.py``)
writes logs whose states are schedules and whose costs are seconds of the
CUDA kernel each state quotients onto (``search/kernel_tuner.py``); this
library reads them back into the kernels' configs:

- ``matmul_config`` / ``conv2d_config``: a block config, re-snapped onto
  the query shape's lattice (``ops/matmul.py``, ``ops/conv2d.py``);
- ``fused_head_config``: the fused head's group count G
  (``ops/fused_head.py::fused_head_stats(groups=)``), which
  ``search/select.py`` asks for;
- ``hist_plan``: a ``hist`` launch plan ``(features, chunks)``
  (``ops/hist.py::hist(plan=)``), which ``models/boost_device.py`` asks
  for.

``matmul`` and ``conv2d`` return ``(fn, provenance)``: the CUDA kernel at
the tuned config, ``("cuda", *config)``, where a record matches, else the
PyTorch call, ``("torch",)`` (the JAX package's ``("xla",)``). The choice
is made by the records and shown by the provenance; it never depends on a
kernel failing to build or launch.

Query semantics are the reference dispatcher's: the exact (workload name,
args) first, then the compatible workload of least dis-factor-scaled cost
(reference utils.py:82-130), with the record's ``-model=<dtype>``
attribute in the role of the reference's best_by_model (records partition
by the operand dtype the kernel was timed with).

Only records measured on the card apply: a record whose target's kind is
not ``cuda`` (the JAX package's ``tpu -model=...`` logs under
``result/selftune/``, or an ``llvm`` log) is never read into the library.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..records.dispatcher import (
    calc_workload_dis_factor,
    decode_workload_key_flat,
    target_keys_of,
    target_model_of,
)
from ..records.serde import MeasureRecord, iter_records
from ..records.workload import make_workload_key
from . import conv2d as oc
from . import fused_head as fh
from . import matmul as om

# One record provides a config for any query whose args it divides (the
# reference accepts any finite dis-factor, dispatcher.py:263-308); a
# config tuned for a far larger problem is a poor prior, so cap it.
MAX_DIS_FACTOR = 1024.0
# the target kind whose records apply: schedules timed on the card
TARGET_KIND = "cuda"


class KernelLibrary:
    """Best tuned schedule per (workload, args, dtype) from measure logs of
    the card (records of another target kind are skipped)."""

    def __init__(self, records: Optional[Iterable[MeasureRecord]] = None,
                 include_compatible: bool = True):
        self.include_compatible = include_compatible
        # (name, flat args, dtype) -> (mean cost seconds, MeasureRecord)
        self._best: Dict[tuple, Tuple[float, MeasureRecord]] = {}
        self._config_cache: Dict[tuple, Optional[Tuple[int, ...]]] = {}
        self.n_skipped = 0   # records of another target kind
        if records is not None:
            self.update(records)

    @classmethod
    def from_file(cls, path: str, **kw) -> "KernelLibrary":
        return cls(iter_records(path), **kw)

    @classmethod
    def from_files(cls, paths: Iterable[str], **kw) -> "KernelLibrary":
        lib = cls(**kw)
        for p in paths:
            lib.update(iter_records(p))
        return lib

    def __len__(self) -> int:
        return len(self._best)

    def update(self, records: Iterable[MeasureRecord]):
        for rec in records:
            if rec.res.error_no != 0:
                continue
            if target_keys_of(rec.inp.task.target)[:1] != [TARGET_KIND]:
                self.n_skipped += 1
                continue
            name, args = decode_workload_key_flat(rec.inp.task.workload_key)
            if args is None:
                continue
            key = (name, args, target_model_of(rec.inp.task.target))
            cost = rec.res.mean_cost
            cur = self._best.get(key)
            if cur is None or cost < cur[0]:
                self._best[key] = (cost, rec)
        self._config_cache.clear()

    # -- dispatcher-semantics queries ------------------------------------

    def query(self, workload_key: str, dtype: str = "bfloat16",
              ) -> Optional[MeasureRecord]:
        """Best record for the workload: exact args, else the compatible
        args of least dis-factor-scaled cost (reference
        dispatcher.py:263-308). Records tuned under another dtype never
        match: a config's validity depends on it."""
        name, args = decode_workload_key_flat(workload_key)
        exact = self._best.get((name, args, dtype))
        if exact is not None:
            return exact[1]
        if not self.include_compatible or args is None:
            return None
        best_score, best_rec = float("inf"), None
        for (r_name, r_args, r_dtype), (cost, rec) in self._best.items():
            if r_name != name or r_dtype != dtype:
                continue
            factor = calc_workload_dis_factor((name, args), (r_name, r_args))
            if factor > MAX_DIS_FACTOR:
                continue
            score = factor * cost
            if score < best_score:
                best_score, best_rec = score, rec
        return best_rec

    def query_nearest(self, workload_key: str, dtype: str = "bfloat16",
                      max_log_ratio: float = None,
                      ) -> Optional[MeasureRecord]:
        """Nearest tuned record by log-shape distance (the sum of
        |log(query arg / record arg)| over numeric args, at most
        ``max_log_ratio``, by default log(MAX_DIS_FACTOR)).

        Divisibility is the right compatibility rule for matmul and conv
        schedules, but not for the fused head's pool sizes or the
        histogram's row counts and censuses: their configs re-snap onto
        the query's shape anyway, so the nearest shape is the best
        prior."""
        if max_log_ratio is None:
            max_log_ratio = math.log(MAX_DIS_FACTOR)
        name, args = decode_workload_key_flat(workload_key)
        exact = self._best.get((name, args, dtype))
        if exact is not None:
            return exact[1]
        if args is None:
            return None
        best_d, best_rec = float("inf"), None
        for (r_name, r_args, r_dtype), (cost, rec) in self._best.items():
            if r_name != name or r_dtype != dtype or r_args is None \
                    or len(r_args) != len(args):
                continue
            d, ok = 0.0, True
            for ta, a in zip(args, r_args):
                num = (isinstance(ta, (int, float))
                       and isinstance(a, (int, float)))
                if num and ta > 0 and a > 0:
                    d += abs(math.log(ta / a))
                elif ta != a:
                    ok = False
                    break
            if ok and d <= max_log_ratio and d < best_d:
                best_d, best_rec = d, rec
        return best_rec

    # -- config lookups ------------------------------------------------------

    def _cached(self, key: tuple, compute: Callable[[], Optional[tuple]]):
        if key not in self._config_cache:
            self._config_cache[key] = compute()
        return self._config_cache[key]

    def matmul_config(self, M: int, N: int, K: int, dtype: str = "bfloat16",
                      ) -> Optional[Tuple[int, int, int]]:
        """Tuned (bm, bn, bk) for [M, K] @ [K, N], snapped onto the query
        shape's lattice (a compatible record tuned at a larger shape
        re-snaps, as the reference applies a compatible schedule to the
        queried workload)."""
        from ..search.kernel_tuner import state_to_matmul_config

        def compute():
            # matmul_auto_scheduler_test(N=M, M=N, K): i over the kernel's
            # M, j over its N (records/workload_library.py)
            wk = make_workload_key("matmul_auto_scheduler_test", (M, N, K))
            rec = self.query(wk, dtype)
            if rec is None:
                return None
            raw, _why = state_to_matmul_config(rec.inp.recover_state())
            if raw is None:
                return None
            cfg = om.snap_config_to_hw(M, N, K, *raw, dtype=dtype)
            return cfg if om.config_is_valid(M, N, K, *cfg, dtype)[0] \
                else None

        return self._cached(("matmul", M, N, K, dtype), compute)

    def conv2d_config(self, N: int, H: int, W: int, CO: int, CI: int,
                      KH: int, KW: int, stride: int, pad: int,
                      dtype: str = "bfloat16",
                      ) -> Optional[Tuple[int, int, int]]:
        """Tuned (boh, bco, bci) for a conv2d_layer workload."""
        from ..search.kernel_tuner import state_to_conv_config

        params = (N, H, W, CO, CI, KH, KW, stride, pad)

        def compute():
            wk = make_workload_key(
                "conv2d_layer",
                (N, H, W, CO, CI, KH, KW, [stride, stride], [pad, pad]))
            rec = self.query(wk, dtype)
            if rec is None:
                return None
            raw, _why = state_to_conv_config(rec.inp.recover_state())
            if raw is None:
                return None
            cfg = oc.snap_conv_config_to_hw(*params, *raw, dtype=dtype)
            return cfg if oc.conv_config_is_valid(*params, *cfg,
                                                  dtype=dtype)[0] else None

        return self._cached(("conv2d",) + params + (dtype,), compute)

    def fused_head_config(self, N: int, D: int, H: int, L: int, T: int,
                          dtype: str = "bfloat16") -> Optional[int]:
        """Tuned group count G for the fused head at (N, D, H, L, T), from
        the nearest record's (block, MC chunk) through
        ``snap_fused_groups``; None where no record matches (the caller
        keeps ``launch_plan``'s G)."""
        from ..search.kernel_tuner import state_to_fusedhead_config

        def compute():
            wk = make_workload_key("fused_head_layer", (N, D, H, L, T))
            rec = self.query_nearest(wk, dtype)
            if rec is None:
                return None
            raw, _why = state_to_fusedhead_config(rec.inp.recover_state())
            return None if raw is None else fh.snap_fused_groups(N, T, *raw)

        return self._cached(("fused_head", N, D, H, L, T, dtype), compute)

    def hist_plan(self, R: int, F: int, c2: int, c16: int, c64: int,
                  c128: int) -> Optional[Tuple[int, int]]:
        """Tuned ``hist`` launch plan ``(features, chunks)`` for the device
        GBDT at a (rows, feature census) shape; None where no record
        matches (the caller keeps ``launch_plan``'s own choice).

        As in the JAX package, the query is made under the ``bfloat16``
        model whatever dtype the suite ran: histogram records written by a
        ``--dtype float32`` suite never match (ROADMAP queue 3)."""
        from ..search.kernel_tuner import state_to_hist_plan

        def compute():
            wk = make_workload_key("gbdt_hist_layer",
                                   (R, F, c2, c16, c64, c128))
            rec = self.query_nearest(wk, "bfloat16")
            if rec is None:
                return None
            raw, _why = state_to_hist_plan(rec.inp.recover_state())
            return raw

        return self._cached(("hist_plan", R, F, c2, c16, c64, c128), compute)

    # -- dispatching ops -----------------------------------------------------

    def matmul(self, M: int, N: int, K: int, dtype: str = "bfloat16"):
        """``(fn(a [M, K], b [K, N]) -> c [M, N] float32, provenance)``:
        the CUDA kernel at the tuned config where a record matches
        (``("cuda", bm, bn, bk)``), else ``torch.matmul`` of the inputs
        rounded to ``dtype``, in float32 (``("torch",)``)."""
        cfg = self.matmul_config(M, N, K, dtype)
        dt = om.DTYPES[dtype][0]
        if cfg is not None:
            def tuned(a, b):
                return om.matmul(a.to(dt).contiguous(),
                                 b.to(dt).contiguous(), *cfg)

            return tuned, ("cuda",) + cfg

        def library(a, b):
            return torch.matmul(a.to(dt).float(), b.to(dt).float())

        return library, ("torch",)

    def conv2d(self, N: int, H: int, W: int, CO: int, CI: int,
               KH: int, KW: int, stride: int, pad: int,
               dtype: str = "bfloat16"):
        """``(fn(x [N, H, W, CI], w [KH, KW, CI, CO], bias [CO]) ->
        relu(conv + bias) [N, OH, OW, CO] float32, provenance)``: the CUDA
        kernel at the tuned config (``("cuda", boh, bco, bci)``), else
        ``torch.nn.functional.conv2d`` of the inputs rounded to ``dtype``,
        in float32 (``("torch",)``). The bias is rounded to ``dtype`` and
        added in float32 either way."""
        params = (N, H, W, CO, CI, KH, KW, stride, pad)
        cfg = self.conv2d_config(*params, dtype=dtype)
        dt = om.DTYPES[dtype][0]
        if cfg is not None:
            if stride != 1:
                raise ValueError("the conv2d kernel takes stride 1")

            def tuned(x, w, bias):
                return oc.conv2d(x.to(dt).contiguous(), w.to(dt).contiguous(),
                                 bias.to(dt).float(), pad, *cfg)

            return tuned, ("cuda",) + cfg

        def library(x, w, bias):
            xn = x.to(dt).float().permute(0, 3, 1, 2)
            wn = w.to(dt).float().permute(3, 2, 0, 1)
            out = torch.nn.functional.conv2d(xn, wn, stride=stride,
                                             padding=pad)
            out = out + bias.to(dt).float()[None, :, None, None]
            return torch.relu(out).permute(0, 2, 3, 1).contiguous()

        return library, ("torch",)


# -- the process's default library (set by the environment, like the
#    reference's DispatchContext.current that every build consults) -------

LIBRARY_ENV = "VES_KERNEL_LIBRARY"
# VES_KERNEL_LIBRARY=none|off|0 turns dispatch off (hand defaults and the
# PyTorch calls everywhere)
LIBRARY_OFF_VALUES = frozenset({"none", "off", "0"})
# the port's committed tuning logs, measured on the card
COMMITTED_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "selftune")
_default_lock = threading.Lock()
_default: Optional[KernelLibrary] = None
_default_env: Optional[str] = None


def committed_log_paths() -> list:
    """The port's committed tuning logs (``data/selftune/*.json`` in the
    package): schedules measured on the card. None is committed yet, so
    this is empty. The JAX package's ``result/selftune/`` logs are TPU
    schedules and are not among them."""
    if not os.path.isdir(COMMITTED_DIR):
        return []
    return sorted(os.path.join(COMMITTED_DIR, f)
                  for f in os.listdir(COMMITTED_DIR) if f.endswith(".json"))


def default_library() -> KernelLibrary:
    """The process-wide library. With ``VES_KERNEL_LIBRARY`` unset or
    empty the committed logs load (none yet: the library is empty); set it
    to an ``os.pathsep``-separated list of logs to use those instead, or
    to ``none``/``off``/``0`` to turn dispatch off. Reloads when the
    variable changes. Whatever the logs, only ``cuda`` records apply."""
    global _default, _default_env
    env = os.environ.get(LIBRARY_ENV, "")
    with _default_lock:
        if _default is None or env != _default_env:
            if env.strip().lower() in LIBRARY_OFF_VALUES:
                paths = []
            elif env == "":
                paths = committed_log_paths()
            else:
                paths = [p for p in env.split(os.pathsep)
                         if p and os.path.exists(p)]
            _default = KernelLibrary.from_files(paths)
            _default_env = env
        return _default


def tuned_matmul(M: int, N: int, K: int, dtype: str = "bfloat16"):
    """An [M, K] @ [K, N] matmul through the default library."""
    return default_library().matmul(M, N, K, dtype)


def tuned_conv2d(N: int, H: int, W: int, CO: int, CI: int, KH: int, KW: int,
                 stride: int, pad: int, dtype: str = "bfloat16"):
    """A conv2d + bias + ReLU through the default library."""
    return default_library().conv2d(N, H, W, CO, CI, KH, KW, stride, pad,
                                    dtype)


def tuned_fused_head_config(N: int, D: int, H: int, L: int, T: int,
                            dtype: str = "bfloat16") -> Optional[int]:
    """The tuned G of the fused head, or None (``launch_plan``'s G)."""
    return default_library().fused_head_config(N, D, H, L, T, dtype)


def tuned_hist_plan(R: int, F: int, c2: int, c16: int, c64: int,
                    c128: int) -> Optional[Tuple[int, int]]:
    """The tuned ``hist`` plan for a (rows, census) shape, or None
    (``launch_plan``'s own choice)."""
    return default_library().hist_plan(R, F, c2, c16, c64, c128)
