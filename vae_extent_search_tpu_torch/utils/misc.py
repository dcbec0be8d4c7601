"""Small shared utilities (counterpart of
``vae_extent_search_tpu/utils/misc.py``): seeding, cost-array helpers,
the experiment path scheme, a size-capped log, a child-process timeout,
``trace_profile``, a ``torch.profiler`` trace of a block of work, and
``span``, a named range of the port's host work inside such a trace.
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Optional

import torch.autograd.profiler as _profiler


def seed_everything(seed: int = 2023):
    """Global seeding of Python's and numpy's generators (the port's torch
    draws come from explicit Generators derived from the seed)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    import numpy as np

    np.random.seed(seed)
    return seed


def array_mean(arr) -> float:
    """Mean of a cost array."""
    vals = [float(x) for x in arr]
    return sum(vals) / max(1, len(vals))


def to_str_round(x, decimal: int = 6):
    """Readable rounded rendering of nested floats."""
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(to_str_round(e, decimal) for e in x) + "]"
    if isinstance(x, dict):
        return str({k: to_str_round(v, decimal) for k, v in x.items()})
    if isinstance(x, (int,)):
        return str(x)
    if isinstance(x, float):
        fmt = "%%.%df" % decimal
        return fmt % x
    return str(x)


@contextlib.contextmanager
def trace_profile(logdir: Optional[str] = None, enabled: bool = True):
    """``torch.profiler`` scope over the block: CPU activity, and CUDA
    kernels too where CUDA is present. On exit, also when the block
    raises (the exception propagates), it writes a Chrome-trace JSON
    (``<host>_<pid>.<ms>.pt.trace.json``, TensorBoard's naming) under
    ``logdir``. Shapes, stacks and memory are not recorded: a search
    phase launches ~10^5 kernels. A no-op when ``logdir`` is None or
    ``enabled`` is False. Yields the profiler (None when off)."""
    if not enabled or logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False,
                 with_stack=False, profile_memory=False,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)) as prof:
        yield prof


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs,
    so that the trace names the port's stage the host was in at each
    device operation and each idle gap, on the profiler's own clock;
    otherwise one shared no-op context, which allocates nothing and does
    not call into the dispatcher (the check costs ~0.1 us)."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NO_SPAN


class PathManager:
    """Experiment artifact path scheme: json/tsv/tasks-pkl paths derived
    from the network and target names."""

    def __init__(self, root: str = "dataset", network: str = "network",
                 target: str = "llvm"):
        self.root = root
        self.network = network
        self.target_kind = target.split()[0] if target else target

    def _clean(self, x) -> str:
        x = str(x)
        for ch in (" ", '"', "/"):
            x = x.replace(ch, "")
        return x

    @property
    def network_info_dir(self):
        return os.path.join(self.root, "network_info")

    @property
    def to_measure_dir(self):
        return os.path.join(self.root, "to_measure_programs")

    @property
    def records_dir(self):
        return os.path.join(self.root, "measure_records")

    def task_pkl(self):
        return os.path.join(
            self.network_info_dir,
            self._clean((self.network, self.target_kind)) + ".task.pkl",
        )

    def record_log(self, workload_key: str):
        return os.path.join(
            self.records_dir,
            self._clean((workload_key, self.target_kind)) + ".json",
        )

    def latency_tsv(self):
        return os.path.join(self.root, f"{self.network}_total_latency.tsv")

    def makedirs(self):
        for d in (self.network_info_dir, self.to_measure_dir,
                  self.records_dir):
            os.makedirs(d, exist_ok=True)
        return self

    # -- cached task lists --
    def tasks_pkl_check(self) -> bool:
        return os.path.exists(self.task_pkl())

    def tasks_pkl_save(self, tasks, weights):
        import pickle

        self.makedirs()
        with open(self.task_pkl(), "wb") as f:
            pickle.dump(([t.to_record() for t in tasks], list(weights)), f)

    def tasks_pkl_use(self):
        """(tasks, weights) from the cache, or None."""
        import pickle

        if not self.tasks_pkl_check():
            return None
        from ..records.task import SearchTask

        with open(self.task_pkl(), "rb") as f:
            recs, weights = pickle.load(f)
        return [SearchTask.from_record(r) for r in recs], weights


class RotatingLog:
    """Size-capped debug log, rotated to name.1 ... name.<keep>."""

    def __init__(self, path: str, max_bytes: int = 4 * 1024 * 1024,
                 keep: int = 3):
        self.path = path
        self.max_bytes = max_bytes
        self.keep = keep

    def write(self, line: str):
        if os.path.exists(self.path) and \
                os.path.getsize(self.path) > self.max_bytes:
            # shift name.(i) -> name.(i+1), dropping the oldest
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        with open(self.path, "a") as f:
            f.write(f"[{time.strftime('%H:%M:%S')}] {line}\n")


def call_func_with_timeout(timeout: float, func, args=(), kwargs=None):
    """Run ``func`` in a child process with a hard timeout: returns the
    result, or a TimeoutError/Exception instance on failure. Used around
    external builders/runners that may hang."""
    import multiprocessing as mp

    def _worker(q, func, args, kwargs):
        try:
            q.put(("ok", func(*args, **(kwargs or {}))))
        except Exception as e:  # pragma: no cover - child-side
            q.put(("err", repr(e)))

    ctx = mp.get_context("fork")
    q = ctx.Queue(1)
    proc = ctx.Process(target=_worker, args=(q, func, args, kwargs))
    proc.start()
    proc.join(timeout)
    if proc.is_alive():
        proc.terminate()
        proc.join()
        return TimeoutError(f"timed out after {timeout}s")
    try:
        kind, payload = q.get_nowait()
    except Exception:
        return RuntimeError("child produced no result")
    if kind == "err":
        return RuntimeError(payload)
    return payload
