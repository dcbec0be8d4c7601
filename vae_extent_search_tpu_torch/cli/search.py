"""Offline search over recorded logs (counterpart of ``scripts/search.py``).

Parity: reference scripts/search.py: ``local_search`` builds per-workload
min-heaps of (cost, record) from logs (:51-108), ``random_choose`` samples
from the top-k (:111-121), and default/random search loops evaluate
schedule choices end-to-end (:148-175). Network latency is estimated
through ApplyHistoryBest (the reference compiles through relay + graph
runtime). Host work over record logs; no device is involved.

    python -m vae_extent_search_tpu_torch.cli.search \\
        result/corpus/resnet_50-B1-llvm.json \\
        --target "llvm -mcpu=skylake-avx512"
"""

from __future__ import annotations

import argparse
import heapq

import numpy as np

from ..records import iter_records
from ..records.dispatcher import (
    ApplyHistoryBest,
    decode_workload_key_flat,
    target_keys_of,
)
from ..records.networks import get_network_tasks


def local_search(log_files, n_lines=None):
    """Per-(target key, workload) min-heaps of (cost, record)
    (reference search.py:51-108)."""
    heaps = {}
    for path in log_files:
        for i, rec in enumerate(iter_records(path)):
            if n_lines is not None and i >= n_lines:
                break
            if rec.res.error_no != 0:
                continue
            name, args = decode_workload_key_flat(rec.inp.task.workload_key)
            for tkey in target_keys_of(rec.inp.task.target):
                key = (tkey, name, args)
                heaps.setdefault(key, [])
                heapq.heappush(heaps[key], (rec.res.mean_cost, id(rec), rec))
    return heaps


def random_choose(heaps, top_k=5, seed=0):
    """Sample one of the top-k records per workload (search.py:111-121)."""
    rng = np.random.default_rng(seed)
    chosen = {}
    for key, heap in heaps.items():
        top = heapq.nsmallest(top_k, heap)
        pick = top[int(rng.integers(len(top)))]
        chosen[key] = pick[2]
    return chosen


def estimate(chosen, tasks_weights):
    total = 0.0
    for (task, weight) in tasks_weights:
        name, args = decode_workload_key_flat(task.workload_key)
        best = None
        for tkey in target_keys_of(task.target):
            rec = chosen.get((tkey, name, args))
            if rec is not None:
                best = rec
                break
        if best is not None:
            total += best.res.mean_cost * weight
    return total


def default_search(log_files, tasks_weights):
    """Pick the min-cost schedule per workload (search.py:148-160)."""
    ahb = ApplyHistoryBest()
    for path in log_files:
        ahb.update(iter_records(path))
    total = 0.0
    for task, weight in tasks_weights:
        total += ahb.best_cost(task.target, task.workload_key) * weight
    return total


def random_search(log_files, tasks_weights, rounds=5, top_k=5, seed=0):
    """Repeatedly sample top-k mixes, keep the best (search.py:162-175)."""
    heaps = local_search(log_files)
    best = float("inf")
    for r in range(rounds):
        chosen = random_choose(heaps, top_k, seed + r)
        best = min(best, estimate(chosen, tasks_weights))
    return best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("logs", nargs="+")
    p.add_argument("--network", type=str, default="resnet_50")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--target", type=str, default="llvm")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--top-k", type=int, default=5)
    args = p.parse_args(argv)

    tasks, weights = get_network_tasks(
        args.network, args.batch_size, args.image_size, args.target
    )
    tw = list(zip(tasks, weights))
    d = default_search(args.logs, tw)
    r = random_search(args.logs, tw, args.rounds, args.top_k)
    print(f"default_search estimated latency: {d * 1e3:.3f} ms")
    print(f"random_search  estimated latency: {r * 1e3:.3f} ms")
    return d, r


if __name__ == "__main__":
    main()
