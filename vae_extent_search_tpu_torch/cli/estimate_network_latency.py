"""Estimate end-to-end network latency from recorded best schedules
(counterpart of ``scripts/estimate_network_latency.py``).

Parity: reference scripts/estimate_network_latency.py:10-35:
sum(task_weight x best-recorded-cost) via ApplyHistoryBest. Host work
over record logs; no device is involved.

    python -m vae_extent_search_tpu_torch.cli.estimate_network_latency \\
        result/corpus/resnet_50-B1-llvm.json \\
        --target "llvm -mcpu=skylake-avx512"
"""

from __future__ import annotations

import argparse

from ..records import iter_records
from ..records.dispatcher import ApplyHistoryBest
from ..records.networks import get_network_tasks


def estimate_network_latency(log_files, network, batch_size=1,
                             image_size=224, target="llvm"):
    """(seconds, number of the network's tasks without a record)."""
    ahb = ApplyHistoryBest()
    for path in log_files:
        ahb.update(iter_records(path))
    tasks, weights = get_network_tasks(network, batch_size, image_size,
                                       target)
    total = 0.0
    missing = 0
    for task, weight in zip(tasks, weights):
        c = ahb.best_cost(task.target, task.workload_key)
        if c == float("inf"):
            missing += 1
            continue
        total += c * weight
    return total, missing


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("logs", nargs="+")
    p.add_argument("--network", type=str, default="resnet_50")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--target", type=str, default="llvm")
    args = p.parse_args(argv)

    total, missing = estimate_network_latency(
        args.logs, args.network, args.batch_size, args.image_size,
        args.target,
    )
    print(f"{args.network} (B{args.batch_size}, {args.image_size}): "
          f"estimated latency {total * 1e3:.3f} ms "
          f"({missing} tasks missing)")
    return total, missing


if __name__ == "__main__":
    main()
