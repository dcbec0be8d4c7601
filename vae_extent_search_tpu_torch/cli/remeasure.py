"""Re-measure one specific to-measure file (counterpart of
``scripts/remeasure.py``).

Parity: reference scripts/remeasure.py (:27-32): the single-file pin of
measure_programs.py, used to patch holes in a collected dataset (a worker
died mid-shard, a file got corrupted) without re-running the whole shard.
Host work; no device is involved.

    python -m vae_extent_search_tpu_torch.cli.remeasure pool.json out.json \\
        --runner replay --replay-log measured.json
"""

from __future__ import annotations

import argparse

from ..records import load_records
from ..search.measure import AnalyticRunner, RecordReplayRunner
from .measure_programs import remeasure_file


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("in_file", help="to-measure record file")
    p.add_argument("out_file", help="measured record log to write")
    p.add_argument("--runner", default="analytic",
                   choices=["analytic", "replay"])
    p.add_argument("--replay-log", default=None,
                   help="cost source for --runner replay")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--noise", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.runner == "analytic":
        runner = AnalyticRunner(noise=args.noise, seed=args.seed)
    else:
        runner = RecordReplayRunner(load_records(args.replay_log))
    n = remeasure_file(args.in_file, args.out_file, runner, args.batch)
    print(f"measured {n} programs -> {args.out_file}")
    return n


if __name__ == "__main__":
    main()
