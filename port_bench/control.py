"""The readings the limits of ``correct`` are set from, at a cell's own
size and load: the port on many seeds (``--mode sound``), the control
(``--mode control``: the reference in the port's place in the nearest
precision below the configuration's) and each planted fault (``--mode
unchanged|half_batch|altered_pick``), all seeds in one process.

    python3 port_bench/control.py --workload vae_extent.select_262k \
        --mode sound --seeds 11 12 13 --out chiprun_out/sound.jsonl

Each run drives at least one episode (``--phases``, then ``--seconds``)
and prints, per seed, the numbers compared. The benchmark's own runs do
not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--phases", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import faults, harness, workload
    from vae_extent_search_tpu_torch.search.select import select_programs

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = workload.load_cell(ROOT, args.workload)
    rows = []
    for seed in args.seeds:
        fn = faults.select_fn(args.mode, cell.config, seed, select_programs)
        t0 = time.perf_counter()
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, t0, rehearse=args.rehearse_cpu,
                               select_fn=fn, min_phases=args.phases)
        row = {"workload": args.workload, "mode": args.mode, "seed": seed,
               "correct": res["correct"], "phases": res["attempted"],
               "checked": res["checked_phases"],
               "numbers": {**{k: v["value"] for k, v in
                              res["compared"].items()},
                           **res["not_compared"]},
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
