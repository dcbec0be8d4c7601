"""Toy external timer for the CommandRunner measurement bridge (counterpart
of ``tools/toy_timer.py``).

Stands in for real out-of-process hardware timing (the reference's
LocalRunner/RPCRunner, measure.py:375-611): reads the record log the
CommandRunner hands it, prices each state with the deterministic analytic
simulator (``search/measure.py::AnalyticRunner``, noise 0.2) and writes one
line per record in input order, the CommandRunner wire contract: the costs
(seconds, 9 significant digits) separated by commas.

Failure injection for tests:
- ``TOY_TIMER_FAIL_EVERY=N``: write the string "error" for every Nth
  record (1-based), exercising the runner's bad-line -> error_no path.
- ``TOY_TIMER_SLEEP=S``: sleep S seconds before answering, exercising the
  runner's timeout path.

Usage: python -m vae_extent_search_tpu_torch.cli.toy_timer <in.json> <out.json> [repeat]

``repeat`` (appended by CommandRunner when its FLOP-dependent repeat
policy asks for more than 1) makes the timer write that many
comma-separated costs per line, like a multi-repeat hardware timing.
"""

import os
import sys
import time

from vae_extent_search_tpu_torch.records import load_records
from vae_extent_search_tpu_torch.search.measure import AnalyticRunner


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    in_file, out_file = argv[0], argv[1]
    repeat = int(argv[2]) if len(argv) > 2 else 1
    sleep = float(os.environ.get("TOY_TIMER_SLEEP", "0"))
    if sleep:
        time.sleep(sleep)
    fail_every = int(os.environ.get("TOY_TIMER_FAIL_EVERY", "0"))

    records = load_records(in_file)
    runner = AnalyticRunner(noise=0.2, repeat=repeat)
    lines = []
    for i, rec in enumerate(records):
        if fail_every and (i + 1) % fail_every == 0:
            lines.append("error")
            continue
        task = rec.inp.task
        state = rec.inp.recover_state(infer_bound=True)
        res = runner.run(task, [state])[0]
        lines.append(",".join(f"{c:.9g}" for c in res.costs))
    with open(out_file, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
