"""Concatenate a network's per-task record files into one log
(counterpart of ``scripts/network2measure_records.py``).

Parity: reference scripts/network2measure_records.py: for each task of a
network task pickle (``cli.dump_network_info``'s ``(task records,
weights)``), append the records of
``$VES_DATASET_ROOT/measure_records/<clean_name((key, target kind))>.json``
to ``--out-file`` in task order, and name the files that are missing.
Host work; no device is involved.

    python -m vae_extent_search_tpu_torch.cli.network2measure_records \\
        --network-task-pkl dataset/network_info/<net>.task.pkl --out-file net.json
"""

from __future__ import annotations

import argparse
import os
import pickle

from ..records import SearchTask
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--network-task-pkl", type=str, required=True)
    p.add_argument("--out-file", type=str, required=True)
    args = p.parse_args(argv)

    with open(args.network_task_pkl, "rb") as f:
        task_records, weights = pickle.load(f)
    tasks = [SearchTask.from_record(r) for r in task_records]

    n = 0
    with open(args.out_file, "w") as out:
        for task in tasks:
            fname = os.path.join(
                common.MEASURE_RECORD_FOLDER,
                common.clean_name((task.workload_key,
                                   task.target.split()[0])) + ".json",
            )
            if not os.path.exists(fname):
                print(f"missing: {fname}")
                continue
            with open(fname) as f:
                for line in f:
                    if line.strip() and not line.startswith("#"):
                        out.write(line)
                        n += 1
    print(f"wrote {n} records -> {args.out_file}")
    return n


if __name__ == "__main__":
    main()
