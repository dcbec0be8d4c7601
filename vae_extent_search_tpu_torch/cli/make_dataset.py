"""Build a performance dataset from measure-record logs (counterpart of
``scripts/make_dataset.py``).

Parity: reference scripts/make_dataset.py: select record files
(hold-out sets :24-59, batch-size-1 preset :62-125, random file sampling,
per-file record caps) and run make_dataset_from_log_file with
min_sample_size 48 (:204-206). The hold-out sets and the preset resolve
workload keys through the network tables (``records/networks.py``): the
preset keeps the files whose first workload key is in its grid, the
hold-out drops the held-out tasks' records. Parsing and featurising are
host work (the port's native record parser and per-store featuriser,
``--n-threads`` threads); no device is involved.

    python -m vae_extent_search_tpu_torch.cli.make_dataset \\
        result/corpus/resnet_50-B1-llvm.json --out-file dataset.pkl --n-threads 8
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random

from ..data.dataset import make_dataset_from_log_file
from ..records.networks import build_network_keys, get_network_tasks


def get_hold_out_task(target: str, network=None):
    """Workload keys to hold out of training (reference
    make_dataset.py:24-59): either every resnet-50 batch/size variant, or
    the 'all_five' evaluation networks at their default sizes."""
    grids = []
    if network == "resnet-50":
        for batch_size in [1, 4, 8]:
            for image_size in [224, 240, 256]:
                grids.append(("resnet_50", batch_size, image_size))
    else:
        grids += [("resnet_18", 1, 224), ("resnet_50", 1, 224),
                  ("mobilenet_v2", 1, 224), ("resnext_50", 1, 224),
                  ("bert_tiny", 1, 128), ("bert_base", 1, 128)]
    exists = set()
    for name, b, sz in grids:
        tasks, _ = get_network_tasks(name, b, sz, target=target)
        for t in tasks:
            exists.add(t.workload_key)
    return exists


def preset_batch_size_1(target: str):
    """Workload keys of the batch-size-1 grid (reference
    make_dataset.py:62-125)."""
    keys = set()
    for name, (batch_size, size) in build_network_keys():
        if batch_size != 1:
            continue
        tasks, _ = get_network_tasks(name, batch_size, size, target=target)
        for t in tasks:
            keys.add(t.workload_key)
    return keys


def _first_workload_key(path: str):
    """Peek the first record's workload key without a full parse."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
                return rec["i"][0][0]
            except Exception:
                return None
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("logs", nargs="+", type=str,
                   help="record log files (globs ok)")
    p.add_argument("--out-file", type=str, default="dataset.pkl")
    p.add_argument("--min-sample-size", type=int, default=48)
    p.add_argument("--n-threads", type=int, default=1,
                   help="native featurizer threads (collection boxes)")
    p.add_argument("--n-task", type=int, default=None,
                   help="cap the number of record files used")
    p.add_argument("--target", type=str, default="llvm",
                   help="target for hold-out/preset task resolution")
    p.add_argument("--hold-out", type=str, default=None,
                   choices=["resnet-50", "all_five"],
                   help="exclude these networks' tasks from the dataset")
    p.add_argument("--preset", type=str, default=None,
                   choices=["batch-size-1"],
                   help="keep only files whose tasks are in the preset grid")
    p.add_argument("--sample-in-files", type=int, default=None,
                   help="random-sample this many record files")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-measurement", type=int, default=None,
                   help="cap records used per log file")
    args = p.parse_args(argv)

    files = []
    for pat in args.logs:
        if os.path.exists(pat):
            # literal path: record-file names carry glob metacharacters
            # ("('[conv2d_layer,...]','cuda').json": the [..] reads as a
            # character class), so an existing path is never re-globbed
            files.append(pat)
        else:
            files.extend(sorted(glob.glob(pat)))

    if args.preset == "batch-size-1":
        keep = preset_batch_size_1(args.target)
        files = [f for f in files if _first_workload_key(f) in keep]
        print(f"preset batch-size-1: {len(files)} files")
    if args.sample_in_files:
        random.seed(args.seed)
        files = random.sample(files, min(args.sample_in_files, len(files)))
    if args.n_task:
        files = files[: args.n_task]

    exclude = None
    if args.hold_out:
        exclude = get_hold_out_task(
            args.target, "resnet-50" if args.hold_out == "resnet-50" else None
        )
        print(f"hold-out {args.hold_out}: {len(exclude)} workloads excluded")

    return make_dataset_from_log_file(
        files, args.out_file, args.min_sample_size,
        n_threads=args.n_threads, exclude_workload_keys=exclude,
        max_records_per_file=args.n_measurement)


if __name__ == "__main__":
    main()
