"""Build a performance dataset from measure-record logs (counterpart of
``scripts/make_dataset.py``).

Parity: reference scripts/make_dataset.py: select record files (random
file sampling, per-file record caps) and run make_dataset_from_log_file
with min_sample_size 48 (:204-206). Featurising is host work (the Python
per-store featuriser); no device is involved.

    python -m vae_extent_search_tpu_torch.cli.make_dataset \\
        result/corpus/resnet_50-B1-llvm.json --out-file dataset.pkl

The hold-out sets and the batch-size-1 preset resolve workload keys
through the network task extraction (``records/networks.py``), which is not
ported yet: ``--hold-out`` and ``--preset`` raise. So does ``--n-threads``
above 1, which belongs to the native featuriser.
"""

from __future__ import annotations

import argparse
import glob
import os
import random

from ..data.dataset import make_dataset_from_log_file


def _not_ported(flag: str, needs: str):
    raise NotImplementedError(f"{flag} needs {needs}, which is not ported "
                              "yet")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("logs", nargs="+", type=str,
                   help="record log files (globs ok)")
    p.add_argument("--out-file", type=str, default="dataset.pkl")
    p.add_argument("--min-sample-size", type=int, default=48)
    p.add_argument("--n-threads", type=int, default=1,
                   help="native featurizer threads (not ported: must be 1)")
    p.add_argument("--n-task", type=int, default=None,
                   help="cap the number of record files used")
    p.add_argument("--target", type=str, default="llvm",
                   help="target for hold-out/preset task resolution")
    p.add_argument("--hold-out", type=str, default=None,
                   choices=["resnet-50", "all_five"],
                   help="exclude these networks' tasks (not ported yet)")
    p.add_argument("--preset", type=str, default=None,
                   choices=["batch-size-1"],
                   help="keep only files in the preset grid (not ported yet)")
    p.add_argument("--sample-in-files", type=int, default=None,
                   help="random-sample this many record files")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-measurement", type=int, default=None,
                   help="cap records used per log file")
    args = p.parse_args(argv)
    if args.preset:
        _not_ported("--preset", "records/networks.py")
    if args.hold_out:
        _not_ported("--hold-out", "records/networks.py")
    if args.n_threads != 1:
        _not_ported("--n-threads > 1", "the native featuriser")

    files = []
    for pat in args.logs:
        if os.path.exists(pat):
            # literal path: record-file names carry glob metacharacters
            # ("('[conv2d_layer,...]','cuda').json": the [..] reads as a
            # character class), so an existing path is never re-globbed
            files.append(pat)
        else:
            files.extend(sorted(glob.glob(pat)))

    if args.sample_in_files:
        random.seed(args.seed)
        files = random.sample(files, min(args.sample_in_files, len(files)))
    if args.n_task:
        files = files[: args.n_task]

    return make_dataset_from_log_file(
        files, args.out_file, args.min_sample_size,
        max_records_per_file=args.n_measurement)


if __name__ == "__main__":
    main()
