"""Featurise one record log and pickle its per-store dataset arrays
(counterpart of ``scripts/json_to_task_pkl.py``).

Parity: reference scripts/json_to_task_pkl.py, the minimal demo of
``get_per_store_features_from_file``: the pickle holds (features,
throughputs, task ids, min costs), made by the port's native parser and
featuriser as the JAX script's are by its own. Host work; no device is
involved.

    python -m vae_extent_search_tpu_torch.cli.json_to_task_pkl \\
        result/corpus/resnet_18-B1-llvm.json --out r18.task.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

from ..features.per_store import get_per_store_features_from_file


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log_file")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    feats, throughputs, task_ids, min_costs = (
        get_per_store_features_from_file(args.log_file)
    )
    # default next to the working directory, not next to the (possibly
    # read-only) input log
    out = args.out or os.path.basename(args.log_file) + ".task.pkl"
    with open(out, "wb") as f:
        pickle.dump((feats, throughputs, task_ids, min_costs), f)
    print(f"{len(feats)} records, {len(min_costs)} tasks -> {out}")
    return out


if __name__ == "__main__":
    main()
