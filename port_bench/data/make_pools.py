"""Make the frozen pools of the benchmark's configurations from the
committed log of 4,000 CUDA conv2d schedules, on the CPU, with the port's
native featurisers (``records/fast_parser.py``, built by g++ at first use):

- ``pool_extent.npz``: the extent rows of the modal-length bucket
  (773 x 17), ``featurize_extents_native``;
- ``pool_perstore.npz``: the per-store rows of every record (5 stores x
  164), flattened to 4,000 x 820, ``featurize_perstore_native``.

Each file holds ``features`` (float32) and ``kept`` (the records' indices
in the log).

    python3 port_bench/data/make_pools.py --out DIR

writes both files into DIR and says whether each equals the committed one.
"""

import argparse
import collections
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
LOG = ROOT / "result/conv2d_4k_chip/pool_conv2d_4k.json.gz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from vae_extent_search_tpu_torch.records.fast_parser import (
        featurize_extents_native, featurize_perstore_native)

    vecs, _, status = featurize_extents_native(str(LOG))
    ok = [i for i, s in enumerate(status) if s == 0]
    modal = collections.Counter(len(vecs[i]) for i in ok).most_common(1)[0][0]
    kept = np.array([i for i in ok if len(vecs[i]) == modal], np.int64)
    pools = {"pool_extent.npz": (np.stack([vecs[i] for i in kept]), kept)}
    feats, status = featurize_perstore_native(str(LOG))
    kept = np.array([i for i, s in enumerate(status) if s == 0], np.int64)
    pools["pool_perstore.npz"] = (
        np.stack([feats[i].reshape(-1) for i in kept]), kept)

    args.out.mkdir(parents=True, exist_ok=True)
    for name, (features, kept) in pools.items():
        features = features.astype(np.float32)
        np.savez_compressed(args.out / name, features=features, kept=kept)
        with np.load(HERE / name) as z:
            same = (np.array_equal(z["features"], features)
                    and np.array_equal(z["kept"], kept))
        print(f"{name}: {features.shape[0]} x {features.shape[1]}, "
              f"{'equals' if same else 'differs from'} the committed file")
    return 0


if __name__ == "__main__":
    sys.exit(main())
