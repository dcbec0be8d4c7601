"""The committed featurized candidate pool.

``pool_conv2d_4k_extent.npz`` holds the extent features of the record
log ``result/conv2d_4k_chip/pool_conv2d_4k.json.gz`` (4,000 GA-generated
CUDA conv2d schedules): the modal-length bucket of 773 rows x 17
features (float32), their labels -log(mean cost) (float32) and the
indices of the kept records (int64), as ``extent_features_from_records``
produces them. :func:`pool_from_records` featurises any record log the
same way (the CLI's ``--record-file``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

DEFAULT_POOL = Path(__file__).resolve().parent / "pool_conv2d_4k_extent.npz"


def pool_from_records(record_file) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """(features, labels, kept) of a record log (NDJSON, or gzip-compressed
    as ``*.gz``): each error-free record replayed and bound, its extent
    vector, -log(mean cost), the modal-length bucket."""
    from ..features.extent import extent_features_from_records
    from ..records.serde import load_records

    feats, labels, kept = extent_features_from_records(
        load_records(str(record_file)))
    return feats, labels, np.asarray(kept, np.int64)


def load_pool(path=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(features [N, D] float32, labels [N] float32, kept [N] int64)."""
    with np.load(DEFAULT_POOL if path is None else path) as z:
        return (z["features"].astype(np.float32),
                z["labels"].astype(np.float32),
                z["kept"].astype(np.int64))
