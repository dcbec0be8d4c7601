"""The committed featurized candidate pool.

``pool_conv2d_4k_extent.npz`` holds the extent features of the record
log ``result/conv2d_4k_chip/pool_conv2d_4k.json.gz`` (4,000 GA-generated
CUDA conv2d schedules): the modal-length bucket of 773 rows x 17
features (float32), their labels -log(mean cost) (float32) and the
indices of the kept records (int64), as the JAX package's
``extent_features_from_records`` produces them. The port has no record
parser yet, so its search starts from this matrix.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

DEFAULT_POOL = Path(__file__).resolve().parent / "pool_conv2d_4k_extent.npz"


def load_pool(path=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(features [N, D] float32, labels [N] float32, kept [N] int64)."""
    with np.load(DEFAULT_POOL if path is None else path) as z:
        return (z["features"].astype(np.float32),
                z["labels"].astype(np.float32),
                z["kept"].astype(np.int64))
