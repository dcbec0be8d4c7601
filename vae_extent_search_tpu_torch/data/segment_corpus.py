"""A synthetic pretraining-scale per-store corpus for the segment MLP.

The corpus of the JAX package's ``tools/chip_mlp_scale.py``, regenerated
from a seed with numpy: ``n_programs`` programs of 4 to 23 store rows each
(about 13.5 rows per program: ~540,000 rows at the default 40,000
programs), ``dim`` uniform features in [0, 3), and a label that is a fixed
linear map of each program's summed rows, scaled to [0, 1]. A rank loss
orders it within a few epochs. The rmse loss does not fit it at the full
hidden width: the dense rows drive the sigmoid head to ~0 in the first
steps and the fit stalls, in the JAX package as here.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def make_segment_corpus(n_programs: int = 40_000, dim: int = 164,
                        seed: int = 0) -> Tuple[List[np.ndarray], np.ndarray]:
    """(ragged [rows_i, dim] float32 feature arrays, labels [n_programs]
    float32 in [0, 1])."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(4, 24, n_programs)
    feats = [rng.random((int(s), dim), dtype=np.float32) * 3 for s in sizes]
    w = rng.random(dim).astype(np.float32)
    y = np.asarray([float(f.sum(0) @ w) for f in feats], np.float32)
    y = (y - y.min()) / (np.ptp(y) + 1e-8)
    return feats, y
