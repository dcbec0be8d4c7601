"""A synthetic TenSet-pretraining-shaped GBDT corpus (the port's copy of
``tools/chip_boost_bench.py::make_corpus``).

The shape mimics the reference pretraining job (xgb_model.py over
make_dataset output): ~20 per-store rows per program, 164 features in
[0, 1), and per-program labels in [0, 1] (normalized-throughput-like)
for the pack-sum objective. Made from a seed, in numpy, so both packages
get the same corpus.
"""

from __future__ import annotations

import numpy as np


def make_corpus(n_rows: int, n_cols: int, seed: int = 0,
                rows_per_program: int = 20):
    """(rows [n_rows, n_cols] float32, pack_ids [n_rows] int64 sorted and
    dense, labels [n_packs] float32). The default is the JAX tool's
    corpus, draw for draw.

    Under the pack-sum objective every row of a program carries the
    program's residual, so one round moves a program's predicted sum by
    about rows_per_program x eta times its residual: the protocol
    converges only while that product stays below 2. At the default 20
    rows and the protocol's eta 0.2 it is 4, and the training rmse grows
    from round to round on either engine."""
    rng = np.random.default_rng(seed)
    rows = rng.random((n_rows, n_cols), dtype=np.float32)
    n_packs = max(1, n_rows // rows_per_program)
    pack_ids = np.sort(rng.integers(0, n_packs, n_rows))
    # keep pack ids dense
    _, pack_ids = np.unique(pack_ids, return_inverse=True)
    n_packs = int(pack_ids.max()) + 1
    w = np.zeros(n_packs, np.float32)
    np.add.at(w, pack_ids, rows[:, 0] - 0.3 * rows[:, 1])
    w += 0.01 * rng.standard_normal(n_packs).astype(np.float32)
    # normalized-throughput-like labels in [0, 1] (dataset.py contract)
    labels = ((w - w.min()) / (w.max() - w.min())).astype(np.float32)
    return rows, pack_ids.astype(np.int64), labels
