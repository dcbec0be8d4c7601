"""The port's committed pool (data/pool_conv2d_4k_extent.npz) is exactly
what the JAX package's extent featuriser makes of the committed record
log result/conv2d_4k_chip/pool_conv2d_4k.json.gz."""

import gzip
import os
import shutil

import numpy as np

from vae_extent_search_tpu.features import extent_features_from_records
from vae_extent_search_tpu.records import load_records
from vae_extent_search_tpu_torch.data.pool import load_pool

LOG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "result", "conv2d_4k_chip", "pool_conv2d_4k.json.gz")


def test_committed_pool_equals_featurized_log(tmp_path):
    plain = tmp_path / "pool.json"
    with gzip.open(LOG, "rb") as src, open(plain, "wb") as dst:
        shutil.copyfileobj(src, dst)
    feats, labels, kept = extent_features_from_records(
        load_records(str(plain)))
    got_f, got_l, got_k = load_pool()
    assert got_f.shape == (773, 17) and got_f.dtype == np.float32
    assert np.array_equal(got_f, feats)
    assert np.array_equal(got_l, labels)
    assert np.array_equal(got_k, np.asarray(kept))
