"""The port's host layers against the JAX package's: the schedule IR, the
workload registry, record serde, the sketch-GA pool, the extent
featuriser and the block-config quotients. The JAX side is held to its
Python GA (its native GA, where built, is a C++ path the port does not
have), so both packages must make the same pool from the same seed on
the same host."""

import gzip
import os
import shutil

import numpy as np
import pytest

from vae_extent_search_tpu.features import extent as jext
from vae_extent_search_tpu.records import SearchTask as JTask
from vae_extent_search_tpu.records import load_records as jload
from vae_extent_search_tpu.records import make_workload_key
from vae_extent_search_tpu.search import pallas_tuner as jtuner
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu_torch.data.pool import load_pool, pool_from_records
from vae_extent_search_tpu_torch.features import extent as text
from vae_extent_search_tpu_torch.records import SearchTask as TTask
from vae_extent_search_tpu_torch.records import load_records as tload
from vae_extent_search_tpu_torch.records import record_to_json
from vae_extent_search_tpu_torch.search import kernel_tuner as ttuner
from vae_extent_search_tpu_torch.search import sketch as tsketch
from _torch_parity import pin_port_python_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(ROOT, "result", "conv2d_4k_chip", "pool_conv2d_4k.json.gz")

WORKLOADS = {
    "matmul": (("matmul_auto_scheduler_test", (64, 64, 64)),
               "state_to_matmul_config"),
    "conv2d": (("conv2d_layer", (1, 8, 8, 16, 16, 3, 3, [1, 1], [1, 1])),
               "state_to_conv_config"),
}
POOL = 300


@pytest.fixture(scope="module")
def pools():
    """Both packages' make_states(seed=2023) for each workload, the JAX
    package on its Python GA."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsketch.SketchPolicy, "_evolutionary_search_native_recs",
               lambda *a, **k: None)
    pin_port_python_paths(mp)
    try:
        out = {}
        for name, ((func, args), _) in WORKLOADS.items():
            wk = make_workload_key(func, args)
            out[name] = (
                jsketch.make_states(JTask(wk, "llvm"), POOL, seed=2023),
                tsketch.make_states(TTask(wk, "llvm"), POOL, seed=2023))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_same_pool(pools, name):
    js, ts = pools[name]
    assert len(ts) == POOL
    assert [s.to_str() for s in ts] == [s.to_str() for s in js]


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_same_extent_vectors(pools, name, bound):
    js, ts = pools[name]
    if bound:
        js = [s.dag.infer_bound(s) for s in js]
        ts = [s.dag.infer_bound(s) for s in ts]
    for a, b in zip(js, ts):
        va, vb = jext.extent_vector(a), text.extent_vector(b)
        assert va.dtype == vb.dtype == np.float32
        assert np.array_equal(va, vb)
        assert np.array_equal(vb, text.extent_vector_from_text(b.to_str()))


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_same_raw_configs(pools, name, bound):
    js, ts = pools[name]
    fn = WORKLOADS[name][1]
    if bound:
        js = [s.dag.infer_bound(s) for s in js]
        ts = [s.dag.infer_bound(s) for s in ts]
    got = [getattr(ttuner, fn)(s) for s in ts]
    assert got == [getattr(jtuner, fn)(s) for s in js]
    assert [ttuner.state_loops(s) for s in ts] == [
        jtuner.state_loops(s) for s in js]
    if bound:  # a bound state always quotients onto a config
        assert all(cfg is not None for cfg, _ in got)


def _first_lines(n, path):
    with gzip.open(LOG, "rt") as src, open(path, "w") as dst:
        for _, line in zip(range(n), src):
            dst.write(line)


def test_extent_features_from_records_match(tmp_path):
    plain = tmp_path / "head.json"
    _first_lines(300, plain)
    jrecs, trecs = jload(str(plain)), tload(str(plain))
    assert len(trecs) == 300
    jf, jl, jk = jext.extent_features_from_records(jrecs)
    tf, tl, tk = text.extent_features_from_records(trecs)
    assert tf.shape[0] > 0
    assert np.array_equal(tf, jf)
    assert np.array_equal(tl, jl)
    assert tk == jk
    # serde round trip: the port writes each record back byte for byte
    with open(plain) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    assert [record_to_json(r) for r in trecs] == lines


def test_record_file_reproduces_committed_pool(tmp_path):
    feats, labels, kept = pool_from_records(LOG)
    got_f, got_l, got_k = load_pool()
    assert feats.shape == (773, 17)
    assert np.array_equal(feats, got_f)
    assert np.array_equal(labels, got_l)
    assert np.array_equal(kept, got_k)
    # the uncompressed log reads the same
    plain = tmp_path / "pool.json"
    with gzip.open(LOG, "rb") as src, open(plain, "wb") as dst:
        shutil.copyfileobj(src, dst)
    assert len(tload(str(plain))) == len(tload(LOG)) == 4000
