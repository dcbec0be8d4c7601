"""The port's per-store featuriser and workload embedding against the JAX
package's Python featuriser (``use_native=False``) on committed record
logs: a CPU target (``result/corpus/resnet_18-B1-llvm.json``) and a CUDA
target (``result/conv2d_4k_chip/pool_conv2d_4k.json.gz``). Both are the
same numpy arithmetic over the same IR, so the features are held equal bit
for bit.
"""

import os

import numpy as np
import pytest

from vae_extent_search_tpu.features import per_store as jps
from vae_extent_search_tpu.models import embedding as jemb
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu_torch.features import per_store as tps
from vae_extent_search_tpu_torch.models import embedding as temb
from vae_extent_search_tpu_torch.records import serde as tserde

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET18 = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")
RESNET50 = os.path.join(ROOT, "result/corpus/resnet_50-B1-llvm.json")
CONV_POOL = os.path.join(ROOT, "result/conv2d_4k_chip/pool_conv2d_4k.json.gz")


def _first_per_task(records, k):
    seen, out = {}, []
    for i, r in enumerate(records):
        key = r.inp.task.workload_key
        seen[key] = seen.get(key, 0) + 1
        if seen[key] <= k:
            out.append(i)
    return out


def _conv_records(loader, n=64):
    import gzip
    import tempfile

    with gzip.open(CONV_POOL, "rt") as f:
        lines = [next(f) for _ in range(n)]
    with tempfile.NamedTemporaryFile("w", suffix=".json") as tmp:
        tmp.writelines(lines)
        tmp.flush()
        return loader(tmp.name)


@pytest.mark.parametrize("log", ["resnet_18", "conv2d_cuda"])
def test_per_store_features_equal(log):
    if log == "resnet_18":
        jr, tr = jserde.load_records(RESNET18), tserde.load_records(RESNET18)
        idx = _first_per_task(tr, 4)
        assert len(idx) == 32
    else:
        jr = _conv_records(jserde.load_records)
        tr = _conv_records(tserde.load_records)
        idx = list(range(64))
        assert tr[0].inp.task.is_gpu
    for i in idx:
        js_ = jr[i].inp.recover_state(infer_bound=True)
        ts_ = tr[i].inp.recover_state(infer_bound=True)
        ref = jps.get_per_store_features_from_state(js_, jr[i].inp.task)
        got = tps.get_per_store_features_from_state(ts_, tr[i].inp.task)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert got.shape[1] == tps.FEATURE_VEC_LEN == 164 and got.shape[0] > 0
        assert np.array_equal(got, ref), i


def test_measure_pairs_and_file_equal():
    jr, tr = jserde.load_records(RESNET18), tserde.load_records(RESNET18)
    idx = _first_per_task(tr, 3)
    ref = jps.get_per_store_features_from_measure_pairs(
        [jr[i].inp for i in idx], [jr[i].res for i in idx], use_native=False)
    got = tps.get_per_store_features_from_measure_pairs(
        [tr[i].inp for i in idx], [tr[i].res for i in idx])
    assert all(np.array_equal(a, b) for a, b in zip(got[0], ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[1].max() == 1.0 and len(got[3]) == 8
    from_file = tps.get_per_store_features_from_file(RESNET18, max_lines=20)
    ref_file = jps.get_per_store_features_from_file(RESNET18, max_lines=20,
                                                    use_native=False)
    assert len(from_file[0]) == 20
    assert all(np.array_equal(a, b)
               for a, b in zip(from_file[0], ref_file[0]))
    assert np.array_equal(from_file[1], ref_file[1])


def test_states_featuriser_equal_and_unlowerable_rows():
    jr, tr = jserde.load_records(RESNET18), tserde.load_records(RESNET18)
    jstates = [jr[i].inp.recover_state(infer_bound=False) for i in range(6)]
    tstates = [tr[i].inp.recover_state(infer_bound=False) for i in range(6)]
    ref = jps.get_per_store_features_from_states(
        jstates, jr[0].inp.task, use_native=False)
    got = tps.get_per_store_features_from_states(tstates + [None],
                                                 tr[0].inp.task)
    assert all(np.array_equal(a, b) for a, b in zip(got[:6], ref))
    # a state that cannot be lowered yields one all-zero row
    assert got[6].shape == (1, 164) and not got[6].any()
    assert not hasattr(tps, "featurize_perstore_states_native")


@pytest.mark.parametrize("length_mode", ["modal", "pad"])
def test_perstore_features_from_records_equal(length_mode):
    jr = _conv_records(jserde.load_records, 48)
    tr = _conv_records(tserde.load_records, 48)
    ref = jps.perstore_features_from_records(jr, length_mode=length_mode,
                                             use_native=False)
    got = tps.perstore_features_from_records(tr, length_mode=length_mode)
    assert got[0].shape == ref[0].shape and got[0].shape[1] % 164 == 0
    assert np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], ref[1]) and list(got[2]) == list(ref[2])
    assert len(got[2]) == (48 if length_mode == "pad" else got[0].shape[0])
    with pytest.raises(ValueError):
        tps.perstore_features_from_records(tr[:4], length_mode="longest")
    empty = tps.perstore_features_from_records([])
    assert empty[0].shape == (0, 0) and empty[2] == []


@pytest.mark.parametrize("log", [RESNET18, RESNET50],
                         ids=["resnet_18", "resnet_50"])
def test_workload_embedding_equal_for_every_workload(log):
    keys = []
    for r in tserde.load_records(log):
        if r.inp.task.workload_key not in keys:
            keys.append(r.inp.task.workload_key)
    assert len(keys) >= 8
    kinds = set()
    for key in keys:
        ref, got = jemb.get_workload_embedding(key), \
            temb.get_workload_embedding(key)
        assert got.dtype == np.float32 and got.shape == (9,)
        assert np.array_equal(got, ref), key
        assert temb.workload_dag_str(key) == jemb.workload_dag_str(key)
        kinds.add(tuple(got))
    # the resnet_50 log holds dense and pooling tasks beside the convs
    assert len(kinds) >= (2 if log == RESNET50 else 1)
    feats = [np.ones((2, 164), np.float32), np.zeros((0, 164), np.float32)]
    ref = jemb.append_workload_embedding(feats, keys[:2])
    got = temb.append_workload_embedding(feats, keys[:2])
    assert got[0].shape == (2, 174) and got[1].shape == (0, 164)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_embed_for_model_follows_the_model():
    key = tserde.load_records(RESNET18)[0].inp.task.workload_key

    class M:
        use_workload_embedding = True
        workload_embed_total_dim = 9

    feats = [np.ones((3, 164), np.float32)]
    assert temb.embed_for_model(M(), feats, key)[0].shape == (3, 173)
    M.use_workload_embedding = False
    assert temb.embed_for_model(M(), feats, key) is feats
    assert not temb.get_workload_embedding("no such workload").any()


def test_search_cli_featurises_per_store(tmp_path):
    """``--features per_store`` of the search command line: the flattened
    per-store rows of a record log, as scripts/vae_extent_search.py makes
    them; a pool npz holds its features already and is refused."""
    import gzip

    from vae_extent_search_tpu_torch.cli.vae_extent_search import _load
    from vae_extent_search_tpu_torch.data.pool import pool_from_records

    log = tmp_path / "pool.json"
    with gzip.open(CONV_POOL, "rt") as f:
        log.write_text("".join(next(f) for _ in range(24)))
    ref = jps.perstore_features_from_records(jserde.load_records(str(log)),
                                             use_native=False)
    got = _load(None, str(log), "per_store")
    assert got[0].shape[1] % 164 == 0 and np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], ref[1]) and list(got[2]) == list(ref[2])
    assert pool_from_records(log, "extent")[0].shape[1] < 164
    with pytest.raises(ValueError, match="record-file"):
        _load(None, None, "per_store")
    with pytest.raises(ValueError):
        pool_from_records(log, "stores")
