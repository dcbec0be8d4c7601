"""Data-parallel GBDT training of the port (``boost_device.train(mesh=)``)
and the histogram's exact cross-card mode (``ops/hist.py``).

In 2 and 4 gloo ranks spawned as subprocesses, the trees equal the port's
single-device engine's bit for bit (features, thresholds, leaf values,
children), on a corpus whose packs straddle the ranks' row blocks and
whose rows need padding; on the JAX test's corpus the predictions are
within 1e-4 of the JAX sharded engine's and the first trees split on the
same features (JAX ``tests/test_boost.py::
test_boost_tpu_sharded_matches_single_device``). In process: the
histogram's int64 mode, rounded, equals ``hist_plain_fixed`` bit for bit,
and so do the rounded sums of row blocks at the agreed exponents."""

import numpy as np
import pytest
import torch

from _torch_mh import run_ranks
from vae_extent_search_tpu.models import boost as jboost
from vae_extent_search_tpu_torch.models import boost, boost_device
from vae_extent_search_tpu_torch.ops import hist as th

PARAMS = {"max_depth": 4, "eta": 0.3}
COMMON = dict(num_boost_round=12, obj="pack_sum",
              fevals=[boost.pack_sum_rmse], metric="tr-rmse",
              stopping_rounds=100, verbose_eval=0)


def _trees(bst):
    return [(t.feature, t.threshold, t.value, t.left, t.right)
            for t in bst.trees]


def _straddling_corpus():
    """601 rows in packs of 1-5 rows: blocks of 301/151 rows cut packs."""
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 6, 400)
    pack_ids = np.repeat(np.arange(len(sizes)), sizes)[:601]
    n_packs = int(pack_ids.max()) + 1
    rows = rng.standard_normal((len(pack_ids), 10)).astype(np.float32)
    labels = rng.standard_normal(n_packs).astype(np.float32)
    return rows, labels[pack_ids], pack_ids, [n_packs]


def _jax_test_corpus():
    rng = np.random.default_rng(12)
    rows = rng.standard_normal((600, 10)).astype(np.float32)
    pack_ids = np.repeat(np.arange(200), 3)
    labels = (rows.reshape(200, 3, 10).sum((1, 2)) / 8).astype(np.float32)
    return rows, labels[pack_ids], pack_ids, [200]


def _single(corpus, fixed):
    """The single-device engine on the CPU: through ``hist_plain`` (its
    CPU path), or through ``hist_plain_fixed``, which the kernel equals
    bit for bit (the card's path)."""
    rows, label, pack_ids, groups = corpus
    dm = boost.DMatrix(rows, label=label, pack_ids=pack_ids,
                       group_sizes=groups)
    orig = boost_device.hist
    if fixed:
        boost_device.hist = (lambda *a, plan=None, exponents=None:
                             th.hist_plain_fixed(*a, exponents=exponents))
    try:
        bst = boost_device.train(PARAMS, dm, evals=[(dm, "tr")],
                                 device="cpu", **COMMON)
    finally:
        boost_device.hist = orig
    return bst, dm


def _sharded(corpus, world, tmp_path):
    rows, label, pack_ids, groups = corpus
    return run_ranks("boost", dict(rows=rows, label=label, pack_ids=pack_ids,
                                   groups=groups, params=PARAMS,
                                   common=COMMON), world, str(tmp_path))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_trees_equal_single_device(tmp_path, world):
    corpus = _straddling_corpus()
    ranks = _sharded(corpus, world, tmp_path)
    want_fixed = _trees(_single(corpus, True)[0])
    bst, dm = _single(corpus, False)
    assert len(ranks[0]["trees"]) == COMMON["num_boost_round"]
    for r in ranks:
        assert r["trees"] == want_fixed
        assert r["trees"] == _trees(bst)
        assert np.array_equal(r["pred"], bst.predict(dm))


@pytest.fixture(scope="module")
def jax_corpus_ranks(tmp_path_factory):
    """{ranks: every rank's result on the JAX test's corpus}."""
    d = tmp_path_factory.mktemp("boost_sharded")
    return {w: _sharded(_jax_test_corpus(), w, d) for w in (2, 4)}


@pytest.mark.parametrize("jax_mesh", [False, True],
                         ids=["jax_single", "jax_sharded8"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_trees_match_jax(jax_corpus_ranks, world, jax_mesh):
    """Against the JAX engine on one device and on the JAX test's own
    8-device mesh. (The JAX engine psums float32 histograms, so its trees
    depend on its device count: on 2 devices its third tree splits one
    node differently from its single-device run. The port's sums are
    exact, so its trees do not depend on the rank count.)"""
    import jax
    from jax.sharding import Mesh

    from vae_extent_search_tpu.models import boost_tpu

    corpus = _jax_test_corpus()
    rows, label, pack_ids, groups = corpus
    dj = jboost.DMatrix(rows, label=label, pack_ids=pack_ids,
                        group_sizes=groups)
    common = dict(COMMON, obj=jboost.pack_sum_square_error,
                  fevals=[jboost.pack_sum_rmse])
    mesh = (Mesh(np.asarray(jax.devices()), ("data",)) if jax_mesh
            else None)
    bj = boost_tpu.train(PARAMS, dj, evals=[(dj, "tr")], mesh=mesh,
                         **common)
    ranks = jax_corpus_ranks[world]
    assert ranks[0]["trees"] == ranks[-1]["trees"]
    assert len(ranks[0]["trees"]) == len(bj.trees)
    assert np.abs(ranks[0]["pred"] - bj.predict(dj)).max() < 1e-4
    for (feat, *_), tj in zip(ranks[0]["trees"][:4], bj.trees[:4]):
        assert feat == tj.feature


def _hist_inputs(seed, n=777, d=5, m=4, nb=9):
    rng = np.random.default_rng(seed)
    bins = torch.as_tensor(rng.integers(0, nb, (d, n)), dtype=torch.uint8)
    node = torch.as_tensor(rng.integers(0, m, n), dtype=torch.int32)
    g = torch.as_tensor(rng.standard_normal(n) * 3, dtype=torch.float32)
    h = torch.as_tensor(rng.random(n) + 0.5, dtype=torch.float32)
    return bins, node, g, h, m, nb


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_mode_rounds_to_hist_plain_fixed(seed):
    bins, node, g, h, m, nb = _hist_inputs(seed)
    n = bins.shape[1]
    e = (th.fixed_exponent(g, n), th.fixed_exponent(h, n))
    gi, hi = th.hist_plain_fixed(bins, node, g, h, m, nb, exponents=e)
    assert gi.dtype == hi.dtype == torch.int64
    gf, hf = th.hist_plain_fixed(bins, node, g, h, m, nb)
    assert torch.equal(th.round_fixed(gi, e[0]), gf)
    assert torch.equal(th.round_fixed(hi, e[1]), hf)
    # the wrapper's CPU path in this mode
    gw, hw = th.hist(bins, node, g, h, m, nb, exponents=e)
    assert torch.equal(gw, gi) and torch.equal(hw, hi)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_row_blocks_sum_exactly(parts):
    """The cross-card rule in process: blocks of rows at the exponents of
    the global max |v| and the global n, int64 sums added, rounded as the
    kernel rounds: equal to the whole-row histogram bit for bit."""
    bins, node, g, h, m, nb = _hist_inputs(10 + parts)
    n = bins.shape[1]
    eg = th.exponent_for(max(float(g[i::parts].abs().max())
                             for i in range(parts)), n)
    eh = th.exponent_for(max(float(h[i::parts].abs().max())
                             for i in range(parts)), n)
    assert (eg, eh) == (th.fixed_exponent(g, n), th.fixed_exponent(h, n))
    cut = np.linspace(0, n, parts + 1).astype(int)
    gs = hs = 0
    for a, b in zip(cut[:-1], cut[1:]):
        gi, hi = th.hist_plain_fixed(bins[:, a:b].contiguous(), node[a:b],
                                     g[a:b], h[a:b], m, nb,
                                     exponents=(eg, eh))
        gs, hs = gs + gi, hs + hi
    gf, hf = th.hist_plain_fixed(bins, node, g, h, m, nb)
    assert torch.equal(th.round_fixed(gs, eg), gf)
    assert torch.equal(th.round_fixed(hs, eh), hf)


def test_mesh_needs_the_chunked_path():
    class OneRank:
        shape = {"data": 1, "model": 1}
        device = torch.device("cpu")

        @staticmethod
        def index(axis):
            return 0

    rows, label, pack_ids, groups = _straddling_corpus()
    dm = boost.DMatrix(rows, label=label)
    with pytest.raises(ValueError):
        boost_device.train(PARAMS, dm, num_boost_round=2, mesh=OneRank())
