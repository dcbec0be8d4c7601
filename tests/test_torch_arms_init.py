"""The diversity and kmeans initial sets and the loop's new modes, port
against the JAX package on the CPU. The first farthest-point pick and
the k-means++ seeds are injected, rebuilt from the JAX key's splits
(Threefry and Philox never draw alike); every index set must be equal.
On the easy corpus of ``tests/test_pipeline.py`` the diversity, kmeans
and vib arms find the optimum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_vae_params, to_jax, to_torch
from vae_extent_search_tpu.search import active_loop as ja
from vae_extent_search_tpu.search import select as js
from vae_extent_search_tpu_torch.search import active_loop as ta
from vae_extent_search_tpu_torch.search import select as ts


def _easy_corpus():
    """The easy synthetic corpus of
    tests/test_pipeline.py::test_encoder_lineage_arms_find_optimum."""
    rng = np.random.default_rng(11)
    n, d = 384, 12
    feats = rng.integers(1, 64, (n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return feats, (np.log1p(feats) @ w).astype(np.float32)


EASY = dict(measure_size=32, max_phases=15, vae_epochs=30, reg_epochs=60,
            latent_dim=16, hidden_dim=64, sampling_seed=2001, device="cpu")


# ---------------------------------------------------------------------------
# the representative initial sets
# ---------------------------------------------------------------------------


def _clusters(n_clusters, per=40, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = 20.0 * rng.standard_normal((n_clusters, d))
    z = np.concatenate([c + rng.standard_normal((per, d)) for c in centers])
    return z[rng.permutation(len(z))].astype(np.float32)


Z_CASES = {
    "clusters": lambda: _clusters(3),
    "random": lambda: np.random.default_rng(1).standard_normal(
        (200, 8)).astype(np.float32),
}


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("case", sorted(Z_CASES))
def test_farthest_point_init_matches_jax(case, k):
    z = Z_CASES[case]()
    n = z.shape[0]
    rem = np.ones(n, bool)
    rem[::7] = False
    ref = np.asarray(js.farthest_point_init(
        jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(rem), k))
    got = ts.farthest_point_init(None, torch.as_tensor(z),
                                 torch.as_tensor(rem), k, first=int(ref[0]))
    assert got.tolist() == ref.tolist()
    assert len(set(got.tolist())) == k and rem[got.numpy()].all()
    # the drawn first pick lies in the remaining set
    g = torch.Generator().manual_seed(0)
    drawn = ts.farthest_point_init(g, torch.as_tensor(z),
                                   torch.as_tensor(rem), k)
    assert rem[drawn.numpy()].all() and len(set(drawn.tolist())) == k


def _jax_kmeanspp_seeds(key, z, k):
    """The seeds jax kmeans_representative_init draws from ``key``."""
    n = z.shape[0]
    k1, kk = jax.random.split(key)
    first = int(jax.random.randint(k1, (), 0, n))
    seeds = [first]
    dist = jnp.sum((z - z[first]) ** 2, -1)
    for _ in range(1, k):
        kk, sub = jax.random.split(kk)
        idx = int(jax.random.categorical(
            sub, jnp.log(jnp.maximum(dist, 1e-12))))
        seeds.append(idx)
        dist = jnp.minimum(dist, jnp.sum((z - z[idx]) ** 2, -1))
    return seeds


@pytest.mark.parametrize("n_clusters,k", [(3, 3), (6, 6), (4, 8)])
def test_kmeans_representative_init_matches_jax(n_clusters, k):
    z = _clusters(n_clusters, seed=n_clusters)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(js.kmeans_representative_init(key, jnp.asarray(z), k))
    seeds = _jax_kmeanspp_seeds(key, jnp.asarray(z), k)
    got = ts.kmeans_representative_init(None, torch.as_tensor(z), k,
                                        seed_idx=seeds)
    assert got.tolist() == ref.tolist()
    assert len(set(got.tolist())) == k
    drawn = ts.kmeans_representative_init(torch.Generator().manual_seed(0),
                                          torch.as_tensor(z), k)
    assert len(set(drawn.tolist())) == k


@pytest.mark.parametrize("init_mode", ["diversity", "kmeans"])
def test_run_active_search_representative_init(init_mode):
    feats, labels = _easy_corpus()
    vae = to_torch(np_vae_params(np.random.default_rng(0), feats.shape[1],
                                 EASY["latent_dim"], EASY["hidden_dim"]))
    res = ta.run_active_search(feats, labels, init_mode=init_mode,
                               pretrained_vae_params=vae, **EASY)
    init = [int(i) for i in res.selected_order[:EASY["measure_size"]]]
    assert len(set(init)) == EASY["measure_size"]
    assert len(set(res.selected_order)) == len(res.selected_order)
    assert res.found, (res.phase, res.train_size)
    # the pick is the init function's on the VAE's mean latents
    X, _ = ta._prepare_pool(feats, labels, "cpu")
    mu, _ = ta.vae_encode(vae, X)
    g = ta.make_generator(EASY["sampling_seed"], ta._INIT_STREAM, "cpu")
    if init_mode == "diversity":
        want = ts.farthest_point_init(
            g, mu.detach(), torch.ones(len(feats), dtype=torch.bool), 32)
    else:
        want = ts.kmeans_representative_init(g, mu.detach(), 32)
    assert init == want.tolist()


def test_vib_arm_finds_optimum_and_refuses_bad_modes():
    feats, labels = _easy_corpus()
    res = ta.run_active_search(feats, labels, encoder_mode="vib", **EASY)
    assert res.found, (res.phase, res.train_size)
    for kw in ({"encoder_mode": "vib", "init_mode": "diversity"},
               {"encoder_mode": "vib", "init_mode": "kmeans"},
               {"encoder_mode": "nope"}, {"init_mode": "nope"}):
        with pytest.raises(ValueError):
            ta.run_active_search(feats, labels, **{**EASY, **kw})


def test_random_init_is_the_jax_draw():
    """init_mode="random" (now explicit) draws the JAX loop's set."""
    feats, labels = _easy_corpus()
    vae = np_vae_params(np.random.default_rng(0), feats.shape[1], 16, 64)
    kw = dict(measure_size=32, max_phases=0, latent_dim=16, hidden_dim=64,
              sampling_seed=2003, init_mode="random")
    rj = ja.run_active_search(feats, labels, pretrained_vae_params=to_jax(vae),
                              **kw)
    rt = ta.run_active_search(feats, labels, device="cpu",
                              pretrained_vae_params=to_torch(vae), **kw)
    assert [int(i) for i in rt.selected_order] == [
        int(i) for i in rj.selected_order]
