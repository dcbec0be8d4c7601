"""The GBDT histograms: the port's plain version (ops/hist.py) against the
JAX Pallas kernel run in interpret mode and against the JAX engine's XLA
formulation (boost_tpu._level_histograms), on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch's threads per worker)
from vae_extent_search_tpu.models.boost_tpu import _level_histograms
from vae_extent_search_tpu.ops.hist_pallas import hist_pallas
from vae_extent_search_tpu_torch.ops import hist as th


def _inputs(n, d, m, nb, zero_rows, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, (d, n)).astype(np.uint8)   # [d, n]
    node = rng.integers(0, m, n).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    if zero_rows:  # inert padding rows with arbitrary bins and nodes
        g[-zero_rows:] = 0.0
        h[-zero_rows:] = 0.0
    return bins, node, g, h


def _port(bins, node, g, h, m, nb):
    return [t.numpy() for t in th.hist(
        torch.as_tensor(bins), torch.as_tensor(node), torch.as_tensor(g),
        torch.as_tensor(h), m, nb)]


def _jax(engine, bins, node, g, h, m, nb):
    args = (jnp.asarray(bins.T), jnp.asarray(node), jnp.asarray(g),
            jnp.asarray(h))
    if engine == "pallas":
        out = hist_pallas(*args, m=m, nb=nb, blk=256, fg=4, interpret=True)
    else:
        out = _level_histograms(*args, m, nb)
    return [np.asarray(t) for t in out]


# float32 sums in another order: within 1e-5 of max |H| (the sums here run
# over ~10-1000 values of magnitude ~1, so f32 rounding is ~1e-7 of that)
@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("n,d,m,nb,zero_rows", [
    (700, 9, 4, 40, 0),        # nb < 128: the TPU kernel pads lanes
    (700, 9, 1, 256, 0),       # the root level
    (600, 5, 32, 256, 57),     # depth-6 width with inert zero-g/h rows
    (513, 3, 32, 17, 100),     # m = 32 with few bins
])
def test_plain_matches_jax(engine, n, d, m, nb, zero_rows):
    bins, node, g, h = _inputs(n, d, m, nb, zero_rows)
    got = _port(bins, node, g, h, m, nb)
    ref = _jax(engine, bins, node, g, h, m, nb)
    for gt, rf in zip(got, ref):
        assert gt.shape == (d, m, nb) and gt.dtype == np.float32
        assert np.abs(gt - rf).max() <= 1e-5 * np.abs(rf).max()


def test_inert_rows_add_nothing():
    bins, node, g, h = _inputs(400, 4, 8, 30, 150, seed=1)
    full = _port(bins, node, g, h, 8, 30)
    live = _port(bins[:, :250], node[:250], g[:250], h[:250], 8, 30)
    for a, b in zip(full, live):
        assert np.array_equal(a, b)


def test_wrapper_runs_plain_on_cpu_without_counting():
    bins, node, g, h = _inputs(300, 6, 4, 64, 0, seed=2)
    args = [torch.as_tensor(a) for a in (bins, node, g, h)]
    before = th.hist.launches
    got = th.hist(*args, 4, 64)
    ref = th.hist_plain(*args, 4, 64)
    assert th.hist.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # the plain version keeps its input's dtype (float64 on the card's
    # check); node totals are the bin-axis sums of any feature
    g64 = th.hist_plain(args[0], args[1], args[2].double(), args[3].double(),
                        4, 64)[0]
    assert g64.dtype == torch.float64
    totals = torch.zeros(4, dtype=torch.float64).index_add_(
        0, args[1].long(), args[2].double())
    assert torch.allclose(g64.sum(-1), totals[None, :].expand(6, 4))


def test_out_of_range_nodes_and_bins_add_nothing():
    """Rows with a node outside [0, m) and (feature, row) pairs with a bin
    >= nb add nothing (the kernel skips them too), checked against a
    numpy loop; float64, so the sums agree to 1e-12."""
    m, nb = 4, 10
    bins, node, g, h = _inputs(300, 5, m, 16, 0, seed=3)     # bins up to 15
    node[::7] = m
    node[3::11] = -1
    ref_g = np.zeros((5, m, nb))
    ref_h = np.zeros((5, m, nb))
    for f in range(5):
        for r in range(300):
            if 0 <= node[r] < m and bins[f, r] < nb:
                ref_g[f, node[r], bins[f, r]] += g[r]
                ref_h[f, node[r], bins[f, r]] += h[r]
    got = th.hist_plain(torch.as_tensor(bins), torch.as_tensor(node),
                        torch.as_tensor(g).double(),
                        torch.as_tensor(h).double(), m, nb)
    for a, r in zip(got, (ref_g, ref_h)):
        assert np.abs(a.numpy() - r).max() <= 1e-12


@pytest.mark.parametrize("d,n,m,nb", [(164, 1_000_000, 32, 256),
                                      (164, 1_000_000, 1, 256),
                                      (9, 700, 4, 40), (17, 100, 32, 256)])
def test_launch_plan(d, n, m, nb):
    F, rows = th.launch_plan(d, n, m, nb)
    assert 1 <= F <= d and 1 <= rows <= max(n, 1)
    assert F * 2 * m * nb * 8 <= th.MAX_SMEM_BYTES
    assert rows >= min(n, 4 * m * nb)


def test_launch_plan_rejects_what_does_not_fit():
    with pytest.raises(ValueError):
        th.launch_plan(10, 1000, 64, 256)  # 256 KB for one feature
