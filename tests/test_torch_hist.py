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


# ---------------------------------------------------------------------------
# the plain fixed-point version: what the kernel computes, bit for bit
# ---------------------------------------------------------------------------

HIST_TOL = 1e-5  # of max |H|, as the card holds the kernel to float64


def _fixed(bins, node, g, h, m, nb):
    return [t.numpy() for t in th.hist_plain_fixed(
        torch.as_tensor(bins), torch.as_tensor(node), torch.as_tensor(g),
        torch.as_tensor(h), m, nb)]


@pytest.mark.parametrize("n,d,m,nb,zero_rows,g_scale", [
    (700, 9, 4, 40, 0, 1.0), (700, 9, 1, 256, 0, 1.0),
    (600, 5, 32, 256, 57, 1.0), (513, 3, 32, 17, 100, 1e-30),
    (4000, 2, 2, 2, 0, 1e6), (1, 1, 1, 1, 0, 1.0)])
def test_fixed_matches_float64_plain(n, d, m, nb, zero_rows, g_scale):
    bins, node, g, h = _inputs(n, d, m, nb, zero_rows)
    g = (g * g_scale).astype(np.float32)
    got = _fixed(bins, node, g, h, m, nb)
    ref = th.hist_plain(torch.as_tensor(bins), torch.as_tensor(node),
                        torch.as_tensor(g).double(),
                        torch.as_tensor(h).double(), m, nb)
    for gt, rf in zip(got, ref):
        rf = rf.numpy()
        assert gt.shape == (d, m, nb) and gt.dtype == np.float32
        assert np.abs(gt - rf).max() <= HIST_TOL * np.abs(rf).max()


@pytest.mark.parametrize("n,d,m,nb,zero_rows", [
    (700, 9, 4, 40, 0), (600, 5, 32, 256, 57), (513, 3, 32, 17, 100),
    (700, 9, 1, 256, 0), (1024, 4, 2, 2, 24), (257, 6, 8, 255, 0)])
def test_fixed_matches_jax_pallas(n, d, m, nb, zero_rows):
    bins, node, g, h = _inputs(n, d, m, nb, zero_rows, seed=4)
    got = _fixed(bins, node, g, h, m, nb)
    ref = _jax("pallas", bins, node, g, h, m, nb)
    for gt, rf in zip(got, ref):
        # the tolerance of test_plain_matches_jax (f32 sums in another
        # order on the JAX side)
        assert np.abs(gt - rf).max() <= 1e-5 * np.abs(rf).max()


def test_fixed_is_invariant_to_row_order():
    bins, node, g, h = _inputs(5000, 6, 8, 64, 300, seed=5)
    perm = np.random.default_rng(6).permutation(5000)
    a = _fixed(bins, node, g, h, 8, 64)
    b = _fixed(bins[:, perm], node[perm], g[perm], h[perm], 8, 64)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_fixed_skips_inert_rows_and_out_of_range_nodes_and_bins():
    """Rows with g = h = 0, rows whose node is outside [0, m) and
    (feature, row) pairs whose bin is >= nb add nothing, bit for bit: the
    result does not change when such rows move to other nodes and bins,
    when out-of-range rows are made inert instead, or when out-of-range
    bins take other out-of-range values (row 0 holds the largest |g| and
    |h|, so the exponents stay the same); and it agrees with a float64
    loop."""
    m, nb = 4, 10
    rng = np.random.default_rng(8)
    bins, node, g, h = _inputs(3000, 5, m, 16, 200, seed=7)  # bins to 15
    g[0], h[0], node[0], bins[:, 0] = 8.0, 8.0, 1, 3
    node[1::7] = m
    node[3::11] = -1
    out = (node < 0) | (node >= m)
    got = _fixed(bins, node, g, h, m, nb)
    inert = np.zeros(3000, bool)
    inert[-200:] = True
    moved_b, moved_n = bins.copy(), node.copy()
    moved_b[:, inert] = rng.integers(0, 16, (5, int(inert.sum())))
    moved_n[inert] = rng.integers(-2, m + 2, int(inert.sum()))
    moved_b[moved_b >= nb] = rng.integers(nb, 256, int((moved_b >= nb).sum()))
    variants = [
        (moved_b, moved_n, g, h),
        (bins, np.where(out, 0, node).astype(np.int32),
         np.where(out, 0, g).astype(np.float32),
         np.where(out, 0, h).astype(np.float32))]
    for args in variants:
        for a, b in zip(got, _fixed(*args, m, nb)):
            assert np.array_equal(a, b)
    ref = [np.zeros((5, m, nb)), np.zeros((5, m, nb))]
    for f in range(5):
        for r in range(3000):
            if 0 <= node[r] < m and bins[f, r] < nb:
                ref[0][f, node[r], bins[f, r]] += g[r]
                ref[1][f, node[r], bins[f, r]] += h[r]
    for a, r in zip(got, ref):
        assert np.abs(a - r).max() <= 1e-6 * np.abs(r).max()


# the plan at the pretraining shape (1M rows x 164 features, 256 bins):
# one block per SM (each takes over 114 KB of shared memory), so the grid
# is a near multiple of 132 blocks; the row ranges grow with m
@pytest.mark.parametrize("m,F,rows,blocks", [
    (1, 55, 22728, 132), (2, 28, 45456, 132), (4, 14, 90912, 132),
    (8, 7, 200000, 120), (16, 3, 142860, 385), (32, 1, 333336, 492)])
def test_launch_plan_at_the_pretraining_shape(m, F, rows, blocks):
    d, n = 164, 1_000_000
    assert th.launch_plan(d, n, m, 256) == (F, rows)
    groups, chunks = -(-d // F), -(-n // rows)
    assert groups * chunks == blocks
    assert F * th.feature_smem_bytes(m, 256) <= th.HIST_SMEM_BYTES
    assert th.feature_smem_bytes(m, 256) == 16 * m * 257  # odd node stride
    assert rows % 4 == 0 and rows >= th.MIN_ROWS
    # the last wave of 132 one-block-per-SM slots is at least FILL full
    assert blocks / (-(-blocks // th.NUM_SMS) * th.NUM_SMS) >= th.FILL


@pytest.mark.parametrize("sms", [114, 132, 144])
@pytest.mark.parametrize("m", [1, 32])
def test_launch_plan_fills_the_cards_own_sms(m, sms):
    """The plan follows the SM count it is given (an H100 PCIe has 114,
    an SXM 132): at the pretraining shape the last wave of one-block-per-SM
    slots is at least FILL full on each."""
    d, n = 164, 1_000_000
    F, rows = th.launch_plan(d, n, m, 256, sms)
    blocks = -(-d // F) * -(-n // rows)
    assert blocks / (-(-blocks // sms) * sms) >= th.FILL
    assert th.launch_plan(d, n, m, 256) == th.launch_plan(d, n, m, 256, 132)


def test_launch_plan_small_inputs_take_one_row_range():
    # the gbdt arm's pool (773 rows) and the cost-model split (5,477 rows)
    for d, n, m in ((17, 773, 32), (164, 773, 1), (164, 5477, 4)):
        F, rows = th.launch_plan(d, n, m, 256)
        assert rows == n


@pytest.mark.parametrize("amax,n,want", [
    (1.0, 1_000_000, 62 - 20 - 1),     # 1.0 < 2^1
    (0.75, 1_000_000, 62 - 20 - 0),    # 0.75 < 2^0
    (3.0e-30, 700, 62 - 10 + 98),      # 3e-30 < 2^-98
    (1.0e6, 1, 62 - 0 - 20),           # 1e6 < 2^20, one row
    (0.0, 5000, 0)])                   # all zero: e = 0
def test_fixed_exponent(amax, n, want):
    """e = 62 - ceil(log2 n) - ex with max |v| < 2^ex (frexp), as the
    kernel's fixed_exponent; the sign of the largest value does not
    matter."""
    v = torch.tensor([0.5 * amax, -amax, 0.25 * amax], dtype=torch.float32)
    assert th.fixed_exponent(v, n) == want
    _, ex = np.frexp(np.float32(amax))
    assert amax == 0 or want == 62 - (n - 1).bit_length() - int(ex)


@pytest.mark.parametrize("d,n,m,nb", [
    (164, 1_000_000, 1, 255), (164, 1_000_000, 32, 255), (17, 50_000, 8, 64),
    (9, 700, 4, 40), (200, 2_000_003, 16, 256), (3, 200_000, 8, 2)])
def test_launch_plan_invariants(d, n, m, nb):
    """Any plan: F fits shared memory, rows are a multiple of 4 (the
    kernel's four rows per thread) unless one range covers all n, every
    range but the last holds at least MIN_ROWS rows, and the ranges cover
    the rows."""
    F, rows = th.launch_plan(d, n, m, nb)
    assert 1 <= F <= d
    assert F * th.feature_smem_bytes(m, nb) <= th.HIST_SMEM_BYTES
    chunks = -(-n // rows)
    assert (chunks - 1) * rows < n <= chunks * rows
    assert rows == n or (rows % 4 == 0 and rows >= th.MIN_ROWS)
