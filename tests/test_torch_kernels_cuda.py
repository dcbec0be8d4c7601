"""The CUDA kernels of the PyTorch port (the fused cost head, the GBDT
histograms, the self-tuning targets matmul and conv2d, and the ragged
segment sum with its gradient) against their plain torch versions, on the
card. These tests need an NVIDIA GPU and nvcc; where
there is none they skip. They import neither jax nor the JAX package,
so they also run on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from vae_extent_search_tpu_torch.convert import params_from_numpy
from vae_extent_search_tpu_torch.models import boost, boost_device
from vae_extent_search_tpu_torch.models.predictor import pred_encode
from vae_extent_search_tpu_torch.ops import conv2d as oc
from vae_extent_search_tpu_torch.ops import fused_head as fh
from vae_extent_search_tpu_torch.ops import hist as th
from vae_extent_search_tpu_torch.ops import matmul as om
from vae_extent_search_tpu_torch.ops import segment_sum as tss

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _params(rng, d, hid, lat, hp):
    def dense(i, o):
        bw, bb = np.sqrt(3.0 / i), np.sqrt(1.0 / i)
        return {"w": rng.uniform(-bw, bw, (i, o)), "b": rng.uniform(-bb, bb, o)}
    return {"encoder": [dense(d, hid), dense(hid, hid), dense(hid, hid)],
            "fc_mu": dense(hid, lat),
            "cost_predictor": [dense(lat, hp), dense(hp, hp), dense(hp, 1)]}


def _setup(dev, n, dtype, d=24, hid=256, lat=64, hp=256, T=10, seed=0):
    rng = np.random.default_rng(seed)
    p = params_from_numpy(_params(rng, d, hid, lat, hp), dev, dtype)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                        device=dev).to(dtype)
    bits = torch.as_tensor(
        rng.integers(0, 2 ** 32, (T, n, hp), dtype=np.uint32), device=dev)
    return p, x, bits


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


# f32: same arithmetic up to summation order; bf16: a summation-order
# difference can flip one bf16 rounding of an intermediate (2^-8 relative)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fused_encoder", [True, False])
def test_fused_head_kernel_matches_plain(dev, dtype, tol, fused_encoder):
    n, T = 1000, 10  # not a multiple of the 32-candidate block
    p, x, bits = _setup(dev, n, dtype, T=T)
    head = p["cost_predictor"]
    enc = (p["encoder"], p["fc_mu"])
    if not fused_encoder:  # head only: the input is the latent mu
        with torch.no_grad():
            x = pred_encode({**p, "fc_logvar": p["fc_mu"]}, x)[0].to(dtype)
        enc = None
    before = fh.fused_head_stats.launches
    got = fh.fused_head_stats(head, x.contiguous(), 0, T=T, rate=0.1,
                              mask_bits=bits, encoder=enc)
    torch.cuda.synchronize()
    assert fh.fused_head_stats.launches == before + 1
    ref = fh.fused_head_stats_plain(head, x, T, 0.1, mask_bits=bits,
                                    encoder=enc)
    for name, g, r in zip(("cost", "gnorm", "mc_mean", "mc_var"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= tol, (name, _rel(g, r))


# the gate's shape space and its edges: minimal widths with heavy
# dropout, odd T, rate 0 (every pass equals the cost, variance exactly 0),
# a wide per-store input (D = 5 * 164), widths off every power of two, a
# head wider than one 256-column pass, and T = 1 (variance 0 by definition)
@pytest.mark.parametrize("d,hid,lat,hp,T,rate", [
    (10, 128, 8, 128, 2, 0.5), (10, 256, 64, 256, 7, 0.1),
    (10, 128, 32, 128, 11, 0.0), (820, 256, 64, 256, 10, 0.1),
    (17, 200, 10, 100, 3, 0.2), (17, 64, 16, 300, 4, 0.1),
    (17, 256, 64, 256, 1, 0.1)])
def test_fused_head_kernel_shape_grid(dev, d, hid, lat, hp, T, rate):
    n = 333
    p, x, bits = _setup(dev, n, torch.float32, d, hid, lat, hp, T, seed=3)
    enc = (p["encoder"], p["fc_mu"])
    got = fh.fused_head_stats(p["cost_predictor"], x, 0, T=T, rate=rate,
                              mask_bits=bits, encoder=enc)
    ref = fh.fused_head_stats_plain(p["cost_predictor"], x, T, rate,
                                    mask_bits=bits, encoder=enc)
    for name, g, r in zip(("cost", "gnorm", "mc_mean", "mc_var"), got, ref):
        assert _rel(g, r) <= 1e-4, (name, _rel(g, r))
    if rate == 0.0 or T == 1:
        assert torch.count_nonzero(got[3]) == 0


def test_fused_head_philox_path(dev):
    n, T, seeds = 65_536, 10, 4
    p, x, bits = _setup(dev, n, torch.float32, T=T)
    head, enc = p["cost_predictor"], (p["encoder"], p["fc_mu"])
    inj = fh.fused_head_stats(head, x, 0, T=T, mask_bits=bits, encoder=enc)
    phil = fh.fused_head_stats(head, x, 1234, T=T, encoder=enc)
    again = fh.fused_head_stats(head, x, 1234, T=T, encoder=enc)
    torch.cuda.synchronize()
    # cost and gnorm do not depend on the dropout words
    assert torch.equal(phil[0], inj[0]) and torch.equal(phil[1], inj[1])
    # the same seed gives the same words
    for a, b in zip(phil, again):
        assert torch.equal(a, b)
    k_var, k_off, r_var, r_off = 0.0, 0.0, 0.0, 0.0
    for s in range(seeds):
        k = fh.fused_head_stats(head, x, 100 + s, T=T, encoder=enc)
        gen = torch.Generator(device=dev).manual_seed(200 + s)
        r = fh.fused_head_stats_plain(head, x, T, 0.1, generator=gen,
                                      encoder=enc)
        k_var += float(k[3].mean()) / seeds
        r_var += float(r[3].mean()) / seeds
        k_off += float((k[2] - k[0]).mean()) / seeds
        r_off += float((r[2] - r[0]).mean()) / seeds
    assert abs(k_var - r_var) <= 0.05 * r_var, (k_var, r_var)
    # the mean offset mc_mean - cost carries MC noise of variance
    # var / T per candidate on each side: 4 standard errors
    se = (2 * r_var / T / (n * seeds)) ** 0.5
    assert abs(k_off - r_off) <= 4 * se, (k_off, r_off, se)


# the grid split: the plan's G (None) and forced ones, at the main path's
# N = 773 (24 full tiles and one of 5 candidates, in every group) and at
# N = 2,000 (a last tile of 16); (7, 4), (10, 4) and at N = 773 (7, None)
# give pass groups of unequal length, (10, 1) is the unsplit grid
@pytest.mark.parametrize("n", [773, 2000])
@pytest.mark.parametrize("T,groups", [(10, None), (10, 1), (10, 4), (2, None),
                                      (7, None), (7, 4), (1, None)])
def test_fused_head_grid_split_matches_plain(dev, n, T, groups):
    p, x, bits = _setup(dev, n, torch.float32, d=17, T=T, seed=4)
    head, enc = p["cost_predictor"], (p["encoder"], p["fc_mu"])
    G, bounds = fh.launch_plan(n, T, fh.sm_count(dev))
    if groups is None and T > 1:
        assert G > 1, (G, bounds)
        if T == 10:
            assert -(-n // fh.BM) * G >= 125, (G, bounds)
    before = fh.fused_head_stats.launches
    got = fh.fused_head_stats(head, x, 0, T=T, rate=0.1, mask_bits=bits,
                              encoder=enc, groups=groups)
    again = fh.fused_head_stats(head, x, 0, T=T, rate=0.1, mask_bits=bits,
                                encoder=enc, groups=groups)
    torch.cuda.synchronize()
    assert fh.fused_head_stats.launches == before + 2
    ref = fh.fused_head_stats_plain(head, x, T, 0.1, mask_bits=bits,
                                    encoder=enc)
    for name, g, a, r in zip(("cost", "gnorm", "mc_mean", "mc_var"), got,
                             again, ref):
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), name  # two launches bit-identical
        assert _rel(g, r) <= 1e-4, (name, _rel(g, r))
    if T == 1:
        assert torch.count_nonzero(got[3]) == 0


def test_fused_head_cost_and_gnorm_do_not_depend_on_the_split(dev):
    """Every group computes cost with the same code on the same data, and
    group 0 the gradient: both equal the unsplit grid's bit for bit, in
    both dtypes and on the Philox path."""
    for dtype in (torch.float32, torch.bfloat16):
        p, x, _ = _setup(dev, 773, dtype, d=17, seed=5)
        head, enc = p["cost_predictor"], (p["encoder"], p["fc_mu"])
        one = fh.fused_head_stats(head, x, 9, encoder=enc, groups=1)
        for G in (2, 6, 11):
            split = fh.fused_head_stats(head, x, 9, encoder=enc, groups=G)
            assert torch.equal(split[0], one[0]) and torch.equal(
                split[1], one[1]), (dtype, G)
            # the same Philox words, summed in another grouping
            assert _rel(split[3], one[3]) <= 1e-4, (dtype, G)


def test_fused_head_sets_attributes_once_and_reuses_scratch(dev):
    p, x, bits = _setup(dev, 773, torch.float32, d=17, seed=6)
    head, enc = p["cost_predictor"], (p["encoder"], p["fc_mu"])
    fh.fused_head_stats(head, x, 0, mask_bits=bits, encoder=enc)
    calls = fh.LIB.load().fused_head_attr_calls()
    cached = len(fh._SCRATCH)
    for _ in range(3):
        fh.fused_head_stats(head, x, 0, mask_bits=bits, encoder=enc)
    assert fh.LIB.load().fused_head_attr_calls() == calls
    assert len(fh._SCRATCH) == cached
    # at the bench shape's tile count the plan keeps one group: no scratch
    G, _ = fh.launch_plan(262_144, 10, fh.sm_count(dev))
    assert G == 1


def test_fused_head_rejects_bad_inputs(dev):
    p, x, bits = _setup(dev, 64, torch.float32, T=4)
    head, enc = p["cost_predictor"], (p["encoder"], p["fc_mu"])
    with pytest.raises(ValueError):
        fh.fused_head_stats(head, x, 0, T=4, mask_bits=bits.view(torch.int32),
                            encoder=enc)
    with pytest.raises(ValueError):
        fh.fused_head_stats(head, x.to(torch.float16), 0, T=4, encoder=enc)
    with pytest.raises(ValueError):
        fh.fused_head_stats(head, x.t(), 0, T=4, encoder=enc)


def _hist_inputs(dev, n, d, m, nb, zero_rows=0, g_scale=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, nb, (d, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    node = torch.randint(0, m, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    g = torch.randn(n, generator=gen, device=dev) * g_scale
    h = torch.rand(n, generator=gen, device=dev)
    if zero_rows:
        g[-zero_rows:] = 0.0
        h[-zero_rows:] = 0.0
    return bins, node, g, h


# the kernel sums exactly in fixed point and rounds once to f32; the plain
# version runs in float64: within 1e-5 of max |H| (in practice ~1e-7), and
# two launches are bit-identical
@pytest.mark.parametrize("n,d,m,nb,zero_rows,g_scale", [
    (700, 9, 4, 40, 0, 1.0), (1000, 5, 1, 256, 0, 1.0),
    (20_000, 7, 32, 256, 3000, 1.0), (5000, 3, 16, 100, 0, 1e-30),
    (70_000, 20, 8, 2, 0, 1e6), (1, 1, 1, 1, 0, 1.0),
    (1_000_000, 164, 32, 256, 0, 1.0), (1_000_000, 164, 1, 256, 0, 1.0)])
def test_hist_kernel_matches_plain(dev, n, d, m, nb, zero_rows, g_scale):
    bins, node, g, h = _hist_inputs(dev, n, d, m, nb, zero_rows, g_scale)
    before = th.hist.launches
    got = th.hist(bins, node, g, h, m, nb)
    again = th.hist(bins, node, g, h, m, nb)
    torch.cuda.synchronize()
    assert th.hist.launches == before + 2
    ref = th.hist_plain(bins, node, g.double(), h.double(), m, nb)
    for a, b, r in zip(got, again, ref):
        assert a.shape == (d, m, nb) and a.dtype == torch.float32
        assert torch.equal(a, b)
        err = float((a.double() - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), err


# the kernel's contract: the integers of hist_plain_fixed, summed exactly,
# so the two are equal bit for bit; with one launch covering the rows
# (C = 1) or several blocks' partial sums (C > 1), at the worst contention
# (every row of a feature in 2 bins) and with inert and out-of-range rows
@pytest.mark.parametrize("n,d,m,nb,zero_rows,g_scale,two_bins", [
    (700, 9, 4, 40, 0, 1.0, False), (1003, 5, 1, 256, 0, 1.0, False),
    (20_000, 7, 32, 256, 3000, 1.0, False),
    (5000, 3, 16, 100, 0, 1e-30, False),
    (70_000, 20, 8, 2, 0, 1e6, False), (1, 1, 1, 1, 0, 1.0, False),
    (200_000, 12, 1, 256, 0, 1.0, True), (200_000, 12, 32, 256, 10, 1.0, True),
    (1_000_000, 164, 32, 256, 0, 1.0, False),
    (1_000_000, 164, 1, 256, 0, 1.0, False)])
def test_hist_kernel_equals_plain_fixed(dev, n, d, m, nb, zero_rows, g_scale,
                                        two_bins):
    bins, node, g, h = _hist_inputs(dev, n, d, m, nb, zero_rows, g_scale)
    if two_bins:
        bins = bins % 2
    node[::97] = m          # out of range: adds nothing
    got = th.hist(bins, node, g, h, m, nb)
    torch.cuda.synchronize()
    ref = th.hist_plain_fixed(bins, node, g, h, m, nb)
    for a, r in zip(got, ref):
        assert torch.equal(a, r), float((a - r).abs().max())


# the exact cross-card mode: exponents given, int64 sums out; equal to
# hist_plain_fixed's integers at the same exponents, with one or several row
# ranges, and the row blocks' sums, added and rounded, equal one launch over
# every row bit for bit
@pytest.mark.parametrize("n,d,m,nb,zero_rows,two_bins", [
    (700, 9, 4, 40, 0, False), (1003, 5, 1, 256, 0, False),
    (20_000, 7, 32, 256, 3000, False), (200_000, 12, 32, 256, 10, True),
    (1_000_000, 164, 32, 256, 0, False)])
def test_hist_fixed_mode_equals_plain_fixed_ints(dev, n, d, m, nb, zero_rows,
                                                 two_bins):
    bins, node, g, h = _hist_inputs(dev, n, d, m, nb, zero_rows)
    if two_bins:
        bins = bins % 2
    node[::97] = m
    e = (th.fixed_exponent(g, n) - 1, th.fixed_exponent(h, n) - 2)
    before = th.hist.launches
    got = th.hist(bins, node, g, h, m, nb, exponents=e)
    torch.cuda.synchronize()
    assert th.hist.launches == before + 1
    ref = th.hist_plain_fixed(bins, node, g, h, m, nb, exponents=e)
    for a, r in zip(got, ref):
        assert a.dtype == torch.int64 and torch.equal(a, r)


@pytest.mark.parametrize("parts", [2, 3])
def test_hist_row_blocks_sum_to_one_launch(dev, parts):
    n, d, m, nb = 300_001, 17, 8, 200
    bins, node, g, h = _hist_inputs(dev, n, d, m, nb, seed=parts)
    e = (th.fixed_exponent(g, n), th.fixed_exponent(h, n))
    cut = np.linspace(0, n, parts + 1).astype(int)
    gs = hs = 0
    for a, b in zip(cut[:-1], cut[1:]):
        gi, hi = th.hist(bins[:, a:b].contiguous(), node[a:b].contiguous(),
                         g[a:b].contiguous(), h[a:b].contiguous(), m, nb,
                         exponents=e)
        gs, hs = gs + gi, hs + hi
    one = th.hist(bins, node, g, h, m, nb)
    torch.cuda.synchronize()
    assert torch.equal(th.round_fixed(gs, e[0]), one[0])
    assert torch.equal(th.round_fixed(hs, e[1]), one[1])


def test_hist_sets_attributes_once_and_reuses_scratch(dev):
    bins, node, g, h = _hist_inputs(dev, 50_000, 6, 8, 64)
    th.hist(bins, node, g, h, 8, 64)
    calls = th.LIB.load().hist_attr_calls()
    cached = len(th._SCRATCH)
    for _ in range(3):
        th.hist(bins, node, g, h, 8, 64)
    assert th.LIB.load().hist_attr_calls() == calls
    assert len(th._SCRATCH) == cached


def test_hist_kernel_skips_out_of_range_like_plain(dev):
    """Nodes outside [0, m) and bins >= nb add nothing in the kernel and in
    the plain version alike (within 1e-5 of max |H|)."""
    bins, node, g, h = _hist_inputs(dev, 5000, 7, 8, 64)
    node[::9] = 8
    node[4::13] = -3
    got = th.hist(bins, node, g, h, 8, 40)
    torch.cuda.synchronize()
    ref = th.hist_plain(bins, node, g.double(), h.double(), 8, 40)
    for a, r in zip(got, ref):
        err = float((a.double() - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), err


def test_hist_rejects_bad_inputs(dev):
    bins, node, g, h = _hist_inputs(dev, 100, 3, 4, 16)
    with pytest.raises(ValueError):
        th.hist(bins.int(), node, g, h, 4, 16)
    with pytest.raises(ValueError):
        th.hist(bins, node.long(), g, h, 4, 16)
    with pytest.raises(ValueError):
        th.hist(bins, node, g.double(), h, 4, 16)
    with pytest.raises(ValueError):
        th.hist(bins.t().contiguous().t(), node, g, h, 4, 16)
    with pytest.raises(ValueError):
        th.hist(bins, node, g, h, 64, 256)  # shared memory does not fit


def test_device_engine_on_card():
    """The device engine on the card grows the host engine's trees on
    continuous data, once per level through the kernel, and repeats
    itself bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(7)
    X = rng.standard_normal((3000, 9)).astype(np.float32)
    y = (2 * X[:, 0] + np.sin(X[:, 1]) + 0.1 * rng.standard_normal(3000)
         ).astype(np.float32)
    params = {"max_depth": 5, "eta": 0.3}

    def fit(fn, **kw):
        return fn(params, boost.DMatrix(X, label=y), num_boost_round=10,
                  verbose_eval=0, **kw)

    before = th.hist.launches
    d1 = fit(boost_device.train, device="cuda")
    assert th.hist.launches == before + 10 * 5
    d2 = fit(boost_device.train, device="cuda")
    host = fit(boost.train)
    assert np.array_equal(d1.predict(X), d2.predict(X))
    assert [t.feature for t in d1.trees] == [t.feature for t in d2.trees]
    assert np.abs(d1.predict(X) - host.predict(X)).max() < 1e-4


# float32: the same f32 products summed in another order (K <= 1536; the
# kernel adds each output's k terms in increasing order in one register);
# bfloat16: the plain version multiplies the same bf16-rounded inputs in
# f32, so only the order of the f32 sums differs (the tensor cores add
# exact products in f32)
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,dims,cfg", [
    (F32, (256, 256, 256), (128, 128, 32)), (F32, (256, 512, 128), (64, 128, 8)),
    (F32, (96, 160, 72), (32, 32, 8)),       # non-square
    (F32, (1536, 1536, 1536), (96, 96, 32)), (F32, (64, 24, 48), (64, 32, 16)),
    (F32, (1000, 100, 200), (96, 128, 16)),  # ragged in M, N and K
    # K or N off a multiple of 4: the operands are staged zero-padded
    (F32, (7, 33, 5), (32, 32, 8)), (F32, (64, 64, 21), (64, 64, 16)),
    (BF16, (256, 256, 256), (128, 128, 64)), (BF16, (1536, 1536, 1536),
                                              (128, 192, 64)),
    (BF16, (1536, 1536, 1536), (256, 128, 32)),
    (BF16, (96, 160, 72), (64, 64, 32)),     # ragged in M, N and K
    (BF16, (1000, 24, 40), (64, 32, 64)), (BF16, (64, 24, 48), (64, 16, 16)),
    # K or N off a multiple of 8: the operands are staged zero-padded
    (BF16, (7, 33, 5), (64, 64, 16)), (BF16, (64, 64, 20), (64, 16, 16))])
def test_matmul_kernel_matches_plain(dev, dtype, dims, cfg):
    M, N, K = dims
    assert om.config_is_valid(M, N, K, *cfg, dtype=om.dtype_name(dtype))[0]
    g = torch.Generator(device=dev).manual_seed(sum(dims))
    a = torch.randn(M, K, generator=g, device=dev).to(dtype)
    b = torch.randn(K, N, generator=g, device=dev).to(dtype)
    before = om.matmul.launches
    got = om.matmul(a, b, *cfg)
    again = om.matmul(a, b, *cfg)
    torch.cuda.synchronize()
    assert om.matmul.launches == before + 2
    assert torch.equal(got, again)
    assert _rel(got, om.matmul_plain(a, b)) <= MM_TOL[dtype]


BF16_INSTANCES = [(bm, bn) for bm in om.BF16_BM for bn in om.BF16_BN
                  if om.bf16_accumulators(bm, bn) <= om.ACC_REGS]
F32_INSTANCES = [(bm, bn) for bm in om.F32_BM for bn in om.F32_BN]
CONV_F32_INSTANCES = [(bm, bn) for bm in oc.F32_BM for bn in oc.F32_BN]


@pytest.mark.parametrize("bm,bn", F32_INSTANCES)
def test_every_f32_matmul_instance_matches_plain(dev, bm, bn):
    # a ragged shape (no tile divides it) at each bk, two launches
    # bit-identical; then K and N off a multiple of 4 (staged)
    M, N, K = 2 * bm + 13, 2 * bn + 20, 200
    g = torch.Generator(device=dev).manual_seed(bm * bn)
    a = torch.randn(M, K, generator=g, device=dev)
    b = torch.randn(K, N, generator=g, device=dev)
    want = om.matmul_plain(a, b)
    for bk in om.F32_BK:
        got = om.matmul(a, b, bm, bn, bk)
        assert torch.equal(got, om.matmul(a, b, bm, bn, bk))
        assert _rel(got, want) <= MM_TOL[F32]
    a, b = a[:, :K - 3].contiguous(), b[:K - 3, :N - 1].contiguous()
    assert _rel(om.matmul(a, b, bm, bn, 16), om.matmul_plain(a, b)) <= \
        MM_TOL[F32]


@pytest.mark.parametrize("bm,bn", F32_INSTANCES)
def test_f32_matmul_epilogue_places_every_output(dev, bm, bn):
    # A = identity: C must equal B exactly (each output one exact product
    # plus zeros), so a wrong (row, column) of the thread tile, a missed
    # mask or a stale stage shows up as a mismatch
    M, N = 2 * bm - 8, 3 * bn - 16
    b = torch.randn(M, N, device=dev)
    for bk in om.F32_BK:
        assert torch.equal(om.matmul(torch.eye(M, device=dev), b, bm, bn, bk),
                           b)
    # K and N off a multiple of 4 (staged operands, C cut back)
    a, b = torch.eye(M - 3, device=dev), b[:M - 3, :N - 5].contiguous()
    assert torch.equal(om.matmul(a, b, bm, bn, 8), b)


@pytest.mark.parametrize("bm,bn", BF16_INSTANCES)
def test_every_bf16_matmul_instance_matches_plain(dev, bm, bn):
    # a ragged shape (no tile divides it) at each bk: all three swizzles
    M, N, K = 2 * bm + 40, 2 * bn + 24, 200
    g = torch.Generator(device=dev).manual_seed(bm + bn)
    a = torch.randn(M, K, generator=g, device=dev).bfloat16()
    b = torch.randn(K, N, generator=g, device=dev).bfloat16()
    want = om.matmul_plain(a, b)
    for bk in om.BF16_BK:
        got = om.matmul(a, b, bm, bn, bk)
        assert torch.equal(got, om.matmul(a, b, bm, bn, bk))
        assert _rel(got, want) <= MM_TOL[BF16]


@pytest.mark.parametrize("bm,bn,bk", [(64, 64, 64), (128, 256, 64),
                                      (256, 128, 32), (64, 96, 16)])
def test_bf16_matmul_epilogue_places_every_output(dev, bm, bn, bk):
    # A = identity: C must equal B exactly, so a wrong (row, column) of the
    # wgmma accumulator layout or a missed mask shows up as a mismatch
    M, N = 2 * bm - 8, 3 * bn - 16
    a = torch.eye(M, M, device=dev).bfloat16()
    b = torch.randn(M, N, device=dev).bfloat16()
    assert torch.equal(om.matmul(a, b, bm, bn, bk), b.float())
    # K and N off a multiple of 8 (staged operands, C cut back)
    a, b = a[:M - 3, :M - 3].contiguous(), b[:M - 3, :N - 5].contiguous()
    assert torch.equal(om.matmul(a, b, bm, bn, bk), b.float())


def test_matmul_and_conv2d_refuse_invalid_configs_before_launch(dev):
    a = torch.randn(256, 256, device=dev)
    before = om.matmul.launches
    for cfg in ((100, 128, 64),      # bm off the f32 lattice
                (256, 128, 32),      # bm past the lattice
                (128, 128, 64)):     # bk not in F32_BK
        with pytest.raises(ValueError, match="invalid matmul config"):
            om.matmul(a, a, *cfg)
    ab = a.bfloat16()
    for cfg in ((100, 128, 64),      # bm off the wgmma lattice
                (128, 120, 64),      # no instance of that width
                (128, 128, 128),     # bk wider than a 128-byte swizzle
                (256, 256, 64)):     # accumulators over 128 registers
        with pytest.raises(ValueError, match="invalid matmul config"):
            om.matmul(ab, ab, *cfg)
    with pytest.raises(ValueError):
        om.matmul(a, a.half(), 128, 128, 64)
    assert om.matmul.launches == before
    # K = N = 250 (rows of 500 bytes, off TMA's 16): staged, not refused
    odd = ab[:250, :250].contiguous()
    got = om.matmul(odd, odd, 64, 64, 64)
    assert om.matmul.launches == before + 1 and got.shape == (250, 250)
    assert got.is_contiguous()
    assert _rel(got, om.matmul_plain(odd, odd)) <= MM_TOL[BF16]
    # and in f32 (rows of 1000 bytes, off the 16-byte copies)
    odd = a[:250, :250].contiguous()
    got = om.matmul(odd, odd, 64, 64, 16)
    assert om.matmul.launches == before + 2 and got.shape == (250, 250)
    assert got.is_contiguous()
    assert _rel(got, om.matmul_plain(odd, odd)) <= MM_TOL[F32]
    x = torch.randn(1, 56, 56, 256, device=dev)
    w = torch.randn(3, 3, 256, 256, device=dev)
    b = torch.randn(256, device=dev)
    before = oc.conv2d.launches
    # bci and bco off the f32 lattice, boh past OH (a boh that does not
    # divide OH is masked, not refused)
    for cfg in ((8, 128, 128), (1, 256, 256), (57, 32, 8)):
        with pytest.raises(ValueError, match="invalid conv2d config"):
            oc.conv2d(x, w, b, 1, *cfg)
    for cfg in ((8, 128, 128), (1, 256, 128), (2, 6, 64), (2, 128, 8)):
        with pytest.raises(ValueError, match="invalid conv2d config"):
            oc.conv2d(x.bfloat16(), w.bfloat16(), b, 1, *cfg)
    assert oc.conv2d.launches == before


def test_shared_memory_attribute_is_set_once_per_instance(dev):
    a = torch.randn(256, 256, device=dev).bfloat16()
    x = torch.randn(1, 14, 14, 64, device=dev).bfloat16()
    w = torch.randn(3, 3, 64, 64, device=dev).bfloat16()
    bias = torch.randn(64, device=dev)
    om.matmul(a, a, 128, 128, 64)
    oc.conv2d(x, w, bias, 1, 2, 64, 32)
    mm0 = om.LIB.load().matmul_attr_calls()
    cv0 = oc.LIB.load().conv2d_attr_calls()
    for bk in om.BF16_BK:           # one instance, three configs
        om.matmul(a, a, 128, 128, bk)
    for bci in (16, 32, 64):        # one warp tile, three configs
        oc.conv2d(x, w, bias, 1, 2, 64, bci)
    torch.cuda.synchronize()
    assert om.LIB.load().matmul_attr_calls() == mm0
    assert oc.LIB.load().conv2d_attr_calls() == cv0
    # another instance sets its own, once
    om.matmul(a, a, 64, 32, 64)
    om.matmul(a, a, 64, 32, 32)
    assert om.LIB.load().matmul_attr_calls() <= mm0 + 1


def test_library_instances_are_the_lattice(dev):
    mm = om.library_instances(om.LIB.load().matmul_instances)
    assert {(p, q) for d, p, q in mm if d == "bfloat16"} == set(
        BF16_INSTANCES)
    assert {(p, q) for d, p, q in mm if d == "float32"} == set(
        F32_INSTANCES)
    cv = om.library_instances(oc.LIB.load().conv2d_instances)
    assert {(p, q) for d, p, q in cv if d == "bfloat16"} == {
        (mt, nt) for mt in oc.BF16_MT for nt in oc.BF16_NT}
    assert {(p, q) for d, p, q in cv if d == "float32"} == set(
        CONV_F32_INSTANCES)


def test_card_timer_reads_the_device_and_raises_when_the_host_falls_behind(
        dev):
    from vae_extent_search_tpu_torch.search.kernel_tuner import cuda_seconds

    a = torch.randn(1536, 1536, device=dev).bfloat16()
    t = cuda_seconds(lambda: om.matmul(a, a, 128, 128, 64))
    assert 0 < t.seconds < 1e-3 and t.host_seconds > 0
    calls = []

    def slower_and_slower():
        # from the first timed window on, the host sleeps longer each call
        calls.append(1)
        if len(calls) > 12:
            time.sleep(1e-3 * (len(calls) - 12))
        om.matmul(a, a, 128, 128, 64)

    with pytest.raises(RuntimeError, match="still enqueueing"):
        cuda_seconds(slower_and_slower, target_ms=0.5)


@pytest.mark.parametrize("dtype,params,cfg", [
    (F32, (2, 8, 8, 6, 256, 3, 3, 1), (4, 32, 32)),     # CO off 4: staged
    (F32, (3, 10, 7, 2, 4, 3, 3, 0), (4, 32, 8)),       # CO off 4, N 3
    (F32, (2, 9, 11, 6, 5, 3, 3, 1), (3, 32, 8)),       # CI and CO off 4
    (F32, (1, 56, 56, 256, 256, 3, 3, 1), (2, 128, 32)),
    (F32, (1, 56, 56, 256, 256, 3, 3, 1), (8, 64, 16)),
    (F32, (1, 56, 56, 256, 256, 3, 3, 1), (5, 96, 32)),  # no tile divides
    (F32, (2, 6, 150, 20, 12, 3, 3, 1), (2, 64, 16)),    # OW 150
    (F32, (1, 14, 14, 40, 24, 1, 1, 0), (3, 32, 16)),    # 1 x 1, ragged
    (BF16, (2, 8, 8, 6, 256, 3, 3, 1), (4, 16, 128)),   # CO < bco
    (BF16, (3, 10, 7, 2, 4, 3, 3, 0), (3, 16, 16)),     # CI < 16: element loads
    (BF16, (1, 56, 56, 256, 256, 3, 3, 1), (2, 128, 64)),
    (BF16, (1, 56, 56, 256, 256, 3, 3, 1), (3, 32, 16)),  # ragged OH
    (BF16, (1, 14, 14, 40, 24, 1, 1, 0), (3, 48, 16))])   # ragged CO, CI
def test_conv2d_kernel_matches_plain(dev, dtype, params, cfg):
    N, H, W, CO, CI, KH, KW, pad = params
    ok, why = oc.conv_config_is_valid(N, H, W, CO, CI, KH, KW, 1, pad, *cfg,
                                      dtype=om.dtype_name(dtype))
    assert ok, why
    g = torch.Generator(device=dev).manual_seed(CO + CI)
    x = torch.randn(N, H, W, CI, generator=g, device=dev).to(dtype)
    w = torch.randn(KH, KW, CI, CO, generator=g, device=dev).to(dtype)
    bias = torch.randn(CO, generator=g, device=dev)
    before = oc.conv2d.launches
    got = oc.conv2d(x, w, bias, pad, *cfg)
    again = oc.conv2d(x, w, bias, pad, *cfg)
    torch.cuda.synchronize()
    assert oc.conv2d.launches == before + 2
    assert torch.equal(got, again)
    assert _rel(got, oc.conv2d_plain(x, w, bias, pad)) <= 1e-5


@pytest.mark.parametrize("bm,bn", CONV_F32_INSTANCES)
@pytest.mark.parametrize("K", [3, 5])
def test_f32_conv2d_shifted_delta_is_exact(dev, bm, bn, K):
    # w = identity at tap (kh, kw) = (0, 0), zero elsewhere, bias 0, pad
    # K // 2, CI = CO: out[n, oh, ow] == relu(x[n, oh - pad, ow - pad])
    # exactly, zeros on the first pad rows and columns, so a wrong shift,
    # window entry, zero fill or output place shows up as a mismatch, in
    # both kernels of the instance (KW 3, any KW). At OW = 14 (OWq 16) boh
    # 2, 4, 6, 8 give BM 32, 64, 96, 128; C = 36 is ragged for every BN and
    # bci
    N, H, W, C, pad = 2, 14, 14, 36, K // 2
    boh = {32: 2, 64: 4, 96: 6, 128: 8}[bm]
    assert oc.f32_bm(boh * oc.f32_row_width(W)) == bm
    x = torch.randn(N, H, W, C, device=dev)
    w = torch.zeros(K, K, C, C, device=dev)
    w[0, 0] = torch.eye(C, device=dev)
    want = torch.zeros_like(x)
    want[:, pad:, pad:] = torch.relu(x[:, :-pad, :-pad])
    for bci in oc.F32_BCI:
        got = oc.conv2d(x, w, torch.zeros(C, device=dev), pad, boh, bn, bci)
        assert torch.equal(got, want)


@pytest.mark.parametrize("bm,bn", CONV_F32_INSTANCES)
@pytest.mark.parametrize("K", [3, 5])
def test_every_f32_conv2d_instance_matches_plain(dev, bm, bn, K):
    # both kernels of the instance (KW 3, and any other KW), rows narrower
    # than a tile (OW 3: a tile spans rows), ragged CO, each bci, two
    # launches bit-identical
    N, H, CO, CI, pad = 2, 40, 2 * bn + 20, 24, K // 2
    boh = next(b for b in range(1, H + 1) if oc.f32_bm(4 * b) == bm)
    g = torch.Generator(device=dev).manual_seed(bm + bn + K)
    x = torch.randn(N, H, 3, CI, generator=g, device=dev)
    w = torch.randn(K, K, CI, CO, generator=g, device=dev)
    bias = torch.randn(CO, generator=g, device=dev)
    want = oc.conv2d_plain(x, w, bias, pad)
    for bci in oc.F32_BCI:
        got = oc.conv2d(x, w, bias, pad, boh, bn, bci)
        assert torch.equal(got, oc.conv2d(x, w, bias, pad, boh, bn, bci))
        assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the ragged segment sum, forward and backward
# ---------------------------------------------------------------------------


def _segments(rng, counts, H, pad_rows, dev, dtype=torch.float32):
    counts = np.asarray(counts)
    n_seg = len(counts)
    ids = np.concatenate([np.repeat(np.arange(n_seg), counts),
                          np.full(pad_rows, n_seg)]).astype(np.int32)
    feats = rng.standard_normal((len(ids), H)).astype(np.float32)
    offs = tss.segment_ids_to_offsets(ids, n_seg)
    return (torch.as_tensor(feats, device=dev).to(dtype),
            torch.as_tensor(ids, device=dev), torch.as_tensor(offs, device=dev),
            n_seg)


SEG_CASES = {
    # the JAX docstring's shape: [32768, 256], spans 1-32
    "docstring_32k_x_256": lambda r: (r.integers(1, 33, 2048), 256, 0),
    "h164_odd_rows": lambda r: (r.integers(1, 24, 513), 164, 7),
    "h174_padding": lambda r: (r.integers(4, 24, 512), 174, 301),
    "empty_start_middle_end": lambda r: ([0, 0, 3, 0, 0, 9, 1, 0], 40, 5),
    "one_long_segment": lambda r: ([5000], 256, 0),
    "h1": lambda r: (r.integers(0, 5, 100), 1, 2),
}


# f32 sums of a segment's rows in another order than index_add_: a few
# 1e-7 of max |out| per 32 rows, ~1e-6 for the 5,000-row segment
@pytest.mark.parametrize("case", SEG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernels_match_plain(dev, case, dtype):
    rng = np.random.default_rng(5)
    counts, H, pad = SEG_CASES[case](rng)
    x, ids, offs, n_seg = _segments(rng, counts, H, pad, dev, dtype)
    x.requires_grad_(True)
    f0, b0 = tss.segment_sum.launches, tss.segment_sum.backward_launches
    out = tss.segment_sum(x, offs)
    again = tss.segment_sum(x.detach(), offs)
    w = torch.randn(n_seg, H, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert tss.segment_sum.launches == f0 + 2
    assert tss.segment_sum.backward_launches == b0 + 1
    assert out.shape == (n_seg, H) and out.dtype == torch.float32
    assert torch.equal(out.detach(), again)     # no atomics: same bits
    ref = tss.segment_sum_plain(x.detach().double(), ids, n_seg)
    tol = 1e-5 if case == "one_long_segment" else 2e-6
    assert _rel(out.detach().double(), ref) < tol
    # the backward is a copy (rounded to bf16 where the input is bf16)
    gref = tss.segment_sum_grad_plain(w, ids, n_seg).to(dtype)
    assert x.grad.dtype == dtype and torch.equal(x.grad, gref)
    if pad:
        assert not x.grad[-pad:].any()


def test_segment_sum_model_step_goes_through_both_kernels(dev):
    """One training step of the per-store MLP on the card equals the same
    step on the CPU (plain versions) within float32 summation order. (The
    rmse loss: under a rank loss the decoder bias has a zero gradient, and
    Adam turns its rounding noise into steps that differ by device.)"""
    from vae_extent_search_tpu_torch.models import segment as ts

    rng = np.random.default_rng(6)
    feats = [rng.random((int(rng.integers(1, 9)), 20)).astype(np.float32)
             for _ in range(100)]
    y = rng.random(100).astype(np.float32)
    preds = {}
    for device in ("cpu", dev):
        m = ts.MLPModelInternal(in_dim=20, hidden_dim=32, batch_size=64,
                                n_epoch=2, loss_type="rmse",
                                device=str(device))
        m.params = ts.init_segment_mlp_params(np.random.default_rng(0), 20,
                                              32, device=device)
        f0, b0 = tss.segment_sum.launches, tss.segment_sum.backward_launches
        m.fit_base(feats, y)
        steps, ev = m.fit_info["steps"], m.fit_info["epochs"]
        if device != "cpu":
            assert tss.segment_sum.backward_launches - b0 == steps == 4
            assert tss.segment_sum.launches - f0 == steps + ev
        else:
            assert tss.segment_sum.launches == f0
        preds[str(device)] = m.predict_on_features(feats)
    assert np.allclose(preds["cpu"], preds[str(dev)], rtol=1e-3, atol=1e-4)


def test_segment_sum_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros(6, 4, device=dev)
    offs = torch.tensor([0, 3, 6], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tss.segment_sum(x.double(), offs)
    with pytest.raises(ValueError):
        tss.segment_sum(x, offs.cpu())
    with pytest.raises(ValueError):
        tss.segment_sum(x, offs.long())
    # a strided view is made contiguous by the wrapper, not refused
    wide = torch.randn(6, 8, device=dev)
    got = tss.segment_sum(wide[:, ::2], offs)
    assert torch.allclose(got, tss.segment_sum(wide[:, ::2].contiguous(), offs))
    assert tss.segment_sum(x, offs[:1]).shape == (0, 4)


def test_network_evaluation_through_the_kernel_equals_plain(dev, tmp_path,
                                                           monkeypatch):
    """eval_model_on_dataset --networks resnet_50 with one MLP pickle: on
    the card every segment sum launches the forward kernel; on the CPU
    (the plain version) the same pickle gives the same network scores,
    the same top-5 picks per task, and predictions within 1e-4 of
    max(1, max |score|) (float32 sums in another order). The 26 per-task
    files hold the first 48 records of the committed resnet-50 corpus."""
    import json
    import os

    from vae_extent_search_tpu_torch.cli import (
        common,
        dump_network_info,
        eval_model_on_dataset,
    )
    from vae_extent_search_tpu_torch.models import load_model_pickle
    from vae_extent_search_tpu_torch.models import segment as ts
    from vae_extent_search_tpu_torch.models.embedding import embed_for_model

    target = "llvm -mcpu=skylake-avx512"
    corpus = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "result/corpus/resnet_50-B1-llvm.json")
    monkeypatch.chdir(tmp_path)
    for name in ("DATASET_ROOT", "NETWORK_INFO_FOLDER",
                 "MEASURE_RECORD_FOLDER"):
        monkeypatch.setattr(common, name, getattr(common, name))
    common.set_dataset_root(str(tmp_path / "ds"))
    dump_network_info.main(["--target", target, "--networks", "resnet_50"])
    groups = {}
    with open(corpus) as f:
        for line in f:
            groups.setdefault(json.loads(line)["i"][0][0], []).append(line)
    os.makedirs(common.MEASURE_RECORD_FOLDER)
    for key, lines in groups.items():
        with open(os.path.join(common.MEASURE_RECORD_FOLDER,
                               common.clean_name((key, "llvm")) + ".json"),
                  "w") as f:
            f.writelines(lines[:48])
    model = ts.MLPModelInternal(in_dim=174, hidden_dim=64, device="cpu")
    model.params = ts.init_segment_mlp_params(np.random.default_rng(3), 174,
                                              64)
    model.fea_norm_vec = np.full(174, 2.0, np.float32)
    model.use_workload_embedding, model.workload_embed_total_dim = True, 10
    model.save("mlp.pkl")

    argv = ["--model", "mlp.pkl", "--networks", "resnet_50", "--target",
            target, "--cache-dir", "cache"]
    f0 = tss.segment_sum.launches
    on_card = eval_model_on_dataset.main(argv)["resnet_50"]
    torch.cuda.synchronize()
    launches = tss.segment_sum.launches - f0
    on_cpu = eval_model_on_dataset.main(argv + ["--device", "cpu"])
    assert tss.segment_sum.launches - f0 == launches >= 26
    assert on_cpu["resnet_50"] == on_card
    assert all(0 < v <= 1 for v in on_card.values())
    tasks, _ = eval_model_on_dataset.network_task_datasets("resnet_50",
                                                           target, "cache")
    assert len(tasks) == 26
    gpu = load_model_pickle("mlp.pkl", device="cuda")
    cpu = load_model_pickle("mlp.pkl", device="cpu")
    for ds, task in tasks:
        feats = embed_for_model(cpu, [np.asarray(x, np.float32)
                                      for x in ds.features[task]],
                                task.workload_key)
        pg, pc = gpu.predict_on_features(feats), cpu.predict_on_features(feats)
        assert np.abs(pg - pc).max() <= 1e-4 * max(1.0, np.abs(pc).max())
        assert list(np.argsort(-pg)[:5]) == list(np.argsort(-pc)[:5])


def _tune_vae_on_card(tmp_path, target):
    """A small cli.tune_vae run on the card on ``target``: every segment sum
    of the loop launches the forward kernel (one per VAE and regression step
    and per model selection) and every optimiser step the backward kernel,
    with no plain version run; the last phase's regression, moved to the CPU
    with the same parameters (plain versions), encodes the candidates within
    1e-4 of max(1, max |mu|) and picks the same top 16 unmeasured ones.
    Returns the run's details."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from vae_extent_search_tpu_torch.cli import tune_vae
    from vae_extent_search_tpu_torch.convert import params_to_numpy
    from vae_extent_search_tpu_torch.models import segment as ts
    from vae_extent_search_tpu_torch.records import make_workload_key
    from vae_extent_search_tpu_torch.records.task import SearchTask
    from vae_extent_search_tpu_torch.search.measure import runner_from_spec

    task = SearchTask(make_workload_key(
        "conv2d_layer", (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1])), target)
    calls = {"sums": 0, "plain": 0, "steps": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    mp = pytest.MonkeyPatch()
    mp.setattr(ts, "segment_sum_rows", counted("sums", ts.segment_sum_rows))
    for name in ("segment_sum_plain", "segment_sum_grad_plain"):
        mp.setattr(tss, name, counted("plain", getattr(tss, name)))
    hook = register_optimizer_step_post_hook(
        lambda *a: calls.__setitem__("steps", calls["steps"] + 1))
    f0, b0 = tss.segment_sum.launches, tss.segment_sum.backward_launches
    details = {}
    runner = (runner_from_spec("analytic_hf", noise=0.2, seed=2023)
              if target.startswith("cuda") else None)
    try:
        best, _ = tune_vae.run_tuning(
            task, n_candidates=96, measure_size=16, n_phases=3,
            vae_epochs=20, reg_epochs=30, select="model", runner=runner,
            log_file=str(tmp_path / "tune.json"), verbose=False,
            device="cuda", details=details)
        torch.cuda.synchronize()
    finally:
        hook.remove()
        mp.undo()
    fwd = tss.segment_sum.launches - f0
    bwd = tss.segment_sum.backward_launches - b0
    assert np.isfinite(best) and calls["plain"] == 0
    assert calls["steps"] == bwd == 20 + 3 * 30
    assert calls["sums"] == fwd == 20 + 3 * 30 + 2
    p = details["pred_params"]
    args = [details[k] for k in ("rows", "seg_ids", "offsets")]
    mu_g, s_g = tune_vae.encode_candidates(p, *args, details["n_seg"])
    mu_c, s_c = tune_vae.encode_candidates(
        params_from_numpy(params_to_numpy(p)), *[a.cpu() for a in args],
        details["n_seg"])
    assert tss.segment_sum.launches - f0 == fwd + 1
    assert np.abs(mu_g - mu_c).max() <= 1e-4 * max(1.0, np.abs(mu_c).max())
    rest = np.flatnonzero(~details["measured"])
    assert list(rest[np.argsort(-s_g[rest])][:16]) == \
        list(rest[np.argsort(-s_c[rest])][:16])
    return details


def test_tune_vae_segment_sums_go_through_the_kernel(dev, tmp_path):
    """_tune_vae_on_card on the CPU target of the JAX script's default."""
    _tune_vae_on_card(tmp_path, "llvm -mcpu=skylake-avx512")


def test_tune_vae_cuda_target_goes_through_the_kernel(dev, tmp_path):
    """_tune_vae_on_card on a cuda task (--target cuda, --runner
    analytic_hf): the GA's GPU-target states, each holding thread binds
    and a shared-memory cache read."""
    details = _tune_vae_on_card(tmp_path, "cuda")
    for st in details["states"]:
        annos = {it.annotation for stg in st.stages for it in stg.iters}
        assert {5, 6} <= annos
        assert any(stg.op.name.endswith(".shared") for stg in st.stages)


def test_few_shot_eval_through_the_kernel_equals_plain(dev, tmp_path,
                                                       monkeypatch):
    """cli.few_shot_eval with an MLP base on two resnet-50 tasks, the four
    modes at K 8: on the card every segment sum launches the forward kernel
    and every optimiser step the backward kernel, with no plain version
    run; on the CPU (the plain versions), from the same initial
    parameters, zero's row within 0.01 and the trained modes' within 0.05
    in each rank metric (float32 sums in another order move near-tied
    predictions); the base keeps its parameters."""
    import json
    import os
    import pickle

    from torch.optim.optimizer import register_optimizer_step_post_hook

    from vae_extent_search_tpu_torch.cli import few_shot_eval
    from vae_extent_search_tpu_torch.convert import tree_leaves
    from vae_extent_search_tpu_torch.data.dataset import (
        make_dataset_from_log_file,
    )
    from vae_extent_search_tpu_torch.models import segment as ts

    corpus = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "result/corpus/resnet_50-B1-llvm.json")
    monkeypatch.chdir(tmp_path)
    keys, lines = [], []
    with open(corpus) as f:
        for line in f:
            key = json.loads(line)["i"][0][0]
            keys += [key] if key not in keys else []
            if keys.index(key) < 2:
                lines.append(line)
    with open("two.json", "w") as f:
        f.writelines(lines)
    make_dataset_from_log_file(["two.json"], "ds.pkl", min_sample_size=30,
                               verbose=0)
    base = ts.MLPModelInternal(in_dim=174, hidden_dim=64, device="cpu")
    base.params = ts.init_segment_mlp_params(np.random.default_rng(3), 174,
                                             64)
    base.fea_norm_vec = np.full(174, 2.0, np.float32)
    base.use_workload_embedding, base.workload_embed_total_dim = True, 10
    base.save("mlp.pkl")

    init = ts.init_segment_mlp_params
    counter = [0]

    def same_init(gen, in_dim, hidden_dim=256, out_dim=1, device=None):
        counter[0] += 1
        return init(np.random.default_rng(100 + counter[0]), in_dim,
                    hidden_dim, out_dim, device=device)

    calls = {"sums": 0, "plain": 0, "steps": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ts, "init_segment_mlp_params", same_init)
    monkeypatch.setattr(ts, "segment_sum_rows",
                        counted("sums", ts.segment_sum_rows))
    for name in ("segment_sum_plain", "segment_sum_grad_plain"):
        monkeypatch.setattr(tss, name, counted("plain", getattr(tss, name)))
    argv = ["--base", "mlp.pkl", "--dataset", "ds.pkl", "--k", "8",
            "--fine-tune-epochs", "6"]
    hook = register_optimizer_step_post_hook(
        lambda *a: calls.__setitem__("steps", calls["steps"] + 1))
    f0, b0 = tss.segment_sum.launches, tss.segment_sum.backward_launches
    try:
        on_card = few_shot_eval.main(argv)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    fwd = tss.segment_sum.launches - f0
    bwd = tss.segment_sum.backward_launches - b0
    assert calls["plain"] == 0 and calls["steps"] > 0
    assert fwd == calls["sums"] > 0 and bwd == calls["steps"]
    counter[0] = 0
    on_cpu = few_shot_eval.main(argv + ["--device", "cpu"])
    assert [r["mode"] for r in on_card] == [r["mode"] for r in on_cpu] == \
        ["zero", "local", "fine_tune", "plus"]
    for a, b in zip(on_card, on_cpu):
        for m in ("pairwise", "peak@1", "peak@5"):
            tol = 0.01 if a["mode"] == "zero" else 0.05
            assert abs(a[m] - b[m]) <= tol, (a, b)
    # fine_tune trains a copy: the base keeps its parameters on the card
    base = ts.MLPModelInternal.load("mlp.pkl", device="cuda")
    before = [t.clone() for t in tree_leaves(base.params)]
    with open("ds.pkl", "rb") as f:
        ds = pickle.load(f)
    task = ds.tasks()[0]
    r = few_shot_eval.adapt_and_eval(
        base, task, [np.asarray(x, np.float32) for x in ds.features[task]],
        np.asarray(ds.throughputs[task]), 8, "fine_tune",
        np.random.default_rng(0), 4)
    assert 0 <= r["pairwise"] <= 1
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(base.params)))


def test_in_search_cost_models_on_the_card_equal_the_cpu(dev, tmp_path):
    """search/cost_model.py on the card: a LearnedCostModel("mlp") refit on
    128 measured states of four matmuls, and a PlusMixCostModel over it
    whose delta fits on the same records, score 64 states within 1e-4 of
    max(1, max |score|) of the same models on the CPU (the plain versions),
    with the same top 16; every segment sum of the fits and the scoring
    launches the forward kernel and every optimiser step the backward
    kernel, with no plain version run."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from vae_extent_search_tpu_torch.models import segment as ts
    from vae_extent_search_tpu_torch.records import (
        SearchTask,
        load_records,
        make_workload_key,
    )
    from vae_extent_search_tpu_torch.search import cost_model as tcm
    from vae_extent_search_tpu_torch.search import measure as tm
    from vae_extent_search_tpu_torch.search.sketch import make_states

    tasks = [SearchTask(make_workload_key("matmul_auto_scheduler_test",
                                          (n, n, n)), "llvm")
             for n in (32, 48, 64, 96)]
    log = str(tmp_path / "measured.json")
    measurer = tm.ProgramMeasurer(tm.EmptyBuilder(),
                                  tm.AnalyticRunner(noise=0.1),
                                  callbacks=[tm.RecordToFile(log)])
    for i, task in enumerate(tasks):
        measurer.measure(task, make_states(task, 32, evo_population=64,
                                           min_population=20, seed=3 + i))
    recs = load_records(log)
    probe = make_states(tasks[2], 64, evo_population=64, min_population=20,
                        seed=5)
    calls = {"sums": 0, "plain": 0, "steps": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    mp = pytest.MonkeyPatch()
    mp.setattr(ts, "segment_sum_rows", counted("sums", ts.segment_sum_rows))
    for name in ("segment_sum_plain", "segment_sum_grad_plain"):
        mp.setattr(tss, name, counted("plain", getattr(tss, name)))
    hook = register_optimizer_step_post_hook(
        lambda *a: calls.__setitem__("steps", calls["steps"] + 1))
    f0, b0 = tss.segment_sum.launches, tss.segment_sum.backward_launches
    try:
        model = tcm.LearnedCostModel(kind="mlp", device="cuda")
        model.update([r.inp for r in recs], [r.res for r in recs])
        mixed = tcm.PlusMixCostModel(model)
        mixed.update([r.inp for r in recs], [r.res for r in recs])
        scores = {"mlp": model.predict(tasks[2], probe),
                  "plus_mix": mixed.predict(tasks[2], probe)}
        torch.cuda.synchronize()
    finally:
        hook.remove()
        mp.undo()
    fwd = tss.segment_sum.launches - f0
    bwd = tss.segment_sum.backward_launches - b0
    assert model._is_fit() and mixed._is_fit() and mixed.device == "cuda"
    assert calls["plain"] == 0 and calls["steps"] == bwd > 0
    assert calls["sums"] == fwd > 0
    model.save(str(tmp_path / "base.pkl"))
    mixed.save(str(tmp_path / "delta.pkl"))
    base_cpu = tcm.LearnedCostModel.load(str(tmp_path / "base.pkl"), "mlp",
                                         device="cpu")
    mixed_cpu = tcm.PlusMixCostModel(base_cpu)
    mixed_cpu.internal = ts.MLPModelInternal.load(str(tmp_path / "delta.pkl"),
                                                  device="cpu")
    want = {"mlp": base_cpu.predict(tasks[2], probe),
            "plus_mix": mixed_cpu.predict(tasks[2], probe)}
    for name, got in scores.items():
        ref = want[name]
        assert np.isfinite(got).all() and got.std() > 0, name
        assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
        assert list(np.argsort(-got, kind="stable")[:16]) == \
            list(np.argsort(-ref, kind="stable")[:16]), name


# ---------------------------------------------------------------------------
# the rest of self-tuning: tuned plans and group counts on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,nb,plans", [
    (120_000, 164, 256, [(1, 1), (2, 3), (8, 29), (40, 2), (0, 7), (82, 0)]),
    (1_000_000, 164, 256, [(4, 2), (16, 0), (0, 3)]),
    (20_000, 9, 40, [(1, 1), (3, 5), (9, 100)])])
def test_hist_is_bit_equal_under_every_plan(dev, n, d, nb, plans):
    """The sums are exact, so every (features, chunks) plan gives the
    launch_plan's histograms bit for bit at every level of a depth-6 tree
    (each plan clamped to be legal there), and each is a launch."""
    for m in (1, 2, 4, 8, 16, 32):
        bins, node, g, h = _hist_inputs(dev, n, d, m, nb)
        want = th.hist(bins, node, g, h, m, nb)
        before = th.hist.launches
        for plan in plans:
            got = th.hist(bins, node, g, h, m, nb, plan=plan)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (m, plan)
        assert th.hist.launches == before + len(plans)


def test_boost_device_trees_equal_under_a_tuned_plan(dev):
    """boost_device.train grows the same trees under any hist plan."""
    rng = np.random.default_rng(6)
    n, d = 60_000, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, :4] = rng.integers(0, 3, (n, 4))
    y = (x[:, 0] + 0.5 * x[:, 5] + 0.1 * rng.standard_normal(n)).astype(
        np.float32)
    dm = boost.DMatrix(x, label=y)
    preds = []
    for plan in ((0, 0), (2, 3), (7, 1)):
        bst = boost_device.train({"max_depth": 6, "eta": 0.3}, dm,
                                 num_boost_round=5, verbose_eval=0,
                                 device=dev, hist_plan=plan)
        preds.append(bst.predict(dm))
    assert all(np.array_equal(preds[0], p) for p in preds[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,T", [(773, 10), (65_536, 10), (300, 7)])
def test_fused_head_within_tol_at_every_legal_G(dev, dtype, n, T):
    """Every G the kernel takes (1 .. min(T + 1, MAX_GROUPS)) gives the
    plain version's statistics within the dtype's tolerance, on the same
    dropout words, and one launch each; snap_fused_groups lands in that
    range for every MC chunk."""
    p, x, bits = _setup(dev, n, dtype, T=T)
    enc = (p["encoder"], p["fc_mu"])
    ref = fh.fused_head_stats_plain(p["cost_predictor"], x, T, 0.1,
                                    mask_bits=bits, encoder=enc)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    Gs = range(1, min(T + 1, fh.MAX_GROUPS) + 1) if n < 10_000 else (
        1, 2, 6, 11)
    for G in Gs:
        before = fh.fused_head_stats.launches
        got = fh.fused_head_stats(p["cost_predictor"], x, 3, T=T,
                                  mask_bits=bits, encoder=enc, groups=G)
        assert fh.fused_head_stats.launches == before + 1
        for a, r in zip(got, ref):
            assert _rel(a, r) <= tol, (G, _rel(a, r))
    assert {fh.snap_fused_groups(n, T, 32, tc) for tc in range(1, T + 1)} \
        <= set(range(1, min(T + 1, fh.MAX_GROUPS) + 1))


def test_kernel_runner_times_one_config_per_family(dev):
    """The composite runner on the card: one schedule per family, each
    timed through its kernel (its launch count grows) with no failure; the
    fused head's and the matmul's held against their plain versions."""
    from vae_extent_search_tpu_torch.records import (
        SearchTask,
        make_workload_key,
    )
    from vae_extent_search_tpu_torch.records.serde import ERROR_NO_ERROR
    from vae_extent_search_tpu_torch.search import kernel_tuner as kt

    r = kt.KernelRunner(dtype="float32", device=dev, repeats=1)
    r.hist.rounds = 2
    cases = [
        ("matmul_auto_scheduler_test", (256, 256, 256), om.matmul),
        ("conv2d_layer", (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1]),
         oc.conv2d),
        ("fused_head_layer", (773, 17, 256, 64, 10), fh.fused_head_stats),
        ("gbdt_hist_layer", (20_000, 12, 4, 2, 2, 2), th.hist)]
    for name, args, kernel in cases:
        task = SearchTask(make_workload_key(name, args), "llvm")
        st = kt.default_config_state(task) or task.compute_dag.init_state
        st = task.compute_dag.infer_bound(st)
        before = kernel.launches
        res = r.run(task, [st])
        assert res[0].error_no == ERROR_NO_ERROR, name
        assert 0 < res[0].costs[0] < 1.0 and kernel.launches > before, name
    assert r.n_timed == 4
    assert r.fusedhead.n_verified == 1 and r.matmul.n_verified == 1
    assert r.fusedhead.verify_rel_err <= 1e-4
    (cfg, launches), = r.fusedhead.launches_per_config.items()
    assert cfg == (5,) and launches >= 3
    (plan, launches), = r.hist.launches_per_config.items()
    assert plan == (0, 0) and launches == 2 * 2 * 6
