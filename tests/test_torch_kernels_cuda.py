"""The CUDA kernels of the PyTorch port (the fused cost head, the GBDT
histograms, and the self-tuning targets matmul and conv2d) against their
plain torch versions, on the card. These tests need an NVIDIA GPU and nvcc; where
there is none they skip. They import neither jax nor the JAX package,
so they also run on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

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


# float32: the same f32 products summed in another order (K <= 1536);
# bfloat16: the plain version multiplies the same bf16-rounded inputs in
# f32, so only the order of the f32 sums differs
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,cfg", [
    ((256, 256, 256), (128, 128, 64)), ((256, 512, 128), (64, 256, 8)),
    ((96, 160, 72), (3, 32, 72)),       # non-square, bk = the whole K
    ((1536, 1536, 1536), (2, 32, 8)), ((64, 24, 48), (64, 24, 48))])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("params,cfg", [
    ((2, 8, 8, 6, 256, 3, 3, 1), (4, 6, 128)),
    ((3, 10, 7, 2, 4, 3, 3, 0), (4, 2, 4)),
    ((1, 56, 56, 256, 256, 3, 3, 1), (2, 128, 64)),
    ((1, 56, 56, 256, 256, 3, 3, 1), (8, 32, 8))])
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


def test_matmul_and_conv2d_refuse_invalid_configs_before_launch(dev):
    a = torch.randn(256, 256, device=dev)
    before = om.matmul.launches
    for cfg in ((100, 128, 64),      # does not divide
                (256, 128, 64),      # more than 256 threads of 8 x 8
                (128, 128, 256)):    # f32 tiles over 227 KB
        with pytest.raises(ValueError, match="invalid matmul config"):
            om.matmul(a, a, *cfg)
    with pytest.raises(ValueError):
        om.matmul(a, a.half(), 128, 128, 64)
    assert om.matmul.launches == before
    x = torch.randn(1, 56, 56, 256, device=dev)
    w = torch.randn(3, 3, 256, 256, device=dev)
    b = torch.randn(256, device=dev)
    before = oc.conv2d.launches
    for cfg in ((8, 128, 128), (1, 256, 256), (3, 32, 8)):
        with pytest.raises(ValueError, match="invalid conv2d config"):
            oc.conv2d(x, w, b, 1, *cfg)
    assert oc.conv2d.launches == before
