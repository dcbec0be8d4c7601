"""The bfloat16 fused head's first encoder layer ahead of the kernel
(``ops/fused_head.py::split_first_layer``): which shapes split, that the
split composition computes the unsplit numbers bit for bit in the plain
version, that the wrapper's chunked first layer computes the plain one on
the CPU, and that the selection phase hands the fused head its float32
pool uncast. The kernel's side is held on the card by
``tests/test_torch_kernels_cuda.py``."""

import math

import pytest
import torch

from vae_extent_search_tpu_torch.ops import fused_head as fh
from vae_extent_search_tpu_torch.search import select as sel

BF16 = torch.bfloat16
# the vae_perstore cell's widths: encoder 820-256-256-256, fc_mu to 64
CELL = [256, 256, 256, 64]


@pytest.mark.parametrize("bf16,d,widths,split", [
    (True, 820, CELL, True),            # the per-store rows
    (True, 257, CELL, True),            # one column wider than the layer
    (True, 256, CELL, False),           # as wide as the layer
    (True, 24, CELL, False),            # the bench shape
    (True, 17, CELL, False),            # the extent rows
    (True, 100, [32, 16], True),        # one encoder layer, then fc_mu
    (True, 820, [64], False),           # fc_mu alone: nothing to split
    (True, 820, [1024, 256, 64], False),  # a first layer wider than d
])
def test_split_rule_by_shape(bf16, d, widths, split):
    assert fh.split_first_layer(bf16, d, widths) is split


@pytest.mark.parametrize("d", [17, 24, 256, 257, 820, 1040])
def test_float32_never_splits(d):
    assert not fh.split_first_layer(False, d, CELL)
    assert not fh.split_first_layer(False, d, [32, 16])


def _dense(g, i, o):
    bw, bb = math.sqrt(3.0 / i), math.sqrt(1.0 / i)
    return {"w": (torch.rand(i, o, generator=g) * 2 - 1) * bw,
            "b": (torch.rand(o, generator=g) * 2 - 1) * bb}


def _model(seed, d, hid, lat, T, n):
    g = torch.Generator().manual_seed(seed)
    enc = [_dense(g, d, hid), _dense(g, hid, hid), _dense(g, hid, hid)]
    fc_mu = _dense(g, hid, lat)
    head = [_dense(g, lat, hid), _dense(g, hid, hid), _dense(g, hid, 1)]
    x = torch.randn(n, d, generator=g)
    bits = torch.randint(0, 2 ** 32, (T, n, hid), dtype=torch.int64,
                         generator=g).to(torch.uint32)
    return enc, fc_mu, head, x, bits


@pytest.mark.parametrize("d", [100, 24])  # splits; does not split
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("words", ["mask_bits", "generator"])
def test_plain_split_composition_is_bit_identical(d, seed, words):
    """The plain first layer rounded to bf16, then the plain head over the
    encoder's other layers, equals the unsplit plain head bit for bit."""
    T = 4
    enc, fc_mu, head, x, bits = _model(seed, d, 32, 16, T, 300)
    xb = x.to(BF16)
    kw = ({"mask_bits": bits} if words == "mask_bits" else {})

    def gen():
        return None if kw else torch.Generator().manual_seed(9)

    whole = fh.fused_head_stats_plain(head, xb, T, 0.1, generator=gen(),
                                      encoder=(enc, fc_mu), **kw)
    h1 = fh.first_layer_plain(enc[0], x, BF16)
    assert h1.dtype == BF16 and h1.shape == (300, 32)
    split = fh.fused_head_stats_plain(head, h1, T, 0.1, generator=gen(),
                                      encoder=(enc[1:], fc_mu), **kw)
    for name, a, b in zip(("cost", "gnorm", "mc_mean", "mc_var"), whole,
                          split):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("d,rows", [(100, 128), (100, 300), (24, 64),
                                    (96, 100)])
def test_chunked_first_layer_computes_the_plain_layer(monkeypatch, d, rows):
    """The wrapper's first layer (chunks of SPLIT_ROWS rows rounded into a
    buffer padded to the GEMM's 16-byte rows, the bias added into bf16,
    then ReLU) on the CPU, where the matmul is plain: the plain layer's
    values, within one rounding of another summation order, over chunks
    that end off the row count."""
    monkeypatch.setattr(fh, "SPLIT_ROWS", rows)
    enc, _, _, x, _ = _model(5, d, 32, 16, 2, 300)
    got = fh._first_layer(x, enc[0], BF16)
    ref = fh.first_layer_plain(enc[0], x, BF16)
    assert got.dtype == BF16 and got.shape == ref.shape
    assert (got.float() >= 0).all()
    ulp = fh._bf16_ulp(ref.float().abs())
    assert ((got.float() - ref.float()).abs() <= ulp).all()
    # a bf16 input takes the same path (its rounding is exact)
    again = fh._first_layer(x.to(BF16), enc[0], BF16)
    assert torch.equal(again, fh._first_layer(x.to(BF16).float(), enc[0],
                                              BF16))


@pytest.mark.parametrize("T", [2, 4])
def test_fused_head_rounds_a_float32_input_to_its_dtype(T):
    """``dtype=`` on the CPU: a float32 x is rounded as the caller's cast
    would, and the outputs equal the call on the cast x bit for bit."""
    enc, fc_mu, head, x, bits = _model(3, 100, 32, 16, T, 200)
    got = fh.fused_head_stats(head, x, 11, T=T, mask_bits=bits,
                              encoder=(enc, fc_mu), dtype=BF16)
    ref = fh.fused_head_stats(head, x.to(BF16), 11, T=T, mask_bits=bits,
                              encoder=(enc, fc_mu))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _phase_inputs(seed, n=400, d=100):
    g = torch.Generator().manual_seed(seed)
    params = {"encoder": [_dense(g, d, 32), _dense(g, 32, 32)],
              "fc_mu": _dense(g, 32, 16), "fc_logvar": _dense(g, 32, 16),
              "cost_predictor": [_dense(g, 16, 32), _dense(g, 32, 32),
                                 _dense(g, 32, 1)]}
    X = torch.randn(n, d, generator=g)
    used = torch.zeros(n, dtype=torch.bool)
    used[torch.randperm(n, generator=g)[:12]] = True
    cfg = sel.SelectionConfig(num_select=16, T_mc=4, uncertainty_topk=8,
                              topk_factor=3, max_centers=64,
                              compute_dtype="bfloat16")
    bits = torch.randint(0, 2 ** 32, (cfg.T_mc, n, 32), dtype=torch.int64,
                         generator=g).to(torch.uint32)
    return params, X, used, cfg, bits


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gated", [False, True])
def test_selection_hands_the_fused_head_its_float32_pool(monkeypatch, seed,
                                                         gated):
    """On the fused bf16 route ``_select_one_device`` makes no cast of the
    whole X: the fused head receives the caller's float32 X itself, with
    the compute dtype beside it, and the phase's picks, masks and scores
    equal those of a phase handed X already cast to bf16 (which the fused
    head then reads as it is)."""
    params, X, used, cfg, bits = _phase_inputs(seed)
    seen = []
    monkeypatch.setattr(fh.fused_head_stats, "tap",
                        lambda x, T, groups: seen.append(x))
    real = sel.fused_head_stats
    dtypes = []

    def spy(*a, **kw):
        dtypes.append(kw.get("dtype"))
        return real(*a, **kw)

    monkeypatch.setattr(sel, "fused_head_stats", spy)

    def phase(x):
        return sel.select_programs(
            params, x, used, ~used, torch.Generator().manual_seed(4), cfg,
            gate_uncertainty_to_remaining=gated, mask_bits=bits)

    got = phase(X)
    assert len(seen) == 1 and seen[0] is X and seen[0].dtype == torch.float32
    assert dtypes == [BF16]
    ref = phase(X.to(BF16))
    assert seen[1].dtype == BF16
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)
    for k in got[3]:
        assert torch.equal(got[3][k], ref[3][k]), k
