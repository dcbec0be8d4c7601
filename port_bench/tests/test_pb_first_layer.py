"""The per-layer metrics of the bf16 fused head's split route
(``port_bench/first_layer.py``) on a synthetic traced window: the first
layer's operations found around each GEMM, the three roofline shares
from their counts, and nothing read from a program that does not split
or has no split counter."""

import pytest

from pb_helpers import REPO  # noqa: F401  (puts the repository on the path)
from port_bench import first_layer, peaks
from port_bench.layers import fused_head_bound_s
from port_bench.trace import Trace
from test_pb_trace import metric
from vae_extent_search_tpu_torch.ops import fused_head as fh

CONFIG = {"compute_dtype": "bfloat16", "T_mc": 10, "input_dim": 820,
          "hidden_dim": 256, "latent_dim": 64, "predictor_hidden": 256,
          "encoder_layers": 3}
N = 262_144
COPY = "elementwise_kernel<bfloat16_copy_kernel_cuda>"
GEMM = "void (anonymous namespace)::mm_bf16<256, 2, 1>(CUtensorMap_st)"
ADD, RELU = "elementwise_kernel<CUDAFunctor_add>", "launch_clamp_scalar"
KERNEL = "void (anonymous namespace)::fused_head_kernel<__nv_bfloat16>"


def phase(t0):
    """One phase from t0 (ms): a weight cast, two chunks of the first
    layer (copy 3, GEMM 2, add 1, ReLU 0.5 each), the fused head's kernel
    (40) and the tail (a copy, as the k-center re-encode's casts)."""
    ops, t = [("cast", t0, t0 + 0.5)], t0 + 0.5
    for _ in range(2):
        for name, ms in ((COPY, 3.0), (GEMM, 2.0), (ADD, 1.0),
                         (RELU, 0.5)):
            ops.append((name, t, t + ms))
            t += ms
    ops += [(KERNEL, t, t + 40.0), (COPY, t + 40.0, t + 41.0)]
    return [(n, a * 1e-3, b * 1e-3) for n, a, b in ops]


def ctx(device=None):
    device = phase(0.0) + phase(100.0) if device is None else device
    return {"trace": Trace(device_ops=device[::-1], host_ops=[],
                           window=(0.0, 0.2)),
            "phases": 2, "config": CONFIG, "N": N}


@pytest.fixture
def splits(monkeypatch):
    monkeypatch.setattr(fh.fused_head_stats, "splits", 3, raising=False)


def test_first_layer_operations_are_found_around_each_gemm(splits):
    # per phase: 2 x (3 + 2 + 1 + 0.5); the weight cast, the kernel and
    # the tail's copy are not the layer's
    assert metric("first_layer_ms").read(ctx()) == pytest.approx(13.0)
    assert first_layer.gemm_ms(ctx()) == pytest.approx(4.0)


def test_shares_come_from_the_split_widths(splits):
    c = ctx()
    layer_s = max(2 * N * 820 * 256 / peaks.FLOPS["bfloat16"],
                  (N * 820 * 4 + (820 * 256 + 256) * 2 + N * 256 * 2)
                  / peaks.HBM_BYTES_PER_S)
    assert metric("first_layer_roofline").read(c) == pytest.approx(
        100 * layer_s / 13e-3)
    gemm_s = max(2 * N * 820 * 256 / peaks.FLOPS["bfloat16"],
                 ((N * 820 + 820 * 256) * 2 + N * 256 * 4)
                 / peaks.HBM_BYTES_PER_S)
    assert metric("first_layer_gemm_roofline").read(c) == pytest.approx(
        100 * gemm_s / 4e-3)
    # the kernel at the widths it is launched with: the cell's count with
    # the first layer's D x H taken out and H-wide rows in
    split = metric("fused_head_split_roofline").read(c)
    whole = metric("fused_head_roofline").read(c)
    assert split == pytest.approx(
        whole * first_layer.kernel_bound_s(c) / fused_head_bound_s(c))
    assert split < whole
    macs = 2 * 256 * 256 + 256 * 64 + (64 * 256 + 256 * 256 + 256) \
        + 10 * (256 * 256 + 256) + (256 * 256 + 256 * 64)
    assert first_layer.kernel_bound_s(c) == pytest.approx(
        2 * N * macs / peaks.FLOPS["bfloat16"])


NAMES = ("first_layer_ms", "first_layer_roofline",
         "first_layer_gemm_roofline", "fused_head_split_roofline")


@pytest.mark.parametrize("name", NAMES)
def test_nothing_read_without_a_split(name, monkeypatch):
    monkeypatch.setattr(fh.fused_head_stats, "splits", 0, raising=False)
    assert metric(name).read(ctx()) is None
    # a program without the counter (the parent of the split route)
    monkeypatch.delattr(fh.fused_head_stats, "splits", raising=False)
    assert metric(name).read(ctx()) is None


@pytest.mark.parametrize("name", NAMES[:3])
def test_nothing_read_from_a_window_without_a_gemm(name, splits):
    device = [op for op in phase(0.0) if op[0] != GEMM]
    assert metric(name).read(ctx(device)) is None
