"""The port's conv2d module (ops/conv2d.py) on the CPU: its plain version
against the JAX package's Pallas conv2d in interpret mode at the JAX
tests' configurations, and the Hopper lattices of its two kernels (float32
on the CUDA cores; bfloat16 on the tensor cores: each refusal, the warp
tiling, shared memory, ragged edges, the instances the source holds). The
CUDA kernels themselves are held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_extent_search_tpu.ops.conv2d_pallas import (
    make_conv2d,
    xla_conv2d_reference,
)
from vae_extent_search_tpu_torch.ops import conv2d as oc
from vae_extent_search_tpu_torch.ops.build import MAX_SMEM_BYTES

torch.set_num_threads(2)

BENCH = (1, 56, 56, 256, 256, 3, 3, 1, 1)  # N H W CO CI KH KW stride pad
F32 = dict(dtype="float32")


def _inputs(seed, N, H, W, CO, CI, KH, KW):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, H, W, CI)).astype(np.float32),
            rng.standard_normal((KH, KW, CI, CO)).astype(np.float32),
            rng.standard_normal(CO).astype(np.float32))


def rel_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _plain(x, w, b, pad, dtype=torch.float32, cfg=(1, 1, 1)):
    x, w = (torch.as_tensor(t).to(dtype) for t in (x, w))
    return oc.conv2d(x, w, torch.as_tensor(b), pad, *cfg).numpy()


@pytest.mark.parametrize("cfg", [(1, 6, 128), (2, 6, 256), (4, 6, 128),
                                 (8, 6, 256)])
def test_plain_matches_jax_kernel(cfg):
    # CO != CI pins the (N, H, W, CO, CI, ...) argument order
    N, H, W, CO, CI, KH, KW, pad = 2, 8, 8, 6, 256, 3, 3, 1
    x, w, b = _inputs(0, N, H, W, CO, CI, KH, KW)
    want = np.asarray(make_conv2d(N, H, W, CO, CI, KH, KW, 1, pad, *cfg,
                                  dtype_name="float32", interpret=True)(
                                      x, w, b))
    got = _plain(x, w, b, pad, cfg=cfg)
    assert got.shape == want.shape == (N, 8, 8, CO)
    # 2,304 f32 products per output (outputs up to ~80) summed in another
    # order than XLA's: the JAX test's 1e-4, taken relative to the largest
    # output (the absolute difference reaches 1.5e-4)
    assert rel_err(got, want) < 1e-4


def test_plain_valid_padding_and_batch():
    N, H, W, CO, CI, KH, KW, pad = 3, 10, 7, 2, 4, 3, 3, 0
    x, w, b = _inputs(1, N, H, W, CO, CI, KH, KW)
    want = np.asarray(make_conv2d(N, H, W, CO, CI, KH, KW, 1, pad, 4, 2, 4,
                                  dtype_name="float32", interpret=True)(
                                      x, w, b))
    got = _plain(x, w, b, pad)
    assert got.shape == (N, 8, 5, CO)
    assert rel_err(got, want) < 1e-4


def test_plain_bf16_inputs_f32_accum():
    N, H, W, CO, CI, KH, KW, pad = 1, 8, 8, 4, 8, 3, 3, 1
    x, w, b = _inputs(2, N, H, W, CO, CI, KH, KW)
    want = np.asarray(xla_conv2d_reference(N, H, W, CO, CI, KH, KW, 1, pad,
                                           dtype_name="bfloat16")(x, w, b))
    got = _plain(x, w, b, pad, torch.bfloat16)
    # the same bf16-rounded products, summed in f32
    assert rel_err(got, want) < 1e-5


def test_conv_config_validity():
    # the float32 CUDA-core kernel: exact tiling, threads, shared memory
    ok, _ = oc.conv_config_is_valid(*BENCH, 1, 256, 64, **F32)
    assert ok
    ok, why = oc.conv_config_is_valid(*BENCH, 3, 32, 64, **F32)
    assert not ok and "divide" in why
    # the TPU's (7, 128, 128): 7 x 56 x 128 outputs, more than 256 threads
    # of 8 x 8 hold
    ok, why = oc.conv_config_is_valid(*BENCH, 7, 128, 128, **F32)
    assert not ok and "threads" in why
    ok, why = oc.conv_config_is_valid(*BENCH, 8, 128, 128, **F32)
    assert not ok and "threads" in why
    # shared memory: 3 x 256 x 128 f32 weight slices alone are 384 KB
    ok, why = oc.conv_config_is_valid(*BENCH, 1, 256, 128, **F32)
    assert not ok and "shared memory" in why
    assert oc.conv_config_is_valid(*BENCH, 1, 256, 32, **F32)[0]
    ok, why = oc.conv_config_is_valid(1, 56, 56, 256, 256, 3, 3, 2, 1,
                                      1, 32, 64, **F32)
    assert not ok and "stride" in why
    assert (oc.predicted_conv_seconds(*BENCH, 1, 1, 1, **F32)
            > oc.predicted_conv_seconds(*BENCH, 2, 128, 64, **F32) * 5)


@pytest.mark.parametrize("params,cfg,reason", [
    (BENCH, (2, 6, 128), "bco=6 not a multiple of 16"),
    (BENCH, (2, 272, 64), "bco=272 not a multiple of 16 up to 256"),
    (BENCH, (1, 256, 256), "bci=256 not in"),
    (BENCH, (2, 128, 8), "bci=8 not in"),
    (BENCH, (57, 32, 16), "boh=57 out of range"),
    (BENCH, (0, 32, 16), "boh=0 out of range"),
    # the TPU's (7, 128, 128) and (8, 128, 128): 25 and 28 position tiles
    # x 16 channel tiles need more than 8 warps of 4 x 8 mma tiles
    (BENCH, (7, 128, 128), "warps"),
    (BENCH, (8, 128, 128), "warps"),
    # two buffers of 3 x 128 x 264 weights alone are 405 KB
    (BENCH, (1, 256, 128), "shared memory"),
    (BENCH[:7] + (2, 1), (1, 32, 64), "stride 2"),
])
def test_bf16_conv_refusals(params, cfg, reason):
    ok, why = oc.conv_config_is_valid(*params, *cfg)
    assert not ok and why.startswith(reason), why


@pytest.mark.parametrize("params,cfg", [
    (BENCH, (3, 32, 64)),                      # 3 does not divide OH = 56
    (BENCH, (2, 128, 64)), (BENCH, (1, 256, 64)),
    ((2, 8, 8, 6, 256, 3, 3, 1, 1), (4, 16, 128)),   # CO = 6 < bco
    ((3, 10, 7, 2, 4, 3, 3, 1, 0), (3, 16, 16)),     # CI = 4 < bci
    ((1, 14, 14, 40, 24, 1, 1, 1, 0), (3, 48, 16))])  # 40 % 48, 24 % 16
def test_bf16_conv_ragged_edges_are_valid(params, cfg):
    assert oc.conv_config_is_valid(*params, *cfg) == (True, None)


@pytest.mark.parametrize("positions,bco,want", [
    (56, 64, (1, 4, 4, 2)), (112, 128, (2, 8, 4, 2)), (448, 64, (4, 8, 7, 1)),
    (7, 16, (1, 2, 1, 1)), (56, 48, (2, 2, 2, 3)), (448, 128, None)])
def test_warp_tile(positions, bco, want):
    got = oc.warp_tile(positions, bco)
    assert got == want
    if got is not None:
        mt, nt, wr, wc = got
        # the warps cover the tile, within the block's 8 warps
        assert wr * mt * 16 >= positions > (wr - 1) * mt * 16
        assert wc * nt * 8 == bco and wr * wc <= oc.BF16_MAX_WARPS


@pytest.mark.parametrize("cfg,buffers", [
    ((2, 128, 64), 3), ((4, 32, 64), 3), ((1, 256, 64), 2), ((8, 64, 64), 2),
    ((1, 256, 128), 1)])
def test_bf16_ring_depth_is_derived_from_shared_memory(cfg, buffers):
    boh, bco, bci = cfg
    one = oc.bf16_conv_buffer_bytes(boh, bco, bci, 56, 3)
    # a buffer: the window and the weights, rows padded by 16 bytes
    assert one == 2 * (boh * 58 * (bci + 8) + 3 * bci * (bco + 8))
    assert oc.bf16_conv_buffers(boh, bco, bci, 56, 3) == buffers
    assert buffers * one <= MAX_SMEM_BYTES
    assert buffers == 3 or (buffers + 1) * one > MAX_SMEM_BYTES
    assert oc.conv_config_is_valid(*BENCH, *cfg)[0] == (buffers >= 2)


def test_bf16_shared_memory_and_the_source():
    src = (Path(oc.__file__).resolve().parent.parent / "csrc"
           / "conv2d.cu").read_text()
    # the instances the source holds are the warp tiles warp_tile picks from
    assert re.search(r"mts\[3\] = \{1, 2, 4\}, nts\[3\] = \{2, 4, 8\}", src)
    assert oc.BF16_MT == (1, 2, 4) and oc.BF16_NT == (2, 4, 8)
    assert f"constexpr int kPad = {oc.BF16_ROW_PAD};" in src


def test_snap_conv_config_to_hw():
    def snap(*raw, params=BENCH):
        return oc.snap_conv_config_to_hw(*params, *raw, **F32)

    # bco up to a multiple of 32, bci to a multiple of 8
    assert snap(1, 4, 4) == (1, 32, 8)
    assert snap(2, 100, 60) == (2, 128, 64)
    # within the limits: unchanged
    assert snap(4, 64, 32) == (4, 64, 32)
    # too many outputs: boh shrinks (boh x OW = 3136 > bco)
    assert snap(56, 32, 8) == (8, 32, 8)
    # too much shared memory: bci shrinks first
    assert snap(1, 256, 256) == (1, 256, 64)
    # CO below 32: the whole axis
    small = (1, 28, 28, 16, 64, 3, 3, 1, 1)
    assert snap(2, 3, 5, params=small) == (2, 16, 8)
    # stride 2 never fits the stride-1 kernel
    s2 = (1, 56, 56, 64, 64, 3, 3, 2, 1)
    assert not oc.conv_config_is_valid(
        *s2, *oc.snap_conv_config_to_hw(*s2, 1, 32, 8, **F32), **F32)[0]


@pytest.mark.parametrize("raw,want", [
    ((1, 4, 4), (1, 16, 16)), ((4, 64, 32), (4, 64, 32)),
    ((2, 100, 60), (1, 112, 64)),      # 7 x 14 mma tiles: no 8-warp grid
    ((56, 32, 8), (9, 32, 16)),        # boh shrinks until 8 warps cover it
    ((1, 256, 256), (1, 256, 64)),     # bci up to 128, then down for smem
    ((8, 128, 128), (4, 128, 64))])
def test_snap_bf16_conv(raw, want):
    assert oc.snap_conv_config_to_hw(*BENCH, *raw) == want


def test_predicted_conv_seconds_bf16():
    p = oc.predicted_conv_seconds
    bound = 2 * 56 * 56 * 256 * 256 * 9 / oc.PEAK_FLOPS["bfloat16"]
    assert bound < p(*BENCH, 2, 128, 64) < 50 * bound
    # narrow tiles predict slower
    assert p(*BENCH, 1, 16, 16) > 5 * p(*BENCH, 2, 128, 64)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("params", [BENCH, (2, 8, 8, 6, 256, 3, 3, 1, 1),
                                    (3, 10, 7, 2, 4, 3, 3, 1, 0),
                                    (1, 14, 14, 512, 512, 1, 1, 1, 0)])
def test_every_snap_lands_on_the_lattice(params, dtype):
    N, H, W, CO, CI, KH, KW, stride, pad = params
    OH = oc.conv_out_size(H, KH, stride, pad)
    rng = np.random.default_rng(CO + CI)

    def divisor(n):
        return int(rng.choice([d for d in range(1, n + 1) if n % d == 0]))

    for _ in range(200):
        raw = (divisor(OH), divisor(CO), divisor(CI))
        cfg = oc.snap_conv_config_to_hw(*params, *raw, dtype=dtype)
        ok, why = oc.conv_config_is_valid(*params, *cfg, dtype=dtype)
        if dtype == "bfloat16":
            # ragged edges are masked, so every stride-1 snap is valid
            assert ok, (raw, cfg, why)
        else:
            assert ok or cfg[1] == CO or cfg[2] == CI, (raw, cfg, why)
        assert oc.snap_conv_config_to_hw(*params, *cfg, dtype=dtype) == cfg


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    x, w, b = (torch.as_tensor(t) for t in _inputs(3, 1, 6, 6, 4, 8, 3, 3))
    before = oc.conv2d.launches
    # a CPU tensor runs the plain version, whatever the config
    assert torch.equal(oc.conv2d(x, w, b, 1, 6, 4, 8),
                       oc.conv2d_plain(x, w, b, 1))
    assert oc.conv2d.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        oc.conv2d(x.to("meta"), w.to("meta"), b.to("meta"), 1, 6, 4, 8)
