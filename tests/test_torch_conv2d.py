"""The port's conv2d module (ops/conv2d.py) on the CPU: its plain version
against the JAX package's Pallas conv2d in interpret mode at the JAX
tests' configurations, and the kernel's Hopper lattice. The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from vae_extent_search_tpu.ops.conv2d_pallas import (
    make_conv2d,
    xla_conv2d_reference,
)
from vae_extent_search_tpu_torch.ops import conv2d as oc

torch.set_num_threads(2)

BENCH = (1, 56, 56, 256, 256, 3, 3, 1, 1)  # N H W CO CI KH KW stride pad


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
    ok, _ = oc.conv_config_is_valid(*BENCH, 1, 256, 64)
    assert ok
    ok, why = oc.conv_config_is_valid(*BENCH, 3, 32, 64)
    assert not ok and "divide" in why
    # the TPU's (7, 128, 128): 7 x 56 x 128 outputs, more than 256 threads
    # of 8 x 8 hold
    ok, why = oc.conv_config_is_valid(*BENCH, 7, 128, 128)
    assert not ok and "threads" in why
    ok, why = oc.conv_config_is_valid(*BENCH, 8, 128, 128)
    assert not ok and "threads" in why
    # shared memory: 3 x 256 x 256 bf16 weight slices alone are 384 KB
    ok, why = oc.conv_config_is_valid(*BENCH, 1, 256, 256)
    assert not ok and "shared memory" in why
    assert oc.conv_config_is_valid(*BENCH, 1, 256, 128)[0]
    assert not oc.conv_config_is_valid(*BENCH, 1, 256, 128,
                                       dtype="float32")[0]
    ok, why = oc.conv_config_is_valid(1, 56, 56, 256, 256, 3, 3, 2, 1,
                                      1, 32, 64)
    assert not ok and "stride" in why
    assert (oc.predicted_conv_seconds(*BENCH, 1, 1, 1)
            > oc.predicted_conv_seconds(*BENCH, 2, 128, 64) * 5)


def test_snap_conv_config_to_hw():
    # bco up to a multiple of 32, bci to a multiple of 8
    assert oc.snap_conv_config_to_hw(*BENCH, 1, 4, 4) == (1, 32, 8)
    assert oc.snap_conv_config_to_hw(*BENCH, 2, 100, 60) == (2, 128, 64)
    # within the limits: unchanged
    assert oc.snap_conv_config_to_hw(*BENCH, 4, 64, 32) == (4, 64, 32)
    # too many outputs: boh shrinks (boh x OW = 3136 > bco)
    assert oc.snap_conv_config_to_hw(*BENCH, 56, 32, 8) == (8, 32, 8)
    # too much shared memory: bci shrinks first
    assert oc.snap_conv_config_to_hw(*BENCH, 1, 256, 256) == (1, 256, 128)
    # CO below 32: the whole axis
    small = (1, 28, 28, 16, 64, 3, 3, 1, 1)
    assert oc.snap_conv_config_to_hw(*small, 2, 3, 5) == (2, 16, 8)
    # stride 2 never fits the stride-1 kernel
    s2 = (1, 56, 56, 64, 64, 3, 3, 2, 1)
    assert not oc.conv_config_is_valid(
        *s2, *oc.snap_conv_config_to_hw(*s2, 1, 32, 8))[0]


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
        assert ok or cfg[1] == CO or cfg[2] == CI, (raw, cfg, why)
        assert oc.snap_conv_config_to_hw(*params, *cfg, dtype=dtype) == cfg


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    x, w, b = (torch.as_tensor(t) for t in _inputs(3, 1, 6, 6, 4, 8, 3, 3))
    before = oc.conv2d.launches
    assert torch.equal(oc.conv2d(x, w, b, 1, 6, 4, 8),
                       oc.conv2d_plain(x, w, b, 1))
    assert oc.conv2d.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        oc.conv2d(x.to("meta"), w.to("meta"), b.to("meta"), 1, 6, 4, 8)
