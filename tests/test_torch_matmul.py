"""The port's matmul module (ops/matmul.py) on the CPU: its plain version
against the JAX package's Pallas matmul in interpret mode at the JAX
tests' configurations, and the kernel's Hopper lattice (validity,
snapping, the thread micro-tile). The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from vae_extent_search_tpu.ops.matmul_pallas import make_matmul
from vae_extent_search_tpu_torch.ops import matmul as om
from vae_extent_search_tpu_torch.ops.build import MAX_SMEM_BYTES

torch.set_num_threads(2)


@pytest.mark.parametrize("cfg", [(128, 128, 128), (64, 256, 32),
                                 (256, 256, 256), (8, 128, 64)])
def test_plain_matches_jax_kernel_f32(cfg):
    M = N = K = 256
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K), np.float32)
    b = rng.standard_normal((K, N), np.float32)
    want = np.asarray(make_matmul(M, N, K, *cfg, dtype_name="float32",
                                  interpret=True)(a, b))
    got = om.matmul(torch.as_tensor(a), torch.as_tensor(b), *cfg)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    # f32 sums in another order (tolerance of the JAX test)
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-4


def test_plain_matches_jax_kernel_bf16_inputs():
    M = N = K = 128
    rng = np.random.default_rng(1)
    a = rng.standard_normal((M, K), np.float32)
    b = rng.standard_normal((K, N), np.float32)
    want = np.asarray(make_matmul(M, N, K, 64, 64, 64,
                                  dtype_name="bfloat16", interpret=True)(a, b))
    got = om.matmul(torch.as_tensor(a).bfloat16(),
                    torch.as_tensor(b).bfloat16(), 64, 64, 64)
    assert got.dtype == torch.float32
    # the same bf16-rounded products, each summed in f32
    rel = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert rel < 1e-5


def test_thread_tile():
    assert om.thread_tile(128, 128) == (8, 8)      # 256 threads
    assert om.thread_tile(64, 64) == (4, 4)
    assert om.thread_tile(16, 16) == (1, 1)
    assert om.thread_tile(3, 32) == (1, 1)         # 96 threads
    assert om.thread_tile(256, 128) is None        # > 256 x 64 outputs
    assert om.thread_tile(7 * 56, 32) == (8, 8)    # 49 x 4 threads
    for rows in (1, 2, 3, 8, 12, 56, 96, 128, 392):
        for cols in (1, 32, 64, 96, 128, 256):
            tt = om.thread_tile(rows, cols)
            if tt is None:
                assert rows * cols > om.MAX_THREADS * 64
                continue
            tm, tn = tt
            assert rows % tm == 0 and cols % tn == 0
            assert (rows // tm) * (cols // tn) <= om.MAX_THREADS


def test_config_validity():
    ok, _ = om.config_is_valid(256, 256, 256, 128, 128, 128)
    assert ok
    ok, why = om.config_is_valid(256, 256, 256, 100, 128, 64)
    assert not ok and "divide" in why
    ok, why = om.config_is_valid(256, 256, 256, 0, 128, 64)
    assert not ok
    # more outputs than 256 threads of 8 x 8 can hold
    ok, why = om.config_is_valid(4096, 4096, 4096, 256, 128, 64)
    assert not ok and "threads" in why
    # shared memory: (128 + 128) x 512 bf16 = 256 KB > 227 KB; f32 at 256
    ok, why = om.config_is_valid(1536, 1536, 1536, 128, 128, 512)
    assert not ok and "shared memory" in why
    assert om.config_is_valid(1536, 1536, 1536, 128, 128, 384)[0]
    assert not om.config_is_valid(1536, 1536, 1536, 128, 128, 256,
                                  dtype="float32")[0]
    assert om.matmul_smem_bytes(128, 128, 384, 2) <= MAX_SMEM_BYTES
    # tiny blocks predict far slower than a 128 x 128 tile
    assert (om.predicted_seconds(1536, 1536, 1536, 2, 1, 3)
            > om.predicted_seconds(1536, 1536, 1536, 128, 128, 64) * 100)


def test_snap_config_to_hw():
    # bn up to a multiple of 32, bk up to a multiple of 8; divisors only
    assert om.snap_config_to_hw(1536, 1536, 1536, 64, 96, 4) == (64, 96, 8)
    assert om.snap_config_to_hw(1536, 1536, 1536, 2, 1, 3) == (2, 32, 8)
    # ... then (24 + 256) x 512 bf16 (280 KB) is over shared memory
    assert om.snap_config_to_hw(1536, 1536, 1536, 24, 200, 400) == \
        (24, 256, 384)
    # on the lattice and within the limits: unchanged
    assert om.snap_config_to_hw(1536, 1536, 1536, 128, 128, 64) == \
        (128, 128, 64)
    # over the thread limit: the larger of bm, bn shrinks, in turn
    assert om.snap_config_to_hw(1536, 1536, 1536, 512, 256, 8) == \
        (128, 128, 8)
    # over shared memory: bk shrinks first
    assert om.snap_config_to_hw(1536, 1536, 1536, 128, 128, 768) == \
        (128, 128, 384)
    # an axis with no multiple of the alignment: the whole axis
    assert om.snap_config_to_hw(64, 24, 6, 3, 3, 3) == (4, 24, 6)
    # a prime axis too long for one block cannot be tiled
    cfg = om.snap_config_to_hw(8, 257 * 127, 8, 1, 1, 1)
    assert cfg[1] == 257 * 127 and not om.config_is_valid(
        8, 257 * 127, 8, *cfg)[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dims", [(1536, 1536, 1536), (256, 512, 64),
                                  (96, 24, 1000), (7, 33, 5)])
def test_every_snap_lands_on_the_lattice(dims, dtype):
    M, N, K = dims
    rng = np.random.default_rng(sum(dims))

    def divisor(n):
        ds = [d for d in range(1, n + 1) if n % d == 0]
        return int(rng.choice(ds))

    for _ in range(300):
        raw = (divisor(M), divisor(N), divisor(K))
        cfg = om.snap_config_to_hw(M, N, K, *raw, dtype=dtype)
        ok, why = om.config_is_valid(M, N, K, *cfg, dtype=dtype)
        assert ok or M == cfg[0] or N == cfg[1] or K == cfg[2], (raw, cfg,
                                                                 why)
        assert om.snap_config_to_hw(M, N, K, *cfg, dtype=dtype) == cfg


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    a, b = torch.randn(32, 16), torch.randn(16, 64)
    before = om.matmul.launches
    # a CPU tensor runs the plain version, whatever the config
    assert torch.equal(om.matmul(a, b, 32, 64, 16), om.matmul_plain(a, b))
    assert om.matmul.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        om.matmul(a.to("meta"), b.to("meta"), 32, 64, 16)
