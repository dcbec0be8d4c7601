"""The port's matmul module (ops/matmul.py) on the CPU: its plain version
against the JAX package's Pallas matmul in interpret mode at the JAX
tests' configurations, and the Hopper lattices of its two kernels (the
float32 CUDA-core kernel: validity, snapping, the thread micro-tile; the
bfloat16 tensor-core kernel: each refusal, the derived stage count, the
register and shared-memory limits, ragged tiles, and the instances the
source is built for). The CUDA kernels themselves are held against the
plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_extent_search_tpu.ops.matmul_pallas import make_matmul
from vae_extent_search_tpu_torch.ops import matmul as om
from vae_extent_search_tpu_torch.ops.build import MAX_SMEM_BYTES

torch.set_num_threads(2)
CSRC = Path(om.__file__).resolve().parent.parent / "csrc"
F32 = dict(dtype="float32")


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


@pytest.mark.parametrize("dims,jax_cfg", [((7, 33, 5), (7, 33, 5)),
                                          ((64, 64, 20), (64, 64, 20))])
def test_bf16_staging_matches_jax_kernel(dims, jax_cfg):
    """K or N off a multiple of 8: the zero-padded operands the wrapper
    hands the bf16 kernel give, cut back to [M, N], the JAX Pallas matmul's
    product (interpret mode, on the JAX lattice's whole-axis tiles)."""
    M, N, K = dims
    rng = np.random.default_rng(M + N + K)
    a = rng.standard_normal((M, K), np.float32)
    b = rng.standard_normal((K, N), np.float32)
    want = np.asarray(make_matmul(M, N, K, *jax_cfg, dtype_name="bfloat16",
                                  interpret=True)(a, b))
    ta, tb = torch.as_tensor(a).bfloat16(), torch.as_tensor(b).bfloat16()
    pa, pb = om.bf16_staged(ta, tb)
    assert pa.shape[1] % 8 == 0 and pb.shape[1] % 8 == 0
    assert pa.shape[1] == pb.shape[0] and pa.is_contiguous()
    assert torch.equal(pa[:, :K], ta) and not pa[:, K:].any()
    assert torch.equal(pb[:K, :N], tb) and not pb[K:].any()
    got = om.matmul_plain(pa, pb)[:, :N]
    # the same bf16-rounded products, each summed in f32; the padded K
    # terms add exact zeros
    rel = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert rel < 1e-5
    assert torch.equal(om.matmul(ta, tb, 64, 16, 16), got)
    # aligned shapes are handed over as they are
    sa, sb = om.bf16_staged(pa, pb)
    assert sa is pa and sb is pb


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
    # the float32 CUDA-core kernel: exact tiling, threads, shared memory
    ok, _ = om.config_is_valid(256, 256, 256, 128, 128, 128, **F32)
    assert ok
    ok, why = om.config_is_valid(256, 256, 256, 100, 128, 64, **F32)
    assert not ok and "divide" in why
    ok, why = om.config_is_valid(256, 256, 256, 0, 128, 64, **F32)
    assert not ok
    # more outputs than 256 threads of 8 x 8 can hold
    ok, why = om.config_is_valid(4096, 4096, 4096, 256, 128, 64, **F32)
    assert not ok and "threads" in why
    # shared memory: (128 + 128) x 256 f32 = 256 KB > 227 KB; 192 fits
    ok, why = om.config_is_valid(1536, 1536, 1536, 128, 128, 256, **F32)
    assert not ok and "shared memory" in why
    assert om.config_is_valid(1536, 1536, 1536, 128, 128, 192, **F32)[0]
    assert om.matmul_smem_bytes(128, 128, 192, 4) <= MAX_SMEM_BYTES
    # tiny blocks predict far slower than a 128 x 128 tile
    assert (om.predicted_seconds(1536, 1536, 1536, 2, 1, 3, **F32)
            > om.predicted_seconds(1536, 1536, 1536, 128, 128, 64, **F32)
            * 100)


def test_snap_config_to_hw():
    def snap(*raw, dims=(1536, 1536, 1536)):
        return om.snap_config_to_hw(*dims, *raw, **F32)

    # bn up to a multiple of 32, bk up to a multiple of 8; divisors only
    assert snap(64, 96, 4) == (64, 96, 8)
    assert snap(2, 1, 3) == (2, 32, 8)
    # ... then (24 + 256) x 256 f32 (280 KB) is over shared memory
    assert snap(24, 200, 400) == (24, 256, 192)
    # on the lattice and within the limits: unchanged
    assert snap(128, 128, 64) == (128, 128, 64)
    # over the thread limit: the larger of bm, bn shrinks, in turn
    assert snap(512, 256, 8) == (128, 128, 8)
    # over shared memory: bk shrinks first
    assert snap(128, 128, 768) == (128, 128, 192)
    # an axis with no multiple of the alignment: the whole axis
    assert snap(3, 3, 3, dims=(64, 24, 6)) == (4, 24, 6)
    # a prime axis too long for one block cannot be tiled
    cfg = snap(1, 1, 1, dims=(8, 257 * 127, 8))
    assert cfg[1] == 257 * 127 and not om.config_is_valid(
        8, 257 * 127, 8, *cfg, **F32)[0]


@pytest.mark.parametrize("cfg,dims,reason", [
    ((100, 128, 64), (256, 256, 256), "bm=100 not in"),
    ((192, 128, 64), (256, 256, 256), "bm=192 not in"),
    ((128, 120, 64), (256, 256, 256), "bn=120 not a wgmma width"),
    ((128, 128, 128), (256, 256, 256), "bk=128 not in"),
    ((128, 128, 8), (256, 256, 256), "bk=8 not in"),
    ((256, 160, 64), (1536, 1536, 1536), "registers: 160 accumulators"),
    ((256, 256, 16), (1536, 1536, 1536), "registers: 256 accumulators"),
    # K or N off TMA's 16-byte alignment: valid, the wrapper stages the
    # operands (reason None; the ids name what these shapes once hit)
    pytest.param((64, 16, 16), (7, 33, 5), None, id="cfg7-dims7-TMA"),
    pytest.param((64, 16, 16), (64, 64, 20), None, id="cfg8-dims8-TMA"),
    ((0, 16, 16), (64, 64, 64), "bm=0 out of range"),
])
def test_bf16_refusals(cfg, dims, reason):
    ok, why = om.config_is_valid(*dims, *cfg)
    if reason is None:
        assert ok and why is None, why
    else:
        assert not ok and why.startswith(reason), why


@pytest.mark.parametrize("dims,cfg", [
    ((96, 160, 72), (64, 64, 32)), ((1000, 24, 40), (64, 32, 64)),
    ((200, 88, 200), (256, 128, 64)), ((8, 8, 8), (128, 256, 64))])
def test_bf16_ragged_tiles_are_valid(dims, cfg):
    # tiles need not divide the axes (TMA zero-fills, stores are masked)
    assert om.config_is_valid(*dims, *cfg) == (True, None)


@pytest.mark.parametrize("cfg,stages", [
    ((64, 16, 16), 6), ((128, 128, 64), 6), ((64, 256, 64), 5),
    ((128, 256, 64), 4), ((256, 128, 64), 4), ((256, 256, 64), 3)])
def test_bf16_stage_count_is_derived_from_shared_memory(cfg, stages):
    assert om.bf16_stages(*cfg) == stages
    assert om.bf16_smem_bytes(*cfg, stages) <= MAX_SMEM_BYTES
    if stages < om.MAX_STAGES:
        assert om.bf16_smem_bytes(*cfg, stages + 1) > MAX_SMEM_BYTES
    # every stage starts at a 1 KB boundary (the 128-byte swizzle's period)
    per_stage = (om.bf16_smem_bytes(*cfg, stages) - 1024) // stages - 16
    assert per_stage % 1024 == 0
    assert per_stage >= (cfg[0] + cfg[1]) * cfg[2] * 2


def test_bf16_lattice_fits_the_card():
    # every configuration of the lattice holds two stages or more, and its
    # accumulators fit 128 registers exactly where the library has it
    for bm in om.BF16_BM:
        wg, atoms = om.bf16_atoms(bm)
        assert 64 * wg * atoms == bm and wg in (1, 2)
        for bn in om.BF16_BN:
            for bk in om.BF16_BK:
                assert om.bf16_stages(bm, bn, bk) >= 2
            assert (om.bf16_accumulators(bm, bn) <= om.ACC_REGS) == (
                bm < 256 or bn <= 128)


def _cu_instances():
    src = (CSRC / "matmul.cu").read_text()

    def widths(name):
        line = re.search(rf"#define {name}\(X\) (.*)", src).group(1)
        return [int(v) for v in re.findall(r"X\((\d+)\)", line)]

    return ({(bm, n) for bm in (64, 128) for n in widths("MM_WIDE")}
            | {(256, n) for n in widths("MM_NARROW")})


def test_the_source_holds_exactly_the_lattice():
    want = {(bm, bn) for bm in om.BF16_BM for bn in om.BF16_BN
            if om.bf16_accumulators(bm, bn) <= om.ACC_REGS}
    assert _cu_instances() == want


def test_wgmma_header_is_generated_for_the_lattice():
    spec = importlib.util.spec_from_file_location("gen_wgmma",
                                                  CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.WIDTHS == om.BF16_BN
    assert gen.HEADER.read_text() == gen.render()
    # one accumulator operand per two columns
    assert gen.op(64).count('"+f"') == 32
    assert "m64n256k16" in gen.render()


@pytest.mark.parametrize("raw,want", [
    ((64, 96, 4), (64, 96, 16)), ((2, 1, 3), (64, 16, 16)),
    ((24, 200, 400), (64, 224, 64)), ((128, 128, 64), (128, 128, 64)),
    ((512, 256, 8), (256, 128, 16)), ((256, 160, 16), (256, 128, 16)),
    ((96, 64, 16), (128, 64, 16))])
def test_snap_bf16_at_1536(raw, want):
    # each of bm, bn, bk up to the lattice, then bn narrows until the
    # accumulators fit
    assert om.snap_config_to_hw(1536, 1536, 1536, *raw) == want


def test_snap_bf16_is_capped_by_the_axes():
    # a raw tile is first cut to the axis, so a small axis takes the
    # smallest lattice value that covers it
    assert om.snap_config_to_hw(96, 24, 1000, 96, 24, 1000) == (128, 32, 64)
    assert om.snap_config_to_hw(1000, 24, 40, 8, 24, 40) == (64, 32, 64)
    assert om.snap_config_to_hw(96, 160, 72, 3, 32, 72) == (64, 32, 64)
    # K or N off TMA's alignment: on the lattice and valid (staged)
    cfg = om.snap_config_to_hw(7, 33, 5, 7, 33, 5)
    assert cfg == (64, 64, 16)
    assert om.config_is_valid(7, 33, 5, *cfg) == (True, None)


def test_predicted_seconds_bf16_counts_ragged_tiles():
    p = om.predicted_seconds
    # wider tiles keep the tensor cores busier
    assert p(1536, 1536, 1536, 128, 256, 64) < p(1536, 1536, 1536, 64, 64, 64)
    # a K of 1544 pads to whole bk steps: one more step of every tile
    assert p(1536, 1536, 1544, 128, 128, 64) > p(1536, 1536, 1536, 128, 128,
                                                 64)
    # within a factor of the tensor-core bound at the tuning shape
    bound = 2 * 1536 ** 3 / om.PEAK_FLOPS["bfloat16"]
    assert bound < p(1536, 1536, 1536, 128, 128, 64) < 20 * bound
    assert math.isfinite(p(7, 8, 8, 64, 16, 16))


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
        if dtype == "bfloat16":
            # on the lattice and valid, K and N off 8 included
            assert (cfg[0] in om.BF16_BM and cfg[1] in om.BF16_BN
                    and cfg[2] in om.BF16_BK), cfg
            assert ok, why
        else:
            assert ok or M == cfg[0] or N == cfg[1] or K == cfg[2], (
                raw, cfg, why)
        assert om.snap_config_to_hw(M, N, K, *cfg, dtype=dtype) == cfg


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    a, b = torch.randn(32, 16), torch.randn(16, 64)
    before = om.matmul.launches
    # a CPU tensor runs the plain version, whatever the config
    assert torch.equal(om.matmul(a, b, 32, 64, 16), om.matmul_plain(a, b))
    assert om.matmul.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        om.matmul(a.to("meta"), b.to("meta"), 32, 64, 16)
