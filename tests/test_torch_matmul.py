"""The port's matmul module (ops/matmul.py) on the CPU: its plain version
against the JAX package's Pallas matmul in interpret mode at the JAX
tests' configurations, the zero-padded staging of K or N off 16-byte rows
against it, and the Hopper lattices of its two kernels (the float32
CUDA-core kernel: validity, snapping, the derived stage count, the wave
model, the instances the source is built for; the bfloat16 tensor-core
kernel: each refusal, the derived stage count, the register and
shared-memory limits, ragged tiles, and the instances). The CUDA kernels
themselves are held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

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
    pa, pb = om.staged(ta, tb, om.TMA_ALIGN)
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
    sa, sb = om.staged(pa, pb, om.TMA_ALIGN)
    assert sa is pa and sb is pb


@pytest.mark.parametrize("dims", [(7, 33, 5), (64, 64, 21)])
def test_f32_staging_matches_jax_kernel(dims):
    """K or N off a multiple of 4 (the f32 kernel's 16-byte copies): the
    zero-padded float32 operands the wrapper hands the kernel give, cut
    back to [M, N], the JAX Pallas matmul's float32 product (interpret
    mode, whole-axis tiles)."""
    M, N, K = dims
    rng = np.random.default_rng(M * N + K)
    a = rng.standard_normal((M, K), np.float32)
    b = rng.standard_normal((K, N), np.float32)
    want = np.asarray(make_matmul(M, N, K, M, N, K, dtype_name="float32",
                                  interpret=True)(a, b))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    pa, pb = om.staged(ta, tb, om.F32_ALIGN)
    assert pa.shape[1] % 4 == 0 and pb.shape[1] % 4 == 0
    assert pa.shape[1] == pb.shape[0] and pa.is_contiguous()
    assert torch.equal(pa[:, :K], ta) and not pa[:, K:].any()
    assert torch.equal(pb[:K, :N], tb) and not pb[K:].any()
    assert not pb[:, N:].any()
    got = om.matmul_plain(pa, pb)[:, :N]
    # the same f32 products summed in another order; the padded K terms
    # add exact zeros
    rel = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert rel < 1e-5
    assert torch.equal(om.matmul(ta, tb, 32, 32, 8), om.matmul_plain(ta, tb))
    sa, sb = om.staged(pa, pb, om.F32_ALIGN)
    assert sa is pa and sb is pb


def test_config_validity():
    # the float32 CUDA-core kernel: the lattice's tiles at any shape
    ok, _ = om.config_is_valid(256, 256, 256, 128, 128, 32, **F32)
    assert ok
    ok, why = om.config_is_valid(256, 256, 256, 100, 128, 16, **F32)
    assert not ok and why.startswith("bm=100 not in")
    ok, why = om.config_is_valid(256, 256, 256, 128, 120, 16, **F32)
    assert not ok and why.startswith("bn=120 not in")
    ok, why = om.config_is_valid(256, 256, 256, 0, 128, 16, **F32)
    assert not ok and why == "bm=0 out of range"
    # bk: whole float4 groups, a power of two of them per A row
    for bk in (4, 12, 24, 64, 256):
        ok, why = om.config_is_valid(1536, 1536, 1536, 128, 128, bk, **F32)
        assert not ok and why.startswith(f"bk={bk} not in"), why
    # tiles need not divide M, N or K (zero-filled copies, masked stores),
    # and K or N off a multiple of 4 is staged by the wrapper
    for dims in ((1000, 24, 40), (96, 160, 72), (7, 33, 5), (1, 1, 1),
                 (8, 257 * 127, 8)):
        assert om.config_is_valid(*dims, 96, 128, 32, **F32) == (True, None)
    # every configuration of the lattice fits 227 KB, with two blocks of
    # two stages or more per SM
    for bm in om.F32_BM:
        for bn in om.F32_BN:
            for bk in om.F32_BK:
                st = om.f32_stages(bm, bn, bk)
                assert 2 <= st <= om.F32_MAX_STAGES
                assert 2 * (om.matmul_smem_bytes(bm, bn, bk, st) + 1024) \
                    <= om.SM_SMEM_BYTES
                assert om.config_is_valid(64, 64, 64, bm, bn, bk, **F32)[0]
    # the ring's depth: as deep as two blocks per SM allow, up to four
    assert om.f32_stages(128, 128, 32) == 3
    assert om.f32_stages(128, 128, 16) == 4
    assert om.matmul_smem_bytes(128, 128, 32, 3) == 3 * (128 * 36
                                                         + 32 * 128) * 4


def test_f32_thread_tile_fills_whole_warps():
    # 8 x 8 accumulators per thread where that gives whole warps, else
    # 8 x 4 (csrc/matmul.cu::F32Tile)
    def threads(bm, bn):
        return bm * bn // (8 * om.f32_thread_tile(bm, bn))

    assert om.f32_thread_tile(128, 128) == 8 and threads(128, 128) == 256
    assert om.f32_thread_tile(128, 96) == 8 and threads(128, 96) == 192
    assert om.f32_thread_tile(96, 96) == 4 and threads(96, 96) == 288
    assert om.f32_thread_tile(32, 32) == 4 and threads(32, 32) == 32
    for bm in om.F32_BM:
        for bn in om.F32_BN:
            assert threads(bm, bn) % 32 == 0 and threads(bm, bn) <= 288


def test_predicted_seconds_f32_prefers_tiles_that_fill_the_waves():
    # at 1536^3 a 128 x 128 tile gives 144 tiles, 1.09 waves of 132 SMs;
    # 96 x 96 gives 256 (1.94 waves), 128 x 96 192: both ahead of it
    p = om.predicted_seconds
    big = p(1536, 1536, 1536, 128, 128, 32, **F32)
    assert p(1536, 1536, 1536, 96, 96, 32, **F32) < big
    assert p(1536, 1536, 1536, 128, 96, 32, **F32) < big
    # within a factor of the CUDA-core bound
    bound = 2 * 1536 ** 3 / om.PEAK_FLOPS["float32"]
    assert bound < big < 3 * bound
    # ragged tiles count whole tiles (272 of 96 x 96 at M = 1540: a third
    # wave) and whole k-steps
    assert p(1540, 1536, 1536, 96, 96, 32, **F32) > p(1536, 1536, 1536, 96,
                                                      96, 32, **F32)
    assert p(1536, 1536, 1544, 128, 128, 32, **F32) > big
    assert math.isfinite(p(7, 8, 5, 32, 32, 8, **F32))


def test_snap_config_to_hw():
    def snap(*raw, dims=(1536, 1536, 1536)):
        return om.snap_config_to_hw(*dims, *raw, **F32)

    # each of bm, bn, bk up to the lattice
    assert snap(64, 96, 4) == (64, 96, 8)
    assert snap(2, 1, 3) == (32, 32, 8)
    assert snap(24, 200, 400) == (32, 128, 32)
    assert snap(100, 65, 9) == (128, 96, 16)
    # on the lattice: unchanged
    assert snap(128, 128, 32) == (128, 128, 32)
    assert snap(96, 64, 16) == (96, 64, 16)
    # past the lattice: its largest value
    assert snap(512, 256, 8) == (128, 128, 8)
    assert snap(128, 128, 768) == (128, 128, 32)
    # a raw tile is first cut to the axis
    assert snap(3, 3, 3, dims=(64, 24, 6)) == (32, 32, 8)
    assert snap(64, 64, 64, dims=(40, 24, 12)) == (64, 32, 16)
    # a prime axis too long for one block: ragged tiles, valid
    cfg = snap(1, 1, 1, dims=(8, 257 * 127, 8))
    assert cfg == (32, 32, 8)
    assert om.config_is_valid(8, 257 * 127, 8, *cfg, **F32) == (True, None)


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


def test_the_source_holds_exactly_the_f32_lattice():
    # the ring depth and row pad live in the header the f32 conv2d shares
    src = (CSRC / "matmul.cu").read_text()
    assert '#include "f32_tile.cuh"' in src
    src += (CSRC / "f32_tile.cuh").read_text()

    def values(name):
        line = re.search(rf"#define {name}\(X\) (.*)", src).group(1)
        return [int(v) for v in re.findall(r"X\((\d+)\)", line)]

    assert {(bm, bn) for bm in values("F32_BM") for bn in values(
        "F32_BN")} == {(bm, bn) for bm in om.F32_BM for bn in om.F32_BN}
    # the kernel's bk check, ring depth and row pad are the wrapper's
    assert "bk != 8 && bk != 16 && bk != 32" in src
    assert om.F32_BK == (8, 16, 32)
    assert re.search(r"kF32MaxStages = (\d+);", src).group(1) == str(
        om.F32_MAX_STAGES)
    assert re.search(r"kF32Pad = (\d+);", src).group(1) == str(
        om.F32_ROW_PAD)


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
        # on the lattice and valid, K and N off 8 (bf16) or 4 (f32)
        # included
        if dtype == "bfloat16":
            assert (cfg[0] in om.BF16_BM and cfg[1] in om.BF16_BN
                    and cfg[2] in om.BF16_BK), cfg
        else:
            assert (cfg[0] in om.F32_BM and cfg[1] in om.F32_BN
                    and cfg[2] in om.F32_BK), cfg
        assert ok, why
        assert om.snap_config_to_hw(M, N, K, *cfg, dtype=dtype) == cfg


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    a, b = torch.randn(32, 16), torch.randn(16, 64)
    before = om.matmul.launches
    # a CPU tensor runs the plain version, whatever the config
    assert torch.equal(om.matmul(a, b, 32, 64, 16), om.matmul_plain(a, b))
    assert om.matmul.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        om.matmul(a.to("meta"), b.to("meta"), 32, 64, 16)
