"""The float32 conv2d kernel's launch plan (``ops/conv2d.py::f32_plan``, a
pure function of the shape and (boh, bco, bci) that ``conv2d`` launches
from and ``csrc/conv2d.cu`` computes again): the grid's position tiles
cover every output once, each tile's staged window covers every (position,
kh, kw) read, shared memory fits with the ring's stated depth, the tiles
are the library's instances, and the stand-in timer ranks a config that
fills the card's waves ahead of one that does not. The block and thread
indexing below restates the kernel's (``conv_f32``); the kernel itself is
held against the plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). The zero-padded staging of CI and CO off a multiple of 4 is
held against the JAX Pallas conv2d in interpret mode."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vae_extent_search_tpu.ops.conv2d_pallas import make_conv2d
from vae_extent_search_tpu_torch.ops import conv2d as oc
from vae_extent_search_tpu_torch.ops import matmul as om
from vae_extent_search_tpu_torch.ops.build import (
    MAX_SMEM_BYTES,
    SM_SMEM_BYTES,
)

torch.set_num_threads(2)
CSRC = Path(oc.__file__).resolve().parent.parent / "csrc"
F32 = dict(dtype="float32")
H100_SMS = 132

# (N, H, W, CO, CI, KH, KW, pad): every conv shape of the port's tests and
# chip_smoke.py, then ResNet-style stride-1 layers at OW 7, 14, 28, 56, 112
SHAPES = [
    (1, 56, 56, 256, 256, 3, 3, 1),     # the tuning shape
    (2, 8, 8, 6, 256, 3, 3, 1),
    (3, 10, 7, 2, 4, 3, 3, 0),
    (1, 8, 8, 4, 8, 3, 3, 1),
    (2, 9, 11, 6, 5, 3, 3, 1),
    (2, 6, 150, 20, 12, 3, 3, 1),
    (1, 14, 14, 40, 24, 1, 1, 0),
    (1, 64, 3, 384, 16, 3, 3, 1),
    (1, 512, 1, 384, 8, 1, 1, 0),
    (1, 28, 28, 64, 128, 3, 3, 1),
    (2, 14, 14, 36, 36, 3, 3, 1),
    (1, 14, 14, 64, 32, 3, 3, 1),
    (1, 14, 14, 512, 512, 1, 1, 0),
    (1, 6, 6, 4, 8, 3, 3, 1),
    (1, 7, 7, 512, 512, 3, 3, 1),
    (1, 14, 14, 256, 256, 3, 3, 1),
    (1, 28, 28, 128, 128, 3, 3, 1),
    (1, 56, 56, 64, 64, 3, 3, 1),
    (1, 112, 112, 64, 3, 7, 7, 3),
]


def _out(shape):
    N, H, W, CO, CI, KH, KW, pad = shape
    return H + 2 * pad - KH + 1, W + 2 * pad - KW + 1


def _configs(shape):
    """Valid configs of the shape: boh at a few row counts (one row, a
    divisor or not of OH, all of it), every channel tile, two ci blocks."""
    N, H, W, CO, CI, KH, KW, pad = shape
    OH, _ = _out(shape)
    out = []
    for boh in sorted({1, 2, 3, 5, 8, OH} & set(range(1, OH + 1))):
        for bco in oc.F32_BN:
            for bci in (8, 32):
                params = (N, H, W, CO, CI, KH, KW, 1, pad)
                if oc.conv_config_is_valid(*params, boh, bco, bci, **F32)[0]:
                    out.append((boh, bco, bci))
    assert out
    return out


def _plan(shape, cfg):
    N, H, W, CO, CI, KH, KW, pad = shape
    OH, OW = _out(shape)
    COp = -(-CO // 4) * 4          # the wrapper stages CO up to 4
    return oc.f32_plan(N, OH, OW, COp, KW, *cfg)


def _blocks(plan, N, OH, boh, CO):
    """The kernel's block decode: (n, oh0, p0, co0) of every block, and
    whether it holds a position below OH (else it returns at once)."""
    tiles_co = -(-CO // plan.bn)
    for b in range(plan.blocks):
        co0 = (b % tiles_co) * plan.bn
        b //= tiles_co
        p0 = (b % plan.tiles) * plan.bm
        b //= plan.tiles
        oh0, n = (b % plan.row_blocks) * boh, b // plan.row_blocks
        live = min(boh, OH - oh0) * plan.row_width
        yield n, oh0, p0, co0, p0 < live, live


@pytest.mark.parametrize("shape", SHAPES)
def test_position_tiles_cover_every_output_once(shape):
    N, H, W, CO, CI, KH, KW, pad = shape
    OH, OW = _out(shape)
    COp = -(-CO // 4) * 4
    for boh, bco, bci in _configs(shape):
        plan = _plan(shape, (boh, bco, bci))
        OWq = plan.row_width
        assert OWq % 4 == 0 and OW <= OWq < OW + 4
        assert plan.tiles == -(-boh * OWq // plan.bm)
        assert plan.row_blocks == -(-OH // boh)
        hits = np.zeros((N, OH, OW, COp), np.int32)
        busy = 0
        for n, oh0, p0, co0, alive, live in _blocks(plan, N, OH, boh, COp):
            if not alive:
                continue
            busy += 1
            p = np.arange(p0, min(p0 + plan.bm, live))
            r, c = p // OWq, p % OWq
            keep = c < OW                      # the padding columns
            np.add.at(hits, (n, oh0 + r[keep], c[keep],
                             slice(co0, min(co0 + plan.bn, COp))), 1)
        assert busy == plan.busy
        assert (hits == 1).all(), (shape, boh, bco, bci)


@pytest.mark.parametrize("shape", SHAPES)
def test_each_window_covers_every_read(shape):
    """Every thread group of four positions (the stored ones and the
    clamped ones past the row block) reads window entries inside the
    stage, and each stored position's entry at tap (kh, kw) holds the
    input it needs: xpad row oh + kh, column ow + kw."""
    N, H, W, CO, CI, KH, KW, pad = shape
    OH, OW = _out(shape)
    for boh, bco, bci in _configs(shape):
        plan = _plan(shape, (boh, bco, bci))
        OWq, OWp = plan.row_width, plan.row_width + KW - 1
        P = boh * OWq
        for n, oh0, p0, co0, alive, live in _blocks(plan, N, OH, boh, 4):
            if not alive or n or co0:
                continue
            f0 = p0 + (p0 // OWq) * (KW - 1)
            groups = p0 + 4 * np.arange(plan.bm // 4)
            read = np.minimum(groups, P - 4)
            wrow = read + (read // OWq) * (KW - 1) - f0
            assert wrow.min() >= 0
            assert wrow.max() + 3 + KW - 1 < plan.window
            for i in range(4):
                p = groups + i
                stored = (p < live) & (p % OWq < OW)
                for kw in range(KW):
                    e = (wrow + i + kw)[stored]
                    r, col = np.divmod(f0 + e, OWp)
                    # the entry's padded row and column are the position's
                    # own row and column + kw; the kernel adds kh to the row
                    assert (r == p[stored] // OWq).all()
                    assert (col == p[stored] % OWq + kw).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_shared_memory_fits_and_two_blocks_where_the_ring_says(shape):
    for cfg in _configs(shape):
        plan = _plan(shape, cfg)
        KW, bci = shape[6], cfg[2]
        assert plan.stage_bytes == 4 * (plan.window * (bci + om.F32_ROW_PAD)
                                        + KW * bci * plan.bn)
        assert 2 <= plan.stages <= om.F32_MAX_STAGES
        assert plan.stages * plan.stage_bytes <= MAX_SMEM_BYTES
        two = 2 * (plan.stages * plan.stage_bytes + om.BLOCK_RESERVED_BYTES)
        deeper = 2 * ((plan.stages + 1) * plan.stage_bytes
                      + om.BLOCK_RESERVED_BYTES)
        # the deepest ring that leaves room for two blocks per SM; where
        # even two stages do not, one block per SM
        assert two <= SM_SMEM_BYTES or plan.stages == 2
        assert plan.stages == om.F32_MAX_STAGES or deeper > SM_SMEM_BYTES


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_tiles_are_the_library_instances(shape):
    src = (CSRC / "conv2d.cu").read_text()

    def values(name):
        line = re.search(rf"#define {name}\(X\) (.*)", src).group(1)
        return tuple(int(v) for v in re.findall(r"X\((\d+)\)", line))

    assert values("CONV_F32_BM") == oc.F32_BM
    assert values("CONV_F32_BN") == oc.F32_BN
    for cfg in _configs(shape):
        plan = _plan(shape, cfg)
        assert plan.bm in oc.F32_BM and plan.bn in oc.F32_BN
        # F32Tile: 8 x 8 thread tiles where they fill whole warps, else 8 x 4
        assert plan.tn == (8 if (plan.bm * plan.bn // 64) % 32 == 0 else 4)
        assert plan.threads == plan.bm * plan.bn // (8 * plan.tn)
        assert plan.threads % 32 == 0 and plan.threads <= 288


def test_the_source_states_the_plan_and_the_wrapper_checks():
    src = (CSRC / "conv2d.cu").read_text()
    assert '#include "f32_tile.cuh"' in src
    assert "return (OW + 3) & ~3;" in src
    assert "const int span = (bm + OWq - 2) / OWq + 1;" in src
    assert "return bm + (span < boh ? span : boh) * (KW - 1);" in src
    assert "(bci != 8 && bci != 16 && bci != 32)" in src
    assert oc.F32_BCI == (8, 16, 32)
    assert "CI % 4 ||\n      CO % 4" in src


@pytest.mark.parametrize("positions,bm", [
    (56, 64), (112, 128), (168, 96), (224, 32), (448, 64), (672, 96),
    (896, 128), (3136, 64), (4, 32), (16, 32), (64, 64), (96, 96),
    (304, 64), (600, 32)])
def test_f32_bm_masks_the_fewest_positions(positions, bm):
    assert oc.f32_bm(positions) == bm
    waste = -positions % bm
    assert all(-positions % b > waste or (-positions % b == waste
                                          and b <= bm) for b in oc.F32_BM)


def test_the_tuning_shape_has_configs_that_fill_a_wave():
    """At 1 x 56 x 56 x 256 -> 256 the lattice holds 8 x 8 (and 8 x 4)
    tiles whose blocks fill at least one wave of 132 SMs."""
    shape = (1, 56, 56, 256, 256, 3, 3, 1)
    full = {}
    for boh in range(1, 57):
        for bco in oc.F32_BN:
            plan = _plan(shape, (boh, bco, 32))
            if plan.busy >= H100_SMS:
                full.setdefault(plan.tn, []).append((boh, bco, plan.busy))
    assert (8, 64, 196) in full[8] and (1, 64, 224) in full[8]
    assert full[4]
    # boh 8 at bco 64: 7 row blocks x 7 tiles of 64 positions x 4 channel
    # tiles, no position masked
    plan = _plan(shape, (8, 64, 32))
    assert (plan.bm, plan.tiles, plan.row_blocks, plan.blocks) == (64, 7, 7,
                                                                   196)


@pytest.mark.parametrize("fills,short", [
    ((8, 64, 32), (16, 128, 32)),     # 196 blocks against 50 busy
    ((1, 64, 32), (3, 128, 32)),      # 224 against 76 of 96 x 128
    ((4, 128, 32), (2, 128, 32)),     # 196 of 32 x 128 against 56
])
def test_predicted_f32_ranks_the_filling_config_first(fills, short):
    bench = (1, 56, 56, 256, 256, 3, 3, 1, 1)
    p = oc.predicted_conv_seconds
    assert p(*bench, *fills, **F32) < p(*bench, *short, **F32)


@pytest.mark.parametrize("shape", [(2, 9, 11, 6, 5, 3, 3, 1),
                                   (3, 10, 7, 2, 4, 3, 3, 0),
                                   (1, 8, 8, 7, 3, 3, 3, 1)])
def test_staging_off_4_keeps_the_jax_result(shape):
    """CI or CO off a multiple of 4: the wrapper's zero-padded copies of x
    and w (ops/matmul.py::staged) give the unpadded conv, held against the
    JAX Pallas conv2d in interpret mode (the padded channels add exact
    zeros; the padded outputs are cut)."""
    N, H, W, CO, CI, KH, KW, pad = shape
    rng = np.random.default_rng(CO + CI)
    x = rng.standard_normal((N, H, W, CI)).astype(np.float32)
    w = rng.standard_normal((KH, KW, CI, CO)).astype(np.float32)
    b = rng.standard_normal(CO).astype(np.float32)
    xs, ws = om.staged(torch.as_tensor(x), torch.as_tensor(w), om.F32_ALIGN)
    assert xs.shape[-1] % 4 == 0 and ws.shape[2:] == (xs.shape[-1],
                                                      -(-CO // 4) * 4)
    assert not xs[..., CI:].any() and not ws[:, :, CI:].any()
    bias = torch.nn.functional.pad(torch.as_tensor(b), (0, ws.shape[3] - CO))
    got = oc.conv2d_plain(xs, ws, bias, pad)[..., :CO].numpy()
    want = np.asarray(make_conv2d(N, H, W, CO, CI, KH, KW, 1, pad, 1, CO, CI,
                                  dtype_name="float32", interpret=True)(
                                      x, w, b))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5
