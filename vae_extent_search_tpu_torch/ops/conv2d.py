"""Implicit-GEMM conv2d + bias + ReLU, the second self-tuning target kernel
(counterpart of ``vae_extent_search_tpu/ops/conv2d_pallas.py``).

:func:`conv2d` computes ``relu(conv2d(x, w, stride 1, zero padding pad) +
bias)`` in float32 in the JAX package's layout, x [N, H, W, CI] (NHWC), w
[KH, KW, CI, CO] (HWIO), bias [CO] -> [N, OH, OW, CO], with the block
configuration ``(boh, bco, bci)`` that the active search tunes: one launch
of the hand-written CUDA kernel ``csrc/conv2d.cu`` when its inputs lie on a
CUDA device, and :func:`conv2d_plain` (``F.conv2d`` in float32 on
NCHW-permuted tensors) when they lie on the CPU. There is no fallback
between the two: a CUDA tensor launches the kernel or raises.

The configuration is the kernels' real tiling: a block computes output
rows of boh (a row block) x bco channels of one image and loops over (kh,
ci-block of bci), staging in shared memory the input window its positions
read and the weight slices [KW, bci, bco]. Zero padding is zero-filled
inside the kernel; no padded copy of x is made. The dtype chooses the kernel
and its lattice:

- **bfloat16, tensor cores** (``mma.sync`` m16n8k16 fed by ``ldmatrix``,
  a ring of ``cp.async`` buffers): bco a multiple of 16 up to 256 (pairs of
  8-channel mma tiles per ``ldmatrix.x4.trans``), bci in ``BF16_BCI``
  (k steps of 16), boh any row count up to OH; ``warp_tile`` must find up
  to 8 warps of at most 4 x 8 mma tiles each (``BF16_MT`` x ``BF16_NT``)
  covering the [boh * OW, bco] output tile (the accumulators then fit the
  registers of 256 threads); at least two buffers (window and weight rows
  padded by 16 bytes) within 227 KB; the ring's depth is derived, three
  where they fit. Ragged edges are masked, not refused: boh,
  bco and bci need not divide OH, CO and CI (bci 16 zero-fills CI < 16).
  The snap moves bco and bci up to the lattice (from at most the axis
  length), then shrinks bci for shared memory and the larger of boh * OW
  and bco for warps, until the configuration fits.
- **float32, CUDA cores** (exact FFMA; the f32 matmul's ``cp.async`` ring,
  float4 fragments and 8 x 8 or 8 x 4 thread tiles under the conv's shifted
  window): bco in ``F32_BN`` (the library's channel tiles, BN), bci in
  ``F32_BCI`` (whole float4 groups of ci, a power of two of them per window
  row), boh any row count up to OH. The launch plan (:func:`f32_plan`) is a
  pure function of the shape and the triple: positions of an output row are
  laid out OWq = OW rounded up to 4 (the padding columns are computed and not
  stored), a row block's boh * OWq positions are cut into tiles of BM =
  :func:`f32_bm` (boh * OWq), the lattice value of ``F32_BM`` that masks the
  fewest positions, the larger on a tie (at OW = 56: boh 8 gives 448
  positions, 7 tiles of 64); the grid is N x row blocks x position tiles x
  channel tiles (each (BM, BN) a kernel for KW = 3, which loads a window
  row once for the three taps, and one for any KW); the ring holds as many
  stages (2-4) as leave room for two blocks per SM, and two stages must fit
  227 KB. Ragged edges are masked,
  not refused: boh, bco and bci need not divide OH, CO and CI. Where CI or
  CO is not a multiple of 4 (the 16-byte copies) the wrapper stages
  zero-padded copies of x and w (``ops/matmul.py::staged``) and cuts the
  output back to CO. The snap moves bco and bci up to the lattice (from at
  most the axis length), then lowers bci, then bco, then halves boh while
  two stages do not fit; its stride-1 result is valid wherever two stages
  of the smallest tile fit (at any shape with KW up to 100).

Both kernels take stride 1 only. The validity result and the launch plan
are cached per shape and configuration.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .build import MAX_SMEM_BYTES, CudaLibrary, check_launch
from .matmul import (
    DTYPES,
    F32_ALIGN,
    F32_NARROW_SHARE,
    F32_ROW_PAD,
    HBM_BYTES_S,
    LAUNCH_S,
    NUM_SMS,
    PEAK_FLOPS,
    STEP_S,
    dtype_name,
    f32_thread_tile,
    ring_stages,
    staged,
    up_to,
)

BF16_BCO = tuple(range(16, 257, 16))
BF16_BCI = (16, 32, 64, 128)
BF16_MT = (1, 2, 4)       # 16-position mma tiles per warp
BF16_NT = (2, 4, 8)       # 8-channel mma tiles per warp
BF16_MAX_WARPS = 8
BF16_ROW_PAD = 8          # bf16 elements of padding per shared-memory row
BF16_MAX_BUFFERS = 3      # the cp.async ring's depth where it fits
# mma.sync's share of the wgmma peak assumed by the stand-in timer
MMA_SYNC_SHARE = 0.5
# the f32 CUDA-core kernel's lattice (csrc/conv2d.cu: CONV_F32_BM,
# CONV_F32_BN, one instance per pair; bci at run time)
F32_BM = (32, 64, 96, 128)
F32_BN = (32, 64, 96, 128)
F32_BCI = (8, 16, 32)


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv2d_f32_launch.argtypes = [vp, vp, vp, vp] + [i32] * 13 + [vp]
    lib.conv2d_bf16_launch.argtypes = [vp, vp, vp, vp] + [i32] * 16 + [vp]
    lib.conv2d_instances.argtypes = [ctypes.POINTER(i32), i32]
    lib.conv2d_attr_calls.argtypes = []
    for fn in ("conv2d_f32_launch", "conv2d_bf16_launch", "conv2d_instances",
               "conv2d_attr_calls"):
        getattr(lib, fn).restype = i32


LIB = CudaLibrary("conv2d", _declare)


def conv_out_size(H: int, KH: int, stride: int, pad: int) -> int:
    return (H + 2 * pad - KH) // stride + 1


def f32_row_width(OW: int) -> int:
    """OWq: the positions an output row takes in the f32 kernel's layout,
    OW rounded up to a multiple of 4 (csrc/conv2d.cu::f32_row_width)."""
    return -(-OW // 4) * 4


@lru_cache(maxsize=None)
def f32_bm(positions: int) -> int:
    """BM, the position tile of a row block of ``positions`` (boh * OWq):
    the value of F32_BM whose tiles mask the fewest positions, the larger on
    a tie."""
    return min(F32_BM, key=lambda bm: (-positions % bm, -bm))


def f32_window(bm: int, boh: int, OWq: int, KW: int) -> int:
    """Window entries a position tile stages per step
    (csrc/conv2d.cu::f32_window): its BM positions and KW - 1 more for each
    output row they can span (at most boh)."""
    return bm + min((bm + OWq - 2) // OWq + 1, boh) * (KW - 1)


class F32Plan(NamedTuple):
    """The f32 kernel's launch (module docstring)."""
    bm: int           # positions per tile
    bn: int           # channels per tile (bco)
    row_width: int    # OWq
    tiles: int        # position tiles per row block
    row_blocks: int   # per image
    window: int       # window entries per stage
    stage_bytes: int  # window [window, bci + 4] + weights [KW, bci, bn], f32
    stages: int       # the cp.async ring's depth
    blocks: int       # the grid
    busy: int         # blocks holding a position below OH (the others return)
    threads: int      # per block: bm * bn / (8 * tn)
    tn: int           # the thread tile is 8 x tn


@lru_cache(maxsize=65536)
def f32_plan(N: int, OH: int, OW: int, CO: int, KW: int, boh: int, bco: int,
             bci: int) -> F32Plan:
    """The f32 kernel's launch plan for output [N, OH, OW, CO], KW taps and
    the configuration (boh, bco, bci): what :func:`conv2d` launches and
    csrc/conv2d.cu computes again from the same arguments."""
    OWq = f32_row_width(OW)
    bm, bn = f32_bm(boh * OWq), bco
    tiles = -(-boh * OWq // bm)
    row_blocks = -(-OH // boh)
    window = f32_window(bm, boh, OWq, KW)
    stage_bytes = 4 * (window * (bci + F32_ROW_PAD) + KW * bci * bn)
    last = (OH - (row_blocks - 1) * boh) * OWq  # live positions, last block
    busy_tiles = (row_blocks - 1) * tiles + -(-last // bm)
    tn = f32_thread_tile(bm, bn)
    co_tiles = -(-CO // bn)
    return F32Plan(bm, bn, OWq, tiles, row_blocks, window, stage_bytes,
                   ring_stages(stage_bytes), N * row_blocks * tiles * co_tiles,
                   N * busy_tiles * co_tiles, bm * bn // (8 * tn), tn)


def bf16_conv_buffer_bytes(boh: int, bco: int, bci: int, OW: int,
                           KW: int) -> int:
    """Shared memory of one buffer of the bf16 kernel: the window [boh,
    OW + KW - 1, bci + 8] and the weight slices [KW, bci, bco + 8], rows
    padded by 16 bytes."""
    return 2 * (boh * (OW + KW - 1) * (bci + BF16_ROW_PAD)
                + KW * bci * (bco + BF16_ROW_PAD))


@lru_cache(maxsize=None)
def bf16_conv_buffers(boh: int, bco: int, bci: int, OW: int, KW: int) -> int:
    """The bf16 kernel's ring depth: three buffers where they fit 227 KB,
    else as many as fit (the lattice needs two)."""
    return min(BF16_MAX_BUFFERS,
               MAX_SMEM_BYTES // bf16_conv_buffer_bytes(boh, bco, bci, OW, KW))


@lru_cache(maxsize=None)
def warp_tile(positions: int, bco: int) -> Optional[Tuple[int, int, int, int]]:
    """(MT, NT, WR, WC) for the bf16 kernel: a WR x WC grid of warps, each
    MT x NT mma tiles (16 positions x 8 channels), covering ``positions`` x
    ``bco`` with at most BF16_MAX_WARPS warps; the fewest padded positions,
    then the most warps, then the largest warp tile. None if none fits."""
    m16, n8 = -(-positions // 16), bco // 8
    best = None
    for mt in BF16_MT:
        for nt in BF16_NT:
            if n8 % nt:
                continue
            wr, wc = -(-m16 // mt), n8 // nt
            if wr * wc > BF16_MAX_WARPS:
                continue
            key = (-(wr * mt - m16), wr * wc, mt * nt)
            if best is None or key > best[0]:
                best = (key, (mt, nt, wr, wc))
    return None if best is None else best[1]


def _bf16_why(OH, OW, CO, CI, KW, boh, bco, bci) -> Optional[str]:
    if boh > OH:
        return f"boh={boh} out of range (dim {OH})"
    if bco % 16 or bco > 256:
        return (f"bco={bco} not a multiple of 16 up to 256 (pairs of 8-channel "
                f"mma tiles)")
    if bci not in BF16_BCI:
        return f"bci={bci} not in {BF16_BCI} (k steps of 16)"
    if warp_tile(boh * OW, bco) is None:
        return (f"warps: no grid of <= {BF16_MAX_WARPS} warps of at most "
                f"{BF16_MT[-1]} x {BF16_NT[-1]} mma tiles covers "
                f"{boh * OW} x {bco} outputs")
    if bf16_conv_buffers(boh, bco, bci, OW, KW) < 2:
        smem = 2 * bf16_conv_buffer_bytes(boh, bco, bci, OW, KW)
        return f"shared memory {smem} B (two buffers) exceeds {MAX_SMEM_BYTES}"
    return None


def _f32_why(N, OH, OW, CO, KW, boh, bco, bci) -> Optional[str]:
    if boh > OH:
        return f"boh={boh} out of range (dim {OH})"
    if bco not in F32_BN:
        return f"bco={bco} not in {F32_BN}: the library's f32 channel tiles"
    if bci not in F32_BCI:
        return (f"bci={bci} not in {F32_BCI}: a power of two of 16-byte "
                f"chunks per window row")
    plan = f32_plan(N, OH, OW, CO, KW, boh, bco, bci)
    smem = plan.stages * plan.stage_bytes
    if smem > MAX_SMEM_BYTES:
        return f"shared memory {smem} B (two stages) exceeds {MAX_SMEM_BYTES}"
    return None


@lru_cache(maxsize=65536)
def conv_config_is_valid(N: int, H: int, W: int, CO: int, CI: int,
                         KH: int, KW: int, stride: int, pad: int,
                         boh: int, bco: int, bci: int,
                         dtype="bfloat16") -> Tuple[bool, Optional[str]]:
    """(ok, the reason it is refused) on the lattice of the kernel
    ``dtype`` takes (module docstring)."""
    if stride != 1:
        return False, f"stride {stride} unsupported (stride-1 kernel)"
    OH = conv_out_size(H, KH, stride, pad)
    OW = conv_out_size(W, KW, stride, pad)
    if OH < 1 or OW < 1:
        return False, "degenerate output"
    for v, nm in ((boh, "boh"), (bco, "bco"), (bci, "bci")):
        if v < 1:
            return False, f"{nm}={v} out of range"
    if dtype_name(dtype) == "bfloat16":
        why = _bf16_why(OH, OW, CO, CI, KW, boh, bco, bci)
    else:
        why = _f32_why(N, OH, OW, CO, KW, boh, bco, bci)
    return why is None, why


def snap_conv_config_to_hw(N: int, H: int, W: int, CO: int, CI: int,
                           KH: int, KW: int, stride: int, pad: int,
                           boh: int, bco: int, bci: int,
                           dtype="bfloat16") -> Tuple[int, int, int]:
    """Snap a raw (boh, bco, bci) onto the kernel's lattice (module
    docstring). The result is valid unless the stride is not 1 or not even
    the smallest tile fits shared memory."""
    params = (N, H, W, CO, CI, KH, KW, stride, pad)
    OH = conv_out_size(H, KH, stride, pad)
    OW = conv_out_size(W, KW, stride, pad)
    if OH < 1 or OW < 1:
        return boh, bco, bci
    boh = min(max(boh, 1), OH)
    if dtype_name(dtype) == "bfloat16":
        bco, bci = up_to(bco, CO, BF16_BCO), up_to(bci, CI, BF16_BCI)
        while True:
            ok, why = conv_config_is_valid(*params, boh, bco, bci, dtype)
            if ok or why.startswith("stride"):
                return boh, bco, bci
            if why.startswith("shared") and bci > BF16_BCI[0]:
                bci = BF16_BCI[BF16_BCI.index(bci) - 1]
            elif (boh * OW >= bco or bco == BF16_BCO[0]) and boh > 1:
                boh -= 1
            elif bco > BF16_BCO[0]:
                bco -= 16
            else:
                return boh, bco, bci
    bco, bci = up_to(bco, CO, F32_BN), up_to(bci, CI, F32_BCI)
    while not conv_config_is_valid(*params, boh, bco, bci, dtype)[0]:
        if bci > F32_BCI[0]:
            bci = F32_BCI[F32_BCI.index(bci) - 1]
        elif bco > F32_BN[0]:
            bco = F32_BN[F32_BN.index(bco) - 1]
        elif boh > 1:
            boh = (boh + 1) // 2
        else:
            break
    return boh, bco, bci


def predicted_conv_seconds(N: int, H: int, W: int, CO: int, CI: int,
                           KH: int, KW: int, stride: int, pad: int,
                           boh: int, bco: int, bci: int,
                           dtype="bfloat16") -> float:
    """Coarse roofline + per-step estimate on an H100 (configuration
    rejection and the CPU stand-in timer only; the point is to measure).

    bf16: waves of one block per SM, each block's mma work (positions padded
    to the warp grid, channels to bco, CI to bci) at the SM's share of
    MMA_SYNC_SHARE of the tensor-core peak, plus a microsecond per (kh,
    ci-block) step; or the staged traffic over HBM; plus a launch. f32: the
    f32 matmul's wave model (``ops/matmul.py::predicted_seconds``) on the
    launch plan: waves of one block per SM over the blocks holding live
    positions, each block's [BM, BN] tile over K = KH x KW x CI padded to bci
    at the SM's share of the CUDA-core peak (F32_NARROW_SHARE of it for an
    8 x 4 thread tile); or the staged traffic over HBM; plus a launch."""
    name = dtype_name(dtype)
    OH = conv_out_size(H, KH, stride, pad)
    OW = conv_out_size(W, KW, stride, pad)
    if name == "bfloat16":
        blocks = N * math.ceil(OH / boh) * math.ceil(CO / bco)
        steps = KH * math.ceil(CI / bci)
        mt, _, wr, _ = warp_tile(boh * OW, bco) or (1, 2, 64, 1)
        block_s = (2.0 * wr * mt * 16 * bco * KW * bci * steps
                   / (MMA_SYNC_SHARE * PEAK_FLOPS[name] / NUM_SMS)
                   + steps * STEP_S)
        bytes_moved = (blocks * steps * bf16_conv_buffer_bytes(
            boh, bco, bci, OW, KW) + N * OH * OW * CO * 4)
        return max(math.ceil(blocks / NUM_SMS) * block_s,
                   bytes_moved / HBM_BYTES_S) + LAUNCH_S
    plan = f32_plan(N, OH, OW, CO, KW, boh, bco, bci)
    steps = KH * math.ceil(CI / bci)
    eff = 1.0 if plan.tn == 8 else F32_NARROW_SHARE
    block_s = (2.0 * plan.bm * plan.bn * KW * bci * steps
               / (PEAK_FLOPS[name] / NUM_SMS) / eff)
    bytes_moved = (plan.busy * steps * plan.stage_bytes
                   + N * OH * OW * CO * 4)
    return max(math.ceil(plan.busy / NUM_SMS) * block_s,
               bytes_moved / HBM_BYTES_S) + LAUNCH_S


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 pad: int) -> torch.Tensor:
    """relu(conv2d(x, w) + bias) [N, OH, OW, CO] in float32, stride 1,
    through ``F.conv2d`` on NCHW/OIHW-permuted tensors. On the card TF32 is
    switched off for it (cuDNN's default for float32 convolutions is TF32)."""
    xn = x.float().permute(0, 3, 1, 2)
    wn = w.float().permute(3, 2, 0, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xn, wn, padding=pad)
    y = torch.relu(y + bias.float()[None, :, None, None])
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, pad: int,
           boh: int, bco: int, bci: int) -> torch.Tensor:
    """relu(conv2d(x, w) + bias) [N, OH, OW, CO] float32 at block
    configuration (boh, bco, bci), stride 1. On CUDA tensors this launches
    the kernel on the current stream (``conv2d.launches`` counts the
    launches) after checking the configuration with
    :func:`conv_config_is_valid`; ``bias`` is taken as float32. On CPU
    tensors it runs :func:`conv2d_plain`, whatever the configuration."""
    if x.device.type == "cpu":
        return conv2d_plain(x, w, bias, pad)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    N, H, W, CI = x.shape
    KH, KW, _, CO = w.shape
    name = dtype_name(x.dtype)
    if name not in DTYPES or w.dtype != x.dtype or w.device != x.device:
        raise ValueError("x and w must be float32 or bfloat16 tensors of one "
                         "dtype on one device")
    if bias.shape != (CO,) or bias.device != x.device:
        raise ValueError(f"bias must be a [{CO}] tensor on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    ok, why = conv_config_is_valid(N, H, W, CO, CI, KH, KW, 1, pad, boh, bco,
                                   bci, name)
    if not ok:
        raise ValueError(f"invalid conv2d config ({boh}, {bco}, {bci}): {why}")
    OH, OW = conv_out_size(H, KH, 1, pad), conv_out_size(W, KW, 1, pad)
    b32 = bias.float().contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "float32":
        # 16-byte copies: CI and CO up to multiples of 4, zero-padded
        x, w = staged(x, w, F32_ALIGN)
        CI, COp = w.shape[2], w.shape[3]
        if COp != CO:
            b32 = F.pad(b32, (0, COp - CO))
    else:
        COp = CO
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned (cp.async)")
    out = torch.empty(N, OH, OW, COp, dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), b32.data_ptr(), out.data_ptr(), N, H,
            W, CI, COp, KH, KW, pad, boh, bco, bci)
    if name == "bfloat16":
        err = LIB.load().conv2d_bf16_launch(
            *args, *warp_tile(boh * OW, bco),
            bf16_conv_buffers(boh, bco, bci, OW, KW), stream)
    else:
        plan = f32_plan(N, OH, OW, COp, KW, boh, bco, bci)
        err = LIB.load().conv2d_f32_launch(*args, plan.bm, plan.stages,
                                           stream)
    check_launch(err, "conv2d")
    conv2d.launches += 1
    return out if COp == CO else out[..., :CO].contiguous()


conv2d.launches = 0
