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

The configuration is the kernel's real tiling: a block computes boh output
rows x all OW columns x bco channels and loops over (kh, ci-block of bci),
staging the input window [boh, OW + KW - 1, bci] and the weight slices
[KW, bci, bco] in shared memory. Zero padding is masked inside the kernel;
no padded copy of x is made. The dtype chooses the kernel and its lattice:

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
- **float32, CUDA cores**: exact tiling; a thread micro-tile leaving at
  most 256 threads (so boh * OW * bco <= 16,384: the TPU's boh = 8 x OW =
  56 x bco = 128 does not fit); the window and weight slices within 227
  KB. The snap moves bco up to a multiple of 32 and bci to a multiple of 8
  (or the whole axis), then shrinks (bci first for shared memory, the
  larger of boh * OW and bco for threads) until it fits.

Both kernels take stride 1 only. The validity result and the launch plan
are cached per shape and configuration.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import MAX_SMEM_BYTES, CudaLibrary, check_launch
from .matmul import (
    DTYPES,
    HBM_BYTES_S,
    K_ALIGN,
    LAUNCH_S,
    NUM_SMS,
    PEAK_FLOPS,
    STEP_S,
    WARP,
    dtype_name,
    itemsize,
    shrink,
    snap_up,
    thread_tile,
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


def conv_smem_bytes(boh: int, bco: int, bci: int, OW: int, KW: int,
                    itemsize: int) -> int:
    """Shared memory of one float32 block: the input window [boh, OW + KW -
    1, bci] and the weight slices [KW, bci, bco] in the input type."""
    return (boh * (OW + KW - 1) * bci + KW * bci * bco) * itemsize


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


def _f32_why(OH, OW, CO, CI, KW, boh, bco, bci) -> Optional[str]:
    for v, d, nm in ((boh, OH, "boh"), (bco, CO, "bco"), (bci, CI, "bci")):
        if v > d:
            return f"{nm}={v} out of range (dim {d})"
        if d % v:
            return f"{nm}={v} does not divide {d}"
    if thread_tile(boh * OW, bco) is None:
        return (f"threads: a {boh * OW} x {bco} tile needs more than "
                f"256 threads of at most 8 x 8 outputs")
    smem = conv_smem_bytes(boh, bco, bci, OW, KW, 4)
    if smem > MAX_SMEM_BYTES:
        return f"shared memory {smem} B exceeds {MAX_SMEM_BYTES}"
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
    why = (_bf16_why if dtype_name(dtype) == "bfloat16" else _f32_why)(
        OH, OW, CO, CI, KW, boh, bco, bci)
    return why is None, why


def snap_conv_config_to_hw(N: int, H: int, W: int, CO: int, CI: int,
                           KH: int, KW: int, stride: int, pad: int,
                           boh: int, bco: int, bci: int,
                           dtype="bfloat16") -> Tuple[int, int, int]:
    """Snap a raw (boh, bco, bci) onto the kernel's lattice (module
    docstring). The result is valid unless the stride is not 1 or (f32) an
    axis has no divisor on the lattice that fits, and then it holds that
    axis whole."""
    params = (N, H, W, CO, CI, KH, KW, stride, pad)
    OH = conv_out_size(H, KH, stride, pad)
    OW = conv_out_size(W, KW, stride, pad)
    if OH < 1 or OW < 1:
        return boh, bco, bci
    if dtype_name(dtype) == "bfloat16":
        boh = min(max(boh, 1), OH)
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
    boh = snap_up(max(boh, 1), OH, 1)
    bco = snap_up(bco, CO, WARP)
    bci = snap_up(bci, CI, K_ALIGN)
    while True:
        ok, why = conv_config_is_valid(*params, boh, bco, bci, dtype)
        if ok or why.startswith("stride"):
            return boh, bco, bci
        if why.startswith("shared"):
            nci = shrink(bci, CI, K_ALIGN)
            if nci != bci:
                bci = nci
                continue
        big_oh = boh * OW >= bco
        noh, nco = shrink(boh, OH, 1), shrink(bco, CO, WARP)
        if big_oh and noh != boh:
            boh = noh
        elif nco != bco:
            bco = nco
        elif noh != boh:
            boh = noh
        else:
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
    larger of the operations at the CUDA-core peak, the traffic and a
    microsecond per step of each block."""
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
    size = itemsize(dtype)
    blocks = N * (OH // boh) * (CO // bco)
    steps = KH * (CI // bci)
    flops_t = 2.0 * N * OH * OW * CO * KH * KW * CI / PEAK_FLOPS[name]
    bytes_moved = (blocks * steps * conv_smem_bytes(boh, bco, bci, OW, KW,
                                                    size)
                   + N * OH * OW * CO * 4)
    return max(flops_t, bytes_moved / HBM_BYTES_S,
               blocks * steps * STEP_S / NUM_SMS)


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
    out = torch.empty(N, OH, OW, CO, dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), b32.data_ptr(), out.data_ptr(), N, H,
            W, CI, CO, KH, KW, pad, boh, bco, bci)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "bfloat16":
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("x and w must be 16-byte aligned (cp.async)")
        err = LIB.load().conv2d_bf16_launch(
            *args, *warp_tile(boh * OW, bco),
            bf16_conv_buffers(boh, bco, bci, OW, KW), stream)
    else:
        err = LIB.load().conv2d_f32_launch(*args, *thread_tile(boh * OW, bco),
                                           stream)
    check_launch(err, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
