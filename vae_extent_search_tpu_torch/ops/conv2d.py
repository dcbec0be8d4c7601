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
no padded copy of x is made. The lattice is the kernel's own, as for the
matmul (``ops/matmul.py``), with the [boh * OW, bco] output tile in the
place of [bm, bn] and bci in the place of bk:

- ``conv_config_is_valid``: stride 1; exact tiling; a thread micro-tile
  leaving at most 256 threads (so boh * OW * bco <= 16,384: the TPU's
  boh = 8 x OW = 56 x bco = 128 does not fit); the window and weight slices
  within 227 KB of shared memory.
- ``snap_conv_config_to_hw``: bco moves up to a multiple of 32 and bci to
  a multiple of 8 (or the whole axis), then the configuration shrinks
  (bci first for shared memory, the larger of boh * OW and bco for
  threads) until it fits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import MAX_SMEM_BYTES, CudaLibrary, check_launch
from .matmul import (
    DTYPES,
    HBM_BYTES_S,
    K_ALIGN,
    NUM_SMS,
    PEAK_FLOPS,
    STEP_S,
    WARP,
    dtype_name,
    itemsize,
    shrink,
    snap_up,
    thread_tile,
)


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv2d_launch.argtypes = [vp, vp, vp, vp] + [i32] * 14 + [vp]
    lib.conv2d_launch.restype = i32


LIB = CudaLibrary("conv2d", _declare)


def conv_out_size(H: int, KH: int, stride: int, pad: int) -> int:
    return (H + 2 * pad - KH) // stride + 1


def conv_smem_bytes(boh: int, bco: int, bci: int, OW: int, KW: int,
                    itemsize: int) -> int:
    """Shared memory of one block: the input window [boh, OW + KW - 1,
    bci] and the weight slices [KW, bci, bco] in the input type."""
    return (boh * (OW + KW - 1) * bci + KW * bci * bco) * itemsize


def conv_config_is_valid(N: int, H: int, W: int, CO: int, CI: int,
                         KH: int, KW: int, stride: int, pad: int,
                         boh: int, bco: int, bci: int,
                         dtype="bfloat16") -> Tuple[bool, Optional[str]]:
    if stride != 1:
        return False, f"stride {stride} unsupported (stride-1 kernel)"
    OH = conv_out_size(H, KH, stride, pad)
    OW = conv_out_size(W, KW, stride, pad)
    if OH < 1 or OW < 1:
        return False, "degenerate output"
    for v, d, nm in ((boh, OH, "boh"), (bco, CO, "bco"), (bci, CI, "bci")):
        if v < 1 or v > d:
            return False, f"{nm}={v} out of range (dim {d})"
        if d % v:
            return False, f"{nm}={v} does not divide {d}"
    if thread_tile(boh * OW, bco) is None:
        return False, (f"threads: a {boh * OW} x {bco} tile needs more than "
                       f"256 threads of at most 8 x 8 outputs")
    smem = conv_smem_bytes(boh, bco, bci, OW, KW, itemsize(dtype))
    if smem > MAX_SMEM_BYTES:
        return False, f"shared memory {smem} B exceeds {MAX_SMEM_BYTES}"
    return True, None


def snap_conv_config_to_hw(N: int, H: int, W: int, CO: int, CI: int,
                           KH: int, KW: int, stride: int, pad: int,
                           boh: int, bco: int, bci: int,
                           dtype="bfloat16") -> Tuple[int, int, int]:
    """Snap a raw (boh, bco, bci) onto the kernel's lattice (module
    docstring). The result is valid unless an axis has no divisor on the
    lattice that fits (or the stride is not 1), and then it holds that
    axis whole."""
    params = (N, H, W, CO, CI, KH, KW, stride, pad)
    OH = conv_out_size(H, KH, stride, pad)
    OW = conv_out_size(W, KW, stride, pad)
    if OH < 1 or OW < 1:
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
    rejection and the CPU stand-in timer only; the point is to measure)."""
    size = itemsize(dtype)
    OH = conv_out_size(H, KH, stride, pad)
    OW = conv_out_size(W, KW, stride, pad)
    blocks = N * (OH // boh) * (CO // bco)
    steps = KH * (CI // bci)
    flops_t = 2.0 * N * OH * OW * CO * KH * KW * CI / PEAK_FLOPS[
        dtype_name(dtype)]
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
    tm, tn = thread_tile(boh * OW, bco)
    b32 = bias.float().contiguous()
    out = torch.empty(N, OH, OW, CO, dtype=torch.float32, device=x.device)
    err = LIB.load().conv2d_launch(
        x.data_ptr(), w.data_ptr(), b32.data_ptr(), out.data_ptr(), N, H, W,
        CI, CO, KH, KW, pad, boh, bco, bci, tm, tn, DTYPES[name][1],
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
