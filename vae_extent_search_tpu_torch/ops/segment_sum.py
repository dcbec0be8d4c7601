"""Ragged per-segment row sum with a gradient (counterpart of
``vae_extent_search_tpu/ops/segment_sum_pallas.py``).

Every per-store cost model sums each program's store rows::

    out[s, :] = sum of feat[r, :] over rows r of segment s,   s < n_seg

The rows of one segment are adjacent (the loaders flatten program by
program), so a segment is the row range ``[offsets[s], offsets[s + 1])``;
rows outside ``[offsets[0], offsets[n_seg])`` are batch padding (segment id
``n_seg`` in the id layout) and add nothing.

:func:`segment_sum` launches the hand-written CUDA kernels of
``csrc/segment_sum.cu``, forward and backward, when its input lies on a
CUDA device, and runs the plain versions (:func:`segment_sum_plain`, one
``index_add_``; :func:`segment_sum_grad_plain`, one row gather) when it lies
on the CPU. There is no fallback between the two: a CUDA tensor launches
the kernel or raises. The sum is taken in float32 in row order without
atomics, so two launches give the same bits; features stored in bfloat16
are upcast as they are read.

Unlike the TPU kernel there is no limit on a segment's length and nothing
is padded (``pad_for_pallas`` has no counterpart).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .build import CudaLibrary, check_launch


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_sum_fwd_launch.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    lib.segment_sum_fwd_launch.restype = i32
    lib.segment_sum_bwd_launch.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
    lib.segment_sum_bwd_launch.restype = i32


LIB = CudaLibrary("segment_sum", _declare)


def segment_ids_to_offsets(segment_ids: np.ndarray, n_seg: int) -> np.ndarray:
    """Contiguous segment ids -> offsets [n_seg+1] int32 on the host
    (padding rows carry id >= n_seg and are excluded)."""
    counts = np.bincount(np.asarray(segment_ids), minlength=n_seg + 1)[:n_seg]
    offs = np.zeros(n_seg + 1, np.int32)
    np.cumsum(counts, out=offs[1:])
    return offs


def check_contiguous(segment_ids: np.ndarray, n_seg: int) -> None:
    """Raise unless the ids (host array) are what the kernel takes: the
    rows of segment 0, then of segment 1, ..., then the padding rows with
    id >= n_seg. Called where a batch is built, never per launch."""
    ids = np.minimum(np.asarray(segment_ids), n_seg)
    if ids.size and (ids.min() < 0 or np.any(np.diff(ids) < 0)):
        raise ValueError("segment ids must be non-negative and "
                         "non-decreasing, with padding rows (id >= n_seg) last")


def offsets_to_segment_ids(offsets: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The id layout of ``offsets`` [n_seg+1]: [n_rows] int64 with id
    ``n_seg`` for the rows outside every segment."""
    n_seg = offsets.shape[0] - 1
    r = torch.arange(n_rows, device=offsets.device)
    offs = offsets.long()
    ids = torch.searchsorted(offs[1:].contiguous(), r, right=True)
    return torch.where(r < offs[0], n_seg, ids)


def ids_to_offsets_device(segment_ids: torch.Tensor, n_seg: int
                          ) -> torch.Tensor:
    """Offsets [n_seg+1] int32 of non-decreasing ids, on the ids' device
    and without a device-to-host copy."""
    want = torch.arange(n_seg + 1, device=segment_ids.device,
                        dtype=segment_ids.dtype)
    return torch.searchsorted(segment_ids.contiguous(), want).int()


def segment_sum_plain(feat: torch.Tensor, segment_ids: torch.Tensor,
                      n_seg: int) -> torch.Tensor:
    """[n_seg, H]: one ``index_add_`` into n_seg + 1 buckets, the last
    (padding, id >= n_seg) dropped. float32, or float64 for float64 input."""
    dtype = torch.float64 if feat.dtype == torch.float64 else torch.float32
    ids = torch.clamp(segment_ids.long(), max=n_seg)
    out = torch.zeros(n_seg + 1, feat.shape[1], dtype=dtype,
                      device=feat.device)
    return out.index_add_(0, ids, feat.to(dtype))[:n_seg]


def segment_sum_grad_plain(grad_out: torch.Tensor, segment_ids: torch.Tensor,
                           n_seg: int) -> torch.Tensor:
    """[R, H]: every row takes its segment's row of ``grad_out``
    [n_seg, H], padding rows (id >= n_seg) zeros."""
    ids = torch.clamp(segment_ids.long(), max=n_seg)
    padded = torch.cat([grad_out, grad_out.new_zeros(1, grad_out.shape[1])])
    return padded[ids]


def _check(feat, offsets):
    if feat.dim() != 2 or feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("features must be a [R, H] float32 or bfloat16 "
                         f"tensor, got {tuple(feat.shape)} {feat.dtype}")
    if (offsets.dim() != 1 or offsets.dtype != torch.int32
            or offsets.shape[0] < 1 or offsets.device != feat.device):
        raise ValueError("offsets must be a [n_seg+1] int32 tensor on "
                         f"{feat.device}")
    if not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous")


def _forward_cuda(feat, offsets):
    _check(feat, offsets)
    feat = feat.contiguous()
    n_seg, H = offsets.shape[0] - 1, feat.shape[1]
    out = torch.empty(n_seg, H, dtype=torch.float32, device=feat.device)
    if n_seg == 0 or H == 0:
        return out
    err = LIB.load().segment_sum_fwd_launch(
        feat.data_ptr(), offsets.data_ptr(), out.data_ptr(), H, n_seg,
        int(feat.dtype == torch.bfloat16),
        torch.cuda.current_stream(feat.device).cuda_stream)
    check_launch(err, "segment_sum forward")
    segment_sum.launches += 1
    return out


def _backward_cuda(grad_out, offsets, n_rows, dtype):
    n_seg = offsets.shape[0] - 1
    if (grad_out.dtype != torch.float32 or grad_out.dim() != 2
            or grad_out.shape[0] != n_seg or grad_out.device != offsets.device):
        raise ValueError(f"grad_out must be a [{n_seg}, H] float32 tensor on "
                         f"{offsets.device}")
    grad_out = grad_out.contiguous()
    H = grad_out.shape[1]
    grad = torch.empty(n_rows, H, dtype=dtype, device=grad_out.device)
    if n_rows == 0 or H == 0:
        return grad
    err = LIB.load().segment_sum_bwd_launch(
        grad_out.data_ptr(), offsets.data_ptr(), grad.data_ptr(), n_rows, H,
        n_seg, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(grad_out.device).cuda_stream)
    check_launch(err, "segment_sum backward")
    segment_sum.backward_launches += 1
    return grad


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, offsets):
        ctx.save_for_backward(offsets)
        ctx.n_rows, ctx.dtype = feat.shape[0], feat.dtype
        if feat.device.type == "cuda":
            return _forward_cuda(feat, offsets)
        n_seg = offsets.shape[0] - 1
        ids = offsets_to_segment_ids(offsets, feat.shape[0])
        return segment_sum_plain(feat, ids, n_seg)

    @staticmethod
    def backward(ctx, grad_out):
        (offsets,) = ctx.saved_tensors
        if grad_out.device.type == "cuda":
            return _backward_cuda(grad_out, offsets, ctx.n_rows,
                                  ctx.dtype), None
        n_seg = offsets.shape[0] - 1
        ids = offsets_to_segment_ids(offsets, ctx.n_rows)
        return segment_sum_grad_plain(grad_out, ids, n_seg).to(ctx.dtype), None


def segment_sum(feat: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[n_seg, H] float32 sums of ``feat`` [R, H] (float32 or bfloat16;
    float64 too on the CPU) over the row ranges of ``offsets`` [n_seg+1]
    int32, which lies on feat's device, is non-decreasing and stays within
    [0, R] (not checked per call: that would wait for the device).
    Differentiable in ``feat``.

    On a CUDA tensor the forward and the backward each launch their kernel
    on the current stream; ``segment_sum.launches`` and
    ``segment_sum.backward_launches`` count those launches. On a CPU tensor
    the plain versions run."""
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feat.device}")
    return _SegmentSum.apply(feat, offsets)


segment_sum.launches = 0
segment_sum.backward_launches = 0


def segment_sum_rows(h: torch.Tensor, segment_ids: torch.Tensor, n_seg: int,
                     offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum rows of h [R, H] into n_seg buckets (id == n_seg drops), under
    the JAX package's name. ``offsets`` [n_seg+1] int32 are the segments'
    row ranges as the batch loaders carry them; without them they are
    found from ``segment_ids`` on the device, which must then be
    non-decreasing (the loaders' layout)."""
    if offsets is None:
        offsets = ids_to_offsets_device(segment_ids, n_seg)
    elif offsets.shape[0] != n_seg + 1:
        raise ValueError(f"offsets must have {n_seg + 1} entries, got "
                         f"{offsets.shape[0]}")
    return segment_sum(h, offsets)
