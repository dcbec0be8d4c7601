"""Gradient/hessian bin histograms for level-wise GBDT growth (counterpart
of ``vae_extent_search_tpu/ops/hist_pallas.py``).

For every feature f, tree node c and bin b::

    ghist[f, c, b] = sum of grad[r] over rows r with node[r] == c and
                     bins[f, r] == b          (hhist: the same for hess)

:func:`hist` computes both with one launch of the hand-written CUDA kernel
``csrc/hist.cu`` when its inputs lie on a CUDA device, and through
:func:`hist_plain`, one ``index_add_`` per output in plain torch, when they
lie on the CPU. There is no fallback between the two: a CUDA tensor
launches the kernel or raises.

The kernel sums in fixed point (int64, one power-of-two scale per input
chosen from its largest magnitude and n), so its result is bit-identical
from run to run and within ~2^-42 of max |v| per row of the exact sum
before the final rounding to float32; see the note at the top of the
source. Rows with grad = hess = 0 add nothing, so zero-weight padding is
inert.

Layouts are the port's own: ``bins`` is ``DMatrix._binned`` as it is,
[d, n] uint8 and feature-major, so nothing like the TPU kernel's
``pack_bins_host`` is needed. The TPU-only tier and kron options have no
counterpart: the kernel takes every bin count up to 256 in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import MAX_SMEM_BYTES, CudaLibrary, check_launch

# shared memory a block takes when several features share it; one feature
# may take up to MAX_SMEM_BYTES on its own
_GROUP_SMEM_BYTES = 96 * 1024
_MIN_ROWS_PER_BLOCK = 8192


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hist_launch.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, i64,
                                vp, vp, vp, vp, vp]
    lib.hist_launch.restype = i32


LIB = CudaLibrary("hist", _declare)


def hist_plain(bins: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
               hess: torch.Tensor, m: int, nb: int):
    """(ghist, hhist), each [d, m, nb] in grad's dtype: one ``index_add_``
    over the flat key ``(f * m + node) * nb + bin`` per output. As in the
    kernel, a row whose node lies outside [0, m) adds nothing, nor does a
    (feature, row) whose bin is >= nb."""
    d, n = bins.shape
    keep = (bins.int() < nb) & ((node >= 0) & (node < m))[None, :]  # [d, n]
    key = torch.where(keep, hist_keys(bins, node, m, nb).view(d, n), 0)
    key = key.reshape(-1)
    g = grad.new_zeros(d * m * nb).index_add_(
        0, key, torch.where(keep, grad, 0).reshape(-1))
    h = hess.new_zeros(d * m * nb).index_add_(
        0, key, torch.where(keep, hess, 0).reshape(-1))
    return g.view(d, m, nb), h.view(d, m, nb)


def hist_keys(bins: torch.Tensor, node: torch.Tensor, m: int, nb: int):
    """The flat histogram cell of every (feature, row): [d * n] int64."""
    d = bins.shape[0]
    f = torch.arange(d, device=bins.device)[:, None]
    return ((f * m + node.long()[None, :]) * nb + bins.long()).reshape(-1)


def launch_plan(d: int, n: int, m: int, nb: int):
    """(features per block, rows per block): as many features as fit in
    ``_GROUP_SMEM_BYTES`` share a block and read node/grad/hess once for
    all of them; a block covers at least 4 * m * nb rows so that adding its
    histogram to the device-wide sum costs well under its own scatter.
    Raises when one feature's histogram does not fit in shared memory."""
    per_feature = 2 * m * nb * 8
    if per_feature > MAX_SMEM_BYTES:
        raise ValueError(f"m={m} x nb={nb} needs {per_feature} bytes of "
                         f"shared memory per feature (> {MAX_SMEM_BYTES})")
    F = max(1, min(d, _GROUP_SMEM_BYTES // per_feature))
    rows = max(_MIN_ROWS_PER_BLOCK, 4 * m * nb)
    return F, min(rows, max(n, 1))


def hist(bins: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
         hess: torch.Tensor, m: int, nb: int):
    """(ghist, hhist), each [d, m, nb] float32.

    ``bins`` [d, n] uint8 with values < nb <= 256; ``node`` [n] int32 in
    [0, m); ``grad``, ``hess`` [n] float32 (finite). Nodes and bins out of
    those ranges are not checked (that would wait for the device): such a
    row, or (feature, row), adds nothing, on either path. On CUDA tensors this
    launches the kernel on the current stream (``hist.launches`` counts
    those launches, and ``hist.tap``, where set, is called with each
    launch's arguments first); on CPU tensors it runs :func:`hist_plain`."""
    if bins.device.type == "cpu":
        return hist_plain(bins, node, grad, hess, m, nb)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(bins, node, grad, hess, int(m), int(nb))


hist.launches = 0
hist.tap = None


def _launch(bins, node, grad, hess, m, nb):
    dev = bins.device
    if bins.dim() != 2 or bins.dtype != torch.uint8:
        raise ValueError("bins must be a [d, n] uint8 tensor")
    d, n = bins.shape
    for name, t, dtype in (("node", node, torch.int32),
                           ("grad", grad, torch.float32),
                           ("hess", hess, torch.float32)):
        if t.dtype != dtype or t.shape != (n,) or t.device != dev:
            raise ValueError(f"{name} must be a [{n}] {dtype} tensor on {dev}")
    if not all(t.is_contiguous() for t in (bins, node, grad, hess)):
        raise ValueError("bins, node, grad and hess must be contiguous")
    if not 1 <= nb <= 256 or m < 1:
        raise ValueError(f"need 1 <= nb <= 256 and m >= 1, got nb={nb}, m={m}")
    F, rows = launch_plan(d, n, m, nb)
    ghist = torch.empty(d, m, nb, dtype=torch.float32, device=dev)
    hhist = torch.empty_like(ghist)
    if n == 0 or d == 0:
        return ghist.zero_(), hhist.zero_()
    if hist.tap is not None:
        hist.tap(bins, node, grad, hess, m, nb)
    lib = LIB.load()
    amax = torch.empty(2, dtype=torch.int32, device=dev)
    acc = torch.empty(2, d, m, nb, dtype=torch.int64, device=dev)
    err = lib.hist_launch(
        bins.data_ptr(), node.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        n, d, m, nb, F, rows, amax.data_ptr(), acc.data_ptr(),
        ghist.data_ptr(), hhist.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "hist")
    hist.launches += 1
    return ghist, hhist
