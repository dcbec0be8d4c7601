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
source. :func:`hist_plain_fixed` computes the same integers in plain torch
and equals the kernel bit for bit; :func:`hist_plain` in float64 is the
yardstick both are held to. Rows with grad = hess = 0 add nothing, so
zero-weight padding is inert.

Exact across cards: given ``exponents=(eg, eh)``, :func:`hist` (and
:func:`hist_plain_fixed`, its plain twin) returns the int64 sums at those
fixed-point exponents instead of float32. Ranks that hold parts of the
rows agree on the exponents (:func:`exponent_for` of the global max |v|
and the global row count), sum the integers across ranks and round them
with :func:`round_fixed`; the result equals one card's :func:`hist` over
all the rows bit for bit.

:func:`launch_plan` sizes the grid: the features a block holds in shared
memory and the rows it covers. The scratch a launch needs (per-block
maxima and the blocks' partial sums) is kept
per (device, stream, shape) and reused, so a repeated call allocates only
its two outputs.

Layouts are the port's own: ``bins`` is ``DMatrix._binned`` as it is,
[d, n] uint8 and feature-major, so nothing like the TPU kernel's
``pack_bins_host`` is needed. The TPU-only tier and kron options have no
counterpart: the kernel takes every bin count up to 256 in one launch.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from functools import lru_cache
from typing import Optional, Tuple

import torch

from .build import (
    MAX_SMEM_BYTES,
    SM_SMEM_BYTES,
    CudaLibrary,
    check_launch,
    sm_count,
)

# shared memory a block's histograms may take: 227 KB less 1 KB for the
# kernel's static shared variables (csrc/hist.cu::kMaxDynSmem)
HIST_SMEM_BYTES = MAX_SMEM_BYTES - 1024
# bytes of shared memory per (feature, node, bin): the int64 sums of grad
# and of hess, each as two 32-bit words
CELL_BYTES = 16
NUM_SMS = 132         # SMs of an H100 SXM; the wrapper passes the card's own
FILL = 0.9            # least share of the last wave's slots the grid fills
MIN_ROWS = 4096       # rows a block covers at least


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hist_launch.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, i64,
                                vp, vp, vp, vp, vp]
    lib.hist_launch.restype = i32
    lib.hist_launch_fixed.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                      i64, vp, i32, i32, vp, vp, vp]
    lib.hist_launch_fixed.restype = i32
    for fn in ("hist_attr_calls", "hist_bmax_words"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i32


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


def exponent_for(amax, n: int) -> int:
    """The kernel's fixed-point exponent for a largest magnitude ``amax``
    (a float32 value) over n rows: amax < 2^ex, e = 62 - ceil(log2 n) -
    ex, so that n values rounded to ``rint(v * 2^e)`` sum below 2^62 in
    magnitude; 0 when amax is 0 or not finite."""
    amax = torch.as_tensor(amax, dtype=torch.float32).cpu()
    if not (bool(amax > 0) and bool(torch.isfinite(amax))):
        return 0
    _, ex = torch.frexp(amax)
    return 62 - (max(n, 1) - 1).bit_length() - int(ex)


def fixed_exponent(v: torch.Tensor, n: int) -> int:
    """The kernel's fixed-point exponent e for ``v`` over n rows
    (:func:`exponent_for` of max |v|)."""
    amax = v.float().abs().max() if v.numel() else v.new_zeros(())
    return exponent_for(amax, n)


def round_fixed(s: torch.Tensor, e: int) -> torch.Tensor:
    """float32 of the int64 sums ``s`` at exponent e, rounded as the
    kernel rounds: float32(float64(s) * 2^-e)."""
    return (s.double() * 2.0 ** -e).float()


def hist_plain_fixed(bins: torch.Tensor, node: torch.Tensor,
                     grad: torch.Tensor, hess: torch.Tensor, m: int, nb: int,
                     exponents: Optional[Tuple[int, int]] = None):
    """(ghist, hhist), each [d, m, nb] float32, computed as the kernel
    computes them: q = rint(v * 2^e) as int64 with :func:`fixed_exponent`
    (max |v| over every row), exact integer sums by ``index_add_``, then
    ``float32(float64(sum) * 2^-e)``. Rows whose node lies outside [0, m),
    and (feature, row) pairs whose bin is >= nb, add nothing. The kernel's
    output equals this bit for bit. Features go 16 at a time to cap the
    int64 scratch. With ``exponents=(eg, eh)`` given, the int64 sums at
    those exponents, unrounded (the kernel's ``hist_launch_fixed``)."""
    d, n = bins.shape
    chunk = 16
    out = []
    for a, v in enumerate((grad, hess)):
        e = fixed_exponent(v, n) if exponents is None else int(exponents[a])
        q = torch.round(v.double() * 2.0 ** e).long()
        q = torch.where((node >= 0) & (node < m), q, 0)
        acc = torch.zeros(d, m * nb, dtype=torch.int64, device=bins.device)
        for f0 in range(0, d, chunk):
            b = bins[f0:f0 + chunk]
            keep = b.int() < nb
            f = torch.arange(b.shape[0], device=bins.device)[:, None]
            key = torch.where(keep, (f * m + node.long().clamp(0, m - 1))
                              * nb + b.long(), 0)
            val = torch.where(keep, q[None, :], 0)
            acc[f0:f0 + chunk].view(-1).index_add_(0, key.reshape(-1),
                                                   val.reshape(-1))
        acc = acc.view(d, m, nb)
        out.append(acc if exponents is not None else round_fixed(acc, e))
    return out[0], out[1]


def hist_keys(bins: torch.Tensor, node: torch.Tensor, m: int, nb: int):
    """The flat histogram cell of every (feature, row): [d * n] int64."""
    d = bins.shape[0]
    f = torch.arange(d, device=bins.device)[:, None]
    return ((f * m + node.long()[None, :]) * nb + bins.long()).reshape(-1)


def feature_smem_bytes(m: int, nb: int) -> int:
    """Shared memory of one feature's histograms in a block: ``CELL_BYTES``
    per (node, bin), each node's bins padded to an odd count (nb | 1) so
    that one bin of different nodes falls in different banks."""
    return CELL_BYTES * m * (nb | 1)


@lru_cache(maxsize=4096)
def launch_plan(d: int, n: int, m: int, nb: int, sms: int = NUM_SMS,
                features: Optional[int] = None,
                chunks: Optional[int] = None):
    """(features per block F, rows per block). F: as many features as fit
    in shared memory (:func:`feature_smem_bytes`), then evened out
    over the ceil(d / F) feature groups, so that a block reads node, grad
    and hess once for as many features as it can. Rows: n split into as
    few row ranges as make the grid's last wave of blocks at least
    ``FILL`` full (1024-thread blocks, as many per SM as shared memory
    allows), within the fewest waves that can; each range a multiple of 4
    rows (four rows per thread) and at least ``MIN_ROWS`` and 4 * m * nb
    rows, so that a block's partial sums stay well under its scatter. At
    depth, where one feature fills a block, a block covers a third of the
    rows or more. ``sms`` is the card's SM count (the wrapper reads it
    from the device it launches on). Raises when one feature's histogram does not fit in
    shared memory.

    ``features`` and ``chunks`` (a tuned plan, :func:`hist`'s ``plan``;
    None or 0 = this function's own choice) cap the features per block and
    set the number of row ranges. Both are clamped at every level as the
    own choice is, the features by shared memory and the row ranges to
    [1, the most the rows allow], so that a plan tuned once stays legal at
    every depth."""
    per_feature = feature_smem_bytes(m, nb)
    if per_feature > HIST_SMEM_BYTES:
        raise ValueError(f"m={m} x nb={nb} needs {per_feature} bytes of "
                         f"shared memory per feature (> {HIST_SMEM_BYTES})")
    F = max(1, min(d, HIST_SMEM_BYTES // per_feature))
    if features:
        F = max(1, min(F, int(features)))
    groups = -(-d // F)
    F = -(-d // groups)
    slots = sms * min(2, SM_SMEM_BYTES // (F * per_feature + 1024))
    most = max(1, min(n // max(MIN_ROWS, 4 * m * nb), 4 * slots))

    def waves(c):
        return -(-groups * c // slots)

    def fill(c):
        return groups * c / (waves(c) * slots)

    if chunks:
        chunks = max(1, min(int(chunks), most))
    else:
        full = [c for c in range(1, most + 1) if fill(c) >= FILL]
        chunks = (min(full, key=lambda c: (waves(c), -fill(c))) if full
                  else max(range(1, most + 1), key=fill))
    rows = -(-(-(-n // chunks)) // 4) * 4
    return F, min(rows, max(n, 1))


def hist(bins: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
         hess: torch.Tensor, m: int, nb: int,
         plan: Optional[Tuple[int, int]] = None,
         exponents: Optional[Tuple[int, int]] = None):
    """(ghist, hhist), each [d, m, nb] float32; with ``exponents=(eg, eh)``
    the int64 sums at those fixed-point exponents (exact across cards, see
    the module docstring), from the kernel on CUDA tensors and from
    :func:`hist_plain_fixed` on CPU tensors.

    ``bins`` [d, n] uint8 with values < nb <= 256; ``node`` [n] int32 in
    [0, m); ``grad``, ``hess`` [n] float32 (finite). Nodes and bins out of
    those ranges are not checked (that would wait for the device): such a
    row, or (feature, row), adds nothing, on either path. On CUDA tensors this
    launches the kernel on the current stream (``hist.launches`` counts
    those launches, and ``hist.tap``, where set, is called with each
    launch's arguments first); on CPU tensors it runs :func:`hist_plain`.
    ``plan`` = (features, chunks), a tuned plan
    (``search/kernel_tuner.py::state_to_hist_plan``), goes to
    :func:`launch_plan`; None, or 0 in either place, leaves that knob to
    it. The sums are exact, so every plan gives the same histograms bit
    for bit; the plain path takes no plan."""
    if bins.device.type == "cpu":
        if exponents is not None:
            return hist_plain_fixed(bins, node, grad, hess, m, nb, exponents)
        return hist_plain(bins, node, grad, hess, m, nb)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    features, chunks = plan if plan is not None else (None, None)
    return _launch(bins, node, grad, hess, int(m), int(nb), features,
                   chunks, exponents)


hist.launches = 0
hist.tap = None


# scratch per (device, stream, d, m, nb, row ranges): the absmax kernel's
# per-block maxima and, with more than one row range, the blocks' partial
# sums
_SCRATCH = OrderedDict()
_SCRATCH_MAX = 16


def _scratch(lib, dev, stream, d, m, nb, chunks):
    key = (dev, stream, d, m, nb, chunks)
    hit = _SCRATCH.get(key)
    if hit is not None:
        _SCRATCH.move_to_end(key)
        return hit
    bmax = torch.empty(lib.hist_bmax_words(), dtype=torch.int32, device=dev)
    part = None
    if chunks > 1:
        part = torch.empty(chunks * d * 2 * m * nb, dtype=torch.int64,
                           device=dev)
    hit = _SCRATCH[key] = (bmax, part)
    if len(_SCRATCH) > _SCRATCH_MAX:
        _SCRATCH.popitem(last=False)
    return hit


def _launch(bins, node, grad, hess, m, nb, features=None, chunks=None,
            exponents=None):
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
    out_dtype = torch.float32 if exponents is None else torch.int64
    ghist = torch.empty(d, m, nb, dtype=out_dtype, device=dev)
    hhist = torch.empty_like(ghist)
    if n == 0 or d == 0:
        return ghist.zero_(), hhist.zero_()
    F, rows = launch_plan(d, n, m, nb, sm_count(dev), features or None,
                          chunks or None)
    if hist.tap is not None:
        hist.tap(bins, node, grad, hess, m, nb)
    lib = LIB.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bmax, part = _scratch(lib, dev, stream, d, m, nb, -(-n // rows))
    part_ptr = None if part is None else part.data_ptr()
    if exponents is None:
        err = lib.hist_launch(
            bins.data_ptr(), node.data_ptr(), grad.data_ptr(),
            hess.data_ptr(), n, d, m, nb, F, rows, bmax.data_ptr(), part_ptr,
            ghist.data_ptr(), hhist.data_ptr(), stream)
    else:
        err = lib.hist_launch_fixed(
            bins.data_ptr(), node.data_ptr(), grad.data_ptr(),
            hess.data_ptr(), n, d, m, nb, F, rows, part_ptr,
            int(exponents[0]), int(exponents[1]), ghist.data_ptr(),
            hhist.data_ptr(), stream)
    check_launch(err, "hist")
    hist.launches += 1
    return ghist, hhist
