"""Blocked matrix product, the self-tuning target kernel (counterpart of
``vae_extent_search_tpu/ops/matmul_pallas.py``).

:func:`matmul` computes ``C = A . B`` in float32 from A [M, K] and B [K, N]
(both float32 or both bfloat16) with the block configuration ``(bm, bn,
bk)`` that the active search tunes: one launch of the hand-written CUDA
kernel ``csrc/matmul.cu`` when its inputs lie on a CUDA device, and
:func:`matmul_plain` (``a.float() @ b.float()``) when they lie on the CPU.
There is no fallback between the two: a CUDA tensor launches the kernel or
raises.

The configuration is the kernel's real tiling (one block per [bm, bn] tile
of C, an in-block loop over K in steps of bk, both tiles staged in shared
memory), so the lattice of configurations is the kernel's own:

- ``config_is_valid``: exact tiling (bm | M, bn | N, bk | K); a thread
  micro-tile from {1, 2, 4, 8}^2 that leaves at most 256 threads per block
  (the kernel's launch bound, which caps its registers); the two staged
  tiles within an H100 block's 227 KB of shared memory. Every configuration
  it accepts launches.
- ``snap_config_to_hw``: bn moves up to a multiple of 32 (a warp's lanes
  then take 32 neighbouring columns) and bk to a multiple of 8, each to the
  smallest such divisor of its axis or else the whole axis; a configuration
  over the limits then shrinks (bk first for shared memory, the larger of
  bm and bn for threads) to the next divisor on the lattice until it fits.

The TPU version's (sublane, 128) alignment and 12 MB VMEM budget do not
apply here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import MAX_SMEM_BYTES, CudaLibrary, check_launch

MAX_THREADS = 256
MICRO = (1, 2, 4, 8)
WARP = 32
K_ALIGN = 8
NUM_SMS = 132
# H100 SXM data-sheet peaks (dense) and memory rate; the per-step cost is
# one k-step of one block (two barriers and a tile load), of which the
# card runs one per SM at a time in this model
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12
STEP_S = 1e-6

DTYPES = {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.matmul_launch.argtypes = [vp, vp, vp] + [i32] * 9 + [vp]
    lib.matmul_launch.restype = i32


LIB = CudaLibrary("matmul", _declare)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def itemsize(dtype) -> int:
    return DTYPES[dtype_name(dtype)][0].itemsize


def thread_tile(rows: int, cols: int) -> Optional[Tuple[int, int]]:
    """The micro-tile (TM, TN) each thread of a [rows, cols] output tile
    computes: TM | rows, TN | cols, at most MAX_THREADS threads; the most
    threads, then the squarest micro-tile, then the wider TN. None when
    no micro-tile leaves few enough threads."""
    best = None
    for tm in MICRO:
        for tn in MICRO:
            if rows % tm or cols % tn:
                continue
            threads = (rows // tm) * (cols // tn)
            if threads > MAX_THREADS:
                continue
            key = (threads, min(tm, tn), tn)
            if best is None or key > best[0]:
                best = (key, (tm, tn))
    return None if best is None else best[1]


def matmul_smem_bytes(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Shared memory of one block: the A tile [bm, bk] and the B tile
    [bk, bn] in the input type."""
    return (bm + bn) * bk * itemsize


def config_is_valid(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                    dtype="bfloat16") -> Tuple[bool, Optional[str]]:
    for v, d, nm in ((bm, M, "bm"), (bn, N, "bn"), (bk, K, "bk")):
        if v < 1 or v > d:
            return False, f"{nm}={v} out of range (dim {d})"
        if d % v:
            return False, f"{nm}={v} does not divide {d}"
    if thread_tile(bm, bn) is None:
        return False, (f"threads: a {bm} x {bn} tile needs more than "
                       f"{MAX_THREADS} threads of at most 8 x 8 outputs")
    smem = matmul_smem_bytes(bm, bn, bk, itemsize(dtype))
    if smem > MAX_SMEM_BYTES:
        return False, f"shared memory {smem} B exceeds {MAX_SMEM_BYTES}"
    return True, None


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def snap_up(v: int, dim: int, align: int) -> int:
    """The smallest divisor of ``dim`` that is >= v and a multiple of
    ``align``, else ``dim``."""
    cands = [d for d in _divisors(dim) if d >= v and d % align == 0]
    return min(cands) if cands else dim


def shrink(v: int, dim: int, align: int) -> int:
    """The next divisor of ``dim`` below v that is a multiple of
    ``align`` (v itself when there is none)."""
    cands = [d for d in _divisors(dim) if d < v and d % align == 0]
    return max(cands) if cands else v


def snap_config_to_hw(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                      dtype="bfloat16") -> Tuple[int, int, int]:
    """Snap a raw (bm, bn, bk) onto the kernel's lattice (module
    docstring). The result is valid unless an axis has no divisor on the
    lattice that fits, and then it holds that axis whole."""
    bm = snap_up(max(bm, 1), M, 1)
    bn = snap_up(bn, N, WARP)
    bk = snap_up(bk, K, K_ALIGN)
    while True:
        ok, why = config_is_valid(M, N, K, bm, bn, bk, dtype)
        if ok:
            return bm, bn, bk
        if why.startswith("shared"):
            nk = shrink(bk, K, K_ALIGN)
            if nk != bk:
                bk = nk
                continue
        big_m = bm >= bn
        nm, nn = shrink(bm, M, 1), shrink(bn, N, WARP)
        if big_m and nm != bm:
            bm = nm
        elif nn != bn:
            bn = nn
        elif nm != bm:
            bm = nm
        else:
            return bm, bn, bk


def predicted_seconds(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                      dtype="bfloat16") -> float:
    """Coarse roofline + per-step estimate on an H100, used only to reject
    configurations that would run for seconds and as the CPU stand-in
    timer (``--fake-timer``). Not a cost model: the point is to measure."""
    size = itemsize(dtype)
    blocks = (M // bm) * (N // bn)
    steps = K // bk
    flops_t = 2.0 * M * N * K / PEAK_FLOPS[dtype_name(dtype)]
    # each block streams its A and B panels; C is written once
    bytes_moved = blocks * steps * (bm * bk + bk * bn) * size + M * N * 4
    return max(flops_t, bytes_moved / HBM_BYTES_S,
               blocks * steps * STEP_S / NUM_SMS)


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C [M, N] float32 = a @ b in float32 (on the card: full float32, as
    ``torch.backends.cuda.matmul.allow_tf32`` is False by default)."""
    return a.float() @ b.float()


def matmul(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int) -> torch.Tensor:
    """C [M, N] float32 = a [M, K] @ b [K, N] at block configuration
    (bm, bn, bk). On CUDA tensors this launches the kernel on the current
    stream (``matmul.launches`` counts the launches) after checking the
    configuration with :func:`config_is_valid`; on CPU tensors it runs
    :func:`matmul_plain`, whatever the configuration."""
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    name = dtype_name(a.dtype)
    if name not in DTYPES or b.dtype != a.dtype or b.device != a.device:
        raise ValueError("a and b must be float32 or bfloat16 tensors of one "
                         "dtype on one device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    M, K = a.shape
    N = b.shape[1]
    ok, why = config_is_valid(M, N, K, bm, bn, bk, name)
    if not ok:
        raise ValueError(f"invalid matmul config ({bm}, {bn}, {bk}): {why}")
    tm, tn = thread_tile(bm, bn)
    c = torch.empty(M, N, dtype=torch.float32, device=a.device)
    err = LIB.load().matmul_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, bm, bn, bk, tm, tn,
        DTYPES[name][1], torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(err, "matmul")
    matmul.launches += 1
    return c


matmul.launches = 0
