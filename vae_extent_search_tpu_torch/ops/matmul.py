"""Blocked matrix product, the self-tuning target kernel (counterpart of
``vae_extent_search_tpu/ops/matmul_pallas.py``).

:func:`matmul` computes ``C = A . B`` in float32 from A [M, K] and B [K, N]
(both float32 or both bfloat16) with the block configuration ``(bm, bn,
bk)`` that the active search tunes: one launch of the hand-written CUDA
kernel ``csrc/matmul.cu`` when its inputs lie on a CUDA device, and
:func:`matmul_plain` (``a.float() @ b.float()``) when they lie on the CPU.
There is no fallback between the two: a CUDA tensor launches the kernel or
raises.

The dtype chooses the kernel, and with it the lattice of configurations
(``config_is_valid``, ``snap_config_to_hw``), each the kernel's own:

- **bfloat16, tensor cores** (TMA loads into a ring of shared-memory
  stages, ``wgmma`` from a producer/consumer warp-specialised block): bm in
  ``BF16_BM`` (64-row wgmma atoms: one consumer warpgroup of one atom, two
  of one, two of two), bn in ``BF16_BN`` (the wgmma widths the library is
  built for, multiples of 16 loaded in 16/32/64-column swizzle chunks), bk
  in ``BF16_BK`` (an A row of bk * 2 bytes fills a 32/64/128-byte swizzle);
  the accumulators, (bm / 64 / warpgroups) * bn / 2 per consumer thread,
  at most ``ACC_REGS``; the stage count is derived, as many stages (up to
  ``MAX_STAGES``) as fit 227 KB, and must be at least two. Tiles need not
  divide M, N or K: TMA zero-fills out-of-range loads and the kernel masks
  its stores. TMA needs 16-byte row strides, so where K or N is not a
  multiple of 8 the wrapper stages A and B into zero-padded copies with K
  and N rounded up to multiples of 8 (:func:`bf16_staged`), runs the kernel
  unchanged on them and cuts C back to [M, N]. The padded K terms are exact
  zeros, so every f32 sum is the unpadded product's; the padded N columns
  are computed and dropped. The copies are part of the call, so a tuner
  timing such a shape times them too, as its caller pays for them; aligned
  shapes take no copy. The snap moves each of bm, bn, bk up to the lattice
  (from at most the axis length), then narrows bn until the accumulators
  fit; its result is always valid.
- **float32, CUDA cores**: exact tiling (bm | M, bn | N, bk | K); a thread
  micro-tile from {1, 2, 4, 8}^2 leaving at most 256 threads per block (the
  kernel's launch bound, which caps its registers); the two staged tiles
  within 227 KB. The snap moves bn up to a multiple of 32 and bk to a
  multiple of 8, each to the smallest such divisor of its axis or else the
  whole axis, then shrinks (bk first for shared memory, the larger of bm
  and bn for threads) to the next divisor on the lattice until it fits.

Every configuration the lattice accepts launches. The validity result, the
launch plan and (bf16) the two TMA descriptors are cached per shape and
configuration, so a repeated call costs the host a dictionary lookup, a
``torch.empty`` and one ctypes call.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import List, Optional, Tuple

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
LAUNCH_S = 3e-6

# the bf16 tensor-core kernel's lattice (csrc/matmul.cu: the instances and
# csrc/gen_wgmma.py's widths)
BF16_BM = (64, 128, 256)
BF16_BN = (16, 32, 64, 96, 128, 160, 192, 224, 256)
BF16_BK = (16, 32, 64)
MAX_STAGES = 6
ACC_REGS = 128       # f32 accumulators per consumer thread
TMA_ALIGN = 8        # bf16 elements in 16 bytes

DTYPES = {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.matmul_f32_launch.argtypes = [vp, vp, vp] + [i32] * 8 + [vp]
    lib.matmul_bf16_maps.argtypes = [vp, vp] + [i32] * 6 + [vp]
    lib.matmul_bf16_launch.argtypes = [vp, vp] + [i32] * 7 + [vp]
    lib.matmul_instances.argtypes = [ctypes.POINTER(i32), i32]
    lib.matmul_attr_calls.argtypes = []
    for fn in ("matmul_f32_launch", "matmul_bf16_maps", "matmul_bf16_launch",
               "matmul_instances", "matmul_attr_calls"):
        getattr(lib, fn).restype = i32


LIB = CudaLibrary("matmul", _declare)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def itemsize(dtype) -> int:
    return DTYPES[dtype_name(dtype)][0].itemsize


def library_instances(fn) -> List[Tuple[str, int, int]]:
    """The template instances a built library holds, as its
    ``<name>_instances`` C function ``fn`` lists them: (dtype name, p, q)."""
    n = fn(None, 0)
    buf = (ctypes.c_int * (3 * n))()
    fn(buf, n)
    names = {v[1]: k for k, v in DTYPES.items()}
    return [(names[buf[3 * i]], buf[3 * i + 1], buf[3 * i + 2])
            for i in range(n)]


@lru_cache(maxsize=None)
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
    """Shared memory of one float32 block: the A tile [bm, bk] and the B
    tile [bk, bn] in the input type."""
    return (bm + bn) * bk * itemsize


def bf16_atoms(bm: int) -> Tuple[int, int]:
    """(consumer warpgroups, 64-row atoms per warpgroup) of a bf16 tile."""
    return (1, 1) if bm == 64 else (2, bm // 128)


def bf16_accumulators(bm: int, bn: int) -> int:
    """f32 accumulators each consumer thread holds: bn / 2 per atom."""
    return bf16_atoms(bm)[1] * bn // 2


def bf16_smem_bytes(bm: int, bn: int, bk: int, stages: int) -> int:
    """Dynamic shared memory of one bf16 block (csrc/matmul.cu::bf16_smem):
    1 KB of alignment slack, ``stages`` A + B tiles at 1 KB boundaries and
    two 8-byte barriers per stage."""
    stage = -(-(bm + bn) * bk * 2 // 1024) * 1024
    return 1024 + stages * stage + 16 * stages


@lru_cache(maxsize=None)
def bf16_stages(bm: int, bn: int, bk: int) -> int:
    """The ring's depth: as many stages as fit 227 KB, at most MAX_STAGES
    (0 or 1 when not even two fit)."""
    s = MAX_STAGES
    while s > 0 and bf16_smem_bytes(bm, bn, bk, s) > MAX_SMEM_BYTES:
        s -= 1
    return s


def _bf16_why(M, N, K, bm, bn, bk) -> Optional[str]:
    if bm not in BF16_BM:
        return (f"bm={bm} not in {BF16_BM}: 64-row wgmma atoms, one or two "
                f"consumer warpgroups")
    if bn not in BF16_BN:
        return f"bn={bn} not a wgmma width of the library {BF16_BN}"
    if bk not in BF16_BK:
        return (f"bk={bk} not in {BF16_BK}: an A row of bk * 2 bytes fills a "
                f"32/64/128-byte swizzle")
    acc = bf16_accumulators(bm, bn)
    if acc > ACC_REGS:
        return (f"registers: {acc} accumulators per consumer thread exceed "
                f"{ACC_REGS}")
    stages = bf16_stages(bm, bn, bk)
    if stages < 2:
        return (f"shared memory: two stages of {bm} x {bk} + {bk} x {bn} "
                f"exceed {MAX_SMEM_BYTES} B")
    return None


def _f32_why(M, N, K, bm, bn, bk) -> Optional[str]:
    for v, d, nm in ((bm, M, "bm"), (bn, N, "bn"), (bk, K, "bk")):
        if v > d:
            return f"{nm}={v} out of range (dim {d})"
        if d % v:
            return f"{nm}={v} does not divide {d}"
    if thread_tile(bm, bn) is None:
        return (f"threads: a {bm} x {bn} tile needs more than "
                f"{MAX_THREADS} threads of at most 8 x 8 outputs")
    smem = matmul_smem_bytes(bm, bn, bk, 4)
    if smem > MAX_SMEM_BYTES:
        return f"shared memory {smem} B exceeds {MAX_SMEM_BYTES}"
    return None


@lru_cache(maxsize=65536)
def config_is_valid(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                    dtype="bfloat16") -> Tuple[bool, Optional[str]]:
    """(ok, the reason it is refused) for a configuration on the lattice of
    the kernel ``dtype`` takes (module docstring)."""
    for v, nm in ((M, "M"), (N, "N"), (K, "K"), (bm, "bm"), (bn, "bn"),
                  (bk, "bk")):
        if v < 1:
            return False, f"{nm}={v} out of range"
    why = (_bf16_why if dtype_name(dtype) == "bfloat16" else _f32_why)(
        M, N, K, bm, bn, bk)
    return why is None, why


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


def up_to(v: int, dim: int, choices) -> int:
    """The smallest of ``choices`` at least min(v, dim), else the largest."""
    want = min(max(v, 1), dim)
    return next((c for c in choices if c >= want), choices[-1])


def snap_config_to_hw(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                      dtype="bfloat16") -> Tuple[int, int, int]:
    """Snap a raw (bm, bn, bk) onto the kernel's lattice (module
    docstring). bf16: the result is always valid (K or N off TMA's
    alignment is staged by the wrapper). f32: the result is valid unless
    an axis has no divisor on the lattice that fits, and then it holds
    that axis whole."""
    if dtype_name(dtype) == "bfloat16":
        bm, bn, bk = (up_to(bm, M, BF16_BM), up_to(bn, N, BF16_BN),
                      up_to(bk, K, BF16_BK))
        while bf16_accumulators(bm, bn) > ACC_REGS:
            bn = BF16_BN[BF16_BN.index(bn) - 1]
        return bm, bn, bk
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
    timer (``--fake-timer``). Not a cost model: the point is to measure.

    bf16: waves of one tile per SM, each tile's operations (K padded to bk)
    at the SM's share of the tensor-core peak, slowed in proportion where
    the tile is narrower than 128 x 128 (wgmma re-reads the operands per
    instruction); or the tiles' operand traffic over HBM; plus a launch.
    f32: the larger of the operations at the CUDA-core peak, the traffic,
    and one microsecond per k-step of each block."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        tiles = math.ceil(M / bm) * math.ceil(N / bn)
        steps = math.ceil(K / bk)
        eff = min(1.0, bm / 128) * min(1.0, bn / 128)
        tile_s = (2.0 * bm * bn * steps * bk / (PEAK_FLOPS[name] / NUM_SMS)
                  / eff)
        bytes_moved = tiles * steps * (bm + bn) * bk * 2 + M * N * 4
        return max(math.ceil(tiles / NUM_SMS) * tile_s,
                   bytes_moved / HBM_BYTES_S) + LAUNCH_S
    size = itemsize(dtype)
    blocks = (M // bm) * (N // bn)
    steps = K // bk
    flops_t = 2.0 * M * N * K / PEAK_FLOPS[name]
    # each block streams its A and B panels; C is written once
    bytes_moved = blocks * steps * (bm * bk + bk * bn) * size + M * N * 4
    return max(flops_t, bytes_moved / HBM_BYTES_S,
               blocks * steps * STEP_S / NUM_SMS)


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C [M, N] float32 = a @ b in float32 (on the card: full float32, as
    ``torch.backends.cuda.matmul.allow_tf32`` is False by default)."""
    return a.float() @ b.float()


def bf16_staged(a: torch.Tensor, b: torch.Tensor):
    """(a, b) for the bf16 kernel: the inputs themselves when K and N are
    multiples of ``TMA_ALIGN`` (no copy), else zero-padded copies with K
    and N rounded up to multiples of it (16-byte row strides for TMA)."""
    K, N = b.shape
    pad_k, pad_n = -K % TMA_ALIGN, -N % TMA_ALIGN
    if pad_k:
        a = torch.nn.functional.pad(a, (0, pad_k))
    if pad_k or pad_n:
        b = torch.nn.functional.pad(b, (0, pad_n, 0, pad_k))
    return a, b


# the bf16 kernel's two TMA descriptors (2 x 128 bytes, 64-byte aligned) per
# (pointers, shape, tile); a descriptor holds only the address, shape and box
_MAPS = {}
_MAPS_MAX = 256


def _tensor_maps(lib, a_ptr: int, b_ptr: int, M: int, N: int, K: int,
                 bm: int, bn: int, bk: int) -> int:
    key = (a_ptr, b_ptr, M, N, K, bm, bn, bk)
    hit = _MAPS.get(key)
    if hit is None:
        if len(_MAPS) >= _MAPS_MAX:
            _MAPS.clear()
        buf = ctypes.create_string_buffer(256 + 64)
        addr = (ctypes.addressof(buf) + 63) & ~63
        check_launch(lib.matmul_bf16_maps(a_ptr, b_ptr, M, N, K, bm, bn, bk,
                                          addr), "matmul (tensor maps)")
        hit = _MAPS[key] = (buf, addr)
    return hit[1]


def matmul(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int) -> torch.Tensor:
    """C [M, N] float32 = a [M, K] @ b [K, N] at block configuration
    (bm, bn, bk). On CUDA tensors this launches the kernel of the inputs'
    dtype on the current stream (``matmul.launches`` counts the launches)
    after checking the configuration with :func:`config_is_valid`; on CPU
    tensors it runs :func:`matmul_plain`, whatever the configuration."""
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
    lib = LIB.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if name == "bfloat16":
        a, b = bf16_staged(a, b)
        Kp, Np = b.shape
        if a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError("a and b must be 16-byte aligned (TMA)")
        c = torch.empty(M, Np, dtype=torch.float32, device=a.device)
        maps = _tensor_maps(lib, a.data_ptr(), b.data_ptr(), M, Np, Kp, bm,
                            bn, bk)
        err = lib.matmul_bf16_launch(maps, c.data_ptr(), M, Np, Kp, bm, bn,
                                     bk, bf16_stages(bm, bn, bk), stream)
    else:
        c = torch.empty(M, N, dtype=torch.float32, device=a.device)
        tm, tn = thread_tile(bm, bn)
        err = lib.matmul_f32_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    M, N, K, bm, bn, bk, tm, tn, stream)
    check_launch(err, "matmul")
    matmul.launches += 1
    return c if c.shape[1] == N else c[:, :N].contiguous()


matmul.launches = 0
