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
  and N rounded up to multiples of 8 (:func:`staged`), runs the kernel
  unchanged on them and cuts C back to [M, N]. The padded K terms are exact
  zeros, so every f32 sum is the unpadded product's; the padded N columns
  are computed and dropped. The copies are part of the call, so a tuner
  timing such a shape times them too, as its caller pays for them; aligned
  shapes take no copy. The snap moves each of bm, bn, bk up to the lattice
  (from at most the axis length), then narrows bn until the accumulators
  fit; its result is always valid.
- **float32, CUDA cores** (exact FFMA; cp.async into a ring of
  shared-memory stages, 8 x 8 or 8 x 4 accumulators per thread read from
  float4 fragments): bm in ``F32_BM`` and bn in ``F32_BN`` (the library's
  instances, one per pair), bk in ``F32_BK`` (whole float4 groups of k,
  a power of two of them per A row); the stage count is derived, as many
  stages (up to ``F32_MAX_STAGES``) as leave room for two blocks in an
  SM's shared memory. Every configuration of the lattice fits the card.
  Tiles need not divide M, N or K: the kernel zero-fills out-of-range
  copies and masks its stores. Its 16-byte copies need 16-byte rows, so
  where K or N is not a multiple of 4 the wrapper stages zero-padded
  operands as for bf16 (:func:`staged`). The snap moves each of bm, bn, bk
  up to the lattice (from at most the axis length); its result is always
  valid.

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

from .build import MAX_SMEM_BYTES, SM_SMEM_BYTES, CudaLibrary, check_launch

WARP = 32
NUM_SMS = 132
# H100 SXM data-sheet peaks (dense) and memory rate; the per-step cost is
# one k-step of one block (two barriers and a tile load), of which the
# card runs one per SM at a time in the conv2d f32 model
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

# the f32 CUDA-core kernel's lattice (csrc/matmul.cu: F32_BM, F32_BN)
F32_BM = (32, 64, 96, 128)
F32_BN = (32, 64, 96, 128)
F32_BK = (8, 16, 32)
F32_MAX_STAGES = 4
F32_ROW_PAD = 4          # f32 elements of padding per A row in shared memory
F32_ALIGN = 4            # f32 elements in 16 bytes
BLOCK_RESERVED_BYTES = 1024  # shared memory the card reserves per block
# the share of the 8 x 8 thread tile's FMA rate assumed for an 8 x 4 one
# by the stand-in timer (3 shared-memory loads per 32 FMAs against 2)
F32_NARROW_SHARE = 2 / 3

DTYPES = {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.matmul_f32_launch.argtypes = [vp, vp, vp] + [i32] * 7 + [vp]
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


def f32_thread_tile(bm: int, bn: int) -> int:
    """TN of the f32 instance's 8 x TN accumulator tile per thread
    (csrc/matmul.cu::F32Tile): 8, or 4 where 8 x 8 would leave a part of a
    warp."""
    return 8 if (bm * bn // 64) % WARP == 0 else 4


def matmul_smem_bytes(bm: int, bn: int, bk: int, stages: int) -> int:
    """Dynamic shared memory of one float32 block (csrc/matmul.cu::
    f32_smem): ``stages`` x (the A tile [bm, bk + F32_ROW_PAD] and the B
    tile [bk, bn]) in f32."""
    return stages * (bm * (bk + F32_ROW_PAD) + bk * bn) * 4


def ring_stages(stage_bytes: int) -> int:
    """The depth of an f32 kernel's ring (the matmul's, the conv2d's) whose
    stage takes ``stage_bytes``: the most stages, up to F32_MAX_STAGES, that
    leave room for two blocks in an SM's shared memory, and at least two
    (then one block per SM, if they fit 227 KB)."""
    s = F32_MAX_STAGES
    while s > 2 and 2 * (s * stage_bytes
                         + BLOCK_RESERVED_BYTES) > SM_SMEM_BYTES:
        s -= 1
    return s


@lru_cache(maxsize=None)
def f32_stages(bm: int, bn: int, bk: int) -> int:
    """The f32 matmul ring's depth (:func:`ring_stages`)."""
    return ring_stages(matmul_smem_bytes(bm, bn, bk, 1))


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
    if bm not in F32_BM:
        return f"bm={bm} not in {F32_BM}: the library's f32 tiles"
    if bn not in F32_BN:
        return f"bn={bn} not in {F32_BN}: the library's f32 tiles"
    if bk not in F32_BK:
        return (f"bk={bk} not in {F32_BK}: a power of two of 16-byte "
                f"chunks per A row")
    smem = matmul_smem_bytes(bm, bn, bk, f32_stages(bm, bn, bk))
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


def up_to(v: int, dim: int, choices) -> int:
    """The smallest of ``choices`` at least min(v, dim), else the largest."""
    want = min(max(v, 1), dim)
    return next((c for c in choices if c >= want), choices[-1])


def snap_config_to_hw(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                      dtype="bfloat16") -> Tuple[int, int, int]:
    """Snap a raw (bm, bn, bk) onto the kernel's lattice (module
    docstring): each up to the lattice, from at most its axis. The result
    is always valid (K or N off the 16-byte alignment is staged by the
    wrapper). bf16 then narrows bn until the accumulators fit."""
    if dtype_name(dtype) == "bfloat16":
        bm, bn, bk = (up_to(bm, M, BF16_BM), up_to(bn, N, BF16_BN),
                      up_to(bk, K, BF16_BK))
        while bf16_accumulators(bm, bn) > ACC_REGS:
            bn = BF16_BN[BF16_BN.index(bn) - 1]
        return bm, bn, bk
    return up_to(bm, M, F32_BM), up_to(bn, N, F32_BN), up_to(bk, K, F32_BK)


def predicted_seconds(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                      dtype="bfloat16") -> float:
    """Coarse roofline + per-step estimate on an H100, used only to reject
    configurations that would run for seconds and as the CPU stand-in
    timer (``--fake-timer``). Not a cost model: the point is to measure.

    Waves of one tile per SM (the blocks an SM holds share its rate), each
    tile's operations (K padded to bk) at the SM's share of the dtype's
    peak, slowed where the tile reads its operands more often per
    operation: bf16 in proportion where the tile is narrower than 128 x
    128 (wgmma re-reads the operands per instruction), f32 by
    F32_NARROW_SHARE for an 8 x 4 thread tile; or the tiles' operand
    traffic over HBM; plus a launch."""
    name = dtype_name(dtype)
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    steps = math.ceil(K / bk)
    if name == "bfloat16":
        eff = min(1.0, bm / 128) * min(1.0, bn / 128)
    else:
        eff = 1.0 if f32_thread_tile(bm, bn) == 8 else F32_NARROW_SHARE
    tile_s = 2.0 * bm * bn * steps * bk / (PEAK_FLOPS[name] / NUM_SMS) / eff
    bytes_moved = tiles * steps * (bm + bn) * bk * itemsize(dtype) + M * N * 4
    return max(math.ceil(tiles / NUM_SMS) * tile_s,
               bytes_moved / HBM_BYTES_S) + LAUNCH_S


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C [M, N] float32 = a @ b in float32 (on the card: full float32, as
    ``torch.backends.cuda.matmul.allow_tf32`` is False by default)."""
    return a.float() @ b.float()


def staged(a: torch.Tensor, b: torch.Tensor, align: int):
    """(a, b) for a kernel that copies 16-byte rows (``align`` elements:
    ``TMA_ALIGN`` for bf16, ``F32_ALIGN`` for f32): the inputs themselves
    when K and N are multiples of ``align`` (no copy), else zero-padded
    copies with K and N rounded up to multiples of it. K is a's last axis
    and b's last but one, N b's last (so the conv2d's x [..., CI] and w
    [KH, KW, CI, CO] stage as they are)."""
    K, N = b.shape[-2:]
    pad_k, pad_n = -K % align, -N % align
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
    bf16 = name == "bfloat16"
    a, b = staged(a, b, TMA_ALIGN if bf16 else F32_ALIGN)
    Kp, Np = b.shape
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned (TMA, cp.async)")
    c = torch.empty(M, Np, dtype=torch.float32, device=a.device)
    if bf16:
        maps = _tensor_maps(lib, a.data_ptr(), b.data_ptr(), M, Np, Kp, bm,
                            bn, bk)
        err = lib.matmul_bf16_launch(maps, c.data_ptr(), M, Np, Kp, bm, bn,
                                     bk, bf16_stages(bm, bn, bk), stream)
    else:
        err = lib.matmul_f32_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    M, Np, Kp, bm, bn, bk,
                                    f32_stages(bm, bn, bk), stream)
    check_launch(err, "matmul")
    matmul.launches += 1
    return c if c.shape[1] == N else c[:, :N].contiguous()


matmul.launches = 0
