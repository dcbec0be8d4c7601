"""Fused cost-head statistics for candidate selection (counterpart of
``vae_extent_search_tpu/ops/fused_head_pallas.py``).

For every candidate the selection phase needs the predicted cost, the
norm of its gradient with respect to the latent ``z``, and the mean and
sample variance (ddof=1) of T MC-dropout passes of the 2-hidden-layer
cost head. :func:`fused_head_stats` computes all four with the
hand-written CUDA kernel ``csrc/fused_head.cu`` when its input lies on a
CUDA device, and through :func:`fused_head_stats_plain`, the same
function in plain torch, when it lies on the CPU. There is no fallback
between the two: a CUDA tensor launches the kernel or raises.

The kernel's grid is candidate tiles x G groups (:func:`launch_plan`).
Where there are too few candidates to fill the card, the T passes are
split over groups and a second kernel adds the groups' sums in a fixed
order (:func:`mc_finish_plain` is its plain version), so a call still
repeats bit for bit.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``vae_extent_search_tpu_torch/build/`` and loaded with ctypes through a
plain C interface (``ops/build.py``).

Numerics (both versions, as the JAX kernel): matmul operands are rounded
to the compute dtype (the input's dtype, float32 or bfloat16) and
accumulated in float32; biases are rounded to the compute dtype and
added in float32, except ``b2``, which stays float32. Dropout keeps a
hidden unit of h0 when its 32-bit random word is ``>= min(int(rate *
2**32), 2**32 - 1)`` and scales kept units by ``1 / (1 - rate)``.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from functools import lru_cache
from itertools import accumulate
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .build import MAX_SMEM_BYTES, CudaLibrary, check_launch, sm_count

BM = 32           # candidates per block (csrc/fused_head.cu)
MAX_GROUPS = 32   # grid rows the kernel takes


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_head_stats_launch.argtypes = [
        i32, vp, ctypes.c_longlong, i32, i32, vp, vp, vp,
        vp, vp, vp, vp, vp, vp, vp, vp,
        i32, i32, i32, i32, ctypes.c_uint, ctypes.c_float,
        vp, ctypes.c_ulonglong, i32, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.fused_head_stats_launch.restype = i32
    lib.fused_head_smem_bytes.argtypes = [i32]
    lib.fused_head_smem_bytes.restype = ctypes.c_size_t
    lib.fused_head_attr_calls.argtypes = []
    lib.fused_head_attr_calls.restype = i32


LIB = CudaLibrary("fused_head", _declare)


def dropout_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def fused_head_passes_plain(head_layers: List[Dict], x: torch.Tensor,
                            T: int, rate: float,
                            mask_bits: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            encoder: Optional[Tuple] = None):
    """(cost, gnorm, deltas): the arguments and the first two outputs of
    :func:`fused_head_stats_plain`, and the T passes' deltas from the
    cost, a list of [N] float32, in pass order."""
    ct = x.dtype
    f32 = torch.float32

    def rnd(t):
        return t.to(ct).to(f32)

    def dense(layer, h):
        return rnd(h) @ rnd(layer["w"]) + rnd(layer["b"])

    z = x.to(f32)
    if encoder is not None:
        enc_layers, fc_mu = encoder
        for layer in enc_layers:
            z = torch.relu(dense(layer, z))
        z = dense(fc_mu, z)
    w0, w1 = rnd(head_layers[0]["w"]), rnd(head_layers[1]["w"])
    w2 = rnd(head_layers[2]["w"])[:, 0]
    b1 = rnd(head_layers[1]["b"])
    b2 = head_layers[2]["b"].to(f32)[0]

    a0 = rnd(z) @ w0 + rnd(head_layers[0]["b"])
    h0 = torch.relu(a0)
    a1 = rnd(h0) @ w1 + b1
    cost = rnd(torch.relu(a1)) @ w2 + b2

    zero = torch.zeros((), dtype=f32, device=x.device)
    g1 = torch.where(a1 > 0, w2, zero)
    g0 = torch.where(a0 > 0, rnd(g1) @ w1.T, zero)
    gz = rnd(g0) @ w0.T
    gnorm = torch.sqrt((gz * gz).sum(-1))

    thresh = dropout_threshold(rate)
    h0s = rnd(h0 * torch.tensor(1.0 / (1.0 - rate), dtype=f32))
    deltas = []
    for t in range(T):
        if mask_bits is not None:
            # compared as int64: torch has no >= for uint32 on the CPU
            # (the int32 view then a mask keeps this to ops every device
            # has for int32)
            bits = mask_bits[t].view(torch.int32).to(torch.int64) \
                & 0xFFFFFFFF
        else:
            bits = torch.randint(0, 2 ** 32, h0.shape, dtype=torch.int64,
                                 generator=generator,
                                 device=generator.device)
        keep = bits.to(x.device) >= thresh
        h1t = rnd(torch.relu(torch.where(keep, h0s, zero) @ w1 + b1))
        deltas.append((h1t @ w2 + b2) - cost)
    return cost, gnorm, deltas


def fused_head_stats_plain(head_layers: List[Dict], x: torch.Tensor, T: int,
                           rate: float,
                           mask_bits: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           encoder: Optional[Tuple] = None):
    """(cost, gnorm, mc_mean, mc_var), each [N] float32, in plain torch.

    ``x`` is [N, D] raw features when ``encoder=(encoder_layers, fc_mu)``
    is given, else latents [N, L]; its dtype is the compute dtype. The
    dropout words come from ``mask_bits`` [T, N, H] (uint32, candidate
    major) or, when it is None, from ``generator``."""
    cost, gnorm, deltas = fused_head_passes_plain(
        head_layers, x, T, rate, mask_bits, generator, encoder)
    s = torch.zeros_like(cost)
    s2 = torch.zeros_like(cost)
    for dt in deltas:
        s = s + dt
        s2 = s2 + dt * dt
    return (cost, gnorm, *mc_finish_plain(cost, s[None], s2[None], T))


def mc_finish_plain(cost: torch.Tensor, s_parts: torch.Tensor,
                    s2_parts: torch.Tensor, T: int):
    """(mc_mean, mc_var) from the groups' sums of the centred pass deltas
    ``s_parts`` [G, N] and of their squares ``s2_parts`` [G, N], added in
    the order g = 0 .. G-1 as the kernel's second pass adds them."""
    s = torch.zeros_like(cost)
    s2 = torch.zeros_like(cost)
    for g in range(s_parts.shape[0]):
        s = s + s_parts[g]
        s2 = s2 + s2_parts[g]
    mean = cost + s / T
    var = (s2 - s * s / T) / (T - 1) if T > 1 else s2 * 0.0
    return mean, var


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _check_layer(layer: Dict, in_dim: int, name: str) -> int:
    w, b = layer["w"], layer["b"]
    if w.dim() != 2 or w.shape[0] != in_dim or b.shape != (w.shape[1],):
        raise ValueError(f"{name}: weight {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not take width {in_dim}")
    return w.shape[1]


def pass_bounds(T: int, groups: int) -> Tuple[int, ...]:
    """Group g's passes are [bounds[g], bounds[g + 1]). One group runs
    all T; with G > 1, group 0 runs the backward (~1.25 passes of work)
    and no pass, and groups 1 .. G-1 share the T passes, the first ones
    one more where G - 1 does not divide T."""
    if groups == 1:
        return (0, T)
    if not 2 <= groups <= min(T + 1, MAX_GROUPS):
        raise ValueError(f"{groups} groups for {T} passes")
    q, r = divmod(T, groups - 1)
    return (0, 0, *accumulate(q + (i < r) for i in range(groups - 1)))


@lru_cache(maxsize=4096)
def launch_plan(n: int, T: int, sms: int) -> Tuple[int, Tuple[int, ...]]:
    """(G, pass bounds) for N = ``n`` candidates on a card of ``sms`` SMs:
    the kernel's grid is ceil(n / BM) tiles x G groups.

    Every block runs the encoder and the forward of its tile (~0.24 of the
    whole work per candidate at the main path's widths), then its group's
    share, so the longest block is the forward plus ceil(T / (G - 1))
    passes. G is the smallest value that makes that the shortest while
    every block has an SM of its own (tiles x G <= sms); G = 1 where two
    groups would not fit (the bench shape's 8,192 tiles) or T = 1. A
    second block on an SM, which shared memory allows, adds only ~1.3x to
    the SM's rate (the G sweep of ``chip_smoke.py`` phase 4 on an H100):
    at N = 773, T = 10 on 132 SMs G = 5 (125 blocks, three passes in the
    longest) beats G = 6 to 10 (150 to 250 blocks, two). See
    :func:`pass_bounds`."""
    tiles = -(-n // BM)
    most = min(T + 1, MAX_GROUPS, sms // max(tiles, 1))
    if T < 2 or most < 2:
        return 1, pass_bounds(T, 1)
    groups = min(range(2, most + 1), key=lambda g: (-(-T // (g - 1)), g))
    return groups, pass_bounds(T, groups)


# the groups' sums [2, G, N] per (device, stream, G, N)
_SCRATCH = OrderedDict()
_SCRATCH_MAX = 16


def _scratch(dev, stream, groups, n):
    key = (dev, stream, groups, n)
    hit = _SCRATCH.get(key)
    if hit is not None:
        _SCRATCH.move_to_end(key)
        return hit
    hit = _SCRATCH[key] = torch.empty(2, groups, n, dtype=torch.float32,
                                      device=dev)
    if len(_SCRATCH) > _SCRATCH_MAX:
        _SCRATCH.popitem(last=False)
    return hit


def fused_head_stats(head_layers: List[Dict], x: torch.Tensor, seed: int,
                     T: int = 10, rate: float = 0.1,
                     mask_bits: Optional[torch.Tensor] = None,
                     encoder: Optional[Tuple[Sequence[Dict], Dict]] = None,
                     groups: Optional[int] = None):
    """cost, gnorm, mc_mean, mc_var — each [N] float32 — for a
    2-hidden-layer ReLU cost head over ``x``: latents [N, L], or raw
    features [N, D] with ``encoder=(encoder_layers, fc_mu)`` run first.

    On a CUDA tensor this launches the CUDA kernel on the current stream,
    and where the plan has G > 1 groups the kernel that adds their sums
    (``fused_head_stats.launches`` counts one per call); ``groups``
    replaces :func:`launch_plan`'s G, for timing and tests. The dropout
    words are ``mask_bits`` [T, N, H] uint32 when given, else Philox bits
    from ``seed``. On a CPU tensor it runs :func:`fused_head_stats_plain`,
    with ``mask_bits`` or a CPU generator seeded by ``seed``."""
    if len(head_layers) != 3:
        raise ValueError("the kernel is specialized to 2 hidden layers")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if x.device.type == "cpu":
        gen = None
        if mask_bits is None:
            gen = torch.Generator().manual_seed(int(seed))
        return fused_head_stats_plain(head_layers, x, T, rate, mask_bits,
                                      gen, encoder)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(head_layers, x, int(seed), T, rate, mask_bits, encoder,
                   groups)


fused_head_stats.launches = 0


def _launch(head_layers, x, seed, T, rate, mask_bits, encoder, groups):
    dev, ct = x.device, x.dtype
    if ct not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {ct}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [N, D] tensor")
    n, d = x.shape
    enc = [] if encoder is None else [*encoder[0], encoder[1]]
    if len(enc) > 8:
        raise ValueError("at most 8 encoder layers (fc_mu included)")
    width = d
    for i, layer in enumerate(enc):
        width = _check_layer(layer, width, f"encoder layer {i}")
    L = width
    H0 = _check_layer(head_layers[0], L, "head layer 0")
    H1 = _check_layer(head_layers[1], H0, "head layer 1")
    if _check_layer(head_layers[2], H1, "head layer 2") != 1:
        raise ValueError("head layer 2 must have one output")
    if mask_bits is not None:
        if (mask_bits.dtype != torch.uint32 or mask_bits.device != dev
                or tuple(mask_bits.shape) != (T, n, H0)
                or not mask_bits.is_contiguous()):
            raise ValueError(f"mask_bits must be a contiguous uint32 "
                             f"[{T}, {n}, {H0}] tensor on {dev}")
    tensors = [l[k] for l in [*enc, *head_layers] for k in ("w", "b")]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"every parameter must lie on {dev}")

    lib = LIB.load()
    # the input width d streams from device memory; the hidden widths
    # live in shared memory
    widths = [*[l["w"].shape[1] for l in enc], L, H0, H1, 16]
    width = -(-max(widths) // 4) * 4
    smem = lib.fused_head_smem_bytes(width)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"hidden width {max(widths)} needs {smem} bytes of "
                         f"shared memory per block (> {MAX_SMEM_BYTES})")
    if n == 0:
        e = torch.empty(0, dtype=torch.float32, device=dev)
        return e, e.clone(), e.clone(), e.clone()
    bf16 = ct == torch.bfloat16
    if groups is None:
        groups, bounds = launch_plan(n, T, sm_count(dev))
    else:
        bounds = pass_bounds(T, groups)

    def w_(t):  # weights in the compute dtype, row-major [in, out]
        return t.to(ct).contiguous()

    def b_(t):  # biases rounded to the compute dtype, passed as f32
        return t.to(ct).to(torch.float32).contiguous()

    enc_w = [w_(l["w"]) for l in enc]
    enc_b = [b_(l["b"]) for l in enc]
    w0, w1 = w_(head_layers[0]["w"]), w_(head_layers[1]["w"])
    w2 = w_(head_layers[2]["w"][:, 0])
    b0, b1 = b_(head_layers[0]["b"]), b_(head_layers[1]["b"])
    b2 = head_layers[2]["b"].to(torch.float32).contiguous()
    w0t, w1t = w0.t().contiguous(), w1.t().contiguous()
    outs = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = None if groups == 1 else _scratch(dev, stream, groups, n)

    ptrs = ctypes.c_void_p * max(1, len(enc))
    err = lib.fused_head_stats_launch(
        int(bf16), x.data_ptr(), n, d, len(enc),
        ptrs(*[t.data_ptr() for t in enc_w]),
        ptrs(*[t.data_ptr() for t in enc_b]),
        (ctypes.c_int * (len(enc) + 1))(d, *[t.shape[1] for t in enc_w]),
        w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), w0t.data_ptr(), w1t.data_ptr(),
        L, H0, H1, T, dropout_threshold(rate), 1.0 / (1.0 - rate),
        None if mask_bits is None else mask_bits.data_ptr(),
        seed & 0xFFFFFFFFFFFFFFFF, groups,
        (ctypes.c_int * len(bounds))(*bounds),
        None if part is None else part[0].data_ptr(),
        None if part is None else part[1].data_ptr(),
        *[o.data_ptr() for o in outs], stream)
    check_launch(err, "fused_head_stats")
    fused_head_stats.launches += 1
    return tuple(outs)
