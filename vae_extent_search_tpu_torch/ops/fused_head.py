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

float32 runs on the CUDA cores; bfloat16 runs every product on the
tensor cores (``mma.sync``), with W1 held in shared memory for the whole
block where it fits beside the rest and streamed through the weight ring
where it does not. :func:`smem_plan` chooses that route by shape before
the launch; ``fused_head_stats.routes`` counts the launches per route.
Where the input is wider than the first encoder layer's output, bfloat16
runs that layer ahead of the kernel as one tensor-core GEMM
(:func:`split_first_layer`), chosen by shape alone as well.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``vae_extent_search_tpu_torch/build/`` and loaded with ctypes through a
plain C interface (``ops/build.py``).

Numerics (both versions, as the JAX kernel): matmul operands are rounded
to the compute dtype (``dtype=``, else the input's; float32 or bfloat16)
and accumulated in float32; biases are rounded to the compute dtype and
added in float32, except ``b2``, which stays float32. Dropout keeps a
hidden unit of h0 when its 32-bit random word is ``>= min(int(rate *
2**32), 2**32 - 1)`` and scales kept units by ``1 / (1 - rate)``.
"""

from __future__ import annotations

import ctypes
import logging
from collections import OrderedDict
from functools import lru_cache
from itertools import accumulate
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.misc import span
from .build import MAX_SMEM_BYTES, CudaLibrary, check_launch, sm_count
from .matmul import TMA_ALIGN, matmul

BM = 32           # candidates per block (csrc/fused_head.cu)
MAX_GROUPS = 32   # grid rows the kernel takes
# the f32 instance's weight chunk (KC rows x CW columns, f32) and the
# bf16 instance's ring: NSTAGE stages of a KS x (256 + KP) weight chunk
# and a BM x KS input chunk, bf16, beside a [NWARP, BM] f32 row-sum
# scratch (csrc/fused_head.cu)
KC, CW = 16, 256
KS, KP, NSTAGE, NWARP = 16, 8, 3, 8
ROUTES = ("fma", "resident", "streamed")
# how far, in input ulps, a bf16 unit may lie from its ReLU kink for a
# flip of its mask to count as another summation order's (gnorm_errors):
# one flipped input rounding moves a unit by at most one input ulp, and
# the roundings another order flips upstream cascade through the encoder,
# so several inputs of a unit may be off at once (chip_smoke.py phase 2
# records how far the kink rows' units lay; PERF.md)
KINK_ULPS = 8
# the bf16 route's first encoder layer ahead of the kernel
# (split_first_layer): rows of x rounded and multiplied per chunk, and the
# bf16 matmul's block configuration (ops/matmul.py; one 128 x 256 tile of
# the layer's output per block)
SPLIT_ROWS = 65536
SPLIT_BLOCK = (128, 256, 64)

_log = logging.getLogger(__name__)


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_head_stats_launch.argtypes = [
        i32, vp, ctypes.c_longlong, i32, i32, vp, vp, vp,
        vp, vp, vp, vp, vp, vp, vp, vp,
        i32, i32, i32, i32, ctypes.c_uint, ctypes.c_float,
        vp, ctypes.c_ulonglong, i32, vp, vp, vp, vp, vp, vp, vp, i32, vp]
    lib.fused_head_stats_launch.restype = i32
    lib.fused_head_smem_bytes.argtypes = [i32]
    lib.fused_head_smem_bytes.restype = ctypes.c_size_t
    lib.fused_head_bf16_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.fused_head_bf16_smem_bytes.restype = ctypes.c_size_t
    lib.fused_head_bf16_w0_resident.argtypes = [i32, i32, i32, i32]
    lib.fused_head_bf16_w0_resident.restype = i32
    lib.fused_head_attr_calls.argtypes = []
    lib.fused_head_attr_calls.restype = i32


LIB = CudaLibrary("fused_head", _declare)


def dropout_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _forward_plain(head_layers: List[Dict], x: torch.Tensor,
                   encoder: Optional[Tuple] = None):
    """The deterministic forward of :func:`fused_head_passes_plain`:
    (rnd, z, a0, a1, cost, (w0, w1, w2, b1, b2)), rnd rounding to the
    compute dtype and back, z the head's input before its rounding."""
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
    a1 = rnd(torch.relu(a0)) @ w1 + b1
    cost = rnd(torch.relu(a1)) @ w2 + b2
    return rnd, z, a0, a1, cost, (w0, w1, w2, b1, b2)


def _gnorm_plain(rnd, keep0, keep1, w0, w1, w2):
    """|dz cost| from the head's ReLU masks keep0 = [a0 > 0], keep1 =
    [a1 > 0]."""
    zero = torch.zeros((), dtype=torch.float32, device=w0.device)
    g1 = torch.where(keep1, w2, zero)
    g0 = torch.where(keep0, rnd(g1) @ w1.T, zero)
    gz = rnd(g0) @ w0.T
    return torch.sqrt((gz * gz).sum(-1))


def fused_head_passes_plain(head_layers: List[Dict], x: torch.Tensor,
                            T: int, rate: float,
                            mask_bits: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            encoder: Optional[Tuple] = None):
    """(cost, gnorm, deltas): the arguments and the first two outputs of
    :func:`fused_head_stats_plain`, and the T passes' deltas from the
    cost, a list of [N] float32, in pass order."""
    f32 = torch.float32
    rnd, _, a0, a1, cost, (w0, w1, w2, b1, b2) = _forward_plain(
        head_layers, x, encoder)
    h0 = torch.relu(a0)
    zero = torch.zeros((), dtype=f32, device=x.device)
    gnorm = _gnorm_plain(rnd, a0 > 0, a1 > 0, w0, w1, w2)

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


def first_layer_plain(layer: Dict, x: torch.Tensor,
                      ct: torch.dtype) -> torch.Tensor:
    """rnd(ReLU(rnd(x) @ rnd(w) + rnd(b))) [N, H] in ``ct``: the first
    encoder layer as the split route computes it ahead of the kernel
    (:func:`split_first_layer`), products summed in float32 and rounded
    once. :func:`fused_head_stats_plain` on it with the encoder's other
    layers equals the unsplit call bit for bit."""
    def rnd(t):
        return t.to(ct).to(torch.float32)

    return torch.relu(rnd(x) @ rnd(layer["w"]) + rnd(layer["b"])).to(ct)


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


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at v >= 0 (8 significant bits; 0 at 0)."""
    _, e = torch.frexp(v)
    return torch.where(v > 0, torch.ldexp(torch.ones_like(v), e - 8),
                       torch.zeros_like(v))


def gnorm_kink_flips_plain(head_layers: List[Dict], x: torch.Tensor,
                           encoder: Optional[Tuple] = None,
                           nearest: int = 8):
    """(gnorm, |a|, ulps) of each row of ``x`` with one or two of its
    ``nearest`` head units closest to their ReLU kink taken to the other
    side, alone and in pairs, each [N, M] float32, M = nearest + nearest *
    (nearest - 1) / 2: the plain gnorm under that flip, the largest
    |pre-activation| among the flipped units, and the largest distance of
    one of them from its kink in input ulps.

    gnorm is discontinuous at a kink. A summation order other than this
    version's (the tensor cores' m16n8k16 steps) can flip a bf16 rounding
    of one of a unit's inputs, which moves the unit's pre-activation by
    |w| times one bf16 ulp of that input; a unit that close to 0 then
    changes its mask and gnorm jumps by a few per cent. The plain version
    summed in float64 differs from it on such rows too. A unit's input ulp
    is one bf16 ulp of its layer's largest input on the row (|rnd(z)| for
    a0, rnd(h0) for a1) times its largest |weight|; the units nearest
    their kink are those with the fewest input ulps |a| / input ulp."""
    rnd, z, a0, a1, _, (w0, w1, w2, _, _) = _forward_plain(
        head_layers, x, encoder)
    pre = torch.cat([a0, a1], 1)

    def input_ulp(u, w):  # [N, units] of the layer u @ w
        return _bf16_ulp(u.abs().amax(1, keepdim=True)) * w.abs().amax(0)

    unit = torch.cat([input_ulp(rnd(z), w0),
                      input_ulp(rnd(torch.relu(a0)), w1)], 1)
    ulps = torch.where(unit > 0, pre.abs() / unit,
                       torch.full_like(pre, float("inf")))
    k = min(nearest, pre.shape[1])
    near = ulps.topk(k, dim=1, largest=False).indices  # [N, k]
    sets = [(i,) for i in range(k)] + [
        (i, j) for i in range(k) for j in range(i + 1, k)]
    keep = (pre > 0)[:, None, :].repeat(1, len(sets), 1)  # [N, M, H0 + H1]
    a_abs = torch.zeros(x.shape[0], len(sets), device=x.device)
    a_ulps = torch.zeros_like(a_abs)
    rows = torch.arange(x.shape[0], device=x.device)
    for m, units in enumerate(sets):
        for i in units:
            keep[rows, m, near[:, i]] ^= True
            a_abs[:, m] = torch.maximum(a_abs[:, m],
                                        pre[rows, near[:, i]].abs())
            a_ulps[:, m] = torch.maximum(a_ulps[:, m], ulps[rows, near[:, i]])
    H0 = a0.shape[1]
    flat = keep.reshape(-1, keep.shape[2])
    gnorm = _gnorm_plain(rnd, flat[:, :H0], flat[:, H0:], w0, w1,
                         w2).reshape(x.shape[0], len(sets))
    return gnorm, a_abs, a_ulps


class GnormCheck(NamedTuple):
    err: float              # max relative error, kink rows as explained
    kinks: int              # rows explained by a flip at a kink
    # over those rows, of the flip nearest the kink that explains each:
    flipped_abs_max: float  # the largest |pre-activation| flipped
    flipped_ulps_max: float  # the largest distance in input ulps


def gnorm_errors(got: torch.Tensor, ref: torch.Tensor,
                 head_layers: List[Dict], x: torch.Tensor,
                 encoder: Optional[Tuple] = None,
                 tol: float = 2e-2) -> GnormCheck:
    """A bfloat16 kernel's gnorm ``got`` against the plain version's
    ``ref``, relative to max |ref|. A row off by more than ``tol`` counts
    as at a kink when the plain gnorm with one or two of its units nearest
    their kink flipped (:func:`gnorm_kink_flips_plain`), each within
    ``KINK_ULPS`` input ulps of it, is within ``tol`` of it, and is then
    measured against that value; any other row counts as it is."""
    scale = ref.abs().max().clamp_min(1e-12)
    err = (got - ref).abs() / scale
    off = (err > tol).nonzero()[:, 0]
    kinks, a_max, u_max = 0, 0.0, 0.0
    if len(off):
        alt, a_abs, a_ulps = gnorm_kink_flips_plain(head_layers, x[off],
                                                    encoder)
        alt_err = (alt - got[off, None]).abs() / scale
        alt_err = torch.where(a_ulps <= KINK_ULPS, alt_err,
                              torch.full_like(alt_err, float("inf")))
        err[off] = torch.minimum(err[off], alt_err.min(1).values)
        ok = alt_err <= tol
        hit = ok.any(1)
        kinks = int(hit.sum())
        if kinks:
            need, m = torch.where(ok, a_ulps, torch.full_like(
                a_ulps, float("inf"))).min(1)
            rows = torch.arange(len(off), device=got.device)[hit]
            a_max = float(a_abs[rows, m[hit]].max())
            u_max = float(need[hit].max())
    return GnormCheck(float(err.max()), kinks, a_max, u_max)


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


def snap_fused_groups(N: int, T: int, block: int, tc: int) -> int:
    """The group count G that :func:`fused_head_stats` takes (``groups=``)
    for a raw tuner config ``(block, tc)`` (counterpart of the JAX
    package's ``snap_fused_config``): one group for the T passes where the
    MC chunk ``tc`` covers them all, else one group for the backward and
    ceil(T / tc) groups of at most ``tc`` passes each, clamped to [1,
    min(T + 1, MAX_GROUPS)]. Raw configs that run the same kernel map onto
    one G, so they share one measurement. ``block`` maps onto nothing: the
    kernel's candidate tile is fixed at ``BM``; ``N`` is taken for the
    JAX signature's sake and does not change G."""
    tc = max(1, int(tc))
    groups = 1 if tc >= T else 1 + -(-T // tc)
    return max(1, min(groups, T + 1, MAX_GROUPS))


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(route: str, width: int, H0: int, H1: int) -> int:
    """Shared memory per block of the kernel on ``route`` where ``width``
    is the largest hidden width (the encoder's outputs, L, H0, H1 and at
    least 16; the input width D streams and bounds nothing). ``fma``: the
    f32 instance's three [width, BM] f32 activation buffers, its weight
    chunk and row sums. ``resident`` / ``streamed``: the bf16 instance's
    three [BM, width + KP] bf16 activation buffers (rows padded to 16: the
    encoder's pair, then rnd(h0) or a pass's masked units, and g1;
    rnd(h0 * scale)), the row sums and the ring, and on ``resident`` W1
    [H0, H1 + KP] bf16 (mirrors ``fused_head_smem_bytes`` and
    ``fused_head_bf16_smem_bytes`` of ``csrc/fused_head.cu``)."""
    if route == "fma":
        return 4 * (3 * _up(width, 4) * BM + KC * CW + 4 * BM)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    lda = _up(width, 16) + KP
    total = (3 * 2 * BM * lda + 4 * NWARP * BM
             + 2 * NSTAGE * (KS * (CW + KP) + BM * KS))
    if route == "resident":
        total += 2 * _up(H0, 16) * (_up(H1, 16) + KP)
    return total


def w0_resident(L: int, H0: int, H1: int) -> bool:
    """Whether the bf16 instance on the ``resident`` route reads W0 for
    gz from a copy in W1's shared-memory region (W0 [L, H0 + KP] fits
    where W1 [H0, H1 + KP] was), so that it needs no W0^T (mirrors
    ``fused_head_bf16_w0_resident`` of ``csrc/fused_head.cu``)."""
    return _up(L, 16) * (_up(H0, 16) + KP) <= _up(H0, 16) * (_up(H1, 16) + KP)


def split_first_layer(bf16: bool, d: int, enc_widths: Sequence[int]) -> bool:
    """Whether the kernel's wrapper runs the first encoder layer ahead of
    the kernel, as one tensor-core GEMM over all rows (:func:`_first_layer`),
    and launches the kernel on its output with the other layers. ``d`` is
    the input width, ``enc_widths`` the output widths of the encoder's
    layers, fc_mu last. bfloat16 only, where an encoder layer precedes
    fc_mu and ``d`` exceeds its width: a 32-row block of the kernel stages
    each weight it reads once from L2 and uses it for only 32 rows, so a
    wide first layer costs the kernel far more than its operations; the
    GEMM's 128 x 256 tiles read it once per 128 rows, and the kernel then
    reads the narrower [N, width] output instead of x. float32 never
    splits: its CUDA-core kernel is paced by its operations, which a
    split would not reduce."""
    return bf16 and len(enc_widths) >= 2 and d > enc_widths[0]


@lru_cache(maxsize=1024)
def smem_plan(bf16: bool, width: int, H0: int, H1: int) -> Tuple[str, int]:
    """(route, shared-memory bytes per block) the kernel takes for these
    widths (see :func:`smem_bytes`), chosen by shape alone before any
    launch. float32 has one route, ``fma`` (the CUDA cores). bfloat16
    takes ``resident`` (W1 loaded into shared memory once per block and
    read by all 12 of its products) where that fits a block's
    ``MAX_SMEM_BYTES``, else ``streamed`` (W1 and W1^T through the weight
    ring, as the other weights). Raises ValueError where no route fits."""
    for route in (("resident", "streamed") if bf16 else ("fma",)):
        nbytes = smem_bytes(route, width, H0, H1)
        if nbytes <= MAX_SMEM_BYTES:
            return route, nbytes
    raise ValueError(f"hidden width {width} needs {nbytes} bytes of shared "
                     f"memory per block (> {MAX_SMEM_BYTES})")


# the groups' sums [2, G, N] per (device, stream, G, N)
_SCRATCH = OrderedDict()
# (bf16, width, H0, H1) whose route was logged
_PLANS_SEEN = set()
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
                     groups: Optional[int] = None,
                     dtype: Optional[torch.dtype] = None):
    """cost, gnorm, mc_mean, mc_var — each [N] float32 — for a
    2-hidden-layer ReLU cost head over ``x``: latents [N, L], or raw
    features [N, D] with ``encoder=(encoder_layers, fc_mu)`` run first.
    ``dtype`` is the compute dtype, ``x``'s own where None; a float32
    ``x`` is rounded to it as it is read (``x.to(dtype)``), so a caller
    need not cast the whole of it.

    Where :func:`split_first_layer` holds (bfloat16, the input wider than
    the first encoder layer's output), the first encoder layer runs ahead
    of the kernel as one tensor-core GEMM per chunk of ``SPLIT_ROWS`` rows
    (:func:`_first_layer`: each chunk rounded to bfloat16, multiplied with
    ``ops/matmul.py::matmul``, the bias added to the float32 sums, one
    rounding, ReLU), and the kernel runs on that [N, width] output with
    the other encoder layers and fc_mu, under the unsplit kernel's
    contract (:func:`first_layer_plain`).

    On a CUDA tensor this launches the CUDA kernel on the current stream,
    and where the plan has G > 1 groups the kernel that adds their sums
    (``fused_head_stats.launches`` counts one per call,
    ``fused_head_stats.routes`` one per call under its :func:`smem_plan`
    route, ``fused_head_stats.splits`` one per call that ran the first
    encoder layer ahead of the kernel); ``groups`` replaces :func:`launch_plan`'s G (a tuned G, or
    timing and tests). Under a running profiler the host's work of a CUDA
    call (checks, weight casts and transposes, the launch plan, the
    library call) is the range "fused_head.launch".
    ``fused_head_stats.tap``, where set, is called with ``(x, T, groups)``
    first, on either device. The dropout
    words are ``mask_bits`` [T, N, H] uint32 when given, else Philox bits
    from ``seed``. On a CPU tensor it runs :func:`fused_head_stats_plain`,
    with ``mask_bits`` or a CPU generator seeded by ``seed``."""
    if len(head_layers) != 3:
        raise ValueError("the kernel is specialized to 2 hidden layers")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if fused_head_stats.tap is not None:
        fused_head_stats.tap(x, T, groups)
    ct = x.dtype if dtype is None else dtype
    if x.device.type == "cpu":
        gen = None
        if mask_bits is None:
            gen = torch.Generator().manual_seed(int(seed))
        return fused_head_stats_plain(head_layers, x.to(ct), T, rate,
                                      mask_bits, gen, encoder)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    with span("fused_head.launch"):
        return _launch(head_layers, x, ct, int(seed), T, rate, mask_bits,
                       encoder, groups)


fused_head_stats.launches = 0
fused_head_stats.routes = dict.fromkeys(ROUTES, 0)
fused_head_stats.splits = 0
fused_head_stats.tap = None


def _first_layer(x: torch.Tensor, layer: Dict, ct: torch.dtype
                 ) -> torch.Tensor:
    """h [N, H] in ``ct`` = rnd(ReLU(rnd(x) @ rnd(w) + rnd(b))) on the
    card (:func:`first_layer_plain`'s numbers, summed in the GEMM's order),
    ``SPLIT_ROWS`` rows of ``x`` at a time: a chunk is rounded into a
    [rows, D] buffer whose row length is padded to the GEMM's 16-byte
    multiple with zero columns (so the matmul stages no copy of it), then
    multiplied into float32 sums, which take the bias and one rounding into
    h, then ReLU. No copy of the whole ``x`` in ``ct`` is made."""
    n, d = x.shape
    dp = _up(d, TMA_ALIGN)
    w = layer["w"].to(ct)
    if dp != d:
        w = torch.nn.functional.pad(w, (0, 0, 0, dp - d))
    w = w.contiguous()
    if w.data_ptr() % 16:
        w = w.clone()
    b = layer["b"].to(ct).to(torch.float32)
    h = torch.empty(n, w.shape[1], dtype=ct, device=x.device)
    rows = min(n, SPLIT_ROWS)
    buf = torch.empty(rows, dp, dtype=ct, device=x.device)
    if dp != d:
        buf[:, d:].zero_()
    for r in range(0, n, rows):
        m = min(rows, n - r)
        a = buf[:m]
        a[:, :d].copy_(x[r:r + m])  # rounds to nearest even, as x.to(ct)
        # the bias added in float32 and rounded into h, then ReLU on the
        # rounded values (rounding is monotonic and keeps 0, so this is
        # rnd(ReLU(s)); two passes over h, none over the float32 sums)
        hr = h[r:r + m]
        torch.add(matmul(a, w, *SPLIT_BLOCK), b, out=hr).relu_()
    return h


def _launch(head_layers, x, ct, seed, T, rate, mask_bits, encoder, groups):
    dev = x.device
    if ct not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {ct}")
    if x.dim() != 2:
        raise ValueError("x must be an [N, D] tensor")
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

    bf16 = ct == torch.bfloat16
    if n and split_first_layer(bf16, d, [l["w"].shape[1] for l in enc]):
        x, enc = _first_layer(x, enc[0], ct), enc[1:]
        d = x.shape[1]
        fused_head_stats.splits += 1
    elif x.dtype != ct:
        x = x.to(ct).contiguous()
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous [N, D] tensor")

    # the input width d streams from device memory; the hidden widths
    # live in shared memory
    width = max(*[l["w"].shape[1] for l in enc], L, H0, H1, 16)
    plan_key = (bf16, width, H0, H1)
    seen = plan_key in _PLANS_SEEN
    route, smem = smem_plan(*plan_key)
    if not seen:
        _PLANS_SEEN.add(plan_key)
        _log.info("fused_head_stats: %s widths (%d, H0 %d, H1 %d): route "
                  "%s, %d bytes of shared memory per block",
                  "bfloat16" if bf16 else "float32", width, H0, H1, route,
                  smem)
    lib = LIB.load()
    if n == 0:
        e = torch.empty(0, dtype=torch.float32, device=dev)
        return e, e.clone(), e.clone(), e.clone()
    if groups is None:
        groups, bounds = launch_plan(n, T, sm_count(dev))
    else:
        bounds = pass_bounds(T, groups)

    def w_(t):  # weights in the compute dtype, row-major [in, out],
        # 16-byte aligned (the bf16 instance copies rows by cp.async)
        t = t.to(ct).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    enc_w = [w_(l["w"]) for l in enc]
    w0, w1 = w_(head_layers[0]["w"]), w_(head_layers[1]["w"])
    w2 = w_(head_layers[2]["w"].reshape(-1))
    # biases rounded to the compute dtype, passed as f32, converted in one
    # go (a call stays a handful of launches where the kernel is short)
    biases = [l["b"] for l in [*enc, *head_layers[:2]]]
    flat = torch.cat([b.reshape(-1) for b in biases]).to(ct).to(
        torch.float32)
    *enc_b, b0, b1 = flat.split([b.numel() for b in biases])
    b2 = head_layers[2]["b"].to(torch.float32).contiguous()
    # W0^T and W1^T only where they are read: the resident route reads
    # W1's shared copy [n][k] instead, and W0's where it fits
    w0t = None if route == "resident" and w0_resident(L, H0, H1) \
        else w0.t().contiguous()
    w1t = None if route == "resident" else w1.t().contiguous()
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
        w2.data_ptr(), b2.data_ptr(),
        None if w0t is None else w0t.data_ptr(),
        None if w1t is None else w1t.data_ptr(),
        L, H0, H1, T, dropout_threshold(rate), 1.0 / (1.0 - rate),
        None if mask_bits is None else mask_bits.data_ptr(),
        seed & 0xFFFFFFFFFFFFFFFF, groups,
        (ctypes.c_int * len(bounds))(*bounds),
        None if part is None else part[0].data_ptr(),
        None if part is None else part[1].data_ptr(),
        *[o.data_ptr() for o in outs], int(route == "resident"), stream)
    check_launch(err, "fused_head_stats")
    fused_head_stats.launches += 1
    fused_head_stats.routes[route] += 1
    return tuple(outs)
