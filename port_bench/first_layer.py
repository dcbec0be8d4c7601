"""Readings of the bfloat16 fused head's split route: where the input is
wider than the first encoder layer's output (``vae_perstore``: D 820
against 256), the port runs that layer ahead of the fused head's kernel
as its own bf16 GEMM (``mm_bf16``, ``csrc/matmul.cu``) and launches the
kernel on the layer's [N, H] output with the other encoder layers
(``vae_extent_search_tpu_torch/ops/fused_head.py::split_first_layer``).

The layer runs in chunks of rows, each chunk four operations on the
phase's one stream, in this order (``ops/fused_head.py::_first_layer``):
the chunk's rows rounded into a bf16 buffer, the GEMM into float32 sums,
the bias added into bf16, the ReLU. The GEMM's name is the only one of
them that no other operation of a phase shares, so the layer's
operations are each GEMM with the one operation before it and the two
after it.

The port counts the launches that split in ``fused_head_stats.splits``.
A program without that counter, or one whose runs split nothing, gives
None for every reading here, as does a window without a GEMM.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from port_bench import peaks
from port_bench.counts import fused_head as counts
from port_bench.layers import _shape, fused_head_ms, is_fused

GEMM = "mm_bf16"
# operations of a chunk before and after its GEMM: the rounding copy;
# the bias add and the ReLU
BEFORE, AFTER = 1, 2


def split_ran(ctx) -> bool:
    from vae_extent_search_tpu_torch.ops import fused_head as fh

    return bool(getattr(fh.fused_head_stats, "splits", 0))


def _ops(ctx) -> List[Tuple[str, float, float]]:
    return sorted(ctx["trace"].clip(), key=lambda op: op[1])


def gemm_ms(ctx) -> Optional[float]:
    """Device milliseconds a phase of the first layer's GEMMs."""
    if not split_ran(ctx):
        return None
    ops = [(a, b) for n, a, b in _ops(ctx) if GEMM in n]
    if not ops:
        return None
    return 1e3 * sum(b - a for a, b in ops) / ctx["phases"]


def layer_ms(ctx) -> Optional[float]:
    """Device milliseconds a phase of the first layer's operations: each
    GEMM with its chunk's rounding copy, bias add and ReLU."""
    if not split_ran(ctx):
        return None
    ops = _ops(ctx)
    picked = set()
    for i, (name, _, _) in enumerate(ops):
        if GEMM in name:
            picked.update(j for j in range(i - BEFORE, i + AFTER + 1)
                          if 0 <= j < len(ops) and not is_fused(ops[j][0]))
    if not picked:
        return None
    return 1e3 * sum(ops[j][2] - ops[j][1] for j in picked) / ctx["phases"]


def _widths(ctx):
    s = _shape(ctx)
    return s, peaks.ITEMSIZE[ctx["config"]["compute_dtype"]]


def layer_bound_s(ctx) -> float:
    """The least time of the first layer's job: 2 N D H operations at the
    compute type's peak, or its bytes at the HBM peak, whichever is
    longer: the float32 rows of X read once, the weight and bias in the
    compute type read once, the [N, H] output written once."""
    s, item = _widths(ctx)
    N, D, H = s["N"], s["D"], s["H"]
    ops = 2 * N * D * H
    nbytes = N * D * 4 + (D * H + H) * item + N * H * item
    return max(ops / peaks.FLOPS[ctx["config"]["compute_dtype"]],
               nbytes / peaks.HBM_BYTES_PER_S)


def gemm_bound_s(ctx) -> float:
    """The least time of the GEMMs as launched: 2 N D H operations, or
    their bytes: the rounded rows [N, D] and the weight [D, H] in the
    compute type read once, the float32 sums [N, H] written once."""
    s, item = _widths(ctx)
    N, D, H = s["N"], s["D"], s["H"]
    ops = 2 * N * D * H
    nbytes = (N * D + D * H) * item + N * H * 4
    return max(ops / peaks.FLOPS[ctx["config"]["compute_dtype"]],
               nbytes / peaks.HBM_BYTES_PER_S)


def kernel_bound_s(ctx) -> float:
    """The least time of the fused head's kernels at the widths they are
    launched with on the split route: input the [N, H] first-layer output,
    the encoder's other layers (``counts/fused_head.py`` with D = H and
    one encoder layer fewer)."""
    s, item = _widths(ctx)
    s = dict(s, D=s["H"], enc_layers=s["enc_layers"] - 1)
    ops = counts.ops(T=ctx["config"]["T_mc"], **s)
    nbytes = counts.bytes_moved(itemsize=item, **s)
    return max(ops / peaks.FLOPS[ctx["config"]["compute_dtype"]],
               nbytes / peaks.HBM_BYTES_PER_S)


def kernel_ms(ctx) -> Optional[float]:
    """The fused head's kernels' device milliseconds a phase, on the split
    route only."""
    return fused_head_ms(ctx) if split_ran(ctx) else None
