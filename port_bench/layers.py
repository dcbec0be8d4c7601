"""Readings shared by the per-layer metrics (``layer_metrics/``)."""

from __future__ import annotations

from port_bench import peaks
from port_bench.counts import fused_head as counts

FUSED_KERNELS = ("fused_head_kernel", "mc_finish_kernel")


def is_fused(name: str) -> bool:
    return any(k in name for k in FUSED_KERNELS)


def device_ms(ctx, fused: bool):
    """Device milliseconds per phase of the fused head's operations
    (``fused``) or of all others; None where the trace holds none."""
    ops = [(a, b) for n, a, b in ctx["trace"].clip() if is_fused(n) == fused]
    if not ops:
        return None
    return 1e3 * sum(b - a for a, b in ops) / ctx["phases"]


def fused_head_ms(ctx):
    return device_ms(ctx, fused=True)


def _shape(ctx):
    c = ctx["config"]
    return dict(N=ctx["N"], D=c["input_dim"], H=c["hidden_dim"],
                L=c["latent_dim"], H0=c["predictor_hidden"],
                H1=c["predictor_hidden"], enc_layers=c["encoder_layers"])


def peak_flops(ctx) -> float:
    return peaks.FLOPS[ctx["config"]["compute_dtype"]]


def phase_ops(ctx) -> int:
    return counts.ops(T=ctx["config"]["T_mc"], **_shape(ctx))


def fused_head_bound_s(ctx) -> float:
    s = _shape(ctx)
    nbytes = counts.bytes_moved(
        itemsize=peaks.ITEMSIZE[ctx["config"]["compute_dtype"]], **s)
    return max(phase_ops(ctx) / peak_flops(ctx),
               nbytes / peaks.HBM_BYTES_PER_S)
