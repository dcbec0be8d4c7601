"""The whole phase's share of the card's peak, in per cent: the model's
operations in a phase (encoder, cost head, T MC-dropout passes and the
backward to z over every candidate, ``counts/fused_head.py``) over the
mean phase time of the unprofiled window, over the compute type's peak."""

from port_bench.layers import phase_ops, peak_flops


def read(ctx):
    if not ctx["timed"] or ctx["window_s"] <= 0:
        return None
    per_phase_s = ctx["window_s"] / len(ctx["timed"])
    return 100.0 * phase_ops(ctx) / per_phase_s / peak_flops(ctx)
