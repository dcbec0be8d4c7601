"""The fused head's share of its roofline, in per cent: the least time the
card could take for a phase's launch (the larger of its operations over
the compute type's peak and its bytes over the HBM peak, counted by
``counts/fused_head.py`` at the cell's shapes) over its measured device
time per phase."""

from port_bench.layers import fused_head_bound_s, fused_head_ms


def read(ctx):
    ms = fused_head_ms(ctx)
    if ms is None:
        return None
    return 100.0 * fused_head_bound_s(ctx) / (ms * 1e-3)
