"""The fused head's kernels' share of their roofline on the bf16 split
route, in per cent, counted at the widths they are launched with: the
first encoder layer's [N, H] output in, the encoder's other layers
(``first_layer.py::kernel_bound_s``), over the kernels' device time per
phase (``fused_head_ms``). ``fused_head_roofline`` counts the first
layer's operations and the [N, D] rows as well, which on this route run
ahead of the kernel; this share leaves them out."""

from port_bench.first_layer import kernel_bound_s, kernel_ms


def read(ctx):
    ms = kernel_ms(ctx)
    if ms is None:
        return None
    return 100.0 * kernel_bound_s(ctx) / (ms * 1e-3)
