"""Device milliseconds per phase of the fused head's kernels
(``fused_head_kernel`` and ``mc_finish_kernel``, ``csrc/fused_head.cu``),
from the traced window."""

from port_bench.layers import fused_head_ms


def read(ctx):
    return fused_head_ms(ctx)
