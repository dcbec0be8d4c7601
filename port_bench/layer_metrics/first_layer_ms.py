"""Device milliseconds per phase of the first encoder layer where the
bf16 fused head runs it ahead of its kernel (``first_layer.py``): each
chunk's rounding copy, GEMM, bias add and ReLU. These operations fall
in ``select_other_ms`` too."""

from port_bench.first_layer import layer_ms


def read(ctx):
    return layer_ms(ctx)
