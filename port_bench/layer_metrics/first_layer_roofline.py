"""The first encoder layer's share of its roofline where the bf16 fused
head runs it ahead of its kernel, in per cent: the least time of the
layer's job (2 N D H operations, or the float32 rows read and the bf16
output written once; ``first_layer.py::layer_bound_s``) over its
measured device time per phase (``first_layer_ms``)."""

from port_bench.first_layer import layer_bound_s, layer_ms


def read(ctx):
    ms = layer_ms(ctx)
    if ms is None:
        return None
    return 100.0 * layer_bound_s(ctx) / (ms * 1e-3)
