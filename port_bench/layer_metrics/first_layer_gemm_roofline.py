"""The first encoder layer's GEMM (``mm_bf16``) share of its roofline
where the bf16 fused head runs that layer ahead of its kernel, in per
cent: the least time of the GEMMs as launched (2 N D H operations, or
the bf16 operands read and the float32 sums written once;
``first_layer.py::gemm_bound_s``) over their device time per phase."""

from port_bench.first_layer import gemm_bound_s, gemm_ms


def read(ctx):
    ms = gemm_ms(ctx)
    if ms is None:
        return None
    return 100.0 * gemm_bound_s(ctx) / (ms * 1e-3)
