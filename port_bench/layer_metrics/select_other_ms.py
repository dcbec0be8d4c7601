"""Device milliseconds per phase of every operation other than the fused
head's kernels: casts, top-k sorts, scatters, the k-center re-encode and
greedy loop, copies."""

from port_bench.layers import device_ms


def read(ctx):
    return device_ms(ctx, fused=False)
