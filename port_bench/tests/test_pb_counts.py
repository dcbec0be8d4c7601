"""The frozen counts of the fused head against a count by hand."""

from port_bench import peaks
from port_bench.counts import fused_head


def test_macs_per_row_by_hand():
    # D 3, hidden 4, latent 2, head 5 and 6, T 2:
    # encoder 3*4 + 2*4*4 + 4*2 = 52; forward 2*5 + 5*6 + 6 = 46;
    # passes 2 * (5*6 + 6) = 72; backward 6*5 + 5*2 = 40
    assert fused_head.macs_per_row(3, 4, 2, 5, 6, 2) == 52 + 46 + 72 + 40
    assert fused_head.ops(7, 3, 4, 2, 5, 6, 2) == 2 * 7 * 210


def test_bytes_by_hand():
    # X 7 rows x 3 in bf16, weights 12 + 32 + 8 + 10 + 30 + 6 = 98 bf16,
    # biases 3*4 + 2 + 5 + 6 + 1 = 26 f32, four f32 outputs a row
    assert fused_head.bytes_moved(7, 3, 4, 2, 5, 6, itemsize=2) == (
        7 * 3 * 2 + 98 * 2 + 26 * 4 + 4 * 7 * 4)


def test_bench_shape_bound_matches_the_kernel_table():
    # the kernel table's bench-shape bounds (N 262,144, D 24): f32 7.634 ms
    # and bf16 0.517 ms, by operations
    ops = fused_head.ops(262144, 24, 256, 64, 256, 256, 10)
    assert round(1e3 * ops / peaks.FLOPS["float32"], 3) == 7.634
    assert round(1e3 * ops / peaks.FLOPS["bfloat16"], 3) == 0.517
