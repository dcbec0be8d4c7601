"""Published dense peaks of one NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet, no sparsity): operations per second by compute
type, and HBM bytes per second."""

FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}
