"""High-fidelity analytic cost model: the port's part of it.

A partial copy of ``vae_extent_search_tpu/search/analytic_hf.py``: the
per-store feature-index constants, the roofline constants ``HFHardware``
and ``DEFAULT_HW``, which ``search/platforms.py`` gives each platform.
The analytic cost itself (the roofline over the 164 per-store features
and the runner that prices schedules with it) is not ported yet: it is
queued with the JAX package's analytic runners (ROADMAP queue 1 #3).

Feature-vector layout (extract_store_features order, 164 floats, all
slog = sign(x)*log2(|x|+1) except one-hots and the AI curve):

    0-15   group 1 op counts (x outer_loop_prod)
    16-26  vectorize [num, prod, len] + 8 pos one-hot
    27-37  unroll    [num, prod, len] + 8 pos one-hot
    38-48  parallel  [num, prod, len] + 8 pos one-hot
    49     is_gpu; 50-56 blockIdx.xyz, threadIdx.xyz, vthread lens
    57+18b per-buffer block b of 5: [acc one-hot(3), bytes,
           unique_bytes, lines, unique_lines, reuse one-hot(3),
           reuse_dis_iter, reuse_dis_bytes, reuse_ct, 4x /reuse_ct
           variants, stride]
    147-156 arithmetic-intensity curve
    157-160 alloc; 161 outer_prod; 162 num_loops; 163 auto_unroll
"""

from __future__ import annotations

from dataclasses import dataclass

# group-1 op-count slots
F_FLOAT_ADD, F_FLOAT_MUL, F_FLOAT_DIV, F_FLOAT_CMP, F_FLOAT_MATH = 1, 2, 3, 4, 5
F_INT_ADD, F_INT_MUL, F_INT_DIV, F_INT_CMP, F_INT_MATH = 8, 9, 10, 11, 12
F_BOOL, F_SELECT = 14, 15
F_VEC_NUM, F_VEC_PROD, F_VEC_LEN = 16, 17, 18
F_PAR_NUM, F_PAR_PROD, F_PAR_LEN = 38, 39, 40
F_IS_GPU = 49
F_BLOCK_X, F_THREAD_X = 50, 53          # .x/.y/.z consecutive
F_VTHREAD = 56
BUF_BASE, BUF_STRIDE, N_BUFS = 57, 18, 5
B_BYTES, B_UNIQUE_BYTES, B_LINES, B_UNIQUE_LINES = 3, 4, 5, 6
B_REUSE_DIS_BYTES = 11
F_OUTER_PROD, F_NUM_LOOPS, F_AUTO_UNROLL = 161, 162, 163


@dataclass(frozen=True)
class HFHardware:
    """Roofline constants. Defaults model a small AVX CPU (the same
    machine class as the base runner's peak_gflops=100/8-core default)
    and a K80-class GPU — chosen for plausible *relative* pricing, not
    absolute accuracy."""

    # CPU
    scalar_ips: float = 6e9          # scalar op issue rate per core
    vector_width: int = 16           # f32 lanes
    num_cores: int = 8
    bw_dram: float = 30e9            # shared across cores
    bw_l2: float = 250e9             # per-core-ish (scaled by par)
    bw_l1: float = 1000e9
    l1_bytes: float = 32 * 1024
    l2_bytes: float = 1 * 1024 * 1024
    dram_ws_bytes: float = 256 * 1024 * 1024   # miss ramp endpoint
    cache_line: float = 64.0
    # GPU
    gpu_peak_ips: float = 2e12       # total scalar-op throughput
    gpu_max_par: float = 26624.0     # SMs x resident threads (K80-ish)
    gpu_bw_dram: float = 160e9
    gpu_bw_smem: float = 1200e9
    gpu_smem_bytes: float = 48 * 1024
    launch_s: float = 1e-6
    # imperfect compute/memory overlap: real machines never hide the
    # non-dominant side completely, and a hard max() collapses schedules
    # that differ only off the roofline edge onto cost ties (measured:
    # 50% -> 91% distinct costs on a 4k conv2d pool at 0.1, optimum
    # plateau 4 -> 1)
    overlap: float = 0.1


DEFAULT_HW = HFHardware()
