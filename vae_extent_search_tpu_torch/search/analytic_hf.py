"""High-fidelity analytic cost: a roofline model over per-store features
(a copy of ``vae_extent_search_tpu/search/analytic_hf.py``, plain numpy,
the same float64 expressions in the same order).

The base ``AnalyticRunner`` cost (search/measure.py) prices only coarse,
quantized schedule properties (parallel extent, vector length, innermost
tile volume), so large families of schedules collapse onto exact-cost
plateaus. This module prices what the per-store featuriser measures
(features/per_store.py): per-BufferStore op counts, vectorize / parallel /
thread structure and per-buffer touched bytes, cache lines and reuse
distances, so distinct schedules get distinct costs while staying
deterministic and machine-free. ``search/platforms.py`` gives each
platform its ``HFHardware``.

The cost is a deterministic function of the 164-dim per-store feature
matrix: corpora measured with it suit extent-feature arms, not the
training or evaluation of per-store-feature cost models, which would
only be fitting the function.

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

import numpy as np

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


def _unslog(v: np.ndarray) -> np.ndarray:
    """Exact inverse of the featurizer's slog for non-negative values."""
    return np.exp2(np.abs(v)) - 1.0


def hf_cost_from_features(feats: np.ndarray,
                          hw: HFHardware = DEFAULT_HW) -> float:
    """Roofline cost (seconds) of one program from its per-store
    feature matrix [n_stores, 164]. Returns +inf for the all-zero
    error-row convention (feature.py:114-116 analogue: unlowerable
    states featurize to a single zero row)."""
    f = np.asarray(feats, np.float64)
    if f.ndim != 2 or f.shape[0] == 0 or not np.any(f):
        return float("inf")

    r = _unslog

    # ---- compute side: weighted scalar-op work per store ----
    w_float = (r(f[:, F_FLOAT_ADD]) + r(f[:, F_FLOAT_MUL])
               + 2.5 * r(f[:, F_FLOAT_DIV]) + r(f[:, F_FLOAT_CMP])
               + 6.0 * r(f[:, F_FLOAT_MATH]))
    w_int = (r(f[:, F_INT_ADD]) + r(f[:, F_INT_MUL])
             + 2.5 * r(f[:, F_INT_DIV]) + r(f[:, F_INT_CMP])
             + 6.0 * r(f[:, F_INT_MATH]) + r(f[:, F_BOOL])
             + r(f[:, F_SELECT]))
    work = w_float + 0.3 * w_int          # addressing partly hidden

    is_gpu = f[:, F_IS_GPU] > 0.5

    # CPU vectorization: vectorized stores run up to ~0.85*VW faster;
    # over-long vectors spill (same shape as the base runner's rule)
    vec_len = r(f[:, F_VEC_LEN])
    vw = float(hw.vector_width)
    lane_eff = np.minimum(vec_len, vw) / vw
    spill = np.where(vec_len > 4 * vw, (4 * vw) / np.maximum(vec_len, 1.0),
                     1.0)
    vec_speed = np.where(vec_len >= 1.0,
                         1.0 + (vw - 1.0) * 0.85 * lane_eff * spill, 1.0)

    # CPU core parallelism: the featurizer's parallel_prod is the
    # product of parallel-annotated extents over the store's stack
    par_prod = r(f[:, F_PAR_PROD])
    cores = np.minimum(np.maximum(par_prod, 1.0), float(hw.num_cores))
    par_speed = np.where(par_prod > 1.0, 0.95 * cores, 1.0)

    # GPU: total resident parallelism with an occupancy ramp on block
    # size; work is already the grid-total op count (thread extents are
    # folded into outer_loop_prod per feature.cc:613-659 semantics)
    threads = (r(f[:, F_THREAD_X]) * r(f[:, F_THREAD_X + 1])
               * r(f[:, F_THREAD_X + 2]))
    blocks = (r(f[:, F_BLOCK_X]) * r(f[:, F_BLOCK_X + 1])
              * r(f[:, F_BLOCK_X + 2]))
    threads = np.maximum(threads, 1.0)
    blocks = np.maximum(blocks, 1.0)
    occupancy = 0.3 + 0.7 * np.minimum(threads, 768.0) / 768.0
    fill = np.minimum(blocks * threads, hw.gpu_max_par) / hw.gpu_max_par
    gpu_util = occupancy * np.minimum(1.0, 0.15 + 0.85 * fill)

    compute_t = np.where(
        is_gpu,
        work / (hw.gpu_peak_ips * gpu_util),
        work / (hw.scalar_ips * vec_speed * par_speed),
    )

    # instruction-cache pressure from huge unrolled bodies (the base
    # runner's >512 rule, smooth variant)
    au = r(f[:, F_AUTO_UNROLL])
    compute_t = compute_t * np.where(au > 512.0, 1.08, 1.0)

    # ---- memory side: per-buffer cache-hierarchy traffic ----
    log_l1 = np.log2(hw.l1_bytes)
    log_l2 = np.log2(hw.l2_bytes)
    log_ws = np.log2(hw.dram_ws_bytes)
    mem_t = np.zeros(f.shape[0])
    for b in range(N_BUFS):
        base = BUF_BASE + b * BUF_STRIDE
        block = f[:, base:base + BUF_STRIDE]
        present = np.any(block != 0.0, axis=1)
        lines = r(block[:, B_LINES])
        unique_lines = r(block[:, B_UNIQUE_LINES])
        rdb = r(block[:, B_REUSE_DIS_BYTES])
        # reuse distance -> miss ratios, piecewise-linear in log-bytes
        # (smooth, so tile-size changes move the cost continuously)
        t = np.log2(rdb + 1.0)
        miss_l2 = np.clip((t - log_l1) / (log_l2 - log_l1), 0.0, 1.0)
        miss_dram = np.clip((t - log_l2) / (log_ws - log_l2), 0.0, 1.0)
        hot = np.maximum(lines - unique_lines, 0.0) * hw.cache_line
        cold = unique_lines * hw.cache_line
        dram_b = cold + miss_dram * hot
        l2_b = np.maximum(miss_l2 - miss_dram, 0.0) * hot
        l1_b = hot
        t_cpu = (dram_b / hw.bw_dram                 # DRAM BW is shared
                 + l2_b / (hw.bw_l2 * par_speed)
                 + l1_b / (hw.bw_l1 * par_speed))
        t_gpu = (dram_b / hw.gpu_bw_dram
                 + (l2_b + l1_b) / hw.gpu_bw_smem)
        mem_t += np.where(present, np.where(is_gpu, t_gpu, t_cpu), 0.0)

    # roofline overlap per store, summed over stores
    per_store = (np.maximum(compute_t, mem_t)
                 + hw.overlap * np.minimum(compute_t, mem_t))
    total = float(np.sum(per_store)) + hw.launch_s
    return max(total, 1e-9)


def hf_costs_batch(feats_list, hw: HFHardware = DEFAULT_HW):
    """[n] costs for a list of per-store feature matrices (None or
    all-zero entries -> +inf)."""
    return [float("inf") if fm is None else hf_cost_from_features(fm, hw)
            for fm in feats_list]
