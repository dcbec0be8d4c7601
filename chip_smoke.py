"""On-card smoke test of the PyTorch/CUDA port (needs one NVIDIA GPU).

    python3 chip_smoke.py              # every phase; ends with the result line
    python3 chip_smoke.py --only head  # phases 1-6 alone, for work on the
                                       # fused head; ends {"partial": "head"}
    python3 chip_smoke.py --only arms  # phases 1 and 20 alone, for work on
                                       # the experiment's other arms; ends
                                       # {"partial": "arms"}
    python3 chip_smoke.py --only conv_f32  # phase 1, then the f32 conv2d's
                                       # part of phases 12 and 14; ends
                                       # {"partial": "conv_f32"}
    python3 chip_smoke.py --only networks  # phases 1 and 21 alone, for work
                                       # on the network-level evaluation;
                                       # ends {"partial": "networks"}

Phases, in order; any failure exits non-zero and prints no result line:
  1. device and build: the card's name and power limit; nvcc builds the
     five kernels from csrc/ for sm_90a, one nvcc per source, started
     together; no fused_head_kernel instance and no f32 matmul or conv2d
     instance may spill registers (ptxas; each f32 instance's registers
     printed); cuobjdump -sass shows HGMMA (wgmma) in every bf16 matmul
     instance and HMMA (mma.sync) in every bf16 conv2d instance, and
     neither in the f32 instances, and LDGSTS (cp.async) in every f32
     matmul and conv2d instance; it prints the histogram kernel's atomic
     instructions, which must all be 32-bit shared-memory adds (ATOMS.ADD):
     no compare-and-swap loop and no global atomic or reduction
  2. kernel vs plain torch version with injected dropout bits, at the
     main path's shape (the committed pool: N=773, D=17, T=10; the launch
     plan splits the passes over grid groups) and at the bench shape
     (N=262,144, D=24, H=256, L=64, T=10, rate 0.1; one group), float32
     and bfloat16, and at the main shape with T=7, whose plan gives pass
     groups of unequal length; two launches bit-identical at G > 1
  3. the in-kernel Philox path: cost and gnorm equal the injected-bits
     run bit for bit (bench and main shapes); the mean MC variance and the
     mean MC offset (mc_mean - cost) are within 5% of the plain version fed
     torch-Generator bits
  4. the kernel's device time by the card timer
     (search/kernel_tuner.py::cuda_seconds; the host's ms per call beside),
     the plain version's by back-to-back CUDA events, and the bound,
     and at the main shape in float32 the kernel at every G from 1 to T
     (G = 1: the grid of 25 tiles alone)
  5. one full select_programs phase at the bench shape (bfloat16)
  6. end to end: the active search on the committed pool at full width
     (hidden 256, latent 64, T 10, measure size 32, 500 VAE epochs, 1000
     predictor epochs) for seed 2002 (2000 and 2001 cut for the time
     limit, PHASE6_SEEDS); every seed must find the
     optimum, and every selection phase must have gone through the kernel
  7. the histogram kernel vs its plain version in float64 at the
     pretraining shape (the corpus of data/boost_corpus.py: 1,000,000 rows
     x 164 features, 256 bins, the first round's gradient, a non-constant
     hessian) at every level (m = 1, 2, ..., 32 nodes), at an odd shape
     (n 700, d 9, m 4, nb 40) and at one feature whose rows lie in 2 bins
     (m 1 and 32): equal bit for bit to the plain fixed-point version,
     within 1e-5 of max |H| of the plain version in float64, and two
     launches bit-identical
  8. histogram times with CUDA events at every level (m = 1 ... 32) beside
     the earlier 64-bit-atomic kernel's recorded times, the byte bound, the
     plain version and the index_add_
     yardstick; and with every feature's rows in 2 bins at m = 1 and 32
  9. GBDT pretraining at full width: GBDTModelInternal.fit_base on that
     corpus (depth 6, eta 0.2, pack-sum objective, tr-rmse and a-peak@1)
     on the device engine for 50 rounds (cut from 300 with early stopping
     for the time limit): 6 kernel launches per round, and 3 rounds on a
     50,000-row subset agree with the numpy grower (pack-prediction
     correlation > 0.999). fit_base is timed whole, and its rounds alone
     by a second run of the device engine, which must grow the same
     trees, on phase 7's binned corpus; the kernel is held and timed on
     the first tree's own six launches (skewed node sizes). At ~20 rows per
     program the protocol's rmse grows on either engine
     (data/boost_corpus.py says why), so the same fit on the generator's
     4-rows-per-program corpus, with engine "auto", must go through the
     kernel and show a falling tr-rmse
 10. the gbdt arm end to end on the committed pool (measure size 32, seeds
     2000-2002, device engine): every seed must find the optimum, and
     every phase must have grown its 100 trees through the kernel; at each
     level, the first phase's launch whose rows lie in the most nodes is
     held against the plain version as in phase 7
 11. the matmul kernels (csrc/matmul.cu) vs their plain version: every
     template instance the library lists (each bf16 wgmma instance at each
     bk on a shape no tile divides; each f32 (bm, bn) instance at a shape
     no tile divides and at one whose K and N are off a multiple of 4,
     staged zero-padded), lattice configs of 1536^3 and of odd shapes, K
     or N off a multiple of 8 in bf16 (7 x 33 x 5, 64 x 64 x 20: staged
     zero-padded), in float32 (rel tol 1e-5) and bfloat16 (rel 1e-5
     against the f32 plain version of the same bf16 inputs); two launches
     bit-identical; A = identity gives C == B exactly at every bf16 and
     every f32 instance and at the two unaligned bf16 shapes; the plain
     version's time beside the bound at 1536^3 bf16 (the kernel's and
     cuBLAS's come from phase 13); then, with
     torch.backends.cuda.matmul.allow_tf32 set False (and printed), the
     sweep of the whole f32 lattice at 1536^3, each config held against
     the plain version and timed by the card timer, beside torch.matmul
     in f32 and the f32 bound
 12. the same for the conv2d kernels (csrc/conv2d.cu): every bf16 mma.sync
     warp tile and every f32 (BM, BN) instance (each at KW 3 and KW 1: its
     two kernels), the JAX tests' shapes and 1 x 56 x 56 x 256 -> 256, 3 x
     3, pad 1, ragged edges (boh, bco, bci not dividing OH, CO, CI), the
     bf16 element-load path (CI not a multiple of 8), f32 CI and CO off a
     multiple of 4 (staged zero-padded), OW 150 and N > 1, each within 1e-5
     of the plain version; the f32 shifted delta (w the identity at tap
     (0, 0), pad 1) exact at every f32 instance; then, beside cuDNN in f32
     with TF32 off, the plain version and the f32 bound, the sweep of the
     whole f32 lattice (56 boh x 4 bco x 3 bci = 672 configs) at that
     shape, each config held and timed like the tuner's
 13. self-tuning end to end: cli.tune_kernel on the matmul at the JAX
     defaults (1536^3 bf16, 1,000 candidates, measure size 16, 6 phases,
     VAE 500 epochs, predictor 1000 epochs), --arm model then --arm
     random, then --dtype float32 --arm random (the f32 CUDA-core kernel's
     path: its best config beside torch.matmul in f32 and the phase 11
     sweep's fastest); every timed config went through the kernel (its launch count
     grew), none failed to launch, the record log holds every measured
     state; the best config against cuBLAS. Kernel and library times are
     device times (search/kernel_tuner.py::cuda_seconds: the calls queued
     behind a blocking product), the host's ms per call beside. Then a
     sweep of the bf16 lattice at 1536^3 (every (bm, bn) at bk 64), each
     config checked and timed the same way: the lattice's fastest config
     beside the tuned one
 14. the same for conv2d at 1 x 56 x 56 x 256 -> 256, 3 x 3, pad 1, bf16,
     against cuDNN; its sweep takes the grid CONV_SWEEP; then --dtype
     float32 --arm random (the f32 CUDA-core kernel's path: its best config
     beside cuDNN in f32 and the phase 12 sweep's fastest)
 15. the segment-sum kernels (csrc/segment_sum.cu), forward and backward,
     vs their plain versions: the forward against the plain version in
     float64 (within 2e-6 of max |out| for segments of up to 36 rows, 2e-5
     for one segment of 5,000 rows), the backward (a copy) equal bit for
     bit, two launches of each bit-identical; at a real training batch of
     the scale corpus (its encoder output, ~7,200 rows x 256 in 512
     segments, padding rows included), [32,768, 256] in segments of 1-32
     rows, H = 164 with an odd row count, empty segments at the start, in
     the middle and at the end, one segment of 5,000 rows, 1,000,000 x 256
     in ~50,000 segments, and bfloat16 storage
 16. segment-sum times with CUDA events, forward and backward, at the
     training batch, [32,768, 256] and 1,000,000 x 256, beside the byte
     bound, the plain version and the library calls torch.segment_reduce
     and index_add_, all by the tuner's card timer (phase 13), because the
     host takes longer to enqueue one than the card to run it (that host
     time is printed beside)
 17. cost-model training end to end on committed records: cli.make_dataset
     on result/corpus/resnet_50-B1-llvm.json (2,528 records, 26 tasks),
     cli.train_model --models mlp,random (lambdaRank, hidden 256, batch
     512, up to 150 epochs, workload embedding, within_task split, seed
     0), then cli.eval_model_on_dataset on the saved pickle; every segment
     sum must go through the kernel (forward launches == calls of the
     model's sum, backward launches == optimiser steps, no plain version
     run), every metric finite; on the test split the mlp's pairwise
     accuracy must lie in [0.53, 0.70] and its peak score@5 in [0.90,
     0.99] (the JAX package's CPU runs of the same commands give 0.532 to
     0.542 and 0.905 to 0.930 over three seeds; the port's CPU runs 0.54
     to 0.67 and 0.946 to 0.979, by the epoch at which the early stop on
     the rank scores' validation rmse falls), and it must beat the random
     model of the same split (0.493, 0.909) by 0.04 in pairwise accuracy
     and in both peak scores; --models
     mlp@rmse, whose validation rmse must fall; then the tree model on the
     same split on the device engine goes through the histogram kernel
     (at this row count the command line's engine "auto" grows on the
     host)
 18. pretraining scale: the 40,000-program, ~540,000-row corpus of
     data/segment_corpus.py; MLPModelInternal.fit_base, up to 30 epochs of
     lambdaRank, timed, one device read per epoch, must order 2,000
     programs (correlation > 0.9 with their labels); the same with the
     rmse loss is run and shown only (on this dense synthetic corpus the
     sigmoid head saturates and the fit stalls, in the JAX package too:
     tests/test_torch_segment_models.py holds both to that)
 19. the latent per-store model: SegmentVAEModelInternal (VAE 200 epochs,
     predictor 300, latent 64) fit on the per-store features of 192
     records of result/conv2d_4k_chip/pool_conv2d_4k.json.gz and scoring
     1,024 others with frozen statistics: 502 forward and 500 backward
     launches, finite scores, positive rank correlation with the recorded
     throughputs; then one seed of cli.vae_extent_search --features
     per_store on the whole log (4,000 candidates x 820 features) must find
     the optimum
 20. the headline experiment's other arms on the committed pool at full
     width (hidden 256, latent 64, T 10, measure size 32, 500 VAE epochs,
     1000 predictor epochs): SelectionConfig(fused_head="off") takes the
     unfused path on the card (no kernel launch) and "auto" the kernel;
     then three processes side by side (arm_job): run_active_search with
     init_mode "diversity" and "kmeans" over one shared pretrain, and
     encoder_mode "vib": each seed must find the optimum from 32 distinct
     initial candidates, one kernel launch per selection phase;
     cli.vae_extent_search --arm grid with the average CSV pre-filled with
     every (measure_size, weights) pair of DEFAULT_GRID but one
     (ARMS["grid_pair"]): exactly that pair's 4 configs run, over one
     pretrain, each finding the optimum; then, alone, one seed of the vae
     arm through the command line with --profile-dir and --max-phases
     ARMS["profile_phases"] and a 20-epoch pretrain (depth cut): the
     torch.profiler trace must hold CUDA kernel events and one
     fused_head_kernel event per launch, and cli.trace_summary prints the
     device busy time (the union of kernel intervals), the idle share of
     the traced window and of the pretrain, each predictor fit and each
     selection phase, and the top kernels
 21. network-level evaluation through the command lines, in a temporary
     VES_DATASET_ROOT, target "llvm -mcpu=skylake-avx512" (NET_TARGET):
     cli.dump_network_info over the whole grid (108 entries; resnet_50
     [1, 224] has 26 tasks); both committed corpora split into per-task
     record files (29: resnet-18's 8 workload keys include 5 of
     resnet-50's 26); cli.make_dataset --hold-out resnet-50 must keep
     exactly resnet-18's 3 tasks outside the resnet-50 grid (48 records)
     and --preset batch-size-1 every file whose key is in its grid;
     cli.train_model on phase 17's dataset (within-task split 0.9, seed 0)
     once per model of NET_MODELS at the default widths (MLP 256, LSTM
     and MHA 256, TabNet 128 with n_d = n_a = 64 and 7 steps, 100 epochs
     for the sequence models), each model's wall time, seconds per epoch
     and six test metrics printed, all finite; the MLP's segment sums
     through the kernel (forward launches == sums, backward == optimiser
     steps, no plain call), none in the sequence models;
     cli.eval_model_on_dataset --networks resnet_50 for each pickle: top-1
     and top-5 scores in (0, 1], the MLP's through the forward kernel with
     no plain call; the same mlp.pkl on the CPU (the plain version) picks
     the same top-5 schedules in every task, gives the same scores, and
     predicts within 1e-4 of max(1, max |score|); cli.estimate_network_
     latency on the resnet-50 corpus prints 9.400 ms with 0 tasks missing
     and equals the sum of weight x best cost computed here, which
     cli.search's default estimate must equal too; the phase's seconds
     are printed against its budget (NET_BUDGET_S)
The last lines are JSON objects with phase 20's and phase 21's results,
the card's name and power limit, a JSON object with each kernel's check
and times, then {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import csv
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# published dense peaks (NVIDIA data sheets) by card; the f32 figure is
# the CUDA-core rate, bf16 the tensor-core rate
PEAKS = {
    "H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
    "H100 PCIe": {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12},
    "H200": {"float32": 67e12, "bfloat16": 989e12, "bytes": 4.8e12},
}
BENCH = dict(n=262_144, d=24, hid=256, lat=64, hp=256, T=10)
# phase 6's seeds, cut from 2000-2002 for the time limit when phase 20
# came (phase 20 runs the same path for three more seeds; the 20-seed band
# is PERF.md's, from the command line)
PHASE6_SEEDS = (2002,)
# phase 20's seeds and cuts (the arms themselves run at full width): the
# grid arm runs the one (measure_size, weights) pair of DEFAULT_GRID left
# out of its pre-filled average CSV, i.e. that pair's 4 configs; the
# profiled run is the shortest that holds one whole predictor fit, its
# pretrain cut to 20 epochs: a predictor epoch leaves ~1,300 trace events,
# and the trace of a 500-epoch pretrain and two fits (1.7 GB) took 64 s to
# write and 42 s to read
ARMS = dict(measure_size=32, diversity=(2000,), kmeans=(2000,), vib=(2000,),
            grid_pair=(64, (0.5, 0.3, 0.2)), profile_seed=2000,
            profile_phases=1, profile_vae_epochs=20,
            width=dict(latent_dim=64, hidden_dim=256, vae_epochs=500,
                       reg_epochs=1000))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(*a):
    print(*a, flush=True)


def sass_functions(library):
    """{kernel name: its SASS lines} of a built library, by cuobjdump from
    the toolkit that built it."""
    from vae_extent_search_tpu_torch.ops.build import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def atomic_census(lines):
    """{opcode: count} of the atomic and reduction instructions (ATOM*,
    RED*, *CAS*) among a function's SASS lines."""
    ops = {}
    for line in lines:
        m = re.search(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and any(k in m.group(1) for k in ("ATOM", "RED", "CAS")):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return ops


def ptxas_report(out):
    """{kernel function: (registers, spill store + load bytes)} from the
    ``-Xptxas -v`` lines of an nvcc build."""
    rep, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = m.group(1)
            rep.setdefault(cur, [0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            rep[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rep[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in rep.items()}


def peaks_for(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}; add them to PEAKS")


def rand_params(rng, d, hid, lat, hp):
    def dense(i, o):
        bw, bb = np.sqrt(3.0 / i), np.sqrt(1.0 / i)
        return {"w": rng.uniform(-bw, bw, (i, o)), "b": rng.uniform(-bb, bb, o)}
    return {"encoder": [dense(d, hid), dense(hid, hid), dense(hid, hid)],
            "fc_mu": dense(hid, lat), "fc_logvar": dense(hid, lat),
            "cost_predictor": [dense(lat, hp), dense(hp, hp), dense(hp, 1)]}


def macs_per_candidate(d, hid, lat, hp, T):
    enc = d * hid + 2 * hid * hid + hid * lat
    head = lat * hp + hp * hp + hp
    grad = hp * hp + hp * lat
    mc = T * (hp * hp + hp)
    return enc + head + grad + mc


def bound_ms(n, d, hid, lat, hp, T, dtype, peaks):
    """Least time for the work: operations over the dtype's peak, bytes
    (x in once, weights once, four f32 outputs) over the memory rate."""
    flops = 2.0 * n * macs_per_candidate(d, hid, lat, hp, T)
    item = torch.finfo(dtype).bits // 8
    weights = d * hid + 2 * hid * hid + hid * lat + lat * hp + hp * hp + hp
    nbytes = n * d * item + weights * item + 4 * n * 4
    t_ops, t_bytes = flops / peaks[dtype_name(dtype)], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_ms(fn, target_ms=10.0):
    """(device ms, host ms) per call of ``fn``, by the tuner's card timer
    (search/kernel_tuner.py::cuda_seconds): the calls are enqueued behind a
    blocking matrix product, so that they all wait in the stream when the
    first event fires and the events see the device's time alone, however
    long the host takes to enqueue one; it raises if the host was still
    enqueueing when the product ended."""
    from vae_extent_search_tpu_torch.search.kernel_tuner import cuda_seconds

    t = cuda_seconds(fn, target_ms)
    return t.seconds * 1e3, t.host_seconds * 1e3


# the pretraining shape of the GBDT slice (tools/chip_boost_bench.py):
# rows x features of the synthetic corpus, 50 rounds (cut from 300 with
# early stopping, for the time limit)
PRETRAIN = dict(n=1_000_000, d=164, rounds=50, depth=6)
HIST_TOL = 1e-5       # of max |H|, against the plain version in float64
# the earlier histogram kernel, which added with 64-bit shared atomics (a
# compare-and-swap loop on Hopper), at the pretraining shape: ms per level
# by m (PERF.md, from this script on an NVIDIA H100 80GB HBM3 at 700 W;
# the levels between were not recorded). Logged for a reader beside this
# run's times, never put into the kernels line
HIST_CAS_MS = {1: 1.509, 32: 3.669}
ARM_SEEDS = (2000, 2001, 2002)


def hist_bound_ms(n, d, m, nb, peaks):
    """Least time for one histogram launch: bins (1 B per row and
    feature) and node/grad/hess (12 B per row) read once, the two
    [d, m, nb] f32 outputs written once, over the memory rate; two f32
    additions per (row, feature) over the f32 peak."""
    t_bytes = (n * d + 12 * n + 2 * d * m * nb * 4) / peaks["bytes"]
    t_ops = 2.0 * n * d / peaks["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_hist(th, checks, label, b, nd, g, h, m, nb):
    """Two kernel launches against the plain versions: finite, of shape
    [d, m, nb], bit-identical, equal bit for bit to the plain fixed-point
    version (the same integers, summed exactly), and within HIST_TOL of
    max |H| of the plain version in float64. Records the errors in
    checks[label]; raises where one fails."""
    got = th.hist(b, nd, g, h, m, nb)
    again = th.hist(b, nd, g, h, m, nb)
    torch.cuda.synchronize()
    fixed = th.hist_plain_fixed(b, nd, g, h, m, nb)
    ref = th.hist_plain(b, nd, g.double(), h.double(), m, nb)
    errs, scales = [], []
    for a, a2, x, r in zip(got, again, fixed, ref):
        if a.shape != (b.shape[0], m, nb) or not torch.isfinite(a).all():
            raise RuntimeError(f"[hist] {label}: histogram not finite or of "
                               f"shape {tuple(a.shape)}")
        if not torch.equal(a, a2):
            raise RuntimeError(f"[hist] {label}: two launches differ")
        if not torch.equal(a, x):
            raise RuntimeError(
                f"[hist] {label}: kernel != hist_plain_fixed, max abs "
                f"{float((a - x).abs().max()):.3e}")
        errs.append(float((a.double() - r).abs().max()))
        scales.append(float(r.abs().max()))
    checks[label] = {"max_abs_err": errs, "max_abs_ref": scales,
                     "equals_plain_fixed": True}
    log(f"[hist] {label} (n={b.shape[1]} d={b.shape[0]} m={m} nb={nb}): "
        f"equal bit for bit to hist_plain_fixed; max abs err g/h "
        f"{errs[0]:.3e}/{errs[1]:.3e} of max |H| {scales[0]:.4g}/"
        f"{scales[1]:.4g} against float64 (tol {HIST_TOL:g} of max |H|); "
        f"two launches bit-identical")
    if any(e > HIST_TOL * sc for e, sc in zip(errs, scales)):
        raise RuntimeError(f"[hist] kernel disagrees with plain: {label}: "
                           f"{checks[label]}")


def gbdt_phases(dev, peaks, fh, th):
    """Phases 7-10: the histogram kernel, GBDT pretraining at full width
    and the gbdt arm of the search. Returns the kernel's result record."""
    from vae_extent_search_tpu_torch.cli.vae_extent_search import (
        run_gbdt_arm,
    )
    from vae_extent_search_tpu_torch.data.boost_corpus import make_corpus
    from vae_extent_search_tpu_torch.models import boost, boost_device
    from vae_extent_search_tpu_torch.models.gbdt import GBDTModelInternal

    n, d = PRETRAIN["n"], PRETRAIN["d"]
    t0 = time.perf_counter()
    rows, pack_ids, labels = make_corpus(n, d)
    dm = boost.DMatrix(rows, label=labels[pack_ids], pack_ids=pack_ids,
                       group_sizes=[len(labels)])
    t1 = time.perf_counter()
    dm._ensure_binned()
    bin_s = time.perf_counter() - t1
    nb = max(len(e) for e in dm._thresholds) + 1
    log(f"[7] corpus {n} rows x {d} features, {len(labels)} programs, "
        f"{nb} bins; made in {t1 - t0:.1f} s, binned in {bin_s:.2f} s")
    bins = torch.from_numpy(dm._binned).to(dev)
    # the first round's pack-sum gradient (predictions 0); the hessian of
    # a weighted fit (the weights, uniform in [0.5, 1.5))
    gen = torch.Generator(device=dev).manual_seed(21)
    grad = torch.as_tensor(-labels[pack_ids], device=dev)
    hess = torch.rand(n, generator=gen, device=dev) + 0.5

    def nodes(count, m):
        return torch.randint(0, m, (count,), generator=gen, device=dev,
                             dtype=torch.int32)

    # ---- 7. histogram kernel vs plain (float64) ----
    checks = {}
    for level in range(PRETRAIN["depth"]):
        m = 1 << level
        check_hist(th, checks, f"pretrain_m{m}", bins, nodes(n, m), grad,
                   hess, m, nb)
    odd = dict(n=700, d=9, m=4, nb=40)
    check_hist(th, checks, "odd",
               torch.randint(0, odd["nb"], (odd["d"], odd["n"]), generator=gen,
                             device=dev, dtype=torch.uint8),
               nodes(odd["n"], odd["m"]),
               torch.randn(odd["n"], generator=gen, device=dev),
               torch.rand(odd["n"], generator=gen, device=dev),
               odd["m"], odd["nb"])
    # the worst contention: one feature whose rows lie in 2 bins, at the
    # root (every row in one node) and at depth
    two = (bins[:1] & 1).contiguous()
    for m in (1, 32):
        check_hist(th, checks, f"two_bins_m{m}", two, nodes(n, m), grad, hess,
                   m, nb)

    # ---- 8. times per level ----
    levels = {}
    for level in range(PRETRAIN["depth"]):
        m = 1 << level
        nd = nodes(n, m)
        k_ms = cuda_ms(lambda: th.hist(bins, nd, grad, hess, m, nb), 10)
        b_ms, b_by = hist_bound_ms(n, d, m, nb, peaks)
        F, per_block = th.launch_plan(d, n, m, nb, th.sm_count(dev))
        levels[m] = dict(ms=k_ms, bound_ms=b_ms, bound_by=b_by)
        if m in (1, 32):
            # the plain version, and the index_add_ yardstick: the same two
            # index_add_ calls on precomputed keys and values
            p_ms = cuda_ms(lambda: th.hist_plain(bins, nd, grad, hess, m, nb),
                           3, warmup=1)
            levels[m]["plain_fixed_ms"] = cuda_ms(
                lambda: th.hist_plain_fixed(bins, nd, grad, hess, m, nb), 3,
                warmup=1)
            key = th.hist_keys(bins, nd, m, nb)
            vg, vh = grad.expand(d, n).reshape(-1), hess.expand(d, n).reshape(-1)
            og = torch.zeros(d * m * nb, device=dev)
            oh = torch.zeros_like(og)
            l_ms = cuda_ms(lambda: (og.index_add_(0, key, vg),
                                    oh.index_add_(0, key, vh)), 3, warmup=1)
            levels[m].update(plain_ms=p_ms, library_ms=l_ms)
            del key, vg, vh, og, oh
        cas = HIST_CAS_MS.get(m)
        log(f"[8] level {level} (m={m}): kernel {k_ms:.4f} ms (the 64-bit-"
            f"atomic kernel: " + (f"{cas:.3f} ms" if cas else "not recorded")
            + f"), bound {b_ms:.4f} ms ({b_by}), kernel at "
            f"{100 * b_ms / k_ms:.1f}% of bound; plan {F} features x "
            f"{per_block} rows per block, "
            f"{-(-d // F) * -(-n // per_block)} blocks"
            + (f"; plain {levels[m]['plain_ms']:.4f} ms (fixed point "
               f"{levels[m]['plain_fixed_ms']:.4f} ms), index_add_ "
               f"{levels[m]['library_ms']:.4f} ms" if m in (1, 32) else ""))
    # the worst contention at full width: every feature's rows in 2 bins;
    # at m = 32 also with 256 bins per node, where the kernel's odd node
    # stride in shared memory (257 words) keeps the nodes' bin 0 in
    # different banks
    two = bins & 1
    for m in (1, 32):
        nd = nodes(n, m)
        levels[m]["two_bins_ms"] = cuda_ms(
            lambda: th.hist(two, nd, grad, hess, m, nb), 10)
        log(f"[8] m={m}, every feature in 2 bins: kernel "
            f"{levels[m]['two_bins_ms']:.4f} ms")
    levels[32]["two_bins_nb256_ms"] = cuda_ms(
        lambda: th.hist(two, nd, grad, hess, 32, 256), 10)
    log(f"[8] m=32, every feature in 2 bins, nb=256: kernel "
        f"{levels[32]['two_bins_nb256_ms']:.4f} ms")
    del two
    per_round = sum(v["ms"] for v in levels.values())
    log(f"[8] the six levels of one tree: {per_round:.4f} ms of kernel time")
    del bins, grad, hess

    # ---- 9. GBDT pretraining at full width on the device engine ----
    rounds, depth = PRETRAIN["rounds"], PRETRAIN["depth"]

    def pretrain(rows, pack_ids, labels, engine, tag):
        """GBDTModelInternal.fit_base as a user calls it, timed whole;
        -> (model, tr-rmse at rounds 0 and 25 and the best, wall s, kernel
        launches)."""
        programs = np.split(rows, np.flatnonzero(np.diff(pack_ids)) + 1)
        model = GBDTModelInternal(max_depth=depth, learning_rate=0.2,
                                  n_estimators=rounds, engine=engine,
                                  device="cuda")
        fh.fused_head_stats.launches = 0
        th.hist.launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            model.fit_base(programs, labels, verbose=True)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = th.hist.launches
        rmse = [float(v) for v in re.findall(r"tr-rmse: ([\d.e+]+)",
                                             buf.getvalue())]
        rmse.append(float(model.model.attr("best_score")))
        for line in buf.getvalue().strip().splitlines():
            log(f"[9] {tag}: {line}")
        log(f"[9] {tag}: fit_base {len(rows)} rows x {rows.shape[1]}, "
            f"{len(labels)} programs, {rounds} rounds: {fit_s:.2f} s wall; "
            f"{launches} kernel launches = {launches / rounds:g} per round; "
            f"tr-rmse at rounds 0, 25 and best {rmse} (best at round "
            f"{model.model.attr('best_iteration')})")
        if launches != rounds * depth or fh.fused_head_stats.launches:
            raise RuntimeError(f"[9] {tag}: {launches} histogram launches "
                               f"for {rounds} rounds of depth {depth}")
        return model, rmse, fit_s, launches

    # (a) the corpus of phases 7-8, ~20 rows per program, device engine
    model, rmse_a, fit_s, pre_launches = pretrain(
        rows, pack_ids, labels, "device", "20 rows/program")
    # the rounds alone: the device engine's entry point with fit_base's
    # arguments on phase 7's binned copy of the same rows (launches not
    # counted); a run repeats bit for bit, so it grows fit_base's trees.
    # The tap keeps the node, grad and hess of the first tree's launches
    # (bins is the same tensor throughout)
    tree = []

    def keep_tree(b, nd, g, h, m, nbb):
        if len(tree) < depth:
            tree.append((b, nd.clone(), g.clone(), h.clone(), m, nbb))

    th.hist.tap = keep_tree
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        again = boost_device.train(
            model._native_params(), dm, num_boost_round=rounds,
            obj=boost.pack_sum_square_error,
            fevals=[boost.pack_sum_rmse, boost.pack_sum_average_peak_score(1)],
            evals=[(dm, "tr")], metric="tr-rmse", stopping_rounds=100,
            verbose_eval=0, device=dev)
        torch.cuda.synchronize()
    finally:
        th.hist.tap = None
    ms_round = 1e3 * (time.perf_counter() - t) / rounds
    log(f"[9] 20 rows/program: {rounds} rounds timed alone: {ms_round:.2f} "
        f"ms per round ({per_round / ms_round * 100:.0f}% of it kernel time "
        f"by phase 8); binning {bin_s:.2f} s (phase 7)")
    if not np.array_equal(again.predict(rows[:4096]),
                          model.model.predict(rows[:4096])):
        raise RuntimeError("[9] a second run grew other trees")
    # the kernel on the first tree's own launches: real trees put skewed
    # numbers of rows in their nodes, which uniform random nodes do not
    tree_ms = {}
    for b, nd, g, h, m, nbb in tree:
        check_hist(th, checks, f"tree_m{m}", b, nd, g, h, m, nbb)
        tree_ms[m] = cuda_ms(lambda: th.hist(b, nd, g, h, m, nbb), 10)
        sizes = torch.bincount(nd.long(), minlength=m)
        log(f"[9] first tree, level m={m}: kernel {tree_ms[m]:.4f} ms (phase "
            f"8, uniform nodes: {levels[m]['ms']:.4f} ms); rows per node "
            f"{int(sizes.min())} ... {int(sizes.max())}")
    if sorted(tree_ms) != sorted(levels):
        raise RuntimeError(f"[9] first tree: levels {sorted(tree_ms)}")
    del tree
    if not all(np.isfinite(rmse_a)):
        raise RuntimeError(f"[9] tr-rmse not finite: {rmse_a}")
    # (b) the same generator at 4 rows per program, where the pack-sum
    # residual amplification (rows/program x eta = 0.8) stays below 2;
    # engine "auto" must pick the device engine at this row count
    rows_b, packs_b, labels_b = make_corpus(n, d, seed=1, rows_per_program=4)
    _, rmse_b, fit_s_b, launches_b = pretrain(
        rows_b, packs_b, labels_b, "auto", "4 rows/program")
    del rows_b, packs_b, labels_b
    # (rounds 0 and 25 are printed to 6 decimals, the best is exact)
    if not (rmse_b[1] < rmse_b[0] and rmse_b[2] <= rmse_b[1] + 5e-7):
        raise RuntimeError(f"[9] tr-rmse does not fall: {rmse_b}")
    sub = 50_000
    _, p_s = np.unique(pack_ids[:sub], return_inverse=True)
    rows_s = rows[:sub]

    def subset():
        return boost.DMatrix(rows_s, label=labels[pack_ids[:sub]],
                             pack_ids=p_s)

    params = model._native_params()
    kw = dict(num_boost_round=3, obj=boost.pack_sum_square_error,
              verbose_eval=0)
    b_dev = boost_device.train(params, subset(), device=dev, **kw)
    t = time.perf_counter()
    b_host = boost.train(params, subset(), **kw)
    host_s = time.perf_counter() - t
    q_dev = boost.pack_sum_predict_throughput(b_dev.predict(rows_s), p_s)
    q_host = boost.pack_sum_predict_throughput(b_host.predict(rows_s), p_s)
    corr = float(np.corrcoef(q_dev, q_host)[0, 1])
    log(f"[9] 3 rounds on {sub} rows: device vs numpy grower pack-prediction "
        f"correlation {corr:.6f} (need > 0.999); numpy grower "
        f"{host_s / 3:.2f} s per round")
    if not corr > 0.999:
        raise RuntimeError(f"[9] engines disagree: correlation {corr}")
    del rows, dm

    # ---- 10. the gbdt arm end to end on the committed pool ----
    # the inputs of every launch of the first phase (100 trees), kept to
    # hold the kernel against its plain version below at each level
    first_phase = 100 * PRETRAIN["depth"]
    arm_inputs = []

    def keep(bins, node, grad, hess, m, nb):
        if len(arm_inputs) < first_phase:
            arm_inputs.append(tuple(t.clone() for t in (bins, node, grad,
                                                        hess)) + (m, nb))

    fh.fused_head_stats.launches = 0
    th.hist.launches = 0
    th.hist.tap = keep
    t0 = time.time()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            arm = run_gbdt_arm(None, out_dir, measure_size=32,
                               seeds=ARM_SEEDS, max_phases=60,
                               engine="device", device="cuda")
    finally:
        th.hist.tap = None
    arm_s = time.time() - t0
    arm_launches = th.hist.launches
    # at each level, the launch whose rows lie in the most nodes (many of
    # the phase's trees stop splitting early, on both engines)
    widest = {}
    for b, nd, g, h, m, nbb in arm_inputs:
        spread = int(nd.unique().numel())
        if m not in widest or spread > widest[m][0]:
            widest[m] = (spread, (b, nd, g, h, m, nbb))
    log(f"[10] first phase: {len(arm_inputs)} launches; rows lie in at most "
        + ", ".join(f"{s} nodes at m={m}" for m, (s, _) in sorted(
            widest.items())))
    if (sorted(widest) != [1 << lv for lv in range(PRETRAIN["depth"])]
            or widest[2][0] < 2):
        raise RuntimeError(f"[10] first phase: levels {sorted(widest)}, "
                           f"or no split at the root")
    for m, (_, args) in sorted(widest.items()):
        check_hist(th, checks, f"gbdt_arm_m{m}", *args)
    del arm_inputs, widest
    phases = sum(r["phase"] for r in arm)
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir, \
            contextlib.redirect_stdout(io.StringIO()):
        host_arm = run_gbdt_arm(None, out_dir, measure_size=32,
                                seeds=ARM_SEEDS, max_phases=60,
                                engine="host", device="cuda")
    for r, h in zip(arm, host_arm):
        log(f"[10] seed {r['sampling_seed']}: found={r['found']} "
            f"phase={r['phase']} train_size={r['train_size']} "
            f"used_time={r['used_time']} s (numpy-grower arm: phase "
            f"{h['phase']}, train_size {h['train_size']})")
    log(f"[10] {phases} phases in {arm_s:.1f} s; {arm_launches} kernel "
        f"launches = {arm_launches / max(phases, 1):g} per phase (100 trees "
        f"of depth 6)")
    if any(r["found"] != 1 for r in arm):
        raise RuntimeError("[10] a seed did not find the optimum")
    if (phases == 0 or arm_launches != phases * 100 * PRETRAIN["depth"]
            or fh.fused_head_stats.launches):
        raise RuntimeError(f"[10] {arm_launches} histogram launches for "
                           f"{phases} phases")

    m32 = levels[32]
    return {
        "name": "hist",
        "route": "cuda",
        "source": "vae_extent_search_tpu_torch/csrc/hist.cu",
        "replaces": "vae_extent_search_tpu/ops/hist_pallas.py:199",
        "launches": pre_launches + launches_b + arm_launches,
        "max_abs_err": max(max(c["max_abs_err"]) for c in checks.values()),
        "ms": m32["ms"], "plain_ms": m32["plain_ms"],
        "bound_ms": m32["bound_ms"], "bound_by": m32["bound_by"],
        "library_ms": m32["library_ms"],
        "shape": {"n": n, "d": d, "m": 32, "nb": nb},
        "levels": {str(m): v for m, v in levels.items()},
        "checks": {**checks, "tolerance_of_max_abs": HIST_TOL,
                   "bit_identical_launches": True,
                   "equals_plain_fixed": True,
                   "subset_engine_corr": corr},
        "launches_by_path": {"pretrain": pre_launches,
                             "pretrain_4_rows": launches_b,
                             "gbdt_arm": arm_launches},
        "first_tree_ms": {str(m): v for m, v in tree_ms.items()},
        "pretrain": {"rounds": rounds, "ms_per_round": ms_round,
                     "bin_s": bin_s, "fit_base_s": fit_s,
                     "launches_per_round": pre_launches / rounds,
                     "tr_rmse": rmse_a, "fit_base_s_4_rows": fit_s_b,
                     "tr_rmse_4_rows": rmse_b,
                     "numpy_grower_s_per_round_50k": host_s / 3},
        "gbdt_arm": {"found": [r["found"] for r in arm],
                     "phase": [r["phase"] for r in arm],
                     "train_size": [r["train_size"] for r in arm],
                     "used_time": [r["used_time"] for r in arm],
                     "numpy_grower_phase": [r["phase"] for r in host_arm]},
    }


# the self-tuning shapes (scripts/tune_pallas_kernel.py's defaults) and
# the tuner's settings at the JAX defaults
MM_DIM = 1536
CONV = (1, 56, 56, 256, 256, 3, 3, 1, 1)  # N H W CO CI KH KW stride pad
TUNE_ARGS = ["--n-candidates", "1000", "--measure-size", "16",
             "--n-phases", "6", "--vae-epochs", "500", "--reg-epochs",
             "1000"]
# relative to max |plain|. float32: the same products summed in another
# order; bfloat16 inputs: against the f32 plain version of the same
# bf16-rounded inputs, so again only the order of the f32 sums differs (a
# kernel that rounded its output to bf16 would be off by about 2^-9)
GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
# bf16 products whose K or N is not a multiple of 8 (TMA's 16-byte rows),
# at a config of the lattice each
MM_UNALIGNED = (((7, 33, 5), (64, 64, 16)), ((64, 64, 20), (64, 16, 16)))
# the f32 conv2d's shifted delta: w is the identity at tap (kh, kw) = (0,
# 0) and zero elsewhere, bias 0, pad 1, CI = CO, so out[n, oh, ow] equals
# relu(x[n, oh - 1, ow - 1]) exactly, with zeros on the first row and
# column; at OW = 14 (OWq 16) boh 2, 4, 6 and 8 give BM 32, 64, 96 and 128
CONV_DELTA = dict(N=2, H=14, W=14, C=36, bci=16, boh={32: 2, 64: 4, 96: 6,
                                                      128: 8})
# the grids of phases 13-14's lattice sweeps at the tuning shapes: every
# (bm, bn) of the bf16 matmul at bk 64, and the conv2d's at the two widest
# ci blocks (the deepest k loops per barrier)
MM_SWEEP_BK = 64
CONV_SWEEP = dict(boh=(1, 2, 3, 4, 7, 8, 14), bco=(16, 32, 64, 128, 256),
                  bci=(64, 128))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def instance_cases(om, oc):
    """[(dtype, shape, config)] that between them launch every template
    instance the two libraries hold, as each library lists them
    (``<name>_instances``): the bf16 matmul at each (bm, bn) instance and
    each bk, on a shape no tile divides; the bf16 conv2d at one config per
    (MT, NT) warp tile, found among configs of a few shapes (one of them
    with CI and CO not multiples of 8, the element-load path); the f32
    matmul at each (bm, bn) instance on a shape no tile divides and on one
    whose K and N are off a multiple of 4 (staged), each bk in turn; and
    the f32 conv2d at each (BM, BN) instance, bco = BN with the first boh
    whose row block gives BM, on two shapes of rows narrower than any tile
    (OW 3 and 1: BM spans rows), one of KW 3 and one of KW 1 (the two
    kernels of each instance), and each bci in turn. Raises if an instance
    is not reached."""
    mm_lib = om.library_instances(om.LIB.load().matmul_instances)
    cv_lib = om.library_instances(oc.LIB.load().conv2d_instances)
    mm, cv, seen_mm, seen_cv = [], [], set(), set()
    for d, bm, bn in mm_lib:
        if d == "bfloat16":
            for bk in om.BF16_BK:
                mm.append((torch.bfloat16, (2 * bm + 40, 2 * bn + 24, 200),
                           (bm, bn, bk)))
            seen_mm.add((d, bm, bn))
        else:
            bk = om.F32_BK[(bm // 32 + bn // 32) % len(om.F32_BK)]
            mm.append((torch.float32, (2 * bm + 13, 2 * bn + 20, 200),
                       (bm, bn, bk)))
            mm.append((torch.float32, (bm + 7, bn + 3, 99), (bm, bn, bk)))
            seen_mm.add((d, bm, bn))
    bf16_shapes = ((1, 56, 56, 256, 256, 3, 3, 1), (1, 28, 28, 64, 128, 3, 3, 1),
                   (3, 10, 7, 24, 4, 3, 3, 0))
    for params in bf16_shapes:
        n, h, w, co, ci, kh, kw, pad = params
        oh, ow = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
        for boh in range(1, oh + 1):
            for bco in oc.BF16_BCO:
                if bco > co + 15:
                    continue
                tile = oc.warp_tile(boh * ow, bco)
                bci = oc.BF16_BCI[len(cv) % 3]
                if tile and ("bfloat16",) + tile[:2] not in seen_cv and \
                        oc.conv_config_is_valid(n, h, w, co, ci, kh, kw, 1,
                                                pad, boh, bco, bci)[0]:
                    seen_cv.add(("bfloat16",) + tile[:2])
                    cv.append((torch.bfloat16, params, (boh, bco, bci)))
    cv.append((torch.bfloat16, bf16_shapes[2], (2, 32, 16)))
    seen_kw = set()
    for params in ((1, 64, 3, 384, 16, 3, 3, 1), (1, 512, 1, 384, 8, 1, 1, 0)):
        n, h, w, co, ci, kh, kw, pad = params
        oh, ow = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
        for boh in range(1, oh + 1):
            bm = oc.f32_bm(boh * oc.f32_row_width(ow))
            for bco in oc.F32_BN:
                bci = oc.F32_BCI[len(cv) % len(oc.F32_BCI)]
                if (bm, bco, kw) not in seen_kw and oc.conv_config_is_valid(
                        n, h, w, co, ci, kh, kw, 1, pad, boh, bco, bci,
                        dtype="float32")[0]:
                    seen_kw.add((bm, bco, kw))
                    seen_cv.add(("float32", bm, bco))
                    cv.append((torch.float32, params, (boh, bco, bci)))
    if seen_mm != set(mm_lib) or seen_cv != set(cv_lib) or len(
            seen_kw) != 2 * sum(d == "float32" for d, _, _ in cv_lib):
        raise RuntimeError(f"instances not reached: matmul "
                           f"{sorted(set(mm_lib) - seen_mm)}, conv2d "
                           f"{sorted(set(cv_lib) - seen_cv)}")
    return mm, cv, len(mm_lib), len(cv_lib)


def gemm_bound_ms(flops, nbytes, dtype, peaks):
    """Least time: the operations over the input type's peak, or the
    bytes (each input read once, the output written once) over the
    memory rate, whichever is longer."""
    t_ops = flops / peaks[dtype_name(dtype)]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def matmul_work(M, N, K, item):
    """(operations, bytes) of C [M, N] f32 = A [M, K] @ B [K, N]."""
    return 2.0 * M * N * K, (M * K + K * N) * item + M * N * 4


def conv_work(N, H, W, CO, CI, KH, KW, stride, pad, item):
    """(operations, bytes) of one stride-1 conv2d + bias + ReLU: x and w
    in the input type, the f32 bias, the f32 output."""
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    return (2.0 * N * OH * OW * CO * KH * KW * CI,
            (N * H * W * CI + KH * KW * CI * CO) * item + CO * 4
            + N * OH * OW * CO * 4)


def check_gemm(tag, label, launch, plain, tol, checks):
    """Two launches against the plain version: finite, bit-identical, and
    within ``tol`` relative to max |plain|. Raises where one fails."""
    got = launch()
    again = launch()
    torch.cuda.synchronize()
    ref = plain()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"[{tag}] {label}: not finite or of shape "
                           f"{tuple(got.shape)}")
    if not torch.equal(got, again):
        raise RuntimeError(f"[{tag}] {label}: two launches differ")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    checks[label] = {"max_abs_err": err, "max_rel_err": rel, "tol": tol}
    log(f"[{tag}] {label}: rel err {rel:.2e} (tol {tol:g}), max abs "
        f"{err:.3e}; two launches bit-identical")
    if not rel <= tol:
        raise RuntimeError(f"[{tag}] kernel disagrees with plain: {label}")


def tune_arms(tag, workload, best_launch, kernels, checks,
              arms=("model", "random"), dtype="bfloat16"):
    """cli.tune_kernel with ``workload`` at TUNE_ARGS in ``dtype``, each of
    ``arms`` in turn, each driven with every kernel count at 0 and read
    just after.
    Checks that every timed config went through the kernel, none failed to
    launch, and each was held against the plain version within
    GEMM_TOL; then holds each arm's best config against the plain version
    on the runner's own operands (``best_launch(runner, cfg)`` gives the
    launch and the plain version; into ``checks``). Returns {arm:
    (summary, runner, launches by kernel, wall s)}."""
    from vae_extent_search_tpu_torch.cli.tune_kernel import tune
    from vae_extent_search_tpu_torch.records.serde import (
        ERROR_COMPILE_DEVICE,
        ERROR_NO_ERROR,
    )

    out = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    label = tag if dtype == "bfloat16" else f"{tag}_{dtype}"
    for arm in arms:
        buf = io.StringIO()
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            log_file = os.path.join(d, "tune.json")
            for k in kernels.values():
                k.launches = 0
            t = time.time()
            with contextlib.redirect_stdout(buf):
                summary, runner = tune(workload + TUNE_ARGS + [
                    "--dtype", dtype, "--arm", arm, "--log-file", log_file])
            wall = time.time() - t
            launches = {n: k.launches for n, k in kernels.items()}
            with open(log_file) as f:
                recs = [json.loads(ln) for ln in f if ln.strip()]
        text = buf.getvalue()
        with open(os.path.join(OUT_DIR, f"tune_{label}_{arm}.log"), "w") as f:
            f.write(text)
        for line in text.splitlines():
            if not line.startswith("  config"):
                log(f"[{tag}] {arm}: {line}")
        measured = runner.measured_configs()
        ok = [(c, sec) for c, sec, e in measured if e == ERROR_NO_ERROR]
        failed = [c for c, _, e in measured if e == ERROR_COMPILE_DEVICE]
        per_cfg = runner.launches_per_config
        verify = runner.n_verified
        lib = summary["library_ms"]
        lib_s = "not timed" if lib is None else (
            f"{lib:.4f} ms on the card ({summary['library_host_ms']:.4f} ms "
            f"per call on the host)")
        log(f"[{tag}] arm {arm}: best {summary['best_cfg']} "
            f"{summary['best_ms']:.4f} ms = {summary['gflops'] / 1e3:.3f} "
            f"TFLOP/s on the card, the host {summary['host_ms']:.4f} ms per "
            f"call; {runner.n_timed} configs timed ({len(ok)} ok, "
            f"{len(failed)} failed to launch), {summary['n_measured']} "
            f"states measured, {wall:.1f} s wall; library {lib_s}; "
            f"{runner.n_verified} configs held against plain, max rel err "
            f"{runner.verify_rel_err}; launches "
            f"{launches}")
        if failed:
            raise RuntimeError(f"[{tag}] {arm}: configs failed on the card "
                               f"(ERROR_COMPILE_DEVICE): {failed}")
        if not ok or any(per_cfg.get(c, 0) < 3 for c, _ in ok):
            raise RuntimeError(f"[{tag}] {arm}: a timed config did not go "
                               f"through the kernel: {per_cfg}")
        if (launches[tag] != sum(per_cfg.values()) + verify
                or verify != len(per_cfg) or verify != len(ok)):
            raise RuntimeError(f"[{tag}] {arm}: {launches[tag]} launches for "
                               f"{sum(per_cfg.values())} timed + {verify} "
                               f"verified, {len(ok)} configs ok")
        tol = GEMM_TOL[getattr(torch, dtype)]
        if not runner.verify_rel_err <= tol:
            raise RuntimeError(f"[{tag}] {arm}: a timed config is off its "
                               f"plain version by {runner.verify_rel_err:g} "
                               f"(tol {tol:g})")
        others = {n: v for n, v in launches.items()
                  if n not in (tag, "fused_head_stats")}
        want_fh = summary["n_phases"] if arm == "model" else 0
        if any(others.values()) or launches["fused_head_stats"] != want_fh:
            raise RuntimeError(f"[{tag}] {arm}: kernel launches {launches}")
        if (len(recs) != summary["n_measured"]
                or {r["i"][0][1] for r in recs} != {f"cuda -model={dtype}"}):
            raise RuntimeError(f"[{tag}] {arm}: {len(recs)} records for "
                               f"{summary['n_measured']} measured states")
        if not (0 < summary["best_ms"] < 1e4 and lib and lib > 0):
            raise RuntimeError(f"[{tag}] {arm}: best {summary['best_ms']} "
                               f"ms, library {lib} ms")
        best = tuple(int(v) for v in summary["best_cfg"].split("x"))
        launch, plain = best_launch(runner, best)
        check_gemm(tag, f"{arm} arm's best {best} on the tuner's operands",
                   launch, plain, tol, checks)
        out[arm] = (summary, runner, launches, wall)
    return out


def lattice_sweep(tag, configs, launch, plain, tuned_ms=None, target_ms=10.0):
    """Each of ``configs`` held against the plain version within GEMM_TOL
    and timed on the card like the tuner's configs (windows of
    ``target_ms``): the lattice's fastest config, beside the one the search
    found where ``tuned_ms`` is given."""
    tol = GEMM_TOL[torch.bfloat16]
    ref = plain()
    times = {}
    for cfg in configs:
        got = launch(cfg)
        rel = float((got - ref).abs().max() / ref.abs().max())
        if not rel <= tol:
            raise RuntimeError(f"[{tag}] sweep {cfg}: rel err {rel:g} (tol "
                               f"{tol:g})")
        times["x".join(map(str, cfg))] = card_ms(lambda: launch(cfg),
                                                 target_ms)[0]
    order = sorted(times, key=times.get)
    best = order[0]
    log(f"[{tag}] lattice sweep, {len(times)} configs: fastest "
        + ", ".join(f"{c} {times[c]:.4f}" for c in order[:6])
        + f" ms; slowest {order[-1]} {times[order[-1]]:.4f} ms"
        + ("" if tuned_ms is None else
           f"; the tuned best {tuned_ms:.4f} ms is "
           f"{tuned_ms / times[best]:.3f}x the sweep's fastest"))
    return {"configs": len(times), "best_cfg": best, "best_ms": times[best],
            "fastest_ms": {c: times[c] for c in order[:6]},
            "slowest_ms": times[order[-1]], "times": times}


def randn_on(dev, seed=31):
    """randn(*shape, dtype=float32) on ``dev`` from one seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    return randn


def conv_f32_phases(dev, peaks, kernels):
    """``--only conv_f32``: phase 12's float32 part and phase 14's f32 arm
    alone. Returns the conv2d_f32 record."""
    from vae_extent_search_tpu_torch.ops import conv2d as oc
    from vae_extent_search_tpu_torch.ops import matmul as om

    checks = {}
    cv_inst = instance_cases(om, oc)[1]
    sweep = conv_f32_checks(dev, peaks, randn_on(dev), cv_inst, checks)
    return conv_f32_record(conv_f32_arm(kernels, checks, sweep), checks,
                           sweep)


def tuner_phases(dev, peaks, kernels):
    """Phases 11-14: the matmul and conv2d kernels against their plain
    versions at every instance the libraries hold, and the self-tuning path
    on both. Returns their result records."""
    from vae_extent_search_tpu_torch.ops import conv2d as oc
    from vae_extent_search_tpu_torch.ops import matmul as om
    from vae_extent_search_tpu_torch.search.kernel_tuner import (
        time_library_matmul,
    )

    randn = randn_on(dev)
    mm_inst, cv_inst, n_mm, n_cv = instance_cases(om, oc)
    log(f"[11] {n_mm} matmul and {n_cv} conv2d template instances in the "
        f"libraries; {len(mm_inst)} and {len(cv_inst)} instance checks")

    # ---- 11. matmul kernel vs plain ----
    F32, BF16 = torch.float32, torch.bfloat16
    mm_checks, mm_f32_checks = {}, {}
    mm_cases = [(F32, (MM_DIM,) * 3, c) for c in (
        (128, 128, 32), (96, 96, 32), (32, 32, 8), (128, 96, 16))] + [
        (BF16, (MM_DIM,) * 3, c) for c in (
            (128, 192, 64), (256, 128, 64), (64, 16, 16), (128, 256, 32))] + [
        # ragged: no tile divides M, N or K
        (F32, (96, 160, 72), (64, 96, 16)), (F32, (1000, 24, 40),
                                             (96, 32, 32)),
        (BF16, (96, 160, 72), (64, 64, 32)), (BF16, (1000, 24, 40),
                                              (64, 32, 64))] + [
        # K or N off a multiple of 8: the wrapper stages zero-padded copies
        (BF16, dims, cfg) for dims, cfg in MM_UNALIGNED] + mm_inst
    operands = {}
    for dtype, dims, cfg in mm_cases:
        M, N, K = dims
        if (dtype, dims) not in operands:
            operands = {(dtype, dims): (randn(M, K, dtype=dtype),
                                        randn(K, N, dtype=dtype))}
        a, b = operands[(dtype, dims)]
        ok, why = om.config_is_valid(M, N, K, *cfg, dtype=dtype_name(dtype))
        if not ok:
            raise RuntimeError(f"[11] {cfg} at {dims}: {why}")
        check_gemm("11", f"{M}x{N}x{K} {cfg} {dtype_name(dtype)}",
                   lambda: om.matmul(a, b, *cfg),
                   lambda: om.matmul_plain(a, b), GEMM_TOL[dtype],
                   mm_f32_checks if dtype == F32 else mm_checks)
    # A = identity at every bf16 and f32 instance: C equals B exactly, so a
    # wrong (row, column) in the epilogue or a missed mask cannot pass
    n_eye = 0
    for dtype, dims, cfg in mm_inst:
        if dtype == BF16 and cfg[2] != 64 or dtype == F32 and dims[2] != 200:
            continue
        M = dims[0]
        b = randn(M, dims[1], dtype=dtype)
        got = om.matmul(torch.eye(M, device=dev, dtype=dtype), b, *cfg)
        if not torch.equal(got, b.float()):
            raise RuntimeError(f"[11] identity A at {cfg} "
                               f"{dtype_name(dtype)}: C != B")
        n_eye += 1
    # and where K or N is off a multiple of 8: A = eye(M, K) gives C = B
    # in its first min(M, K) rows and zeros below, exactly
    launches = om.matmul.launches
    for (M, N, K), cfg in MM_UNALIGNED:
        a, b = torch.eye(M, K, device=dev, dtype=BF16), randn(K, N, dtype=BF16)
        if not torch.equal(om.matmul(a, b, *cfg), a.float() @ b.float()):
            raise RuntimeError(f"[11] identity A at {(M, N, K)} {cfg}: C != B")
    if om.matmul.launches != launches + len(MM_UNALIGNED):
        raise RuntimeError("[11] an unaligned bf16 product did not launch")
    log(f"[11] identity A: C == B exactly at every bf16 and f32 instance "
        f"({n_eye} products) and at {[d for d, _ in MM_UNALIGNED]} (bf16, K "
        f"or N off 8, staged)")
    del operands, a, b
    a = randn(MM_DIM, MM_DIM, dtype=BF16)
    b = randn(MM_DIM, MM_DIM, dtype=BF16)
    mm_plain_ms, _ = card_ms(lambda: om.matmul_plain(a, b))
    mm_bound, mm_by = gemm_bound_ms(*matmul_work(MM_DIM, MM_DIM, MM_DIM, 2),
                                    BF16, peaks)
    log(f"[11] 1536^3 bf16: plain {mm_plain_ms:.4f} ms, bound "
        f"{mm_bound:.4f} ms ({mm_by})")
    del a, b
    # the f32 kernel's whole lattice at 1536^3 beside torch.matmul in full
    # float32 (TF32 off: PyTorch's default for matmul, set here all the same)
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = randn(MM_DIM, MM_DIM), randn(MM_DIM, MM_DIM)
    f32_plain_ms, _ = card_ms(lambda: om.matmul_plain(a, b))
    f32_lib_ms = time_library_matmul(MM_DIM, MM_DIM, MM_DIM, "float32",
                                     device=dev).seconds * 1e3
    f32_bound, f32_by = gemm_bound_ms(
        *matmul_work(MM_DIM, MM_DIM, MM_DIM, 4), F32, peaks)
    log(f"[11] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}; 1536^3 f32: torch.matmul "
        f"{f32_lib_ms:.4f} ms, plain {f32_plain_ms:.4f} ms, bound "
        f"{f32_bound:.4f} ms ({f32_by})")
    f32_sweep = lattice_sweep(
        "11", [(bm, bn, bk) for bm in om.F32_BM for bn in om.F32_BN
               for bk in om.F32_BK],
        lambda cfg: om.matmul(a, b, *cfg), lambda: om.matmul_plain(a, b))
    f32_sweep.update(library_ms=f32_lib_ms, bound_ms=f32_bound,
                     all_ms=f32_sweep.pop("times"))
    log(f"[11] f32 lattice sweep: fastest {f32_sweep['best_cfg']} "
        f"{f32_sweep['best_ms']:.4f} ms = "
        f"{f32_lib_ms / f32_sweep['best_ms']:.3f}x torch.matmul's speed, "
        f"{f32_bound / f32_sweep['best_ms']:.1%} of the bound")
    del a, b

    # ---- 12. conv2d kernel vs plain ----
    cv_checks, cv_f32_checks = {}, {}
    cv_cases = [(BF16, (2, 8, 8, 6, 256, 3, 3, 1), c) for c in (
        (1, 16, 128), (4, 16, 128), (8, 16, 64))] + [
        (BF16, (3, 10, 7, 2, 4, 3, 3, 0), (3, 16, 16)),
        (BF16, (1, 8, 8, 4, 8, 3, 3, 1), (2, 16, 16))] + [
        (BF16, CONV[:7] + CONV[8:], c) for c in (
            (2, 128, 64), (3, 32, 16), (1, 256, 64), (2, 64, 128))] + [
        c for c in cv_inst if c[0] == BF16]
    check_conv_cases("12", cv_cases, randn, cv_checks)
    N, H, W, CO, CI, KH, KW, _, pad = CONV
    x, w = randn(N, H, W, CI, dtype=BF16), randn(KH, KW, CI, CO, dtype=BF16)
    bias = randn(CO)
    cv_plain_ms, _ = card_ms(lambda: oc.conv2d_plain(x, w, bias, pad))
    cv_bound, cv_by = gemm_bound_ms(*conv_work(*CONV, 2), BF16, peaks)
    log(f"[12] 1x56x56x256->256 3x3 bf16: plain {cv_plain_ms:.4f} ms, bound "
        f"{cv_bound:.4f} ms ({cv_by})")
    del x, w, bias
    cv_f32_sweep = conv_f32_checks(dev, peaks, randn, cv_inst, cv_f32_checks)

    # ---- 13. / 14. self-tuning end to end ----
    def mm_best(runner, cfg):
        a, b = runner.operands(MM_DIM, MM_DIM, MM_DIM)
        return lambda: om.matmul(a, b, *cfg), lambda: om.matmul_plain(a, b)

    def cv_best(runner, cfg):
        N, H, W, CO, CI, KH, KW, _, pad = CONV
        x, w, bias = runner.operands(N, H, W, CO, CI, KH, KW)
        return (lambda: oc.conv2d(x, w, bias, pad, *cfg),
                lambda: oc.conv2d_plain(x, w, bias, pad))

    mm_arms = tune_arms("matmul", ["--workload", "matmul", "--dim",
                                   str(MM_DIM)], mm_best, kernels, mm_checks)
    # this slice's path: the f32 CUDA-core kernel tuned at the same shape
    mm_f32_arms = tune_arms("matmul", ["--workload", "matmul", "--dim",
                                       str(MM_DIM)], mm_best, kernels,
                            mm_f32_checks, arms=("random",), dtype="float32")
    f32_tuned = mm_f32_arms["random"][0]
    log(f"[13] f32 random arm: best {f32_tuned['best_cfg']} "
        f"{f32_tuned['best_ms']:.4f} ms; torch.matmul f32 (TF32 off) "
        f"{f32_tuned['library_ms']:.4f} ms in the arm, {f32_lib_ms:.4f} ms "
        f"in phase 11 -> {f32_tuned['best_ms'] / f32_tuned['library_ms']:.3f}"
        f"x the library's time; the phase 11 sweep's fastest "
        f"{f32_sweep['best_cfg']} {f32_sweep['best_ms']:.4f} ms -> "
        f"{f32_tuned['best_ms'] / f32_sweep['best_ms']:.3f}x")
    cv_arms = tune_arms("conv2d", ["--workload", "conv2d", "--conv",
                                   *map(str, CONV[:7])], cv_best, kernels,
                        cv_checks)
    cv_f32_arms = conv_f32_arm(kernels, cv_f32_checks, cv_f32_sweep)

    def tuned_ms(arms):
        return min(v[0]["best_ms"] for v in arms.values())

    a, b = mm_arms["model"][1].operands(MM_DIM, MM_DIM, MM_DIM)
    mm_sweep = lattice_sweep(
        "13", [(bm, bn, MM_SWEEP_BK) for bm in om.BF16_BM
               for bn in om.BF16_BN if om.config_is_valid(
                   MM_DIM, MM_DIM, MM_DIM, bm, bn, MM_SWEEP_BK)[0]],
        lambda cfg: om.matmul(a, b, *cfg), lambda: om.matmul_plain(a, b),
        tuned_ms(mm_arms))
    N, H, W, CO, CI, KH, KW, _, pad = CONV
    x, w, bias = cv_arms["model"][1].operands(N, H, W, CO, CI, KH, KW)
    cv_sweep = lattice_sweep(
        "14", [(boh, bco, bci) for boh in CONV_SWEEP["boh"]
               for bco in CONV_SWEEP["bco"] for bci in CONV_SWEEP["bci"]
               if oc.conv_config_is_valid(*CONV, boh, bco, bci)[0]],
        lambda cfg: oc.conv2d(x, w, bias, pad, *cfg),
        lambda: oc.conv2d_plain(x, w, bias, pad), tuned_ms(cv_arms))
    del a, b, x, w, bias

    def record(name, arms, checks, src, replaces, plain_ms, b_ms, b_by,
               shape, sweep, flops, kernel=None):
        best = min(arms.values(), key=lambda v: v[0]["best_ms"])[0]
        kernel = kernel or name
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(v[2][kernel] for v in arms.values()),
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "ms": best["best_ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": min(v[0]["library_ms"] for v in arms.values()),
            "shape": shape, "best_cfg": best["best_cfg"],
            "tflops": flops / best["best_ms"] / 1e9,
            "host_ms": best["host_ms"],
            "library_host_ms": best["library_host_ms"],
            "timer": "device time, calls queued behind a blocking product "
                     "(search/kernel_tuner.py::cuda_seconds)",
            "lattice_sweep": sweep,
            "checks": {"max_rel_err": max(c["max_rel_err"]
                                          for c in checks.values()),
                       "tolerance": {dtype_name(t): v
                                     for t, v in GEMM_TOL.items()},
                       "bit_identical_launches": True,
                       "configs_checked": len(checks)},
            "tune": {arm: {k: v[0][k] for k in (
                "best_cfg", "best_ms", "gflops", "host_ms", "library_ms",
                "library_host_ms", "n_configs_timed", "n_measured",
                "n_raw_configs", "n_lattice_configs", "pool_s", "bound_s",
                "featurize_s", "vae_s", "fit_s", "select_s", "measure_s",
                "timing_s")}
                | {"wall_s": v[3], "launches": v[2][kernel],
                   "configs_verified": v[1].n_verified,
                   "verify_max_rel_err": v[1].verify_rel_err}
                for arm, v in arms.items()},
        }

    return [
        record("matmul", mm_arms, mm_checks,
               "vae_extent_search_tpu_torch/csrc/matmul.cu",
               "vae_extent_search_tpu/ops/matmul_pallas.py:78", mm_plain_ms,
               mm_bound, mm_by, {"M": MM_DIM, "N": MM_DIM, "K": MM_DIM,
                                 "dtype": "bfloat16"}, mm_sweep,
               matmul_work(MM_DIM, MM_DIM, MM_DIM, 2)[0]),
        record("matmul_f32", mm_f32_arms, mm_f32_checks,
               "vae_extent_search_tpu_torch/csrc/matmul.cu",
               "vae_extent_search_tpu/ops/matmul_pallas.py:78", f32_plain_ms,
               f32_bound, f32_by, {"M": MM_DIM, "N": MM_DIM, "K": MM_DIM,
                                   "dtype": "float32"}, f32_sweep,
               matmul_work(MM_DIM, MM_DIM, MM_DIM, 4)[0], kernel="matmul"),
        record("conv2d", cv_arms, cv_checks,
               "vae_extent_search_tpu_torch/csrc/conv2d.cu",
               "vae_extent_search_tpu/ops/conv2d_pallas.py:106", cv_plain_ms,
               cv_bound, cv_by, dict(zip(("N", "H", "W", "CO", "CI", "KH",
                                          "KW", "stride", "pad"), CONV),
                                     dtype="bfloat16"), cv_sweep,
               conv_work(*CONV, 2)[0]),
        conv_f32_record(cv_f32_arms, cv_f32_checks, cv_f32_sweep),
    ]


def check_conv_cases(tag, cases, randn, checks):
    """Each (dtype, (N, H, W, CO, CI, KH, KW, pad), config) of ``cases``
    through check_gemm against the plain version, on operands drawn once
    per dtype and shape."""
    from vae_extent_search_tpu_torch.ops import conv2d as oc

    operands = {}
    for dtype, params, cfg in cases:
        N, H, W, CO, CI, KH, KW, pad = params
        if (dtype, params) not in operands:
            operands = {(dtype, params): (
                randn(N, H, W, CI, dtype=dtype),
                randn(KH, KW, CI, CO, dtype=dtype), randn(CO))}
        x, w, bias = operands[(dtype, params)]
        ok, why = oc.conv_config_is_valid(N, H, W, CO, CI, KH, KW, 1, pad,
                                          *cfg, dtype=dtype_name(dtype))
        if not ok:
            raise RuntimeError(f"[{tag}] {cfg} at {params}: {why}")
        check_gemm(tag, f"{params} {cfg} {dtype_name(dtype)}",
                   lambda: oc.conv2d(x, w, bias, pad, *cfg),
                   lambda: oc.conv2d_plain(x, w, bias, pad),
                   GEMM_TOL[dtype], checks)


def conv_f32_checks(dev, peaks, randn, cv_inst, checks):
    """Phase 12's float32 part: the f32 kernel against the plain version at
    every (BM, BN) instance (``instance_cases``), ragged edges (boh, bco,
    bci not dividing OH, CO, CI), CI and CO off a multiple of 4 (staged
    zero-padded), OW wider than any tile, N > 1 and the tuning shape; the
    shifted delta exact at every instance; then the sweep of the whole
    lattice at the tuning shape beside cuDNN in f32 (TF32 off), the plain
    version and the f32 bound. Returns the sweep."""
    from vae_extent_search_tpu_torch.ops import conv2d as oc
    from vae_extent_search_tpu_torch.search.kernel_tuner import (
        time_library_conv2d,
    )

    F32 = torch.float32
    cases = [(F32, (2, 8, 8, 6, 256, 3, 3, 1), c) for c in (
        (1, 32, 32), (4, 64, 16), (8, 32, 8))] + [
        (F32, (3, 10, 7, 2, 4, 3, 3, 0), (4, 32, 8)),
        (F32, (1, 8, 8, 4, 8, 3, 3, 1), (2, 32, 8)),
        (F32, (2, 9, 11, 6, 5, 3, 3, 1), (3, 32, 8)),        # CI, CO off 4
        (F32, (2, 6, 150, 20, 12, 3, 3, 1), (2, 64, 16)),     # OW 150
        (F32, (1, 14, 14, 40, 24, 1, 1, 0), (3, 32, 16))] + [
        (F32, CONV[:7] + CONV[8:], c) for c in (
            (8, 64, 32), (3, 96, 16), (1, 128, 32), (7, 32, 8))] + [
        c for c in cv_inst if c[0] == F32]
    check_conv_cases("12", cases, randn, checks)
    d = CONV_DELTA
    N, H, W, C = d["N"], d["H"], d["W"], d["C"]
    x = randn(N, H, W, C)
    w = torch.zeros(3, 3, C, C, device=dev)
    w[0, 0] = torch.eye(C, device=dev)
    want = torch.zeros_like(x)
    want[:, 1:, 1:] = torch.relu(x[:, :-1, :-1])
    for bm, boh in d["boh"].items():
        if oc.f32_bm(boh * oc.f32_row_width(W)) != bm:
            raise RuntimeError(f"[12] delta: boh {boh} does not give BM {bm}")
        for bn in oc.F32_BN:
            got = oc.conv2d(x, w, torch.zeros(C, device=dev), 1, boh, bn,
                            d["bci"])
            if not torch.equal(got, want):
                raise RuntimeError(f"[12] shifted delta at BM {bm}, BN {bn}: "
                                   f"out != relu(x shifted by one row and "
                                   f"column)")
    log(f"[12] shifted delta (w = identity at tap (0, 0), pad 1): out == "
        f"relu(x[oh - 1, ow - 1]) exactly at all "
        f"{len(d['boh']) * len(oc.F32_BN)} f32 instances, {N}x{H}x{W}x{C}")
    del x, w, want
    N, H, W, CO, CI, KH, KW, _, pad = CONV
    x, w, bias = randn(N, H, W, CI), randn(KH, KW, CI, CO), randn(CO)
    lib_ms = time_library_conv2d(*CONV, "float32", device=dev).seconds * 1e3
    plain_ms = card_ms(lambda: oc.conv2d_plain(x, w, bias, pad))[0]
    bound, by = gemm_bound_ms(*conv_work(*CONV, 4), F32, peaks)
    log(f"[12] 1x56x56x256->256 3x3 f32: cuDNN (TF32 off) {lib_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    # 672 configs: 5 ms windows (each the minimum of three) for the time
    # limit
    OH = H + 2 * pad - KH + 1
    sweep = lattice_sweep(
        "12", [(boh, bco, bci) for boh in range(1, OH + 1)
               for bco in oc.F32_BN for bci in oc.F32_BCI],
        lambda cfg: oc.conv2d(x, w, bias, pad, *cfg),
        lambda: oc.conv2d_plain(x, w, bias, pad), target_ms=5.0)
    sweep.update(library_ms=lib_ms, plain_ms=plain_ms, bound_ms=bound,
                 bound_by=by, all_ms=sweep.pop("times"))
    log(f"[12] f32 lattice sweep: fastest {sweep['best_cfg']} "
        f"{sweep['best_ms']:.4f} ms = {sweep['best_ms'] / lib_ms:.3f}x "
        f"cuDNN's time, {bound / sweep['best_ms']:.1%} of the bound")
    return sweep


def conv_f32_arm(kernels, checks, sweep):
    """Phase 14's float32 part: cli.tune_kernel --workload conv2d --dtype
    float32 --arm random at the tuning shape; its best config beside cuDNN
    and the phase 12 sweep's fastest."""
    from vae_extent_search_tpu_torch.ops import conv2d as oc

    def best_launch(runner, cfg):
        N, H, W, CO, CI, KH, KW, _, pad = CONV
        x, w, bias = runner.operands(N, H, W, CO, CI, KH, KW)
        return (lambda: oc.conv2d(x, w, bias, pad, *cfg),
                lambda: oc.conv2d_plain(x, w, bias, pad))

    arms = tune_arms("conv2d", ["--workload", "conv2d", "--conv",
                                *map(str, CONV[:7])], best_launch, kernels,
                     checks, arms=("random",), dtype="float32")
    tuned = arms["random"][0]
    log(f"[14] f32 random arm: best {tuned['best_cfg']} "
        f"{tuned['best_ms']:.4f} ms; cuDNN f32 (TF32 off) "
        f"{tuned['library_ms']:.4f} ms in the arm, {sweep['library_ms']:.4f}"
        f" ms in phase 12 -> {tuned['best_ms'] / tuned['library_ms']:.3f}x "
        f"cuDNN's time; the phase 12 sweep's fastest {sweep['best_cfg']} "
        f"{sweep['best_ms']:.4f} ms -> "
        f"{tuned['best_ms'] / sweep['best_ms']:.3f}x")
    return arms


def conv_f32_record(arms, checks, sweep):
    """The conv2d_f32 entry of the kernels line: the random arm's best and
    launches, the sweep, the checks."""
    best, runner, launches, wall = arms["random"]
    flops = conv_work(*CONV, 4)[0]
    return {
        "name": "conv2d_f32", "route": "cuda",
        "source": "vae_extent_search_tpu_torch/csrc/conv2d.cu",
        "replaces": "vae_extent_search_tpu/ops/conv2d_pallas.py:106",
        "launches": launches["conv2d"],
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": best["best_ms"], "plain_ms": sweep["plain_ms"],
        "bound_ms": sweep["bound_ms"], "bound_by": sweep["bound_by"],
        "library_ms": best["library_ms"],
        "shape": dict(zip(("N", "H", "W", "CO", "CI", "KH", "KW", "stride",
                           "pad"), CONV), dtype="float32"),
        "best_cfg": best["best_cfg"], "tflops": flops / best["best_ms"] / 1e9,
        "host_ms": best["host_ms"],
        "timer": "device time, calls queued behind a blocking product "
                 "(search/kernel_tuner.py::cuda_seconds)",
        "lattice_sweep": sweep,
        "checks": {"max_rel_err": max(c["max_rel_err"]
                                      for c in checks.values()),
                   "tolerance": GEMM_TOL[torch.float32],
                   "bit_identical_launches": True, "shifted_delta_exact": True,
                   "configs_checked": len(checks)},
        "tune": {"random": {k: best[k] for k in (
            "best_cfg", "best_ms", "gflops", "host_ms", "library_ms",
            "n_configs_timed", "n_measured")} | {
            "wall_s": wall, "launches": launches["conv2d"],
            "configs_verified": runner.n_verified,
            "verify_max_rel_err": runner.verify_rel_err}},
    }


# the per-store cost models: full width of the reference's MLP
SEG = dict(hidden=256, batch=512, dim=164)
SEG_TOL = 2e-6        # of max |out|, float64 plain version, spans <= 36 rows
SEG_TOL_LONG = 2e-5   # one segment of 5,000 rows
RESNET50_LOG = os.path.join(ROOT, "result/corpus/resnet_50-B1-llvm.json")
RESNET18_LOG = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")
CONV_POOL_LOG = os.path.join(ROOT,
                             "result/conv2d_4k_chip/pool_conv2d_4k.json.gz")
# phase 17's bands for the mlp on the test split. The JAX package's scripts
# give, for the same commands on the CPU, 0.532-0.542 and 0.905-0.930 over
# three seeds. The port's CPU runs give 0.54-0.67 and 0.946-0.979: the early
# stop watches the validation rmse of uncalibrated rank scores, and the
# epoch it falls on (34 to 67 here) moves with the order of float sums
MLP_BANDS = {"pairwise comparision accuracy": (0.53, 0.70),
             "average peak score@5": (0.90, 0.99)}
# and its least margin over the random model of the same split
MLP_OVER_RANDOM = {"pairwise comparision accuracy": 0.04,
                   "average peak score@1": 0.0, "average peak score@5": 0.0}


def segment_bound_ms(R, H, n_seg, item, peaks):
    """Least time for one segment-sum launch: the [R, H] rows and the
    offsets read once, the [n_seg, H] f32 sums written once, over the
    memory rate (the backward moves the same bytes the other way); one f32
    addition per element over the f32 peak."""
    t_bytes = (R * H * item + n_seg * H * 4 + (n_seg + 1) * 4) / peaks["bytes"]
    t_ops = R * H / peaks["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextlib.contextmanager
def in_directory(path):
    here = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(here)


class CallCounts:
    """Counts, while active, the calls of the models' segment sum, of the
    two plain versions, and the optimiser steps."""

    def __init__(self, seg_models, tss):
        self.seg_models, self.tss = seg_models, tss
        self.sums = self.plain = self.steps = 0

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self._orig = (self.seg_models.segment_sum_rows,
                      self.tss.segment_sum_plain,
                      self.tss.segment_sum_grad_plain)

        def counted(name, fn):
            def wrapper(*a, **kw):
                setattr(self, name, getattr(self, name) + 1)
                return fn(*a, **kw)
            return wrapper

        self.seg_models.segment_sum_rows = counted("sums", self._orig[0])
        self.tss.segment_sum_plain = counted("plain", self._orig[1])
        self.tss.segment_sum_grad_plain = counted("plain", self._orig[2])
        self._hook = register_optimizer_step_post_hook(
            lambda *a: setattr(self, "steps", self.steps + 1))
        return self

    def __exit__(self, *exc):
        (self.seg_models.segment_sum_rows, self.tss.segment_sum_plain,
         self.tss.segment_sum_grad_plain) = self._orig
        self._hook.remove()


def segment_phases(dev, peaks, kernels, shared=None):
    """Phases 15-19: the segment-sum kernels against their plain versions,
    their times, and the cost-model training paths that run them. Returns
    the kernel's result record; phase 17's dataset goes into ``shared``
    (for phase 21)."""
    from vae_extent_search_tpu_torch.cli import (
        eval_model_on_dataset,
        make_dataset,
        train_model,
    )
    from vae_extent_search_tpu_torch.cli.vae_extent_search import (
        run_experiment,
    )
    from vae_extent_search_tpu_torch.data.segment_corpus import (
        make_segment_corpus,
    )
    from vae_extent_search_tpu_torch.features.per_store import (
        get_per_store_features_from_measure_pairs,
    )
    from vae_extent_search_tpu_torch.models import segment as sm
    from vae_extent_search_tpu_torch.models.gbdt import (
        _DEVICE_BOOST_MIN_ROWS as gbdt_min_rows,
        GBDTModelInternal,
    )
    from vae_extent_search_tpu_torch.models.modules import mlp_apply
    from vae_extent_search_tpu_torch.ops import segment_sum as tss
    from vae_extent_search_tpu_torch.records.serde import load_records

    seg = tss.segment_sum
    gen = torch.Generator(device=dev).manual_seed(41)
    rng = np.random.default_rng(41)

    def reset():
        for k in kernels.values():
            k.launches = 0
        seg.backward_launches = 0

    def others(*names):
        return {n: k.launches for n, k in kernels.items() if n not in names}

    # the scale corpus of phase 18, and one training batch of it as the
    # model sees it: the encoder's output for the batch's rows
    t0 = time.perf_counter()
    corpus, corpus_y = make_segment_corpus(dim=SEG["dim"])
    corpus_rows = sum(len(f) for f in corpus)
    log(f"[15] scale corpus: {len(corpus)} programs, {corpus_rows} rows x "
        f"{SEG['dim']}, made in {time.perf_counter() - t0:.1f} s")
    batch = sm.make_segment_batches(
        corpus[:SEG["batch"]], corpus_y[:SEG["batch"]], SEG["batch"],
        sm.compute_fea_norm_vec(corpus[:SEG["batch"]]), device=dev)[0]
    # pad the batch as a mid-corpus batch is padded (to the corpus's
    # longest batch), so that it carries padding rows
    pad = torch.zeros(97, SEG["dim"], device=dev)
    enc = sm.init_segment_mlp_params(gen, SEG["dim"], SEG["hidden"],
                                     device=dev)["segment_encoder"]
    with torch.no_grad():
        h_batch = mlp_apply(enc, torch.cat([batch.features, pad]),
                            final_activation=True).contiguous()

    def case(counts, H, pad_rows, dtype=torch.float32, x=None):
        counts = np.asarray(counts, np.int64)
        n_seg = len(counts)
        offs = np.zeros(n_seg + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        R = int(offs[-1]) + pad_rows
        if x is None:
            x = torch.randn(R, H, generator=gen, device=dev).to(dtype)
        offs = torch.as_tensor(offs, device=dev)
        return x, offs, tss.offsets_to_segment_ids(offs, R), n_seg

    def prefix(counts, total):
        """The longest prefix of ``counts`` that sums to at most ``total``."""
        return counts[:int(np.searchsorted(np.cumsum(counts), total,
                                           side="right"))]

    spans32 = prefix(rng.integers(1, 33, 4096), 32_768)
    big = prefix(rng.integers(4, 37, 50_000), 1_000_000)
    b_counts = np.diff(batch.offsets.cpu().numpy())
    cases = {
        "train_batch": lambda: case(b_counts, SEG["hidden"],
                                    h_batch.shape[0] - int(b_counts.sum()),
                                    x=h_batch),
        "32768x256_spans_1_32": lambda: case(
            spans32, 256, 32_768 - int(spans32.sum())),
        "h164_odd_rows": lambda: case(rng.integers(1, 24, 513), 164, 7),
        "empty_segments": lambda: case([0, 0, 3, 0, 0, 9, 1, 0, 0], 174, 5),
        "one_segment_5000": lambda: case([5000], 256, 0),
        "1000000x256": lambda: case(big, 256, 1_000_000 - int(big.sum())),
        "bf16_32768x256": lambda: case(
            spans32, 256, 32_768 - int(spans32.sum()), torch.bfloat16),
    }

    # ---- 15. kernels vs plain ----
    checks = {}
    for label, make in cases.items():
        x, offs, ids, n_seg = make()
        R, H = x.shape
        f0, b0 = seg.launches, seg.backward_launches
        xg = x.clone().requires_grad_(True)
        out = seg(xg, offs)
        again = seg(x, offs)
        # a strided view: handed to the backward as it is by the second
        # call, and made contiguous by the wrapper
        w = torch.randn(n_seg, 2 * H, generator=gen, device=dev)[:, ::2]
        (out * w).sum().backward()
        grad2, = torch.autograd.grad(seg(xg, offs), xg, w)
        torch.cuda.synchronize()
        if (seg.launches, seg.backward_launches) != (f0 + 3, b0 + 2):
            raise RuntimeError(f"[15] {label}: launches not counted")
        ref = tss.segment_sum_plain(x.double(), ids, n_seg)
        gref = tss.segment_sum_grad_plain(w, ids, n_seg).to(x.dtype)
        if out.shape != (n_seg, H) or not torch.isfinite(out).all():
            raise RuntimeError(f"[15] {label}: not finite or of shape "
                               f"{tuple(out.shape)}")
        if not (torch.equal(out.detach(), again)
                and torch.equal(xg.grad, grad2)):
            raise RuntimeError(f"[15] {label}: two launches differ")
        err = float((out.detach().double() - ref).abs().max())
        scale = float(ref.abs().max())
        tol = SEG_TOL_LONG if label == "one_segment_5000" else SEG_TOL
        g_ok = torch.equal(xg.grad, gref)
        checks[label] = {"max_abs_err": err, "max_abs_ref": scale,
                         "tol_of_max_abs": tol, "backward_equal": g_ok,
                         "R": R, "H": H, "n_seg": n_seg,
                         "longest": int(offs.diff().max()),
                         "dtype": dtype_name(x.dtype)}
        log(f"[15] {label} (R={R} H={H} n_seg={n_seg}, longest segment "
            f"{checks[label]['longest']} rows, {dtype_name(x.dtype)}): "
            f"forward max abs err {err:.3e} = {err / scale:.2e} of max |out| "
            f"(tol {tol:g}); backward equal to plain: {g_ok}; two launches "
            f"of each bit-identical")
        if not (err <= tol * scale and g_ok):
            raise RuntimeError(f"[15] kernel disagrees with plain: {label}")
        del x, xg, out, again, ref, gref, grad2, w, ids

    # ---- 16. times ----
    times = {}
    for label in ("train_batch", "32768x256_spans_1_32", "1000000x256"):
        x, offs, ids, n_seg = cases[label]()
        R, H = x.shape
        w = torch.randn(n_seg, H, generator=gen, device=dev)
        lengths = torch.cat([offs, offs.new_tensor([R])]).diff().long()
        buf = torch.zeros(n_seg + 1, H, device=dev)
        with torch.no_grad():
            (f_ms, f_host), (b_ms, b_host), (p_ms, _), (pb_ms, _), \
                (sr_ms, _), (ia_ms, _) = (card_ms(fn) for fn in (
                    lambda: seg(x, offs),
                    lambda: tss._backward_cuda(w, offs, R, x.dtype),
                    lambda: tss.segment_sum_plain(x, ids, n_seg),
                    lambda: tss.segment_sum_grad_plain(w, ids, n_seg),
                    # the library calls: segment_reduce over the segments'
                    # lengths (one more for the padding rows), and
                    # index_add_ alone into a buffer that is already there
                    lambda: torch.segment_reduce(
                        x, "sum", lengths=lengths, axis=0, unsafe=True),
                    lambda: buf.index_add_(0, ids, x)))
        bd_ms, by = segment_bound_ms(R, H, n_seg, x.element_size(), peaks)
        times[label] = dict(R=R, H=H, n_seg=n_seg, ms=f_ms, backward_ms=b_ms,
                            host_call_ms=f_host, host_backward_call_ms=b_host,
                            plain_ms=p_ms, plain_backward_ms=pb_ms,
                            bound_ms=bd_ms, bound_by=by,
                            segment_reduce_ms=sr_ms, index_add_ms=ia_ms)
        log(f"[16] {label} (R={R} H={H} n_seg={n_seg}): forward {f_ms:.4f} "
            f"ms, backward {b_ms:.4f} ms, bound {bd_ms:.4f} ms ({by}), "
            f"forward at {100 * bd_ms / f_ms:.1f}% of bound; the host takes "
            f"{f_host:.4f} / {b_host:.4f} ms to enqueue one; plain forward "
            f"{p_ms:.4f} / backward {pb_ms:.4f} ms; torch.segment_reduce "
            f"{sr_ms:.4f} ms, index_add_ {ia_ms:.4f} ms")
        del x, w, ids, buf
    del h_batch
    launches_by_path = {}

    def path_counts(tag, counts, want_backward):
        """After a driven path: every model sum went through the forward
        kernel, every optimiser step through the backward kernel, and no
        plain version ran."""
        f, b = seg.launches, seg.backward_launches
        launches_by_path[tag] = {"forward": f, "backward": b}
        log(f"[{tag}] segment sums called {counts.sums}, forward launches "
            f"{f}; optimiser steps {counts.steps}, backward launches {b}; "
            f"plain versions run {counts.plain}")
        if not (f == counts.sums > 0 and b == want_backward
                and counts.plain == 0):
            raise RuntimeError(f"[{tag}] a segment sum missed the kernel: "
                               f"{f} forward launches for {counts.sums} "
                               f"calls, {b} backward for {want_backward} "
                               f"steps, {counts.plain} plain calls")

    # ---- 17. cost-model training on committed records ----
    with tempfile.TemporaryDirectory(dir=ROOT) as d, in_directory(d):
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            ds = make_dataset.main([RESNET50_LOG, "--out-file", "ds.pkl"])
        feat_s = time.perf_counter() - t
        n_rec = len(ds)
        if shared is not None:
            shared["resnet50_ds"] = ds
        log(f"[17] make_dataset: {n_rec} records, {len(ds.tasks())} tasks "
            f"(min sample size 48) featurised in {feat_s:.2f} s = "
            f"{1e3 * feat_s / n_rec:.2f} s per 1,000 records (host)")
        reset()
        buf = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with CallCounts(sm, tss) as counts, contextlib.redirect_stdout(buf):
            res = train_model.main(["--dataset", "ds.pkl", "--models",
                                    "mlp,random", "--seed", "0"])
            scores_17 = eval_model_on_dataset.main(
                ["--model", "mlp.pkl", "--datasets", "ds.pkl"])["ds.pkl"]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        for line in buf.getvalue().strip().splitlines():
            log(f"[17] {line}")
        path_counts("17", counts, counts.steps)
        mlp, rand = res["mlp"], res["random"]
        log(f"[17] train_model + eval_model_on_dataset: {train_s:.2f} s "
            f"wall, {counts.steps} optimiser steps")
        if any(others("segment_sum").values()) or counts.steps == 0:
            raise RuntimeError(f"[17] kernel launches {others()}")
        if not (all(np.isfinite(v) for v in mlp.values())
                and all(0 < v <= 1 for v in scores_17.values())):
            raise RuntimeError(f"[17] metrics {mlp}, scores {scores_17}")
        for name, (lo, hi) in MLP_BANDS.items():
            if not lo <= mlp[name] <= hi:
                raise RuntimeError(f"[17] {name} {mlp[name]:.4f} outside "
                                   f"[{lo}, {hi}]")
        for name, margin in MLP_OVER_RANDOM.items():
            if not mlp[name] > rand[name] + margin:
                raise RuntimeError(
                    f"[17] {name}: mlp {mlp[name]:.4f} against the random "
                    f"model's {rand[name]:.4f}, margin {margin}")
        # an rmse-loss fit (sigmoid head) on the same dataset: its
        # validation rmse has to fall
        reset()
        buf = io.StringIO()
        with CallCounts(sm, tss) as counts_r, contextlib.redirect_stdout(buf):
            res_r = train_model.main(
                ["--dataset", "ds.pkl", "--models", "mlp@rmse", "--seed", "0",
                 "--verbose"])
        path_counts("17 rmse", counts_r, counts_r.steps)
        val = [float(v) for v in re.findall(r"epoch \d+: train \S+ val (\S+)",
                                            buf.getvalue())]
        rmse = res_r["mlp@rmse"]
        log(f"[17] --models mlp@rmse: validation rmse every 10 epochs {val}; "
            f"test RMSE {rmse['RMSE']:.4f}, pairwise accuracy "
            f"{rmse['pairwise comparision accuracy']:.4f}")
        if not (len(val) >= 2 and min(val[1:]) < val[0]
                and all(np.isfinite(v) for v in rmse.values())):
            raise RuntimeError(f"[17] rmse fit: validation rmse {val}, "
                               f"metrics {rmse}")
        # the tree model on the same split, grown through the histograms.
        # The command line's engine "auto" grows on the host below
        # _DEVICE_BOOST_MIN_ROWS rows, so the device engine is asked for
        # through the model's own argument
        train_set, test_set = ds.random_split_within_task(0.9, seed=0)
        g_feats, g_labels, _ = train_set.flatten(
            with_workload_embedding=True, embed_total_dim=9)
        g_rows = sum(len(f) for f in g_feats)
        gbdt = GBDTModelInternal(engine="device")
        gbdt.use_workload_embedding, gbdt.workload_embed_total_dim = True, 9
        reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        gbdt.fit_base(g_feats, g_labels)
        torch.cuda.synchronize()
        gbdt_s = time.perf_counter() - t
        hist_17 = kernels["hist"].launches
        res_g = train_model.evaluate_model(gbdt, test_set)
        log(f"[17] GBDTModelInternal(engine='device') on the training split "
            f"({len(g_feats)} records, {g_rows} rows; 'auto' takes the host "
            f"below {gbdt_min_rows} rows): {gbdt_s:.2f} s, {hist_17} "
            f"histogram launches; test metrics "
            + ", ".join(f"{k} {v:.4f}" for k, v in res_g.items()))
        if (hist_17 == 0 or hist_17 % 6 or any(others("hist").values())
                or not all(np.isfinite(v) for v in res_g.values())):
            raise RuntimeError(f"[17] gbdt: launches "
                               f"{others()}, metrics {res_g}")
    steps_17, train_fit = counts.steps, train_s

    # ---- 18. pretraining scale ----
    scale = {}
    for loss in ("lambdaRank", "rmse"):
        model = sm.MLPModelInternal(in_dim=SEG["dim"], n_epoch=30,
                                    loss_type=loss)
        reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with CallCounts(sm, tss) as counts:
            model.fit_base(corpus, corpus_y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        info = model.fit_info
        path_counts(f"18 {loss}", counts, info["steps"])
        ep = info["epochs"]
        per_epoch = (seg.launches + seg.backward_launches) / ep
        tb = times["train_batch"]
        kernel_ms = ((info["train_batches"] + info["val_batches"]) * tb["ms"]
                     + info["train_batches"] * tb["backward_ms"])
        hist = info["val_history"]
        loop_s = info["loop_seconds"]
        scale[loss] = dict(fit_s=fit_s, loop_s=loop_s, epochs=ep,
                           steps=info["steps"],
                           launches_per_epoch=per_epoch,
                           kernel_ms_per_epoch=kernel_ms,
                           val_first=hist[0], val_best=info["best_val"])
        log(f"[18] {loss}: fit_base ({len(corpus)} programs, {corpus_rows} "
            f"rows): {fit_s:.2f} s wall incl. "
            f"packing and upload, {loop_s:.2f} s in the {ep} epochs = "
            f"{loop_s / ep:.3f} s per epoch = "
            f"{1e3 * loop_s / info['steps']:.2f} ms per optimiser step; "
            f"{info['train_batches']} training + {info['val_batches']}"
            f" validation batches: {per_epoch:g} kernel launches per epoch = "
            f"{kernel_ms:.3f} ms of kernel time per epoch by phase 16 "
            f"({100 * kernel_ms / (1e3 * loop_s / ep):.2f}% of the epoch); "
            f"validation rmse first {hist[0]:.5f}, best {info['best_val']:.5f}")
        if counts.steps != info["steps"] \
                or any(others("segment_sum").values()):
            raise RuntimeError(f"[18] {loss}: {counts.steps} steps, "
                               f"{others()}")
        if not np.isfinite(hist).all():
            raise RuntimeError(f"[18] {loss}: validation rmse not finite: "
                               f"{hist}")
        pred = model.predict_on_features(corpus[:2000])
        corr = float(np.corrcoef(pred, corpus_y[:2000])[0, 1])
        scale[loss]["corr_2000"] = corr
        log(f"[18] {loss}: corr(pred, y) on 2,000 programs = {corr:.4f}"
            + ("" if loss == "lambdaRank" else
               " (on this dense synthetic corpus the sigmoid head saturates "
               "within the first steps and the rmse fit stalls, in the JAX "
               "package too: shown, not held to a limit; phase 17 holds an "
               "rmse fit on real records)"))
        # the labels are a linear map of the summed rows: the rank-loss fit
        # has to order them
        if loss == "lambdaRank" and not corr > 0.9:
            raise RuntimeError(f"[18] the lambdaRank model did not learn: "
                               f"corr {corr}")
    del corpus

    # ---- 19. the latent per-store model ----
    t = time.perf_counter()
    records = [r for r in load_records(CONV_POOL_LOG)
               if r.res.error_no == 0 and r.res.costs]
    pick = np.random.default_rng(0).permutation(len(records))[:192 + 1024]
    t1 = time.perf_counter()
    feats, thr, _, _ = get_per_store_features_from_measure_pairs(
        [records[i].inp for i in pick], [records[i].res for i in pick])
    t2 = time.perf_counter()
    log(f"[19] {len(records)} records loaded in {t1 - t:.1f} s; {len(pick)} "
        f"featurised per store in {t2 - t1:.1f} s = "
        f"{1e3 * (t2 - t1) / len(pick):.2f} s per 1,000 (host, CUDA target)")
    vae = sm.SegmentVAEModelInternal(in_dim=164, hidden_dim=256,
                                     latent_dim=64, vae_epochs=200,
                                     reg_epochs=300)
    reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with CallCounts(sm, tss) as counts:
        vae.fit_base(feats[:192], thr[:192])
        fit_vae_s = time.perf_counter() - t
        scores = vae.predict_on_features(feats[192:])
    path_counts("19", counts, 500)

    def ranks(a):
        return np.argsort(np.argsort(a)).astype(np.float64)

    rho = float(np.corrcoef(ranks(scores), ranks(thr[192:]))[0, 1])
    log(f"[19] SegmentVAEModelInternal: fit on 192 records in "
        f"{fit_vae_s:.2f} s (VAE 200 + predictor 300 full-batch epochs); "
        f"1,024 others scored; rank correlation with the recorded "
        f"throughputs {rho:.3f}")
    if (seg.launches != 502 or counts.steps != 500
            or any(others("segment_sum").values())):
        raise RuntimeError(f"[19] {seg.launches} forward launches, "
                           f"{counts.steps} steps, {others()}")
    if not (scores.shape == (1024,) and np.isfinite(scores).all()
            and rho > 0):
        raise RuntimeError(f"[19] scores not finite or rank correlation "
                           f"{rho} not positive")
    del records, feats
    reset()
    t = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir, \
            contextlib.redirect_stdout(buf):
        rows, _ = run_experiment(
            None, out_dir, measure_size=32, seeds=(2000,), max_phases=60,
            vae_epochs=500, reg_epochs=1000, latent_dim=64, hidden_dim=256,
            device="cuda", record_file=CONV_POOL_LOG, features="per_store")
    ps_s = time.perf_counter() - t
    r = rows[0]
    log(f"[19] {buf.getvalue().splitlines()[0]}")
    log(f"[19] cli.vae_extent_search --features per_store, seed 2000: "
        f"found={r['found']} phase={r['phase']} train_size={r['train_size']}"
        f" used_time={r['used_time']} s; {ps_s:.1f} s wall incl. "
        f"featurising the log; fused-head launches "
        f"{kernels['fused_head_stats'].launches}")
    if r["found"] != 1 or kernels["fused_head_stats"].launches != r["phase"] \
            or any(others("fused_head_stats").values()):
        raise RuntimeError(f"[19] per_store search: {r}, launches "
                           f"{others()}")

    tb = times["train_batch"]
    fwd = sum(v["forward"] for v in launches_by_path.values())
    bwd = sum(v["backward"] for v in launches_by_path.values())
    return {
        "name": "segment_sum",
        "route": "cuda",
        "source": "vae_extent_search_tpu_torch/csrc/segment_sum.cu",
        "replaces": "vae_extent_search_tpu/ops/segment_sum_pallas.py:38",
        "launches": fwd + bwd,
        "forward_launches": fwd, "backward_launches": bwd,
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": tb["ms"], "backward_ms": tb["backward_ms"],
        "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"],
        # the faster of the two library calls at this shape
        "library_ms": min(tb["segment_reduce_ms"], tb["index_add_ms"]),
        "shape": {k: tb[k] for k in ("R", "H", "n_seg")},
        "times": times,
        "checks": {**checks, "bit_identical_launches": True},
        "launches_by_path": launches_by_path,
        "train_model": {"records": n_rec, "featurise_s": feat_s,
                        "train_eval_s": train_fit, "steps": steps_17,
                        "metrics": mlp, "top_k_scores": {
                            str(k): v for k, v in scores_17.items()},
                        "random_metrics": rand,
                        "rmse_fit": {"val_rmse_every_10": val,
                                     "metrics": rmse},
                        "gbdt_s": gbdt_s, "gbdt_hist_launches": hist_17,
                        "gbdt_metrics": res_g},
        "scale": scale,
        "segment_vae": {"fit_s": fit_vae_s, "rank_corr": rho,
                        "per_store_search": {
                            "found": r["found"], "phase": r["phase"],
                            "train_size": r["train_size"], "wall_s": ps_s}},
    }


# phase 21: the network workflow's target (the committed corpora's), the
# sequence models' default widths and the limit of the phase's seconds
NET_TARGET = "llvm -mcpu=skylake-avx512"
NET_MODELS = ("mlp", "lstm", "mha", "tabnet", "random")
NET_BUDGET_S = 150.0


def split_by_task(logs, folder):
    """The per-task layout of measure_records: one file per workload key,
    named clean_name((workload_key, "llvm")).json, records in log order.
    Returns the paths."""
    from vae_extent_search_tpu_torch.cli.common import clean_name

    groups = {}
    for path in logs:
        with open(path) as f:
            for line in f:
                if line.strip():
                    key = json.loads(line)["i"][0][0]
                    groups.setdefault(key, []).append(
                        line.rstrip("\n") + "\n")
    os.makedirs(folder, exist_ok=True)
    paths = []
    for key, lines in groups.items():
        p = os.path.join(folder, clean_name((key, "llvm")) + ".json")
        with open(p, "w") as f:
            f.writelines(lines)
        paths.append(p)
    return paths


def network_phases(dev, kernels, dataset=None):
    """Phase 21: the network-level evaluation workflow through the command
    lines, in a temporary VES_DATASET_ROOT. ``dataset``: phase 17's
    resnet-50 Dataset (made here when None). Returns its results and the
    segment-sum launches of its path."""
    import pickle

    from vae_extent_search_tpu_torch.cli import (
        common,
        dump_network_info,
        estimate_network_latency,
        eval_model_on_dataset,
        make_dataset,
        search,
        train_model,
    )
    from vae_extent_search_tpu_torch.models import load_model_pickle
    from vae_extent_search_tpu_torch.models import segment as sm
    from vae_extent_search_tpu_torch.models import variants as mv
    from vae_extent_search_tpu_torch.models.embedding import embed_for_model
    from vae_extent_search_tpu_torch.ops import segment_sum as tss
    from vae_extent_search_tpu_torch.records import iter_records
    from vae_extent_search_tpu_torch.records.networks import (
        build_network_keys,
        get_network_tasks,
    )

    seg = tss.segment_sum
    t_phase = time.perf_counter()
    out, fits = {}, {}

    def reset():
        for k in kernels.values():
            k.launches = 0
        seg.backward_launches = 0

    def others():
        return {n: k.launches for n, k in kernels.items()
                if n != "segment_sum" and k.launches}

    def quiet(fn, *a):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn(*a)
        return res, buf.getvalue()

    # each model's fit_info, as fit_base leaves it
    fit_orig = {cls: cls.fit_base for cls in (sm.MLPModelInternal,
                                              mv.SequenceModelInternal)}

    def recording(cls):
        def fit_base(self, *a, **kw):
            r = fit_orig[cls](self, *a, **kw)
            fits[getattr(self, "arch", "mlp")] = dict(self.fit_info)
            return r
        return fit_base

    env_before = os.environ.get("VES_DATASET_ROOT")
    with tempfile.TemporaryDirectory(dir=ROOT) as d, in_directory(d):
        os.environ["VES_DATASET_ROOT"] = os.path.join(d, "dataset")
        common.set_dataset_root()
        try:
            # 1. the task tables of the whole grid
            t = time.perf_counter()
            dumped, _ = quiet(dump_network_info.main, ["--target", NET_TARGET])
            grid = build_network_keys()
            log(f"[21] dump_network_info --target '{NET_TARGET}': "
                f"{len(dumped)} of {len(grid)} grid entries, "
                f"{sum(dumped.values())} tasks, in "
                f"{time.perf_counter() - t:.2f} s")
            if len(dumped) != 108 or len(grid) != 108 or \
                    dumped[("resnet_50", (1, 224))] != 26:
                raise RuntimeError(f"[21] dumped {len(dumped)} entries: "
                                   f"{dumped}")
            # 2. the per-task record layout of both corpora
            files = split_by_task([RESNET50_LOG, RESNET18_LOG],
                                  common.MEASURE_RECORD_FOLDER)
            r50 = {r.inp.task.workload_key for r in iter_records(RESNET50_LOG)}
            r18 = {r.inp.task.workload_key for r in iter_records(RESNET18_LOG)}
            log(f"[21] measure_records: {len(files)} per-task files (the "
                f"resnet-50 corpus's {len(r50)} tasks and the resnet-18 "
                f"corpus's {len(r18)}, {len(r50 & r18)} of them shared)")
            if len(files) != len(r50 | r18) or r50 != {
                    t_.workload_key for t_ in get_network_tasks(
                        "resnet_50", 1, 224, NET_TARGET)[0]}:
                raise RuntimeError(f"[21] {len(files)} record files")
            # 3. hold-out and preset
            t = time.perf_counter()
            ho, text = quiet(make_dataset.main, files + [
                "--hold-out", "resnet-50", "--min-sample-size", "1",
                "--target", NET_TARGET, "--out-file", "holdout.pkl"])
            ho_keys = {t_.workload_key for t_ in ho.tasks()}
            log(f"[21] make_dataset --hold-out resnet-50: {len(ho.tasks())} "
                f"tasks, {len(ho)} records, in {time.perf_counter() - t:.2f} "
                f"s (featurising every file, host)")
            held = set()
            for b in (1, 4, 8):
                for size in (224, 240, 256):
                    held |= {t_.workload_key for t_ in get_network_tasks(
                        "resnet_50", b, size, NET_TARGET)[0]}
            if len(ho.tasks()) != 3 or len(ho) != 48 or ho_keys & held \
                    or ho_keys != r18 - held:
                raise RuntimeError(f"[21] hold-out: {len(ho.tasks())} tasks, "
                                   f"{len(ho)} records")
            pre, text = quiet(make_dataset.main, files + [
                "--preset", "batch-size-1", "--target", NET_TARGET,
                "--out-file", "preset.pkl"])
            b1 = set()
            for name, (b, size) in grid:
                if b == 1:
                    b1 |= {t_.workload_key for t_ in get_network_tasks(
                        name, b, size, NET_TARGET)[0]}
            want = sum(1 for k in r50 | r18 if k in b1)
            kept = int(re.search(r"preset batch-size-1: (\d+) files",
                                 text).group(1))
            log(f"[21] make_dataset --preset batch-size-1: {kept} files kept "
                f"of {len(files)} ({want} in the preset grid); {len(pre)} "
                f"records in {len(pre.tasks())} tasks of >= 48")
            if kept != want:
                raise RuntimeError(f"[21] preset kept {kept} of {want}")

            # 4. the five models at their default widths
            if dataset is None:
                dataset, _ = quiet(make_dataset.main,
                                   [RESNET50_LOG, "--out-file", "ds.pkl"])
            else:
                with open("ds.pkl", "wb") as f:
                    pickle.dump(dataset, f)
            metrics, train = {}, {}
            for cls in fit_orig:
                cls.fit_base = recording(cls)
            for name in NET_MODELS:
                reset()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with CallCounts(sm, tss) as counts:
                    res, _ = quiet(train_model.main, [
                        "--dataset", "ds.pkl", "--models", name,
                        "--seed", "0"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                metrics[name] = res[name]
                info = fits.get(name, {})
                ep = info.get("epochs", 0)
                train[name] = dict(wall_s=wall, epochs=ep,
                                   loop_s=info.get("loop_seconds"),
                                   s_per_epoch=(info["loop_seconds"] / ep
                                                if ep else None),
                                   forward_launches=seg.launches,
                                   backward_launches=seg.backward_launches,
                                   steps=counts.steps)
                log(f"[21] train_model --models {name}: {wall:.2f} s wall "
                    f"(split, fit, test metrics, pickle)"
                    + (f"; fit {info['loop_seconds']:.2f} s over {ep} "
                       f"epochs = {info['loop_seconds'] / ep:.4f} s per "
                       f"epoch" if ep else "")
                    + "; " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in res[name].items())
                    + f"; segment-sum launches {seg.launches} forward, "
                    f"{seg.backward_launches} backward, {counts.steps} "
                    f"optimiser steps, {counts.plain} plain calls")
                if not all(np.isfinite(v) for v in res[name].values()):
                    raise RuntimeError(f"[21] {name}: metrics {res[name]}")
                if counts.plain or others():
                    raise RuntimeError(f"[21] {name}: plain calls "
                                       f"{counts.plain}, launches {others()}")
                if name == "mlp" and not (
                        seg.launches == counts.sums > 0
                        and seg.backward_launches == counts.steps > 0):
                    raise RuntimeError(f"[21] mlp: {seg.launches} forward "
                                       f"launches for {counts.sums} sums, "
                                       f"{seg.backward_launches} backward "
                                       f"for {counts.steps} steps")
                if name in ("lstm", "mha", "tabnet") and (
                        counts.sums or seg.launches
                        or ep != 100 or counts.steps != 100):
                    raise RuntimeError(f"[21] {name}: {ep} epochs, "
                                       f"{counts.steps} steps, "
                                       f"{seg.launches} segment sums")
            for cls, fn in fit_orig.items():
                cls.fit_base = fn
            seq_width = {n: (load_model_pickle(f"{n}.pkl", device="cpu")
                             .hidden_dim) for n in ("lstm", "mha", "tabnet")}
            if seq_width != {"lstm": 256, "mha": 256, "tabnet": 128}:
                raise RuntimeError(f"[21] widths {seq_width}")

            # 5. the network scores of every model
            scores, eval_s = {}, {}
            for name in NET_MODELS:
                reset()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with CallCounts(sm, tss) as counts:
                    sc, _ = quiet(eval_model_on_dataset.main, [
                        "--model", f"{name}.pkl", "--networks", "resnet_50",
                        "--target", NET_TARGET, "--cache-dir", "eval_cache"])
                torch.cuda.synchronize()
                eval_s[name] = time.perf_counter() - t
                scores[name] = sc["resnet_50"]
                log(f"[21] eval_model_on_dataset --networks resnet_50, "
                    f"{name}: top-1 {scores[name][1]:.4f}, top-5 "
                    f"{scores[name][5]:.4f}, {eval_s[name]:.2f} s wall"
                    + (" (the network's dataset built from the per-file "
                       "feature caches, then cached)"
                       if name == NET_MODELS[0] else "")
                    + f"; segment-sum launches {seg.launches} for "
                    f"{counts.sums} sums, {counts.plain} plain calls")
                if not all(0 < v <= 1 for v in scores[name].values()):
                    raise RuntimeError(f"[21] {name}: scores {scores[name]}")
                if counts.plain or others() or seg.backward_launches:
                    raise RuntimeError(f"[21] {name}: plain {counts.plain}, "
                                       f"launches {others()}")
                if name == "mlp":
                    eval_launches = seg.launches
                    if not seg.launches == counts.sums > 0:
                        raise RuntimeError(
                            f"[21] mlp eval: {seg.launches} launches for "
                            f"{counts.sums} sums")
            # the same pickle on the CPU (the plain segment sum): the same
            # picks and scores, predictions within 1e-4 of max(1, max |score|)
            # (float32 sums in another order)
            cpu_scores, _ = quiet(eval_model_on_dataset.main, [
                "--model", "mlp.pkl", "--networks", "resnet_50", "--target",
                NET_TARGET, "--cache-dir", "eval_cache", "--device", "cpu"])
            cpu_scores = cpu_scores["resnet_50"]
            tasks, _ = eval_model_on_dataset.network_task_datasets(
                "resnet_50", NET_TARGET, "eval_cache")
            on_card = load_model_pickle("mlp.pkl", device="cuda")
            on_cpu = load_model_pickle("mlp.pkl", device="cpu")
            max_err, same_picks, scale = 0.0, 0, 1.0
            for ds_, task in tasks:
                feats = embed_for_model(
                    on_cpu, [np.asarray(f, np.float32)
                             for f in ds_.features[task]], task.workload_key)
                pg = on_card.predict_on_features(feats)
                pc = on_cpu.predict_on_features(feats)
                max_err = max(max_err, float(np.abs(pg - pc).max()))
                scale = max(scale, float(np.abs(pc).max()))
                same_picks += list(np.argsort(-pg)[:5]) == \
                    list(np.argsort(-pc)[:5])
            log(f"[21] mlp.pkl on the CPU (plain segment sum): top-1 "
                f"{cpu_scores[1]:.6f}, top-5 {cpu_scores[5]:.6f} against the "
                f"card's {scores['mlp'][1]:.6f}, {scores['mlp'][5]:.6f}; "
                f"predictions within {max_err:.2e} (max |score| {scale:.3g}); "
                f"the same top-5 picks in "
                f"{same_picks} of {len(tasks)} tasks")
            if cpu_scores != scores["mlp"] or max_err > 1e-4 * scale or \
                    same_picks != len(tasks):
                raise RuntimeError(f"[21] card and CPU differ: {cpu_scores} "
                                   f"vs {scores['mlp']}, err {max_err}, "
                                   f"picks {same_picks}/{len(tasks)}")

            # 6. latency estimates
            reset()
            (total, missing), text = quiet(estimate_network_latency.main, [
                RESNET50_LOG, "--target", NET_TARGET])
            best = {}
            for rec in iter_records(RESNET50_LOG):
                if rec.res.error_no == 0:
                    k = rec.inp.task.workload_key
                    best[k] = min(best.get(k, float("inf")),
                                  rec.res.mean_cost)
            tasks_, weights = get_network_tasks("resnet_50", 1, 224,
                                                NET_TARGET)
            own = 0.0
            for task, w in zip(tasks_, weights):
                own += best[task.workload_key] * w
            (d_ms, r_ms), text2 = quiet(search.main, [RESNET50_LOG,
                                                      "--target", NET_TARGET])
            log(f"[21] {text.strip()}; the sum of weight x best cost "
                f"{own * 1e3:.6f} ms; search: {text2.strip()}")
            if not (missing == 0 and f"{total * 1e3:.3f}" == "9.400"
                    and total == own == d_ms and r_ms >= d_ms) or others() \
                    or seg.launches:
                raise RuntimeError(f"[21] estimate {total} ({missing} "
                                   f"missing), own {own}, search {d_ms}, "
                                   f"{r_ms}")
        finally:
            for cls, fn in fit_orig.items():
                cls.fit_base = fn
            if env_before is None:
                os.environ.pop("VES_DATASET_ROOT", None)
            else:
                os.environ["VES_DATASET_ROOT"] = env_before
            common.set_dataset_root()
    secs = time.perf_counter() - t_phase
    log(f"[21] phase 21: {secs:.1f} s (budget {NET_BUDGET_S:.0f} s)")
    if secs > NET_BUDGET_S:
        log(f"[21] over its budget of {NET_BUDGET_S:.0f} s")
    launches = {"forward": train["mlp"]["forward_launches"] + eval_launches,
                "backward": train["mlp"]["backward_launches"]}
    return {"seconds": secs, "grid_entries": len(dumped),
            "hold_out": {"tasks": len(ho.tasks()), "records": len(ho)},
            "preset_files": kept, "metrics": metrics, "train": train,
            "scores": {n: {str(k): v for k, v in s_.items()}
                       for n, s_ in scores.items()},
            "eval_s": eval_s,
            "mlp_cpu_vs_card": {"max_abs_err": max_err,
                                "same_top5_tasks": same_picks,
                                "tasks": len(tasks)},
            "estimate_ms": total * 1e3, "search_ms": [d_ms * 1e3, r_ms * 1e3],
            "segment_sum_launches": launches}


def kernel_wrappers():
    """The five kernels' wrappers by name (each counts its launches)."""
    from vae_extent_search_tpu_torch.ops import conv2d as oc
    from vae_extent_search_tpu_torch.ops import fused_head as fh
    from vae_extent_search_tpu_torch.ops import hist as th
    from vae_extent_search_tpu_torch.ops import matmul as om
    from vae_extent_search_tpu_torch.ops import segment_sum as tss

    return {"fused_head_stats": fh.fused_head_stats, "hist": th.hist,
            "matmul": om.matmul, "conv2d": oc.conv2d,
            "segment_sum": tss.segment_sum}


def cli_width(device):
    """cli.vae_extent_search's options for ARMS["width"] on ``device``."""
    args = ["--device", device]
    for k, v in ARMS["width"].items():
        args += ["--" + k.replace("_", "-"), str(v)]
    return args


def count_checks(kernels):
    """(reset, others): set every launch count to 0; the nonzero counts
    of the kernels other than the fused head."""
    fh = kernels["fused_head_stats"]

    def reset():
        for k in kernels.values():
            k.launches = 0

    def others():
        return {nm: k.launches for nm, k in kernels.items()
                if k is not fh and k.launches}

    return reset, others


def arm_job(job, device):
    """One of phase 20's arms: "inits" (one pretrain, then the diversity
    and kmeans initial sets), "vib" or "grid". Phase 20 runs each in a
    process of its own, side by side: each is bound by its host's eager
    launches (the card idles ~0.94 of a search, PERF.md), so a process per
    arm shortens the phase without changing what the card does for any
    arm. Each process has its own launch counts; they are set to 0 just
    before an arm runs and read just after. Returns (results, log lines,
    failures)."""
    import vae_extent_search_tpu_torch.cli.vae_extent_search as cli
    from vae_extent_search_tpu_torch.data.pool import load_pool
    from vae_extent_search_tpu_torch.device import resolve_device
    from vae_extent_search_tpu_torch.search.active_loop import (
        expand_hyper_grid,
        pretrain_pool_vae,
        run_active_search,
    )

    resolve_device(device)
    kernels = kernel_wrappers()
    fh = kernels["fused_head_stats"]
    feats, labels, _ = load_pool()
    width = ARMS["width"]
    out, lines, bad = {}, [], []
    reset, others = count_checks(kernels)
    if job in ("inits", "vib"):
        vae = None
        if job == "inits":
            t = time.perf_counter()
            vae = pretrain_pool_vae(feats, latent_dim=width["latent_dim"],
                                    hidden_dim=width["hidden_dim"],
                                    vae_epochs=width["vae_epochs"],
                                    device=device)
            out["vae_pretrain_s"] = time.perf_counter() - t
            runs = [("diversity", "vae", s) for s in ARMS["diversity"]]
            runs += [("kmeans", "vae", s) for s in ARMS["kmeans"]]
        else:
            runs = [("random", "vib", s) for s in ARMS["vib"]]
        for init_mode, enc, seed in runs:
            reset()
            t = time.perf_counter()
            r = run_active_search(
                feats, labels, measure_size=ARMS["measure_size"],
                max_phases=60, sampling_seed=seed, init_mode=init_mode,
                encoder_mode=enc, pretrained_vae_params=vae, device=device,
                **width)
            wall = time.perf_counter() - t
            init = [int(i) for i in r.selected_order[:ARMS["measure_size"]]]
            label = f"{enc} {init_mode}" if enc == "vae" else enc
            row = {"found": r.found, "phases": r.phase,
                   "train_size": r.train_size, "wall_s": wall,
                   "fit_s": sum(r.fit_seconds),
                   "select_s": sum(r.select_seconds),
                   "launches": fh.launches, "init_distinct": len(set(init))}
            out.setdefault(label, {})[str(seed)] = row
            lines.append(
                f"{label} seed {seed}: found={r.found} phases={r.phase} "
                f"train_size={r.train_size} wall {wall:.1f} s (predictor "
                f"fits {row['fit_s']:.1f} s, selection {row['select_s']:.3f}"
                f" s); initial set {len(set(init))} distinct of {len(init)};"
                f" fused-head launches {fh.launches}")
            if not r.found or fh.launches != r.phase or others() or \
                    len(set(init)) != ARMS["measure_size"]:
                bad.append(f"{label} seed {seed}: {row}, {others()}")
        return out, lines, bad

    # the grid arm through the command line: the average CSV pre-filled
    # with every (measure_size, weights) pair of DEFAULT_GRID but one
    left = ARMS["grid_pair"]
    pairs = {(c["measure_size"], str(tuple(c["weights"])))
             for c in expand_hyper_grid(cli.DEFAULT_GRID)}
    pretrains = []
    orig = cli.pretrain_pool_vae

    def counted(*a, **kw):
        pretrains.append(1)
        return orig(*a, **kw)

    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        avg_csv = os.path.join(out_dir, "vae_extent_total_avg.csv")
        with open(avg_csv, "w") as f:
            f.write("measure_size,weights,phase,train_size,used_time,top-1,"
                    "found,n_seeds\n")
            for ms, w in sorted(pairs - {(left[0], str(left[1]))}):
                f.write(f'{ms},"{w}",0,0,0,0,1,0\n')
        reset()
        cli.pretrain_pool_vae = counted
        buf = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["--arm", "grid", "--out-dir", out_dir, "--seeds",
                          "2000", *cli_width(device)])
        finally:
            cli.pretrain_pool_vae = orig
        wall = time.perf_counter() - t
        with open(avg_csv) as f:
            rows = list(csv.DictReader(f))[len(pairs) - 1:]
    phases = sum(int(float(r["phase"])) for r in rows)
    out["grid"] = {"pair": [left[0], str(left[1])], "configs": len(rows),
                   "pretrains": len(pretrains), "wall_s": wall,
                   "phases": [float(r["phase"]) for r in rows],
                   "train_size": [float(r["train_size"]) for r in rows],
                   "found": [float(r["found"]) for r in rows],
                   "launches": fh.launches}
    lines.append(
        f"grid arm, pair {left}: {buf.getvalue().splitlines()[0]}; "
        f"{len(rows)} configs, {len(pretrains)} pretrain, phases "
        f"{out['grid']['phases']}, train_size {out['grid']['train_size']}, "
        f"found {out['grid']['found']}; {wall:.1f} s wall; fused-head "
        f"launches {fh.launches}")
    if (len(rows) != 4 or len(pretrains) != 1
            or any(r["measure_size"] != str(left[0])
                   or r["weights"] != str(left[1]) or r["found"] != "1.0"
                   for r in rows)
            or fh.launches != phases or others()):
        bad.append(f"grid arm: {rows}, {len(pretrains)} pretrains, "
                   f"launches {fh.launches}, {others()}")
    return out, lines, bad


def arms_phases(dev, kernels):
    """Phase 20: the headline experiment's other arms on the committed
    pool at full width: SelectionConfig(fused_head="off") on the card;
    then side by side, a process each (``arm_job``), the diversity and
    kmeans initial sets, the vib encoder and the grid arm through the
    command line; then, alone on the card, a --profile-dir run whose
    trace gives the device idle share. Returns the arms' results."""
    import vae_extent_search_tpu_torch.cli.vae_extent_search as cli
    from vae_extent_search_tpu_torch.cli.trace_summary import (
        report,
        summarize,
    )
    from vae_extent_search_tpu_torch.convert import params_from_numpy
    from vae_extent_search_tpu_torch.data.pool import load_pool
    from vae_extent_search_tpu_torch.search.active_loop import standardize
    from vae_extent_search_tpu_torch.search.select import (
        SelectionConfig,
        select_programs,
    )

    fh = kernels["fused_head_stats"]
    feats, _, _ = load_pool()
    n = feats.shape[0]
    width = ARMS["width"]
    out = {}
    reset, others = count_checks(kernels)

    # ---- fused_head="off" forces the unfused path on the card ----
    rng = np.random.default_rng(20)
    p = params_from_numpy(rand_params(rng, feats.shape[1],
                                      width["hidden_dim"], width["latent_dim"],
                                      width["hidden_dim"]),
                          dev, torch.float32)
    x = torch.as_tensor(standardize(feats)[0], device=dev)
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    used[:32] = True
    picks = {}
    for mode in ("off", "auto"):
        reset()
        with torch.no_grad():
            sel, val, _, _ = select_programs(
                p, x, used, ~used, torch.Generator(device=dev).manual_seed(21),
                SelectionConfig(num_select=32, fused_head=mode))
        picks[mode] = (fh.launches, int(val.sum()),
                       len(set(sel[val].tolist())))
    log(f"[20] select_programs at N={n}: fused_head='off' {picks['off'][0]} "
        f"kernel launches, 'auto' {picks['auto'][0]}; valid / distinct picks "
        f"{picks['off'][1:]} / {picks['auto'][1:]}")
    if picks["off"] != (0, 32, 32) or picks["auto"] != (1, 32, 32):
        raise RuntimeError(f"[20] fused_head off/auto: {picks}")
    out["fused_head_off_launches"] = picks["off"][0]

    # ---- the inits, vib and grid arms, a process each, side by side ----
    jobs = ("grid", "inits", "vib")
    t = time.perf_counter()
    with ProcessPoolExecutor(len(jobs), mp_context=get_context(
            "spawn")) as pool:
        futures = [pool.submit(arm_job, job, dev.type) for job in jobs]
        done = [f.result() for f in futures]
    out["side_by_side_s"] = time.perf_counter() - t
    bad = []
    for res, lines, failed in done:
        out.update(res)
        for line in lines:
            log(f"[20] {line}")
        bad += failed
    log(f"[20] the three processes took {out['side_by_side_s']:.1f} s wall "
        f"side by side (each arm's wall above is its own, beside the other "
        f"two)")
    if bad:
        raise RuntimeError(f"[20] {bad}")

    # ---- --profile-dir: a torch.profiler trace and the idle share ----
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = os.path.join(tmp, "trace")
        done = []
        orig = cli._dispatch

        def timed(args):
            orig(args)
            torch.cuda.synchronize()
            done.append(time.perf_counter())

        reset()
        cli._dispatch = timed
        buf = io.StringIO()
        t_run = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["--out-dir", os.path.join(tmp, "out"), "--seeds",
                          str(ARMS["profile_seed"]), "--measure-size",
                          str(ARMS["measure_size"]), "--max-phases",
                          str(ARMS["profile_phases"]), "--profile-dir",
                          trace_dir, *cli_width(dev.type), "--vae-epochs",
                          str(ARMS["profile_vae_epochs"])])
        finally:
            cli._dispatch = orig
        t_end = time.perf_counter()
        files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        if len(files) != 1:
            raise RuntimeError(f"[20] --profile-dir wrote {files}")
        size = os.path.getsize(files[0])
        t = time.perf_counter()
        tr = summarize(files[0])
        parse_s = time.perf_counter() - t
    head = sum(c[0] for n, c in tr["kernels_by_name"].items()
               if "fused_head_kernel" in n)
    finish = sum(c[0] for n, c in tr["kernels_by_name"].items()
                 if "mc_finish_kernel" in n)
    fits = tr["spans"].get("fit_predictor", [])
    lines = report(tr)
    del tr["kernels_by_name"]
    tr.update(run_s=done[0] - t_run, write_s=t_end - done[0], bytes=size,
              parse_s=parse_s, launches=fh.launches,
              fused_head_kernel=head, mc_finish_kernel=finish)
    out["profile"] = tr
    seed_line = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("seed ")]
    log(f"[20] --profile-dir, seed {ARMS['profile_seed']}, --max-phases "
        f"{ARMS['profile_phases']}, --vae-epochs "
        f"{ARMS['profile_vae_epochs']}: {seed_line}; run {tr['run_s']:.1f} s "
        f"traced, trace written in {tr['write_s']:.1f} s, {size / 2**20:.1f} "
        f"MiB, read in {parse_s:.1f} s")
    for line in lines:
        log(f"[20] {line}")
    log(f"[20] fused_head_kernel events {head}, mc_finish_kernel {finish}; "
        f"the wrapper's launches {fh.launches}")
    if (not tr["kernel_events"] or not head or head != fh.launches
            or len(fits) != ARMS["profile_phases"] or others()):
        raise RuntimeError(f"[20] trace: {tr['kernel_events']} kernel events,"
                           f" {head} fused-head for {fh.launches} launches, "
                           f"{len(fits)} fits; {others()}")
    return out


def head_phases(dev, peaks, fh, th):
    """Phases 2-6: the fused cost head against its plain version, its
    times, one selection phase at the bench shape and the search end to
    end on the committed pool. Returns the kernel's result record."""
    from vae_extent_search_tpu_torch.cli.vae_extent_search import (
        run_experiment,
    )
    from vae_extent_search_tpu_torch.convert import params_from_numpy
    from vae_extent_search_tpu_torch.data.pool import load_pool
    from vae_extent_search_tpu_torch.search.select import (
        SelectionConfig,
        select_programs,
    )

    feats, labels, _ = load_pool()
    main_shape = dict(n=feats.shape[0], d=feats.shape[1], hid=256, lat=64,
                      hp=256, T=10)

    def setup(shape, dtype, seed):
        rng = np.random.default_rng(seed)
        p = params_from_numpy(rand_params(rng, shape["d"], shape["hid"],
                                          shape["lat"], shape["hp"]),
                              dev, dtype)
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(shape["n"], shape["d"], generator=g, device=dev)
        return p, x.to(dtype)

    def call(p, x, shape, seed=0, bits=None):
        return fh.fused_head_stats(
            p["cost_predictor"], x, seed, T=shape["T"], rate=0.1,
            mask_bits=bits, encoder=(p["encoder"], p["fc_mu"]))

    def plain(p, x, shape, bits=None, gen=None):
        return fh.fused_head_stats_plain(
            p["cost_predictor"], x, shape["T"], 0.1, mask_bits=bits,
            generator=gen, encoder=(p["encoder"], p["fc_mu"]))

    def words(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-2 ** 31, 2 ** 31, (shape["T"], shape["n"],
                                                 shape["hp"]),
                             generator=g, device=dev,
                             dtype=torch.int32).view(torch.uint32)

    def plan(shape):
        """(G, pass bounds, blocks) of the wrapper's launch plan."""
        G, bounds = fh.launch_plan(shape["n"], shape["T"], fh.sm_count(dev))
        return G, bounds, -(-shape["n"] // fh.BM) * G

    def log_plan(label, shape, dtype):
        G, bounds, blocks = plan(shape)
        passes = [b - a for a, b in zip(bounds, bounds[1:])]
        log(f"[2] {label} N={shape['n']} T={shape['T']} {dtype_name(dtype)}:"
            f" plan G={G}, {blocks} blocks, passes per group {passes}")
        return G

    # ---- 2. kernel vs plain, injected bits ----
    names = ("cost", "gnorm", "mc_mean", "mc_var")
    uneven = dict(main_shape, T=7)
    errors = {}
    for label, shape, dtypes in (
            ("main", main_shape, (torch.float32, torch.bfloat16)),
            ("bench", BENCH, (torch.float32, torch.bfloat16)),
            ("uneven", uneven, (torch.float32,))):
        for dtype in dtypes:
            G = log_plan(label, shape, dtype)
            p, x = setup(shape, dtype, 1)
            bits = words(shape, 2)
            got = call(p, x, shape, bits=bits)
            torch.cuda.synchronize()
            ref = plain(p, x, shape, bits=bits)
            rel, mabs = {}, 0.0
            for nm, g, r in zip(names, got, ref):
                if g.shape != (shape["n"],) or not torch.isfinite(g).all():
                    raise RuntimeError(f"{label} {dtype}: {nm} not finite "
                                       f"or of shape {tuple(g.shape)}")
                rel[nm] = float((g - r).abs().max() / r.abs().max())
                mabs = max(mabs, float((g - r).abs().max()))
            errors[(label, dtype)] = (rel, mabs)
            log(f"[2] {label} N={shape['n']} {dtype_name(dtype)}: rel err "
                + " ".join(f"{k}={v:.2e}" for k, v in rel.items())
                + f" (tol {TOL[dtype]:g}); max abs {mabs:.3e}")
            if max(rel.values()) > TOL[dtype]:
                raise RuntimeError(f"kernel disagrees with plain: {label} "
                                   f"{dtype}: {rel}")
            if G > 1:
                again = call(p, x, shape, bits=bits)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise RuntimeError(f"{label} {dtype}: two launches at "
                                       f"G={G} differ")
                log(f"[2] {label} {dtype_name(dtype)}: two launches at G={G} "
                    f"bit-identical")
            del bits, got, ref

    # ---- 3. Philox path ----
    for label, shape in (("main", main_shape), ("bench", BENCH)):
        p, x = setup(shape, torch.float32, 3)
        inj = call(p, x, shape, bits=words(shape, 4))
        ph = call(p, x, shape, seed=11)
        if not (torch.equal(ph[0], inj[0]) and torch.equal(ph[1], inj[1])):
            raise RuntimeError(f"{label}: Philox run changed cost/gnorm")
    k_var, k_off, r_var, r_off = [], [], [], []
    for s in range(4):
        k = call(p, x, BENCH, seed=100 + s)
        r = plain(p, x, BENCH,
                  gen=torch.Generator(device=dev).manual_seed(200 + s))
        k_var.append(float(k[3].mean()))
        k_off.append(float((k[2] - k[0]).mean()))
        r_var.append(float(r[3].mean()))
        r_off.append(float((r[2] - r[0]).mean()))
    k_var, k_off = np.mean(k_var), np.mean(k_off)
    r_var, r_off = np.mean(r_var), np.mean(r_off)
    log(f"[3] Philox: cost/gnorm bit-equal to injected run (main, bench); "
        f"mean mc_var {k_var:.6e} vs plain {r_var:.6e}; mean mc offset "
        f"{k_off:.6e} vs plain {r_off:.6e} (bench, 4 seeds each)")
    if abs(k_var - r_var) > 0.05 * r_var or abs(k_off - r_off) > \
            0.05 * abs(r_off):
        raise RuntimeError("Philox MC statistics outside the 5% band")

    # ---- 4. timing (device time; the host's ms per call beside) ----
    times = {}
    # (the plain version's ~100 launches per call outlast the card
    # timer's blocker at the main shape: it is timed by back-to-back
    # events, host included, as before)
    for label, shape, iters in (("main", main_shape, 10), ("bench", BENCH, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            p, x = setup(shape, dtype, 5)
            gen = torch.Generator(device=dev).manual_seed(6)
            k_ms, k_host = card_ms(lambda: call(p, x, shape, seed=7))
            p_ms = cuda_ms(lambda: plain(p, x, shape, gen=gen), iters)
            b_ms, b_by = bound_ms(shape["n"], shape["d"], shape["hid"],
                                  shape["lat"], shape["hp"], shape["T"],
                                  dtype, peaks)
            times[(label, dtype)] = (k_ms, p_ms, b_ms, b_by, k_host)
            log(f"[4] {label} N={shape['n']} {dtype_name(dtype)}: kernel "
                f"{k_ms:.4f} ms (host {k_host:.4f} ms per call), plain "
                f"{p_ms:.4f} ms (events), bound {b_ms:.4f} ms "
                f"({b_by}); kernel at {100 * b_ms / k_ms:.1f}% of bound")
    # the split alone: the main shape at every G up to T (from G = 6 on
    # 132 SMs, some SMs hold two blocks)
    p, x = setup(main_shape, torch.float32, 5)
    G_plan, _, _ = plan(main_shape)
    tiles = -(-main_shape["n"] // fh.BM)
    by_g = {}
    for G in range(1, main_shape["T"] + 1):
        by_g[G] = card_ms(lambda: fh.fused_head_stats(
            p["cost_predictor"], x, 7, T=main_shape["T"], rate=0.1,
            encoder=(p["encoder"], p["fc_mu"]), groups=G))
        log(f"[4] main N={main_shape['n']} float32 at G={G} ({tiles * G} "
            f"blocks{', the plan' if G == G_plan else ''}): "
            f"{by_g[G][0]:.4f} ms (host {by_g[G][1]:.4f})")

    # ---- 5. one select_programs phase at the bench shape ----
    cfg = SelectionConfig(num_select=64, T_mc=10, topk_factor=5, grad_num=2,
                          rand_num=0, compute_dtype="bfloat16")
    p, x = setup(BENCH, torch.float32, 8)
    n = BENCH["n"]
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    used[:256] = True
    rem = ~used
    cidx = torch.zeros(cfg.max_centers, dtype=torch.int64, device=dev)
    cidx[:256] = torch.arange(256, device=dev)
    cval = torch.arange(cfg.max_centers, device=dev) < 256
    gen = torch.Generator(device=dev).manual_seed(9)

    def phase():
        with torch.no_grad():
            sel, val, _, _ = select_programs(p, x, used, rem, gen, cfg,
                                             center_idx=cidx,
                                             center_valid=cval)
        return sel.cpu().numpy()[val.cpu().numpy()]

    for _ in range(2):
        phase()
    ph_times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        picked = phase()
        ph_times.append((time.perf_counter() - t0) * 1e3)
    if len(set(picked.tolist())) != cfg.num_select or picked.min() < 256:
        raise RuntimeError(f"bad selection: {picked}")
    ph_ms = float(np.median(ph_times))
    log(f"[5] select_programs phase N={n} bf16: median {ph_ms:.3f} ms "
        f"(min {min(ph_times):.3f}, max {max(ph_times):.3f}, 10 phases) = "
        f"{n / (ph_ms / 1e3):.0f} candidates/s; {len(picked)} picked")

    # ---- 6. end to end on the main path ----
    fh.fused_head_stats.launches = 0
    th.hist.launches = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        rows, avg = run_experiment(
            None, out_dir, measure_size=32, seeds=PHASE6_SEEDS,
            max_phases=60, vae_epochs=500, reg_epochs=1000, latent_dim=64,
            hidden_dim=256, device="cuda")
    e2e_s = time.time() - t0
    launches = fh.fused_head_stats.launches
    phases = sum(r["phase"] for r in rows)
    for r in rows:
        log(f"[6] seed {r['sampling_seed']}: found={r['found']} "
            f"phase={r['phase']} train_size={r['train_size']} "
            f"used_time={r['used_time']} s")
    log(f"[6] avg phase {avg['phase']:.2f} train_size "
        f"{avg['train_size']:.1f} found {avg['found']:.2f}; wall {e2e_s:.1f}"
        f" s incl. the shared VAE pretrain; kernel launches {launches} for "
        f"{phases} selection phases")
    if any(r["found"] != 1 for r in rows):
        raise RuntimeError("a seed did not find the optimum")
    if launches != phases or launches == 0 or th.hist.launches:
        raise RuntimeError(f"{launches} kernel launches for {phases} phases"
                           f" ({th.hist.launches} histogram launches)")

    k_ms, p_ms, b_ms, b_by, k_host = times[("main", torch.float32)]
    bk, bp, bb, _, _ = times[("bench", torch.bfloat16)]
    fk, fp, fb, _, _ = times[("bench", torch.float32)]
    return {
        "name": "fused_head_stats",
        "route": "cuda",
        "source": "vae_extent_search_tpu_torch/csrc/fused_head.cu",
        "replaces": "vae_extent_search_tpu/ops/fused_head_pallas.py:66",
        "launches": launches,
        "max_abs_err": errors[("main", torch.float32)][1],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "host_ms": k_host,
        "one_group_ms": by_g[1][0],
        "checks": {
            "max_rel_err": {f"{lbl}_{dtype_name(dt)}": max(r.values())
                            for (lbl, dt), (r, _) in errors.items()},
            "tolerance": {dtype_name(dt): t for dt, t in TOL.items()},
            "philox": {"cost_gnorm_bit_equal": True,
                       "mc_var_mean": [k_var, r_var],
                       "mc_offset_mean": [k_off, r_off]},
            "e2e_found": [r["found"] for r in rows],
        },
        "shape": {**main_shape, "dtype": "float32"},
        "bench": {"shape": {**BENCH, "dtype": "bfloat16"}, "ms": bk,
                  "plain_ms": bp, "bound_ms": bb,
                  "float32_ms": fk, "float32_plain_ms": fp,
                  "float32_bound_ms": fb},
        "select_phase_ms": ph_ms,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("head", "arms", "conv_f32",
                                       "networks"),
                    help="head: run phases 1-6 alone (the fused cost head); "
                         "arms: phases 1 and 20 (the experiment's other "
                         "arms); conv_f32: phase 1, then the float32 conv2d's "
                         "part of phases 12 and 14; networks: phases 1 and "
                         "21 (the network-level evaluation); each ends with "
                         "{\"partial\": ...} instead of the result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")
    from vae_extent_search_tpu_torch.device import resolve_device
    from vae_extent_search_tpu_torch.ops import conv2d as oc
    from vae_extent_search_tpu_torch.ops import fused_head as fh
    from vae_extent_search_tpu_torch.ops import hist as th
    from vae_extent_search_tpu_torch.ops import matmul as om
    from vae_extent_search_tpu_torch.ops import segment_sum as tss

    dev = resolve_device("cuda")
    t_start = time.time()

    # ---- 1. device and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    log(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    libs = (fh.LIB, th.LIB, om.LIB, oc.LIB, tss.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        builds = list(pool.map(lambda lib: lib.build(force=True), libs))
    for lib, (_, out, secs) in zip(libs, builds):
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  out)})
        spills = [l.strip() for l in out.splitlines() if "spill" in l and
                  "0 bytes spill stores, 0 bytes spill loads" not in l]
        log(f"[1] nvcc build of {os.path.relpath(lib.source, ROOT)}: "
            f"{secs:.2f} s; {out.count('registers')} kernel instances using "
            f"{regs} registers; {len(spills)} spill"
            + (f" ({spills[0]})" if spills else ""))
    log(f"[1] all builds: {time.perf_counter() - t0:.2f} s wall")
    # the fused head's register tile and its staged next chunk must stay
    # in registers: no instance may spill
    head_regs = {name: rs for name, rs in ptxas_report(builds[0][1]).items()
                 if "fused_head_kernel" in name}
    log(f"[1] fused_head_kernel instances (registers, spill bytes): "
        f"{sorted(head_regs.values())}")
    if not head_regs or any(sp for _, sp in head_regs.values()):
        raise RuntimeError(f"[1] fused_head_kernel spills: {head_regs}")
    # the f32 matmul's and conv2d's 64 (or 32) accumulators and their
    # fragments stay in registers at two blocks per SM: no instance may spill
    # (the conv's instances are (bm, bn, KWT): KWT 3 for KW = 3, 0 for any)
    for out, kern, key, want in (
            (builds[2][1], "mm_f32", "(bm, bn)",
             {(bm, bn) for bm in om.F32_BM for bn in om.F32_BN}),
            (builds[3][1], "conv_f32", "(bm, bn, KWT)",
             {(bm, bn, k) for bm in oc.F32_BM for bn in oc.F32_BN
              for k in (0, 3)})):
        f32_regs = {}
        for name, rs in ptxas_report(out).items():
            m = re.search(kern + r"I((?:Li\d+E)+)", name)
            if m:
                f32_regs[tuple(int(v) for v in re.findall(
                    r"Li(\d+)E", m.group(1)))] = rs
        log(f"[1] {kern} instances {key}: (registers, spill bytes) "
            + ", ".join(f"{k}: {v}" for k, v in sorted(f32_regs.items())))
        if set(f32_regs) != want or any(sp for _, sp in f32_regs.values()):
            raise RuntimeError(f"[1] {kern} instances or spills: {f32_regs}")
    # the bf16 instances run on the tensor cores: every one of them holds
    # the instruction (HGMMA: wgmma; HMMA: mma.sync), no f32 instance does
    for lib, kern, op in ((om.LIB, "mm_", "HGMMA"), (oc.LIB, "conv_", "HMMA")):
        funcs = sass_functions(lib.library)
        counts = {name: sum(op in ln for ln in text)
                  for name, text in funcs.items() if kern in name}
        bf16 = [n for n in counts if f"{kern}bf16" in n]
        f32 = [n for n in counts if f"{kern}f32" in n]
        log(f"[1] cuobjdump -sass {lib.library.name}: {op} in the "
            f"{len(bf16)} bf16 instances {sorted(counts[n] for n in bf16)}, "
            f"in the {len(f32)} f32 instances {sum(counts[n] for n in f32)}")
        if not bf16 or not all(counts[n] for n in bf16) or any(
                counts[n] for n in f32):
            raise RuntimeError(f"[1] {lib.library.name}: {op} counts {counts}")
        # the f32 rings are filled by cp.async (LDGSTS)
        ldgsts = {n: sum("LDGSTS" in ln for ln in funcs[n]) for n in f32}
        log(f"[1] cuobjdump -sass {lib.library.name}: LDGSTS in the "
            f"{len(f32)} f32 instances {sorted(ldgsts.values())}")
        if not f32 or not all(ldgsts.values()):
            raise RuntimeError(f"[1] {lib.library.name}: LDGSTS counts "
                               f"{ldgsts}")

    # the histogram kernel adds with 32-bit shared-memory atomics: its only
    # atomic instructions are ATOMS.ADD, with no compare-and-swap loop
    # (which is what a 64-bit shared add compiles to) and no global atomic
    # or reduction (ATOMG, RED): partial sums are stored, not added
    hist_sass = {name: atomic_census(text) for name, text in
                 sass_functions(th.LIB.library).items()
                 if "hist_kernel" in name}
    log(f"[1] cuobjdump -sass {th.LIB.library.name}: atomic instructions "
        f"of the {len(hist_sass)} hist_kernel instances {hist_sass}")
    if not hist_sass or any(
            not ops or any(not op.startswith("ATOMS.ADD") or "CAS" in op
                           for op in ops) for ops in hist_sass.values()):
        raise RuntimeError(f"[1] {th.LIB.library.name}: atomics {hist_sass}")

    kernels = kernel_wrappers()
    if args.only == "conv_f32":
        record = conv_f32_phases(dev, peaks, kernels)
        log(f"total {time.time() - t_start:.1f} s")
        log(card)
        print(json.dumps({"kernels": [record]}, default=float), flush=True)
        print(json.dumps({"partial": "conv_f32"}), flush=True)
        return
    if args.only == "networks":
        net = network_phases(dev, kernels)
        log(f"total {time.time() - t_start:.1f} s")
        print(json.dumps({"networks": net}, default=float), flush=True)
        log(card)
        print(json.dumps({"partial": "networks"}), flush=True)
        return
    if args.only == "arms":
        arms = arms_phases(dev, kernels)
        log(f"total {time.time() - t_start:.1f} s")
        print(json.dumps({"arms": arms}, default=float), flush=True)
        log(card)
        print(json.dumps({"partial": "arms"}), flush=True)
        return
    records = [head_phases(dev, peaks, fh, th)]
    if args.only == "head":
        log(f"total {time.time() - t_start:.1f} s")
        log(card)
        print(json.dumps({"kernels": records}, default=float), flush=True)
        print(json.dumps({"partial": "head"}), flush=True)
        return
    shared = {}
    records += [gbdt_phases(dev, peaks, fh, th),
                *tuner_phases(dev, peaks, kernels),
                segment_phases(dev, peaks, kernels, shared)]
    arms = arms_phases(dev, kernels)
    net = network_phases(dev, kernels, shared.get("resnet50_ds"))
    # the segment sum's launches on phase 21's path join its record
    seg_rec = records[-1]
    seg_rec["launches_by_path"]["21"] = net["segment_sum_launches"]
    for way in ("forward", "backward"):
        seg_rec[f"{way}_launches"] += net["segment_sum_launches"][way]
        seg_rec["launches"] += net["segment_sum_launches"][way]

    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"arms": arms}, default=float), flush=True)
    print(json.dumps({"networks": net}, default=float), flush=True)
    log(card)
    print(json.dumps({"kernels": records}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
