"""On-card smoke test of the PyTorch/CUDA port (needs one NVIDIA GPU).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device and build: the card's name and power limit; nvcc builds the
     four kernels from csrc/ for sm_90a, one nvcc per source, started
     together
  2. kernel vs plain torch version with injected dropout bits, at the
     main path's shape (the committed pool: N=773, D=17) and at the bench
     shape (N=262,144, D=24, H=256, L=64, T=10, rate 0.1), float32 and
     bfloat16
  3. the in-kernel Philox path: cost and gnorm equal the injected-bits
     run bit for bit; the mean MC variance and the mean MC offset
     (mc_mean - cost) are within 5% of the plain version fed
     torch-Generator bits
  4. timing with CUDA events: kernel, plain version and the bound
  5. one full select_programs phase at the bench shape (bfloat16)
  6. end to end: the active search on the committed pool at full width
     (hidden 256, latent 64, T 10, measure size 32, 500 VAE epochs, 1000
     predictor epochs) for seeds 2000-2002; every seed must find the
     optimum, and every selection phase must have gone through the kernel
  7. the histogram kernel vs its plain version in float64 at the
     pretraining shape (the corpus of data/boost_corpus.py: 1,000,000 rows
     x 164 features, 256 bins, the first round's gradient, a non-constant
     hessian) at every level (m = 1, 2, ..., 32 nodes) and at an odd shape
     (n 700, d 9, m 4, nb 40): within 1e-5 of max |H|, and two launches
     bit-identical
  8. histogram times with CUDA events at every level (m = 1 ... 32) beside
     the byte bound, the plain version and the index_add_ yardstick
  9. GBDT pretraining at full width: GBDTModelInternal.fit_base on that
     corpus (depth 6, eta 0.2, pack-sum objective, tr-rmse and a-peak@1)
     on the device engine for 50 rounds (cut from 300 with early stopping
     for the time limit): 6 kernel launches per round, and 3 rounds on a
     50,000-row subset agree with the numpy grower (pack-prediction
     correlation > 0.999). fit_base is timed whole, and its rounds alone
     by a second run of the device engine, which must grow the same
     trees, on phase 7's binned corpus. At ~20 rows per
     program the protocol's rmse grows on either engine
     (data/boost_corpus.py says why), so the same fit on the generator's
     4-rows-per-program corpus, with engine "auto", must go through the
     kernel and show a falling tr-rmse
 10. the gbdt arm end to end on the committed pool (measure size 32, seeds
     2000-2002, device engine): every seed must find the optimum, and
     every phase must have grown its 100 trees through the kernel; at each
     level, the first phase's launch whose rows lie in the most nodes is
     held against the plain version as in phase 7
 11. the matmul kernel (csrc/matmul.cu) vs its plain version at lattice
     configs of 1536^3 and of odd shapes, among them a non-square tile and
     one whose bk is the whole K, in float32 (rel tol 1e-5) and bfloat16
     (rel 1e-2 against the f32 plain version of the same bf16 inputs); two
     launches bit-identical; the plain version's time beside the bound at
     1536^3 bf16 (the kernel's and cuBLAS's come from phase 13)
 12. the same for the conv2d kernel (csrc/conv2d.cu) at the JAX tests'
     shapes and at 1 x 56 x 56 x 256 -> 256, 3 x 3, pad 1
 13. self-tuning end to end: cli.tune_kernel on the matmul at the JAX
     defaults (1536^3 bf16, 1,000 candidates, measure size 16, 6 phases,
     VAE 500 epochs, predictor 1000 epochs), --arm model then --arm
     random; every timed config went through the kernel (its launch count
     grew), none failed to launch, the record log holds every measured
     state; the best config against cuBLAS
 14. the same for conv2d at 1 x 56 x 56 x 256 -> 256, 3 x 3, pad 1, bf16,
     against cuDNN
The last three lines are the card's name and power limit, a JSON object
with each kernel's check and times, then {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(*a):
    print(*a, flush=True)


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


# the pretraining shape of the GBDT slice (tools/chip_boost_bench.py):
# rows x features of the synthetic corpus, 50 rounds (cut from 300 with
# early stopping, for the time limit)
PRETRAIN = dict(n=1_000_000, d=164, rounds=50, depth=6)
HIST_TOL = 1e-5       # of max |H|, against the plain version in float64
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
    """Two kernel launches against the plain version in float64: finite,
    of shape [d, m, nb], bit-identical, and within HIST_TOL of max |H|.
    Records the errors in checks[label]; raises where one fails."""
    got = th.hist(b, nd, g, h, m, nb)
    again = th.hist(b, nd, g, h, m, nb)
    torch.cuda.synchronize()
    ref = th.hist_plain(b, nd, g.double(), h.double(), m, nb)
    errs, scales = [], []
    for a, a2, r in zip(got, again, ref):
        if a.shape != (b.shape[0], m, nb) or not torch.isfinite(a).all():
            raise RuntimeError(f"[hist] {label}: histogram not finite or of "
                               f"shape {tuple(a.shape)}")
        if not torch.equal(a, a2):
            raise RuntimeError(f"[hist] {label}: two launches differ")
        errs.append(float((a.double() - r).abs().max()))
        scales.append(float(r.abs().max()))
    checks[label] = {"max_abs_err": errs, "max_abs_ref": scales}
    log(f"[hist] {label} (n={b.shape[1]} d={b.shape[0]} m={m} nb={nb}): "
        f"max abs err g/h {errs[0]:.3e}/{errs[1]:.3e} of max |H| "
        f"{scales[0]:.4g}/{scales[1]:.4g} (tol {HIST_TOL:g} of max |H|); "
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

    # ---- 8. times per level ----
    levels = {}
    for level in range(PRETRAIN["depth"]):
        m = 1 << level
        nd = nodes(n, m)
        k_ms = cuda_ms(lambda: th.hist(bins, nd, grad, hess, m, nb), 10)
        b_ms, b_by = hist_bound_ms(n, d, m, nb, peaks)
        levels[m] = dict(ms=k_ms, bound_ms=b_ms, bound_by=b_by)
        if m in (1, 32):
            # the plain version, and the index_add_ yardstick: the same two
            # index_add_ calls on precomputed keys and values
            p_ms = cuda_ms(lambda: th.hist_plain(bins, nd, grad, hess, m, nb),
                           3, warmup=1)
            key = th.hist_keys(bins, nd, m, nb)
            vg, vh = grad.expand(d, n).reshape(-1), hess.expand(d, n).reshape(-1)
            og = torch.zeros(d * m * nb, device=dev)
            oh = torch.zeros_like(og)
            l_ms = cuda_ms(lambda: (og.index_add_(0, key, vg),
                                    oh.index_add_(0, key, vh)), 3, warmup=1)
            levels[m].update(plain_ms=p_ms, library_ms=l_ms)
            del key, vg, vh, og, oh
        log(f"[8] level {level} (m={m}): kernel {k_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), kernel at {100 * b_ms / k_ms:.1f}% of "
            f"bound" + (f"; plain {levels[m]['plain_ms']:.4f} ms, index_add_ "
                        f"{levels[m]['library_ms']:.4f} ms"
                        if m in (1, 32) else ""))
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
    # counted); a run repeats bit for bit, so it grows fit_base's trees
    torch.cuda.synchronize()
    t = time.perf_counter()
    again = boost_device.train(
        model._native_params(), dm, num_boost_round=rounds,
        obj=boost.pack_sum_square_error,
        fevals=[boost.pack_sum_rmse, boost.pack_sum_average_peak_score(1)],
        evals=[(dm, "tr")], metric="tr-rmse", stopping_rounds=100,
        verbose_eval=0, device=dev)
    torch.cuda.synchronize()
    ms_round = 1e3 * (time.perf_counter() - t) / rounds
    log(f"[9] 20 rows/program: {rounds} rounds timed alone: {ms_round:.2f} "
        f"ms per round ({per_round / ms_round * 100:.0f}% of it kernel time "
        f"by phase 8); binning {bin_s:.2f} s (phase 7)")
    if not np.array_equal(again.predict(rows[:4096]),
                          model.model.predict(rows[:4096])):
        raise RuntimeError("[9] a second run grew other trees")
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
                   "subset_engine_corr": corr},
        "launches_by_path": {"pretrain": pre_launches,
                             "pretrain_4_rows": launches_b,
                             "gbdt_arm": arm_launches},
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
             "1000", "--dtype", "bfloat16"]
# relative to max |plain|. float32: the same products summed in another
# order; bfloat16 inputs: against the f32 plain version of the same
# bf16-rounded inputs, so again only the order of the f32 sums differs (a
# kernel that rounded its output to bf16 would be off by about 2^-9)
GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def instance_cases(om, oc):
    """({dims: [matmul configs]}, {conv params: [conv2d configs]}) that
    between them launch each of the 16 thread micro-tiles (TM, TN) the
    kernels are built for (each .cu file holds one template instance per
    micro-tile and input type): the first valid config found per
    micro-tile at a few shapes chosen so that all 16 occur."""
    def divs(n):
        return [d for d in range(1, n + 1) if n % d == 0]

    mm, cv, seen_mm, seen_cv = {}, {}, set(), set()
    M, N, K = 1536, 768, 64
    for bm in divs(M):
        for bn in divs(N):
            t = om.thread_tile(bm, bn)
            if t and t not in seen_mm and om.config_is_valid(
                    M, N, K, bm, bn, 8, dtype="float32")[0]:
                seen_mm.add(t)
                mm.setdefault((M, N, K), []).append((bm, bn, 8))
    for params in ((1, 64, 3, 384, 16, 3, 3, 1), (1, 512, 1, 384, 8, 1, 1, 0)):
        n, h, w, co, ci, kh, kw, pad = params
        ow = w + 2 * pad - kw + 1
        for boh in divs(h + 2 * pad - kh + 1):
            for bco in divs(co):
                t = om.thread_tile(boh * ow, bco)
                if t and t not in seen_cv and oc.conv_config_is_valid(
                        n, h, w, co, ci, kh, kw, 1, pad, boh, bco, 8,
                        dtype="float32")[0]:
                    seen_cv.add(t)
                    cv.setdefault(params, []).append((boh, bco, 8))
    if len(seen_mm) != 16 or len(seen_cv) != 16:
        raise RuntimeError(f"micro-tiles reached: matmul {sorted(seen_mm)}, "
                           f"conv2d {sorted(seen_cv)}")
    return mm, cv


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


def tune_arms(tag, workload, best_launch, kernels, checks):
    """cli.tune_kernel with ``workload`` at TUNE_ARGS, arm model then arm
    random, each driven with every kernel count at 0 and read just after.
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
    for arm in ("model", "random"):
        buf = io.StringIO()
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            log_file = os.path.join(d, "tune.json")
            for k in kernels.values():
                k.launches = 0
            t = time.time()
            with contextlib.redirect_stdout(buf):
                summary, runner = tune(workload + TUNE_ARGS + [
                    "--arm", arm, "--log-file", log_file])
            wall = time.time() - t
            launches = {n: k.launches for n, k in kernels.items()}
            with open(log_file) as f:
                recs = [json.loads(ln) for ln in f if ln.strip()]
        text = buf.getvalue()
        with open(os.path.join(OUT_DIR, f"tune_{tag}_{arm}.log"), "w") as f:
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
        lib_s = "not timed" if lib is None else f"{lib:.4f} ms"
        log(f"[{tag}] arm {arm}: best {summary['best_cfg']} "
            f"{summary['best_ms']:.4f} ms = {summary['gflops'] / 1e3:.3f} "
            f"TFLOP/s; {runner.n_timed} configs timed ({len(ok)} ok, "
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
        tol = GEMM_TOL[torch.bfloat16]
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
                or {r["i"][0][1] for r in recs} != {"cuda -model=bfloat16"}):
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


def tuner_phases(dev, peaks, kernels):
    """Phases 11-14: the matmul and conv2d kernels against their plain
    versions, and the self-tuning path on both. Returns their result
    records."""
    from vae_extent_search_tpu_torch.ops import conv2d as oc
    from vae_extent_search_tpu_torch.ops import matmul as om
    from vae_extent_search_tpu_torch.search.kernel_tuner import cuda_seconds

    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # ---- 11. matmul kernel vs plain ----
    mm_inst, cv_inst = instance_cases(om, oc)
    mm_checks = {}
    for dims, cfgs in (
            ((MM_DIM,) * 3, [(128, 128, 64), (64, 256, 8), (2, 32, 8),
                             (4, 32, 1536)]),
            ((96, 160, 72), [(3, 32, 72)]), ((1000, 24, 40), [(8, 24, 40)]),
            *mm_inst.items()):
        M, N, K = dims
        for dtype in (torch.float32, torch.bfloat16):
            a, b = randn(M, K, dtype=dtype), randn(K, N, dtype=dtype)
            for cfg in cfgs:
                ok, why = om.config_is_valid(M, N, K, *cfg,
                                             dtype=dtype_name(dtype))
                if not ok:
                    raise RuntimeError(f"[11] {cfg} at {dims}: {why}")
                check_gemm("11", f"{M}x{N}x{K} {cfg} {dtype_name(dtype)}",
                           lambda: om.matmul(a, b, *cfg),
                           lambda: om.matmul_plain(a, b), GEMM_TOL[dtype],
                           mm_checks)
    a = randn(MM_DIM, MM_DIM, dtype=torch.bfloat16)
    b = randn(MM_DIM, MM_DIM, dtype=torch.bfloat16)
    mm_plain_ms = cuda_seconds(lambda: om.matmul_plain(a, b), 20, 3) * 1e3
    mm_bound, mm_by = gemm_bound_ms(*matmul_work(MM_DIM, MM_DIM, MM_DIM, 2),
                                    torch.bfloat16, peaks)
    log(f"[11] 1536^3 bf16: plain {mm_plain_ms:.4f} ms, bound "
        f"{mm_bound:.4f} ms ({mm_by})")
    del a, b

    # ---- 12. conv2d kernel vs plain ----
    cv_checks = {}
    for params, cfgs in (
            ((2, 8, 8, 6, 256, 3, 3, 1), [(1, 6, 128), (4, 6, 128),
                                           (8, 6, 256)]),
            ((3, 10, 7, 2, 4, 3, 3, 0), [(4, 2, 4)]),
            ((1, 8, 8, 4, 8, 3, 3, 1), [(2, 4, 8)]),
            (CONV[:7] + CONV[8:], [(2, 128, 64), (8, 32, 8), (1, 256, 64),
                                   (7, 32, 32)]), *cv_inst.items()):
        N, H, W, CO, CI, KH, KW, pad = params
        for dtype in (torch.float32, torch.bfloat16):
            x, w = randn(N, H, W, CI, dtype=dtype), randn(KH, KW, CI, CO,
                                                         dtype=dtype)
            bias = randn(CO)
            for cfg in cfgs:
                ok, why = oc.conv_config_is_valid(
                    N, H, W, CO, CI, KH, KW, 1, pad, *cfg,
                    dtype=dtype_name(dtype))
                if not ok:
                    raise RuntimeError(f"[12] {cfg} at {params}: {why}")
                check_gemm("12", f"{params} {cfg} {dtype_name(dtype)}",
                           lambda: oc.conv2d(x, w, bias, pad, *cfg),
                           lambda: oc.conv2d_plain(x, w, bias, pad),
                           GEMM_TOL[dtype], cv_checks)
    N, H, W, CO, CI, KH, KW, _, pad = CONV
    x, w = randn(N, H, W, CI, dtype=torch.bfloat16), randn(
        KH, KW, CI, CO, dtype=torch.bfloat16)
    bias = randn(CO)
    cv_plain_ms = cuda_seconds(lambda: oc.conv2d_plain(x, w, bias, pad), 20,
                               3) * 1e3
    cv_bound, cv_by = gemm_bound_ms(*conv_work(*CONV, 2), torch.bfloat16,
                                    peaks)
    log(f"[12] 1x56x56x256->256 3x3 bf16: plain {cv_plain_ms:.4f} ms, bound "
        f"{cv_bound:.4f} ms ({cv_by})")
    del x, w, bias

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
    cv_arms = tune_arms("conv2d", ["--workload", "conv2d", "--conv",
                                   *map(str, CONV[:7])], cv_best, kernels,
                        cv_checks)

    def record(name, arms, checks, src, replaces, plain_ms, b_ms, b_by,
               shape):
        best = min(arms.values(), key=lambda v: v[0]["best_ms"])[0]
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(v[2][name] for v in arms.values()),
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "ms": best["best_ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": min(v[0]["library_ms"] for v in arms.values()),
            "shape": shape, "best_cfg": best["best_cfg"],
            "checks": {"max_rel_err": max(c["max_rel_err"]
                                          for c in checks.values()),
                       "tolerance": {dtype_name(t): v
                                     for t, v in GEMM_TOL.items()},
                       "bit_identical_launches": True,
                       "configs_checked": len(checks)},
            "tune": {arm: {k: v[0][k] for k in (
                "best_cfg", "best_ms", "gflops", "library_ms",
                "n_configs_timed", "n_measured", "n_raw_configs",
                "n_lattice_configs", "pool_s", "bound_s", "featurize_s",
                "vae_s", "fit_s", "select_s", "measure_s", "timing_s")}
                | {"wall_s": v[3], "launches": v[2][name],
                   "configs_verified": v[1].n_verified,
                   "verify_max_rel_err": v[1].verify_rel_err}
                for arm, v in arms.items()},
        }

    return [
        record("matmul", mm_arms, mm_checks,
               "vae_extent_search_tpu_torch/csrc/matmul.cu",
               "vae_extent_search_tpu/ops/matmul_pallas.py:78", mm_plain_ms,
               mm_bound, mm_by, {"M": MM_DIM, "N": MM_DIM, "K": MM_DIM,
                                 "dtype": "bfloat16"}),
        record("conv2d", cv_arms, cv_checks,
               "vae_extent_search_tpu_torch/csrc/conv2d.cu",
               "vae_extent_search_tpu/ops/conv2d_pallas.py:106", cv_plain_ms,
               cv_bound, cv_by, dict(zip(("N", "H", "W", "CO", "CI", "KH",
                                          "KW", "stride", "pad"), CONV),
                                     dtype="bfloat16")),
    ]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")
    from vae_extent_search_tpu_torch.cli.vae_extent_search import (
        run_experiment,
    )
    from vae_extent_search_tpu_torch.convert import params_from_numpy
    from vae_extent_search_tpu_torch.data.pool import load_pool
    from vae_extent_search_tpu_torch.device import resolve_device
    from vae_extent_search_tpu_torch.ops import conv2d as oc
    from vae_extent_search_tpu_torch.ops import fused_head as fh
    from vae_extent_search_tpu_torch.ops import hist as th
    from vae_extent_search_tpu_torch.ops import matmul as om
    from vae_extent_search_tpu_torch.search.select import (
        SelectionConfig,
        select_programs,
    )

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
    libs = (fh.LIB, th.LIB, om.LIB, oc.LIB)
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

    # ---- 2. kernel vs plain, injected bits ----
    names = ("cost", "gnorm", "mc_mean", "mc_var")
    errors = {}
    for label, shape in (("main", main_shape), ("bench", BENCH)):
        for dtype in (torch.float32, torch.bfloat16):
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
            del bits, got, ref

    # ---- 3. Philox path ----
    p, x = setup(BENCH, torch.float32, 3)
    inj = call(p, x, BENCH, bits=words(BENCH, 4))
    ph = call(p, x, BENCH, seed=11)
    if not (torch.equal(ph[0], inj[0]) and torch.equal(ph[1], inj[1])):
        raise RuntimeError("Philox run changed cost/gnorm")
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
    log(f"[3] Philox: cost/gnorm bit-equal to injected run; mean mc_var "
        f"{k_var:.6e} vs plain {r_var:.6e}; mean mc offset {k_off:.6e} vs "
        f"plain {r_off:.6e} (4 seeds each)")
    if abs(k_var - r_var) > 0.05 * r_var or abs(k_off - r_off) > \
            0.05 * abs(r_off):
        raise RuntimeError("Philox MC statistics outside the 5% band")

    # ---- 4. timing ----
    times = {}
    for label, shape, iters in (("main", main_shape, 50),
                                ("bench", BENCH, 5)):
        for dtype in (torch.float32, torch.bfloat16):
            p, x = setup(shape, dtype, 5)
            gen = torch.Generator(device=dev).manual_seed(6)
            k_ms = cuda_ms(lambda: call(p, x, shape, seed=7), iters)
            p_ms = cuda_ms(lambda: plain(p, x, shape, gen=gen),
                           max(2, iters // 5))
            b_ms, b_by = bound_ms(shape["n"], shape["d"], shape["hid"],
                                  shape["lat"], shape["hp"], shape["T"],
                                  dtype, peaks)
            times[(label, dtype)] = (k_ms, p_ms, b_ms, b_by)
            log(f"[4] {label} N={shape['n']} {dtype_name(dtype)}: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}); kernel at {100 * b_ms / k_ms:.1f}% of bound")

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
            None, out_dir, measure_size=32, seeds=(2000, 2001, 2002),
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

    hist_record = gbdt_phases(dev, peaks, fh, th)
    tuner_records = tuner_phases(dev, peaks, {
        "fused_head_stats": fh.fused_head_stats, "hist": th.hist,
        "matmul": om.matmul, "conv2d": oc.conv2d})

    # ---- result ----
    k_ms, p_ms, b_ms, b_by = times[("main", torch.float32)]
    bk, bp, bb, _ = times[("bench", torch.bfloat16)]
    fk, fp, fb, _ = times[("bench", torch.float32)]
    log(f"total {time.time() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [{
        "name": "fused_head_stats",
        "route": "cuda",
        "source": "vae_extent_search_tpu_torch/csrc/fused_head.cu",
        "replaces": "vae_extent_search_tpu/ops/fused_head_pallas.py:66",
        "launches": launches,
        "max_abs_err": errors[("main", torch.float32)][1],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
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
    }, hist_record, *tuner_records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
