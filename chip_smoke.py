"""On-card smoke test of the PyTorch/CUDA port (needs one NVIDIA GPU).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device and build: the card's name and power limit; nvcc builds the
     fused-head kernel from csrc/ for sm_90a
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
The last two lines are a JSON object with each kernel's check and times,
then {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

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
    from vae_extent_search_tpu_torch.ops import fused_head as fh
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
    _, out, secs = fh.build(force=True)
    regs = [l.strip() for l in out.splitlines() if "registers" in l]
    log(f"[1] nvcc build of {os.path.relpath(fh.SOURCE, ROOT)}: "
        f"{secs:.2f} s; {' / '.join(regs)}")

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
    if launches != phases or launches == 0:
        raise RuntimeError(f"{launches} kernel launches for {phases} phases")

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
