"""Self-tuning: the active search tunes the port's own CUDA kernels on the
card (counterpart of ``scripts/tune_pallas_kernel.py``).

  sketch-GA candidate pool (matmul or conv2d tilings)   search/sketch.py
    -> bound inference, extent features                 ir/, features/extent.py
    -> VAE pretrain + online active selection           search/active_loop.py
    -> each selected schedule quotiented onto a block   search/kernel_tuner.py
       config and the CUDA kernel timed at it on the    ops/matmul.py,
       card (device time, queued behind a blocker)      ops/conv2d.py
    -> an NDJSON record log; the best config against cuBLAS / cuDNN

    python -m vae_extent_search_tpu_torch.cli.tune_kernel --workload matmul --dim 1536
    python -m vae_extent_search_tpu_torch.cli.tune_kernel --workload conv2d \\
        --conv 1 56 56 256 256 3 3     # N H W CO CI KH KW (stride 1, pad 1)
    python -m vae_extent_search_tpu_torch.cli.tune_kernel --arm random   # baseline arm
CPU smoke run (an analytic stand-in for the timings):
    python -m vae_extent_search_tpu_torch.cli.tune_kernel --fake-timer --device cpu ...

Runs on CUDA by default; asking for CUDA on a host without a GPU is an
error. The pool's states are bound (bound inference) before they are
featurised and quotiented, as ``make_states`` returns them and as a record
replays: unbound cache stages print no extents, and most matmul
states would quotient onto no configuration at all. Records are written
under the target ``cuda -model=<dtype>``; the schedule space comes from an
``llvm`` task, whose pool depends on the host's core count.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np

from ..device import resolve_device
from ..features.extent import extent_vector
from ..ops import conv2d as oc
from ..ops import matmul as om
from ..records import SearchTask, make_workload_key
from ..records.serde import ERROR_NO_ERROR
from ..search.active_loop import run_active_search_online
from ..search.kernel_tuner import (
    Conv2dRunner,
    MatmulRunner,
    state_to_conv_config,
    state_to_matmul_config,
    time_library_conv2d,
    time_library_matmul,
)
from ..search.measure import EmptyBuilder, ProgramMeasurer, RecordToFile
from ..search.select import SelectionConfig
from ..search.sketch import make_states


def pad_extent_features(states) -> np.ndarray:
    vecs = [extent_vector(st) for st in states]
    d = max(len(v) for v in vecs)
    X = np.zeros((len(vecs), d), np.float32)
    for i, v in enumerate(vecs):
        X[i, : len(v)] = v
    return X


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", type=str, default="matmul",
                   choices=["matmul", "conv2d"])
    p.add_argument("--dim", type=int, default=1536,
                   help="square matmul size (or use --m/--n/--k)")
    p.add_argument("--m", type=int, default=None)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--conv", type=int, nargs=7,
                   default=[1, 56, 56, 256, 256, 3, 3],
                   metavar=("N", "H", "W", "CO", "CI", "KH", "KW"),
                   help="conv2d_layer dims (stride fixed 1)")
    p.add_argument("--pad", type=int, default=None,
                   help="conv padding (default: same, (KH-1)//2)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=sorted(om.DTYPES))
    p.add_argument("--n-candidates", type=int, default=1000)
    p.add_argument("--measure-size", type=int, default=16)
    p.add_argument("--n-phases", type=int, default=6)
    p.add_argument("--arm", type=str, default="model",
                   choices=["model", "random"],
                   help="selection arm: the model-based mix, or the "
                        "reference online arm's random stub (baseline)")
    p.add_argument("--vae-epochs", type=int, default=500)
    p.add_argument("--reg-epochs", type=int, default=1000)
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--sampling-seed", type=int, default=2000)
    p.add_argument("--max-seconds", type=float, default=2.0,
                   help="reject configs predicted slower than this")
    p.add_argument("--log-file", type=str, default="tune_kernel.json")
    p.add_argument("--out-csv", type=str, default=None,
                   help="append a summary row here")
    p.add_argument("--fake-timer", action="store_true",
                   help="an analytic stand-in for the card's timings")
    p.add_argument("--skip-library-baseline", "--skip-xla-baseline",
                   action="store_true",
                   help="do not time cuBLAS / cuDNN at the same shape")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p.parse_args(argv)


def tune(argv=None):
    """Run the whole path; returns (summary dict, the runner)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu" and not args.fake_timer:
        raise SystemExit("timing the kernels needs --device cuda; on the CPU "
                         "pass --fake-timer")
    dt = args.dtype
    if args.workload == "matmul":
        M, N, K = args.m or args.dim, args.n or args.dim, args.k or args.dim
        shape = (M, N, K)
        wk = make_workload_key("matmul_auto_scheduler_test", shape)
        shape_desc = f"[{M}x{K}] @ [{K}x{N}]"
        to_cfg = state_to_matmul_config
        snap = lambda c: om.snap_config_to_hw(M, N, K, *c, dtype=dt)  # noqa: E731
        flops = 2.0 * M * N * K
        fake_fn = lambda *a: om.predicted_seconds(*a, dtype=dt)     # noqa: E731
        runner_cls, names = MatmulRunner, ("bm", "bn", "bk")
        library = ("cuBLAS", lambda: time_library_matmul(
            M, N, K, dt, device=device))
    else:
        cN, cH, cW, cCO, cCI, cKH, cKW = args.conv
        pad = args.pad if args.pad is not None else (cKH - 1) // 2
        params = (cN, cH, cW, cCO, cCI, cKH, cKW, 1, pad)
        shape = tuple(args.conv) + (pad,)
        wk = make_workload_key(
            "conv2d_layer",
            (cN, cH, cW, cCO, cCI, cKH, cKW, [1, 1], [pad, pad]))
        OH, OW = oc.conv_out_size(cH, cKH, 1, pad), oc.conv_out_size(
            cW, cKW, 1, pad)
        shape_desc = (f"conv2d {cN}x{cH}x{cW}x{cCI} * "
                      f"{cKH}x{cKW}x{cCI}x{cCO} (pad {pad})")
        to_cfg = state_to_conv_config
        snap = lambda c: oc.snap_conv_config_to_hw(*params, *c, dtype=dt)  # noqa: E731
        flops = 2.0 * cN * OH * OW * cCO * cKH * cKW * cCI
        fake_fn = lambda *a: oc.predicted_conv_seconds(*a, dtype=dt)  # noqa: E731
        runner_cls, names = Conv2dRunner, ("boh", "bco", "bci")
        library = ("cuDNN", lambda: time_library_conv2d(
            *params, dt, device=device))

    task = SearchTask(wk, "llvm")  # schedule-space donor for the tilings
    # records carry the card's target + dtype (the -model attribute is
    # the dispatcher's best_by_model key: the timed operand dtype)
    record_task = SearchTask(wk, f"cuda -model={dt}")

    t0 = time.time()
    print(f"generating {args.n_candidates} candidate tilings for "
          f"{shape_desc} {dt} ...")
    states = make_states(task, args.n_candidates, seed=args.seed)
    pool_s = time.time() - t0
    t = time.time()
    dag = task.compute_dag
    states = [dag.infer_bound(st) for st in states]
    bound_s = time.time() - t
    t = time.time()
    X = pad_extent_features(states)
    cfgs = [to_cfg(st)[0] for st in states]
    featurize_s = time.time() - t
    raw = {c for c in cfgs if c is not None}
    snapped = {snap(c) for c in raw}
    print(f"  {len(states)} states -> {len(raw)} raw tilings -> "
          f"{len(snapped)} block configs on the kernel's lattice; pool "
          f"{pool_s:.1f}s, bound inference {bound_s:.1f}s, features "
          f"{featurize_s:.1f}s ({X.shape[1]} per state)")

    runner = runner_cls(dtype=dt, max_seconds=args.max_seconds,
                        time_fn=fake_fn if args.fake_timer else None,
                        verbose=True, device=device)
    measurer = ProgramMeasurer(EmptyBuilder(), runner,
                               callbacks=[RecordToFile(args.log_file)],
                               max_continuous_error=10 ** 9)

    def measure_fn(idxs):
        results = measurer.measure(record_task, [states[i] for i in idxs])
        return np.asarray(
            [-np.log((r.mean_cost if r.error_no == ERROR_NO_ERROR else 1e10)
                     + 1e-8) for r in results], np.float32)

    res = run_active_search_online(
        X, measure_fn,
        measure_size=args.measure_size,
        max_phases=args.n_phases,
        vae_epochs=args.vae_epochs,
        reg_epochs=args.reg_epochs,
        selection=SelectionConfig(num_select=args.measure_size),
        sampling_seed=args.sampling_seed,
        train_seed=args.seed,
        select=args.arm,
        verbose=True,
        device=device,
    )

    best_cfg = snap(to_cfg(states[res.best_index])[0])
    best_sec = float(np.exp(-res.best_label))
    gflops = flops / best_sec / 1e9
    print(f"\narm={args.arm}: measured {res.n_measured} states "
          f"({runner.n_timed} distinct configs timed) in "
          f"{res.used_time:.1f}s (VAE {res.vae_seconds:.1f}s, predictor "
          f"{sum(res.fit_seconds):.1f}s, selection "
          f"{sum(res.select_seconds):.2f}s, measurement "
          f"{sum(res.measure_seconds):.1f}s)")
    host_sec = runner.host_seconds.get(best_cfg)
    host_s = "" if host_sec is None else (
        f"; the host takes {host_sec*1e3:.4f} ms per call to enqueue it")
    print("best config "
          + " ".join(f"{n}={v}" for n, v in zip(names, best_cfg))
          + f": {best_sec*1e3:.4f} ms  ({gflops:.0f} GFLOP/s) "
          + ("by the stand-in timer" if args.fake_timer else "on the card")
          + host_s)

    lib_sec = lib_host = None
    if not (args.skip_library_baseline or args.fake_timer):
        lib_name, lib_fn = library
        lib_sec, lib_host = lib_fn()
        print(f"{lib_name} same shape/dtype: {lib_sec*1e3:.4f} ms "
              f"({flops/lib_sec/1e9:.0f} GFLOP/s) on the card, "
              f"{lib_host*1e3:.4f} ms per call on the host -> tuned kernel "
              f"at {lib_sec/best_sec:.3f}x {lib_name}")

    ok = [s for _, s, e in runner.measured_configs() if e == ERROR_NO_ERROR]
    if ok:
        med = float(np.median(ok))
        print(f"measured-config spread: best {best_sec*1e3:.4f} / median "
              f"{med*1e3:.4f} / worst {max(ok)*1e3:.4f} ms "
              f"(best is {med/best_sec:.1f}x median)")

    summary = {
        "arm": args.arm, "workload": args.workload,
        "shape": "x".join(str(v) for v in shape), "dtype": dt,
        "n_candidates": len(states), "measure_size": args.measure_size,
        "n_phases": res.phases, "n_measured": res.n_measured,
        "n_raw_configs": len(raw), "n_lattice_configs": len(snapped),
        "n_configs_timed": runner.n_timed,
        "best_cfg": "x".join(str(v) for v in best_cfg),
        "best_ms": best_sec * 1e3,
        "gflops": gflops,
        "host_ms": None if host_sec is None else host_sec * 1e3,
        "library_ms": None if lib_sec is None else lib_sec * 1e3,
        "library_host_ms": None if lib_host is None else lib_host * 1e3,
        "wall_s": res.used_time,
        "pool_s": pool_s, "bound_s": bound_s, "featurize_s": featurize_s,
        "vae_s": res.vae_seconds,
        "fit_s": "|".join(f"{s:.3f}" for s in res.fit_seconds),
        "select_s": "|".join(f"{s:.4f}" for s in res.select_seconds),
        "measure_s": "|".join(f"{s:.3f}" for s in res.measure_seconds),
        "timing_s": runner.timing_seconds,
        "sampling_seed": args.sampling_seed,
        "best_history": "|".join(f"{b:.4f}" for b in res.best_history),
    }
    if args.out_csv:
        exists = os.path.exists(args.out_csv)
        with open(args.out_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(summary))
            if not exists:
                w.writeheader()
            w.writerow(summary)
        print(f"summary appended to {args.out_csv}")
    return summary, runner


def main(argv=None):
    tune(argv)


if __name__ == "__main__":
    main()
