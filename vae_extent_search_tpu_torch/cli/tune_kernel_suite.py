"""Self-tuning over a suite of kernel workloads: the gradient task
scheduler spends trials on the card across the port's own kernels
(counterpart of ``scripts/tune_kernel_suite.py``).

The reference's network flow (scripts/tune_network.py:63-109: extract
tasks, tune them under the gradient TaskScheduler, apply the best records,
estimate the network's latency) over the port's CUDA kernels: the
"network" is a weighted suite of kernel shapes, each trial times a kernel
on the card (``search/kernel_tuner.py::KernelRunner``), the gradient
strategy (reference task_scheduler.py:418-474) picks which workload's next
round buys the most, and the log becomes a ``KernelLibrary``
(``ops/kernel_library.py``) whose weighted tuned time is the suite's
latency.

Suite entries, repeatable:
  matmul:MxNxK[:weight]
  conv2d:NxHxWxCOxCIxKHxKW[:weight]        (stride 1, same padding)
  fusedhead:NxDxHxLxT[:weight]             (the fused cost head: its group
                                            count G)
  gbdthist:RxFxC2xC16xC64xC128[:weight]    (the device GBDT's histogram
                                            launch plan at a rows x census
                                            shape; C* = features with at
                                            most 2 / 16 / 64 / 128 bins)

Tuned fusedhead and gbdthist records feed ``search/select.py`` and
``models/boost_device.py`` through the process library
(``VES_KERNEL_LIBRARY``); the summary gives their tuned time against the
hand default, measured by the same runner, and the matmul's and conv2d's
against cuBLAS / cuDNN.

    python -m vae_extent_search_tpu_torch.cli.tune_kernel_suite \\
        --suite matmul:1536x1536x1536:2 conv2d:1x56x56x128x128x3x3:4 \\
        --n-trials 96 --measures-per-round 8
CPU smoke run (an analytic stand-in for the card's times; plain ``sketch``
takes ~5 s of GA where ``sketch.vae`` also refits its model every round):
    python -m vae_extent_search_tpu_torch.cli.tune_kernel_suite --fake-timer \\
        --device cpu --policy sketch --suite matmul:256x256x256 --n-trials 16

Runs on CUDA by default; on the CPU only with ``--fake-timer``. Two tasks
per entry: an ``llvm`` task whose sketch rules give the schedule space,
and a ``cuda -model=<dtype>`` task that keys the records, so that the
library applies them later.
"""

from __future__ import annotations

import argparse
import time
from functools import partial

from ..device import resolve_device
from ..ops import conv2d as oc
from ..ops import matmul as om
from ..ops.kernel_library import KernelLibrary
from ..records import SearchTask, TuningOptions, make_workload_key
from ..search.cost_model import make_search_policies
from ..search.kernel_tuner import (
    KernelRunner,
    default_config,
    default_config_state,
    fusedhead_block_flops,
    predicted_fusedhead_seconds,
    predicted_hist_seconds,
    time_library_conv2d,
    time_library_matmul,
)
from ..search.measure import EmptyBuilder, ProgramMeasurer, RecordToFile
from ..search.task_scheduler import (
    LogEstimatedLatency,
    PrintTableInfo,
    TaskScheduler,
)

DEFAULT_SUITE = [
    # a resnet-block-flavoured mix: two conv stages and a dense layer
    "conv2d:1x56x56x128x128x3x3:4",
    "conv2d:1x28x28x256x256x3x3:4",
    "matmul:1536x1536x1536:1",
]


def parse_suite_entry(token: str):
    """-> (family, dims tuple, weight)."""
    parts = token.split(":")
    family = parts[0]
    dims = tuple(int(v) for v in parts[1].split("x"))
    weight = float(parts[2]) if len(parts) > 2 else 1.0
    if family == "matmul":
        if len(dims) != 3:
            raise SystemExit(f"matmul wants MxNxK, got {parts[1]!r}")
    elif family == "conv2d":
        if len(dims) != 7:
            raise SystemExit(f"conv2d wants NxHxWxCOxCIxKHxKW, got "
                             f"{parts[1]!r}")
        KH, KW = dims[5], dims[6]
        if KH % 2 == 0 or KW % 2 == 0:
            raise SystemExit(
                f"conv2d suite entries use 'same' padding, which needs odd "
                f"kernel sizes; got KH={KH} KW={KW}")
        if KH != KW:
            raise SystemExit(
                f"conv2d suite entries need square kernels (KH==KW); "
                f"got KH={KH} KW={KW}")
    elif family == "fusedhead":
        if len(dims) != 5:
            raise SystemExit(f"fusedhead wants NxDxHxLxT, got {parts[1]!r}")
        if dims[4] < 1:
            raise SystemExit(f"fusedhead needs T >= 1, got T={dims[4]}")
    elif family == "gbdthist":
        if len(dims) != 6:
            raise SystemExit(
                f"gbdthist wants RxFxC2xC16xC64xC128, got {parts[1]!r}")
        if sum(dims[2:]) > dims[1]:
            raise SystemExit(
                f"gbdthist census {dims[2:]} exceeds F={dims[1]}")
    else:
        raise SystemExit(f"unknown suite family {family!r}")
    return family, dims, weight


def conv_same_padding(KH, KW):
    """'same' padding per spatial dim (odd kernels only; see parse)."""
    return (KH - 1) // 2, (KW - 1) // 2


def entry_workload_key(family, dims):
    if family == "matmul":
        return make_workload_key("matmul_auto_scheduler_test", dims)
    if family == "fusedhead":
        return make_workload_key("fused_head_layer", dims)
    if family == "gbdthist":
        return make_workload_key("gbdt_hist_layer", dims)
    N, H, W, CO, CI, KH, KW = dims
    pad_h, pad_w = conv_same_padding(KH, KW)
    return make_workload_key(
        "conv2d_layer", (N, H, W, CO, CI, KH, KW, [1, 1], [pad_h, pad_w]))


def entry_flops(family, dims):
    if family == "matmul":
        M, N, K = dims
        return 2.0 * M * N * K
    if family == "fusedhead":
        N, D, H, L, T = dims
        return N * fusedhead_block_flops(D, H, L, T, 1)
    if family == "gbdthist":
        return 2.0 * dims[0] * dims[1] * 256 * 16
    N, H, W, CO, CI, KH, KW = dims
    pad_h, pad_w = conv_same_padding(KH, KW)
    OH = oc.conv_out_size(H, KH, 1, pad_h)
    OW = oc.conv_out_size(W, KW, 1, pad_w)
    return 2.0 * N * OH * OW * CO * KH * KW * CI


def fake_timers(dtype: str):
    """The ``--fake-timer`` stand-ins per family (analytic H100 estimates,
    no claim about speed)."""
    return dict(
        matmul_time_fn=partial(om.predicted_seconds, dtype=dtype),
        conv_time_fn=partial(oc.predicted_conv_seconds, dtype=dtype),
        fusedhead_time_fn=partial(predicted_fusedhead_seconds, dtype=dtype),
        hist_time_fn=predicted_hist_seconds)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--suite", type=str, nargs="+", default=DEFAULT_SUITE,
                   help="matmul:MxNxK[:w] conv2d:NxHxWxCOxCIxKHxKW[:w] "
                        "fusedhead:NxDxHxLxT[:w] "
                        "gbdthist:RxFxC2xC16xC64xC128[:w]")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=sorted(om.DTYPES))
    p.add_argument("--n-trials", type=int, default=96,
                   help="total measurement trials across the suite")
    p.add_argument("--measures-per-round", type=int, default=8)
    p.add_argument("--strategy", type=str, default="gradient",
                   choices=["gradient", "round-robin"])
    p.add_argument("--policy", type=str, default="sketch.vae",
                   help="search policy spec (sketch.<cost-model>)")
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--max-seconds", type=float, default=2.0)
    p.add_argument("--log-file", type=str, default="tune_kernel_suite.json")
    p.add_argument("--fake-timer", action="store_true",
                   help="an analytic stand-in for the card's timings")
    p.add_argument("--skip-library-baseline", "--skip-xla-baseline",
                   action="store_true",
                   help="do not time cuBLAS / cuDNN at the same shapes")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None, policies_hook=None):
    """Run the suite; returns (summary dict, the runner).

    ``policies_hook``, where given, is called with the search policies
    before tuning (the smoke run cuts their GA population through it)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu" and not args.fake_timer:
        raise SystemExit("timing the kernels needs --device cuda; on the CPU "
                         "pass --fake-timer")
    entries = [parse_suite_entry(t) for t in args.suite]

    # two tasks per entry: the llvm donor's sketch rules give the schedule
    # space; the cuda -model=<dtype> task keys the records, so that
    # ops/kernel_library.py applies them later
    donor_tasks, record_tasks, weights = [], [], []
    for family, dims, weight in entries:
        wk = entry_workload_key(family, dims)
        donor_tasks.append(SearchTask(wk, "llvm"))
        record_tasks.append(SearchTask(wk, f"cuda -model={args.dtype}"))
        weights.append(weight)

    runner = KernelRunner(
        dtype=args.dtype, max_seconds=args.max_seconds, device=device,
        verbose=not args.fake_timer,
        **(fake_timers(args.dtype) if args.fake_timer else {}))
    tune_option = TuningOptions(
        num_measure_trials=args.n_trials,
        num_measures_per_round=args.measures_per_round,
        builder=EmptyBuilder(),
        runner=runner,
        measure_callbacks=[RecordToFile(args.log_file)],
    )
    scheduler = TaskScheduler(
        record_tasks, weights, strategy=args.strategy,
        callbacks=[PrintTableInfo(), LogEstimatedLatency()],
        seed=args.seed, device=device)
    policies, cost_model = make_search_policies(
        args.policy, donor_tasks, seed=args.seed, device=device)
    if policies_hook is not None:
        policies_hook(policies)

    # each family's hand default goes into the log first (the reference's
    # PreloadMeasuredStates role): the library's min-cost query then never
    # falls below it, and the GA has it as a measured anchor
    seeder = ProgramMeasurer(EmptyBuilder(), runner,
                             callbacks=[RecordToFile(args.log_file)],
                             max_continuous_error=10 ** 9)
    defaults = {}
    for task in record_tasks:
        st = default_config_state(task)
        if st is not None:
            res = seeder.measure(task, [st])
            defaults[task.workload_key] = res[0].costs[0]
            print(f"  seeded hand-default config of "
                  f"{task.workload_key.split(',')[0]}: "
                  f"{res[0].costs[0] * 1e3:.3f} ms")

    t0 = time.time()
    scheduler.tune(tune_option, policies=policies, cost_model=cost_model)
    wall = time.time() - t0

    lib = KernelLibrary.from_file(args.log_file)
    print(f"\nsuite tuned in {wall:.1f}s "
          f"({args.n_trials} trials, {runner.n_timed} distinct configs "
          f"timed); library holds {len(lib)} workloads")

    tuned_total, lib_total = 0.0, 0.0
    have_lib = not args.skip_library_baseline and not args.fake_timer
    rows = []
    for (family, dims, weight), task in zip(entries, record_tasks):
        rec = lib.query(task.workload_key, dtype=args.dtype)
        if rec is None:
            print(f"  {family} {dims}: NO tuned record (all configs "
                  "invalid or failed)")
            rows.append(dict(family=family, dims=dims, weight=weight,
                             tuned_s=None))
            continue
        sec = rec.res.mean_cost
        gf = entry_flops(family, dims) / sec / 1e9
        line = (f"  {family} {'x'.join(map(str, dims))} w={weight:g}: "
                f"tuned {sec*1e3:.3f} ms ({gf:.0f} GFLOP/s)")
        row = dict(family=family, dims=dims, weight=weight, tuned_s=sec)
        tuned_total += weight * sec
        if family in ("fusedhead", "gbdthist"):
            # the framework kernels' baseline is their hand default,
            # measured through the same runner and timing path
            dcfg = default_config(task)
            def_sec = defaults[task.workload_key]
            names = ("G",) if family == "fusedhead" else ("features",
                                                          "chunks")
            dcfg_s = " ".join(f"{n}={v}" for n, v in zip(names, dcfg))
            line += (f" | default[{dcfg_s}] {def_sec*1e3:.3f} ms "
                     f"({def_sec/sec:.2f}x)")
            row.update(default_config=dcfg, default_s=def_sec)
        elif have_lib:
            if family == "matmul":
                lib_sec = time_library_matmul(*dims, dtype=args.dtype,
                                              device=device).seconds
            else:
                N, H, W, CO, CI, KH, KW = dims
                pad, _ = conv_same_padding(KH, KW)
                lib_sec = time_library_conv2d(N, H, W, CO, CI, KH, KW, 1,
                                              pad, dtype=args.dtype,
                                              device=device).seconds
            lib_total += weight * lib_sec
            line += (f" | {'cuBLAS' if family == 'matmul' else 'cuDNN'} "
                     f"{lib_sec*1e3:.3f} ms ({lib_sec/sec:.2f}x)")
            row.update(library_s=lib_sec)
        print(line)
        rows.append(row)

    print(f"\nweighted suite latency (tuned kernels): "
          f"{tuned_total*1e3:.3f} ms")
    if have_lib and lib_total:
        print(f"weighted suite latency (library calls): "
              f"{lib_total*1e3:.3f} ms")
    return dict(wall_s=wall, n_timed=runner.n_timed, library=len(lib),
                entries=rows, tuned_total_s=tuned_total,
                library_total_s=lib_total), runner


if __name__ == "__main__":
    main()
