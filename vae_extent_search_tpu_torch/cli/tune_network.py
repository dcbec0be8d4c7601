"""End-to-end network tuning (counterpart of ``scripts/tune_network.py``).

Parity: reference scripts/tune_network.py:63-109 — extract the network's
tasks, run the TaskScheduler (round-robin or gradient) with a
sketch.<cost-model> policy, then estimate the final latency from the
produced log (local/default search). Real hardware timing is an adapter;
the built-in runner is the analytic simulator.

    python -m vae_extent_search_tpu_torch.cli.tune_network \\
        --network dcgan --num-measure-trials 96
    python -m vae_extent_search_tpu_torch.cli.tune_network \\
        --network resnet_18 --search-policy sketch.mlp --load-model mlp.pkl
    python -m vae_extent_search_tpu_torch.cli.tune_network --device cpu \\
        --network dcgan --num-measure-trials 32 --continue-tuning

The GA, the measuring and the latency estimate are host work. A learned
model (``--search-policy sketch.<kind>``) lives on ``--device``: CUDA by
default, where the MLP and SegmentVAE models run their segment sums
through the ``segment_sum`` kernel; asking for CUDA without a GPU is an
error, whatever the policy. ``--continue-tuning`` restores the trial
counts and best costs from the log as the JAX script does, before the
policies exist: recorded states are not marked as measured, and the
counts divide by 64 (``search/task_scheduler.py::restore_status_from_log``
says why).
"""

from __future__ import annotations

import argparse
import os
import time

from ..device import resolve_device
from ..records import TuningOptions
from ..records.networks import get_network_tasks
from ..search.measure import (
    AnalyticRunner,
    EmptyBuilder,
    RecordToFile,
    runner_from_spec,
)
from ..search.task_scheduler import (
    LogEstimatedLatency,
    PrintTableInfo,
    TaskScheduler,
    restore_status_from_log,
    transfer_tune,
)
from .common import BenchmarkRecord
from .estimate_network_latency import estimate_network_latency


def tune_and_evaluate(network, batch_size, image_size, target, log_file,
                      num_measure_trials, strategy="gradient",
                      runner=None, result_file="results.tsv",
                      search_policy="sketch", load_model=None,
                      use_transfer=False, continue_tuning=False,
                      eval_only=False, num_measures_per_round=16,
                      early_stopping=-1, device="cuda"):
    resolve_device(device)
    tasks, task_weights = get_network_tasks(network, batch_size, image_size,
                                            target)
    print(f"extracted {len(tasks)} tasks for {network}")

    tune_option = TuningOptions(
        num_measure_trials=num_measure_trials,
        num_measures_per_round=num_measures_per_round,
        early_stopping=early_stopping,
        builder=EmptyBuilder(),
        runner=runner or AnalyticRunner(noise=0.2),
        measure_callbacks=[RecordToFile(log_file)],
    )
    scheduler = TaskScheduler(
        tasks, task_weights, strategy=strategy,
        callbacks=[PrintTableInfo(), LogEstimatedLatency()], device=device,
    )
    if continue_tuning and os.path.exists(log_file):
        # resume from the append-only log (reference --continue-tuning:
        # PreloadMeasuredStates + _restore_status)
        restore_status_from_log(scheduler, log_file)
    t0 = time.time()
    if eval_only:
        pass  # skip tuning; estimate from the existing log below
    elif use_transfer:
        # transfer-tune: tune half with the (pretrained) model, refit as
        # frozen-base + plus_mix delta on the first half's measurements,
        # tune the rest with the combined model (reference
        # task_scheduler.py:498-583)
        transfer_tune(scheduler, tune_option,
                      search_policy=search_policy,
                      load_model_file=load_model)
    else:
        scheduler.tune(tune_option, search_policy=search_policy,
                       load_model_file=load_model)
    search_time = time.time() - t0

    latency, missing = estimate_network_latency(
        [log_file], network, batch_size, image_size, target
    )
    print(f"search time {search_time:.1f}s; "
          f"estimated latency {latency * 1e3:.3f} ms")
    BenchmarkRecord(
        target.split()[0], "simulated", "network",
        f"{network}.B{batch_size}", "ours", "vae-extent-search",
        {"costs": latency}, time.strftime("%Y-%m-%d %H:%M:%S"),
    ).write(result_file)
    return latency, search_time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--network", type=str, default="resnet_18")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--target", type=str, default="llvm -mcpu=skylake-avx512")
    p.add_argument("--log-file", type=str, default=None)
    p.add_argument("--num-measure-trials", type=int, default=128)
    p.add_argument("--strategy", type=str, default="gradient",
                   choices=["gradient", "round-robin"])
    p.add_argument("--search-policy", type=str, default="sketch",
                   help="'sketch' (random model) or 'sketch.<model>'"
                        " with model in mlp/vae/gbdt/lgb/lstm/mha/tabnet,"
                        " optionally '-no-update' (pretrained, frozen)")
    p.add_argument("--load-model", type=str, default=None,
                   help="pretrained cost-model pickle for sketch.<model>")
    p.add_argument("--transfer-tune", action="store_true")
    p.add_argument("--continue-tuning", action="store_true",
                   help="resume search state from an existing log")
    p.add_argument("--eval-only", action="store_true",
                   help="skip tuning; evaluate latency from the log")
    p.add_argument("--num-measures-per-round", type=int, default=16)
    p.add_argument("--early-stopping", type=int, default=-1)
    p.add_argument("--runner", type=str, default="analytic",
                   help="any runner_from_spec spec: analytic | "
                        "analytic_hf | replay | command:<cmd> | "
                        "service:<key>@<host>:<port>")
    p.add_argument("--noise", type=float, default=0.2,
                   help="simulated-measurement jitter for the analytic "
                        "runners")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda without a GPU raises")
    args = p.parse_args(argv)

    log_file = args.log_file or (
        f"{args.network}-B{args.batch_size}-{args.target.split()[0]}.json"
    )
    return tune_and_evaluate(
        args.network, args.batch_size, args.image_size, args.target,
        log_file, args.num_measure_trials, args.strategy,
        runner=runner_from_spec(args.runner, noise=args.noise),
        search_policy=args.search_policy, load_model=args.load_model,
        use_transfer=args.transfer_tune,
        continue_tuning=args.continue_tuning, eval_only=args.eval_only,
        num_measures_per_round=args.num_measures_per_round,
        early_stopping=args.early_stopping, device=args.device,
    )


if __name__ == "__main__":
    main()
