"""Plain Ansor-style tuning driver — the experiment's baseline arm
(counterpart of ``scripts/vae_experiments/ansor.py``).

Parity: reference scripts/vae_experiments/ansor.py:62-113 — cached task
extraction through the PathManager, TaskScheduler-driven tuning with a
RecordToFile log + TSV latency trace, then best-schedule application and
latency evaluation. Candidate-kernel execution is an external adapter
(the reference compiles with ApplyHistoryBest and times on a GPU through
an RPC context), so evaluation is the ApplyHistoryBest latency estimate
and, optionally, a CommandRunner measurement fleet.

    python -m vae_extent_search_tpu_torch.cli.ansor --network dcgan \\
        --num-measure-trials 96 --work-dir ansor_out
    python -m vae_extent_search_tpu_torch.cli.ansor --device cpu ...

The policy is the plain sketch GA with the random model, so the loop is
host work. Like ``cli/tune_vae.py``, which came from the same folder, the
command runs on ``--device`` (CUDA by default; asking for it without a
GPU is an error), where a learned model would live.
"""

from __future__ import annotations

import argparse
import time

from ..device import resolve_device
from ..records import TuningOptions
from ..records.networks import get_network_tasks
from ..search.measure import (
    AnalyticRunner,
    CommandRunner,
    EmptyBuilder,
    RecordToFile,
)
from ..search.task_scheduler import (
    LogEstimatedLatency,
    PrintTableInfo,
    TaskScheduler,
)
from ..utils.misc import PathManager, seed_everything
from .estimate_network_latency import estimate_network_latency


def get_tasks(network, batch_size, image_size, target, path_manager,
              verbose=True, get_pkl=True):
    """Cached network->tasks (reference ansor.py:40-58: tasks_pkl_use /
    tasks_pkl_save through the PathManager)."""
    tasks = weights = None
    if get_pkl:
        loaded = path_manager.tasks_pkl_use()
        if loaded is not None:
            tasks, weights = loaded
    if not tasks:
        print("Extract tasks...")
        tasks, weights = get_network_tasks(network, batch_size, image_size,
                                           target)
        if not path_manager.tasks_pkl_check():
            path_manager.tasks_pkl_save(tasks, weights)
    if verbose:
        for idx, task in enumerate(tasks):
            print(f"========== Task {idx}  (workload key: "
                  f"{task.workload_key}) ==========")
    print(f"Total tasks length : {len(tasks)}")
    return tasks, weights


def run_tuning(tasks, weights, paths, num_measure_trials, runner,
               device="cuda"):
    print("=" * 80)
    print("Begin tuning...")
    tuner = TaskScheduler(
        tasks, weights,
        callbacks=[PrintTableInfo(), LogEstimatedLatency(paths["tsv"])],
        device=device,
    )
    tune_option = TuningOptions(
        num_measure_trials=num_measure_trials,
        num_measures_per_round=16,
        builder=EmptyBuilder(),
        runner=runner,
        measure_callbacks=[RecordToFile(paths["json"])],
    )
    tuner.tune(tune_option)  # search_policy default: plain sketch+random


def evaluate(paths, network, batch_size, image_size, target):
    """Best-schedule latency from the tuning log (the ApplyHistoryBest
    estimate; real compile+benchmark is the external adapter)."""
    latency, missing = estimate_network_latency(
        [paths["json"]], network, batch_size, image_size, target
    )
    print(f"Estimated network latency: {latency * 1e3:.3f} ms "
          f"({missing} tasks unmeasured)")
    return latency


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--network", type=str, default="resnet_18")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--target", type=str, default="llvm -mcpu=skylake-avx512")
    p.add_argument("--num-measure-trials", type=int, default=256)
    p.add_argument("--work-dir", type=str, default="ansor_out")
    p.add_argument("--measure-command", type=str, default=None,
                   help="external measurement command (CommandRunner); "
                        "default: the analytic simulator")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda without a GPU raises")
    args = p.parse_args(argv)
    resolve_device(args.device)

    seed_everything(args.seed)
    pm = PathManager(args.work_dir, f"{args.network}-B{args.batch_size}",
                     args.target).makedirs()
    paths = {"json": pm.record_log(pm.network), "tsv": pm.latency_tsv()}

    tasks, weights = get_tasks(args.network, args.batch_size,
                               args.image_size, args.target, pm,
                               verbose=False)
    runner = (CommandRunner(args.measure_command) if args.measure_command
              else AnalyticRunner(noise=0.2))
    t0 = time.time()
    run_tuning(tasks, weights, paths, args.num_measure_trials, runner,
               device=args.device)
    print(f"tuning wall: {time.time() - t0:.1f}s")
    return evaluate(paths, args.network, args.batch_size, args.image_size,
                    args.target)


if __name__ == "__main__":
    main()
