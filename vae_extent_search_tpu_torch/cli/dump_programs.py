"""Generate candidate-schedule pools for tasks (counterpart of
``scripts/dump_programs.py``).

Parity: reference scripts/dump_programs.py:17-74: per task, sample the
initial population and run evolutionary search rounds collecting unique
states (default 4,000), wrap them as records with dummy results and save
them to ``$VES_DATASET_ROOT/to_measure_programs/<task>.json``. Host work
(the native record-level GA, ``search/sketch.py::make_state_records``);
no device is involved.

    python -m vae_extent_search_tpu_torch.cli.dump_programs \\
        --workload-key '["conv2d_layer", 1, 14, 14, 128, 128, 3, 3, [1, 1], [1, 1]]' \\
        --n-states 2000 --out pool.json

As in the JAX script, the steps go straight from the native GA into the
log without building Python States; ``make_states`` runs where the native
GA declines (a population with no record it replays). Both rule sets of the GA are ported, so ``--target cuda`` regenerates a GPU
pool such as ``result/conv2d_4k_chip/pool_conv2d_4k.json.gz``'s:

    python -m vae_extent_search_tpu_torch.cli.dump_programs \
        --workload-key '["conv2d_layer", 1, 56, 56, 64, 64, 3, 3, [1,1], [1,1]]' \
        --target cuda --n-states 4000 --seed 2023
"""

from __future__ import annotations

import argparse
import os
import time

from ..records import SearchTask, make_record, save_records
from ..search.sketch import make_state_records, make_states
from . import common


def dump_task(task: SearchTask, out_file: str, n_states: int,
              seed: int = 2023):
    recs_list = make_state_records(task, n_states, seed=seed)
    if recs_list is None:
        recs_list = [[s.to_record() for s in st.transform_steps]
                     for st in make_states(task, n_states, seed=seed)]
    records = [
        make_record(task, recs, costs=[0.0], timestamp=0)
        for recs in recs_list
    ]
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    if os.path.exists(out_file):
        os.remove(out_file)
    save_records(out_file, records)
    return len(records)


def _pool_file(folder: str, task: SearchTask) -> str:
    return os.path.join(folder, common.clean_name(
        (task.workload_key, task.target.split()[0])) + ".json")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload-key", type=str, default=None)
    p.add_argument("--all-tasks", type=str, default=None,
                   help="all_tasks.pkl: dump every task in the file "
                        "(shardable via --start-idx/--end-idx/--step-idx; "
                        "existing non-empty outputs are skipped, so an "
                        "interrupted sweep resumes)")
    p.add_argument("--batch-size-1", action="store_true",
                   help="with --all-tasks: restrict to the reference "
                        "make_dataset.py batch-size-1 preset grid")
    p.add_argument("--target", type=str, default="llvm -mcpu=skylake-avx512")
    p.add_argument("--only-target", type=str, default=None,
                   help="with --all-tasks: dump only the tasks of this "
                        "target (all_tasks.pkl is the global multi-"
                        "platform registry; one platform's pools per run)")
    p.add_argument("--out-folder", type=str, default=None,
                   help="pool output folder (default "
                        "to_measure_programs/; platform-specific pools "
                        "need their own folder, since pool file names key "
                        "on (workload, target kind) only)")
    p.add_argument("--n-states", type=int, default=4000)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--start-idx", type=int, default=0)
    p.add_argument("--end-idx", type=int, default=None)
    p.add_argument("--step-idx", type=int, default=1)
    args = p.parse_args(argv)
    out_folder = args.out_folder or common.TO_MEASURE_PROGRAM_FOLDER

    if args.all_tasks:
        tasks = common.load_and_register_tasks(args.all_tasks)
        if args.only_target:
            tasks = [t for t in tasks if t.target == args.only_target]
        if args.batch_size_1:
            from .make_dataset import preset_batch_size_1

            keys = preset_batch_size_1(args.only_target or args.target)
            tasks = [t for t in tasks if t.workload_key in keys]
        end = args.end_idx if args.end_idx is not None else len(tasks)
        tasks = tasks[args.start_idx:end:args.step_idx]
        t0 = time.time()
        dumped = {}
        for i, task in enumerate(tasks):
            out = _pool_file(out_folder, task)
            if os.path.exists(out) and os.path.getsize(out) > 0:
                print(f"[{i + 1}/{len(tasks)}] exists, skip {out}",
                      flush=True)
                continue
            try:
                n = dump_task(task, out, args.n_states, args.seed)
            except Exception as e:  # keep the sweep going; log the task
                print(f"[{i + 1}/{len(tasks)}] FAILED "
                      f"{task.workload_key[:60]}: {e!r}", flush=True)
                if os.path.exists(out):
                    os.remove(out)
                continue
            dumped[out] = n
            el = time.time() - t0
            print(f"[{i + 1}/{len(tasks)}] dumped {n} states -> {out} "
                  f"({el:.0f}s elapsed)", flush=True)
        return dumped

    if not args.workload_key:
        raise SystemExit("need --workload-key or --all-tasks")
    task = SearchTask(args.workload_key, args.target)
    out = args.out or _pool_file(out_folder, task)
    n = dump_task(task, out, args.n_states, args.seed)
    print(f"dumped {n} states -> {out}")
    return {out: n}


if __name__ == "__main__":
    main()
