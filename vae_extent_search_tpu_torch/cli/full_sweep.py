"""Full multi-task sweep (counterpart of ``scripts/full_sweep.py``).

Per task: generate a candidate pool -> measure it (simulated or replayed)
-> featurise its extents through the native pipeline -> run the
VAE-extent active search -> append a per-task result row. Tasks shard over
processes by ``--shard-idx/--num-shards``, or by rank with
``--auto-shard`` (``parallel/multihost.py``: the ``VES_*`` variables).
With ``--global-mesh`` every rank instead joins one mesh over the "data"
axis and each task's pool is split over all ranks
(``run_active_search(mesh=)``); rank 0 generates the pool (the ``.done``
sentinel tells the others it is complete) and writes the CSV.

    python -m vae_extent_search_tpu_torch.cli.full_sweep --networks \\
        mobilenet_v2 --max-tasks 1 --n-states 200 --device cpu

Without ``--device cpu`` the search needs CUDA. Each rank of a
``--global-mesh`` run takes ``cuda:<rank mod cards>``; the backend is
NCCL when every rank has a card of its own, gloo otherwise.
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import time
from collections import Counter

import numpy as np

from ..records import SearchTask
from ..search.active_loop import pretrain_pool_vae, run_active_search
from ..search.measure import (
    EmptyBuilder,
    ProgramMeasurer,
    RecordToFile,
    runner_from_spec,
)
from ..search.select import SelectionConfig
from ..search.sketch import make_states
from .common import clean_name


def _pool(task: SearchTask, work_dir: str, n_states: int, noise: float,
          runner_spec: str, pool_owner: bool) -> str:
    """The task's measured pool log. The owner generates it unless its
    completion sentinel exists (a partial log from a killed run is
    regenerated); the others wait for the sentinel."""
    log = os.path.join(
        work_dir,
        clean_name((task.workload_key, task.target.split()[0])) + ".json")
    done = log + ".done"
    if pool_owner:
        if not os.path.exists(done):
            if os.path.exists(log):
                os.remove(log)
            states = make_states(task, n_states, seed=2023)
            measurer = ProgramMeasurer(
                EmptyBuilder(), runner_from_spec(runner_spec, noise=noise),
                callbacks=[RecordToFile(log)])
            for s in range(0, len(states), 256):
                measurer.measure(task, states[s:s + 256])
        with open(done, "w"):
            pass
    else:
        wait_s = float(os.environ.get("VES_POOL_WAIT_S", "7200"))
        deadline = time.time() + wait_s
        while not os.path.exists(done):
            if time.time() > deadline:
                raise TimeoutError(f"pool owner never finished {log}")
            time.sleep(0.5)
    return log


def sweep_task(task: SearchTask, work_dir: str, n_states: int,
               measure_size: int, seeds, max_phases: int, vae_epochs: int,
               reg_epochs: int, noise: float, mesh=None,
               pool_owner: bool = True, runner_spec: str = "analytic",
               device: str = "cuda"):
    """(result rows, None) for one task, or (None, skip reason)."""
    from ..records.fast_parser import featurize_extents_native

    log = _pool(task, work_dir, n_states, noise, runner_spec, pool_owner)
    vecs, labels, status = featurize_extents_native(log)
    ok = [i for i in range(len(vecs))
          if status[i] == 0 and vecs[i] is not None]
    if len(ok) < measure_size * 2:
        return None, {"reason": "pool_too_small", "pool": len(ok),
                      "raw_pool": len(vecs)}
    # the modal vector length (the experiment's uniform-length pool)
    modal = Counter(len(vecs[i]) for i in ok).most_common(1)[0][0]
    sel = [i for i in ok if len(vecs[i]) == modal]
    feats = np.stack([vecs[i] for i in sel])
    labs = np.asarray([labels[i] for i in sel], np.float32)
    if len(feats) < measure_size * 2:
        return None, {"reason": "modal_bucket_too_small",
                      "pool": len(feats), "raw_pool": len(vecs)}

    # one VAE pretrain per task, shared across sampling seeds
    vae_params = pretrain_pool_vae(feats, vae_epochs=vae_epochs,
                                   device=device, mesh=mesh)
    rows = []
    for seed in seeds:
        res = run_active_search(
            feats, labs, measure_size=measure_size, max_phases=max_phases,
            vae_epochs=vae_epochs, reg_epochs=reg_epochs,
            selection=SelectionConfig(num_select=measure_size),
            sampling_seed=seed, pretrained_vae_params=vae_params,
            device=device, mesh=mesh)
        rows.append({
            "workload_key": task.workload_key[:48],
            "n_candidates": len(feats),
            "seed": seed,
            "found": int(res.found),
            "phase": res.phase,
            "train_size": res.train_size,
            "used_time": round(res.used_time, 2),
            "top1": ("" if res.final_recall_topk is None
                     else res.final_recall_topk),
            "optimum_rank": ("" if res.final_optimum_rank is None
                             else res.final_optimum_rank),
        })
    return rows, None


def _write_rows(path: str, rows) -> None:
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        if not exists:
            w.writeheader()
        w.writerows(rows)


def _note_skip(path: str, entry: dict) -> bool:
    """Append ``entry`` to the ``.skipped`` sidecar unless a resumed run
    listed the task already; returns whether it was written."""
    if os.path.exists(path):
        with open(path, newline="") as f:
            if any(r.get("workload_key") == entry["workload_key"]
                   and r.get("target") == entry["target"]
                   for r in csv.DictReader(f)):
                return False
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["workload_key", "target",
                                          "reason", "pool", "raw_pool"])
        if f.tell() == 0:
            w.writeheader()
        w.writerow(entry)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tasks-pkl", type=str, default=None,
                   help="all_tasks.pkl-style task list")
    p.add_argument("--networks", nargs="*",
                   default=["resnet_18", "mobilenet_v2"])
    p.add_argument("--target", type=str, default="llvm -mcpu=skylake-avx512")
    p.add_argument("--work-dir", type=str, default="sweep_records")
    p.add_argument("--out-csv", type=str, default="sweep_results.csv")
    p.add_argument("--n-states", type=int, default=1000)
    p.add_argument("--measure-size", type=int, default=32)
    p.add_argument("--seeds", nargs="+", type=int, default=[2000, 2001])
    p.add_argument("--max-phases", type=int, default=20)
    p.add_argument("--vae-epochs", type=int, default=200)
    p.add_argument("--reg-epochs", type=int, default=300)
    p.add_argument("--noise", type=float, default=0.25)
    p.add_argument("--runner", type=str, default="analytic",
                   help="pool measurement runner spec (runner_from_spec)")
    p.add_argument("--max-tasks", type=int, default=None)
    p.add_argument("--shard-idx", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--auto-shard", action="store_true",
                   help="shard the tasks by rank (the VES_* variables)")
    p.add_argument("--global-mesh", action="store_true",
                   help="every rank joins one data mesh and each task's "
                        "pool is split over all ranks; rank 0 generates "
                        "the pool and writes the CSV")
    p.add_argument("--resume", action="store_true",
                   help="skip tasks whose rows already exist in --out-csv")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if args.tasks_pkl:
        with open(args.tasks_pkl, "rb") as f:
            tasks = [SearchTask.from_record(r) for r in pickle.load(f)]
    else:
        from ..records.networks import get_network_tasks

        tasks, seen = [], set()
        for net in args.networks:
            for t in get_network_tasks(net, target=args.target)[0]:
                if t.workload_key not in seen:
                    seen.add(t.workload_key)
                    tasks.append(t)

    from ..parallel.multihost import maybe_initialize_distributed

    shard_idx, num_shards = args.shard_idx, args.num_shards
    mesh = None
    is_writer = True
    if args.global_mesh:
        from ..parallel.mesh import make_mesh

        rank, _ = maybe_initialize_distributed(device=args.device)
        mesh = make_mesh(device=args.device)
        is_writer = rank == 0
    elif args.auto_shard:
        shard_idx, num_shards = maybe_initialize_distributed(
            device=args.device)
    tasks = tasks[shard_idx::num_shards]
    if args.max_tasks:
        tasks = tasks[:args.max_tasks]
    os.makedirs(args.work_dir, exist_ok=True)

    # preemption recovery: a task is done iff the CSV still holds one
    # unconsumed row for every seed under its truncated key
    done_budget = Counter()
    if args.resume and os.path.exists(args.out_csv):
        with open(args.out_csv, newline="") as f:
            done_budget = Counter((r["workload_key"], int(r["seed"]))
                                  for r in csv.DictReader(f))

    print(f"[shard {shard_idx}/{num_shards}] {len(tasks)} tasks")
    t0 = time.time()
    all_rows, skipped = [], []
    skipped_path = args.out_csv + ".skipped"
    for i, task in enumerate(tasks):
        key48 = task.workload_key[:48]
        seeds_to_run = []
        for s in args.seeds:
            if done_budget[(key48, s)] > 0:
                done_budget[(key48, s)] -= 1
            else:
                seeds_to_run.append(s)
        if not seeds_to_run:
            print(f"  task {i + 1}/{len(tasks)}: resumed (rows in log)")
            continue
        rows, skip = sweep_task(
            task, args.work_dir, args.n_states, args.measure_size,
            seeds_to_run, args.max_phases, args.vae_epochs, args.reg_epochs,
            args.noise, mesh=mesh, pool_owner=is_writer,
            runner_spec=args.runner, device=args.device)
        if rows:
            all_rows.extend(rows)
            if not is_writer:
                continue
            _write_rows(args.out_csv, rows)
            print(f"  task {i + 1}/{len(tasks)}: top-1 found "
                  f"{sum(r['found'] for r in rows)}/{len(rows)} seeds "
                  f"(phases {[r['phase'] for r in rows]})")
        else:
            skipped.append({"workload_key": task.workload_key,
                            "target": task.target, **(skip or {})})
            if is_writer and _note_skip(skipped_path, skipped[-1]):
                print(f"  task {i + 1}/{len(tasks)}: skipped "
                      f"({skipped[-1].get('reason', '?')}, pool "
                      f"{skipped[-1].get('pool', '?')}) -> {skipped_path}")

    if all_rows or skipped:
        n_swept = len({r["workload_key"] for r in all_rows})
        print(f"coverage: {len(tasks)} tasks listed, ~{n_swept} swept this "
              f"run, {len(skipped)} skipped (reasons in {skipped_path})")
    if all_rows:
        print(f"swept {len(tasks)} tasks in {time.time() - t0:.0f}s: top-1 "
              f"found rate {np.mean([r['found'] for r in all_rows]):.2f}, "
              f"mean phases {np.mean([r['phase'] for r in all_rows]):.2f} "
              f"-> {args.out_csv}")
    import torch

    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
