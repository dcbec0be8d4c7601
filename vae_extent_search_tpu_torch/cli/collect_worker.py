"""Fleet collection worker: measure an assigned shard, zip, exit
(counterpart of ``scripts/collect_fleet/collect_worker.py``).

The worker (optionally) measures one file and discards it as a warm-up,
measures its interleaved file shard [start:end:step] with
``cli/measure_programs.py::remeasure_file``, zips the records into
``dataset_part_<start>_<end>.zip`` (archive paths under
``dataset/measure_records/``), deletes the raw records and, with
``--shutdown``, powers the machine down. ``--auto-shard`` takes (start,
step) = (rank, world) of the ``torch.distributed`` group that the
``VES_*`` variables describe (gloo: the measuring is host work).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import zipfile


def run_shard(in_folder: str, out_folder: str, start: int, end, step: int,
              runner: str, noise: float, seed: int) -> int:
    """Measure files [start:end:step] of ``in_folder`` into
    ``out_folder``; returns the number of programs measured."""
    from ..search.measure import runner_from_spec
    from .measure_programs import remeasure_file

    r = runner_from_spec(runner, noise=noise, seed=seed)
    files = sorted(glob.glob(os.path.join(in_folder, "*.json")))
    end = len(files) if end is None else end
    os.makedirs(out_folder, exist_ok=True)
    total = 0
    for f in files[start:end:step]:
        n = remeasure_file(f, os.path.join(out_folder, os.path.basename(f)),
                           r)
        total += n
        print(f"[shard {start}/{step}] {f}: {n} programs", flush=True)
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--start-idx", type=int, default=0)
    p.add_argument("--end-idx", type=int, default=None)
    p.add_argument("--step-idx", type=int, default=1)
    p.add_argument("--auto-shard", action="store_true",
                   help="shard by torch.distributed rank (the VES_* "
                        "variables) instead of explicit indices")
    p.add_argument("--in-folder", type=str,
                   default="dataset/to_measure_programs")
    p.add_argument("--workdir", type=str, default=".",
                   help="records and the zip land under it")
    p.add_argument("--runner", type=str, default="analytic")
    p.add_argument("--noise", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", action="store_true")
    p.add_argument("--no-zip", action="store_true",
                   help="leave the raw records in place")
    p.add_argument("--shutdown", action="store_true",
                   help="power off when done (needs privileges)")
    args = p.parse_args(argv)

    start, end, step = args.start_idx, args.end_idx, args.step_idx
    if args.auto_shard:
        from ..parallel.multihost import maybe_initialize_distributed

        start, step = maybe_initialize_distributed(device="cpu")
        end = None

    records_dir = os.path.join(args.workdir, "dataset", "measure_records")
    if args.warmup:
        run_shard(args.in_folder, records_dir, 0, 1, 1, args.runner,
                  args.noise, args.seed)
        shutil.rmtree(records_dir, ignore_errors=True)
    run_shard(args.in_folder, records_dir, start, end, step, args.runner,
              args.noise, args.seed)

    if not args.no_zip:
        end_name = end if end is not None else "all"
        zpath = os.path.join(args.workdir,
                             f"dataset_part_{start}_{end_name}.zip")
        if os.path.exists(zpath):
            os.remove(zpath)
        with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as zf:
            for f in sorted(glob.glob(os.path.join(records_dir, "*"))):
                zf.write(f, os.path.join("dataset", "measure_records",
                                         os.path.basename(f)))
        shutil.rmtree(records_dir)
        print(f"zipped -> {zpath}", flush=True)

    import torch

    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if args.shutdown:
        os.system("sudo shutdown -h now")


if __name__ == "__main__":
    main()
