"""Measure to-measure program pools into record logs (counterpart of
``scripts/measure_programs.py``).

Parity: reference scripts/measure_programs.py: replays to-measure files
through ProgramMeasurer (builder + runner + RecordToFile), shardable via
--start-idx/--end-idx/--step-idx (:88-91), with the FLOP-dependent
timing-repeat policy (:107-120; see ``search/measure.py::
flop_repeat_count``). The runners come from ``runner_from_spec``: the
analytic simulators, replay, an external timer command, the measurement
service, or the port's CUDA kernels timed on the card
(``cuda_matmul``, ``cuda_conv2d``). The others do host work only.

    python -m vae_extent_search_tpu_torch.cli.measure_programs \\
        --in-file pool.json --out-file measured.json --runner analytic_hf

A runner that measures straight from step records (``AnalyticRunner.
run_record_lists``, over the native replay) skips the State recovery, as
the JAX script does, with the same costs bit for bit and the measurer's
abort after 150 errors in a row (the records before it kept).
"""

from __future__ import annotations

import argparse
import glob
import os

from ..records import SearchTask, load_records, make_record, save_records
from ..search.measure import (
    MAX_CONTINUOUS_ERROR,
    EmptyBuilder,
    ProgramMeasurer,
    RecordToFile,
    flop_repeat_count,
    runner_from_spec,
)
from . import common


def remeasure_file(in_file: str, out_file: str, runner, batch: int = 64,
                   flop_repeats: bool = True, target: str = None):
    """Measure every record of ``in_file`` into ``out_file`` (replaced);
    returns the number measured. Stops with the measurer's error after
    150 errors in a row, keeping the batches written before."""
    records = load_records(in_file)
    if not records:
        return 0
    task = records[0].inp.task
    if target and target != task.target:
        # re-target the pool: to-measure programs are generated once per
        # target kind and measured on each platform of that kind, the
        # records carrying the platform's target string
        if target.split()[0] != (task.target.split()[0] if task.target
                                 else "llvm"):
            raise SystemExit(
                f"--target kind {target.split()[0]!r} does not match the "
                f"pool's kind {task.target!r}: schedule spaces differ "
                "across kinds; regenerate the pool with dump_programs")
        task = SearchTask(task.workload_key, target)
    if flop_repeats and hasattr(runner, "repeat"):
        # emitted records carry `repeat` cost entries scaled to the task's
        # arithmetic volume
        runner.repeat = flop_repeat_count(task.compute_dag.flop_ct)
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    if os.path.exists(out_file):
        os.remove(out_file)

    # runners that measure straight from step records skip the State
    # recovery (bit-identical costs)
    fast = getattr(runner, "run_record_lists", None)
    if fast is not None:
        results = fast(task, [r.inp.step_records for r in records])
        if results is not None:
            # ProgramMeasurer's abort at MAX_CONTINUOUS_ERROR, with
            # RecordToFile's persistence: what came before the abort is
            # written first
            error_ct = 0
            cut = len(results)
            for i, res in enumerate(results):
                if res.error_no == 0:
                    error_ct = 0
                else:
                    error_ct += 1
                    if error_ct >= MAX_CONTINUOUS_ERROR:
                        cut = i + 1
                        break
            out = [
                make_record(task, rec.inp.step_records, res.costs,
                            res.error_no, res.all_cost, res.timestamp)
                for rec, res in zip(records[:cut], results[:cut])
            ]
            save_records(out_file, out, mode="a")
            if cut < len(results):
                raise RuntimeError("too many continuous measurement errors")
            return len(out)

    measurer = ProgramMeasurer(
        EmptyBuilder(), runner, callbacks=[RecordToFile(out_file)]
    )
    n = 0
    for s in range(0, len(records), batch):
        chunk = records[s:s + batch]
        states = [r.inp.recover_state(infer_bound=True) for r in chunk]
        measurer.measure(task, states)
        n += len(states)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--in-file", type=str, default=None,
                   help="one to-measure file (else sweep --in-folder)")
    p.add_argument("--in-folder", type=str, default=None,
                   help="folder of to-measure files (default "
                        "to_measure_programs/), shardable via "
                        "--start-idx/--end-idx/--step-idx "
                        "(reference measure_programs.py:88-91)")
    p.add_argument("--out-file", type=str, default=None)
    p.add_argument("--runner", type=str, default="analytic",
                   help="analytic[:<platform>] | analytic_hf[:<platform>] | "
                        "replay | command:<external timer invoked as "
                        "'<cmd> in.json out.json'> | "
                        "service:<key>@<host>:<port> (the tracker/server "
                        "service, reference RPCRunner topology, "
                        "measure.py:434-611) | cuda_matmul[:<dtype>] | "
                        "cuda_conv2d[:<dtype>] | cuda_kernels[:<dtype>]")
    p.add_argument("--replay-log", type=str, default=None)
    p.add_argument("--noise", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--start-idx", type=int, default=0)
    p.add_argument("--end-idx", type=int, default=None)
    p.add_argument("--step-idx", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="skip files whose output already exists non-empty")
    p.add_argument("--no-flop-repeats", action="store_true",
                   help="disable the FLOP-dependent timing-repeat policy "
                        "(reference measure_programs.py:107-120) and emit "
                        "single-cost records")
    p.add_argument("--target", type=str, default=None,
                   help="measure the pools as this platform target "
                        "(records carry it; the analytic runner prices "
                        "with its profile, search/platforms.py). Output "
                        "defaults to measure_records/<platform>/ like the "
                        "reference's per-platform record folders")
    args = p.parse_args(argv)

    runner = runner_from_spec(args.runner, noise=args.noise,
                              seed=args.seed, replay_log=args.replay_log)

    if args.in_file:
        files = [args.in_file]
    else:
        folder = args.in_folder or common.TO_MEASURE_PROGRAM_FOLDER
        files = sorted(glob.glob(os.path.join(folder, "*.json")))
        end = args.end_idx if args.end_idx is not None else len(files)
        files = files[args.start_idx:end:args.step_idx]
        if not files:
            print(f"no to-measure files under {folder}")
            return {}

    out_folder = common.MEASURE_RECORD_FOLDER
    if args.target:
        from ..search.platforms import platform_for_target

        out_folder = os.path.join(common.MEASURE_RECORD_FOLDER,
                                  platform_for_target(args.target).name)

    measured = {}
    for i, in_file in enumerate(files):
        out = args.out_file if (args.out_file and len(files) == 1) else \
            os.path.join(out_folder, os.path.basename(in_file))
        if args.resume and os.path.exists(out) and os.path.getsize(out) > 0:
            print(f"[{i + 1}/{len(files)}] exists, skip {out}", flush=True)
            continue
        n = remeasure_file(in_file, out, runner, batch=args.batch_size,
                           flop_repeats=not args.no_flop_repeats,
                           target=args.target)
        measured[out] = n
        print(f"[{i + 1}/{len(files)}] measured {n} programs -> {out}",
              flush=True)
    return measured


if __name__ == "__main__":
    main()
