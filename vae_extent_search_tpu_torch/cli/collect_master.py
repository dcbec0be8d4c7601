"""Fleet collection master: launch measurement workers over a fleet
(counterpart of ``scripts/collect_fleet/collect_master.py``).

Worker i of n measures the to-measure task files [i : end : n] (the
reference's ``--start-idx/--end-idx/--step-idx`` contract), zips its
records into ``dataset_part_<start>_<end>.zip`` and exits;
``cli/gather_master.py`` merges the zips afterwards.

Worker specs (only the transport differs):

- ``ssh:<host>[:<remote_repo_dir>]``: launched detached on another machine
  with ``ssh ... tmux new-session -d``; fire-and-forget;
- ``local[:<workdir>]``: a local subprocess with its own working directory
  (default ``fleet_work/worker_<i>``); the master waits for it.

    python -m vae_extent_search_tpu_torch.cli.collect_master \\
        --workers local:w0 local:w1 --in-folder dataset/to_measure_programs
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = "vae_extent_search_tpu_torch.cli.collect_worker"


def worker_cmd(start: int, end: int, step: int, args) -> list:
    cmd = ["python3", "-m", WORKER,
           "--start-idx", str(start), "--end-idx", str(end),
           "--step-idx", str(step),
           "--in-folder", args.in_folder,
           "--runner", args.runner]
    if args.noise is not None:
        cmd += ["--noise", str(args.noise)]
    if args.seed is not None:
        cmd += ["--seed", str(args.seed)]
    if args.warmup:
        cmd += ["--warmup"]
    if args.shutdown:
        cmd += ["--shutdown"]
    return cmd


def launch_ssh(host: str, repo_dir: str, cmd: list):
    """Detached launch on a remote machine: ssh <host> tmux new-session
    -d, from the remote checkout."""
    remote = f"cd {repo_dir}; " + " ".join(cmd)
    remote = remote.replace('"', '\\"')
    full = (f'ssh -o StrictHostKeyChecking=no {host} '
            f'"tmux new-session -d \\"{remote}\\""')
    print(full)
    ret = os.system(full)
    if ret != 0:
        # os.system returns a wait status; exit with a readable message
        raise SystemExit(f"ssh launch failed on {host} "
                         f"(status {ret >> 8 or ret})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workers", nargs="+", required=True,
                   help="worker specs: ssh:<host>[:<repo_dir>] or "
                        "local[:<workdir>]")
    p.add_argument("--in-folder", type=str,
                   default="dataset/to_measure_programs",
                   help="to-measure task files (a shared path, or synced "
                        "to every worker)")
    p.add_argument("--n-tasks", type=int, default=None,
                   help="cap the file index range; default: every file in "
                        "--in-folder")
    p.add_argument("--runner", type=str, default="analytic")
    p.add_argument("--noise", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--warmup", action="store_true",
                   help="workers measure and discard one file first")
    p.add_argument("--shutdown", action="store_true",
                   help="workers power the machine down when done "
                        "(local workers just exit)")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    if args.n_tasks is not None:
        end = args.n_tasks
    else:
        end = len(glob.glob(os.path.join(args.in_folder, "*.json")))
        if end == 0:
            raise SystemExit(
                f"no task files under {args.in_folder!r} on this master; "
                "pass --n-tasks when the corpus lives on the workers")
    n_workers = len(args.workers)
    print(f"tasks: {end}, workers: {n_workers}, "
          f"tasks/worker <= {-(-end // max(n_workers, 1))}")

    procs = []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for wi, spec in enumerate(args.workers):
        cmd = worker_cmd(wi, end, n_workers, args)
        if spec.startswith("ssh:"):
            parts = spec.split(":", 2)
            host = parts[1]
            repo_dir = parts[2] if len(parts) > 2 else "vae-extent-search-tpu"
            if args.dry_run:
                print(f"[{host}] {' '.join(cmd)}")
            else:
                launch_ssh(host, repo_dir, cmd)
        elif spec == "local" or spec.startswith("local:"):
            workdir = (spec.split(":", 1)[1] if ":" in spec
                       else os.path.join("fleet_work", f"worker_{wi}"))
            cmd = [sys.executable] + cmd[1:] + ["--workdir", workdir]
            if args.dry_run:
                print(f"[local {workdir}] {' '.join(cmd)}")
            else:
                os.makedirs(workdir, exist_ok=True)
                procs.append(subprocess.Popen(cmd, env=env))
        else:
            raise SystemExit(f"unknown worker spec {spec!r} "
                             "(want ssh:<host> or local[:<workdir>])")

    rc = 0
    for pr in procs:
        rc |= pr.wait()
    if procs:
        print(f"local workers done (rc={rc}); gather with "
              "vae_extent_search_tpu_torch.cli.gather_master")
    sys.exit(rc)


if __name__ == "__main__":
    main()
