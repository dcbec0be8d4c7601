"""Fleet gather: copy the workers' zip shards back and merge the records
(counterpart of ``scripts/collect_fleet/gather_master.py``).

Each zip's ``dataset/measure_records/*`` entries are extracted into one
records folder; the shards are disjoint (interleaved file indices), so
merging is a union. Sources follow ``cli/collect_master.py``'s worker
specs: ``ssh:<host>[:<remote_repo_dir>]`` (scp, staged per host) or
``local:<workdir>``.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import zipfile


def fetch_zips(spec: str, stage_dir: str) -> list:
    if spec.startswith("ssh:"):
        parts = spec.split(":", 2)
        host = parts[1]
        repo_dir = parts[2] if len(parts) > 2 else "vae-extent-search-tpu"
        # a directory per host, emptied of earlier zips: a shared one would
        # merge other sources' or an earlier gather's zips again
        host_dir = os.path.join(stage_dir, host.replace("@", "_"))
        os.makedirs(host_dir, exist_ok=True)
        for old in glob.glob(os.path.join(host_dir, "dataset_part_*.zip")):
            os.remove(old)
        cmd = (f"scp -o StrictHostKeyChecking=no "
               f"{host}:{repo_dir}/dataset_part_*.zip {host_dir}/")
        print(cmd)
        subprocess.run(cmd, shell=True, check=True)
        return sorted(glob.glob(os.path.join(host_dir, "dataset_part_*.zip")))
    if spec == "local" or spec.startswith("local:"):
        workdir = spec.split(":", 1)[1] if ":" in spec else "."
        return sorted(glob.glob(os.path.join(workdir, "dataset_part_*.zip")))
    raise SystemExit(f"unknown source spec {spec!r}")


def merge_zip(zpath: str, out_folder: str) -> int:
    n = 0
    with zipfile.ZipFile(zpath) as zf:
        for name in zf.namelist():
            base = os.path.basename(name)
            if not base:
                continue
            with zf.open(name) as src, \
                    open(os.path.join(out_folder, base), "wb") as dst:
                dst.write(src.read())
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workers", nargs="+", required=True,
                   help="where the zips live: ssh:<host>[:<repo_dir>] or "
                        "local:<workdir>")
    p.add_argument("--out-folder", type=str,
                   default="dataset/measure_records")
    p.add_argument("--stage-dir", type=str, default="fleet_gather",
                   help="staging directory for scp'd zips")
    args = p.parse_args(argv)

    os.makedirs(args.out_folder, exist_ok=True)
    total = 0
    for spec in args.workers:
        for zpath in fetch_zips(spec, args.stage_dir):
            n = merge_zip(zpath, args.out_folder)
            total += n
            print(f"{zpath}: merged {n} record files")
    print(f"gathered {total} record files -> {args.out_folder}")


if __name__ == "__main__":
    main()
