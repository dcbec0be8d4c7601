"""Dump network task info for the benchmark grid (counterpart of
``scripts/dump_network_info.py``).

Parity: reference scripts/dump_network_info.py: builds per-network task
lists for the network grid and writes ``*.task.pkl`` files plus the global
``all_tasks.pkl`` registry (:139-241), under ``$VES_DATASET_ROOT/
network_info``. Host work over the static shape tables of
``records/networks.py``; no device is involved.

    python -m vae_extent_search_tpu_torch.cli.dump_network_info \\
        --target "llvm -mcpu=skylake-avx512"

``--from-model`` traces a real model graph, which needs the graph
front end (``frontend/``, ROADMAP queue 1 #7); it is not ported yet and
raises; its ``--batch-size``, ``--image-size`` and ``--seq-length``
will come with it.
"""

from __future__ import annotations

import argparse
import os
import pickle

from ..records.networks import build_network_keys, get_network_tasks
from . import common


def dump_network_info(target: str = "llvm", networks=None):
    """Write one task pickle per grid entry (of ``networks``, or all 108)
    and merge the tasks into ``all_tasks.pkl``. Returns
    {(name, (batch, size)): number of tasks}."""
    folder = common.NETWORK_INFO_FOLDER
    os.makedirs(folder, exist_ok=True)
    all_tasks = {}
    keys = build_network_keys()
    if networks:
        keys = [k for k in keys if k[0] in networks]

    dumped = {}
    for name, shape_args in keys:
        try:
            tasks, weights = get_network_tasks(name, *shape_args,
                                               target=target)
        except ValueError:
            continue
        network_key = (name, list(shape_args))
        out = os.path.join(folder,
                           common.clean_name((network_key, target))
                           + ".task.pkl")
        with open(out, "wb") as f:
            pickle.dump(([t.to_record() for t in tasks], weights), f)
        for t in tasks:
            all_tasks[(t.workload_key, t.target)] = t.to_record()
        dumped[(name, tuple(shape_args))] = len(tasks)
        print(f"{name} {shape_args}: {len(tasks)} tasks -> {out}")

    # all_tasks.pkl is the GLOBAL registry across platforms (the
    # reference's spans all its hardware targets): merge with any
    # existing registry so a cuda grid dump does not clobber the llvm
    # one; this run's tasks win on key collisions
    reg_path = os.path.join(folder, "all_tasks.pkl")
    if os.path.exists(reg_path):
        with open(reg_path, "rb") as f:
            for rec in pickle.load(f):
                all_tasks.setdefault((rec[0], rec[1]), rec)
    with open(reg_path, "wb") as f:
        pickle.dump(list(all_tasks.values()), f)
    print(f"all_tasks.pkl: {len(all_tasks)} unique tasks")
    return dumped


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--target", type=str, default="llvm")
    p.add_argument("--networks", nargs="*", default=None)
    p.add_argument("--from-model", type=str, default=None,
                   help="trace a real model graph (not ported yet)")
    args = p.parse_args(argv)
    if args.from_model:
        raise NotImplementedError(
            "--from-model needs the graph front end (frontend/), which is "
            "not ported yet; the static tables need no flag")
    return dump_network_info(args.target, args.networks)


if __name__ == "__main__":
    main()
