"""List every task of the network task table (counterpart of
``scripts/print_all_tasks.py``).

Parity: reference scripts/print_all_tasks.py: enumerate all_tasks.pkl
with each task's FLOP count, target and workload key. The table is
``$VES_DATASET_ROOT/network_info/all_tasks.pkl`` (``cli.dump_network_info``
writes it); ``--network-info-folder`` is handed on as the pickle's path,
as the JAX script hands it to ``load_and_register_tasks``. Host work; no
device is involved.

    python -m vae_extent_search_tpu_torch.cli.print_all_tasks
"""

from __future__ import annotations

import argparse

from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--network-info-folder", default=None)
    args = p.parse_args(argv)
    tasks = common.load_and_register_tasks(args.network_info_folder)
    for i, task in enumerate(tasks):
        dag = task.compute_dag
        print(f"[{i:5d}] flop={dag.flop_ct:.3e} target={task.target} "
              f"key={task.workload_key[:80]}")
    return tasks


if __name__ == "__main__":
    main()
