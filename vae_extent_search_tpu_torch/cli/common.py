"""Dataset folders and file names of the network-level command lines
(counterpart of ``scripts/common.py``).

Parity: reference scripts/common.py (dataset folder constants :41-43,
clean_name file scheme :45-66, load_and_register_tasks :68-75). The root
is ``$VES_DATASET_ROOT`` (default ``dataset``, under the working
directory), read at import; ``set_dataset_root`` reads it again, or sets
another root, for a caller that changes it later in the same process.
"""

from __future__ import annotations

import os
import pickle

DATASET_ROOT = NETWORK_INFO_FOLDER = MEASURE_RECORD_FOLDER = ""


def set_dataset_root(root=None):
    """Point the folders at ``root``, or at ``$VES_DATASET_ROOT`` (default
    ``dataset``) when ``root`` is None."""
    global DATASET_ROOT, NETWORK_INFO_FOLDER, MEASURE_RECORD_FOLDER
    DATASET_ROOT = root or os.environ.get("VES_DATASET_ROOT", "dataset")
    NETWORK_INFO_FOLDER = os.path.join(DATASET_ROOT, "network_info")
    MEASURE_RECORD_FOLDER = os.path.join(DATASET_ROOT, "measure_records")


set_dataset_root()


def clean_name(x) -> str:
    """File-name scheme for (workload_key, target_kind) tuples."""
    x = str(x)
    for ch in (" ", '"', "/"):
        x = x.replace(ch, "")
    return x


def load_and_register_tasks(path=None):
    """Load tasks from an all_tasks.pkl-equivalent and register their
    workloads (reference common.py:68-75). The pickle holds a list of
    SearchTask records."""
    from ..records import SearchTask

    path = path or os.path.join(NETWORK_INFO_FOLDER, "all_tasks.pkl")
    with open(path, "rb") as f:
        task_records = pickle.load(f)
    return [SearchTask.from_record(r) for r in task_records]
