"""The performance dataset: (task -> features, throughputs); counterpart of
``vae_extent_search_tpu/data/dataset.py``, featurising with the port's
Python per-store featuriser.

Parity target: python/tvm/auto_scheduler/dataset.py —
``LearningTask(workload_key, target)``-keyed dict of ragged feature arrays
+ normalized throughputs (min_latency / latency), renormalization on merge
(:66-85), the three split schemes (:87-179), and
``make_dataset_from_log_file`` with a ``.dataset_cache/<path>.feature_cache``
pickle cache, dropping tasks with fewer than ``min_sample_size`` records
(:214-287).
"""

from __future__ import annotations

import os
import pickle
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

import numpy as np

LearningTask = namedtuple("LearningTask", ["workload_key", "target"])
CACHE_FOLDER = ".dataset_cache_torch"


class Dataset:
    def __init__(self):
        self.raw_files = None
        self.features: Dict[LearningTask, np.ndarray] = {}
        self.throughputs: Dict[LearningTask, np.ndarray] = {}
        self.min_latency: Dict[LearningTask, float] = {}

    # ------------------------------------------------------------------
    def load_task_data(self, task: LearningTask, features, throughputs,
                       min_latency: float):
        """Insert or merge one task's data, renormalizing throughputs on
        merge (reference dataset.py:66-85)."""
        features = np.asarray(features, dtype=object)
        throughputs = np.asarray(throughputs, np.float32)
        if task not in self.features:
            self.features[task] = features
            self.throughputs[task] = throughputs
            self.min_latency[task] = float(min_latency)
            return
        # merge: re-normalize both sides to the common min latency
        old_min = self.min_latency[task]
        new_min = min(old_min, float(min_latency))
        old_thr = self.throughputs[task] * (new_min / old_min)
        add_thr = throughputs * (new_min / float(min_latency))
        self.features[task] = np.concatenate(
            [self.features[task], features]
        )
        self.throughputs[task] = np.concatenate([old_thr, add_thr])
        self.min_latency[task] = new_min

    def update_from_dataset(self, other: "Dataset"):
        for task in other.features:
            self.load_task_data(
                task, other.features[task], other.throughputs[task],
                other.min_latency[task],
            )

    # ------------------------------------------------------------------
    def tasks(self) -> List[LearningTask]:
        return list(self.features.keys())

    def __len__(self):
        return sum(len(t) for t in self.throughputs.values())

    # ------------------------------------------------------------------
    # splits (reference dataset.py:87-179)
    # ------------------------------------------------------------------

    def random_split_within_task(self, train_set_ratio: float = 0.9,
                                 shuffle_time: bool = False, seed: int = 0,
                                 train_idxs=None, test_idxs=None):
        train, test = Dataset(), Dataset()
        rng = np.random.default_rng(seed)
        for task in self.features:
            feats, thr = self.features[task], self.throughputs[task]
            n = len(thr)
            if train_idxs is not None and test_idxs is not None:
                tr = np.asarray(train_idxs.get(task, []), np.int64)
                te = np.asarray(test_idxs.get(task, []), np.int64)
            else:
                perm = rng.permutation(n)
                k = int(n * train_set_ratio)
                tr, te = perm[:k], perm[k:]
            if len(tr):
                train.load_task_data(task, feats[tr], thr[tr],
                                     self.min_latency[task])
            if len(te):
                test.load_task_data(task, feats[te], thr[te],
                                    self.min_latency[task])
        return train, test

    def random_split_by_task(self, train_set_ratio: float = 0.9,
                             seed: int = 0):
        train, test = Dataset(), Dataset()
        tasks = self.tasks()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(tasks))
        k = int(len(tasks) * train_set_ratio)
        for i, ti in enumerate(perm):
            dst = train if i < k else test
            task = tasks[ti]
            dst.load_task_data(task, self.features[task],
                               self.throughputs[task],
                               self.min_latency[task])
        return train, test

    def random_split_by_target(self, train_targets: List[str]):
        train, test = Dataset(), Dataset()
        for task in self.tasks():
            dst = train if task.target in train_targets else test
            dst.load_task_data(task, self.features[task],
                               self.throughputs[task],
                               self.min_latency[task])
        return train, test

    # flatten helpers -------------------------------------------------

    def flatten(self, with_workload_embedding: bool = False,
                embed_total_dim: int = 10
                ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
        """(ragged feature list, labels, task_ids) across all tasks.

        ``with_workload_embedding`` tiles each task's workload embedding
        onto its rows (reference SegmentDataLoader, mlp_model.py:52-80;
        see models/embedding.py). ``embed_total_dim``: 10 for the
        MLP-family models (9 tags + reserved target slot), 9 raw tags
        for the tree models (xgb_model.py:301-304)."""
        feats, labels, task_ids, keys = [], [], [], []
        for tid, task in enumerate(self.tasks()):
            for f in self.features[task]:
                feats.append(np.asarray(f, np.float32))
                keys.append(task.workload_key)
            labels.append(self.throughputs[task])
            task_ids.extend([tid] * len(self.throughputs[task]))
        if with_workload_embedding and feats:
            from ..models.embedding import append_workload_embedding

            feats = append_workload_embedding(feats, keys,
                                              total_dim=embed_total_dim)
        labels = np.concatenate(labels) if labels else np.zeros(0, np.float32)
        return feats, labels, np.asarray(task_ids, np.int32)


def make_dataset_from_log_file(log_files, out_file: str,
                               min_sample_size: int = 48,
                               verbose: int = 1,
                               exclude_workload_keys=None,
                               max_records_per_file=None):
    """Featurize measure-record logs into a Dataset pickle, with per-file
    feature caches (reference dataset.py:214-287).

    ``exclude_workload_keys``: workload keys to drop (the reference's
    hold-out sets, make_dataset.py:24-59); ``max_records_per_file``
    caps records per log (the reference's --n-measurement). The caches
    pickle this package's ``LearningTask``, so they live in a folder of
    their own (``CACHE_FOLDER``, under the working directory), apart from
    the JAX package's ``.dataset_cache``."""
    cache_folder = CACHE_FOLDER
    os.makedirs(cache_folder, exist_ok=True)

    dataset = Dataset()
    dataset.raw_files = list(log_files)
    for filename in dataset.raw_files:
        if not os.path.exists(filename):
            raise FileNotFoundError(f"{filename} does not exist")
        cap = f".n{max_records_per_file}" if max_records_per_file else ""
        cache_file = os.path.join(
            cache_folder, filename.replace("/", "_") + cap + ".feature_cache"
        )
        if os.path.exists(cache_file):
            if verbose:
                print(f"Load feature cache from {cache_file}")
            with open(cache_file, "rb") as f:
                features, throughputs, task_keys, min_costs = pickle.load(f)
        else:
            if verbose:
                print(f"Featurize {filename}")
            from ..records.serde import load_records

            records = load_records(filename)
            if max_records_per_file:
                records = records[:max_records_per_file]
            inputs = [r.inp for r in records]
            results = [r.res for r in records]
            from ..features.per_store import (
                get_per_store_features_from_measure_pairs,
            )

            features, throughputs, task_ids, min_costs = (
                get_per_store_features_from_measure_pairs(inputs, results)
            )
            # recover the ordered unique task list
            task_keys = []
            seen = {}
            for inp in inputs:
                key = LearningTask(inp.task.workload_key, inp.task.target)
                if key not in seen:
                    seen[key] = len(seen)
                    task_keys.append(key)
            features = (features, task_ids)
            with open(cache_file, "wb") as f:
                pickle.dump((features, throughputs, task_keys, min_costs), f)

        feature_list, task_ids = features
        for tid, task in enumerate(task_keys):
            if exclude_workload_keys is not None and \
                    task.workload_key in exclude_workload_keys:
                continue
            sel = [i for i, t in enumerate(task_ids) if t == tid]
            if len(sel) < min_sample_size:
                continue
            dataset.load_task_data(
                task,
                np.asarray([feature_list[i] for i in sel], dtype=object),
                throughputs[sel],
                float(min_costs[tid]),
            )

    if out_file:
        with open(out_file, "wb") as f:
            pickle.dump(dataset, f)
        if verbose:
            print(
                f"A dataset file is saved to {out_file} "
                f"({len(dataset)} samples, {len(dataset.tasks())} tasks)"
            )
    return dataset
