"""Evaluate a trained cost model as a "dataset simulator" (counterpart of
``scripts/eval_model_on_dataset.py``).

Parity: reference scripts/eval_model_on_dataset.py: the top-k latency
score = best_latency / (weighted latency of the model's predicted top-k
schedules) over featurized per-task datasets (:19-73), reported for k=1
and k=5. ``--networks`` mode mirrors the reference: per network, the task
weights come from the network's task pkl under ``$VES_DATASET_ROOT/
network_info`` (``cli.dump_network_info``), the records from the
per-platform folder of ``measure_records`` or else its root, and the
featurized dataset is cached under ``--cache-dir`` (:50-62); given bare,
it scores the default five networks (:133-140). ``--datasets`` evaluates
pre-built dataset pickles with unit weights.

    python -m vae_extent_search_tpu_torch.cli.eval_model_on_dataset \\
        --model mlp.pkl --datasets dataset.pkl
    python -m vae_extent_search_tpu_torch.cli.eval_model_on_dataset \\
        --model mlp.pkl --networks resnet_50

Runs on CUDA by default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..data.dataset import Dataset, make_dataset_from_log_file
from ..models import load_model_pickle
from ..models.embedding import embed_for_model
from ..search.platforms import platform_for_target
from . import common

DEFAULT_NETWORKS = ["resnet_50", "mobilenet_v2", "resnext_50",
                    "bert_tiny", "bert_base"]


def eval_cost_model_on_weighted_tasks(model, task_datasets, weights, top_ks):
    """reference eval_model_on_dataset.py:19-40."""
    best_latency = 0.0
    latencies = [0.0] * len(top_ks)
    for (task, weight) in zip(task_datasets, weights):
        ds, tsk = task
        feats = [np.asarray(f, np.float32) for f in ds.features[tsk]]
        labels = ds.throughputs[tsk]
        min_latency = ds.min_latency[tsk]
        feats = embed_for_model(model, feats, tsk.workload_key)
        preds = model.predict_on_features(feats)
        real_values = labels[np.argsort(-preds)]
        real_latency = min_latency / np.maximum(real_values, 1e-10)
        for i, top_k in enumerate(top_ks):
            latencies[i] += np.min(real_latency[:top_k]) * weight
        best_latency += min_latency * weight
    return best_latency, latencies


def network_task_datasets(network, target, cache_dir, min_sample_size=48):
    """Build (or load cached) the featurized per-task dataset of one
    network from its measure-record files (reference :50-62). Returns
    ([(dataset, task)], [weight]) for the network's tasks that have
    records."""
    network_key = (network, [1, 224] if not network.startswith("bert") else
                   [1, 128])
    name = common.clean_name((network_key, target))
    task_pkl = os.path.join(common.NETWORK_INFO_FOLDER, f"{name}.task.pkl")
    with open(task_pkl, "rb") as f:
        task_records, weights = pickle.load(f)

    cache = os.path.join(cache_dir, f"{name}.pkl")
    if not os.path.exists(cache):
        # records live either at the folder root (single-platform
        # pipelines) or under the per-platform subfolder that
        # measure_programs --target writes (reference per-platform
        # record folders); the EVAL target's platform decides which
        platform_folder = os.path.join(
            common.MEASURE_RECORD_FOLDER, platform_for_target(target).name)
        files = []
        for rec in task_records:
            wkl_key, tgt = rec[0], rec[1]
            kind = tgt.split(" ")[0].split("-")[0]
            fname = f"{common.clean_name((wkl_key, kind))}.json"
            for folder in (platform_folder, common.MEASURE_RECORD_FOLDER):
                f = os.path.join(folder, fname)
                if os.path.exists(f):
                    files.append(f)
                    break
            else:
                print(f"  missing record file for {wkl_key}; skipped")
        os.makedirs(cache_dir, exist_ok=True)
        make_dataset_from_log_file(files, cache, min_sample_size)
    with open(cache, "rb") as f:
        ds: Dataset = pickle.load(f)

    by_key = {}
    for rec, w in zip(task_records, weights):
        by_key[rec[0]] = float(w)
    task_datasets, task_weights = [], []
    for t in ds.tasks():
        if t.workload_key in by_key:
            task_datasets.append((ds, t))
            task_weights.append(by_key[t.workload_key])
    return task_datasets, task_weights


def _report(best, latencies, top_ks):
    scores = {}
    for k, lat in zip(top_ks, latencies):
        score = best / lat if lat > 0 else 0.0
        scores[k] = score
        print(f"top-{k} score: {score:.4f} "
              f"(best {best * 1e3:.3f} ms vs picked {lat * 1e3:.3f} ms)")
    return scores


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--datasets", nargs="+", default=None,
                   help="dataset pickle per network (task datasets)")
    p.add_argument("--networks", nargs="*", default=None,
                   help="evaluate these networks from dataset/ record "
                        "files (reference mode; empty = the default 5)")
    p.add_argument("--target", type=str, default="llvm -mcpu=skylake-avx512")
    p.add_argument("--cache-dir", type=str, default="dataset/eval_cache")
    p.add_argument("--top-ks", nargs="+", type=int, default=[1, 5])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    model = load_model_pickle(args.model, device=args.device)
    if hasattr(model, "device"):
        model.device = args.device   # tree models pickle their own

    scores = {}
    if args.networks is not None:
        for network in args.networks or DEFAULT_NETWORKS:
            task_datasets, weights = network_task_datasets(
                network, args.target, args.cache_dir)
            best, latencies = eval_cost_model_on_weighted_tasks(
                model, task_datasets, weights, args.top_ks)
            print(f"=== {network} ({len(task_datasets)} tasks) ===")
            scores[network] = _report(best, latencies, args.top_ks)
        return scores

    for path in args.datasets or []:
        with open(path, "rb") as f:
            ds: Dataset = pickle.load(f)
        task_datasets = [(ds, t) for t in ds.tasks()]
        weights = [1.0] * len(task_datasets)
        best, latencies = eval_cost_model_on_weighted_tasks(
            model, task_datasets, weights, args.top_ks
        )
        print(f"=== {path} ===")
        scores[path] = _report(best, latencies, args.top_ks)
    return scores


if __name__ == "__main__":
    main()
