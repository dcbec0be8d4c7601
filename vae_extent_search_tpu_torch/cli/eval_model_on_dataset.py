"""Evaluate a trained cost model as a "dataset simulator" (counterpart of
``scripts/eval_model_on_dataset.py``).

Parity: reference scripts/eval_model_on_dataset.py: the top-k latency
score = best_latency / (weighted latency of the model's predicted top-k
schedules) over featurized per-task datasets (:19-73), reported for k=1
and k=5. ``--datasets`` evaluates pre-built dataset pickles with unit
weights.

    python -m vae_extent_search_tpu_torch.cli.eval_model_on_dataset \\
        --model mlp.pkl --datasets dataset.pkl

Runs on CUDA by default; ``--device cpu`` runs on the CPU. The
``--networks`` mode takes its task weights from the network task extraction
(``records/networks.py``), which is not ported yet, and raises.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..data.dataset import Dataset
from ..models import load_model_pickle
from ..models.embedding import embed_for_model


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--datasets", nargs="+", default=None,
                   help="dataset pickle per network (task datasets)")
    p.add_argument("--networks", nargs="*", default=None,
                   help="evaluate these networks from dataset/ record "
                        "files (not ported yet)")
    p.add_argument("--target", type=str, default="llvm -mcpu=skylake-avx512")
    p.add_argument("--cache-dir", type=str, default="dataset/eval_cache")
    p.add_argument("--top-ks", nargs="+", type=int, default=[1, 5])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.networks is not None:
        raise NotImplementedError(
            "--networks needs records/networks.py, which is not ported yet; "
            "pass --datasets")

    model = load_model_pickle(args.model, device=args.device)
    if hasattr(model, "device"):
        model.device = args.device   # tree models pickle their own

    scores = {}
    for path in args.datasets or []:
        with open(path, "rb") as f:
            ds: Dataset = pickle.load(f)
        task_datasets = [(ds, t) for t in ds.tasks()]
        weights = [1.0] * len(task_datasets)
        best, latencies = eval_cost_model_on_weighted_tasks(
            model, task_datasets, weights, args.top_ks
        )
        print(f"=== {path} ===")
        scores[path] = {}
        for k, lat in zip(args.top_ks, latencies):
            score = best / lat if lat > 0 else 0.0
            scores[path][k] = score
            print(f"top-{k} score: {score:.4f} "
                  f"(best {best * 1e3:.3f} ms vs picked {lat * 1e3:.3f} ms)")
    return scores


if __name__ == "__main__":
    main()
