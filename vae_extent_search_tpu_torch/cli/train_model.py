"""Train and evaluate cost models on a performance dataset (counterpart of
``scripts/train_model.py``).

Parity: reference scripts/train_model.py:33-175: load dataset pickle(s),
split (within_task / by_task / by_target), train the requested models
("mlp", "mlp@lambdaRank", "gbdt", "xgb", "lgb"/"lgbm", "random", and
the sequence models "lstm", "mha", "tabnet"), report
weighted RMSE / R2 / pairwise accuracy / MAPE / peak@1 / peak@5 per model,
save <name>.pkl.

    python -m vae_extent_search_tpu_torch.cli.train_model \\
        --dataset dataset.pkl --models mlp

Runs on CUDA by default; ``--device cpu`` runs on the CPU. Asking for CUDA
on a host without a GPU is an error.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..data.dataset import Dataset
from ..device import resolve_device
from ..models import metrics as M
from ..models.embedding import embed_for_model
from ..models.gbdt import (
    GBDTModelInternal,
    LGBModelInternal,
    RandomModelInternal,
)
from ..models.segment import MLPModelInternal
from ..models.variants import SequenceModelInternal

METRIC_NAMES = ["RMSE", "R^2", "pairwise comparision accuracy", "mape",
                "average peak score@1", "average peak score@5"]
_KINDS = {"mlp", "gbdt", "xgb", "lgb", "lgbm", "random", "lstm", "mha",
          "tabnet"}


def evaluate_model(model, test_ds: Dataset):
    """Per-task metrics, weighted by task sample counts
    (reference train_model.py:33-76)."""
    rows = []
    weights = []
    for task in test_ds.tasks():
        feats = [np.asarray(f, np.float32) for f in test_ds.features[task]]
        labels = test_ds.throughputs[task]
        feats = embed_for_model(model, feats, task.workload_key)
        preds = model.predict_on_features(feats)
        finite = np.isfinite(preds)
        preds = np.where(finite, preds, 0.0)
        rows.append([
            M.metric_rmse(preds, labels),
            M.metric_r_squared(preds, labels),
            M.metric_pairwise_comp_accuracy(preds, labels),
            M.metric_mape(preds, labels),
            M.metric_peak_score(preds, labels, 1),
            M.metric_peak_score(preds, labels, 5),
        ])
        weights.append(len(labels))
    if not rows:
        return dict(zip(METRIC_NAMES, [0.0] * len(METRIC_NAMES)))
    rows = np.asarray(rows)
    weights = np.asarray(weights, np.float64)
    weights /= weights.sum()
    return dict(zip(METRIC_NAMES,
                    (rows * weights[:, None]).sum(axis=0).tolist()))


def make_model(spec: str, in_dim: int, device="cuda", seed: int = 0):
    parts = spec.split("@")
    kind = parts[0]
    if kind == "mlp":
        loss = parts[1] if len(parts) > 1 else "lambdaRank"
        return MLPModelInternal(in_dim=in_dim, loss_type=loss, seed=seed,
                                device=device)
    if kind in ("lgb", "lgbm"):
        # "lgbm" is the reference's name (its train_model.py model
        # table); lightgbm growth semantics via LGBModelInternal
        return LGBModelInternal(device=device)
    if kind == "random":
        return RandomModelInternal()
    if kind in ("gbdt", "xgb"):
        # both run the reference pack-sum protocol on the in-repo booster
        return GBDTModelInternal(
            backend="xgb" if kind == "xgb" else "auto", device=device)
    if kind in ("lstm", "mha", "tabnet"):
        return SequenceModelInternal(arch=kind, in_dim=in_dim, seed=seed,
                                     device=device)
    raise ValueError(f"unknown model spec {spec}")


def train_zero_shot(dataset: Dataset, models: str, split_scheme: str,
                    seed: int = 0, verbose: bool = False,
                    train_ratio: float = 0.9,
                    use_workload_embedding: bool = True, device="cuda"):
    """Split, train every model of ``models`` on ``device``, evaluate on the
    test split, save ``<name>.pkl`` in the working directory. Returns
    {name: metrics}."""
    resolve_device(device)   # fail before any work when CUDA is absent
    if split_scheme == "within_task":
        train_set, test_set = dataset.random_split_within_task(
            train_ratio, seed=seed)
    elif split_scheme == "by_task":
        train_set, test_set = dataset.random_split_by_task(
            train_ratio, seed=seed)
    elif split_scheme == "by_target":
        targets = sorted({t.target for t in dataset.tasks()})
        train_set, test_set = dataset.random_split_by_target(targets[:-1])
    else:
        raise ValueError(split_scheme)

    print(f"Train set: {len(train_set)} samples / "
          f"{len(train_set.tasks())} tasks")
    print(f"Test set:  {len(test_set)} samples / "
          f"{len(test_set.tasks())} tasks")

    specs = models.split(",")
    if len(specs) == 1 and "@" in models and \
            all(part in _KINDS for part in models.split("@")):
        # reference separator: --models mlp@xgb trains two models
        # (train_model.py:113); '@' otherwise selects the mlp loss
        specs = models.split("@")

    results = {}
    for name in specs:
        # reference default: models train with the workload embedding
        # appended per row (MLP 10 dims, tree models 9 raw tags)
        kind = name.split("@")[0]
        emb_dim = 10 if kind in ("mlp", "lstm", "mha", "tabnet") else 9
        feats, labels, _ = train_set.flatten(
            with_workload_embedding=use_workload_embedding,
            embed_total_dim=emb_dim,
        )
        in_dim = feats[0].shape[1] if feats else 164
        model = make_model(name, in_dim, device, seed)
        model.use_workload_embedding = use_workload_embedding
        model.workload_embed_total_dim = emb_dim
        if kind == "mlp":
            # crash-resume snapshot during training, the reference's
            # `tmp_mlp.pkl` contract (mlp_model.py:598)
            model.fit_base(feats, labels, verbose=verbose,
                           checkpoint_path="tmp_mlp.pkl")
        else:
            model.fit_base(feats, labels, verbose=verbose)
        eval_res = evaluate_model(model, test_set)
        print(f"===== {name} =====")
        # rank-loss scores are uncalibrated: absolute-error metrics on
        # them say nothing, so print n/a
        rank_scored = M.model_is_rank_scored(model)
        for k, v in eval_res.items():
            if rank_scored and k in M.CALIBRATION_METRIC_NAMES:
                print(f"{k}: n/a (rank loss {model.loss_type})")
            else:
                print(f"{k}: {v:.4f}")
        out = f"{name.replace('@', '_')}.pkl"
        model.save(out)
        print(f"saved -> {out}")
        results[name] = eval_res
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", nargs="+", type=str,
                   default=["dataset.pkl"])
    p.add_argument("--models", type=str, default="mlp")
    p.add_argument("--split-scheme", type=str, default="within_task",
                   choices=["within_task", "by_task", "by_target"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-ratio", type=float, default=0.9)
    p.add_argument("--no-workload-embedding", action="store_true",
                   help="train on raw per-store features without the "
                        "per-task workload tag embedding (reference "
                        "models default to embedding ON)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    dataset = Dataset()
    for path in args.dataset:
        with open(path, "rb") as f:
            dataset.update_from_dataset(pickle.load(f))
    return train_zero_shot(
        dataset, args.models, args.split_scheme, args.seed, args.verbose,
        train_ratio=args.train_ratio,
        use_workload_embedding=not args.no_workload_embedding,
        device=args.device)


if __name__ == "__main__":
    main()
