"""Few-shot adaptation of a pretrained cost model to an unseen target
(counterpart of ``scripts/few_shot_eval.py``).

Parity: reference scripts/few_shot_eval.py, the protocols of the
reference's mlp_model.py:422-510 (local_only_mix_task, fine_tune_mix_task,
plus_mix_task) at corpus scale: a base model pretrained on other
platforms adapts on K records per task of the held-out one and is scored
on the task's other records. Per task, a seeded permutation takes the
first K records as the adaptation set and the rest as the evaluation set.
Modes:
  zero      — the base model unchanged (the by_target baseline)
  local     — a fresh model of the base's family trained on the K
              records alone
  fine_tune — a copy of the base warm-started from its parameters and
              refit on the K records (MLP family only)
  plus      — the frozen base plus a residual model fit on
              (label - base prediction), one per task
Each mode reports the pairwise accuracy, peak@1 and peak@5 over tasks,
weighted by evaluation size.

    python -m vae_extent_search_tpu_torch.cli.few_shot_eval \\
        --base mlp.pkl --dataset held_out.pkl --k 48 480

As in the JAX script, ``fine_tune`` on a GBDT or LGB base raises (tree
models have no ``params`` to warm-start) and the CSV is written only
once every mode has run, so such a run loses the modes before it: give
such a base ``--modes zero local plus``. The fine-tuned copy trains on
clones of the base's tensors (``MLPModelInternal._fit``), so the base is
left as it was. Runs on CUDA by default (the MLP's segment sums through
the kernels); ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import csv
import json
import os
import pickle
import time
from collections import defaultdict

import numpy as np

from ..data.dataset import Dataset
from ..models import load_model_pickle
from ..models import metrics as M
from ..models.embedding import embed_for_model


def _predict(model, feats, workload_key):
    emb = embed_for_model(model, feats, workload_key)
    preds = model.predict_on_features(emb)
    return np.where(np.isfinite(preds), preds, 0.0)


def _fresh_like(base, in_dim: int):
    """A fresh untrained model of the base's family and contract, on the
    base's device."""
    from ..models.gbdt import GBDTModelInternal, LGBModelInternal
    from ..models.segment import MLPModelInternal

    device = getattr(base, "device", "cuda")
    if isinstance(base, MLPModelInternal):
        m = MLPModelInternal(in_dim=base.in_dim, hidden_dim=128,
                             loss_type="rmse", n_epoch=60, device=device)
    elif isinstance(base, LGBModelInternal):
        m = LGBModelInternal(device=device)
    elif isinstance(base, GBDTModelInternal):
        m = GBDTModelInternal(backend=getattr(base, "backend", "auto"),
                              device=device)
    else:
        m = copy.copy(base)
    m.use_workload_embedding = getattr(base, "use_workload_embedding",
                                       False)
    m.workload_embed_total_dim = getattr(base, "workload_embed_total_dim",
                                         10)
    return m


def adapt_and_eval(base, task, feats, labels, k: int, mode: str,
                   rng: np.random.Generator, fine_tune_epochs: int = 30):
    n = len(feats)
    perm = rng.permutation(n)
    adapt_idx, eval_idx = perm[:k], perm[k:]
    fa = [feats[i] for i in adapt_idx]
    la = labels[adapt_idx].astype(np.float32)
    fe = [feats[i] for i in eval_idx]
    le = labels[eval_idx]
    key = task.workload_key

    if mode == "zero":
        preds = _predict(base, fe, key)
    elif mode == "local":
        local = _fresh_like(base, in_dim=getattr(base, "in_dim", 174))
        local.fit_base(embed_for_model(local, fa, key), la)
        preds = local.predict_on_features(embed_for_model(local, fe, key))
    elif mode == "fine_tune":
        ft = copy.copy(base)
        ft.n_epoch = fine_tune_epochs
        ft.params = base.params
        ft.fea_norm_vec = base.fea_norm_vec
        ft.fit_base(embed_for_model(ft, fa, key), la, keep_norm=True)
        preds = ft.predict_on_features(embed_for_model(ft, fe, key))
    elif mode == "plus":
        residual = _fresh_like(base, in_dim=getattr(base, "in_dim", 174))
        base_a = _predict(base, fa, key)
        residual.fit_base(embed_for_model(residual, fa, key),
                          (la - base_a).astype(np.float32))
        pr = residual.predict_on_features(
            embed_for_model(residual, fe, key))
        preds = _predict(base, fe, key) + np.where(np.isfinite(pr), pr, 0.0)
    else:
        raise ValueError(mode)
    preds = np.where(np.isfinite(preds), preds, 0.0)
    return {
        "pairwise": M.metric_pairwise_comp_accuracy(preds, le),
        "peak@1": M.metric_peak_score(preds, le, 1),
        "peak@5": M.metric_peak_score(preds, le, 5),
        "n_eval": len(le),
    }


def main(argv=None):
    """The command line; returns the rows it printed (and wrote)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", type=str, required=True,
                   help="pretrained model pickle (the N-1-platform base)")
    p.add_argument("--dataset", type=str, required=True,
                   help="held-out-platform dataset pickle")
    p.add_argument("--k", nargs="+", type=int, default=[48, 480])
    p.add_argument("--modes", nargs="+",
                   default=["zero", "local", "fine_tune", "plus"])
    p.add_argument("--max-tasks", type=int, default=64,
                   help="stratified task subsample (0 = all)")
    p.add_argument("--min-task-records", type=int, default=None,
                   help="default: max(k) + 20 (each K only uses tasks "
                        "with >= K + 20 records)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fine-tune-epochs", type=int, default=30)
    p.add_argument("--out-csv", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    base = load_model_pickle(args.base, device=args.device)
    if hasattr(base, "device"):
        base.device = args.device   # tree models pickle their own
    with open(args.dataset, "rb") as f:
        ds: Dataset = pickle.load(f)

    min_recs = args.min_task_records or (max(args.k) + 20)
    tasks = [t for t in ds.tasks()
             if len(ds.throughputs[t]) >= min_recs]
    rng = np.random.default_rng(args.seed)
    if args.max_tasks and len(tasks) > args.max_tasks:
        # stratify by workload family
        fams = defaultdict(list)
        for t in tasks:
            fams[json.loads(t.workload_key)[0]].append(t)
        alloc = {f: max(1, round(args.max_tasks * len(v) / len(tasks)))
                 for f, v in fams.items()}
        while sum(alloc.values()) > args.max_tasks:
            alloc[max(alloc, key=lambda f: alloc[f])] -= 1
        picked = []
        for f in sorted(fams):
            idx = rng.choice(len(fams[f]),
                             size=min(alloc[f], len(fams[f])),
                             replace=False)
            picked.extend(fams[f][i] for i in sorted(idx))
        tasks = picked
    print(f"{len(tasks)} tasks (>= {min_recs} records each), "
          f"K={args.k}, modes={args.modes}")

    rows = []
    for mode in args.modes:
        ks = [0] if mode == "zero" else args.k
        for k in ks:
            t0 = time.time()
            per_task = []
            weights = []
            task_rng = np.random.default_rng(args.seed + 1)
            kk = k or args.k[0]
            for t in tasks:
                labels = np.asarray(ds.throughputs[t])
                if len(labels) < kk + 20:
                    continue  # this K needs more records than the task has
                feats = [np.asarray(f, np.float32)
                         for f in ds.features[t]]
                r = adapt_and_eval(base, t, feats, labels,
                                   kk, mode, task_rng,
                                   args.fine_tune_epochs)
                per_task.append(r)
                weights.append(r["n_eval"])
            if not per_task:
                print(f"mode={mode} k={k}: no eligible tasks, skipped")
                continue
            w = np.asarray(weights, np.float64)
            w /= w.sum()
            agg = {m: float(sum(r[m] * wi for r, wi in zip(per_task, w)))
                   for m in ("pairwise", "peak@1", "peak@5")}
            row = {"mode": mode, "k": k, **{m: round(agg[m], 4)
                                            for m in agg},
                   "n_tasks": len(per_task),
                   "wall_s": round(time.time() - t0, 1)}
            rows.append(row)
            print(row, flush=True)

    if args.out_csv:
        os.makedirs(os.path.dirname(args.out_csv) or ".", exist_ok=True)
        with open(args.out_csv, "w", newline="") as f:
            wtr = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            wtr.writeheader()
            wtr.writerows(rows)
        print(f"-> {args.out_csv}")
    return rows


if __name__ == "__main__":
    main()
