"""Ranking/regression metrics for cost models.

Parity: python/tvm/auto_scheduler/cost_model/metric.py (RMSE, R2, pairwise
comparison accuracy, top-k recall, peak score@k, MAPE) plus the experiment's
pair_accuracy / recall_at_k (vae_extent_search.py:812-837).
"""

from __future__ import annotations

import numpy as np

# Losses whose raw scores carry ranking information only: they are not
# calibrated to the throughput scale, so RMSE/R^2/MAPE computed on them
# are meaningless (e.g. R^2 of -1e5 on a healthy lambdaRank model).
# Evaluation sites print "n/a (rank loss)" for these metrics instead.
RANK_LOSSES = frozenset({"rankNet", "lambdaRank", "listNet"})
CALIBRATION_METRIC_NAMES = frozenset({"RMSE", "R^2", "mape"})


def model_is_rank_scored(model) -> bool:
    """True when the model's predictions are uncalibrated rank scores
    (trained with one of RANK_LOSSES)."""
    return getattr(model, "loss_type", None) in RANK_LOSSES


def metric_rmse(preds, labels) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    return float(np.sqrt(np.mean((preds - labels) ** 2)))


def metric_r_squared(preds, labels) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    ss_tot = np.sum((labels - labels.mean()) ** 2)
    ss_res = np.sum((labels - preds) ** 2)
    if ss_tot < 1e-12:
        return 1.0
    return float(1 - ss_res / ss_tot)


def metric_pairwise_comp_accuracy(preds, labels) -> float:
    """Upper-triangle XOR trick (reference metric.py:32-40)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    n = len(preds)
    if n < 2:
        return 1.0
    pred_rel = preds[:, None] > preds[None, :]
    label_rel = labels[:, None] > labels[None, :]
    mask = np.triu(np.ones((n, n), bool), k=1)
    agree = ~(pred_rel ^ label_rel)
    return float(agree[mask].mean())


def metric_top_k_recall(preds, labels, top_k: int) -> float:
    """How many of the true top-k are in the predicted top-k
    (reference metric.py:43-48)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    real_top_k = set(np.argsort(-labels)[:top_k].tolist())
    pred_top_k = set(np.argsort(-preds)[:top_k].tolist())
    return float(len(real_top_k & pred_top_k) / top_k)


def metric_peak_score(preds, labels, top_k: int) -> float:
    """Mean running max of true labels of the predicted top-k, normalized by
    the global best (reference metric.py:51-56)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    trials = np.argsort(-preds)[:top_k]
    trial_scores = labels[trials]
    curve = np.maximum.accumulate(trial_scores) / np.max(labels)
    return float(np.mean(curve))


def metric_mape(preds, labels) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    nz = np.abs(labels) > 1e-12
    if not nz.any():
        return 0.0
    return float(np.mean(np.abs((labels[nz] - preds[nz]) / labels[nz])))


def pair_accuracy(preds, labels, n_samples: int = 1000, seed: int = 42) -> float:
    """Sampled pairwise accuracy (vae_extent_search.py:812-831)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    rng = np.random.default_rng(seed)
    n = min(n_samples, len(preds))
    idx = rng.choice(len(preds), n, replace=False)
    p, l = preds[idx], labels[idx]
    pd = p[:, None] - p[None, :]
    ld = l[:, None] - l[None, :]
    mask = np.triu(np.ones((n, n), bool), k=1)
    return float(((pd * ld) > 0)[mask].mean()) if n > 1 else 0.0


def recall_at_k(preds, labels, k: int = 1) -> int:
    """1 if the true argmax is inside the predicted top-k
    (vae_extent_search.py:833-837)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    true_best = int(np.argmax(labels))
    topk = np.argsort(-preds)[:k]
    return int(true_best in set(topk.tolist()))


def random_mix(values, randomness: float):
    """Blend predictions with uniform noise spanning the value range
    (reference cost_model/metric.py random_mix) — used to study model
    quality vs search outcome sensitivity."""
    values = np.asarray(values)
    random_values = np.random.uniform(
        np.min(values), np.max(values), len(values)
    )
    return randomness * random_values + (1 - randomness) * values
