"""The picking stages of one selection phase, as the experiment describes
them, in numpy: the candidate pool (the num_select * topk_factor highest
predicted costs among the remaining rows), then from it the n_cost
highest costs, the grad_num largest gradient norms, the n_unc largest MC
variances (over all remaining rows instead while the measured set is
smaller than uncertainty_topk), and n_div by k-center greedy on the
L2-normalised latents against the measured set and the picks so far.

Every top-k takes the highest scores and, among equal scores, the
earliest entry: the lowest row index over all rows, the earliest pool
position inside the pool.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class Budget(NamedTuple):
    n_cost: int
    grad: int
    n_unc: int
    n_div: int
    rand: int
    k_pool: int
    unc_topk: int


def budget(cfg: Dict) -> Budget:
    """The stage sizes of a configuration's selection settings."""
    rest = cfg["num_select"] - cfg["grad_num"] - cfg["rand_num"]
    n_unc, n_div = int(rest * cfg["w_unc"]), int(rest * cfg["w_div"])
    n_cost = rest - n_unc - n_div
    return Budget(n_cost, cfg["grad_num"], n_unc, n_div, cfg["rand_num"],
                  cfg["num_select"] * cfg["topk_factor"],
                  cfg["uncertainty_topk"])


def top_k(scores: np.ndarray, mask: np.ndarray, k: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(positions [k], valid [k]) of the k highest ``scores`` where
    ``mask``, earliest position first among ties; padded with (0, False)."""
    cand = np.flatnonzero(mask)
    order = cand[np.lexsort((cand, -scores[cand].astype(np.float64)))][:k]
    idx = np.zeros(k, np.int64)
    valid = np.zeros(k, bool)
    idx[:len(order)] = order
    valid[:len(order)] = True
    return idx, valid


class Replay(NamedTuple):
    parts: List[Tuple[np.ndarray, np.ndarray]]  # cost, grad, unc picks
    pool: np.ndarray          # [k_pool] row indices
    avail: np.ndarray         # [k_pool] bool, left for k-center


def replay(cost, gnorm, mc_var, remaining, b: Budget, gated: bool
           ) -> Replay:
    """The cost, gradient and uncertainty picks of a phase from its
    scores ([N] each) and the remaining rows ([N] bool)."""
    pool, avail = top_k(cost, remaining, b.k_pool)
    picked = np.zeros(len(cost), bool)
    parts = []

    def from_pool(scores, k):
        li, lv = top_k(scores[pool], avail, k)
        avail[li[lv]] = False
        return pool[li], lv

    for k, scores in ((b.n_cost, cost), (b.grad, gnorm)):
        idx, valid = from_pool(scores, k)
        picked[idx[valid]] = True
        parts.append((idx, valid))
    if gated:
        idx, valid = top_k(mc_var, remaining & ~picked, b.n_unc)
        picked[idx[valid]] = True
        avail &= ~picked[pool]
    else:
        idx, valid = from_pool(mc_var, b.n_unc)
    parts.append((idx, valid))
    return Replay(parts, pool, avail)


def _nearest_sq(z_pool: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Each pool row's squared distance to its nearest center."""
    if not len(centers):
        return np.full(len(z_pool), np.inf)
    return ((z_pool[:, None, :] - centers[None, :, :]) ** 2).sum(-1).min(1)


def kcenter_gaps(z_pool: np.ndarray, avail: np.ndarray,
                 centers: np.ndarray, picks: np.ndarray,
                 picks_valid: np.ndarray) -> np.ndarray:
    """For each k-center pick, in order, how far its squared distance to
    the nearest center lies below the farthest available pool row's, as
    a share of the latter (0: a farthest row). ``z_pool`` [P, L] and
    ``centers`` [C, L] are normalised latents; ``picks`` are row indices
    into the pool's positions (-1: not a pool row still available), each
    becoming a center after its step. A pick that is not available, or
    invalid while a row was available, reads 1."""
    avail = avail.copy()
    min_sq = _nearest_sq(z_pool, centers)
    gaps = []
    for j, ok in zip(picks, picks_valid):
        if not avail.any():
            gaps.append(0.0 if not ok else 1.0)
            continue
        best = float(min_sq[avail].max())
        if not ok or j < 0 or not avail[j]:
            gaps.append(1.0)
            continue
        gaps.append(0.0 if best <= 0 else (best - float(min_sq[j])) / best)
        avail[j] = False
        min_sq = np.minimum(min_sq, ((z_pool - z_pool[j]) ** 2).sum(-1))
    return np.asarray(gaps)


def kcenter_greedy(z_pool: np.ndarray, avail: np.ndarray,
                   centers: np.ndarray, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(pool positions [k], valid [k]) of k greedy farthest-first picks
    among the available pool rows, the earliest position among ties."""
    avail = avail.copy()
    min_sq = _nearest_sq(z_pool, centers)
    idx = np.zeros(k, np.int64)
    valid = np.zeros(k, bool)
    for i in range(k):
        if not avail.any():
            break
        j = int(np.argmax(np.where(avail, min_sq, -np.inf)))
        idx[i], valid[i] = j, True
        avail[j] = False
        min_sq = np.minimum(min_sq, ((z_pool - z_pool[j]) ** 2).sum(-1))
    return idx, valid
