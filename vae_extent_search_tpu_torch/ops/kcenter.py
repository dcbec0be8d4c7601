"""k-center greedy (farthest-first) selection over a gathered candidate
pool (counterpart of ``k_center_greedy_pool_core`` in
``vae_extent_search_tpu/ops/kcenter.py``), in plain torch.

Only pool members are selectable, so distances matter only from the
[P, D] pool to the gathered centers: one [P, C] matmul, then k steps of
[P]-sized updates. Squared distances throughout: every consumer (greedy
argmax, running min) is monotonic in the distance.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _sq_dist_block(a: torch.Tensor, b: torch.Tensor,
                   b_valid: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [n, m] via the matmul identity, with
    invalid columns masked to +inf."""
    sq = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
          - 2.0 * a @ b.T)
    return torch.where(b_valid[None, :], torch.clamp(sq, min=0.0),
                       float("inf"))


def k_center_greedy_pool_core(z_pool: torch.Tensor, avail: torch.Tensor,
                              centers: torch.Tensor, c_valid: torch.Tensor,
                              k: int):
    """Greedy farthest-first picks from the pool ``z_pool`` [P, D] where
    ``avail``, against ``centers`` [C, D] where ``c_valid``. Returns
    (local indices into the pool [k], valid [k]); once no available row
    is left, the remaining picks are row 0, flagged invalid.

    ``score`` is the running minimum squared distance of each available
    row and -1e30 elsewhere; a pick sets its own row to -1e30 (distances
    are clamped at 0, so the running minimum never lifts a taken row). No
    value is read on the host: each pick stays a 0-d device tensor, so on
    CUDA the whole loop queues behind the stream's earlier work. Ties go
    to the lowest index, as jnp.argmax: torch.max over a dim returns the
    first maximum."""
    min_sq = _sq_dist_block(z_pool, centers, c_valid).min(dim=1).values
    score = torch.where(avail, min_sq, NEG_INF)
    best, picks = [], []
    for _ in range(k):
        s_j, j = torch.max(score, dim=0)
        best.append(s_j)
        picks.append(j)
        j = j.view(1)
        d_new = torch.clamp(
            ((z_pool - z_pool.index_select(0, j)) ** 2).sum(-1), min=0.0)
        score = torch.minimum(score, d_new).index_fill_(0, j, NEG_INF)
    return torch.stack(picks), torch.stack(best) > NEG_INF / 2
