"""k-center greedy (farthest-first) selection over a gathered candidate
pool (counterpart of ``k_center_greedy_pool_core`` in
``vae_extent_search_tpu/ops/kcenter.py``), in plain torch.

Only pool members are selectable, so distances matter only from the
[P, D] pool to the gathered centers: one [P, C] matmul, then k steps of
[P]-sized updates. Squared distances throughout: every consumer (greedy
argmax, running min) is monotonic in the distance.
"""

from __future__ import annotations

import contextlib

import torch

NEG_INF = -1e30


def _sq_dist_block(a: torch.Tensor, b: torch.Tensor,
                   b_valid: torch.Tensor,
                   sync=contextlib.nullcontext) -> torch.Tensor:
    """Squared euclidean distances [n, m] via the matmul identity, with
    invalid columns masked to +inf."""
    sq = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
          - 2.0 * a @ b.T)
    with sync():
        inf = torch.tensor(float("inf"), dtype=sq.dtype, device=sq.device)
    return torch.where(b_valid[None, :], torch.clamp(sq, min=0.0), inf)


def k_center_greedy_pool_core(z_pool: torch.Tensor, avail: torch.Tensor,
                              centers: torch.Tensor, c_valid: torch.Tensor,
                              k: int, sync=contextlib.nullcontext):
    """Greedy farthest-first picks from the pool ``z_pool`` [P, D] where
    ``avail``, against ``centers`` [C, D] where ``c_valid``. Returns
    (local indices into the pool [k], valid [k]).

    Each step indexes with the 0-d device tensor ``j``, which PyTorch
    reads on the host: on CUDA each such index, and each host scalar
    copied to the device, waits for the card. ``sync()`` gives the
    context each of them runs in (``select_programs`` counts and marks
    them). Ties go to the lowest index, as jnp.argmax: torch.argmax
    returns the first maximum."""
    min_sq = _sq_dist_block(z_pool, centers, c_valid,
                            sync).min(dim=1).values
    avail = avail.clone()
    sel = torch.zeros(k, dtype=torch.int64, device=z_pool.device)
    val = torch.zeros(k, dtype=torch.bool, device=z_pool.device)
    with sync():
        neg = torch.tensor(NEG_INF, dtype=min_sq.dtype, device=min_sq.device)
    for i in range(k):
        score = torch.where(avail, min_sq, neg)
        j = torch.argmax(score)
        sel[i] = j
        with sync():
            score_j = score[j]
        val[i] = score_j > NEG_INF / 2
        # ``avail[j] = False`` as the two syncs it makes: the index's read
        # and the copy of the host's False to the device
        with sync():
            j_host = int(j)
        with sync():
            avail[j_host] = False
        with sync():
            z_j = z_pool[j]
        d_new = torch.clamp(((z_pool - z_j) ** 2).sum(-1), min=0.0)
        min_sq = torch.minimum(min_sq, d_new)
    return sel, val
