"""One selection phase over a candidate pool whose rows are split over the
ranks of a mesh's "data" axis (counterpart of
``vae_extent_search_tpu/search/select_sharded.py``).

- the fused-head kernel (``ops/fused_head.py``; on the CPU its plain
  version with injected bits), or the unfused torch scoring, runs on each
  rank's own rows only;
- every full-N reduction is a top-k on each rank's rows, an
  ``all_gather`` of the [S, k] (value, global index) winners and a stable
  merge by (-value, global index), which keeps ``masked_top_k``'s
  lowest-index-first ties; the collective moves O(S * k) numbers, never
  O(N);
- pool-local stages (strategies 3-6) run replicated on every rank: they
  work on the few hundred gathered pool rows;
- k-center's centers are gathered per rank and merged by global index,
  which reproduces the single-device ``first_k_true`` compaction.

The merges are plain functions over a list of per-rank results
(:func:`merge_top_k`, :func:`merge_gathered_rows`,
:func:`merge_masked_rows`), so they are tested without a process group.

Every tensor argument that has a candidate axis is this rank's row block
(``parallel/mesh.py::shard_batch``); indices are global. With injected
dropout bits each row sees the same bits whatever the split, so a sharded
phase picks exactly what the single-device ``select_programs`` picks.
With the kernel's own Philox bits, each rank seeds ``seed + rank * 2^20``
(the JAX design), so the MC variances differ from one device's by sampling
noise, as re-seeding would.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import torch

from ..convert import tree_map
from ..models.predictor import mc_predict, pred_encode, predict_cost
from ..ops.fused_head import fused_head_stats
from ..ops.kcenter import k_center_greedy_pool_core
from ..ops.kernel_library import tuned_fused_head_config
from ..parallel.mesh import Mesh, all_gather, all_reduce
from .select import (
    NEG_INF,
    SelectionConfig,
    _use_fused_head,
    first_k_true,
    l2_normalize,
    masked_top_k,
    scatter_set,
    scatter_unset,
    z_grad_norms,
)

_BIG = 2 ** 62   # the global index of an empty slot (sorts last)


# ---------------------------------------------------------------------------
# per-rank parts and their merges
# ---------------------------------------------------------------------------


def local_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int,
                base: int):
    """(values [kk], global indices [kk]) of this rank's top
    kk = min(k, rows) masked scores (-1e30 where masked out), lowest index
    first on ties; ``base`` is the rank's first global row."""
    kk = min(k, scores.shape[0])
    masked = torch.where(mask, scores.float(),
                         torch.tensor(NEG_INF, device=scores.device))
    vals, idx = torch.sort(masked, descending=True, stable=True)
    return vals[:kk], idx[:kk] + base


def merge_top_k(vals: Sequence[torch.Tensor], gidx: Sequence[torch.Tensor],
                k: int):
    """(indices [k], valid [k]) from the ranks' ``local_top_k`` results:
    the k largest values, ties to the lower global index (the JAX
    ``lexsort((index, -value))``); padded invalid past the candidates."""
    v = torch.cat(list(vals))
    i = torch.cat(list(gidx))
    by_i = torch.sort(i, stable=True).indices
    order = by_i[torch.sort(v[by_i], descending=True, stable=True).indices]
    mk = min(k, v.shape[0])
    idx, val = i[order[:mk]], v[order[:mk]]
    valid = val > NEG_INF / 2
    if mk < k:
        idx = torch.cat([idx, idx.new_zeros(k - mk)])
        valid = torch.cat([valid, valid.new_zeros(k - mk)])
    return idx, valid


def local_rows(x: torch.Tensor, idx: torch.Tensor, base: int):
    """[k, ...]: the rows of global indices ``idx`` that this rank holds
    (its block starts at ``base``), zero elsewhere."""
    n = x.shape[0]
    loc = idx - base
    ok = (loc >= 0) & (loc < n)
    rows = x[loc.clamp(0, n - 1)]
    return torch.where(ok.view(-1, *([1] * (x.dim() - 1))), rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def merge_gathered_rows(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ranks' ``local_rows`` summed: each row is one rank's, the others
    add zeros."""
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def local_masked_rows(z: torch.Tensor, mask: torch.Tensor, max_rows: int,
                      base: int):
    """(rows [m, D], global indices [m]) of this rank's first
    m = min(max_rows, rows) rows where ``mask``, empty slots zero with
    index 2^62."""
    n = z.shape[0]
    m = min(max_rows, n)
    li = first_k_true(mask, m, fill=n)
    valid = li < n
    rows = torch.where(valid[:, None], z[li.clamp(0, n - 1)],
                       torch.zeros((), dtype=z.dtype, device=z.device))
    gi = torch.where(valid, li + base, torch.full_like(li, _BIG))
    return rows, gi


def merge_masked_rows(rows: Sequence[torch.Tensor],
                      gidx: Sequence[torch.Tensor], max_rows: int):
    """(rows [max_rows, D], valid [max_rows]): the first ``max_rows``
    masked rows in global index order, padded invalid."""
    r = torch.cat(list(rows))
    i = torch.cat(list(gidx))
    order = torch.sort(i, stable=True).indices[:max_rows]
    out, valid = r[order], i[order] < _BIG
    if out.shape[0] < max_rows:
        pad = max_rows - out.shape[0]
        out = torch.cat([out, out.new_zeros(pad, *out.shape[1:])])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return out, valid


# ---------------------------------------------------------------------------
# the collectives over a mesh axis
# ---------------------------------------------------------------------------


def _base(x: torch.Tensor, mesh: Mesh, axis: str) -> int:
    return mesh.index(axis) * x.shape[0]


def masked_top_k_sharded(scores: torch.Tensor, mask: torch.Tensor, k: int,
                         mesh: Mesh, axis: str = "data"):
    """Global masked top-k of a row-sharded score vector: replicated
    (indices [k], valid [k]) equal to ``masked_top_k`` on the whole
    vector, ties included."""
    vals, gi = local_top_k(scores, mask, k, _base(scores, mesh, axis))
    v_all = all_gather(vals, mesh, axis)
    i_all = all_gather(gi, mesh, axis)
    return merge_top_k(v_all.unbind(0), i_all.unbind(0), k)


def gather_rows_sharded(x: torch.Tensor, idx: torch.Tensor, mesh: Mesh,
                        axis: str = "data") -> torch.Tensor:
    """Replicated ``x[idx]`` of a row-sharded x and replicated global
    indices: each rank fills the rows it owns, then one ``all_reduce``
    sums the [k, ...] buffers (a row plus zeros: exact in any dtype)."""
    return all_reduce(local_rows(x, idx, _base(x, mesh, axis)), mesh, axis)


def gather_masked_rows_sharded(z: torch.Tensor, mask: torch.Tensor,
                               max_rows: int, mesh: Mesh,
                               axis: str = "data"):
    """Replicated (rows [max_rows, D], valid [max_rows]): the first
    ``max_rows`` rows of a row-sharded z where ``mask``, in global index
    order (``first_k_true`` + gather on one device)."""
    rows, gi = local_masked_rows(z, mask, max_rows, _base(z, mesh, axis))
    r_all = all_gather(rows, mesh, axis)
    i_all = all_gather(gi, mesh, axis)
    return merge_masked_rows(r_all.unbind(0), i_all.unbind(0), max_rows)


def _set_local(mask: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
               base: int) -> torch.Tensor:
    """``scatter_set`` on a row block: mask[idx - base] = True for the
    valid global indices this rank holds."""
    n = mask.shape[0]
    loc = idx - base
    ok = valid & (loc >= 0) & (loc < n)
    return scatter_set(mask, loc.clamp(0, n - 1), ok)


def _hit(pool_idx: torch.Tensor, picks) -> torch.Tensor:
    """[k_pool] bool: pool entries among the valid picks."""
    hit = torch.zeros_like(pool_idx, dtype=torch.bool)
    for idx, valid in picks:
        if idx.numel():
            hit |= ((pool_idx[:, None] == idx[None, :])
                    & valid[None, :]).any(1)
    return hit


# ---------------------------------------------------------------------------
# scoring on each rank's rows
# ---------------------------------------------------------------------------


def _fused_scores_sharded(params: Dict, X: torch.Tensor, seed: int,
                          cfg: SelectionConfig, mesh: Mesh, axis: str,
                          mask_bits=None):
    """The fused head on this rank's rows: seed ``seed + rank * 2^20``;
    the kernel library's group count at the LOCAL shape; injected
    ``mask_bits`` [T, N, H] (global; sliced to this rank's rows) or
    already [T, local rows, H]."""
    n_loc = X.shape[0]
    h_dim, l_dim = params["fc_mu"]["w"].shape
    groups = tuned_fused_head_config(n_loc, X.shape[1], h_dim, l_dim,
                                     cfg.T_mc, dtype=cfg.compute_dtype)
    i = mesh.index(axis)
    if mask_bits is not None and mesh.shape[axis] > 1 \
            and mask_bits.shape[1] == n_loc * mesh.shape[axis]:
        mask_bits = mask_bits[:, i * n_loc:(i + 1) * n_loc].contiguous()
    cost, gnorm, _, mc_var = fused_head_stats(
        params["cost_predictor"], X, seed + i * (1 << 20), T=cfg.T_mc,
        rate=cfg.dropout_rate, mask_bits=mask_bits,
        encoder=(params["encoder"], params["fc_mu"]), groups=groups)
    return cost, gnorm, mc_var


def rank_generator(gen: torch.Generator, rank: int) -> torch.Generator:
    """A generator of this rank's own, derived from the replicated
    ``gen``'s state without drawing from it."""
    state = gen.get_state().cpu().numpy().tobytes()
    h = hashlib.sha256(state + rank.to_bytes(4, "little")).digest()
    return torch.Generator(device=gen.device).manual_seed(
        int.from_bytes(h[:8], "little") >> 1)


def _unfused_scores_sharded(params: Dict, X: torch.Tensor, gen,
                            cfg: SelectionConfig, mesh: Mesh, axis: str):
    """The unfused torch scoring on this rank's rows; the MC dropout
    masks come from the rank's own stream (``rank_generator``)."""
    mu, _ = pred_encode(params, X)
    cost = predict_cost(params, mu).float()
    gnorm = z_grad_norms(params, mu).float()
    _, mc_var = mc_predict(params, X, rank_generator(gen, mesh.index(axis)),
                           cfg.T_mc, cfg.dropout_rate, mu=mu)
    return cost, gnorm, mc_var.float(), mu.float()


# ---------------------------------------------------------------------------
# the phase
# ---------------------------------------------------------------------------


def select_programs_sharded(params: Dict, X: torch.Tensor,
                            used_mask: torch.Tensor,
                            remaining_mask: torch.Tensor,
                            gen: torch.Generator, cfg: SelectionConfig,
                            mesh: Mesh, axis: str = "data",
                            gate_uncertainty_to_remaining: bool = False,
                            mask_bits=None, center_idx=None,
                            center_valid=None):
    """One selection phase over a row-sharded pool: ``select_programs``'
    seven stages and return contract, with ``X``, ``used_mask``,
    ``remaining_mask``, the returned new remaining mask and the ``aux``
    scores as this rank's row blocks, and the selected (global) indices
    replicated. Every block has the same number of rows (callers pad).
    ``gen`` is replicated: it draws the kernel's seed and the random
    stage's noise over the global N, so every rank picks the same."""
    n_loc = X.shape[0]
    n = n_loc * mesh.shape[axis]
    base = mesh.index(axis) * n_loc
    dev = X.device
    if cfg.compute_dtype != "float32":
        ct = getattr(torch, cfg.compute_dtype)
        params = tree_map(
            lambda a: a.to(ct) if a.dtype == torch.float32 else a, params)
        X = X.to(ct).contiguous()
    mu = None
    if _use_fused_head(params, X, cfg, mask_bits):
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                 device=gen.device))
        cost_pred, gnorm, mc_var = _fused_scores_sharded(
            params, X, seed, cfg, mesh, axis, mask_bits)
    else:
        cost_pred, gnorm, mc_var, mu = _unfused_scores_sharded(
            params, X, gen, cfg, mesh, axis)

    k_pool = cfg.num_select * cfg.topk_factor

    # 2. candidate pool (merged full-N top-k) and its replicated scores
    pool_idx, pool_valid = masked_top_k_sharded(cost_pred, remaining_mask,
                                                k_pool, mesh, axis)
    avail = pool_valid
    pooled = gather_rows_sharded(torch.stack([cost_pred, gnorm, mc_var], 1),
                                 pool_idx, mesh, axis)
    cost_p, gnorm_p, mcvar_p = pooled[:, 0], pooled[:, 1], pooled[:, 2]

    picked = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    none = (torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev))

    def pick_local(scores_p, avail, k):
        li, lv = masked_top_k(scores_p, avail, k)
        return pool_idx[li], lv, scatter_unset(avail, li, lv)

    # 3. predicted-cost top-k
    ci, cv, avail = pick_local(cost_p, avail, cfg.n_cost)
    picked = _set_local(picked, ci, cv, base)

    # 4. z-grad top-k
    if cfg.grad_num:
        gi, gv, avail = pick_local(gnorm_p, avail, cfg.grad_num)
        picked = _set_local(picked, gi, gv, base)
    else:
        gi, gv = none

    # 5. uncertainty top-k
    if not cfg.n_unc:
        ui, uv = none
    elif gate_uncertainty_to_remaining:
        ui, uv = masked_top_k_sharded(mc_var, remaining_mask & ~picked,
                                      cfg.n_unc, mesh, axis)
        picked = _set_local(picked, ui, uv, base)
        avail = avail & ~_hit(pool_idx, [(ci, cv), (gi, gv), (ui, uv)])
    else:
        ui, uv, avail = pick_local(mcvar_p, avail, cfg.n_unc)
        picked = _set_local(picked, ui, uv, base)

    # 6. latent diversity on the gathered pool and center rows: the fused
    # path re-encodes the gathered raw rows, the unfused one gathers its
    # latents (each the single-device path's numbers)
    if cfg.n_div:
        z = X if mu is None else mu
        zp = gather_rows_sharded(z, pool_idx, mesh, axis)
        if center_idx is not None:
            cidx = torch.cat([center_idx.to(torch.int64).to(dev), ci, gi, ui])
            c_valid = torch.cat([center_valid.to(dev), cv, gv, uv])
            zc = gather_rows_sharded(z, cidx, mesh, axis)
        else:
            zc, c_valid = gather_masked_rows_sharded(
                z, used_mask | picked, cfg.max_centers, mesh, axis)
        if mu is None:
            zp, _ = pred_encode(params, zp)
            zc, _ = pred_encode(params, zc)
        dl, dv = k_center_greedy_pool_core(
            l2_normalize(zp.float()), avail, l2_normalize(zc.float()),
            c_valid, cfg.n_div)
        di = pool_idx[dl]
    else:
        di, dv = none
    picked = _set_local(picked, di, dv, base)

    # 7. eps-greedy random: the global noise from the replicated stream
    # (``random_select``'s draw), this rank's rows of it, merged top-k
    if cfg.rand_num:
        noise = torch.rand(n, generator=gen, device=gen.device)
        noise = noise[base:base + n_loc].to(dev)
        ri, rv = masked_top_k_sharded(noise, remaining_mask & ~picked,
                                      cfg.rand_num, mesh, axis)
        picked = _set_local(picked, ri, rv, base)
    else:
        ri, rv = none

    parts = [(ci, cv), (gi, gv), (ui, uv), (di, dv), (ri, rv)]
    sel_idx = torch.cat([p[0] for p in parts])
    sel_valid = torch.cat([p[1] for p in parts])
    new_remaining = remaining_mask & ~picked
    aux = {"cost_pred": cost_pred, "mc_var": mc_var, "grad_norm": gnorm}
    return sel_idx, sel_valid, new_remaining, aux

