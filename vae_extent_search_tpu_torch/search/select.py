"""Active-learning candidate selection, one phase on the device
(counterpart of ``vae_extent_search_tpu/search/select.py``).

Index sets are boolean masks over the candidate axis and every strategy
is a masked top-k or argmax: predicted-cost top-k, z-gradient-norm
top-k, MC-dropout-variance top-k, k-center-greedy latent diversity and
eps-greedy random, unioned. On a CUDA tensor the scoring block (encoder,
cost head, z-gradient norm, T MC-dropout passes) is one launch of the
fused-head kernel (``ops/fused_head.py``). ``farthest_point_init`` and
``kmeans_representative_init`` pick the search's initial set instead of
a random draw (plain torch: the JAX package runs them as XLA ops, not a
kernel).

Ties: ``jax.lax.top_k`` puts the lowest index first among equal scores,
while ``torch.topk`` promises no order. Every top-k here is a stable
descending sort, which keeps the lowest index first; the extent pools
hold duplicate rows whose scores tie exactly.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..convert import tree_map
from ..models.predictor import mc_predict, pred_encode, predict_cost
from ..ops.fused_head import fused_head_stats
from ..ops.kcenter import k_center_greedy_pool_core
from ..ops.kernel_library import tuned_fused_head_config
from ..utils.misc import span

NEG_INF = -1e30


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Indices of the k largest scores where mask (lowest index first on
    ties); masked-out entries score -1e30, a Python scalar in the same
    dtype, so nothing is copied from the host. Returns (indices [k], valid
    [k]); when k exceeds the pool size the tail is padded invalid."""
    n = scores.shape[0]
    kk = min(k, n)
    masked = torch.where(mask, scores, NEG_INF)
    vals, idx = torch.sort(masked, descending=True, stable=True)
    vals, idx = vals[:kk], idx[:kk]
    valid = vals > NEG_INF / 2
    if kk < k:
        idx = torch.cat([idx, idx.new_zeros(k - kk)])
        valid = torch.cat([valid, valid.new_zeros(k - kk)])
    return idx, valid


def _hits(n: int, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[n] bool: True at idx where valid (duplicates allowed, no sync)."""
    counts = torch.zeros(n, dtype=torch.int32, device=idx.device)
    counts.index_put_((idx,), valid.to(torch.int32), accumulate=True)
    return counts > 0


def scatter_unset(mask: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """mask[idx] = False where valid; returns a new mask."""
    return mask & ~_hits(mask.shape[0], idx, valid)


def scatter_set(mask: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """mask[idx] = True where valid; returns a new mask."""
    return mask | _hits(mask.shape[0], idx, valid)


def l2_normalize(z: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + eps)


def first_k_true(mask: torch.Tensor, k: int, fill: int = 0) -> torch.Tensor:
    """Indices of the first k set entries of ``mask`` in index order,
    padded with ``fill``. Each set entry is scattered to its rank among
    the set entries (a cumsum); the ranks past k and the unset entries go
    to one spare slot, dropped. The host reads no count, so on CUDA
    nothing waits for the card."""
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (rank < k), rank, k)
    out = torch.full((k + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:k]


def random_select(gen: torch.Generator, remaining_mask: torch.Tensor,
                  k: int):
    """eps-greedy random pick without replacement from the remaining set."""
    noise = torch.rand(remaining_mask.shape[0], generator=gen,
                       device=gen.device).to(remaining_mask.device)
    return masked_top_k(noise, remaining_mask, k)


def _sq_dist_to(z: torch.Tensor, j) -> torch.Tensor:
    """[N] squared distances from every row of z to row j."""
    return ((z - z[j]) ** 2).sum(-1)


def farthest_point_init(gen: torch.Generator, z: torch.Tensor,
                        remaining_mask: torch.Tensor, k: int, first=None):
    """Farthest-point-first init selection [k]: the first pick uniform
    over ``remaining_mask`` (or ``first``, injected), then greedily the
    remaining point farthest from every pick so far, on un-normalised
    squared distances. The min-distance vector is updated per pick, so no
    [N, N] matrix exists. Ties go to the lowest index (``torch.argmax``,
    like ``jnp.argmax``)."""
    if first is None:
        first = torch.multinomial(remaining_mask.float().to(gen.device), 1,
                                  generator=gen)[0].to(z.device)
    first = torch.as_tensor(first, device=z.device)
    sel = torch.zeros(k, dtype=torch.int64, device=z.device)
    sel[0] = first
    min_sq = _sq_dist_to(z, first)
    avail = remaining_mask.clone()
    avail[first] = False
    neg = torch.tensor(NEG_INF, dtype=min_sq.dtype, device=z.device)
    for i in range(1, k):
        j = torch.argmax(torch.where(avail, min_sq, neg))
        sel[i] = j
        avail[j] = False
        min_sq = torch.minimum(min_sq, _sq_dist_to(z, j))
    return sel


def kmeans_representative_init(gen: torch.Generator, z: torch.Tensor,
                               k: int, iters: int = 10, seed_idx=None):
    """k-means++ seeding, ``iters`` Lloyd steps, then per centre the
    nearest data point not yet taken: the representative init selection
    [k] of distinct indices. It clusters ALL points, not only the
    remaining ones.

    Seeding draws the first centre uniformly, then each next one with
    probability proportional to max(d^2, 1e-12), d^2 the squared distance
    to the nearest centre so far; ``seed_idx`` [k] injects the seeds.
    Lloyd distances use |z|^2 + |c|^2 - 2 z.c; an empty cluster keeps its
    centre. Each argmin takes the lowest index on ties."""
    n = z.shape[0]
    if seed_idx is None:
        cidx = torch.zeros(k, dtype=torch.int64, device=z.device)
        cidx[0] = torch.randint(0, n, (), generator=gen,
                                device=gen.device).to(z.device)
        dist = _sq_dist_to(z, cidx[0])
        for i in range(1, k):
            w = torch.clamp(dist, min=1e-12).to(gen.device)
            cidx[i] = torch.multinomial(w, 1, generator=gen)[0].to(z.device)
            dist = torch.minimum(dist, _sq_dist_to(z, cidx[i]))
    else:
        cidx = torch.as_tensor(seed_idx, dtype=torch.int64, device=z.device)
    centers = z[cidx]
    zz = (z * z).sum(-1)

    def sq_d(c):
        return zz[:, None] + (c * c).sum(-1)[None, :] - 2.0 * z @ c.T

    for _ in range(iters):
        assign = torch.argmin(sq_d(centers), dim=1)
        sums = torch.zeros_like(centers).index_add_(0, assign, z)
        cnts = torch.zeros(k, dtype=z.dtype, device=z.device).index_add_(
            0, assign, torch.ones_like(zz))[:, None]
        centers = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0),
                              centers)
    d = sq_d(centers)
    taken = torch.zeros(n, dtype=torch.bool, device=z.device)
    sel = torch.zeros(k, dtype=torch.int64, device=z.device)
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=z.device)
    for j in range(k):
        i = torch.argmin(torch.where(taken, inf, d[:, j]))
        taken[i] = True
        sel[j] = i
    return sel


def z_grad_norms(params: Dict, z: torch.Tensor) -> torch.Tensor:
    """||d cost / d z|| per candidate."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(predict_cost(params, zz).sum(), zz)
    return torch.linalg.vector_norm(grad, dim=-1)


class SelectionConfig(NamedTuple):
    num_select: int = 64
    w_cost: float = 0.5
    w_unc: float = 0.3
    w_div: float = 0.2
    grad_num: int = 2
    rand_num: int = 0
    T_mc: int = 10
    uncertainty_topk: int = 128
    topk_factor: int = 5
    dropout_rate: float = 0.1
    max_centers: int = 4096
    # compute dtype of the scoring forwards ("float32" | "bfloat16"); the
    # top-k / selection logic always runs in f32
    compute_dtype: str = "float32"
    # "off" forces the unfused torch scoring path (the reference the
    # kernel is compared with); any other value admits the fused head
    # where ``_use_fused_head`` does. The JAX config's ``fused_interpret``
    # has no counterpart: the port's CPU seam is ``mask_bits``
    fused_head: str = "auto"

    @property
    def budget(self) -> int:
        return self.num_select - self.grad_num - self.rand_num

    @property
    def n_cost(self) -> int:
        n_cost = int(self.budget * self.w_cost)
        n_unc = int(self.budget * self.w_unc)
        n_div = int(self.budget * self.w_div)
        return n_cost + (self.budget - (n_cost + n_unc + n_div))

    @property
    def n_unc(self) -> int:
        return int(self.budget * self.w_unc)

    @property
    def n_div(self) -> int:
        return int(self.budget * self.w_div)


def _use_fused_head(params: Dict, X: torch.Tensor, cfg: SelectionConfig,
                    mask_bits=None) -> bool:
    """Gate for the fused head: a CUDA tensor (or, on the CPU, injected
    ``mask_bits`` — the seam on which the kernel's plain version runs
    with the same bits as a reference), the 2-hidden-layer head over an
    encoder whose fc_mu feeds it, and an MC pass actually needed (T >= 2
    and an uncertainty budget; otherwise the unfused path skips it).
    ``cfg.fused_head == "off"`` refuses it before any other check."""
    if cfg.fused_head == "off":
        return False
    if not X.is_cuda and mask_bits is None:
        return False
    head = params.get("cost_predictor")
    if head is None or len(head) != 3:
        return False
    l, h = head[0]["w"].shape
    if h != head[1]["w"].shape[0]:
        return False
    enc = params.get("encoder")
    if enc is None or "fc_mu" not in params:
        return False
    if params["fc_mu"]["w"].shape != (enc[-1]["w"].shape[1], l):
        return False
    return cfg.T_mc >= 2 and cfg.n_unc > 0


def select_programs(params: Dict, X: torch.Tensor, used_mask: torch.Tensor,
                    remaining_mask: torch.Tensor, gen: torch.Generator,
                    cfg: SelectionConfig,
                    gate_uncertainty_to_remaining: bool = False,
                    mask_bits=None, center_idx=None, center_valid=None,
                    mesh=None):
    """One full selection phase.

    Flow:
      1. score all candidates: cost_pred = head(mu), z-grad norms, MC
         mean/variance (fused kernel, or the unfused torch path)
      2. candidate pool = top (num_select * topk_factor) predicted among
         remaining
      3. top n_cost by predicted cost from the pool
      4. top grad_num by |dcost/dz| from the pool
      5. top n_unc by MC-dropout variance (from the pool, or from all
         remaining while the measured set is small —
         ``gate_uncertainty_to_remaining``)
      6. n_div by k-center greedy on L2-normalized z, centers = measured +
         already-selected
      7. rand_num random from remaining
    Returns (selected_idx [num_select], valid [num_select],
             new_remaining_mask, aux dict).

    ``gen`` draws the kernel's dropout seed (or the unfused path's masks)
    and the random stage's noise. ``center_idx``/``center_valid`` ([C]
    int / bool): the compact measured-set buffer for the diversity stage;
    without it the center set is derived from ``used_mask``.

    With a ``mesh`` whose "data" axis holds more than one rank, the pool is
    split over those ranks: ``X``, the masks and ``aux`` are this rank's
    row blocks, and the phase runs on the sharded path
    (``search/select_sharded.py``: the fused head on each rank's rows,
    every full-N top-k merged across ranks).

    On one device the host waits for the card once, at the draw of the
    kernel's seed, before anything of the phase is queued; every later
    stage (the casts, the kernel, the top-ks, the k-center re-encode and
    loop, the scatters) is queued behind it without a read on the host,
    so on CUDA the function returns while the card still works and the
    caller's first read of the outputs waits for the phase. (A generator
    on another device than the data's would add a wait, at the copy of
    the random stage's noise; every caller keeps both on one device.)

    Under a running profiler the phase is the range "select_programs",
    and on one device its stages are ranges inside it: "select.prepare",
    "select.score", "select.pool_topk", "select.picks", "select.kcenter"
    and "select.random", with "select.sync" around each of those waits.
    ``select_programs.host_syncs`` counts them as they are passed,
    profiler or not, on one device (the sharded route's syncs are not
    counted).
    """
    with span("select_programs"):
        if mesh is not None and mesh.shape["data"] > 1:
            from .select_sharded import select_programs_sharded

            return select_programs_sharded(
                params, X, used_mask, remaining_mask, gen, cfg, mesh,
                gate_uncertainty_to_remaining=gate_uncertainty_to_remaining,
                mask_bits=mask_bits, center_idx=center_idx,
                center_valid=center_valid)
        return _select_one_device(params, X, used_mask, remaining_mask, gen,
                                  cfg, gate_uncertainty_to_remaining,
                                  mask_bits, center_idx, center_valid)


select_programs.host_syncs = 0


def _host_sync():
    """The context of one place in ``select_programs`` where the host
    waits for the card: counted, and a "select.sync" range."""
    select_programs.host_syncs += 1
    return span("select.sync")


def _select_one_device(params, X, used_mask, remaining_mask, gen, cfg,
                       gate_uncertainty_to_remaining, mask_bits, center_idx,
                       center_valid):
    # the phase's one host wait: the kernel's seed, the generator's first
    # draw, read before the casts are queued (the gate reads only shapes
    # and devices, which the casts keep)
    fused = _use_fused_head(params, X, cfg, mask_bits)
    if fused:
        with _host_sync():
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                     device=gen.device))
    ct = getattr(torch, cfg.compute_dtype)
    with span("select.prepare"):
        if ct != torch.float32:
            params = tree_map(
                lambda a: a.to(ct) if a.dtype == torch.float32 else a,
                params)
            # the fused head rounds X as it reads it (a chunk at a time
            # where it runs the first encoder layer as a GEMM), so X is
            # cast whole only for the unfused path
            if not fused:
                X = X.to(ct).contiguous()
        if fused:
            # the kernel's group count tuned for this shape on the card
            # (cli/tune_kernel_suite.py's fusedhead family), where the
            # process kernel library holds a record; launch_plan's G
            # otherwise. Keyed by the caller's D: the suite times the whole
            # fused_head_stats call at that D, so a bf16 record at a D
            # wider than the first encoder layer times the kernel on that
            # layer's output (split_first_layer) as this call runs it
            h_dim, l_dim = params["fc_mu"]["w"].shape
            groups = tuned_fused_head_config(
                X.shape[0], X.shape[1], h_dim, l_dim, cfg.T_mc,
                dtype=cfg.compute_dtype)
    mu = None
    if fused:
        with span("select.score"):
            cost_pred, gnorm, _, mc_var = fused_head_stats(
                params["cost_predictor"], X, seed, T=cfg.T_mc,
                rate=cfg.dropout_rate, mask_bits=mask_bits,
                encoder=(params["encoder"], params["fc_mu"]), groups=groups,
                dtype=ct)
    else:
        with span("select.score"):
            mu, _ = pred_encode(params, X)
            cost_pred = predict_cost(params, mu).float()
            gnorm = z_grad_norms(params, mu).float()
            # the encoder has no dropout: the T MC samples reuse mu
            _, mc_var = mc_predict(params, X, gen, cfg.T_mc,
                                   cfg.dropout_rate, mu=mu)
            mc_var = mc_var.float()
            mu = mu.float()

    n = X.shape[0]
    dev = X.device
    k_pool = cfg.num_select * cfg.topk_factor

    # 2. candidate pool — the one full-N top-k; stages 3-6 pick from it
    with span("select.pool_topk"):
        pool_idx, pool_valid = masked_top_k(cost_pred, remaining_mask,
                                            k_pool)
        avail = pool_valid
        cost_p, gnorm_p, mcvar_p = (cost_pred[pool_idx], gnorm[pool_idx],
                                    mc_var[pool_idx])

    picked = torch.zeros(n, dtype=torch.bool, device=dev)
    none = (torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev))

    def pick_local(scores_p, avail, k):
        """Pool-local masked top-k -> (global idx, valid, new avail)."""
        li, lv = masked_top_k(scores_p, avail, k)
        return pool_idx[li], lv, scatter_unset(avail, li, lv)

    with span("select.picks"):
        # 3. predicted-cost top-k
        ci, cv, avail = pick_local(cost_p, avail, cfg.n_cost)
        picked = scatter_set(picked, ci, cv)

        # 4. z-grad top-k
        if cfg.grad_num:
            gi, gv, avail = pick_local(gnorm_p, avail, cfg.grad_num)
            picked = scatter_set(picked, gi, gv)
        else:
            gi, gv = none

        # 5. uncertainty top-k
        if not cfg.n_unc:
            ui, uv = none
        elif gate_uncertainty_to_remaining:
            ui, uv = masked_top_k(mc_var, remaining_mask & ~picked,
                                  cfg.n_unc)
            picked = scatter_set(picked, ui, uv)
            avail = avail & ~picked[pool_idx]
        else:
            ui, uv, avail = pick_local(mcvar_p, avail, cfg.n_unc)
            picked = scatter_set(picked, ui, uv)

    # 6. latent diversity (k-center greedy) restricted to the pool. The
    # fused path has no latents: it re-encodes the few hundred gathered
    # pool and center rows
    with span("select.kcenter"):
        if cfg.n_div:
            if center_idx is not None:
                cidx = torch.cat([center_idx.to(torch.int64), ci, gi, ui])
                c_valid = torch.cat([center_valid, cv, gv, uv])
            else:
                cmask = used_mask | picked
                cidx = first_k_true(cmask, cfg.max_centers)
                c_valid = cmask[cidx]
            if mu is None:
                zp, _ = pred_encode(params, X[pool_idx].to(ct))
                zc, _ = pred_encode(params, X[cidx].to(ct))
                zp_norm = l2_normalize(zp.float())
                centers = l2_normalize(zc.float())
            else:
                zp_norm = l2_normalize(mu[pool_idx])
                centers = l2_normalize(mu[cidx])
            dl, dv = k_center_greedy_pool_core(zp_norm, avail, centers,
                                               c_valid, cfg.n_div)
            di = pool_idx[dl]
        else:
            di, dv = none
        picked = scatter_set(picked, di, dv)

    # 7. eps-greedy random from remaining minus picked
    if cfg.rand_num:
        with span("select.random"):
            ri, rv = random_select(gen, remaining_mask & ~picked,
                                   cfg.rand_num)
    else:
        ri, rv = none
    picked = scatter_set(picked, ri, rv)

    parts = [(ci, cv), (gi, gv), (ui, uv), (di, dv), (ri, rv)]
    sel_idx = torch.cat([p[0] for p in parts])
    sel_valid = torch.cat([p[1] for p in parts])
    new_remaining = remaining_mask & ~picked
    aux = {"cost_pred": cost_pred, "mc_var": mc_var, "grad_norm": gnorm}
    return sel_idx, sel_valid, new_remaining, aux
