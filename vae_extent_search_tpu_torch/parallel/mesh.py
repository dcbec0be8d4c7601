"""A (data, model) grid of ranks on ``torch.distributed`` (counterpart of
``vae_extent_search_tpu/parallel/mesh.py``).

One process per rank, each with an explicit device. Rank r sits at grid
position (r // model, r % model), the JAX package's
``np.array(devices).reshape(data, model)``:

- axis "data": candidate rows. A rank holds the contiguous row block of
  its data index (:func:`shard_batch`); scoring, MC dropout and the
  training batch shard here, and gradients are summed over it;
- axis "model": the wide dense layers' output columns
  (:func:`param_sharding`): a rank computes its slice of their outputs,
  which are gathered along the feature axis.

The collectives below (:func:`all_reduce`, :func:`all_gather`,
:func:`gather_rows`, an autograd-aware row gather, and :func:`host`, the
JAX loop's ``_host``) work on either backend: gloo (the CPU, or ranks
sharing one card) and NCCL (a card per rank). A mesh of one rank along an
axis makes that axis's collectives the identity, so a single process runs
every sharded function without a process group.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import tree_leaves, tree_map
from ..models.modules import dense
from ..models.predictor import (
    PredictorConfig,
    clip_by_global_norm_,
    make_predictor_optimizer,
    pair_loss,
    predict_cost,
)
from ..models.vae import kld_loss
from .multihost import local_device


class Mesh:
    """The ranks of the process group (or this process alone) as a
    ``data`` x ``model`` grid. ``shape`` maps each axis to its size,
    ``index(axis)`` is this rank's coordinate and ``group(axis)`` the
    process group of the ranks that differ only along ``axis`` (None: the
    default group, or no collective at all when the axis has size 1)."""

    def __init__(self, data: int, model: int = 1, device="cuda"):
        dist = torch.distributed
        if dist.is_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.rank, self.world, self.backend = 0, 1, None
        if data * model != self.world:
            raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                             f"ranks; the process group has {self.world}")
        self.shape = {"data": data, "model": model}
        self._coord = {"data": self.rank // model, "model": self.rank % model}
        self.device = local_device(device, self.rank)
        self._groups = {"data": None, "model": None}
        if data > 1 and model > 1:
            # every rank creates every group, in the same order
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if self._coord["model"] == m:
                    self._groups["data"] = g
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if self._coord["data"] == d:
                    self._groups["model"] = g

    def index(self, axis: str) -> int:
        return self._coord[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


def make_mesh(data: Optional[int] = None, model: int = 1,
              device="cuda") -> Mesh:
    """A (data, model) mesh over the process group's ranks (this process
    alone when there is no group); ``data`` defaults to the world size
    over ``model``."""
    if data is None:
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        data = world // model
    return Mesh(data, model, device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# gloo and NCCL take CUDA tensors of every dtype used here (bool, bf16,
# int64 included) in torch 2.11: nothing is staged through the host
_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = "data",
               op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced (``op`` "sum", "max" or "min") over the
    ranks of ``axis``. Integer sums are exact on both backends."""
    t = x.contiguous().clone()
    if mesh.shape[axis] > 1:
        torch.distributed.all_reduce(
            t, getattr(torch.distributed.ReduceOp, _OPS[op]),
            group=mesh.group(axis))
    return t


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "data"
               ) -> torch.Tensor:
    """[S, *x.shape]: every rank's ``x`` along ``axis`` in coordinate
    order (no gradient; see :func:`gather_rows` for one)."""
    if mesh.shape[axis] == 1:
        return x[None].clone()
    t = x.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    torch.distributed.all_gather(parts, t, group=mesh.group(axis))
    return torch.stack(parts)


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' blocks of ``dim`` concatenated in coordinate
    order. Backward: this rank's block of the incoming gradient. Every
    rank computes the same function of the gathered tensor, so the
    gradient of that one function needs no sum across ranks; the
    parameters' gradients are summed afterwards, where each rank holds
    only its own rows' share."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        parts = all_gather(x.detach(), mesh, axis)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        i = ctx.mesh.index(ctx.axis)
        return (grad.narrow(ctx.dim, i * ctx.size, ctx.size), None, None,
                None)


class _SumGradOver(torch.autograd.Function):
    """Identity forward; backward sums the gradient over ``axis`` (the
    input of a layer whose output columns are split over it: each rank's
    columns give part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.axis), None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                dim: int = 0) -> torch.Tensor:
    """The global tensor from each rank's block along ``dim``, on every
    rank, through autograd (see ``_GatherRows``)."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherRows.apply(x, mesh, axis, dim)


def host(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> np.ndarray:
    """The global rows of a row-sharded ``x`` as host numpy, on every rank
    (the JAX loop's ``_host``)."""
    with torch.no_grad():
        return gather_rows(x.detach(), mesh, axis).cpu().numpy()


def digest(tree, mesh: Mesh) -> bool:
    """True when every rank holds bit-identical tensors in ``tree``: each
    rank's SHA-256 of the leaves' bytes (first 8 bytes), gathered over
    both axes."""
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().cpu().view(-1).view(
            torch.uint8).numpy().tobytes())
    mine = torch.tensor([int.from_bytes(h.digest()[:8], "little") >> 1],
                        dtype=torch.int64, device=mesh.device)
    got = torch.cat([all_gather(mine, mesh, axis).view(-1)
                     for axis in ("data", "model")])
    return bool((got == mine).all())


def shard_batch(x, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous row block of the global [N, ...] ``x`` (N a
    multiple of the axis size; callers pad), on the mesh's device."""
    t = torch.as_tensor(x)
    s = mesh.shape[axis]
    if t.shape[0] % s:
        raise ValueError(f"{t.shape[0]} rows do not split over {s} ranks")
    n = t.shape[0] // s
    i = mesh.index(axis)
    return t[i * n:(i + 1) * n].to(mesh.device)


def param_sharding(params: Dict, mesh: Mesh) -> Dict:
    """Per leaf, the dimension split over "model" (None: replicated): the
    out-features of 2-D weights and the length of 1-D vectors that divide
    by the axis size and are at least twice it, the JAX package's rule."""
    m = mesh.shape["model"]

    def spec(x):
        if x.dim() == 2 and x.shape[1] % m == 0 and x.shape[1] >= 2 * m:
            return 1
        if x.dim() == 1 and x.shape[0] % m == 0 and x.shape[0] >= 2 * m:
            return 0
        return None

    return tree_map(spec, params)


# ---------------------------------------------------------------------------
# the sharded predictor step and scoring
# ---------------------------------------------------------------------------


def _dense_tp(layer: Dict, x: torch.Tensor, mesh) -> torch.Tensor:
    """``dense`` with the weight's columns split over "model" when
    :func:`param_sharding` splits them: this rank computes its columns,
    which are then gathered (the bias is split the same way). ``mesh``
    None: ``dense``."""
    w, b = layer["w"], layer["b"]
    m = 1 if mesh is None else mesh.shape["model"]
    if m == 1 or not (w.shape[1] % m == 0 and w.shape[1] >= 2 * m):
        return dense(layer, x)
    c = w.shape[1] // m
    j = mesh.index("model")
    y = dense({"w": w[:, j * c:(j + 1) * c], "b": b[j * c:(j + 1) * c]},
              _SumGradOver.apply(x, mesh, "model"))
    return gather_rows(y, mesh, "model", dim=-1)


def _encode_tp(params: Dict, x: torch.Tensor, mesh: Mesh):
    h = x
    for layer in params["encoder"]:
        h = torch.relu(_dense_tp(layer, h, mesh))
    return (_dense_tp(params["fc_mu"], h, mesh),
            torch.clamp(_dense_tp(params["fc_logvar"], h, mesh), -10.0, 10.0))


def _head_tp(params: Dict, z: torch.Tensor, mesh: Mesh, keeps=(),
             rate: float = 0.1) -> torch.Tensor:
    """``predict_cost`` with split columns; ``keeps`` holds one uniform
    draw per dropout layer (this rank's rows), as ``models/modules.py::
    dropout`` uses them."""
    layers = params["cost_predictor"]
    n = len(layers)
    h = z
    for i, layer in enumerate(layers):
        h = _dense_tp(layer, h, mesh)
        if i < n - 1:
            h = torch.relu(h)
            if i < n - 2 and keeps:
                keep = 1.0 - rate
                h = torch.where(keeps[i] < keep, h / keep,
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
    return h.squeeze(-1)


def _rows(mesh: Mesh, n_loc: int) -> slice:
    i = mesh.index("data")
    return slice(i * n_loc, (i + 1) * n_loc)


def _draw(gen, shape, normal: bool, rows: slice, device) -> torch.Tensor:
    """This rank's rows of a draw over the GLOBAL shape from the
    replicated generator, so each row sees what it would on one device."""
    f = torch.randn if normal else torch.rand
    return f(shape, generator=gen, device=gen.device)[rows].to(device)


def sharded_total_loss(params: Dict, x: torch.Tensor, labels: torch.Tensor,
                       gen, config: Dict, mesh: Mesh,
                       sample_mask: Optional[torch.Tensor] = None):
    """``models/predictor.py::compute_total_loss`` over the global batch
    whose row block ``x`` this rank holds: each rank computes its rows'
    outputs (drawing the global noise from the replicated ``gen`` in
    compute_total_loss's order and keeping its rows), the per-row terms are
    gathered through autograd, and the loss is the single-device formula
    over all rows, the same on every rank."""
    n_loc = x.shape[0]
    N = n_loc * mesh.shape["data"]
    rows = _rows(mesh, n_loc)
    dev = x.device
    rate = config.get("dropout", 0.1)
    mu, logvar = _encode_tp(params, x, mesh)
    L = mu.shape[-1]
    z = mu
    if config.get("stochastic_z", False):
        eps = _draw(gen, (N, L), True, rows, dev).to(mu.dtype)
        z = mu + eps * torch.exp(0.5 * logvar)
    keeps = []
    if rate > 0.0:
        for layer in params["cost_predictor"][:-2]:
            keeps.append(_draw(gen, (N, layer["w"].shape[1]), False, rows,
                               dev))
    cost = _head_tp(params, z, mesh, keeps, rate)
    if config.get("huber_reg", False):
        delta = config.get("huber_delta", 1.0)
        d = (cost - labels).abs()
        errs = torch.where(d < delta, 0.5 * d ** 2, delta * (d - 0.5 * delta))
    else:
        errs = (cost - labels) ** 2
    noise = _draw(gen, (N, L), True, rows, dev).to(z.dtype)
    sq = (_head_tp(params, z, mesh)
          - _head_tp(params, z + config.get("noise_std", 0.1) * noise,
                     mesh)) ** 2

    cost_g, mu_g, logvar_g, errs_g, sq_g = (
        gather_rows(t, mesh) for t in (cost, mu, logvar, errs, sq))
    labels_g = gather_rows(labels.detach(), mesh)
    if sample_mask is None:
        reg = errs_g.mean()
        kld = kld_loss(mu_g, logvar_g)
        smooth = sq_g.mean()
        mask_g = None
    else:
        mask_g = gather_rows(sample_mask, mesh)
        denom = torch.clamp(mask_g.sum(), min=1)
        reg = torch.where(mask_g, errs_g, torch.zeros_like(errs_g)).sum() \
            / denom
        kl_terms = -0.5 * (1.0 + logvar_g - mu_g ** 2 - torch.exp(logvar_g))
        kld = torch.where(mask_g[:, None], kl_terms,
                          torch.zeros_like(kl_terms)).sum() / (
            denom * mu_g.shape[-1])
        smooth = torch.where(mask_g, sq_g, torch.zeros_like(sq_g)).sum() \
            / denom
    pair = pair_loss(cost_g, labels_g, config.get("margin", 0.1), mask_g)
    total = (config.get("lambda_reg", 0.01) * reg
             + config.get("lambda_pair", 3.0) * pair
             + config.get("gamma", 0.01) * smooth
             + config.get("beta", 0.01) * kld)
    return total, {"reg": reg, "pair": pair, "smooth": smooth, "kld": kld,
                   "pred": cost_g}


def make_sharded_train_step(mesh: Mesh,
                            config: PredictorConfig = PredictorConfig()):
    """(step, init_opt): one full-batch predictor step, data-parallel over
    "data" and with the wide layers' columns split over "model".

    ``opt = init_opt(params)`` makes ``params``' leaves trainable (in
    place) and returns their dual-learning-rate AdamW.
    ``step(params, opt, X, y, mask, gen) -> (params, opt, loss)`` takes
    this rank's row blocks of X, y and mask (None: every row) and the
    replicated generator. The loss is :func:`sharded_total_loss`; each
    gradient is summed over "data" (and, for split leaves, over "model",
    where the ranks' columns are disjoint), clipped by its global norm and
    applied on every rank, so the ranks' parameters stay identical."""
    cfg = config.as_dict()

    def init_opt(params):
        for t in tree_leaves(params):
            t.requires_grad_(True)
        return make_predictor_optimizer(params, config.encoder_lr,
                                        config.head_lr, config.weight_decay)

    def step(params, opt, X, y, mask, gen):
        leaves = tree_leaves(params)
        split = tree_leaves(param_sharding(params, mesh))
        loss, _ = sharded_total_loss(params, X, y, gen, cfg, mesh, mask)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        with torch.no_grad():
            for t, s in zip(leaves, split):
                g = all_reduce(t.grad, mesh, "data")
                if s is not None and mesh.shape["model"] > 1:
                    g = all_reduce(g, mesh, "model")
                t.grad.copy_(g)
        clip_by_global_norm_([t.grad for t in leaves], config.grad_clip)
        opt.step()
        return params, opt, loss.detach()

    return step, init_opt


def sharded_score_candidates(mesh: Mesh):
    """``score(params, X, gen, T, rate=0.1) -> (cost, gnorm, mc_var, mu)``
    for this rank's row block ``X``: the encoder, the cost head, the
    z-gradient norms and the variance of T MC-dropout passes. Each pass's
    dropout draw is over the global rows from the replicated ``gen``, so
    each row's statistics are those of one device's ``mc_predict``."""
    from ..models.predictor import pred_encode
    from ..search.select import z_grad_norms

    def score(params, X, gen, T: int, rate: float = 0.1):
        n_loc = X.shape[0]
        rows = _rows(mesh, n_loc)
        N = n_loc * mesh.shape["data"]
        with torch.no_grad():
            mu, _ = pred_encode(params, X)
            cost = predict_cost(params, mu)
        gnorm = z_grad_norms(params, mu)
        preds = []
        with torch.no_grad():
            for _ in range(T):
                keeps = [_draw(gen, (N, layer["w"].shape[1]), False, rows,
                               X.device)
                         for layer in params["cost_predictor"][:-2]] \
                    if rate > 0.0 else []
                preds.append(_head_tp(params, mu, None, keeps, rate))
        mc_var = torch.stack(preds).float().var(0, correction=1)
        return cost, gnorm, mc_var, mu

    return score

