"""Segment-sum cost models over ragged per-store features (counterpart of
``vae_extent_search_tpu/models/segment.py``).

Parity targets:
- SegmentSumMLPModule (reference cost_model/mlp_model.py:147-221):
  2x(Linear+ReLU) per-row encoder -> segment-sum over each program's store
  rows -> two residual (Linear+ReLU) blocks -> linear decoder (+ optional
  sigmoid).
- ranking losses rmse / rankNet / lambdaRank / listNet
  (mlp_model.py:863-944).
- SegmentVAE (vae_experiments/models/vae.py:16-137): same segment encoder,
  normalized segment-sum -> fc_mean/fc_logvar -> decoder reconstructing
  the segment-sum vector.

Ragged programs are flattened to a fixed [n_rows, in_dim] matrix, an int
segment-id vector (padding rows carry segment id == n_seg) and the
segments' row offsets [n_seg+1]. Every model sums its rows through
``ops/segment_sum.py``: the hand-written CUDA kernel, forward and backward,
on a CUDA tensor, and the plain version on a CPU tensor. The batch loaders
make the offsets on the host, so no launch waits for the device to find
them.

Parameters are dicts of ``{"w": [in, out], "b": [out]}`` tensors in the JAX
package's layout, and the pickles hold numpy arrays only: a model saved by
either package loads in the other.
"""

from __future__ import annotations

import copy
import pickle
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..convert import (
    clone_params,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
)
from ..device import make_generator, resolve_device
from ..ops.segment_sum import check_contiguous, segment_sum_rows
from .modules import dense, dense_init, dropout, mlp_apply, mlp_init
from .predictor import clip_by_global_norm_, pair_loss

_INIT_STREAM, _FIT_STREAM, _PRED_STREAM = 0, 1, 2


def init_segment_mlp_params(gen, in_dim: int, hidden_dim: int = 256,
                            out_dim: int = 1, device=None) -> Dict:
    return {
        "segment_encoder": mlp_init(gen, [in_dim, hidden_dim, hidden_dim],
                                    device),
        "l0": mlp_init(gen, [hidden_dim, hidden_dim], device),
        "l1": mlp_init(gen, [hidden_dim, hidden_dim], device),
        "decoder": dense_init(gen, hidden_dim, out_dim, device),
    }


def segment_mlp_forward(params: Dict, features: torch.Tensor,
                        segment_ids: torch.Tensor, n_seg: int,
                        add_sigmoid: bool = False,
                        offsets: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """features [R, in_dim], segment_ids [R] (id == n_seg for padding),
    offsets [n_seg+1] as the batch loaders carry them (found from the ids
    on the device when absent)."""
    h = mlp_apply(params["segment_encoder"], features, final_activation=True)
    seg = segment_sum_rows(h, segment_ids, n_seg, offsets)
    out = seg
    out = mlp_apply(params["l0"], out, final_activation=True) + out
    out = mlp_apply(params["l1"], out, final_activation=True) + out
    out = dense(params["decoder"], out).squeeze(-1)
    if add_sigmoid:
        out = torch.sigmoid(out)
    return out


# ---------------------------------------------------------------------------
# Ranking losses (mlp_model.py:863-944)
# ---------------------------------------------------------------------------


def _masked(valid_mask, preds, labels, fill=-1e9):
    neg = preds.new_tensor(fill)
    return (torch.where(valid_mask, preds, neg),
            torch.where(valid_mask, labels, neg))


def rmse_loss(preds, labels, valid_mask=None):
    sq = (preds - labels) ** 2
    if valid_mask is None:
        return torch.sqrt(torch.mean(sq))
    return torch.sqrt(torch.where(valid_mask, sq, sq.new_zeros(())).sum()
                      / torch.clamp(valid_mask.sum(), min=1))


def rank_net_loss(preds, labels, valid_mask=None):
    s_ij = preds - preds[:, None]
    p_ij = 1.0 / (torch.exp(s_ij) + 1.0)
    label_p = (labels[:, None] > labels[None, :]).to(preds.dtype)
    n = preds.shape[0]
    tri = torch.ones((n, n), dtype=torch.bool, device=preds.device).triu(1)
    if valid_mask is not None:
        tri = tri & valid_mask[:, None] & valid_mask[None, :]
    eps = 1e-7
    p = torch.clamp(p_ij, eps, 1 - eps)
    bce = -(label_p * torch.log(p) + (1 - label_p) * torch.log(1 - p))
    return torch.where(tri, bce, bce.new_zeros(())).sum() / torch.clamp(
        tri.sum(), min=1)


def lambda_rank_loss(preds, labels, valid_mask=None, eps=1e-10, sigma=1.0):
    """NDCG-weighted pairwise loss (mlp_model.py:879-926)."""
    if valid_mask is not None:
        preds, labels = _masked(valid_mask, preds, labels)
    n = preds.shape[0]
    idx_pred = torch.argsort(-preds, stable=True)
    y_pred_sorted = preds[idx_pred]
    y_true_sorted = torch.sort(labels, descending=True).values
    true_by_pred = labels[idx_pred]

    true_diffs = true_by_pred[:, None] - true_by_pred[None, :]
    pairs_mask = torch.isfinite(true_diffs) & (true_diffs > 0)
    if valid_mask is not None:
        v = valid_mask[idx_pred]
        pairs_mask = pairs_mask & v[:, None] & v[None, :]

    true_by_pred = torch.clamp(true_by_pred, min=0.0)
    y_true_sorted = torch.clamp(y_true_sorted, min=0.0)

    pos = torch.arange(1, n + 1, dtype=preds.dtype, device=preds.device)
    D = torch.log2(1.0 + pos)
    maxDCG = torch.clamp(torch.sum((2.0 ** y_true_sorted - 1.0) / D), min=eps)
    G = (2.0 ** true_by_pred - 1.0) / maxDCG

    weights = torch.abs(1.0 / D[:, None] - 1.0 / D[None, :]) * torch.abs(
        G[:, None] - G[None, :])
    scores_diffs = torch.clamp(
        y_pred_sorted[:, None] - y_pred_sorted[None, :], -1e8, 1e8)
    probas = torch.clamp(
        torch.clamp(torch.sigmoid(sigma * scores_diffs), min=eps) ** weights,
        min=eps)
    losses = torch.log2(probas)
    return -torch.where(pairs_mask, losses, losses.new_zeros(())).sum()


def list_net_loss(preds, labels, valid_mask=None, eps=1e-10):
    if valid_mask is not None:
        preds, labels = _masked(valid_mask, preds, labels)
    p = torch.softmax(preds, 0)
    t = torch.softmax(labels, 0)
    return -torch.sum(t * torch.log(p + eps))


LOSS_FNS = {
    "rmse": rmse_loss,
    "rankNet": rank_net_loss,
    "lambdaRank": lambda_rank_loss,
    "listNet": list_net_loss,
}


# ---------------------------------------------------------------------------
# The trainable model (MLPModelInternal parity, mlp_model.py:340-846)
# ---------------------------------------------------------------------------


class SegmentBatch(NamedTuple):
    """One fixed-shape flattened batch of ragged programs (or, stacked,
    all of them with a leading batch axis)."""

    features: torch.Tensor  # [R, in_dim] (padded)
    segment_ids: torch.Tensor  # [R] int32; == n_seg for padding rows
    labels: torch.Tensor  # [n_seg]
    valid: torch.Tensor  # [n_seg] bool
    offsets: torch.Tensor  # [n_seg+1] int32 row ranges of the segments


def _is_bf16(feature_dtype) -> bool:
    return feature_dtype is torch.bfloat16 or str(feature_dtype) == "bfloat16"


def make_segment_batches(features_list, labels, batch_size: int = 512,
                         fea_norm_vec=None, shuffle_rng=None,
                         stacked: bool = False, feature_dtype=np.float32,
                         device="cpu"):
    """Flatten ragged [n_i, D] feature arrays into fixed-shape batches
    (SegmentDataLoader semantics, mlp_model.py:26-144) on ``device``. Rows
    are padded to the max rows-per-batch bucket; per-column max
    normalization optional.

    ``stacked``: return ONE SegmentBatch of [n_batches, ...] tensors
    instead of a per-batch list: the batch axes are built on the host and
    uploaded in one transfer each. ``feature_dtype`` (stacked path only;
    ``torch.bfloat16`` or "bfloat16") stores the features in bf16 to halve
    the device memory and the upload; the forward upcasts to f32 before the
    first matmul.

    The rows of a batch lie program by program, so its segments are the
    row ranges ``offsets`` built here beside the ids."""
    n = len(features_list)
    order = np.arange(n)
    if shuffle_rng is not None:
        shuffle_rng.shuffle(order)
    D = features_list[0].shape[1] if n else 0
    if not n:
        return []
    # fully vectorized pack (a per-program python loop scales linearly with
    # the corpus; this is the pretraining-scale loader): one concatenate
    # + one fancy-index scatter
    bs = batch_size
    labels = np.asarray(labels, np.float32)
    sizes = np.fromiter((features_list[i].shape[0] for i in order),
                        np.int64, n)
    n_batches = -(-n // bs)
    cum = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=cum[1:])
    b_start = cum[np.minimum(np.arange(n_batches) * bs, n)]
    b_end = cum[np.minimum((np.arange(n_batches) + 1) * bs, n)]
    max_rows = int((b_end - b_start).max()) if n_batches else 0
    pos = np.arange(n)                       # program position in order
    batch_of = pos // bs
    within_start = cum[:-1] - b_start[batch_of]
    total = int(cum[-1])
    prog_of_row = np.repeat(pos, sizes)
    row_in_prog = np.arange(total) - np.repeat(cum[:-1], sizes)
    dest = (batch_of[prog_of_row] * max_rows
            + within_start[prog_of_row] + row_in_prog)
    all_feats = (np.concatenate([features_list[i] for i in order], axis=0)
                 .astype(np.float32, copy=False)
                 if total else np.zeros((0, D), np.float32))
    feats = np.zeros((n_batches * max_rows, D), np.float32)
    feats[dest] = all_feats
    if fea_norm_vec is not None:
        feats /= fea_norm_vec
    seg_ids = np.full(n_batches * max_rows, bs, np.int32)
    seg_ids[dest] = (prog_of_row % bs).astype(np.int32)
    labs = np.zeros(n_batches * bs, np.float32)
    labs[:n] = labels[order]
    valid = np.zeros(n_batches * bs, bool)
    valid[:n] = True
    # offsets[b, j] = first row of program j of batch b; the programs a
    # short last batch lacks are empty segments at its last real row
    offsets = np.repeat((b_end - b_start)[:, None], bs + 1, axis=1)
    offsets[batch_of, pos % bs] = within_start
    offsets = offsets.astype(np.int32)
    feats = feats.reshape(n_batches, max_rows, D)
    seg_ids = seg_ids.reshape(n_batches, max_rows)
    labs = labs.reshape(n_batches, bs)
    valid = valid.reshape(n_batches, bs)
    for b in range(n_batches):
        check_contiguous(seg_ids[b], bs)
    feats_t = torch.from_numpy(feats)
    if stacked and _is_bf16(feature_dtype):
        feats_t = feats_t.to(torch.bfloat16)
    stack = SegmentBatch(*(t.to(device) for t in (
        feats_t, torch.from_numpy(seg_ids), torch.from_numpy(labs),
        torch.from_numpy(valid), torch.from_numpy(offsets))))
    return stack if stacked else _unstack(stack)


def _unstack(stack: SegmentBatch):
    """The per-batch views of a stacked SegmentBatch."""
    return [SegmentBatch(*(t[b] for t in stack))
            for b in range(stack.labels.shape[0])]


def compute_fea_norm_vec(features_list) -> np.ndarray:
    """Per-column max over the training set (mlp_model.py:95-105)."""
    D = features_list[0].shape[1]
    mx = np.zeros(D, np.float32)
    for f in features_list:
        if len(f):
            mx = np.maximum(mx, np.abs(f).max(axis=0))
    mx[mx == 0] = 1.0
    return mx


class MLPModelInternal:
    """Cost model: fit_base / predict / save / load
    (mlp_model.py MLPModelInternal; default loss lambdaRank, hidden 256,
    Adam lr 7e-4, grad clip 0.5, early stop n/6).

    The fit has one loop: the corpus is packed and uploaded once, stacked,
    each batch's loss stays on the device, and the epoch's sum and the
    validation rmse are read once per epoch for early stopping (the stop
    rule of the JAX package's per-batch loop and of its compiled scan,
    which agree). ``fit_mode`` ("auto", "host", "scan") is taken for the
    JAX class's signature and selects nothing here. ``device`` defaults to
    CUDA and is never swapped for the CPU."""

    def __init__(self, in_dim: int = 164, hidden_dim: int = 256,
                 loss_type: str = "lambdaRank", lr: float = 7e-4,
                 batch_size: int = 512, grad_clip: float = 0.5,
                 n_epoch: int = 150, seed: int = 0,
                 fit_mode: str = "auto", device="cuda"):
        if loss_type not in LOSS_FNS:
            raise ValueError(f"unknown loss {loss_type!r}")
        if fit_mode not in ("auto", "host", "scan"):
            raise ValueError(f"unknown fit_mode {fit_mode!r}")
        self.in_dim = in_dim
        self.hidden_dim = hidden_dim
        self.loss_type = loss_type
        self.lr = lr
        self.batch_size = batch_size
        self.grad_clip = grad_clip
        self.n_epoch = n_epoch
        self.seed = seed
        self.fit_mode = fit_mode
        self.device = str(device)
        self.params = None
        self.fea_norm_vec = None
        self._add_sigmoid = loss_type == "rmse"
        # what the last fit did: epochs run, optimiser steps, the stopping
        # metric of every epoch, the loop's seconds
        self.fit_info: Dict = {}

    def _forward(self, params, b: SegmentBatch):
        # bf16-stored corpora upcast per batch (storage-only bf16)
        return segment_mlp_forward(params, b.features.float(), b.segment_ids,
                                   self.batch_size, self._add_sigmoid,
                                   offsets=b.offsets)

    def fit_base(self, features_list, labels, valid_split: float = 0.1,
                 verbose: bool = False, keep_norm: bool = False,
                 checkpoint_path: str = None, checkpoint_every: int = 25):
        """``checkpoint_path``: crash-resume snapshot every
        ``checkpoint_every`` epochs and at the end, the
        analogue of the reference's ``tmp_mlp.pkl`` (mlp_model.py:598);
        ``load`` restores params + fea_norm_vec mid-fit. ``keep_norm``:
        reuse the existing normalization vector (fine-tuning must share
        the base model's scaling)."""
        dev = resolve_device(self.device)
        if not keep_norm or self.fea_norm_vec is None:
            self.fea_norm_vec = compute_fea_norm_vec(features_list)
        rng = np.random.default_rng(self.seed)
        n = len(features_list)
        perm = rng.permutation(n)
        n_val = max(1, int(n * valid_split)) if n > 4 else 0
        tr = [int(i) for i in perm[n_val:]]
        va = [int(i) for i in perm[:n_val]]

        if self.params is None:
            self.params = init_segment_mlp_params(
                make_generator(self.seed, _INIT_STREAM, dev), self.in_dim,
                self.hidden_dim, device=dev)

        labels = np.asarray(labels, np.float32)
        total_rows = sum(len(f) for f in features_list)
        # past ~6 GB of f32 features, store them bf16 on the device (the
        # forward upcasts to f32)
        fdt = ("bfloat16" if total_rows * self.in_dim * 4 > 6e9
               else "float32")

        def batches(idx):
            if not idx:
                return None
            return make_segment_batches(
                [features_list[i] for i in idx], labels[idx],
                self.batch_size, self.fea_norm_vec, stacked=True,
                feature_dtype=fdt, device=dev)

        self._fit(batches(tr), batches(va), verbose, checkpoint_path,
                  checkpoint_every)
        if checkpoint_path:
            self.save(checkpoint_path)
        return self

    def _fit(self, tr_stack, va_stack=None, verbose=False,
             checkpoint_path=None, checkpoint_every=25):
        """The epoch loop over stacked batches. Stops when the validation
        rmse (the summed training loss, without a validation set) has not
        improved by 1e-7 for ``max(5, n_epoch // 6)`` epochs and keeps the
        best epoch's parameters."""
        tr_batches = _unstack(tr_stack)
        va_batches = _unstack(va_stack) if va_stack is not None else []
        params = clone_params(self.params, requires_grad=True)
        leaves = tree_leaves(params)
        opt = torch.optim.Adam(leaves, lr=self.lr)
        loss_fn = LOSS_FNS[self.loss_type]

        best_val = float("inf")
        best_params = clone_params(params)
        patience = max(5, self.n_epoch // 6)
        bad, steps, epochs_run, history = 0, 0, 0, []
        t_loop = time.perf_counter()
        for epoch in range(self.n_epoch):
            ep = 0.0
            for b in tr_batches:
                loss = loss_fn(self._forward(params, b), b.labels, b.valid)
                opt.zero_grad(set_to_none=False)
                loss.backward()
                clip_by_global_norm_([t.grad for t in leaves], self.grad_clip)
                opt.step()
                steps += 1
                ep = ep + loss.detach()
            epochs_run += 1
            if va_batches:
                with torch.no_grad():
                    val = float(torch.stack(
                        [rmse_loss(self._forward(params, b), b.labels,
                                   b.valid) for b in va_batches]).mean())
            else:
                val = float(ep)
            history.append(val)
            if val < best_val - 1e-7:
                best_val, best_params, bad = val, clone_params(params), 0
            else:
                bad += 1
                if bad >= patience:
                    break
            if verbose and epoch % 10 == 0:
                print(f"epoch {epoch}: train {float(ep):.4f} val {val:.4f}")
            if checkpoint_path and epoch % checkpoint_every == 0:
                self.params = clone_params(params)
                self.save(checkpoint_path)
        self.params = best_params
        self.fit_info = {"epochs": epochs_run, "steps": steps,
                         "train_batches": len(tr_batches),
                         "val_batches": len(va_batches), "best_val": best_val,
                         "val_history": history,
                         # host clock; every epoch ends in a device read
                         "loop_seconds": time.perf_counter() - t_loop}
        return self

    def predict_on_features(self, features_list) -> np.ndarray:
        """Scores for ragged feature arrays; all-zero rows (unlowerable
        states) score -inf (mlp_model.py:842-845)."""
        if not features_list:
            return np.zeros(0, np.float32)
        dev = resolve_device(self.device)
        n = len(features_list)
        batches = make_segment_batches(
            features_list, np.zeros(n, np.float32), self.batch_size,
            self.fea_norm_vec, device=dev)
        with torch.no_grad():
            out = torch.cat([self._forward(self.params, b) for b in batches])
        preds = out[:n].cpu().numpy().astype(np.float32)
        from .gbdt import _invalid_rows_mask

        for i, bad in enumerate(_invalid_rows_mask(self, features_list)):
            if bad:
                preds[i] = -np.inf
        return preds

    def save(self, path: str):
        """The JAX package's pickle layout, numpy arrays only."""
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "config": {
                        "in_dim": self.in_dim, "hidden_dim": self.hidden_dim,
                        "loss_type": self.loss_type, "lr": self.lr,
                        "batch_size": self.batch_size,
                        "grad_clip": self.grad_clip, "n_epoch": self.n_epoch,
                    },
                    "params": params_to_numpy(self.params),
                    "fea_norm_vec": self.fea_norm_vec,
                    # whether fit-time features carried the tiled 10-dim
                    # workload embedding (models/embedding.py): consumers
                    # must featurize predictions the same way
                    "use_workload_embedding": getattr(
                        self, "use_workload_embedding", False),
                    "workload_embed_total_dim": getattr(
                        self, "workload_embed_total_dim", 10),
                },
                f,
            )

    @classmethod
    def load(cls, path: str, device="cuda") -> "MLPModelInternal":
        with open(path, "rb") as f:
            blob = pickle.load(f)
        model = cls(**blob["config"], device=device)
        model.params = params_from_numpy(blob["params"],
                                         resolve_device(device))
        model.fea_norm_vec = blob["fea_norm_vec"]
        model.use_workload_embedding = blob.get(
            "use_workload_embedding", False)
        model.workload_embed_total_dim = blob.get(
            "workload_embed_total_dim", 10)
        return model


# ---------------------------------------------------------------------------
# SegmentVAE (vae_experiments/models/vae.py:16-137)
# ---------------------------------------------------------------------------

_ENC_KEYS = ("segment_encoder", "l0", "l1", "fc_mean", "fc_logvar")


def _segment_trunk(gen, in_dim, hidden_dim, latent_dim, device) -> Dict:
    return {
        "segment_encoder": mlp_init(gen, [in_dim, hidden_dim, hidden_dim],
                                    device),
        "l0": mlp_init(gen, [hidden_dim, hidden_dim], device),
        "l1": mlp_init(gen, [hidden_dim, hidden_dim], device),
        "fc_mean": dense_init(gen, hidden_dim, latent_dim, device),
        "fc_logvar": dense_init(gen, hidden_dim, latent_dim, device),
    }


def init_segment_vae_params(gen, in_dim: int, hidden_dim: int = 256,
                            latent_dim: int = 64, device=None) -> Dict:
    params = _segment_trunk(gen, in_dim, hidden_dim, latent_dim, device)
    params["decoder"] = mlp_init(
        gen, [latent_dim, hidden_dim, hidden_dim, hidden_dim], device)
    return params


def _masked_moments(seg, valid):
    """Biased per-channel (mean, var) over valid rows: the single
    definition shared by train-time batch standardization and the frozen
    predict-time statistics (they must agree numerically)."""
    denom = torch.clamp(valid.sum(), min=1)
    v = valid[:, None]
    zero = seg.new_zeros(())
    mean = torch.where(v, seg, zero).sum(0, keepdim=True) / denom
    var = torch.where(v, (seg - mean) ** 2, zero).sum(0, keepdim=True) / denom
    return mean, var


def segment_vae_encode(params, features, segment_ids, n_seg,
                       stats_valid=None, norm_stats=None, offsets=None):
    """Returns (mu, logvar, segment_sum_target).

    Batch-standardization of the segment sums (BatchNorm1d equivalent):
    by default train-mode full-batch statistics. ``stats_valid`` restricts
    the statistics to real segments when the batch carries padding rows;
    ``norm_stats=(mean, var)`` applies frozen statistics instead
    (BatchNorm eval semantics, for models that predict on batches other
    than the one they were fit on)."""
    h = mlp_apply(params["segment_encoder"], features, final_activation=True)
    seg = segment_sum_rows(h, segment_ids, n_seg, offsets)
    if norm_stats is not None:
        mean, var = norm_stats
    elif stats_valid is not None:
        mean, var = _masked_moments(seg, stats_valid)
    else:
        mean = seg.mean(0, keepdim=True)
        var = seg.var(0, keepdim=True, correction=0)
    # sqrt(var + eps) keeps the gradient finite on constant channels
    # (one-hot feature columns)
    normed = (seg - mean) * torch.rsqrt(var + 1e-5)
    out = mlp_apply(params["l0"], normed, final_activation=True) + normed
    out = mlp_apply(params["l1"], out, final_activation=True) + out
    logvar = torch.clamp(dense(params["fc_logvar"], out), -10.0, 10.0)
    return dense(params["fc_mean"], out), logvar, normed


def _randn(gen, ref: torch.Tensor) -> torch.Tensor:
    return torch.randn(ref.shape, generator=gen, device=gen.device,
                       dtype=ref.dtype).to(ref.device)


def _masked_kld(mu, logvar, valid, denom):
    kl_terms = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
    return torch.where(valid[:, None], kl_terms, kl_terms.new_zeros(())
                       ).sum() / (denom * mu.shape[-1])


def segment_vae_loss(params, features, segment_ids, n_seg, valid, gen,
                     beta: float = 1e-4, stats_valid=None, offsets=None,
                     noise=None):
    """``gen`` draws the reparameterization noise; ``noise`` [n_seg,
    latent], where given, is used in its place."""
    mu, logvar, target = segment_vae_encode(
        params, features, segment_ids, n_seg, stats_valid=stats_valid,
        offsets=offsets)
    std = torch.exp(0.5 * logvar)
    z = mu + std * (_randn(gen, mu) if noise is None else noise)
    recon = mlp_apply(params["decoder"], z, final_activation=False)
    denom = torch.clamp(valid.sum(), min=1)
    recon_l = torch.where(valid[:, None], (recon - target) ** 2,
                          recon.new_zeros(())).sum() / (
        denom * target.shape[-1])
    kld = _masked_kld(mu, logvar, valid, denom)
    return recon_l + beta * kld, (recon_l, kld)


# ---------------------------------------------------------------------------
# Segment-aware latent cost predictor
# (vae_experiments/models/regression.py:11-173 parity)
# ---------------------------------------------------------------------------


def init_segment_predictor_params(gen, in_dim: int, hidden_dim: int = 256,
                                  latent_dim: int = 64,
                                  predictor_hidden: int = 256,
                                  predictor_layers: int = 2,
                                  device=None) -> Dict:
    dims = [latent_dim] + [predictor_hidden] * predictor_layers + [1]
    params = _segment_trunk(gen, in_dim, hidden_dim, latent_dim, device)
    params["cost_predictor"] = mlp_init(gen, dims, device)
    return params


def load_pretrained_segment_encoder(pred_params: Dict,
                                    vae_params: Dict) -> Dict:
    """Copy segment encoder + latent heads from a pretrained SegmentVAE
    (reference regression.py load_pretrained_encoder: key-prefix match)."""
    out = dict(pred_params)
    for k in _ENC_KEYS:
        if k in vae_params:
            out[k] = clone_params(vae_params[k])
    return out


def segment_predictor_encode(params, features, segment_ids, n_seg,
                             stats_valid=None, norm_stats=None, offsets=None):
    return segment_vae_encode(
        {k: params[k] for k in _ENC_KEYS}, features, segment_ids, n_seg,
        stats_valid=stats_valid, norm_stats=norm_stats, offsets=offsets)


def segment_predict_cost(params, z, dropout_gen=None,
                         dropout_rate: float = 0.1, dropout_keep=None):
    """The cost head; dropout after every hidden ReLU but the last, drawn
    from ``dropout_gen`` or, where given, taken from ``dropout_keep`` (one
    bool keep-mask per dropout layer)."""
    layers = params["cost_predictor"]
    n = len(layers)
    h = z
    for i, layer in enumerate(layers):
        h = dense(layer, h)
        if i < n - 1:
            h = torch.relu(h)
            if i < n - 2:
                if dropout_keep is not None:
                    h = torch.where(dropout_keep[i],
                                    h / (1.0 - dropout_rate),
                                    h.new_zeros(()))
                elif dropout_gen is not None:
                    h = dropout(dropout_gen, h, dropout_rate)
    return h.squeeze(-1)


def segment_predictor_loss(params, features, segment_ids, n_seg, labels,
                           valid, gen, config: Dict, stats_valid=None,
                           offsets=None, noise=None, dropout_keep=None):
    """reg + pair + smooth + KL phase loss over segment encodings
    (vae_experiments/trainer.py:298-568 Regression_Trainer). ``gen`` draws
    the dropout masks, then the smoothness noise; ``dropout_keep`` and
    ``noise`` (standard normal, [n_seg, latent]) replace those draws."""
    mu, logvar, _ = segment_predictor_encode(
        params, features, segment_ids, n_seg, stats_valid=stats_valid,
        offsets=offsets)
    rate = config.get("dropout", 0.1)
    cost = segment_predict_cost(params, mu, gen, rate, dropout_keep)
    denom = torch.clamp(valid.sum(), min=1)
    zero = cost.new_zeros(())
    reg = torch.where(valid, (cost - labels) ** 2, zero).sum() / denom
    pair = pair_loss(cost, labels, config.get("margin", 0.1), valid)
    eps = _randn(gen, mu) if noise is None else noise
    smooth = torch.where(
        valid,
        (segment_predict_cost(params, mu)
         - segment_predict_cost(
             params, mu + config.get("noise_std", 0.001) * eps)) ** 2,
        zero).sum() / denom
    kld = _masked_kld(mu, logvar, valid, denom)
    total = (
        config.get("lambda_reg", 0.01) * reg
        + config.get("lambda_pair", 3.0) * pair
        + config.get("gamma", 0.01) * smooth
        + config.get("beta", 0.01) * kld
    )
    return total, {"reg": reg, "pair": pair, "smooth": smooth, "kld": kld}


def _keep_best_(best_params, best_loss, params, loss):
    """On the device, without a read: where ``loss`` is lower than
    ``best_loss``, copy ``params`` into ``best_params`` and return the new
    best loss."""
    better = loss < best_loss
    for b, p in zip(tree_leaves(best_params), tree_leaves(params)):
        b.copy_(torch.where(better, p.detach(), b))
    return torch.where(better, loss, best_loss)


def fit_segment_predictor(params, features, segment_ids, labels, valid, gen,
                          n_seg: int, epochs: int = 300,
                          encoder_lr: float = 1e-5, head_lr: float = 1e-4,
                          stats_valid=None, offsets=None):
    """Full-batch phase training: global-norm clip at 1.0, then AdamW with
    weight decay 1e-5, the encoder at ``encoder_lr`` and the head at
    ``head_lr``. Returns (best params, {"best_loss", "losses"}): as in the
    JAX package, the parameters kept are those right after the step whose
    loss was the lowest so far. Nothing is read back during the fit."""
    params = clone_params(params, requires_grad=True)
    leaves = tree_leaves(params)
    enc = [t for k in _ENC_KEYS for t in tree_leaves(params[k])]
    head = [t for k in sorted(params) if k not in _ENC_KEYS
            for t in tree_leaves(params[k])]
    opt = torch.optim.AdamW([{"params": enc, "lr": encoder_lr},
                             {"params": head, "lr": head_lr}],
                            weight_decay=1e-5)
    best_params = clone_params(params)
    best_loss = torch.full((), float("inf"), device=features.device)
    losses = []
    for _ in range(epochs):
        loss, _ = segment_predictor_loss(
            params, features, segment_ids, n_seg, labels, valid, gen, {},
            stats_valid, offsets)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        clip_by_global_norm_([t.grad for t in leaves], 1.0)
        opt.step()
        with torch.no_grad():
            best_loss = _keep_best_(best_params, best_loss, params,
                                    loss.detach())
        losses.append(loss.detach())
    return best_params, {"best_loss": best_loss,
                         "losses": torch.stack(losses)}


def _sgdr_schedule(lr: float, epochs: int, t0: int = 30, t_mult: int = 2):
    """CosineAnnealingWarmRestarts(T_0=30, T_mult=2) equivalent
    (reference vae_experiments/trainer.py:43): cosine cycles of length
    30, 60, 120, ... stepped once per epoch. Returns step -> learning rate
    (0-based steps; past the last cycle the rate stays 0)."""
    bounds = [0]
    t = t0
    while bounds[-1] < epochs:
        bounds.append(bounds[-1] + t)
        t *= t_mult

    def schedule(step: int) -> float:
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if step < hi:
                return lr * 0.5 * (1.0 + np.cos(np.pi * (step - lo)
                                                / (hi - lo)))
        return 0.0

    return schedule


def fit_segment_vae(params, features, segment_ids, valid, gen, n_seg: int,
                    epochs: int = 200, lr: float = 2e-4, beta: float = 1e-4,
                    stats_valid=None, offsets=None):
    """SegmentVAE pretraining (reference VAE_Trainer.train_vae defaults:
    200 epochs, lr 2e-4, beta 1e-4, AdamW with weight decay 1e-4 and
    cosine-warm-restart LR cycles). Returns (params, losses [epochs])."""
    params = clone_params(params, requires_grad=True)
    opt = torch.optim.AdamW(tree_leaves(params), lr=lr, weight_decay=1e-4)
    schedule = _sgdr_schedule(lr, epochs)
    losses = []
    for step in range(epochs):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        loss, _ = segment_vae_loss(params, features, segment_ids, n_seg,
                                   valid, gen, beta, stats_valid, offsets)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return clone_params(params), torch.stack(losses)


def eval_segment_vae(params, features, segment_ids, valid, n_seg: int,
                     offsets=None):
    """(reconstruction R^2, KL per latent dim) on the mean latent."""
    with torch.no_grad():
        mu, logvar, target = segment_vae_encode(
            params, features, segment_ids, n_seg, offsets=offsets)
        recon = mlp_apply(params["decoder"], mu, final_activation=False)
        v = valid[:, None]
        zero = target.new_zeros(())
        denom = torch.clamp(valid.sum(), min=1)
        err = torch.where(v, (recon - target) ** 2, zero).sum()
        mean_t = torch.where(v, target, zero).sum() / (
            denom * target.shape[-1])
        var_t = torch.where(v, (target - mean_t) ** 2, zero).sum()
        r2 = 1.0 - err / torch.clamp(var_t, min=1e-8)
        kl_per_dim = _masked_kld(mu, logvar, valid, denom)
    return float(r2), float(kl_per_dim)


DEFAULT_VAE_SEARCH_CONFIGS = [
    # reference trainer.py:148-156 (hand-picked subset of the full grid)
    {"hidden_dim": 256, "latent_dim": 64, "beta": 1e-4, "lr": 1e-3},
    {"hidden_dim": 256, "latent_dim": 64, "beta": 1e-4, "lr": 2e-4},
    {"hidden_dim": 256, "latent_dim": 64, "beta": 2e-4, "lr": 1e-3},
    {"hidden_dim": 256, "latent_dim": 128, "beta": 5e-5, "lr": 1e-3},
    {"hidden_dim": 256, "latent_dim": 128, "beta": 5e-5, "lr": 5e-4},
    {"hidden_dim": 256, "latent_dim": 128, "beta": 5e-5, "lr": 2e-4},
    {"hidden_dim": 256, "latent_dim": 128, "beta": 1e-4, "lr": 2e-4},
    {"hidden_dim": 256, "latent_dim": 128, "beta": 1e-3, "lr": 2e-4},
]


def search_segment_vae_hyperparams(features, segment_ids, valid, n_seg: int,
                                   in_dim: int, configs=None,
                                   target_kl_range=(0.05, 0.2),
                                   epochs: int = 200, seed: int = 0,
                                   verbose: bool = False, offsets=None):
    """VAE hyperparameter search targeting a healthy KL/dim band
    (reference VAE_Trainer.hyperparameter_search, trainer.py:124-267):
    per config train + evaluate (recon R^2, KL/dim); score = R^2 with up
    to a 10% penalty proportional to the KL/dim distance outside
    ``target_kl_range`` (avoids posterior collapse / blown-up codes).
    Returns (best_params, best_config, results sorted by score)."""
    configs = configs or DEFAULT_VAE_SEARCH_CONFIGS
    kl_min, kl_max = target_kl_range
    results = []
    best = None
    for ci, cfg in enumerate(configs):
        gen = make_generator(seed + ci, _INIT_STREAM, features.device)
        params = init_segment_vae_params(
            gen, in_dim, hidden_dim=cfg["hidden_dim"],
            latent_dim=cfg["latent_dim"], device=features.device)
        params, _ = fit_segment_vae(
            params, features, segment_ids, valid, gen, n_seg,
            epochs=epochs, lr=cfg["lr"], beta=cfg["beta"], offsets=offsets)
        r2, kl_per_dim = eval_segment_vae(
            params, features, segment_ids, valid, n_seg, offsets=offsets)
        if kl_min <= kl_per_dim <= kl_max:
            score = r2
        elif kl_per_dim < kl_min:
            score = r2 - 0.1 * (kl_min - kl_per_dim) / kl_min
        else:
            score = r2 - 0.1 * (kl_per_dim - kl_max) / kl_max
        row = dict(cfg, recon_r2=r2, kl_per_dim=kl_per_dim, score=score,
                   in_kl_range=kl_min <= kl_per_dim <= kl_max)
        results.append((row, params))
        if verbose:
            print(f"[{ci + 1}/{len(configs)}] {cfg} -> R2={r2:.4f} "
                  f"KL/dim={kl_per_dim:.4f} score={score:.4f}")
        if best is None or score > best[0]["score"]:
            best = (row, params)
    results.sort(key=lambda rp: -rp[0]["score"])
    return best[1], best[0], [r for r, _ in results]


def _segment_predictor_scores(params, features, segment_ids, n_seg,
                              norm_stats=None, offsets=None):
    with torch.no_grad():
        mu, _, _ = segment_predictor_encode(
            params, features, segment_ids, n_seg, norm_stats=norm_stats,
            offsets=offsets)
        return segment_predict_cost(params, mu)


def _segment_norm_stats(params, features, segment_ids, valid, n_seg,
                        offsets=None):
    """Frozen batch-norm statistics over the fit set's valid segments
    (BatchNorm1d running-stats / eval-mode equivalent)."""
    with torch.no_grad():
        h = mlp_apply(params["segment_encoder"], features,
                      final_activation=True)
        seg = segment_sum_rows(h, segment_ids, n_seg, offsets)
        return _masked_moments(seg, valid)


def _flatten_programs(features_list, labels, fea_norm_vec,
                      seg_bucket: int = 256, row_bucket: int = 4096,
                      device="cpu"):
    """Flatten ragged per-program feature matrices into one fixed-shape
    (features, segment_ids, labels, valid, n_seg, offsets) tuple on
    ``device``, bucketing both the program axis and the row axis as the JAX
    package does (so both see the same padded shapes). Rows are filled
    program by program: ``offsets`` [n_seg+1] are the segments' row
    ranges, the bucket's spare segments empty."""
    n = len(features_list)
    D = features_list[0].shape[1] if n else 0
    rows = int(sum(len(f) for f in features_list))
    n_seg = max(seg_bucket, -(-n // seg_bucket) * seg_bucket)
    R = max(row_bucket, -(-rows // row_bucket) * row_bucket)
    feats = np.zeros((R, D), np.float32)
    seg_ids = np.full((R,), n_seg, np.int32)  # padding rows -> dropped seg
    labs = np.zeros((n_seg,), np.float32)
    valid = np.zeros((n_seg,), bool)
    offsets = np.full((n_seg + 1,), rows, np.int32)
    r = 0
    for j, f in enumerate(features_list):
        feats[r:r + len(f)] = f
        seg_ids[r:r + len(f)] = j
        labs[j] = labels[j] if labels is not None else 0.0
        valid[j] = True
        offsets[j] = r
        r += len(f)
    feats /= fea_norm_vec
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(feats), to(seg_ids), to(labs), to(valid), n_seg, to(offsets)


class SegmentVAEModelInternal:
    """VAE-pretrained latent cost model behind the fit/predict interface:
    the reference's for_inference lineage (vae_reg_feature_ansor*.ipynb /
    e2e_vae_reg_feature.ipynb plug the scripts/vae_experiments SegmentVAE
    + Regression pipeline in as the cost model inside Ansor's search).

    fit_base = SegmentVAE pretrain on the measured rows (first fit only;
    fit_segment_vae) -> encoder transfer (load_pretrained_segment_encoder)
    -> reg+pair+smooth+KL predictor fit (fit_segment_predictor). Predict
    scores the mean latent through the cost head; all-zero feature rows
    (unlowerable states) score -inf like every other backend. ``device``
    defaults to CUDA and is never swapped for the CPU."""

    def __init__(self, in_dim: int = 164, hidden_dim: int = 256,
                 latent_dim: int = 64, vae_epochs: int = 200,
                 vae_lr: float = 2e-4, vae_beta: float = 1e-4,
                 reg_epochs: int = 300, encoder_lr: float = 1e-5,
                 head_lr: float = 1e-4, seed: int = 0, device="cuda"):
        self.in_dim = in_dim
        self.hidden_dim = hidden_dim
        self.latent_dim = latent_dim
        self.vae_epochs = vae_epochs
        self.vae_lr = vae_lr
        self.vae_beta = vae_beta
        self.reg_epochs = reg_epochs
        self.encoder_lr = encoder_lr
        self.head_lr = head_lr
        self.seed = seed
        self.device = str(device)
        self.vae_params = None
        self.params = None
        self.fea_norm_vec = None
        self.norm_stats = None

    def fit_base(self, features_list, labels, valid_split: float = 0.1,
                 verbose: bool = False, keep_norm: bool = False):
        dev = resolve_device(self.device)
        if not keep_norm or self.fea_norm_vec is None:
            self.fea_norm_vec = compute_fea_norm_vec(features_list)
        labels = np.asarray(labels, np.float32)
        feats, seg_ids, labs, valid, n_seg, offsets = _flatten_programs(
            features_list, labels, self.fea_norm_vec, device=dev)
        g_vae = make_generator(self.seed, _INIT_STREAM, dev)
        g_pred = make_generator(self.seed, _PRED_STREAM, dev)
        g_fit = make_generator(self.seed, _FIT_STREAM, dev)
        # batch-norm statistics are restricted to the real (non-padding)
        # segments during fit and FROZEN afterwards for prediction: this
        # model predicts on batches other than its fit set, so train-mode
        # batch stats would shift between fit and predict
        if self.vae_params is None:
            # pretrain once per search (reference tune_vae.py:100-110:
            # the SegmentVAE trains on the initial pool, later phases
            # retrain only the regression model on all measured)
            self.vae_params = init_segment_vae_params(
                g_vae, self.in_dim, self.hidden_dim, self.latent_dim, dev)
            self.vae_params, _ = fit_segment_vae(
                self.vae_params, feats, seg_ids, valid, g_vae, n_seg,
                epochs=self.vae_epochs, lr=self.vae_lr, beta=self.vae_beta,
                stats_valid=valid, offsets=offsets)
        params = init_segment_predictor_params(
            g_pred, self.in_dim, self.hidden_dim, self.latent_dim,
            device=dev)
        params = load_pretrained_segment_encoder(params, self.vae_params)
        self.params, _ = fit_segment_predictor(
            params, feats, seg_ids, labs, valid, g_fit, n_seg,
            epochs=self.reg_epochs, encoder_lr=self.encoder_lr,
            head_lr=self.head_lr, stats_valid=valid, offsets=offsets)
        self.norm_stats = _segment_norm_stats(
            self.params, feats, seg_ids, valid, n_seg, offsets)
        return self

    def predict_on_features(self, features_list) -> np.ndarray:
        if not len(features_list):
            return np.zeros(0, np.float32)
        feats, seg_ids, _, _, n_seg, offsets = _flatten_programs(
            features_list, None, self.fea_norm_vec,
            device=resolve_device(self.device))
        scores = _segment_predictor_scores(
            self.params, feats, seg_ids, n_seg, self.norm_stats, offsets
        ).cpu().numpy()[: len(features_list)].astype(np.float32)
        from .gbdt import _invalid_rows_mask

        for i, bad in enumerate(_invalid_rows_mask(self, features_list)):
            if bad:
                scores[i] = -np.inf
        return scores

    def save(self, path: str):
        """The JAX package's pickle layout, numpy arrays only."""
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "config": {
                        "in_dim": self.in_dim,
                        "hidden_dim": self.hidden_dim,
                        "latent_dim": self.latent_dim,
                        "vae_epochs": self.vae_epochs,
                        "vae_lr": self.vae_lr, "vae_beta": self.vae_beta,
                        "reg_epochs": self.reg_epochs,
                        "encoder_lr": self.encoder_lr,
                        "head_lr": self.head_lr, "seed": self.seed,
                    },
                    "vae_params": params_to_numpy(self.vae_params),
                    "params": params_to_numpy(self.params),
                    "norm_stats": params_to_numpy(self.norm_stats),
                    "fea_norm_vec": self.fea_norm_vec,
                    "use_workload_embedding": getattr(
                        self, "use_workload_embedding", False),
                    "workload_embed_total_dim": getattr(
                        self, "workload_embed_total_dim", 10),
                },
                f,
            )

    @classmethod
    def load(cls, path: str, device="cuda") -> "SegmentVAEModelInternal":
        with open(path, "rb") as f:
            blob = pickle.load(f)
        model = cls(**blob["config"], device=device)
        dev = resolve_device(device)
        model.vae_params = params_from_numpy(blob["vae_params"], dev)
        model.params = params_from_numpy(blob["params"], dev)
        stats = blob.get("norm_stats")
        model.norm_stats = (None if stats is None
                            else params_from_numpy(tuple(stats), dev))
        model.fea_norm_vec = blob["fea_norm_vec"]
        model.use_workload_embedding = blob.get(
            "use_workload_embedding", False)
        model.workload_embed_total_dim = blob.get(
            "workload_embed_total_dim", 10)
        return model


def few_shot_fit(base_cls, features_by_task, labels_by_task,
                 mode: str = "base_only", in_dim: int = 164,
                 fine_tune_epochs: int = 30, **model_kw):
    """Few-shot training modes over per-task datasets (reference
    mlp_model.py:422-510,683-786: base_only / local_only_mix_task /
    fine_tune_mix_task / plus_mix_task).

    Returns {task: model-like with predict_on_features} plus a "__base__"
    entry when a shared base model exists.
    """
    all_feats, all_labels = [], []
    for t in features_by_task:
        all_feats.extend(features_by_task[t])
        all_labels.extend(labels_by_task[t])

    models = {}
    if mode in ("base_only", "fine_tune", "plus", "maml"):
        base = base_cls(in_dim=in_dim, **model_kw)
        base.fit_base(all_feats, np.asarray(all_labels, np.float32))
        models["__base__"] = base
        if mode == "base_only":
            for t in features_by_task:
                models[t] = base
            return models

    if mode == "maml":
        # first-order meta-learning of the initialization (the reference's
        # MAML few-shot mode, mlp_model.py:683-786; the Reptile first-order
        # update: adapt a copy on one task for a few epochs, then move the
        # meta-parameters toward the adapted ones)
        meta = models["__base__"]
        tasks = list(features_by_task)
        rng = np.random.default_rng(getattr(meta, "seed", 0))
        meta_rounds = 3 * len(tasks)
        step_size = 0.2
        for _ in range(meta_rounds):
            t = tasks[int(rng.integers(len(tasks)))]
            inner = copy.copy(meta)
            inner.params = clone_params(meta.params)
            inner.n_epoch = max(5, fine_tune_epochs // 3)
            inner.fit_base(
                features_by_task[t],
                np.asarray(labels_by_task[t], np.float32),
                keep_norm=True,
            )
            with torch.no_grad():
                for a, b in zip(tree_leaves(meta.params),
                                tree_leaves(inner.params)):
                    a.add_(step_size * (b - a))
        models["__base__"] = meta

    for t in features_by_task:
        feats = features_by_task[t]
        labels = np.asarray(labels_by_task[t], np.float32)
        if mode == "local":
            local = base_cls(in_dim=in_dim, **model_kw)
            local.fit_base(feats, labels)
            models[t] = local
        elif mode in ("fine_tune", "maml"):
            ft = copy.copy(models["__base__"])
            ft.n_epoch = fine_tune_epochs
            # warm-start from the base parameters, keep its normalization
            ft.params = clone_params(models["__base__"].params)
            ft.fea_norm_vec = models["__base__"].fea_norm_vec
            ft.fit_base(feats, labels, keep_norm=True)
            models[t] = ft
        elif mode == "plus":
            base = models["__base__"]
            residual = base_cls(in_dim=in_dim, **model_kw)
            base_pred = base.predict_on_features(feats)
            base_pred = np.where(np.isfinite(base_pred), base_pred, 0.0)
            residual.fit_base(feats, labels - base_pred)

            class _Plus:
                def __init__(self, b, r):
                    self.b, self.r = b, r

                def predict_on_features(self, fl):
                    pb = self.b.predict_on_features(fl)
                    pr = self.r.predict_on_features(fl)
                    return np.where(
                        np.isfinite(pb) & np.isfinite(pr), pb + pr, -np.inf
                    )

            models[t] = _Plus(base, residual)
        else:
            raise ValueError(f"unknown few-shot mode {mode}")
    return models
