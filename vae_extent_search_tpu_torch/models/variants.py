"""Alternative cost-model architectures over per-store feature sequences
(counterpart of ``vae_extent_search_tpu/models/variants.py``).

Parity targets:
- LSTM variant (reference cost_model/mlp_model.py:223-271 LSTMModuel):
  row encoder -> LSTM over each program's store rows -> last hidden ->
  decoder
- MHA variant (mlp_model.py:273-339): row encoder -> multi-head
  self-attention within a program's rows -> masked mean-pool -> residual
  blocks -> decoder
- TabNet (cost_model/tabnet_model.py:30-770 + sparsemax.py): the full
  SegmentSumMLPModule flow: per-store rows through a 7-step TabNet
  encoder (entmax-1.5 attentive masks with prior, shared+independent
  GLU stacks with sqrt(0.5) residuals, ghost batch-norm vb=512),
  encodings segment-summed per program, two residual relu layers,
  decoder

Programs are padded to [S, T, D] (programs x their longest row count)
with a [S, T] row mask. Parameters are trees of tensors in the JAX
package's layout (a dense layer ``{"w": [in, out], "b": [out]}``, a
TabNet fc a bare [in, out] matrix), so its pickles load here. None of
this reaches a hand-written kernel, in either package: the JAX
package's LSTM is a ``lax.scan`` and the rest fused XLA ops; here the
LSTM is an explicit loop over T and the rest plain tensor operations.
"""

from __future__ import annotations

import math
import pickle
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..convert import (
    clone_params,
    tree_leaves,
    variant_from_numpy,
    variant_to_numpy,
)
from ..device import make_generator, resolve_device
from .modules import dense, dense_init, mlp_apply, mlp_init
from .predictor import clip_by_global_norm_

_INIT_STREAM = 0


def pad_segments(features_list, device="cpu"):
    """Ragged [n_i, D] arrays -> ([S, T, D] padded, [S, T] bool mask) on
    ``device``; T is the longest program."""
    S = len(features_list)
    T = max((len(f) for f in features_list), default=1)
    D = features_list[0].shape[1] if S else 0
    out = np.zeros((S, T, D), np.float32)
    mask = np.zeros((S, T), bool)
    for i, f in enumerate(features_list):
        out[i, :len(f)] = f
        mask[i, :len(f)] = True
    return (torch.as_tensor(out).to(device),
            torch.as_tensor(mask).to(device))


def _zeros_like(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device).expand_as(x)


# ---------------------------------------------------------------------------
# LSTM variant
# ---------------------------------------------------------------------------


def init_lstm_params(gen, in_dim: int, hidden_dim: int = 256,
                     device=None) -> Dict:
    return {
        "segment_encoder": mlp_init(gen, [in_dim, hidden_dim, hidden_dim],
                                    device),
        "lstm_x": dense_init(gen, hidden_dim, 4 * hidden_dim, device),
        "lstm_h": dense_init(gen, hidden_dim, 4 * hidden_dim, device),
        "decoder": mlp_init(gen, [hidden_dim, hidden_dim, 1], device),
    }


def lstm_forward(params: Dict, feats: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """feats [S, T, D], mask [S, T] -> scores [S]. One cell step per row
    position; where a program has no row the carry is kept."""
    x_all = mlp_apply(params["segment_encoder"], feats,
                      final_activation=True)
    S, T, H = x_all.shape
    h = x_all.new_zeros((S, H))
    c = x_all.new_zeros((S, H))
    for t in range(T):
        gates = dense(params["lstm_x"], x_all[:, t]) + \
            dense(params["lstm_h"], h)
        i, f, g, o = torch.split(gates, H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        keep = mask[:, t, None]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
    return mlp_apply(params["decoder"], h).squeeze(-1)


# ---------------------------------------------------------------------------
# MHA variant
# ---------------------------------------------------------------------------


def init_mha_params(gen, in_dim: int, hidden_dim: int = 256,
                    device=None) -> Dict:
    return {
        "segment_encoder": mlp_init(gen, [in_dim, hidden_dim, hidden_dim],
                                    device),
        "q": dense_init(gen, hidden_dim, hidden_dim, device),
        "k": dense_init(gen, hidden_dim, hidden_dim, device),
        "v": dense_init(gen, hidden_dim, hidden_dim, device),
        "o": dense_init(gen, hidden_dim, hidden_dim, device),
        "l0": mlp_init(gen, [hidden_dim, hidden_dim], device),
        "decoder": dense_init(gen, hidden_dim, 1, device),
    }


def mha_forward(params: Dict, feats: torch.Tensor, mask: torch.Tensor,
                n_heads: int = 8) -> torch.Tensor:
    """Self-attention over a program's rows. Absent keys get the logit
    -1e9, not -inf, so a program with no valid row stays finite; padding
    query rows attend to the valid keys and the masked mean-pool drops
    them."""
    h = mlp_apply(params["segment_encoder"], feats, final_activation=True)
    S, T, H = h.shape
    hd = H // n_heads

    def split_heads(x):
        return x.reshape(S, T, n_heads, hd).transpose(1, 2)  # [S,nh,T,hd]

    q = split_heads(dense(params["q"], h))
    k = split_heads(dense(params["k"], h))
    v = split_heads(dense(params["v"], h))
    logits = torch.einsum("shtd,shud->shtu", q, k) / math.sqrt(float(hd))
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), -1e9, device=logits.device))
    attn = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("shtu,shud->shtd", attn, v)
    ctx = ctx.transpose(1, 2).reshape(S, T, H)
    out = dense(params["o"], ctx) + h
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    pooled = torch.where(mask[..., None], out, _zeros_like(out)).sum(1) \
        / denom
    pooled = mlp_apply(params["l0"], pooled, final_activation=True) + pooled
    return dense(params["decoder"], pooled).squeeze(-1)


# ---------------------------------------------------------------------------
# TabNet
# ---------------------------------------------------------------------------


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with jnp.maximum's gradient (half to each side at a
    tie), which torch.maximum shares and torch.clamp does not."""
    return torch.maximum(x, _zeros_like(x))


def sparsemax(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sparse softmax projection onto the simplex (reference
    cost_model/sparsemax.py; Martins & Astudillo 2016)."""
    if dim != -1 and dim != z.ndim - 1:
        return sparsemax(z.movedim(dim, -1)).movedim(-1, dim)
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k = torch.arange(1, z.shape[-1] + 1, dtype=z.dtype, device=z.device)
    z_cumsum = torch.cumsum(z_sorted, dim=-1)
    support = 1.0 + k * z_sorted > z_cumsum
    k_z = support.sum(dim=-1, keepdim=True)
    tau = (torch.gather(z_cumsum, -1, k_z - 1) - 1.0) / k_z.to(z.dtype)
    return _relu0(z - tau)


def entmax15(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exact 1.5-entmax (Peters, Niculae & Martins 2019), the mask the
    reference's TabNet uses (tabnet_model.py mask_type="entmax").
    Closed form via the sorted-moments threshold; outputs
    p_i = max(z_i/2 - tau, 0)^2 summing to 1."""
    if dim != -1 and dim != z.ndim - 1:
        return entmax15(z.movedim(dim, -1)).movedim(-1, dim)
    zh = z / 2.0
    zs = torch.sort(zh, dim=-1, descending=True).values
    k = torch.arange(1, z.shape[-1] + 1, dtype=z.dtype, device=z.device)
    mean = torch.cumsum(zs, dim=-1) / k
    meansq = torch.cumsum(zs * zs, dim=-1) / k
    ss = k * (meansq - mean * mean)
    delta = (1.0 - ss) / k
    # safe sqrt: d/dx sqrt(x) at the clamp point is inf -> NaN grads
    pos = delta > 0.0
    tau = mean - torch.sqrt(torch.where(pos, delta, torch.ones_like(delta))) \
        * pos
    support = (tau <= zs) & (delta >= 0.0)
    k_star = torch.clamp(support.sum(dim=-1, keepdim=True), min=1)
    tau_star = torch.gather(tau, -1, k_star - 1)
    p = torch.square(_relu0(zh - tau_star))
    # exact tau makes p sum to 1; normalize to absorb fp round-off
    total = p.sum(dim=-1, keepdim=True)
    return p / torch.maximum(total, torch.full_like(total, 1e-12))


# Faithful TabNet encoder (reference tabnet_model.py:30-588 +
# SegmentSumMLPModule:703-770): per-store rows run through the TabNet
# encoder FIRST, encodings segment-sum per program, then two residual
# relu layers + decoder. Config mirrors SegmentSumMLPModule:709-719
# (n_d = n_a = 64, n_steps = 7, gamma = 1.3, 2 shared + 2 independent
# GLU layers, ghost batch-norm with virtual batch 512, entmax masks).

_TABNET_VB = 512
_TABNET_BN_MOM = 0.02


def _xavier_normal(gen, shape, gain, device):
    std = gain * np.sqrt(2.0 / (shape[0] + shape[1]))
    r = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (r * float(std)).to(device)


def _glu_fc_init(gen, in_dim, out2, device):
    # initialize_glu: gain = sqrt((in + out2) / sqrt(in)); no bias
    return _xavier_normal(gen, (in_dim, out2),
                          np.sqrt((in_dim + out2) / np.sqrt(in_dim)), device)


def _non_glu_fc_init(gen, in_dim, out, device):
    return _xavier_normal(gen, (in_dim, out),
                          np.sqrt((in_dim + out) / np.sqrt(4 * in_dim)),
                          device)


def _bn_init(dim, device):
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def _bn_state_init(dim, device):
    return {"mean": torch.zeros(dim, device=device),
            "var": torch.ones(dim, device=device)}


def _gbn_apply(p, st, x, training, momentum=_TABNET_BN_MOM,
               virtual_batch=_TABNET_VB):
    """Ghost batch norm (tabnet_model.py GBN:226-243): at train time each
    virtual batch normalizes with its own statistics (the biased
    variance); running stats feed eval. Rows pad to a virtual-batch
    multiple with the batch mean so padding cannot skew chunk
    statistics. Returns (y, new running stats), the stats detached."""
    if not training:
        inv = torch.rsqrt(st["var"] + 1e-5)
        return (x - st["mean"]) * inv * p["scale"] + p["bias"], st
    n, d = x.shape
    vb = min(virtual_batch, max(n, 1))
    nchunk = -(-n // vb)
    pad = nchunk * vb - n
    full_mean = x.mean(dim=0)
    xp = torch.cat([x, full_mean.expand(pad, d)]) if pad else x
    xc = xp.reshape(nchunk, vb, d)
    mu = xc.mean(dim=1, keepdim=True)
    var = xc.var(dim=1, keepdim=True, unbiased=False)
    y = (xc - mu) * torch.rsqrt(var + 1e-5)
    y = y.reshape(-1, d)[:n] * p["scale"] + p["bias"]
    batch_mean = mu.detach().mean(dim=(0, 1))
    batch_var = var.detach().mean(dim=(0, 1))
    new_st = {
        "mean": (1 - momentum) * st["mean"] + momentum * batch_mean,
        "var": (1 - momentum) * st["var"] + momentum * batch_var,
    }
    return y, new_st


class TabNetConfig(NamedTuple):
    n_d: int = 64
    n_a: int = 64
    n_steps: int = 7
    gamma: float = 1.3
    n_shared: int = 2
    n_independent: int = 2


def init_tabnet_params(gen, in_dim: int, hidden_dim: int = 128,
                       cfg: TabNetConfig = TabNetConfig(), device=None):
    """(params, bn_state) for the full encoder + segment head."""
    if device is None:
        device = gen.device
    nda = cfg.n_d + cfg.n_a
    params = {"initial_bn": _bn_init(in_dim, device)}
    state = {"initial_bn": _bn_state_init(in_dim, device)}
    # shared GLU FCs (first maps in_dim, rest nda)
    params["shared_fcs"] = [
        _glu_fc_init(gen, in_dim if i == 0 else nda, 2 * nda, device)
        for i in range(cfg.n_shared)
    ]

    def ft_init(tag):
        # per-FeatTransformer: a GBN per shared layer + independent GLUs
        params[tag] = {
            "shared_bns": [_bn_init(2 * nda, device)
                           for _ in range(cfg.n_shared)],
            "indep": [
                {"fc": _glu_fc_init(gen, nda, 2 * nda, device),
                 "bn": _bn_init(2 * nda, device)}
                for _ in range(cfg.n_independent)
            ],
        }
        state[tag] = {
            "shared_bns": [_bn_state_init(2 * nda, device)
                           for _ in range(cfg.n_shared)],
            "indep": [_bn_state_init(2 * nda, device)
                      for _ in range(cfg.n_independent)],
        }

    ft_init("splitter")
    for s in range(cfg.n_steps):
        ft_init(f"ft_{s}")
        params[f"att_{s}"] = {
            "fc": _non_glu_fc_init(gen, cfg.n_a, in_dim, device),
            "bn": _bn_init(in_dim, device),
        }
        state[f"att_{s}"] = _bn_state_init(in_dim, device)
    params["final"] = _non_glu_fc_init(gen, cfg.n_d, hidden_dim, device)
    params["l0"] = dense_init(gen, hidden_dim, hidden_dim, device)
    params["l1"] = dense_init(gen, hidden_dim, hidden_dim, device)
    params["decoder"] = dense_init(gen, hidden_dim, 1, device)
    return params, state


_SQRT_HALF = float(np.sqrt(0.5).astype(np.float32))


def _glu(g):
    half = g.shape[-1] // 2
    return g[:, :half] * torch.sigmoid(g[:, half:])


def _feat_transformer(params, shared_fcs, st, x, training):
    """Shared GLU block (first layer unscaled) + independent GLU block,
    residuals scaled by sqrt(0.5) (tabnet_model.py GLU_Block:146-187)."""
    new_st = {"shared_bns": [], "indep": []}
    h = x
    for i, fc in enumerate(shared_fcs):
        g, bst = _gbn_apply(params["shared_bns"][i], st["shared_bns"][i],
                            h @ fc, training)
        new_st["shared_bns"].append(bst)
        glu = _glu(g)
        h = glu if i == 0 else (h + glu) * _SQRT_HALF
    for i, lay in enumerate(params["indep"]):
        g, bst = _gbn_apply(lay["bn"], st["indep"][i], h @ lay["fc"],
                            training)
        new_st["indep"].append(bst)
        glu = _glu(g)
        h = (h + glu) * _SQRT_HALF if (shared_fcs or i > 0) else glu
    return h, new_st


def tabnet_encode(params, state, x, training=False,
                  cfg: TabNetConfig = TabNetConfig()):
    """Per-row TabNet encoding [N, in_dim] -> [N, hidden]
    (TabNetEncoder.forward:353-380 + final_mapping:567-582)."""
    new_state = {}
    x, new_state["initial_bn"] = _gbn_apply(
        params["initial_bn"], state["initial_bn"], x, training,
        momentum=0.01, virtual_batch=1 << 30)  # plain BN on input
    prior = torch.ones_like(x)
    h, new_state["splitter"] = _feat_transformer(
        params["splitter"], params["shared_fcs"], state["splitter"], x,
        training)
    att = h[:, cfg.n_d:]
    res = 0.0
    for s in range(cfg.n_steps):
        a, new_state[f"att_{s}"] = _gbn_apply(
            params[f"att_{s}"]["bn"], state[f"att_{s}"],
            att @ params[f"att_{s}"]["fc"], training)
        mask = entmax15(a * prior)
        prior = (cfg.gamma - mask) * prior
        h, new_state[f"ft_{s}"] = _feat_transformer(
            params[f"ft_{s}"], params["shared_fcs"], state[f"ft_{s}"],
            mask * x, training)
        res = res + torch.relu(h[:, :cfg.n_d])
        att = h[:, cfg.n_d:]
    return res @ params["final"], new_state


def tabnet_forward(params, state, feats, mask, training=False,
                   cfg: TabNetConfig = TabNetConfig()):
    """[S, T, D] padded rows -> (per-program scores [S], new bn state)
    (SegmentSumMLPModule.forward:740-770: encode rows, segment-sum
    encodings, two residual relu layers, decoder). All S x T rows are
    encoded, padding included, so the batch statistics see the padded
    rows as the JAX package's do; the program sum is masked."""
    S, T, D = feats.shape
    enc, new_state = tabnet_encode(params, state, feats.reshape(S * T, D),
                                   training, cfg)
    enc = enc.reshape(S, T, -1)
    seg = torch.where(mask[..., None], enc, _zeros_like(enc)).sum(dim=1)
    h = torch.relu(dense(params["l0"], seg)) + seg
    h = torch.relu(dense(params["l1"], h)) + h
    return dense(params["decoder"], h).squeeze(-1), new_state


# ---------------------------------------------------------------------------
# A shared model wrapper with the MLPModelInternal surface
# ---------------------------------------------------------------------------


class SequenceModelInternal:
    """fit_base/predict/save/load for the LSTM/MHA/TabNet variants.

    ``fit_base`` is full-batch: every epoch is one step over all training
    programs (rmse loss, global-norm clip 0.5, then Adam at ``lr``), as
    the JAX package's jitted step; TabNet's batch-norm statistics are
    carried from epoch to epoch. A model whose ``params`` are set before
    ``fit_base`` trains from them instead of a fresh draw, in their dtype
    (float32 for a fresh draw). ``device`` defaults to CUDA and is never
    swapped for the CPU."""

    def __init__(self, arch: str = "lstm", in_dim: int = 164,
                 hidden_dim: int = 256, lr: float = 7e-4,
                 n_epoch: int = 100, seed: int = 0, device="cuda"):
        if arch not in ("lstm", "mha", "tabnet"):
            raise ValueError(f"unknown sequence model {arch!r}")
        self.arch = arch
        self.in_dim = in_dim
        self.hidden_dim = hidden_dim if arch != "tabnet" else 128
        self.lr = lr
        self.n_epoch = n_epoch
        self.seed = seed
        self.device = str(device)
        self.params = None
        self.bn_state = None
        self.fea_norm_vec = None
        # what the last fit did: epochs, the loop's seconds, final rmse
        self.fit_info: Dict = {}

    def _init(self, dev):
        gen = make_generator(self.seed, _INIT_STREAM, dev)
        if self.arch == "lstm":
            self.params = init_lstm_params(gen, self.in_dim, self.hidden_dim)
        elif self.arch == "mha":
            self.params = init_mha_params(gen, self.in_dim, self.hidden_dim)
        else:
            self.params, self.bn_state = init_tabnet_params(
                gen, self.in_dim, self.hidden_dim)

    def _forward(self, params, feats, mask, training=False):
        """Scores [S] and the new TabNet bn state (None for the others)."""
        if self.arch == "lstm":
            return lstm_forward(params, feats, mask), None
        if self.arch == "mha":
            return mha_forward(params, feats, mask), None
        return tabnet_forward(params, self.bn_state, feats, mask,
                              training=training)

    def fit_base(self, features_list, labels, verbose=False):
        from .segment import compute_fea_norm_vec

        dev = resolve_device(self.device)
        self.fea_norm_vec = compute_fea_norm_vec(features_list)
        feats, mask = pad_segments(
            [f / self.fea_norm_vec for f in features_list], device=dev)
        if self.params is None:
            self._init(dev)
        params = clone_params(self.params, requires_grad=True)
        leaves = tree_leaves(params)
        # the parameters' dtype (float32 unless given others)
        feats = feats.to(leaves[0].dtype)
        labels = torch.as_tensor(np.asarray(labels)).to(dev, leaves[0].dtype)
        opt = torch.optim.Adam(leaves, lr=self.lr, eps=1e-8)
        t_loop = time.perf_counter()
        loss = None
        for epoch in range(self.n_epoch):
            preds, new_state = self._forward(params, feats, mask,
                                             training=True)
            loss = torch.sqrt(torch.mean((preds - labels) ** 2))
            opt.zero_grad(set_to_none=False)
            loss.backward()
            clip_by_global_norm_([t.grad for t in leaves], 0.5)
            opt.step()
            if new_state is not None:
                self.bn_state = new_state
            if verbose and epoch % 20 == 0:
                print(f"{self.arch} epoch {epoch}: rmse {float(loss):.4f}")
        final = float(loss.detach()) if loss is not None else float("nan")
        self.params = clone_params(params)
        self.fit_info = {"epochs": self.n_epoch, "rmse": final,
                         # host clock, ended by the device read of the loss
                         "loop_seconds": time.perf_counter() - t_loop}
        return self

    def predict_on_features(self, features_list):
        """Scores for ragged feature arrays; all-zero programs
        (unlowerable states) score -inf (mlp_model.py:842-845)."""
        dev = resolve_device(self.device)
        feats, mask = pad_segments(
            [np.asarray(f, np.float32) / self.fea_norm_vec
             for f in features_list], device=dev)
        feats = feats.to(tree_leaves(self.params)[0].dtype)
        with torch.no_grad():
            preds = self._forward(self.params, feats, mask)[0]
        preds = preds.cpu().numpy().astype(np.float32)
        from .gbdt import _invalid_rows_mask

        for i, bad in enumerate(_invalid_rows_mask(self, features_list)):
            if bad:
                preds[i] = -np.inf
        return preds

    def save(self, path):
        """The JAX package's pickle layout, numpy arrays only."""
        params, bn_state = variant_to_numpy(self.params, self.bn_state)
        with open(path, "wb") as f:
            pickle.dump({
                "arch": self.arch, "in_dim": self.in_dim,
                "hidden_dim": self.hidden_dim, "lr": self.lr,
                "n_epoch": self.n_epoch,
                "params": params, "bn_state": bn_state,
                "fea_norm_vec": self.fea_norm_vec,
                "use_workload_embedding": getattr(
                    self, "use_workload_embedding", False),
                "workload_embed_total_dim": getattr(
                    self, "workload_embed_total_dim", 10),
            }, f)

    @classmethod
    def load(cls, path, device="cuda"):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        dev = resolve_device(device)
        m = cls(blob["arch"], blob["in_dim"], blob["hidden_dim"],
                blob["lr"], blob["n_epoch"], device=device)
        m.params, m.bn_state = variant_from_numpy(
            blob["params"], blob.get("bn_state"), dev)
        m.fea_norm_vec = blob["fea_norm_vec"]
        m.use_workload_embedding = blob.get("use_workload_embedding", False)
        m.workload_embed_total_dim = blob.get("workload_embed_total_dim", 10)
        return m

