"""Latent cost predictor over the VAE encoder (counterpart of
``vae_extent_search_tpu/models/predictor.py``).

The VAE encoder (3x Linear+ReLU -> fc_mu/fc_logvar) + an MLP cost head
with dropout after the first hidden ReLU; MC-dropout ``mc_predict`` for
epistemic variance; training loss
  total = l_reg * reg + l_pair * margin-rank(all pairs) + gamma * smooth
          + beta * KL
with dual-learning-rate AdamW (encoder 1e-5, head 1e-4) and global-norm
gradient clipping at 1.0.

The VIB arm's fields of ``PredictorConfig`` (all off by default) sample
z by reparameterisation during training (``stochastic_z``), swap the
squared error for a smooth-L1 term (``huber_reg``) and schedule the KL
weight per epoch with a linear warm-up and a cosine decay
(``kld_cosine_warmup``, ``kld_beta``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from ..convert import clone_params, tree_leaves
from .modules import dense, dense_init, dropout, mlp_apply, mlp_init
from .vae import kld_loss, reparameterize

ENCODER_KEYS = ("encoder", "fc_mu", "fc_logvar")


def init_predictor_params(gen, input_dim: int, hidden_dim: int = 256,
                          latent_dim: int = 64, predictor_hidden: int = 256,
                          predictor_layers: int = 2, device=None) -> Dict:
    dims = [latent_dim] + [predictor_hidden] * predictor_layers + [1]
    return {
        "encoder": mlp_init(gen, [input_dim, hidden_dim, hidden_dim,
                                  hidden_dim], device),
        "fc_mu": dense_init(gen, hidden_dim, latent_dim, device),
        "fc_logvar": dense_init(gen, hidden_dim, latent_dim, device),
        "cost_predictor": mlp_init(gen, dims, device),
    }


def load_pretrained_encoder(pred_params: Dict, vae_params: Dict) -> Dict:
    """Copy encoder/fc_mu/fc_logvar from a pretrained VAE."""
    out = dict(pred_params)
    for k in ENCODER_KEYS:
        out[k] = clone_params(vae_params[k])
    return out


def pred_encode(params: Dict, x: torch.Tensor):
    h = mlp_apply(params["encoder"], x, final_activation=True)
    return dense(params["fc_mu"], h), torch.clamp(
        dense(params["fc_logvar"], h), -10.0, 10.0)


def predict_cost(params: Dict, z: torch.Tensor, dropout_gen=None,
                 dropout_rate: float = 0.1) -> torch.Tensor:
    """Cost head: [Linear, ReLU, Dropout]*(L-1), [Linear, ReLU], Linear —
    dropout between hidden layers only, so with two hidden layers it
    follows the first hidden ReLU alone."""
    layers = params["cost_predictor"]
    n = len(layers)
    h = z
    for i, layer in enumerate(layers):
        h = dense(layer, h)
        if i < n - 1:
            h = torch.relu(h)
            if i < n - 2 and dropout_gen is not None:
                h = dropout(dropout_gen, h, dropout_rate)
    return h.squeeze(-1)


def pred_forward(params: Dict, x: torch.Tensor, dropout_gen=None,
                 dropout_rate: float = 0.1, z_gen=None, eps=None):
    """(cost, mu, logvar, z): z = mu, or with ``z_gen`` (or injected
    noise ``eps``) z = mu + eps * exp(logvar / 2), drawn before the
    dropout masks."""
    mu, logvar = pred_encode(params, x)
    z = mu
    if z_gen is not None or eps is not None:
        z = reparameterize(z_gen, mu, logvar, eps)
    cost = predict_cost(params, z, dropout_gen, dropout_rate)
    return cost, mu, logvar, z


def mc_predict(params: Dict, x: torch.Tensor, gen, T: int = 20,
               dropout_rate: float = 0.1, mu=None):
    """MC-dropout mean and sample variance (ddof=1) over T passes. Pass a
    precomputed ``mu`` to skip re-encoding (the encoder has no dropout,
    so the T samples share it)."""
    if mu is None:
        mu, _ = pred_encode(params, x)
    preds = torch.stack([predict_cost(params, mu, gen, dropout_rate)
                         for _ in range(T)]).float()
    return preds.mean(0), preds.var(0, correction=1)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def pair_loss(cost_pred: torch.Tensor, cost_true: torch.Tensor,
              margin: float = 0.1,
              sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs margin ranking loss over the upper triangle (optionally
    restricted to rows where sample_mask)."""
    n = cost_pred.shape[0]
    pi = cost_pred[:, None] - cost_pred[None, :]          # pred_i - pred_j
    labels = torch.sign(cost_true[None, :] - cost_true[:, None])
    losses = torch.clamp(labels * pi + margin, min=0.0)
    mask = torch.ones((n, n), dtype=torch.bool,
                      device=cost_pred.device).triu(1)
    if sample_mask is not None:
        mask = mask & sample_mask[:, None] & sample_mask[None, :]
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1)


def smooth_loss(params: Dict, z: torch.Tensor, gen, noise_std: float = 0.1,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    noise = torch.randn(z.shape, generator=gen, device=gen.device,
                        dtype=z.dtype).to(z.device)
    c0 = predict_cost(params, z)
    c1 = predict_cost(params, z + noise_std * noise)
    sq = (c0 - c1) ** 2
    if sample_mask is None:
        return sq.mean()
    return torch.where(sample_mask, sq, torch.zeros_like(sq)).sum() / \
        torch.clamp(sample_mask.sum(), min=1)


def compute_total_loss(params: Dict, x: torch.Tensor, labels: torch.Tensor,
                       gen, config: Dict,
                       sample_mask: Optional[torch.Tensor] = None, eps=None):
    """total = l_reg*reg + l_pair*pair + gamma*smooth + beta*KL, optionally
    over a masked subset of rows. ``gen`` draws, in this order, the
    reparameterisation noise (``stochastic_z`` only), the dropout masks
    and the smoothness noise; ``eps`` injects the first (a test seam).
    With ``huber_reg`` the regression term is smooth-L1 with
    ``huber_delta``; the smoothness term sees the sampled z."""
    stochastic = bool(config.get("stochastic_z", False))
    cost_pred, mu, logvar, z = pred_forward(
        params, x, dropout_gen=gen, dropout_rate=config.get("dropout", 0.1),
        z_gen=gen if stochastic else None, eps=eps if stochastic else None)
    if config.get("huber_reg", False):
        delta = config.get("huber_delta", 1.0)
        d = (cost_pred - labels).abs()
        errs = torch.where(d < delta, 0.5 * d ** 2, delta * (d - 0.5 * delta))
    else:
        errs = (cost_pred - labels) ** 2
    if sample_mask is None:
        reg = errs.mean()
        kld = kld_loss(mu, logvar)
    else:
        denom = torch.clamp(sample_mask.sum(), min=1)
        reg = torch.where(sample_mask, errs, torch.zeros_like(errs)).sum() \
            / denom
        kl_terms = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
        kld = torch.where(sample_mask[:, None], kl_terms,
                          torch.zeros_like(kl_terms)).sum() / (
            denom * mu.shape[-1])
    pair = pair_loss(cost_pred, labels, config.get("margin", 0.1),
                     sample_mask)
    smooth = smooth_loss(params, z, gen, config.get("noise_std", 0.1),
                         sample_mask)
    total = (config.get("lambda_reg", 0.01) * reg
             + config.get("lambda_pair", 3.0) * pair
             + config.get("gamma", 0.01) * smooth
             + config.get("beta", 0.01) * kld)
    return total, {"reg": reg, "pair": pair, "smooth": smooth, "kld": kld,
                   "pred": cost_pred}


class PredictorConfig(NamedTuple):
    """Hyperparameters of the VAE-arm cost predictor (the JAX package's
    defaults)."""

    lambda_reg: float = 0.01
    lambda_pair: float = 3.0
    gamma: float = 0.01
    beta: float = 0.01
    margin: float = 0.1
    noise_std: float = 0.001
    dropout: float = 0.1
    encoder_lr: float = 1e-5
    head_lr: float = 1e-4
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    # linear warm-up of the pair-ranking weight over the first N epochs:
    # lambda_pair(e) = lambda_pair * min(e + 1, N) / N
    rank_warmup_epochs: int = 200
    # the VIB arm (all off for the vae/ae arms): sampled z, smooth-L1
    # regression, and the KL weight on kld_beta's schedule
    stochastic_z: bool = False
    huber_reg: bool = False
    huber_delta: float = 1.0
    kld_cosine_warmup: bool = False
    kld_beta_start: float = 0.0
    kld_warmup_epochs: int = 50

    def as_dict(self) -> Dict:
        return self._asdict()


def kld_beta(epoch: int, epochs: int, beta: float, beta_start: float,
             warmup: int) -> float:
    """The VIB arm's KL weight at 0-based ``epoch``: linear from
    ``beta_start`` to ``beta`` over ``warmup`` epochs, then a cosine decay
    from ``beta`` towards 0 over the remaining ``epochs - warmup``,
    floored at ``beta_start``."""
    if epoch < warmup:
        return beta_start + (beta - beta_start) * epoch / max(warmup, 1)
    progress = (epoch - warmup) / max(epochs - warmup, 1)
    return max(beta * 0.5 * (1.0 + math.cos(math.pi * progress)),
               beta_start)


def make_predictor_optimizer(params: Dict, encoder_lr: float = 1e-5,
                             head_lr: float = 1e-4,
                             weight_decay: float = 1e-5
                             ) -> torch.optim.AdamW:
    """Dual-LR AdamW: encoder/fc_mu/fc_logvar in one group, the head in
    the other. torch's AdamW decays weights as optax.adamw does
    (p -= lr * (adam_update + wd * p), with the pre-update p)."""
    enc = [t for k in ENCODER_KEYS for t in tree_leaves(params[k])]
    head = [t for k in sorted(params) if k not in ENCODER_KEYS
            for t in tree_leaves(params[k])]
    return torch.optim.AdamW(
        [{"params": enc, "lr": encoder_lr},
         {"params": head, "lr": head_lr}],
        weight_decay=weight_decay)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: scale by max_norm / g_norm
    only when g_norm >= max_norm. (torch.nn.utils.clip_grad_norm_ adds
    1e-6 to the denominator and so gives other numbers.)"""
    g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                        max_norm / g_norm)
    for g in grads:
        g.mul_(scale)


def fit_predictor(params: Dict, X: torch.Tensor, y: torch.Tensor,
                  sample_mask: Optional[torch.Tensor], gen,
                  config: PredictorConfig = PredictorConfig(),
                  epochs: int = 1000):
    """Phase retraining of the cost predictor: full-batch AdamW steps over
    ``X`` (restricted to ``sample_mask`` rows when given) for ``epochs``
    epochs. Returns (best params, {"best_loss", "losses" [epochs]}).

    The best checkpoint is chosen on the FIXED-weight loss: the warm-up
    loss is incomparable across epochs (a tiny early lambda_pair would
    make near-init params look best forever). It is copied, never
    aliased, when an epoch's loss is strictly lower than every earlier
    one. It keeps the maximum beta as well: only the gradient step sees
    ``kld_beta``'s schedule."""
    params = clone_params(params, requires_grad=True)
    leaves = tree_leaves(params)
    opt = make_predictor_optimizer(params, config.encoder_lr, config.head_lr,
                                   config.weight_decay)
    cfg = config.as_dict()
    warmup = int(cfg.pop("rank_warmup_epochs", 0))
    lambda_pair_max = cfg["lambda_pair"]
    best_params, best_loss = clone_params(params), float("inf")
    losses = []
    for epoch in range(epochs):
        lam = (lambda_pair_max * min(epoch + 1.0, warmup) / warmup
               if warmup > 0 else lambda_pair_max)
        cfg_e = {**cfg, "lambda_pair": lam}
        if config.kld_cosine_warmup:
            cfg_e["beta"] = kld_beta(epoch, epochs, config.beta,
                                     config.kld_beta_start,
                                     config.kld_warmup_epochs)
        loss, aux = compute_total_loss(params, X, y, gen, cfg_e, sample_mask)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        clip_by_global_norm_([t.grad for t in leaves], config.grad_clip)
        opt.step()
        with torch.no_grad():
            fixed = (cfg["lambda_reg"] * aux["reg"]
                     + lambda_pair_max * aux["pair"]
                     + cfg["gamma"] * aux["smooth"]
                     + cfg["beta"] * aux["kld"])
        losses.append(fixed)
        f = float(fixed)
        if f < best_loss:
            best_loss, best_params = f, clone_params(params)
    return best_params, {"best_loss": best_loss,
                         "losses": torch.stack(losses)}
