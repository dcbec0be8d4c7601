"""VAE over extent feature vectors (counterpart of
``vae_extent_search_tpu/models/vae.py``).

3x(Linear+ReLU) encoder -> fc_mu/fc_logvar, symmetric decoder; loss =
alpha_recon * MSE + beta * KL; Adam over fixed, un-shuffled minibatches,
keeping the best-validation parameters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..convert import clone_params, tree_leaves
from .modules import dense, dense_init, mlp_apply, mlp_init


def init_vae_params(gen, input_dim: int, latent_dim: int = 16,
                    hidden_dim: int = 128, device=None) -> Dict:
    return {
        "encoder": mlp_init(gen, [input_dim, hidden_dim, hidden_dim,
                                  hidden_dim], device),
        "fc_mu": dense_init(gen, hidden_dim, latent_dim, device),
        "fc_logvar": dense_init(gen, hidden_dim, latent_dim, device),
        "decoder": mlp_init(gen, [latent_dim, hidden_dim, hidden_dim,
                                  hidden_dim, input_dim], device),
    }


def vae_encode(params: Dict, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = mlp_apply(params["encoder"], x, final_activation=True)
    # clamp logvar for numerical stability of exp()
    return dense(params["fc_mu"], h), torch.clamp(
        dense(params["fc_logvar"], h), -10.0, 10.0)


def vae_decode(params: Dict, z: torch.Tensor) -> torch.Tensor:
    return mlp_apply(params["decoder"], z, final_activation=False)


def reparameterize(gen: torch.Generator, mu: torch.Tensor,
                   logvar: torch.Tensor, eps=None) -> torch.Tensor:
    """mu + eps * exp(logvar / 2), eps standard normal from ``gen`` unless
    injected."""
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn(std.shape, generator=gen, device=gen.device,
                          dtype=std.dtype).to(std.device)
    return mu + eps * std


def vae_forward(params: Dict, x: torch.Tensor, gen=None,
                use_mean: bool = True):
    mu, logvar = vae_encode(params, x)
    z = mu if use_mean or gen is None else reparameterize(gen, mu, logvar)
    return vae_decode(params, z), mu, logvar, z


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * mean(1 + logvar - mu^2 - exp(logvar))."""
    return -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))


def masked_vae_loss(params: Dict, x: torch.Tensor, row_mask: torch.Tensor,
                    gen, beta: float, alpha_recon: float,
                    deterministic: bool = False):
    """VAE loss over valid rows only (padding rows masked out).

    ``deterministic=True`` encodes z = mu with no sampling (the plain
    autoencoder arm; pass beta=0 to drop the KL term as that arm does)."""
    x_recon, mu, logvar, _ = vae_forward(params, x, gen,
                                         use_mean=deterministic)
    m = row_mask[:, None]
    denom = torch.clamp(row_mask.sum(), min=1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    recon = torch.where(m, (x_recon - x) ** 2, zero).sum() / (
        denom * x.shape[-1])
    kl_terms = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
    kld = torch.where(m, kl_terms, zero).sum() / (denom * mu.shape[-1])
    return alpha_recon * recon + beta * kld, (recon, kld)


def fit_vae(params: Dict, X_batches: torch.Tensor, batch_masks: torch.Tensor,
            X_val: torch.Tensor, gen, beta: float = 0.01,
            alpha_recon: float = 1.0, lr: float = 1e-3, epochs: int = 500,
            X_val_mask: Optional[torch.Tensor] = None,
            deterministic: bool = False):
    """Adam over the fixed minibatches ``X_batches`` [nb, B, D] for
    ``epochs`` epochs; returns (best-validation params, best val loss,
    (per-epoch mean train loss [epochs], val loss [epochs])).

    The best parameters are copied when an epoch's validation loss is
    strictly lower than every earlier one (never aliased to the live,
    still-training tensors)."""
    params = clone_params(params, requires_grad=True)
    opt = torch.optim.Adam(tree_leaves(params), lr=lr)
    if X_val_mask is None:
        X_val_mask = torch.ones(X_val.shape[0], dtype=torch.bool,
                                device=X_val.device)
    best_params, best_val = clone_params(params), float("inf")
    ep_losses, ep_vals = [], []
    for _ in range(epochs):
        losses = []
        for x, m in zip(X_batches, batch_masks):
            loss, _ = masked_vae_loss(params, x, m, gen, beta, alpha_recon,
                                      deterministic)
            opt.zero_grad(set_to_none=False)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            if X_val.shape[0]:
                val, _ = masked_vae_loss(params, X_val, X_val_mask, None,
                                         beta, alpha_recon, deterministic)
            else:
                val = torch.zeros((), device=X_val.device)
        ep_losses.append(torch.stack(losses).mean())
        ep_vals.append(val)
        v = float(val)
        if v < best_val:
            best_val, best_params = v, clone_params(params)
    history = (torch.stack(ep_losses), torch.stack(ep_vals))
    return best_params, best_val, history


def batchify(X: torch.Tensor, batch_size: int, n_valid=None):
    """Pad to a multiple of batch_size and reshape to [nb, B, D] + masks.
    ``n_valid`` treats trailing rows beyond it as padding too."""
    n, d = X.shape
    nb = max(1, -(-n // batch_size))
    pad = nb * batch_size - n
    Xp = torch.cat([X, X.new_zeros((pad, d))]) if pad else X
    mask = torch.arange(nb * batch_size, device=X.device) < (
        n if n_valid is None else min(n, n_valid))
    return Xp.reshape(nb, batch_size, d), mask.reshape(nb, batch_size)


def train_vae(gen, X_train: torch.Tensor, X_val: torch.Tensor,
              latent_dim: int = 64, hidden_dim: int = 256, lr: float = 1e-3,
              beta: float = 0.01, alpha_recon: float = 1.0,
              epochs: int = 500, batch_size: int = 512,
              X_val_mask=None, deterministic: bool = False):
    """Initialize and pretrain a VAE (see :func:`fit_vae`); ``gen`` draws
    the initial parameters, then the reparameterization noise."""
    params = init_vae_params(gen, X_train.shape[-1], latent_dim, hidden_dim,
                             X_train.device)
    Xb, mb = batchify(X_train, batch_size)
    best_params, best_val, history = fit_vae(
        params, Xb, mb, X_val, gen, beta=beta, alpha_recon=alpha_recon,
        lr=lr, epochs=epochs, X_val_mask=X_val_mask,
        deterministic=deterministic)
    return best_params, {"best_val": best_val, "history": history}
