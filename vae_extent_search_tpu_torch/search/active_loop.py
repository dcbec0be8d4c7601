"""The VAE-extent active-learning search loop, offline record-replay arm
(counterpart of ``vae_extent_search_tpu/search/active_loop.py``).

Init with ``measure_size`` random candidates, then per phase: retrain the
latent cost predictor on the measured set, select the next batch
(``select_programs``), reveal the recorded costs, and stop once the
true-best candidate is in the measured set.

Randomness: the initial measured set and the VAE's train/validation
split are numpy draws (``default_rng(sampling_seed)`` and
``default_rng(train_seed)``), exactly as in the JAX package, so both
packages start from the same measured set. Everything else draws from
explicit torch Generators on the run's device, seeded from
``train_seed`` (VAE pretraining; predictor init and training) and
``sampling_seed`` (selection).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.metrics import metric_r_squared, recall_at_k
from ..models.predictor import (
    PredictorConfig,
    fit_predictor,
    init_predictor_params,
    load_pretrained_encoder,
    pred_forward,
)
from ..models.vae import train_vae
from .select import SelectionConfig, select_programs

# Generator streams derived from one seed (numpy SeedSequence spawn keys)
_VAE_STREAM, _PHASE_STREAM, _SELECT_STREAM = 0, 1, 2


def make_generator(seed: int, stream: int, device) -> torch.Generator:
    """An explicit torch Generator on ``device`` for stream ``stream`` of
    ``seed``; distinct streams of one seed are independent."""
    s = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def standardize(X: np.ndarray):
    """log1p + per-column standardization."""
    Xl = np.log1p(X.astype(np.float32))
    mean = Xl.mean(axis=0)
    std = Xl.std(axis=0)
    std = np.where(std < 1e-12, 1.0, std)
    return (Xl - mean) / std, (mean, std)


def _prepare_pool(features: np.ndarray, labels: np.ndarray, device):
    """Standardize the candidate pool and move it to ``device`` once;
    shared by ``run_active_search`` and ``pretrain_pool_vae`` so both see
    identical inputs."""
    X_scaled, _ = standardize(features)
    X = torch.as_tensor(X_scaled, dtype=torch.float32).to(device)
    y = torch.as_tensor(np.asarray(labels, np.float32)).to(device)
    return X, y


def _train_pool_vae(X: torch.Tensor, gen, train_seed: int, latent_dim: int,
                    hidden_dim: int, vae_lr: float, vae_beta: float,
                    vae_epochs: int, deterministic: bool = False):
    """VAE pretraining on the prepared pool, 80/20 split."""
    N = X.shape[0]
    perm = np.random.default_rng(train_seed).permutation(N)
    n_tr = int(N * 0.8)
    perm = torch.as_tensor(perm, device=X.device)
    vae_params, _ = train_vae(
        gen, X[perm[:n_tr]], X[perm[n_tr:]], latent_dim=latent_dim,
        hidden_dim=hidden_dim, lr=vae_lr, beta=vae_beta, epochs=vae_epochs,
        deterministic=deterministic)
    return vae_params


def pretrain_pool_vae(features: np.ndarray, latent_dim: int = 64,
                      hidden_dim: int = 256, vae_epochs: int = 500,
                      vae_lr: float = 1e-3, vae_beta: float = 0.01,
                      train_seed: int = 2023, deterministic: bool = False,
                      device="cuda"):
    """Pretrain the pool VAE once, to be shared by every sampling seed of
    an experiment (pass it as ``run_active_search(pretrained_vae_params=
    ...)``). Same inputs and Generator stream as ``run_active_search``
    would use to train it itself."""
    device = resolve_device(device)
    X, _ = _prepare_pool(features, np.zeros(features.shape[0], np.float32),
                         device)
    return _train_pool_vae(X, make_generator(train_seed, _VAE_STREAM, device),
                           train_seed, latent_dim, hidden_dim, vae_lr,
                           vae_beta, vae_epochs, deterministic)


@dataclass
class ActiveSearchResult:
    found: bool
    phase: int
    train_size: int
    used_time: float
    reg_r2_history: List[float] = field(default_factory=list)
    top1_hits: List[int] = field(default_factory=list)
    selected_order: List[int] = field(default_factory=list)
    # does the FINAL model's top-k prediction over the whole pool contain
    # the true optimum (a model-quality recall, not the search's found
    # rate); None when the optimum was hit before any model was trained
    final_recall_topk: Optional[int] = None
    # full-pool rank (1 = argmax) the final model gives the true optimum
    final_optimum_rank: Optional[int] = None
    # host seconds per phase spent retraining the predictor and selecting
    # (each ends in a device sync: a host fetch of its result)
    fit_seconds: List[float] = field(default_factory=list)
    select_seconds: List[float] = field(default_factory=list)


def run_active_search(
    features: np.ndarray,
    labels: np.ndarray,
    measure_size: int = 64,
    max_phases: int = 60,
    latent_dim: int = 64,
    hidden_dim: int = 256,
    vae_epochs: int = 500,
    vae_lr: float = 1e-3,
    vae_beta: float = 0.01,
    reg_epochs: int = 1000,
    reg_config=None,
    selection: Optional[SelectionConfig] = None,
    sampling_seed: int = 2000,
    train_seed: int = 2023,
    stop_top_k: int = 1,
    pretrained_vae_params=None,
    encoder_mode: str = "vae",
    verbose: bool = False,
    device="cuda",
) -> ActiveSearchResult:
    """Search until the true-best schedule is measured.

    features: [N, D] raw extent features; labels: [N] (-log mean cost,
    higher is better). ``encoder_mode``: "vae" (VAE pretrain + cost
    predictor, the headline experiment) or "ae" (plain-autoencoder
    ablation: deterministic reconstruction-only pretrain, no KL
    anywhere). The initial measured set is ``measure_size`` random
    candidates."""
    if encoder_mode not in ("vae", "ae"):
        raise ValueError(f"unknown encoder_mode {encoder_mode!r}")
    device = resolve_device(device)
    t0 = time.time()
    N = features.shape[0]
    X, y_all = _prepare_pool(features, labels, device)

    true_best = int(np.argmax(labels))
    true_top_set = set(np.argsort(-labels)[:stop_top_k].tolist())

    if pretrained_vae_params is None:
        vae_params = _train_pool_vae(
            X, make_generator(train_seed, _VAE_STREAM, device), train_seed,
            latent_dim, hidden_dim, vae_lr,
            0.0 if encoder_mode == "ae" else vae_beta, vae_epochs,
            deterministic=encoder_mode == "ae")
    else:
        vae_params = pretrained_vae_params

    rng = np.random.default_rng(sampling_seed)
    init_idx = rng.choice(N, size=min(measure_size, N), replace=False)
    used_mask = np.zeros(N, bool)
    used_mask[init_idx] = True
    selected_order = list(init_idx)

    sel_cfg = selection or SelectionConfig(num_select=measure_size)
    result = ActiveSearchResult(False, 0, 0, 0.0)
    if true_top_set & set(init_idx.tolist()):
        result.found = True
        result.train_size = int(used_mask.sum())
        result.used_time = time.time() - t0
        result.selected_order = selected_order
        return result

    used = torch.as_tensor(used_mask, device=device)
    remaining = ~used

    if reg_config is None:
        pred_cfg = PredictorConfig()
    elif isinstance(reg_config, PredictorConfig):
        pred_cfg = reg_config
    else:
        pred_cfg = PredictorConfig(**reg_config)
    if encoder_mode == "ae":
        pred_cfg = pred_cfg._replace(beta=0.0)  # no KL in the AE arm

    # compact measured-set ring buffer for the diversity stage
    center_buf = np.zeros(sel_cfg.max_centers, np.int64)
    center_n = min(len(selected_order), sel_cfg.max_centers)
    center_buf[:center_n] = selected_order[:center_n]
    center_pos = torch.arange(sel_cfg.max_centers, device=device)

    g_phase = make_generator(train_seed, _PHASE_STREAM, device)
    g_sel = make_generator(sampling_seed, _SELECT_STREAM, device)
    labels_np = np.asarray(labels)
    for phase in range(1, max_phases + 1):
        # retrain the predictor on the measured rows only (the masked
        # full-pool loss over them is the same function)
        t_fit = time.perf_counter()
        params = init_predictor_params(g_phase, X.shape[1], hidden_dim,
                                       latent_dim, device=device)
        params = load_pretrained_encoder(params, vae_params)
        midx = torch.as_tensor(np.asarray(selected_order), device=device)
        params, _ = fit_predictor(params, X[midx], y_all[midx], None,
                                  g_phase, pred_cfg, reg_epochs)
        result.fit_seconds.append(time.perf_counter() - t_fit)

        with torch.no_grad():
            all_pred = pred_forward(params, X)[0].float().cpu().numpy()
        rem_np = remaining.cpu().numpy()
        result.reg_r2_history.append(
            metric_r_squared(all_pred[rem_np], labels_np[rem_np]))
        result.final_recall_topk = recall_at_k(all_pred, labels_np,
                                               k=stop_top_k)
        result.final_optimum_rank = int(
            np.sum(all_pred > all_pred[true_best])) + 1

        t_sel = time.perf_counter()
        gate = len(selected_order) < sel_cfg.uncertainty_topk
        with torch.no_grad():
            sel_idx, sel_valid, remaining, _ = select_programs(
                params, X, used, remaining, g_sel, sel_cfg,
                gate_uncertainty_to_remaining=gate,
                center_idx=torch.as_tensor(center_buf, device=device),
                center_valid=center_pos < min(center_n, sel_cfg.max_centers))
        sel = sel_idx.cpu().numpy()[sel_valid.cpu().numpy()]
        result.select_seconds.append(time.perf_counter() - t_sel)
        used[torch.as_tensor(sel, device=device)] = True
        selected_order.extend(sel.tolist())
        # ring buffer: when capacity binds, the oldest centers go
        for i in sel.tolist():
            center_buf[center_n % sel_cfg.max_centers] = i
            center_n += 1

        if verbose:
            print(f"phase {phase}: +{len(sel)} measured "
                  f"(total {len(selected_order)}), "
                  f"val R2 {result.reg_r2_history[-1]:.3f}")
        hit = bool(true_top_set & set(sel.tolist()))
        result.top1_hits.append(int(hit))
        result.phase = phase
        if hit:
            result.found = True
            break

    result.train_size = int(used.sum())
    result.used_time = time.time() - t0
    result.selected_order = selected_order
    return result
