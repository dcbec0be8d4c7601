"""The VAE-extent active-learning search loop, offline record-replay arm
(counterpart of ``vae_extent_search_tpu/search/active_loop.py``).

Init with ``measure_size`` random candidates, then per phase: retrain the
latent cost predictor on the measured set, select the next batch
(``select_programs``), reveal the recorded costs, and stop once the
true-best candidate is in the measured set. ``run_gbdt_baseline_search``
is the tree-model baseline arm of the same experiment, and
``run_active_search_online`` the live-measurement arm that the self-tuning
path (``cli/tune_kernel.py``) drives.

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
from ..models.gbdt import GBDTModelInternal
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


class _ModelPhase:
    """One phase of the model-guided selection, shared by the offline and
    the online loop: retrain the cost predictor on the measured rows (the
    JAX package's masked full-pool loss over them is the same function),
    then pick the next batch with ``select_programs``, whose diversity
    stage reads a ring buffer of the measured set (when its capacity
    binds, the oldest centers go)."""

    def __init__(self, X, vae_params, pred_cfg, sel_cfg, hidden_dim,
                 latent_dim, reg_epochs, train_seed, sampling_seed,
                 measured):
        self.X, self.vae_params = X, vae_params
        self.pred_cfg, self.sel_cfg = pred_cfg, sel_cfg
        self.hidden_dim, self.latent_dim = hidden_dim, latent_dim
        self.reg_epochs = reg_epochs
        self.center_buf = np.zeros(sel_cfg.max_centers, np.int64)
        self.center_n = min(len(measured), sel_cfg.max_centers)
        self.center_buf[:self.center_n] = measured[:self.center_n]
        self.center_pos = torch.arange(sel_cfg.max_centers, device=X.device)
        self.g_phase = make_generator(train_seed, _PHASE_STREAM, X.device)
        self.g_sel = make_generator(sampling_seed, _SELECT_STREAM, X.device)

    def fit(self, measured, y):
        """Predictor parameters fitted to labels ``y`` of rows
        ``measured``, from a fresh init with the pretrained encoder."""
        X = self.X
        params = init_predictor_params(self.g_phase, X.shape[1],
                                       self.hidden_dim, self.latent_dim,
                                       device=X.device)
        params = load_pretrained_encoder(params, self.vae_params)
        midx = torch.as_tensor(np.asarray(measured), device=X.device)
        params, _ = fit_predictor(params, X[midx], y, None, self.g_phase,
                                  self.pred_cfg, self.reg_epochs)
        return params

    def select(self, params, used, remaining, n_measured):
        """(pool indices to measure next, the new ``remaining`` mask)."""
        cfg = self.sel_cfg
        with torch.no_grad():
            sel_idx, sel_valid, remaining, _ = select_programs(
                params, self.X, used, remaining, self.g_sel, cfg,
                gate_uncertainty_to_remaining=n_measured
                < cfg.uncertainty_topk,
                center_idx=torch.as_tensor(self.center_buf,
                                           device=self.X.device),
                center_valid=self.center_pos < min(self.center_n,
                                                   cfg.max_centers))
        sel = sel_idx.cpu().numpy()[sel_valid.cpu().numpy()]
        for i in sel.tolist():
            self.center_buf[self.center_n % cfg.max_centers] = i
            self.center_n += 1
        return sel, remaining


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

    step = _ModelPhase(X, vae_params, pred_cfg,
                       selection or SelectionConfig(num_select=measure_size),
                       hidden_dim, latent_dim, reg_epochs, train_seed,
                       sampling_seed, selected_order)
    labels_np = np.asarray(labels)
    for phase in range(1, max_phases + 1):
        t_fit = time.perf_counter()
        params = step.fit(selected_order, y_all[
            torch.as_tensor(np.asarray(selected_order), device=device)])
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
        sel, remaining = step.select(params, used, remaining,
                                     len(selected_order))
        result.select_seconds.append(time.perf_counter() - t_sel)
        used[torch.as_tensor(sel, device=device)] = True
        selected_order.extend(sel.tolist())

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


@dataclass
class OnlineSearchResult:
    best_index: int
    best_label: float
    n_measured: int
    phases: int
    used_time: float
    best_history: List[float] = field(default_factory=list)
    selected_order: List[int] = field(default_factory=list)
    # host seconds: VAE pretraining once, then per phase (the initial
    # draw first) predictor retraining, selection and measurement; each
    # device step ends in a host fetch of its result
    vae_seconds: float = 0.0
    fit_seconds: List[float] = field(default_factory=list)
    select_seconds: List[float] = field(default_factory=list)
    measure_seconds: List[float] = field(default_factory=list)


def run_active_search_online(
    features: np.ndarray,
    measure_fn,
    measure_size: int = 16,
    max_phases: int = 8,
    latent_dim: int = 64,
    hidden_dim: int = 256,
    vae_epochs: int = 500,
    reg_epochs: int = 1000,
    selection: Optional[SelectionConfig] = None,
    sampling_seed: int = 2000,
    train_seed: int = 2023,
    select: str = "model",
    verbose: bool = False,
    device="cuda",
) -> OnlineSearchResult:
    """The ONLINE variant of run_active_search: labels are not known up
    front — ``measure_fn(pool_indices) -> labels`` measures candidates for
    real (higher label = better, the -log-cost convention). This is the
    reference's live-measurement arm (vae_experiments/tune_vae.py:73-166)
    with its selection stub (tuning.py:65-68 picks randomly) replaced by
    the offline arm's selection mix (select_programs); ``select="random"``
    reproduces the stub as a baseline arm and draws only from numpy
    (``default_rng(sampling_seed)``), exactly as the JAX package does, so
    both pick the same candidates in the same order. There is no
    stop-on-optimum (the optimum is unknown): the loop runs the phase
    budget and reports the best measured candidate. The VAE and the
    predictor take their default learning rate, beta and configuration."""
    if select not in ("model", "random"):
        raise ValueError(f"unknown select {select!r}")
    device = resolve_device(device)
    t0 = time.time()
    N = features.shape[0]
    X, _ = _prepare_pool(features, np.zeros(N, np.float32), device)
    result = OnlineSearchResult(0, -np.inf, 0, 0, 0.0)

    rng = np.random.default_rng(sampling_seed)
    init_idx = rng.choice(N, size=min(measure_size, N), replace=False)
    step = None
    if select == "model":
        t = time.perf_counter()
        vae_params = _train_pool_vae(
            X, make_generator(train_seed, _VAE_STREAM, device), train_seed,
            latent_dim, hidden_dim, 1e-3, 0.01, vae_epochs)
        result.vae_seconds = time.perf_counter() - t
        step = _ModelPhase(
            X, vae_params, PredictorConfig(),
            selection or SelectionConfig(num_select=measure_size),
            hidden_dim, latent_dim, reg_epochs, train_seed, sampling_seed,
            init_idx.tolist())

    labels = np.full(N, -1e9, np.float32)  # unmeasured sentinel
    t = time.perf_counter()
    labels[init_idx] = measure_fn(init_idx.tolist())
    result.measure_seconds.append(time.perf_counter() - t)
    used_mask = np.zeros(N, bool)
    used_mask[init_idx] = True
    selected_order = [int(i) for i in init_idx]

    def note_best():
        meas = np.where(used_mask)[0]
        b = meas[np.argmax(labels[meas])]
        result.best_index = int(b)
        result.best_label = float(labels[b])
        result.best_history.append(result.best_label)

    note_best()
    used = torch.as_tensor(used_mask, device=device)
    remaining = ~used
    for phase in range(1, max_phases + 1):
        rem_np = np.where(~used_mask)[0]
        if len(rem_np) == 0:
            break
        if step is None:
            sel = rng.choice(rem_np, size=min(measure_size, len(rem_np)),
                             replace=False)
        else:
            t = time.perf_counter()
            params = step.fit(selected_order, torch.as_tensor(
                labels[selected_order], device=device))
            result.fit_seconds.append(time.perf_counter() - t)
            t = time.perf_counter()
            sel, remaining = step.select(params, used, remaining,
                                         len(selected_order))
            result.select_seconds.append(time.perf_counter() - t)

        t = time.perf_counter()
        labels[sel] = measure_fn([int(i) for i in sel])
        result.measure_seconds.append(time.perf_counter() - t)
        used_mask[sel] = True
        used[torch.as_tensor(np.asarray(sel, np.int64), device=device)] = True
        selected_order.extend(int(i) for i in sel)
        result.phases = phase
        note_best()
        if verbose:
            print(f"phase {phase}: +{len(sel)} measured "
                  f"(total {int(used_mask.sum())}), "
                  f"best label {result.best_label:.4f}")

    result.n_measured = int(used_mask.sum())
    result.used_time = time.time() - t0
    result.selected_order = selected_order
    return result


def run_gbdt_baseline_search(
    features: np.ndarray,
    labels: np.ndarray,
    measure_size: int = 64,
    max_phases: int = 60,
    eps_greedy: float = 0.05,
    sampling_seed: int = 2000,
    stop_top_k: int = 1,
    engine: str = "auto",
    device="cuda",
) -> ActiveSearchResult:
    """The experiment's tree-model baseline arm: per phase, fit a GBDT on
    the measured set and pick 95% predicted-top-k + 5% eps-greedy random
    (reference vae_extent_search.py:843-865,1980-2307 xgb_select_indices
    with XGBoostModelInternal over the same extent features). The rng use
    and stop rule are the JAX package's. ``engine`` and ``device`` go to
    ``GBDTModelInternal``; ``fit_seconds`` holds each phase's host seconds
    of model fitting and prediction."""
    resolve_device(device)
    t0 = time.time()
    N = features.shape[0]
    X = np.log1p(features.astype(np.float32))
    rng = np.random.default_rng(sampling_seed)
    true_top = set(np.argsort(-labels)[:stop_top_k].tolist())

    measured = np.zeros(N, bool)
    init = rng.choice(N, size=min(measure_size, N), replace=False)
    measured[init] = True
    result = ActiveSearchResult(False, 0, 0, 0.0)
    result.selected_order = init.tolist()
    if true_top & set(init.tolist()):
        result.found = True
        result.train_size = int(measured.sum())
        result.used_time = time.time() - t0
        return result

    n_rand = max(1, int(measure_size * eps_greedy))
    n_top = measure_size - n_rand
    for phase in range(1, max_phases + 1):
        t_fit = time.perf_counter()
        tr = np.where(measured)[0]
        model = GBDTModelInternal(n_estimators=100, engine=engine,
                                  device=device)
        model.fit_base([X[i:i + 1] for i in tr], labels[tr])
        preds = model.predict_on_features([X[i:i + 1] for i in range(N)])
        result.fit_seconds.append(time.perf_counter() - t_fit)
        remaining = np.where(~measured)[0]
        order = remaining[np.argsort(-preds[remaining])]
        sel = list(order[:min(n_top, len(order))])
        rest = np.setdiff1d(remaining, sel)
        if len(rest) and n_rand:
            sel.extend(rng.choice(rest, size=min(n_rand, len(rest)),
                                  replace=False).tolist())
        measured[sel] = True
        result.selected_order.extend(int(i) for i in sel)
        result.phase = phase
        result.top1_hits.append(int(bool(true_top & set(sel))))
        result.final_recall_topk = recall_at_k(preds, labels,
                                               k=stop_top_k)
        tb = int(np.argmax(labels))
        result.final_optimum_rank = int(np.sum(preds > preds[tb])) + 1
        if true_top & set(sel):
            result.found = True
            break
        if not (~measured).any():
            break
    result.train_size = int(measured.sum())
    result.used_time = time.time() - t0
    return result
