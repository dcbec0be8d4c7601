"""The VAE-extent active-learning search loop, offline record-replay arm
(counterpart of ``vae_extent_search_tpu/search/active_loop.py``).

Init with ``measure_size`` candidates (random, or representatives of the
VAE's latent space), then per phase: retrain the latent cost predictor on
the measured set, select the next batch
(``select_programs``), reveal the recorded costs, and stop once the
true-best candidate is in the measured set. ``run_gbdt_baseline_search``
is the tree-model baseline arm of the same experiment, and
``run_active_search_online`` the live-measurement arm that the self-tuning
path (``cli/tune_kernel.py``) drives.

Randomness: the random initial measured set and the VAE's
train/validation split are numpy draws (``default_rng(sampling_seed)``
and ``default_rng(train_seed)``), exactly as in the JAX package, so both
packages start from the same measured set. Everything else draws from
explicit torch Generators on the run's device, seeded from
``train_seed`` (VAE pretraining; predictor init and training) and
``sampling_seed`` (selection; the diversity and kmeans inits, on a stream
of their own).

The JAX loop's ``bucket_shapes`` (padding the pool so that XLA compiles
once per bucket) has no counterpart: eager torch does not recompile per
shape.

``mesh`` (``parallel/mesh.py``) splits the pool's rows over the ranks of
its "data" axis: the pool is padded to a multiple of that size (padded
rows are never remaining), each rank keeps its row block on its device,
and selection runs on the sharded path (``search/select_sharded.py``).
The measured set and the VAE's 80/20 split are gathered
(``gather_rows_sharded``) and training runs replicated on every rank from
the same Generator seeds, which leaves every rank with the same
parameters (a digest check after each training confirms it); the
full-pool prediction for R2 and recall is computed on each rank's rows
and gathered. Every rank returns the same result.
"""

from __future__ import annotations

import csv
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import make_generator, resolve_device
from ..models.gbdt import GBDTModelInternal
from ..models.metrics import metric_r_squared, recall_at_k
from ..models.predictor import (
    PredictorConfig,
    fit_predictor,
    init_predictor_params,
    load_pretrained_encoder,
    pred_forward,
)
from ..models.vae import train_vae, vae_encode
from .select import (
    SelectionConfig,
    farthest_point_init,
    kmeans_representative_init,
    select_programs,
)

# Generator streams derived from one seed (numpy SeedSequence spawn keys)
_VAE_STREAM, _PHASE_STREAM, _SELECT_STREAM, _INIT_STREAM = 0, 1, 2, 3


def standardize(X: np.ndarray):
    """log1p + per-column standardization."""
    Xl = np.log1p(X.astype(np.float32))
    mean = Xl.mean(axis=0)
    std = Xl.std(axis=0)
    std = np.where(std < 1e-12, 1.0, std)
    return (Xl - mean) / std, (mean, std)


def _prepare_pool(features: np.ndarray, labels: np.ndarray, device,
                  mesh=None):
    """Standardize the candidate pool and move it to ``device`` once;
    shared by ``run_active_search`` and ``pretrain_pool_vae`` so both see
    identical inputs. With a ``mesh``: padded with zero rows (label -1e9)
    to a multiple of its "data" size, and this rank's row blocks on the
    mesh's device."""
    X_scaled, _ = standardize(features)
    X = torch.as_tensor(X_scaled, dtype=torch.float32)
    y = torch.as_tensor(np.asarray(labels, np.float32))
    if mesh is None:
        return X.to(device), y.to(device)
    from ..parallel.mesh import shard_batch

    pad = -X.shape[0] % mesh.shape["data"]
    if pad:
        X = torch.cat([X, X.new_zeros(pad, X.shape[1])])
        y = torch.cat([y, y.new_full((pad,), -1e9)])
    return shard_batch(X, mesh), shard_batch(y, mesh)


def _rows(X: torch.Tensor, idx, mesh) -> torch.Tensor:
    """``X[idx]`` (global indices), gathered across ranks with a mesh."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                          device=X.device)
    if mesh is None:
        return X[idx]
    from .select_sharded import gather_rows_sharded

    return gather_rows_sharded(X, idx, mesh)


def _check_replicated(params, mesh, what: str) -> None:
    """Raise unless every rank holds bit-identical ``params``."""
    from ..parallel.mesh import digest

    if mesh is not None and not digest(params, mesh):
        raise RuntimeError(f"{what}: the ranks' parameters differ")


def _train_pool_vae(X: torch.Tensor, gen, train_seed: int, latent_dim: int,
                    hidden_dim: int, vae_lr: float, vae_beta: float,
                    vae_epochs: int, deterministic: bool = False, N=None,
                    mesh=None):
    """VAE pretraining on the prepared pool (its first ``N`` rows), 80/20
    split."""
    N = X.shape[0] if N is None else N
    perm = np.random.default_rng(train_seed).permutation(N)
    n_tr = int(N * 0.8)
    vae_params, _ = train_vae(
        gen, _rows(X, perm[:n_tr], mesh), _rows(X, perm[n_tr:], mesh),
        latent_dim=latent_dim, hidden_dim=hidden_dim, lr=vae_lr,
        beta=vae_beta, epochs=vae_epochs, deterministic=deterministic)
    _check_replicated(vae_params, mesh, "VAE pretraining")
    return vae_params


def pretrain_pool_vae(features: np.ndarray, latent_dim: int = 64,
                      hidden_dim: int = 256, vae_epochs: int = 500,
                      vae_lr: float = 1e-3, vae_beta: float = 0.01,
                      train_seed: int = 2023, deterministic: bool = False,
                      device="cuda", mesh=None):
    """Pretrain the pool VAE once, to be shared by every sampling seed of
    an experiment (pass it as ``run_active_search(pretrained_vae_params=
    ...)``). Same inputs and Generator stream as ``run_active_search``
    would use to train it itself; with a ``mesh`` every rank trains the
    same parameters from the gathered split."""
    device = resolve_device(mesh.device if mesh is not None else device)
    X, _ = _prepare_pool(features, np.zeros(features.shape[0], np.float32),
                         device, mesh)
    return _train_pool_vae(X, make_generator(train_seed, _VAE_STREAM, device),
                           train_seed, latent_dim, hidden_dim, vae_lr,
                           vae_beta, vae_epochs, deterministic,
                           features.shape[0], mesh)


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
                 measured, mesh=None):
        self.X, self.vae_params, self.mesh = X, vae_params, mesh
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
        ``measured``, from a fresh init with the pretrained encoder (none
        in the VIB arm). A profiler trace shows it as "fit_predictor"."""
        X = self.X
        with torch.profiler.record_function("fit_predictor"):
            params = init_predictor_params(self.g_phase, X.shape[1],
                                           self.hidden_dim, self.latent_dim,
                                           device=X.device)
            if self.vae_params is not None:
                params = load_pretrained_encoder(params, self.vae_params)
            params, _ = fit_predictor(params, _rows(X, measured, self.mesh),
                                      y, None, self.g_phase, self.pred_cfg,
                                      self.reg_epochs)
        _check_replicated(params, self.mesh, "predictor fit")
        return params

    def select(self, params, used, remaining, n_measured):
        """(pool indices to measure next, the new ``remaining`` mask)."""
        cfg = self.sel_cfg
        with torch.no_grad(), torch.profiler.record_function(
                "select_programs"):
            sel_idx, sel_valid, remaining, _ = select_programs(
                params, self.X, used, remaining, self.g_sel, cfg,
                gate_uncertainty_to_remaining=n_measured
                < cfg.uncertainty_topk,
                center_idx=torch.as_tensor(self.center_buf,
                                           device=self.X.device),
                center_valid=self.center_pos < min(self.center_n,
                                                   cfg.max_centers),
                mesh=self.mesh)
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
    init_mode: str = "random",
    encoder_mode: str = "vae",
    verbose: bool = False,
    device="cuda",
    mesh=None,
) -> ActiveSearchResult:
    """Search until the true-best schedule is measured.

    features: [N, D] raw extent features; labels: [N] (-log mean cost,
    higher is better). ``encoder_mode``:
      - "vae": VAE pretrain + cost predictor (the headline experiment);
      - "ae": plain-autoencoder ablation, a deterministic
        reconstruction-only pretrain and no KL anywhere;
      - "vib": variational information bottleneck, no pretrain: encoder
        and head train jointly each phase from a fresh init, with a
        sampled z, the smooth-L1 term and the cosine KL warm-up, the
        encoder at the head's learning rate.
    ``init_mode`` picks the initial ``measure_size`` candidates: "random"
    (numpy, as the JAX package draws them), "diversity"
    (``farthest_point_init``) or "kmeans" (``kmeans_representative_init``)
    on the pretrained VAE's mean latents, in pick order. "vib" takes
    "random" only: it has no pretrained latent space. ``mesh`` splits the
    pool over its "data" ranks (each rank runs this function; the module
    docstring says how), on the mesh's device."""
    if encoder_mode not in ("vae", "ae", "vib"):
        raise ValueError(f"unknown encoder_mode {encoder_mode!r}")
    if init_mode not in ("random", "diversity", "kmeans"):
        raise ValueError(f"unknown init_mode {init_mode!r}")
    if encoder_mode == "vib" and init_mode != "random":
        raise ValueError("vib has no pretrained latent space for "
                         "diversity/kmeans init; use init_mode='random'")
    device = resolve_device(mesh.device if mesh is not None else device)
    t0 = time.time()
    N = features.shape[0]
    X, y_all = _prepare_pool(features, labels, device, mesh)

    true_best = int(np.argmax(labels))
    true_top_set = set(np.argsort(-labels)[:stop_top_k].tolist())

    if encoder_mode == "vib":
        vae_params = None
    elif pretrained_vae_params is None:
        vae_params = _train_pool_vae(
            X, make_generator(train_seed, _VAE_STREAM, device), train_seed,
            latent_dim, hidden_dim, vae_lr,
            0.0 if encoder_mode == "ae" else vae_beta, vae_epochs,
            deterministic=encoder_mode == "ae", N=N, mesh=mesh)
    else:
        vae_params = pretrained_vae_params

    k = min(measure_size, N)
    if init_mode == "random":
        init_idx = np.random.default_rng(sampling_seed).choice(
            N, size=k, replace=False)
    else:
        g_init = make_generator(sampling_seed, _INIT_STREAM, device)
        with torch.no_grad():
            mu_all, _ = vae_encode(vae_params, _rows(X, np.arange(N), mesh))
            if init_mode == "diversity":
                pick = farthest_point_init(
                    g_init, mu_all, torch.ones(N, dtype=torch.bool,
                                               device=device), k)
            else:
                pick = kmeans_representative_init(g_init, mu_all, k)
        init_idx = pick.cpu().numpy()
        if len(set(init_idx.tolist())) != k:
            raise RuntimeError(f"{init_mode} init picked a candidate twice: "
                               f"{init_idx.tolist()}")
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

    N_pad = N if mesh is None else N + (-N % mesh.shape["data"])
    lo, hi = 0, N_pad
    if mesh is not None:
        n_loc = N_pad // mesh.shape["data"]
        lo = mesh.index("data") * n_loc
        hi = lo + n_loc
    used_full = np.zeros(N_pad, bool)
    used_full[init_idx] = True
    used = torch.as_tensor(used_full[lo:hi], device=device)
    # padded rows are neither measured nor selectable
    remaining = torch.as_tensor((~used_full & (np.arange(N_pad) < N))[lo:hi],
                                device=device)

    if reg_config is None:
        pred_cfg = PredictorConfig()
    elif isinstance(reg_config, PredictorConfig):
        pred_cfg = reg_config
    else:
        pred_cfg = PredictorConfig(**reg_config)
    if encoder_mode == "ae":
        pred_cfg = pred_cfg._replace(beta=0.0)  # no KL in the AE arm
    elif encoder_mode == "vib":
        pred_cfg = pred_cfg._replace(
            stochastic_z=True, huber_reg=True, kld_cosine_warmup=True,
            encoder_lr=pred_cfg.head_lr)

    step = _ModelPhase(X, vae_params, pred_cfg, sel_cfg, hidden_dim,
                       latent_dim, reg_epochs, train_seed, sampling_seed,
                       selected_order, mesh)
    labels_np = np.asarray(labels)

    def fetch(t):
        """The first N global rows of a row-sharded ``t``, on the host."""
        if mesh is None:
            return t.cpu().numpy()
        from ..parallel.mesh import host

        return host(t, mesh)[:N]

    for phase in range(1, max_phases + 1):
        t_fit = time.perf_counter()
        params = step.fit(selected_order, _rows(y_all, selected_order, mesh))
        result.fit_seconds.append(time.perf_counter() - t_fit)

        with torch.no_grad():
            all_pred = fetch(pred_forward(params, X)[0].float())
        rem_np = fetch(remaining)
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
        mine = sel[(sel >= lo) & (sel < hi)] - lo
        used[torch.as_tensor(mine, device=device)] = True
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

    result.train_size = len(selected_order)
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


def expand_hyper_grid(grid: Dict, filters=None) -> List[Dict]:
    """Cartesian product of a dict-of-lists hyperparameter grid, in the
    grid's key order, keeping the rows every filter accepts."""
    keys = list(grid.keys())
    rows = []
    for values in itertools.product(*(grid[k] for k in keys)):
        row = dict(zip(keys, values))
        if filters and not all(f(row) for f in filters):
            continue
        rows.append(row)
    return rows


def filter_already_measured(rows: List[Dict], total_csv: str,
                            key_fields: List[str]) -> List[Dict]:
    """Drop the rows whose ``key_fields`` (compared as strings) already
    appear in the accumulated result CSV ``total_csv``."""
    if not os.path.exists(total_csv):
        return rows
    with open(total_csv, newline="") as f:
        seen = {tuple(str(rec.get(k)) for k in key_fields)
                for rec in csv.DictReader(f)}
    return [row for row in rows
            if tuple(str(row.get(k)) for k in key_fields) not in seen]
