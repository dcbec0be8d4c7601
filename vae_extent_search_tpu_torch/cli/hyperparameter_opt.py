"""Hyperparameter optimisation of the cost models (counterpart of
``scripts/hyperparameter_opt.py``).

Parity: reference scripts/nni_hyperparameter_opt.py and
lightgbm_bayesian_hyperparameter_opt.py, as the JAX script re-implements
them without NNI or bayes_opt: ``--algo local`` is random search then
greedy refinement over neighbouring values; ``--algo tpe`` a categorical
Tree-structured Parzen Estimator (NNI's default tuner): after the startup
trials the trials split into the top-gamma "good" set and the rest, each
parameter's densities l(x) and g(x) are estimated with add-one smoothing,
and the next trial is the sampled candidate of highest l/g; ``--algo gp``
Gaussian-process Bayesian optimisation over a continuous box (bayes_opt's
BayesianOptimization: a Matern-2.5 GP posterior and kappa-UCB
acquisition), run with ``--model lgbm`` as the reference's lightgbm
tuning flow (probe the tuned defaults, init_points random trials, n_iter
GP-guided trials, maximise -RMSE, save ``lightgbm_tuned.pkl`` —
lightgbm_bayesian_hyperparameter_opt.py:96-186). Every optimiser is numpy
and ``random.Random(seed)``, so a seed gives the JAX script's trials where
the models' metrics agree. Categorical spaces report the metric the
reference optimises (weighted peak score@1 by default).

    python -m vae_extent_search_tpu_torch.cli.hyperparameter_opt \\
        --dataset dataset.pkl --model mlp --algo local --n-random 4

Each trial trains through ``cli.train_model``'s models and scores with its
``evaluate_model``. Runs on CUDA by default (the MLP's segment sums through
the kernels, the trees on the device engine from 200,000 rows);
``--device cpu`` runs on the CPU.
"""

import argparse
import pickle
import random

import numpy as np

from ..data.dataset import Dataset
from .train_model import evaluate_model

SPACES = {
    "mlp": {
        "hidden_dim": [128, 256, 512],
        "lr": [3e-4, 7e-4, 1.5e-3],
        "loss_type": ["lambdaRank", "rankNet", "rmse"],
        "batch_size": [256, 512],
        "grad_clip": [0.25, 0.5, 1.0],
    },
    "gbdt": {
        "max_depth": [4, 6, 8, 10],
        "learning_rate": [0.05, 0.1, 0.2, 0.3],
        "n_estimators": [100, 300, 600],
    },
}


def build(model_kind, cfg, in_dim, device="cuda"):
    if model_kind == "mlp":
        from ..models.segment import MLPModelInternal

        return MLPModelInternal(in_dim=in_dim, device=device, **cfg)
    from ..models.gbdt import GBDTModelInternal

    return GBDTModelInternal(device=device, **cfg)


def sample(space, rng):
    return {k: rng.choice(v) for k, v in space.items()}


class TPE:
    """Categorical Tree-structured Parzen Estimator (Bergstra et al.
    2011, the NNI default): argmax over candidates of the likelihood
    ratio l(x)/g(x) between good-trial and bad-trial densities."""

    def __init__(self, space, rng, gamma=0.25, n_candidates=24,
                 n_startup=4, explore=0.15):
        self.space = space
        self.rng = rng
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        # per-parameter uniform-exploration probability: pure l/g argmax
        # re-samples the incumbent once one good trial dominates
        self.explore = explore
        self.history = []  # (cfg, value)

    def tell(self, cfg, value):
        self.history.append((cfg, value))

    def _density(self, cfgs, key):
        vals = self.space[key]
        counts = {v: 1.0 for v in vals}  # add-one smoothing prior
        for cfg, _ in cfgs:
            counts[cfg[key]] += 1.0
        total = sum(counts.values())
        return {v: c / total for v, c in counts.items()}

    def ask(self):
        if len(self.history) < self.n_startup:
            return sample(self.space, self.rng)
        ranked = sorted(self.history, key=lambda t: -t[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        good, bad = ranked[:n_good], ranked[n_good:]
        l_d = {k: self._density(good, k) for k in self.space}
        g_d = {k: self._density(bad, k) for k in self.space}
        seen = {tuple(sorted(c.items())) for c, _ in self.history}
        best_cfg, best_ratio = None, -1.0
        best_new, best_new_ratio = None, -1.0
        for _ in range(self.n_candidates):
            # sample from l (good density) per parameter
            cfg = {}
            for k, vals in self.space.items():
                if self.rng.random() < self.explore:
                    cfg[k] = self.rng.choice(vals)
                else:
                    weights = [l_d[k][v] for v in vals]
                    cfg[k] = self.rng.choices(vals, weights=weights)[0]
            ratio = 1.0
            for k in self.space:
                ratio *= l_d[k][cfg[k]] / g_d[k][cfg[k]]
            if ratio > best_ratio:
                best_cfg, best_ratio = cfg, ratio
            if tuple(sorted(cfg.items())) not in seen \
                    and ratio > best_new_ratio:
                best_new, best_new_ratio = cfg, ratio
        # prefer the best UNSEEN candidate: re-running a measured trial
        # wastes the budget (the objective is deterministic here)
        return best_new if best_new is not None else best_cfg


# continuous box space of the reference's lightgbm bayesian tuning
# (lightgbm_bayesian_hyperparameter_opt.py:113-121) and its probed
# default point (:126-136)
LGBM_BOUNDS = {
    "learning_rate": (0.02, 0.2),
    "num_leaves": (24, 80),
    "feature_fraction": (0.6, 1.0),
    "bagging_fraction": (0.7, 1.0),
    "bagging_freq": (3, 10),
    "min_data_in_leaf": (0, 40),
    "min_sum_hessian_in_leaf": (0, 20),
}
LGBM_PROBE = {
    "learning_rate": 0.05,
    "num_leaves": 31,
    "feature_fraction": 0.9,
    "bagging_fraction": 0.8,
    "bagging_freq": 5,
    "min_data_in_leaf": 0,
    "min_sum_hessian_in_leaf": 0,
}


def proc_lgbm_params(params: dict) -> dict:
    """Round/clamp a continuous point into lightgbm params (reference
    proc_params / lgb_eval coercions :96-105,147-157)."""
    p = dict(params)
    p["learning_rate"] = max(min(p["learning_rate"], 1.0), 0.0)
    p["num_leaves"] = int(round(p["num_leaves"]))
    p["feature_fraction"] = max(min(p["feature_fraction"], 1.0), 0.0)
    p["bagging_fraction"] = max(min(p["bagging_fraction"], 1.0), 0.0)
    p["bagging_freq"] = int(round(p["bagging_freq"]))
    p["min_data_in_leaf"] = int(round(p["min_data_in_leaf"]))
    return p


class GPUCB:
    """Gaussian-process upper-confidence-bound Bayesian optimization
    over a continuous box — the optimizer bayes_opt's
    BayesianOptimization runs (Matern-2.5 kernel GP posterior, UCB
    acquisition with kappa=2.576, acquisition maximized from random
    starts), self-contained in numpy.

    Inputs are normalized to the unit box and targets to zero mean /
    unit std before fitting; ``probe`` queues exact points to evaluate
    first (the reference probes the tuned lightgbm defaults lazily)."""

    def __init__(self, bounds: dict, rng, kappa: float = 2.576,
                 alpha: float = 1e-6, length_scale: float = 0.35,
                 n_acq: int = 2048, init_points: int = 2):
        self.keys = list(bounds)
        self.lo = np.array([bounds[k][0] for k in self.keys], float)
        self.hi = np.array([bounds[k][1] for k in self.keys], float)
        self.rng = rng
        self.kappa = kappa
        self.alpha = alpha
        self.ls = length_scale
        self.n_acq = n_acq
        self.X: list = []   # normalized points
        self.y: list = []
        self.queue: list = []
        # bayes_opt semantics: init_points uniform-random exploration
        # trials before any GP-guided acquisition (probes don't count)
        self.init_points = max(init_points, 2)
        self._n_random = 0

    def _norm(self, params: dict) -> np.ndarray:
        x = np.array([params[k] for k in self.keys], float)
        return (x - self.lo) / (self.hi - self.lo)

    def _denorm(self, x: np.ndarray) -> dict:
        v = self.lo + x * (self.hi - self.lo)
        return dict(zip(self.keys, v.tolist()))

    def probe(self, params: dict):
        self.queue.append(dict(params))

    def tell(self, params: dict, value: float):
        self.X.append(self._norm(params))
        self.y.append(float(value))

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        # Matern nu=2.5: (1 + sqrt5 r + 5r^2/3) exp(-sqrt5 r)
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        r = np.sqrt(np.maximum(d2, 0.0)) / self.ls
        s5r = np.sqrt(5.0) * r
        return (1.0 + s5r + 5.0 * r * r / 3.0) * np.exp(-s5r)

    def ask(self) -> dict:
        if self.queue:
            return self.queue.pop(0)
        if self._n_random < self.init_points or len(self.X) < 2:
            self._n_random += 1
            x = np.array([self.rng.random() for _ in self.keys])
            return self._denorm(x)
        X = np.asarray(self.X)
        y = np.asarray(self.y)
        ystd = y.std() or 1.0
        yn = (y - y.mean()) / ystd
        K = self._kernel(X, X) + self.alpha * np.eye(len(X))
        L = np.linalg.cholesky(K)
        w = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        # random-start acquisition maximization + exploitation jitter
        # around the incumbent (bayes_opt seeds L-BFGS from randoms)
        cand = np.array([[self.rng.random() for _ in self.keys]
                         for _ in range(self.n_acq)])
        inc = X[int(np.argmax(y))]
        local = inc[None, :] + 0.05 * np.array(
            [[self.rng.gauss(0, 1) for _ in self.keys]
             for _ in range(self.n_acq // 8)])
        cand = np.clip(np.vstack([cand, local]), 0.0, 1.0)
        Ks = self._kernel(cand, X)                      # [m, n]
        mu = Ks @ w
        v = np.linalg.solve(L, Ks.T)                    # [n, m]
        var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
        ucb = mu + self.kappa * np.sqrt(var)
        return self._denorm(cand[int(np.argmax(ucb))])


def neighbors(space, cfg):
    out = []
    for k, vals in space.items():
        i = vals.index(cfg[k])
        for j in (i - 1, i + 1):
            if 0 <= j < len(vals):
                n = dict(cfg)
                n[k] = vals[j]
                out.append(n)
    return out


def tune_lgbm_bayesian(args):
    """The reference lightgbm flow (lightgbm_bayesian_hyperparameter_
    opt.py train_zero_shot): probe the tuned defaults, init_points
    random + n_iter GP-UCB trials maximizing -RMSE on the held-out
    split, then refit the best params and save the tuned model."""
    from ..models.gbdt import LGBModelInternal
    from ..utils.misc import to_str_round

    with open(args.dataset, "rb") as f:
        dataset: Dataset = pickle.load(f)
    train_set, test_set = dataset.random_split_within_task(0.9,
                                                           seed=args.seed)
    if len(test_set) == 0:
        test_set = train_set
    feats, labels, _ = train_set.flatten()

    rng = random.Random(args.seed)
    opt = GPUCB(LGBM_BOUNDS, rng, init_points=args.init_points)
    opt.probe(LGBM_PROBE)

    def score(point: dict) -> float:
        params = proc_lgbm_params(point)
        model = LGBModelInternal(params=params,
                                 n_estimators=args.n_estimators,
                                 seed=args.seed, device=args.device)
        model.fit_base(feats, labels)
        res = evaluate_model(model, test_set)
        print(f"{to_str_round(params)} -> RMSE = {res['RMSE']:.4f}")
        return -res["RMSE"]  # maximize -RMSE (reference lgb_eval)

    best_point, best_val = None, -np.inf
    for _ in range(args.init_points + args.n_iter + 1):  # +1: the probe
        point = opt.ask()
        v = score(point)
        opt.tell(point, v)
        if v > best_val:
            best_point, best_val = point, v

    opt_params = proc_lgbm_params(best_point)
    print("best result:", best_val, opt_params)
    model = LGBModelInternal(params=opt_params,
                             n_estimators=args.n_estimators,
                             seed=args.seed, device=args.device)
    model.fit_base(feats, labels)
    print(f"Save model to {args.out_model}")
    model.save(args.out_model)
    res = evaluate_model(model, test_set)
    print("-" * 60)
    print("Model: lightgbm_tuned")
    print(to_str_round(res))
    return opt_params, best_val


def main(argv=None):
    """The command line; returns (best config, best value), or with
    ``--algo gp`` / ``--model lgbm`` (best params, best -RMSE)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", type=str, default="dataset.pkl")
    p.add_argument("--model", type=str, default="mlp",
                   choices=list(SPACES.keys()) + ["lgbm"])
    p.add_argument("--metric", type=str, default="average peak score@1")
    p.add_argument("--algo", type=str, default="local",
                   choices=["local", "tpe", "gp"])
    p.add_argument("--n-random", type=int, default=8)
    p.add_argument("--n-local", type=int, default=6)
    p.add_argument("--n-trials", type=int, default=24,
                   help="total TPE trials (--algo tpe)")
    p.add_argument("--init-points", type=int, default=15,
                   help="random exploration trials before the GP takes "
                        "over (--algo gp; reference maximize "
                        "init_points=15)")
    p.add_argument("--n-iter", type=int, default=15,
                   help="GP-guided trials (--algo gp; reference "
                        "n_iter=15)")
    p.add_argument("--n-estimators", type=int, default=300)
    p.add_argument("--out-model", type=str, default="lightgbm_tuned.pkl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.model == "lgbm" or args.algo == "gp":
        return tune_lgbm_bayesian(args)

    with open(args.dataset, "rb") as f:
        dataset: Dataset = pickle.load(f)
    train_set, test_set = dataset.random_split_within_task(0.9,
                                                           seed=args.seed)
    feats, labels, _ = train_set.flatten()
    in_dim = feats[0].shape[1] if feats else 164

    rng = random.Random(args.seed)
    space = SPACES[args.model]
    tried = {}

    def score(cfg):
        key = tuple(sorted(cfg.items()))
        if key in tried:
            return tried[key]
        model = build(args.model, cfg, in_dim, args.device)
        model.fit_base(feats, labels)
        res = evaluate_model(model, test_set)
        val = res[args.metric]
        tried[key] = val
        print(f"{cfg} -> {args.metric} = {val:.4f}")
        return val

    best_cfg, best_val = None, -np.inf
    if args.algo == "tpe":
        tuner = TPE(space, rng)
        for _ in range(args.n_trials):
            cfg = tuner.ask()
            v = score(cfg)
            tuner.tell(cfg, v)
            if v > best_val:
                best_cfg, best_val = cfg, v
        print(f"BEST: {best_cfg} -> {args.metric} = {best_val:.4f}")
        return best_cfg, best_val

    for _ in range(args.n_random):
        cfg = sample(space, rng)
        v = score(cfg)
        if v > best_val:
            best_cfg, best_val = cfg, v

    for _ in range(args.n_local):
        improved = False
        for cand in neighbors(space, best_cfg):
            v = score(cand)
            if v > best_val:
                best_cfg, best_val = cand, v
                improved = True
        if not improved:
            break

    print(f"BEST: {best_cfg} -> {args.metric} = {best_val:.4f}")
    return best_cfg, best_val


if __name__ == "__main__":
    main()
