"""Gradient-boosted-tree cost model (counterpart of
``vae_extent_search_tpu/models/gbdt.py``, native backend).

Parity target: cost_model/xgb_model.py XGBModelInternal — XGBoost over
per-store rows with the pack-sum trick (each store row is one tree sample;
a program's score is the sum over its pack; custom objective
pack_sum_square_error :528, eval pack_sum_rmse :558 / average peak score
:579; params depth 6, eta 0.2 :138-149).

The port runs that protocol on the in-repo booster only: ``backend``
"auto", "xgb", "lgb" and "native" all mean it (the JAX package resolves
"xgb"/"lgb" to it too when the libraries are absent). The trees grow on
the numpy engine (``models/boost.py``) or the device engine
(``models/boost_device.py``); see ``GBDTModelInternal``'s ``engine``.
"""

from __future__ import annotations

import functools
import pickle
from typing import List, Optional

import numpy as np

from ..device import resolve_device
from . import boost, boost_device


def _invalid_rows_mask(model, features_list):
    """Unlowerable states arrive as all-zero feature matrices
    (feature.py:114-116 / mlp_model.py:842-845 -> score -inf). The
    workload-embedding columns are appended AFTER that convention, so
    only the base columns decide validity."""
    emb = (
        getattr(model, "workload_embed_total_dim", 0)
        if getattr(model, "use_workload_embedding", False) else 0
    )
    out = []
    for f in features_list:
        base = f[:, : f.shape[1] - emb] if emb and len(f) else f
        out.append(len(f) == 0 or not np.any(base))
    return out


def _pack_ids(features_list) -> np.ndarray:
    ids = []
    for i, f in enumerate(features_list):
        ids.extend([i] * len(f))
    return np.asarray(ids, np.int64)


# from this many per-store rows on, engine="auto" grows the trees on the
# GPU (the JAX package's threshold for its accelerator engine)
_DEVICE_BOOST_MIN_ROWS = 200_000


class GBDTModelInternal:
    """``engine``: "host" (numpy grower), "device" (trees grown on
    ``device`` by ``boost_device``) or "auto": the device engine from
    ``_DEVICE_BOOST_MIN_ROWS`` rows on when ``device`` is CUDA, the numpy
    grower below that (the JAX package's rule with ``VES_BOOST_TPU``
    unset). ``device`` defaults to CUDA and is never swapped for the CPU:
    fitting with ``device="cuda"`` on a host without a GPU raises."""

    def __init__(self, max_depth: int = 6, learning_rate: float = 0.2,
                 n_estimators: int = 300, seed: int = 43,
                 backend: str = "auto", engine: str = "auto", device="cuda",
                 in_dim: Optional[int] = None):
        # in_dim is accepted and unused (trees take any width), so that
        # the few-shot harness (models/segment.py few_shot_fit) drives this
        # model through the same modes as the MLP
        if backend not in ("auto", "xgb", "lgb", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if engine not in ("auto", "device", "host"):
            raise ValueError(f"unknown engine {engine!r}")
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.seed = seed
        self.backend = "native"
        self.engine = engine
        self.device = str(device)
        self.model = None

    # ------------------------------------------------------------------
    def fit_base(self, features_list: List[np.ndarray], labels,
                 verbose=False, augment_buffer_swap: bool = False,
                 use_weight: bool = False):
        """``augment_buffer_swap``: duplicate every program with the
        per-store feature blocks of buffers 1 and 2 swapped (columns
        57+18..57+54) — the reference's ``use_data_argumentation``
        buffer-permutation augmentation (xgb_model.py:323-334).
        ``use_weight``: per-row weight max(y, 0.1) so high-throughput
        programs dominate the objective (xgb_model.py:336)."""
        labels = np.asarray(labels, np.float32)
        if augment_buffer_swap:
            aug = []
            for f in features_list:
                g = np.array(f, copy=True)
                if g.shape[-1] >= 57 + 18 * 3:
                    tmp = g[:, 57 + 18:57 + 36].copy()
                    g[:, 57 + 18:57 + 36] = g[:, 57 + 36:57 + 54]
                    g[:, 57 + 36:57 + 54] = tmp
                aug.append(g)
            features_list = list(features_list) + aug
            labels = np.concatenate([labels, labels])
        self._row_weights = (
            np.maximum(labels, 0.1) if use_weight else None)
        self._fit_native(features_list, labels, verbose)
        return self

    def _fit_native(self, features_list, labels, verbose=False):
        """The reference's full pack-sum protocol (xgb_model.py:120-250):
        per-store rows, pack_sum_square_error objective, pack_sum_rmse +
        a-peak@N eval callbacks every 25 rounds, best-iteration early
        stopping after 100."""
        rows = np.concatenate(features_list)
        pack_ids = _pack_ids(features_list)
        w = getattr(self, "_row_weights", None)
        dtrain = boost.DMatrix(
            rows, label=labels[pack_ids], pack_ids=pack_ids,
            weight=None if w is None else w[pack_ids],
            group_sizes=[len(features_list)])
        train_fn = self._native_train_fn(len(rows))
        self.model = train_fn(
            self._native_params(),
            dtrain, num_boost_round=self.n_estimators,
            obj=boost.pack_sum_square_error,
            fevals=[boost.pack_sum_rmse,
                    boost.pack_sum_average_peak_score(1)],
            evals=[(dtrain, "tr")], metric="tr-rmse",
            stopping_rounds=100,
            verbose_eval=25 if verbose else 0,
        )

    def _native_params(self) -> dict:
        """Booster params, xgboost-faithful (xgb_model.py:138-149 depth 6,
        eta 0.2)."""
        return {
            "max_depth": self.max_depth, "eta": self.learning_rate,
            "gamma": 0.003, "min_child_weight": 2,
            "seed": self.seed,
        }

    def _native_train_fn(self, n_rows: int):
        """boost.train or boost_device.train on ``self.device``; both
        produce the same boost.Booster, so saving/prediction are
        engine-agnostic."""
        dev = resolve_device(self.device)
        use_device = self.engine == "device" or (
            self.engine == "auto" and dev.type == "cuda"
            and n_rows >= _DEVICE_BOOST_MIN_ROWS)
        if use_device:
            return functools.partial(boost_device.train, device=dev)
        return boost.train

    # ------------------------------------------------------------------
    def predict_on_features(self, features_list) -> np.ndarray:
        if not features_list:
            return np.zeros(0, np.float32)
        rows = np.concatenate(features_list)
        pack_ids = _pack_ids(features_list)
        preds = self.model.predict(rows)
        out = np.bincount(pack_ids, weights=preds,
                          minlength=len(features_list)).astype(np.float32)
        for i, bad in enumerate(_invalid_rows_mask(self, features_list)):
            if bad:
                out[i] = -np.inf
        return out

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path: str, device=None):
        """A pickled tree internal, of this package or of the JAX package
        (its classes map onto this package's by module name). A JAX pickle
        must hold the in-repo booster (backend "native"), the only one the
        port runs. ``device`` (CUDA or the CPU) sets where later fits may
        grow on the device engine; None keeps the pickled device, CUDA
        for a JAX pickle."""
        with open(path, "rb") as f:
            model = _PackageUnpickler(f).load()
        if isinstance(model, GBDTModelInternal):
            if getattr(model, "backend", "native") != "native":
                raise ValueError(
                    f"{path}: a {model.backend!r}-backend tree model; the "
                    "port runs the in-repo booster only (backend 'native')")
            model.__dict__.setdefault("engine", "auto")
            model.__dict__.setdefault("device", "cuda")
            if device is not None:
                model.device = str(resolve_device(device))
        return model


class _PackageUnpickler(pickle.Unpickler):
    """Reads a pickle of the JAX package's tree models as this package's:
    ``vae_extent_search_tpu.<m>`` classes resolve to
    ``vae_extent_search_tpu_torch.<m>``, which keep the same names and
    attributes (the boosters' trees and the internals' settings)."""

    def find_class(self, module, name):
        jax_pkg = "vae_extent_search_tpu"
        if module == jax_pkg or module.startswith(jax_pkg + "."):
            module = __package__.split(".")[0] + module[len(jax_pkg):]
        return super().find_class(module, name)


class LGBModelInternal(GBDTModelInternal):
    """LightGBM-semantics variant (reference cost_model/lgbm_model.py):
    the same pack_sum_square_error objective + fevals as the xgb model
    (lgbm_model.py:246-247) but with lightgbm's tree grower, best-first
    leaf-wise growth capped by num_leaves, per-tree feature_fraction and
    bagging, and the reference's tuned params (lgbm_model.py:250-258:
    num_leaves 72, lr 0.1632095, feature_fraction 0.84375, bagging
    0.89435/freq 4, min_sum_hessian_in_leaf 4). It grows on the in-repo
    booster's leaf-wise grower (models/boost.py _grow_tree_leafwise), which
    runs on the host on either engine: the device engine hands such a fit
    to it."""

    def __init__(self, params: Optional[dict] = None, **kw):
        # `params` mirrors the reference's tunable-params constructor
        # (lgbm_model.py LGBModelInternal(params=...)): lightgbm-named
        # keys override the tuned defaults below
        self._params_override = dict(params or {})
        self._explicit_depth = "max_depth" in self._params_override
        for k in ("learning_rate", "max_depth", "n_estimators"):
            if k in self._params_override:
                kw[k] = self._params_override.pop(k)
        self._params_override.pop("boosting_type", None)  # always gbdt
        kw.setdefault("backend", "lgb")
        kw.setdefault("learning_rate", 0.1632095)
        super().__init__(**kw)

    def _native_params(self) -> dict:
        p = {
            "grow_policy": "lossguide",
            "num_leaves": 72,
            "eta": self.learning_rate,
            "feature_fraction": 0.84375,
            "bagging_fraction": 0.89435,
            "bagging_freq": 4,
            "min_child_weight": 4,  # min_sum_hessian_in_leaf
            "seed": self.seed,
        }
        if self._explicit_depth:
            # absent key = unlimited depth (lightgbm's default); only an
            # explicit user override caps the leaf-wise grower
            p["max_depth"] = self.max_depth
        rename = {"min_sum_hessian_in_leaf": "min_child_weight"}
        for k, v in self._params_override.items():
            p[rename.get(k, k)] = v
        return p


class RandomModelInternal:
    """Uniform-random predictions — the sanity baseline (reference
    cost_model/cost_model.py:87-113 RandomModelInternal)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.model = True  # "fit" from the start

    def fit_base(self, features_list, labels, verbose=False):
        return self

    def predict_on_features(self, features_list) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.random(len(features_list)).astype(np.float32)

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path: str):
        with open(path, "rb") as f:
            return pickle.load(f)
