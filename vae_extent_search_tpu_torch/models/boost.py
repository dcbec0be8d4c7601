"""Self-contained histogram gradient-boosted trees (counterpart of
``vae_extent_search_tpu/models/boost.py``, numpy only).

The reference's tree cost model is a training PROTOCOL, not just "a
GBDT" (xgb_model.py:120-250): a second-order boosting loop driven by the
custom ``pack_sum_square_error`` objective over per-store rows
(:528-556), with ``pack_sum_rmse`` / ``average-peak-score@N`` eval
callbacks printed every 25 rounds and best-iteration early stopping
(:558-745). This module is a minimal booster with the xgboost training
surface the protocol needs:

- ``DMatrix(X, label, weight, pack_ids)``: per-row features + the pack-id
  side channel, with 256-bin quantile binning into a feature-major
  ``_binned`` [d, n] uint8 array;
- ``train(params, dtrain, num_boost_round, obj, fevals, evals, ...)``:
  second-order gradient boosting; per round the custom objective maps
  raw row predictions to (gradient, hessian), a depth-limited regression
  tree fits the Newton step on the bin histograms with the XGBoost split
  gain ``0.5 [G_L^2/(H_L+lam) + G_R^2/(H_R+lam) - G^2/(H+lam)] - gamma``
  and leaf weight ``-eta * G/(H+lam)``, honoring ``min_child_weight``;
  ``grow_policy="lossguide"`` grows LightGBM-style best-first instead;
- the reference's callback semantics: fevals evaluated on the eval sets
  every ``verbose_eval`` rounds (skipping ``i % skip_every == 1`` like
  custom_callback:676), printed as
  ``XGB iter: %3d\\tte-rmse: ...\\ttr-a-peak@1: ...``, with best-score
  tracking + early stop after ``stopping_rounds``.

This host engine is sized for the search loop (10^2-10^5 rows); the
device engine (``models/boost_device.py``) grows the same trees on the
GPU at pretraining scale. Both return this module's ``Booster`` of numpy
trees, so prediction and pickles have one format. The code below is the
JAX package's, line for line, so the two host engines agree bit for bit.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("vae_extent_search_tpu_torch.boost")

_MAX_BINS = 255


class DMatrix:
    """Feature matrix + label + optional per-row weight and pack ids."""

    def __init__(self, data: np.ndarray, label: Optional[np.ndarray] = None,
                 weight: Optional[np.ndarray] = None,
                 pack_ids: Optional[np.ndarray] = None,
                 group_sizes: Optional[Sequence[int]] = None):
        self.data = np.ascontiguousarray(data, np.float32)
        self.label = (np.zeros(len(self.data), np.float32)
                      if label is None else np.asarray(label, np.float32))
        self.weight = (np.zeros(0, np.float32) if weight is None
                       else np.asarray(weight, np.float32))
        self.pack_ids = (None if pack_ids is None
                         else np.asarray(pack_ids, np.int64))
        self.group_sizes = list(group_sizes) if group_sizes else None
        self._binned = None
        self._thresholds = None

    def __len__(self):
        return len(self.data)

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def _ensure_binned(self):
        if self._binned is not None:
            return
        n, d = self.data.shape
        binned = np.zeros((d, n), np.uint8)
        thresholds: List[np.ndarray] = []
        for j in range(d):
            col = self.data[:, j]
            uniq = np.unique(col)
            if len(uniq) > _MAX_BINS:
                # quantile binning (lightgbm-style histogram sketch)
                qs = np.quantile(col, np.linspace(0, 1, _MAX_BINS + 1)[1:-1])
                edges = np.unique(qs)
            else:
                edges = (uniq[:-1] + uniq[1:]) / 2.0
            thresholds.append(edges.astype(np.float32))
            binned[j] = np.searchsorted(edges, col, side="right")
        self._binned = binned
        self._thresholds = thresholds


class _Tree:
    """Flat-array regression tree (feature, threshold, left, right,
    value); value is the eta-scaled Newton leaf weight."""

    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self):
        self.feature: List[int] = []
        self.threshold: List[float] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.value: List[float] = []

    def _new_node(self):
        self.feature.append(-1)
        self.threshold.append(0.0)
        self.left.append(-1)
        self.right.append(-1)
        self.value.append(0.0)
        return len(self.feature) - 1

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.zeros(len(X), np.float32)
        node = np.zeros(len(X), np.int64)
        feature = np.asarray(self.feature)
        threshold = np.asarray(self.threshold, np.float32)
        left = np.asarray(self.left)
        right = np.asarray(self.right)
        value = np.asarray(self.value, np.float32)
        active = np.arange(len(X))
        while len(active):
            f = feature[node[active]]
            leaf = f < 0
            if leaf.any():
                idx = active[leaf]
                out[idx] = value[node[idx]]
                active = active[~leaf]
                if not len(active):
                    break
                f = feature[node[active]]
            goes_left = X[active, f] <= threshold[node[active]]
            node[active] = np.where(goes_left, left[node[active]],
                                    right[node[active]])
        return out


def _grow_tree(dtrain: DMatrix, grad: np.ndarray, hess: np.ndarray,
               max_depth: int, eta: float, reg_lambda: float,
               gamma: float, min_child_weight: float):
    """-> (tree, train_update [n]) where train_update carries each
    row's leaf value under the GROWTH-time (binned) partition.

    The training loop must advance predictions with this vector, not
    tree.predict: growth routes ``bin <= k`` while float prediction
    routes ``x <= edges[k]``, and quantile edges can coincide exactly
    with data values — a row sitting on an edge then belongs to the
    right child during training but the left at predict time. Real
    xgboost (tree_method=hist) also updates from growth-time leaf
    assignments; this also keeps the device engine
    (models/boost_device.py) consistent with this one."""
    dtrain._ensure_binned()
    binned = dtrain._binned            # [d, n] uint8
    thresholds = dtrain._thresholds
    d = binned.shape[0]
    tree = _Tree()
    root = tree._new_node()
    train_update = np.zeros(len(grad), np.float32)
    # (node_id, depth, row_indices)
    stack = [(root, 0, np.arange(len(grad)))]
    while stack:
        node, depth, rows = stack.pop()
        G = grad[rows].sum()
        H = hess[rows].sum()
        if depth >= max_depth or H < 2 * min_child_weight or len(rows) < 2:
            tree.value[node] = -eta * G / (H + reg_lambda)
            train_update[rows] = tree.value[node]
            continue
        parent_score = G * G / (H + reg_lambda)
        best = (0.0, -1, -1)  # (gain, feature, bin)
        gj = grad[rows]
        hj = hess[rows]
        for j in range(d):
            edges = thresholds[j]
            if not len(edges):
                continue
            b = binned[j, rows]
            nb = len(edges) + 1
            gh = np.zeros(nb, np.float64)
            hh = np.zeros(nb, np.float64)
            np.add.at(gh, b, gj)
            np.add.at(hh, b, hj)
            gl = np.cumsum(gh)[:-1]
            hl = np.cumsum(hh)[:-1]
            gr = G - gl
            hr = H - hl
            ok = (hl >= min_child_weight) & (hr >= min_child_weight)
            if not ok.any():
                continue
            gain = 0.5 * (gl * gl / (hl + reg_lambda)
                          + gr * gr / (hr + reg_lambda)
                          - parent_score) - gamma
            gain = np.where(ok, gain, -np.inf)
            k = int(np.argmax(gain))
            if gain[k] > best[0]:
                best = (float(gain[k]), j, k)
        if best[1] < 0:
            tree.value[node] = -eta * G / (H + reg_lambda)
            train_update[rows] = tree.value[node]
            continue
        j, k = best[1], best[2]
        tree.feature[node] = j
        tree.threshold[node] = float(thresholds[j][k])
        mask = binned[j, rows] <= k
        lnode = tree._new_node()
        rnode = tree._new_node()
        tree.left[node] = lnode
        tree.right[node] = rnode
        stack.append((lnode, depth + 1, rows[mask]))
        stack.append((rnode, depth + 1, rows[~mask]))
    return tree, train_update


def _best_split(binned, thresholds, rows, grad, hess, reg_lambda,
                gamma, min_child_weight, min_data_in_leaf,
                feature_idx):
    """Best (gain, feature, bin) over candidate features for one node —
    the shared histogram split search of the lossguide grower."""
    gj = grad[rows]
    hj = hess[rows]
    G = gj.sum()
    H = hj.sum()
    parent_score = G * G / (H + reg_lambda)
    best = (0.0, -1, -1)
    for j in feature_idx:
        edges = thresholds[j]
        if not len(edges):
            continue
        b = binned[j, rows]
        nb = len(edges) + 1
        gh = np.zeros(nb, np.float64)
        hh = np.zeros(nb, np.float64)
        ch = np.bincount(b, minlength=nb).astype(np.float64)
        np.add.at(gh, b, gj)
        np.add.at(hh, b, hj)
        gl = np.cumsum(gh)[:-1]
        hl = np.cumsum(hh)[:-1]
        cl = np.cumsum(ch)[:-1]
        gr, hr, cr = G - gl, H - hl, len(rows) - cl
        ok = ((hl >= min_child_weight) & (hr >= min_child_weight)
              & (cl >= min_data_in_leaf) & (cr >= min_data_in_leaf))
        if not ok.any():
            continue
        gain = 0.5 * (gl * gl / (hl + reg_lambda)
                      + gr * gr / (hr + reg_lambda)
                      - parent_score) - gamma
        gain = np.where(ok, gain, -np.inf)
        k = int(np.argmax(gain))
        if gain[k] > best[0]:
            best = (float(gain[k]), j, k)
    return best, G, H


def _grow_tree_leafwise(dtrain: DMatrix, grad: np.ndarray,
                        hess: np.ndarray, num_leaves: int,
                        max_depth: int, eta: float, reg_lambda: float,
                        gamma: float, min_child_weight: float,
                        min_data_in_leaf: int = 20,
                        feature_idx=None, bag_rows=None):
    """LightGBM-semantics best-first ("lossguide") growth: keep a pool
    of splittable leaves, always split the one with the globally
    largest gain, stop at ``num_leaves`` leaves or when no leaf has a
    positive-gain split (reference lgbm_model.py trains
    boosting_type='gbdt' whose tree grower is leaf-wise with a
    num_leaves cap — unlike xgboost-hist's level-wise default).

    ``feature_idx``: candidate feature subset for this tree
    (feature_fraction); ``bag_rows``: row subset the tree is grown on
    (bagging_fraction/bagging_freq).  -> (tree, train_update[n]) where
    train_update routes EVERY row (in- and out-of-bag) through the
    finished tree by bin id, keeping score updates growth-consistent
    (see _grow_tree docstring for why bin routing, not float
    thresholds)."""
    import heapq

    dtrain._ensure_binned()
    binned = dtrain._binned            # [d, n] uint8
    thresholds = dtrain._thresholds
    if feature_idx is None:
        feature_idx = range(binned.shape[0])
    all_rows = np.arange(len(grad))
    rows0 = all_rows if bag_rows is None else bag_rows

    tree = _Tree()
    root = tree._new_node()
    split_bin = {}                     # node -> (feature, bin) for routing
    leaf_rows = {root: rows0}

    def push(heap, node, depth, rows, tick):
        (gain, j, k), G, H = _best_split(
            binned, thresholds, rows, grad, hess, reg_lambda, gamma,
            min_child_weight, min_data_in_leaf, feature_idx)
        tree.value[node] = -eta * G / (H + reg_lambda)
        depth_ok = max_depth <= 0 or depth < max_depth
        if j >= 0 and gain > 0 and depth_ok and len(rows) >= 2:
            # tick breaks gain ties toward the earlier-created leaf
            # (lightgbm's deterministic ordering)
            heapq.heappush(heap, (-gain, tick, node, depth, rows, j, k))

    heap: list = []
    push(heap, root, 0, rows0, 0)
    n_leaves, tick = 1, 1
    while heap and n_leaves < num_leaves:
        _, _, node, depth, rows, j, k = heapq.heappop(heap)
        mask = binned[j, rows] <= k
        lnode = tree._new_node()
        rnode = tree._new_node()
        tree.feature[node] = j
        tree.threshold[node] = float(thresholds[j][k])
        tree.left[node], tree.right[node] = lnode, rnode
        split_bin[node] = (j, k)
        del leaf_rows[node]
        lrows, rrows = rows[mask], rows[~mask]
        leaf_rows[lnode] = lrows
        leaf_rows[rnode] = rrows
        push(heap, lnode, depth + 1, lrows, tick)
        push(heap, rnode, depth + 1, rrows, tick + 1)
        tick += 2
        n_leaves += 1

    # route every row (incl. out-of-bag) down by bin id
    train_update = np.zeros(len(grad), np.float32)
    stack = [(root, all_rows)]
    while stack:
        node, rows = stack.pop()
        if tree.feature[node] < 0:
            train_update[rows] = tree.value[node]
            continue
        j, k = split_bin[node]
        mask = binned[j, rows] <= k
        stack.append((tree.left[node], rows[mask]))
        stack.append((tree.right[node], rows[~mask]))
    return tree, train_update


class Booster:
    """Trained model: base score + tree ensemble (+ xgboost-style str
    attributes for best-iteration bookkeeping)."""

    def __init__(self, base_score: float = 0.0):
        self.base_score = base_score
        self.trees: List[_Tree] = []
        self._attr = {}

    def predict(self, dmat) -> np.ndarray:
        X = dmat.data if isinstance(dmat, DMatrix) else \
            np.asarray(dmat, np.float32)
        out = np.full(len(X), self.base_score, np.float32)
        for t in self.trees:
            out += t.predict(X)
        return out

    def set_attr(self, **kw):
        self._attr.update({k: str(v) for k, v in kw.items()})

    def attr(self, key):
        return self._attr.get(key)


class EarlyStopException(Exception):
    def __init__(self, best_iteration):
        super().__init__(f"early stop at {best_iteration}")
        self.best_iteration = best_iteration


def train(params: dict, dtrain: DMatrix, num_boost_round: int = 300,
          obj: Optional[Callable] = None,
          fevals: Sequence[Callable] = (),
          evals: Sequence[Tuple[DMatrix, str]] = (),
          metric: Optional[str] = None, maximize: bool = False,
          stopping_rounds: Optional[int] = None,
          verbose_eval: int = 25, skip_every: int = 5,
          log_file: Optional[str] = None) -> Booster:
    """xgb.train-shaped boosting loop with the reference's callback
    semantics folded in (xgb_model.py custom_callback:629-745).

    ``obj(preds, dtrain) -> (grad, hess)``: custom objective on raw row
    predictions — the pack-sum objective plugs in unchanged. Default
    objective is plain square error against dtrain.label.
    ``fevals``: each called as ``feval(raw_preds, dmatrix)`` returning
    (name, score); evaluated on every (dmatrix, tag) in ``evals``."""
    max_depth = int(params.get("max_depth", 6))
    eta = float(params.get("eta", 0.3))
    reg_lambda = float(params.get("lambda", 1.0))
    gamma = float(params.get("gamma", 0.0))
    min_child_weight = float(params.get("min_child_weight", 1.0))
    base_score = float(params.get("base_score", 0.0))
    # lightgbm-semantics knobs (reference lgbm_model.py:141-150):
    # grow_policy "lossguide" = best-first leaf-wise growth capped by
    # num_leaves; feature_fraction / bagging_* are per-tree samplings
    lossguide = params.get("grow_policy") == "lossguide"
    num_leaves = int(params.get("num_leaves", 31))
    min_data_in_leaf = int(params.get("min_data_in_leaf", 20))
    feature_fraction = float(params.get("feature_fraction", 1.0))
    bagging_fraction = float(params.get("bagging_fraction", 1.0))
    bagging_freq = int(params.get("bagging_freq", 0))
    rng = np.random.default_rng(int(params.get("seed", 0)))

    bst = Booster(base_score)
    preds = {id(dm): bst.predict(dm) for dm, _ in evals}
    pred_tr = (preds[id(dtrain)] if id(dtrain) in preds
               else bst.predict(dtrain))

    best_score = -np.inf if maximize else np.inf
    best_iteration = 0
    bag = None

    for i in range(num_boost_round):
        if obj is not None:
            grad, hess = obj(pred_tr, dtrain)
        else:
            grad = pred_tr - dtrain.label
            hess = np.ones_like(grad)
            w = dtrain.get_weight()
            if len(w):
                grad, hess = grad * w, hess * w
        if lossguide:
            d = dtrain.data.shape[1]
            fidx = None
            if feature_fraction < 1.0:
                nf = max(1, int(round(feature_fraction * d)))
                fidx = np.sort(rng.choice(d, nf, replace=False))
            brows = None
            if 0 < bagging_fraction < 1.0 and bagging_freq > 0:
                # lightgbm re-bags every bagging_freq iterations;
                # within a window trees share the bag
                if i % bagging_freq == 0 or bag is None:
                    n = len(dtrain)
                    bag = np.sort(rng.choice(
                        n, max(1, int(round(bagging_fraction * n))),
                        replace=False))
                brows = bag
            tree, train_update = _grow_tree_leafwise(
                dtrain, np.asarray(grad, np.float64),
                np.asarray(hess, np.float64), num_leaves, max_depth
                if "max_depth" in params else -1, eta, reg_lambda,
                gamma, min_child_weight, min_data_in_leaf,
                feature_idx=fidx, bag_rows=brows)
        else:
            tree, train_update = _grow_tree(
                dtrain, np.asarray(grad, np.float64),
                np.asarray(hess, np.float64), max_depth, eta,
                reg_lambda, gamma, min_child_weight)
        bst.trees.append(tree)
        # growth-consistent (binned) update — see _grow_tree docstring
        pred_tr = pred_tr + train_update
        for dm, _tag in evals:
            if id(dm) == id(dtrain):
                preds[id(dm)] = pred_tr
            else:
                preds[id(dm)] = preds[id(dm)] + tree.predict(dm.data)

        if i % skip_every == 1:  # reference custom_callback:676
            continue
        eval_res = []
        for feval in fevals:
            for dm, tag in evals:
                name, score = feval(preds[id(dm)], dm)
                eval_res.append((f"{tag}-{name}", score))
        if metric and eval_res:
            # order like the reference: metric_shortname entries first
            short = metric.split("-")[1]
            eval_res.sort(key=lambda x: x[0] if short not in x[0]
                          else "a" + x[0])
        if verbose_eval and eval_res and i % verbose_eval == 0:
            infos = ["XGB iter: %3d" % i]
            infos += ["%s: %.6f" % kv for kv in eval_res]
            line = "\t".join(infos)
            logger.debug(line)
            print(line)
            if log_file:
                with open(log_file, "a") as f:
                    f.write(line + "\n")
        if metric and stopping_rounds:
            score = dict(eval_res).get(metric)
            if score is not None:
                better = score > best_score if maximize \
                    else score < best_score
                if better:
                    best_score, best_iteration = score, i
                    bst.set_attr(best_score=best_score,
                                 best_iteration=best_iteration)
                elif i - best_iteration >= stopping_rounds:
                    logger.debug("XGB stopped. Best iteration: %d",
                                 best_iteration)
                    del bst.trees[best_iteration + 1:]
                    break
    return bst


# ---------------------------------------------------------------------------
# Pack-sum objective + eval functions (reference xgb_model.py:470-627) —
# pack ids travel on the DMatrix instead of a global dmatrix_context.
# ---------------------------------------------------------------------------


def pack_sum_predict_throughput(raw_preds, pack_ids):
    return np.bincount(pack_ids, weights=raw_preds)


def pack_sum_square_error(preds, dtrain: DMatrix):
    """grad/hess of 0.5 * (sum_pack(pred) - label)^2 per row
    (xgb_model.py:528-556; row label = its pack's label)."""
    pack_ids = dtrain.pack_ids
    weight = dtrain.get_weight()
    sum_pred = np.bincount(pack_ids, weights=preds)
    gradient = sum_pred[pack_ids] - dtrain.get_label()
    hessian = np.ones_like(gradient)
    if len(weight) == 0:
        return gradient, hessian
    return gradient * weight, hessian * weight


def _per_pack(raw_preds, pack_ids, row_labels):
    """(pred_sums, labels) aligned per DISTINCT pack id — robust to
    absent ids (a program with zero feature rows contributes no id, so
    bincount length and unique-count length diverge)."""
    uniq, cnt = np.unique(pack_ids, return_counts=True)
    sums = np.bincount(pack_ids, weights=raw_preds)[uniq]
    labels = np.bincount(pack_ids, weights=row_labels)[uniq] / cnt
    return sums, labels


def pack_sum_rmse(raw_preds, dtrain: DMatrix):
    """('rmse', value) over per-pack summed predictions
    (xgb_model.py:558-576)."""
    preds, labels = _per_pack(raw_preds, dtrain.pack_ids,
                              dtrain.get_label())
    return "rmse", float(np.sqrt(np.mean(np.square(preds - labels))))


def max_curve(trial_scores):
    ret = np.empty(len(trial_scores))
    keep = -1e9
    for i, s in enumerate(trial_scores):
        keep = max(keep, s)
        ret[i] = keep
    return ret


def pack_sum_average_peak_score(N: int):
    """average-peak-score@N feval factory (xgb_model.py:579-627).

    The returned callable carries ``apeak_n = N`` so device-side
    re-implementations (boost_device scan metrics) read N robustly
    instead of sniffing closure cells."""

    def feval(raw_preds, dmatrix: DMatrix):
        group_sizes = dmatrix.group_sizes or [
            len(np.unique(dmatrix.pack_ids))]
        preds, labels = _per_pack(raw_preds, dmatrix.pack_ids,
                                  dmatrix.get_label())
        scores = []
        offset = 0
        for size in group_sizes:
            preds_group = preds[offset:offset + size]
            labels_group = labels[offset:offset + size]
            offset += size
            trials = np.argsort(preds_group)[::-1][:N]
            trial_scores = labels_group[trials]
            curve = max_curve(trial_scores) / np.max(labels_group)
            scores.append(np.mean(curve))
        return "a-peak@%d" % N, float(np.mean(scores))

    feval.apeak_n = N
    return feval
