"""GPU histogram gradient boosting: the pack-sum training protocol at
TenSet-pretraining scale (counterpart of
``vae_extent_search_tpu/models/boost_tpu.py``).

``models/boost.py`` runs the reference's xgb training protocol
(pack_sum_square_error objective + pack_sum_rmse / a-peak@N eval
callbacks + best-iteration early stopping, reference
cost_model/xgb_model.py:120-250,470-745) on a numpy histogram booster
sized for the search loop. This module runs the same protocol with the
per-round work on the device, for corpora of millions of per-store rows:

- trees grow LEVEL-WISE over a complete binary tree of static depth: per
  level, the (grad, hess) histograms per (feature, node, bin) come from
  one launch of the histogram kernel (``ops/hist.py``); the XGBoost split
  gain ``0.5[G_L^2/(H_L+lam) + G_R^2/(H_R+lam) - G^2/(H+lam)] - gamma`` is
  computed from prefix sums over bins and one flattened argmax per node;
- a node that does not split (gain <= 0, H < 2*min_child_weight, or < 2
  rows) becomes "dead": its split bin is set past the last real bin so
  every row routes down the LEFT spine, which makes the eventual depth-D
  leaf value equal the early-leaf Newton step ``-eta * G/(H + lambda)``
  the numpy grower would have emitted;
- the pack-sum objective is a device segment sum + gather, so a full
  boosting round never leaves the device; rounds run in chunks of 50 with
  the standard protocol metrics computed on the device, and only the
  chunk's tree arrays and metrics come back to the host;
- splits compare ``bin <= k`` exactly like ``boost._grow_tree``, and the
  finished ensemble is converted back to ``boost.Booster``/``_Tree``
  (float thresholds ``edges[k]``), so prediction, pickling and the
  GBDTModelInternal save/load format are the numpy engine's.

Tie-breaking matches the numpy grower: gains are laid out feature-major /
bin-minor and argmax takes the first maximum, which reproduces "first max
bin within a feature, strictly-greater across features".

Determinism: no sum here depends on the order of atomics. The histogram
kernel sums in fixed point, and so do the segment sums (pack sums, leaf
sums) and the prefix sums over bins (``_fixed_exponent``: int64 with one
power-of-two scale per tensor, exact up to ~2^-42 of the largest value),
so a run gives the same trees every time. Prefix sums and gains are
float64, as in the numpy grower; the histograms themselves are float32.
The JAX engine sums in float32 instead, so exact-tie gains can split
differently on adversarial data; the parity tests use continuous
features, where this does not occur.

Data-parallel training (``train(..., mesh=)``, the counterpart of the JAX
engine's ``_make_sharded_chunk_runner``): the rows are padded to a multiple
of the mesh's "data" size with weight 0 and split into contiguous blocks,
one per rank. Each rank launches the histogram kernel on its own rows in
its exact mode (``ops/hist.py``: the ranks agree on the fixed-point
exponents by an all-reduce MAX of max |grad| and max |hess| and by the
global row count, then all-reduce SUM the int64 sums and round as the
kernel does), and the pack sums, the leaf sums and the row counts per node
reduce the same way (an agreed exponent, then an int64 SUM), since packs
may straddle blocks. Every other step runs on the replicated histograms,
so every rank grows the same trees, equal bit for bit to one card's.

Left out of this port: the TPU-layout options ``VES_BOOST_HIST``,
``VES_BOOST_TIER`` and ``VES_BOOST_KRON`` (one kernel launch takes every
bin count).
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.hist import exponent_for, hist, round_fixed
from ..ops.kernel_library import tuned_hist_plan
from . import boost
from .boost import Booster, DMatrix, _Tree

logger = logging.getLogger("vae_extent_search_tpu_torch.boost_device")

_CHUNK = 50


# ---------------------------------------------------------------------------
# exact, order-independent sums
# ---------------------------------------------------------------------------


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0 ** e as float64, exactly, for int64 ``e`` in [-1022, 1023]."""
    return ((e + 1023) << 52).view(torch.float64)


class _Ranks:
    """The reductions of rows split over a mesh's "data" ranks: ``n`` is
    the global count of real rows and ``valid`` marks this rank's real
    (unpadded) rows."""

    def __init__(self, mesh, n: int, valid: torch.Tensor):
        self.mesh, self.n, self.valid = mesh, n, valid

    def max(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import all_reduce

        return all_reduce(x, self.mesh, "data", "max")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import all_reduce

        return all_reduce(x, self.mesh, "data", "sum")


def _fixed_exponent(x: torch.Tensor, terms: int,
                    ranks: Optional[_Ranks] = None) -> torch.Tensor:
    """int64 exponent e such that ``round(x * 2**e)`` of any ``terms``
    values of x sums below 2**62 in magnitude (0 for an all-zero x); with
    ``ranks``, max |x| is taken over every rank's x."""
    amax = x.abs().max()
    if ranks is not None:
        amax = ranks.max(amax)
    amax = amax.double()
    _, ex = torch.frexp(amax)  # amax < 2 ** ex
    e = 62 - (max(terms, 1) - 1).bit_length() - ex.long()
    return torch.where(amax > 0, e, torch.zeros_like(e)).clamp(-1000, 1000)


def _to_fixed(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return torch.round(x.double() * _pow2(e)).long()


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 n_seg: int, ranks: Optional[_Ranks] = None) -> torch.Tensor:
    """float64 [n_seg]: the sum of ``values`` per segment id, in fixed
    point (``jax.ops.segment_sum`` in the JAX engine); with ``ranks``, over
    every rank's real rows (padded rows add nothing)."""
    if ranks is not None:
        values = torch.where(ranks.valid, values, torch.zeros_like(values))
    e = _fixed_exponent(values, values.numel() if ranks is None
                        else ranks.n, ranks)
    acc = torch.zeros(n_seg, dtype=torch.int64, device=values.device)
    acc.index_add_(0, seg, _to_fixed(values, e))
    if ranks is not None:
        acc = ranks.sum(acc)
    return acc.double() * _pow2(-e)


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float64 inclusive prefix sums of ``x`` along ``dim``, in fixed
    point."""
    e = _fixed_exponent(x, x.shape[dim])
    return torch.cumsum(_to_fixed(x, e), dim).double() * _pow2(-e)


# ---------------------------------------------------------------------------
# device tree growth
# ---------------------------------------------------------------------------


def hist_census(thresholds) -> Tuple[int, int, int, int, int]:
    """(F, c2, c16, c64, c128) of a binned matrix: the features whose bin
    count (edges + 1) is at most 2, in (2, 16], (16, 64] and (64, 128],
    as the JAX engine counts them for its tuned tier ladder
    (``models/boost_tpu.py:115-121``); the gbdt_hist_layer workload's
    census."""
    nbins = np.asarray([len(e) for e in thresholds]) + 1
    return (len(nbins), int((nbins <= 2).sum()),
            int(((nbins > 2) & (nbins <= 16)).sum()),
            int(((nbins > 16) & (nbins <= 64)).sum()),
            int(((nbins > 64) & (nbins <= 128)).sum()))


def _level_hist(bins, node, grad, hess, m, nb, hist_plan, ranks):
    """The level's (ghist, hhist) [d, m, nb] float32: one launch over the
    rows here, or with ``ranks`` the exact cross-rank sums (each rank's
    launch at the agreed exponents, int64 SUM, the kernel's rounding)."""
    if ranks is None:
        return hist(bins, node, grad, hess, m, nb, plan=hist_plan)
    eg = exponent_for(ranks.max(grad.abs().max()).cpu(), ranks.n)
    eh = exponent_for(ranks.max(hess.abs().max()).cpu(), ranks.n)
    gi, hi = hist(bins, node, grad, hess, m, nb, plan=hist_plan,
                  exponents=(eg, eh))
    return round_fixed(ranks.sum(gi), eg), round_fixed(ranks.sum(hi), eh)


def _grow_tree_device(bins, n_edges, grad, hess, *, max_depth: int, nb: int,
                      eta: float, reg_lambda: float, gamma: float,
                      min_child_weight: float, hist_plan=None, ranks=None):
    """One tree as a complete binary heap of static depth.

    ``bins`` [d, n] uint8 on the device, ``n_edges`` [d] int64, ``grad``
    and ``hess`` [n] float32. Returns (feat [2^D-1], bin_thr [2^D-1],
    split [2^D-1] bool, leafval [2^D] float64, row_update [n] float32)
    where level ``l`` occupies heap slots [2^l - 1, 2^(l+1) - 1).

    Per-node grad/hess totals are the last prefix sum of feature 0's
    histogram (every row lands in exactly one bin). Row routing gathers
    each row's bin of its node's split feature. ``hist_plan`` goes to
    every level's histogram launch (``ops/hist.py::hist(plan=)``). With
    ``ranks`` (a ``_Ranks``) the rows here are this rank's block and every
    sum covers all ranks' rows."""
    d, n = bins.shape
    dev = bins.device
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    ones = (torch.ones(n, dtype=torch.int64, device=dev) if ranks is None
            else ranks.valid.long())
    valid_bin = (torch.arange(nb - 1, device=dev)[None, None, :]
                 < n_edges[:, None, None])                   # [d, 1, nb-1]
    feat_lv, bin_lv, split_lv = [], [], []
    for level in range(max_depth):
        m = 1 << level
        ghist, hhist = _level_hist(bins, node, grad, hess, m, nb,
                                   hist_plan, ranks)         # [d, m, nb]
        gc = _prefix_sum(ghist, 2)
        hc = _prefix_sum(hhist, 2)
        Gn, Hn = gc[0, :, -1], hc[0, :, -1]                  # [m]
        gl, hl = gc[:, :, :-1], hc[:, :, :-1]                # [d, m, nb-1]
        gr = Gn[None, :, None] - gl
        hr = Hn[None, :, None] - hl
        parent = (Gn * Gn / (Hn + reg_lambda))[None, :, None]
        ok = (hl >= min_child_weight) & (hr >= min_child_weight) & valid_bin
        gain = 0.5 * (gl * gl / (hl + reg_lambda)
                      + gr * gr / (hr + reg_lambda) - parent) - gamma
        gain = torch.where(ok, gain, -torch.inf)
        flat = gain.permute(1, 0, 2).reshape(m, d * (nb - 1))
        best = torch.argmax(flat, dim=1)        # first maximum
        best_gain = flat.gather(1, best[:, None])[:, 0]
        node_l = node.long()
        # rows per node (bincount would wait for the device to size its
        # output)
        Cn = torch.zeros(m, dtype=torch.int64, device=dev).index_add_(
            0, node_l, ones)
        if ranks is not None:
            Cn = ranks.sum(Cn)
        can_split = ((best_gain > 0.0) & (Hn >= 2 * min_child_weight)
                     & (Cn >= 2))
        f_best = torch.where(can_split, best // (nb - 1), 0)
        # dead: every bin <= nb-1, so all rows go left
        k_best = torch.where(can_split, best % (nb - 1), nb - 1)
        feat_lv.append(f_best)
        bin_lv.append(k_best)
        split_lv.append(can_split)
        col = bins.gather(0, f_best[node_l][None, :])[0]
        goes_right = col.long() > k_best[node_l]
        node = 2 * node + goes_right.int()
    m = 1 << max_depth
    node_l = node.long()
    G = _segment_sum(grad, node_l, m, ranks)
    H = _segment_sum(hess, node_l, m, ranks)
    leafval = -eta * G / (H + reg_lambda)
    row_update = leafval.float()[node_l]
    return (torch.cat(feat_lv), torch.cat(bin_lv), torch.cat(split_lv),
            leafval, row_update)


def _descend_device(binned, feat, bin_thr, max_depth: int):
    """Leaf index of each (pre-binned, row-major [n, d]) row under a
    heap-layout tree."""
    node = torch.zeros(binned.shape[0], dtype=torch.int64,
                       device=binned.device)
    off = 0
    for level in range(max_depth):
        fb = feat[off + node]
        kb = bin_thr[off + node]
        rowbin = binned.gather(1, fb[:, None])[:, 0]
        node = 2 * node + (rowbin > kb).long()
        off += 1 << level
    return node


class _PackSum:
    """The pack-sum objective's per-row inputs on the device, and its
    per-pack labels for the protocol metrics. With ``rows`` = (first, end,
    pad) the per-row inputs are those of rows [first, end) padded with
    ``pad`` inert rows (weight 0), a rank's block, and ``ranks`` sums the
    packs over every rank."""

    def __init__(self, dtrain: DMatrix, dev, rows=None, ranks=None):
        pack_ids = dtrain.pack_ids
        self.n_packs = int(pack_ids.max()) + 1 if len(pack_ids) else 1
        self.ranks = ranks
        label = dtrain.get_label()
        w = dtrain.get_weight()
        if rows is not None:
            lo, hi, pad = rows
            last = pack_ids[-1] if len(pack_ids) else 0
            w = np.pad((w if len(w) else np.ones(len(label)))[lo:hi],
                       (0, pad))
            pack_ids = np.pad(pack_ids[lo:hi], (0, pad), constant_values=last)
            label = np.pad(label[lo:hi], (0, pad))
        self.pack_ids = torch.as_tensor(pack_ids, dtype=torch.int64,
                                        device=dev)
        # rows of a pack carry the pack's label, so the per-row label
        # needs no per-round expansion
        self.label_row = torch.as_tensor(label, dtype=torch.float32,
                                         device=dev)
        self.weight = (torch.as_tensor(w, dtype=torch.float32, device=dev)
                       if len(w) else None)
        pack_ids, label = dtrain.pack_ids, dtrain.get_label()
        cnt = np.bincount(pack_ids, minlength=self.n_packs)
        lp = np.bincount(pack_ids, weights=label, minlength=self.n_packs)
        self.label_pack = torch.as_tensor(lp / np.maximum(cnt, 1),
                                          dtype=torch.float64, device=dev)
        self.present = torch.as_tensor(cnt > 0, device=dev)
        self.num_present = int((cnt > 0).sum())

    def sums(self, preds):
        return _segment_sum(preds, self.pack_ids, self.n_packs, self.ranks)

    def grad_hess(self, preds):
        """boost.pack_sum_square_error on the device."""
        grad = self.sums(preds)[self.pack_ids] - self.label_row
        hess = torch.ones_like(grad)
        if self.weight is not None:
            grad = grad * self.weight
            hess = hess * self.weight
        return grad.float(), hess.float()

    def metrics(self, preds, metric_kinds):
        """pack_sum_rmse / a-peak@N of the per-pack summed predictions,
        exactly like the host fevals -> float64 [len(metric_kinds)]."""
        sums = self.sums(preds)
        max_label = torch.max(torch.where(self.present, self.label_pack,
                                          -torch.inf))
        mets = []
        for kind, N in metric_kinds:
            if kind == "rmse":
                err = torch.where(self.present, sums - self.label_pack, 0.0)
                mets.append(torch.sqrt(torch.sum(err * err)
                                       / self.num_present))
            else:
                masked = torch.where(self.present, sums, -torch.inf)
                # np.argsort(sums)[::-1] breaks ties toward the LARGEST
                # pack index: a stable descending sort of the reversed
                # sums does the same. Clamp N like the host's [:N] slice:
                # trials never include absent packs.
                k_eff = min(N, self.n_packs, self.num_present)
                order = torch.sort(masked.flip(0), descending=True,
                                   stable=True).indices[:k_eff]
                idx = self.n_packs - 1 - order
                curve = torch.cummax(self.label_pack[idx], 0).values
                mets.append(torch.mean(curve / max_label))
        if not mets:
            return torch.zeros(0, dtype=torch.float64, device=sums.device)
        return torch.stack(mets)


# ---------------------------------------------------------------------------
# host-side conversion + training loop
# ---------------------------------------------------------------------------


def _to_numpy_tree(feat, bin_thr, split, leafval, thresholds,
                   max_depth: int) -> _Tree:
    """Heap-layout device tree -> boost._Tree (float thresholds), same
    node-visit order as the JAX engine's conversion."""
    feat = np.asarray(feat)
    bin_thr = np.asarray(bin_thr)
    split = np.asarray(split)
    leafval = np.asarray(leafval, np.float32)
    offs = np.cumsum([0] + [1 << l for l in range(max_depth)])
    tree = _Tree()

    def rec(level: int, idx: int) -> int:
        me = tree._new_node()
        if level < max_depth and split[offs[level] + idx]:
            j = int(feat[offs[level] + idx])
            k = int(bin_thr[offs[level] + idx])
            tree.feature[me] = j
            tree.threshold[me] = float(thresholds[j][k])
            tree.left[me] = rec(level + 1, 2 * idx)
            tree.right[me] = rec(level + 1, 2 * idx + 1)
        else:
            # dead/bottom node: all rows flowed down the left spine
            tree.value[me] = float(leafval[idx << (max_depth - level)])
        return me

    rec(0, 0)
    return tree


def _bin_against(dmat: DMatrix, thresholds: List[np.ndarray]) -> np.ndarray:
    """Bin a foreign eval matrix with the train-set thresholds so the
    device descent (bin <= k) equals the float compare x <= edges[k]."""
    n, d = dmat.data.shape
    out = np.zeros((n, d), np.int64)
    for j in range(d):
        if len(thresholds[j]):
            # side="left": bin(x) <= k  <=>  x <= edges[k]
            out[:, j] = np.searchsorted(
                thresholds[j], dmat.data[:, j], side="left")
    return out


def _device_feval_kinds(fevals, dtrain):
    """Map the standard protocol fevals to on-device metric specs:
    -> tuple of ("rmse", 0) / ("apeak", N), or None when any feval has
    no device equivalent (or needs multi-group a-peak)."""
    kinds = []
    single_group = (not dtrain.group_sizes) or len(dtrain.group_sizes) == 1
    for feval in fevals:
        if feval is boost.pack_sum_rmse:
            kinds.append(("rmse", 0))
            continue
        N = getattr(feval, "apeak_n", None)
        if N is not None and single_group:
            kinds.append(("apeak", int(N)))
            continue
        return None
    return tuple(kinds)


def train(params: dict, dtrain: DMatrix, num_boost_round: int = 300,
          obj: Optional[Callable] = None,
          fevals: Sequence[Callable] = (),
          evals: Sequence[Tuple[DMatrix, str]] = (),
          metric: Optional[str] = None, maximize: bool = False,
          stopping_rounds: Optional[int] = None,
          verbose_eval: int = 25, skip_every: int = 5,
          log_file: Optional[str] = None, device="cuda",
          hist_plan: Optional[Tuple[int, int]] = None, mesh=None) -> Booster:
    """Drop-in for boost.train with device-resident rounds on ``device``.

    ``obj is boost.pack_sum_square_error`` (or the string "pack_sum")
    selects the fully on-device objective: no host transfer inside a
    round. Any other callable still works: predictions are pulled to the
    host, the objective runs in numpy, and (grad, hess) are pushed back
    (one round-trip per round). Eval callbacks, early stopping and
    printing reproduce boost.train / reference xgb_model.py
    custom_callback:629-745 semantics.

    ``hist_plan`` = (features, chunks) is the histogram kernel's launch
    plan at every level (``ops/hist.py::hist(plan=)``). Without one, the
    process kernel library is asked for a plan tuned at this (rows,
    feature census) shape (``cli/tune_kernel_suite.py``'s gbdthist
    family), and where it has none ``launch_plan`` chooses. Every plan
    grows the same trees: the histograms are exact.

    ``mesh`` (``parallel/mesh.py``) trains data-parallel over its "data"
    ranks on the mesh's device (the module docstring says how); every rank
    calls this with the whole ``dtrain`` and returns the same booster. It
    takes the chunked path only: the pack-sum objective, the standard
    protocol fevals, ``dtrain`` as the only eval set."""
    if params.get("grow_policy") == "lossguide":
        # leaf-wise growth keeps a dynamic splittable-leaf pool, a
        # data-dependent control structure the static-heap device tree
        # cannot express; run the host lossguide grower instead
        return boost.train(params, dtrain, num_boost_round, obj=obj,
                           fevals=fevals, evals=evals, metric=metric,
                           maximize=maximize,
                           stopping_rounds=stopping_rounds,
                           verbose_eval=verbose_eval,
                           skip_every=skip_every, log_file=log_file)
    dev = resolve_device(mesh.device if mesh is not None else device)
    max_depth = int(params.get("max_depth", 6))
    eta = float(params.get("eta", 0.3))
    base_score = float(params.get("base_score", 0.0))
    grow_kw = dict(max_depth=max_depth, eta=eta,
                   reg_lambda=float(params.get("lambda", 1.0)),
                   gamma=float(params.get("gamma", 0.0)),
                   min_child_weight=float(params.get("min_child_weight", 1.0)))

    dtrain._ensure_binned()
    thresholds = dtrain._thresholds
    nb = max(2, max(len(e) for e in thresholds) + 1)
    grow_kw["nb"] = nb
    if hist_plan is None:
        hist_plan = tuned_hist_plan(len(dtrain), *hist_census(thresholds))
    grow_kw["hist_plan"] = hist_plan
    n = len(dtrain)
    n_edges = torch.as_tensor([len(e) for e in thresholds],
                              dtype=torch.int64, device=dev)
    pack_fast = (obj is boost.pack_sum_square_error or obj == "pack_sum")
    if mesh is None:
        bins = torch.from_numpy(dtrain._binned).to(dev)      # [d, n] uint8
        packs = _PackSum(dtrain, dev) if pack_fast else None
    else:
        if not (pack_fast and _device_feval_kinds(fevals, dtrain) is not None
                and all(dm is dtrain for dm, _ in evals)):
            raise ValueError("train(mesh=) runs the pack-sum objective with "
                             "the standard protocol fevals on dtrain only")
        s = mesh.shape["data"]
        n_loc = -(-n // s)
        lo = min(mesh.index("data") * n_loc, n)
        hi = min(lo + n_loc, n)
        pad = n_loc - (hi - lo)
        bins = torch.from_numpy(np.ascontiguousarray(np.pad(
            dtrain._binned[:, lo:hi], ((0, 0), (0, pad))))).to(dev)
        ranks = _Ranks(mesh, n, torch.arange(n_loc, device=dev) < hi - lo)
        grow_kw["ranks"] = ranks
        packs = _PackSum(dtrain, dev, (lo, hi, pad), ranks)
        n = n_loc

    preds = torch.full((n,), base_score, dtype=torch.float32, device=dev)
    # eval sets: dtrain shares the train predictions; foreign sets get
    # binned against the train thresholds and accumulated per round
    eval_state = []   # dicts: {dm, tag, binned (None = train), preds}
    for dm, tag in evals:
        if dm is dtrain:
            eval_state.append(dict(dm=dm, tag=tag, binned=None, preds=None))
        else:
            eval_state.append(dict(
                dm=dm, tag=tag,
                binned=torch.as_tensor(_bin_against(dm, thresholds),
                                       device=dev),
                preds=torch.full((len(dm),), base_score,
                                 dtype=torch.float32, device=dev)))

    bst = Booster(base_score)
    best_score = -np.inf if maximize else np.inf
    best_iteration = 0

    def _callback_step(i, eval_res):
        """Reference custom_callback semantics for one round's eval
        results: sort, print every verbose_eval, track best, return True
        when early stopping should truncate + stop."""
        nonlocal best_score, best_iteration
        if metric and eval_res:
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
                    return True
        return False

    def _host_trees(pending):
        """Per-round device tree arrays -> numpy trees, in one transfer."""
        if not pending:
            return []
        cols = [torch.stack([p[c] for p in pending]).cpu().numpy()
                for c in range(4)]
        return [_to_numpy_tree(*[c[j] for c in cols], thresholds, max_depth)
                for j in range(len(pending))]

    # -- chunked fast path: the full protocol, one host transfer per 50
    # rounds, with the standard protocol fevals computed ON DEVICE per
    # round and the callback / early-stop semantics replayed on the
    # returned metric series (exact: stopping only truncates trees and
    # the training trajectory never depends on the metric)
    metric_kinds = _device_feval_kinds(fevals, dtrain)
    if (pack_fast and metric_kinds is not None
            and all(s["binned"] is None for s in eval_state)):
        tags = [s["tag"] for s in eval_state]
        i = 0
        stopped = False
        while i < num_boost_round and not stopped:
            k = min(_CHUNK, num_boost_round - i)
            rounds = []
            for _ in range(k):
                grad, hess = packs.grad_hess(preds)
                feat, bin_thr, split, leafval, row_update = \
                    _grow_tree_device(bins, n_edges, grad, hess, **grow_kw)
                preds = preds + row_update
                rounds.append((feat, bin_thr, split, leafval,
                               packs.metrics(preds, metric_kinds)))
            trees = _host_trees(rounds)
            mets = torch.stack([r[4] for r in rounds]).cpu().numpy()
            for j in range(k):
                bst.trees.append(trees[j])
                ii = i + j
                if ii % skip_every == 1:
                    continue
                eval_res = []
                for mi, (kind, N) in enumerate(metric_kinds):
                    name = "rmse" if kind == "rmse" else f"a-peak@{N}"
                    for tag in tags:
                        eval_res.append((f"{tag}-{name}",
                                         float(mets[j][mi])))
                if _callback_step(ii, eval_res):
                    del bst.trees[best_iteration + 1:]
                    stopped = True
                    break
            i += k
        return bst

    # -- general path: one round per step; the per-round tree arrays
    # stay on the device and convert to numpy trees in one transfer
    pending: List[tuple] = []
    for i in range(num_boost_round):
        if pack_fast:
            grad, hess = packs.grad_hess(preds)
        else:
            if obj is not None:
                g, h = obj(preds.cpu().numpy(), dtrain)
            else:
                g = preds.cpu().numpy() - dtrain.label
                h = np.ones_like(g)
                w = dtrain.get_weight()
                if len(w):
                    g, h = g * w, h * w
            grad = torch.as_tensor(np.asarray(g, np.float32), device=dev)
            hess = torch.as_tensor(np.asarray(h, np.float32), device=dev)
        feat, bin_thr, split, leafval, row_update = _grow_tree_device(
            bins, n_edges, grad, hess, **grow_kw)
        preds = preds + row_update
        pending.append((feat, bin_thr, split, leafval))
        for s in eval_state:
            if s["binned"] is not None:
                leaf = _descend_device(s["binned"], feat, bin_thr, max_depth)
                s["preds"] = s["preds"] + leafval.float()[leaf]

        if i % skip_every == 1:   # reference custom_callback:676
            continue
        need_eval = (fevals and (verbose_eval and i % verbose_eval == 0
                                 or (metric and stopping_rounds)))
        if not need_eval:
            continue
        eval_res = []
        pred_tr_np = None
        for feval in fevals:
            for s in eval_state:
                if s["binned"] is None:
                    if pred_tr_np is None:
                        pred_tr_np = preds.cpu().numpy()
                    name, score = feval(pred_tr_np, dtrain)
                else:
                    name, score = feval(s["preds"].cpu().numpy(), s["dm"])
                eval_res.append((f"{s['tag']}-{name}", score))
        if _callback_step(i, eval_res):
            bst.trees.extend(_host_trees(pending))
            del bst.trees[best_iteration + 1:]
            return bst
    bst.trees.extend(_host_trees(pending))
    return bst
