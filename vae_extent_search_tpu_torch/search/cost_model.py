"""In-search cost-model wrappers (counterpart of
``vae_extent_search_tpu/search/cost_model.py``).

Parity target: python/tvm/auto_scheduler/cost_model/cost_model.py
(PythonBasedModel: the C++ evolutionary search calls back into the Python
model's predict per GA iteration) and the in-search wrappers
MLPModel (mlp_model.py:814-846) / XGBModel: featurize candidate states
with the per-store extractor and score them; update() refits on measured
records; unlowerable states score -inf.

``device`` places the model's internal: CUDA by default, the CPU only
when the caller asks for it. On CUDA the MLP, the SegmentVAE model and
the PlusMix delta MLP run every segment sum through the ``segment_sum``
kernel, forward when they score a GA generation and forward and backward
when they refit; the tree models grow on the host below 200,000 per-store
rows (``models/gbdt.py``). Featurising and the GA are host work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..features.per_store import get_per_store_features_from_states
from ..records.task import SearchTask
from .sketch import PythonCostModel, RandomCostModel  # noqa: F401

NEURAL_KINDS = ("mlp", "lstm", "mha", "tabnet", "vae")


def _new_internal(kind: str, in_dim: int, device):
    if kind == "mlp":
        from ..models.segment import MLPModelInternal

        return MLPModelInternal(in_dim=in_dim, device=device)
    if kind == "vae":
        # the for_inference lineage: SegmentVAE + latent regression as the
        # search's cost model (vae_reg_feature_ansor*.ipynb /
        # e2e_vae_reg_feature)
        from ..models.segment import SegmentVAEModelInternal

        return SegmentVAEModelInternal(in_dim=in_dim, device=device)
    if kind in ("gbdt", "xgb"):
        from ..models.gbdt import GBDTModelInternal

        # both names run the in-repo pack-sum booster (the port has no
        # xgboost or sklearn backend)
        return GBDTModelInternal(backend="xgb" if kind == "xgb" else "auto",
                                 device=device)
    if kind in ("lgb", "lgbm"):
        from ..models.gbdt import LGBModelInternal

        return LGBModelInternal(device=device)
    from ..models.variants import SequenceModelInternal

    return SequenceModelInternal(arch=kind, in_dim=in_dim, device=device)


class LearnedCostModel(PythonCostModel):
    """Wraps a fit/predict model (MLPModelInternal / GBDTModelInternal /
    SequenceModelInternal) behind the search-callback interface."""

    def __init__(self, internal=None, kind: str = "mlp",
                 few_shot_learning: str = "base_only",
                 use_workload_embedding: bool = True,
                 num_warmup_sample: int = 0, device="cuda"):
        # reference default: MLP/XGB/LGB append a workload embedding to
        # every feature row (mlp_model.py use_workload_embedding=True,
        # xgb_model.py:108); the MLP pads it to 10 dims, the tree models
        # use the raw 9 tags
        self._embed_total = 10 if kind in NEURAL_KINDS else 9
        if internal is None:
            resolve_device(device)
            extra = self._embed_total if use_workload_embedding else 0
            internal = _new_internal(kind, 164 + extra, device)
            internal.use_workload_embedding = use_workload_embedding
            internal.workload_embed_total_dim = self._embed_total
        else:
            # trained internals carry the authoritative contract — the
            # kind-derived default must not override it
            use_workload_embedding = getattr(
                internal, "use_workload_embedding", False)
            self._embed_total = getattr(
                internal, "workload_embed_total_dim", self._embed_total)
        self.use_workload_embedding = use_workload_embedding
        self.internal = internal
        self.device = str(getattr(internal, "device", device))
        self.few_shot_learning = few_shot_learning
        # num_warmup_sample (set by make_search_policies from
        # task_scheduler.py:100-102): update() does not refit until this
        # many measured samples accumulated, so for a PRETRAINED model the
        # pretrained predictions serve until enough local data exists.
        # This gate on update() is the JAX package's, kept for parity; it
        # is not the reference XGBModel's, which gates predict() (random
        # scores until num_warmup_sample samples), not update().
        self.num_warmup_sample = num_warmup_sample
        self._inputs: List = []
        self._results: List = []

    def _embed(self, features_list, workload_keys):
        if not self.use_workload_embedding:
            return features_list
        from ..models.embedding import append_workload_embedding

        return append_workload_embedding(features_list, workload_keys,
                                         total_dim=self._embed_total)

    # ---------------- search-side interface -------------------------

    def update(self, inputs, results):
        """Refit on all measured pairs so far (reference
        PythonBasedModel.update -> model.update)."""
        if inputs:
            self._inputs.extend(inputs)
            self._results.extend(results)
        if not self._inputs:
            return
        if len(self._inputs) < self.num_warmup_sample:
            return  # keep predicting with the current (pretrained) fit
        from ..features.per_store import (
            get_per_store_features_from_measure_pairs,
        )

        feats, throughputs, task_ids, min_costs = (
            get_per_store_features_from_measure_pairs(
                self._inputs, self._results
            )
        )
        keep = [i for i, f in enumerate(feats) if len(f) and np.any(f)]
        if len(keep) < 8:
            return
        self.internal.fit_base(
            self._embed([feats[i] for i in keep],
                        [self._inputs[i].task.workload_key for i in keep]),
            throughputs[keep],
        )

    def update_from_file(self, path: str, max_lines: Optional[int] = None):
        """Warm-start from a record log (reference mlp_model.py:848)."""
        from ..records.serde import load_records

        records = load_records(path, max_lines)
        self._inputs.extend(r.inp for r in records)
        self._results.extend(r.res for r in records)
        self.update(None, None)

    def _is_fit(self) -> bool:
        return (
            getattr(self.internal, "params", None) is not None
            or getattr(self.internal, "model", None) is not None
        )

    def predict(self, task: SearchTask, states: Sequence) -> np.ndarray:
        if not self._is_fit():
            # unfit model scores randomly (reference: an un-updated model
            # behaves like RandomModel until the first update)
            rng = np.random.default_rng(0)
            return rng.random(len(states)).astype(np.float32)
        feats = get_per_store_features_from_states(states, task)
        return self.internal.predict_on_features(
            self._embed(feats, [task.workload_key] * len(feats)))

    def predict_on_feature_list(self, task, feats) -> np.ndarray:
        """Score pre-extracted per-store feature matrices (the native GA
        featurises a generation in the host library and scores it here,
        without building States)."""
        if not self._is_fit():
            rng = np.random.default_rng(0)
            return rng.random(len(feats)).astype(np.float32)
        return self.internal.predict_on_features(
            self._embed(feats, [task.workload_key] * len(feats)))

    def save(self, path: str):
        self.internal.save(path)

    @classmethod
    def load(cls, path: str, kind: str = "mlp", device="cuda"):
        """A saved internal of ``kind`` (a pickle of this package's or of
        the JAX package's) on ``device``."""
        if kind == "mlp":
            from ..models.segment import MLPModelInternal

            return cls(MLPModelInternal.load(path, device=device), kind)
        if kind == "vae":
            from ..models.segment import SegmentVAEModelInternal

            return cls(SegmentVAEModelInternal.load(path, device=device),
                       kind)
        if kind in ("gbdt", "xgb", "lgb", "lgbm"):
            from ..models.gbdt import GBDTModelInternal

            return cls(GBDTModelInternal.load(path, device=device), kind)
        from ..models.variants import SequenceModelInternal

        return cls(SequenceModelInternal.load(path, device=device), kind)


class PlusMixCostModel(LearnedCostModel):
    """Frozen pretrained base + delta model refit on local measurements
    (the reference's ``plus_mix_task`` few-shot mode driving its
    transfer_tune second stage: mlp_model.py:446-474 trains ONE delta
    model — calibrated rmse loss, hidden 128, sigmoid head — on
    ``throughput - base_pred`` residuals of everything measured so far,
    and predicts ``base + delta`` for every task;
    task_scheduler.py:562-574 rebuilds the policies with it).

    ``update()`` refits only the delta; the base never moves. The delta
    lives on the base's device."""

    def __init__(self, base: LearnedCostModel, kind: str = "mlp"):
        device = base.device
        if kind in NEURAL_KINDS:
            from ..models.segment import MLPModelInternal

            extra = base._embed_total if base.use_workload_embedding else 0
            delta = MLPModelInternal(in_dim=164 + extra, hidden_dim=128,
                                     loss_type="rmse", device=device)
            delta.use_workload_embedding = base.use_workload_embedding
            delta.workload_embed_total_dim = base._embed_total
            super().__init__(internal=delta, kind="mlp")
        else:
            # tree-model delta of the same family (reference XGB plus_mix
            # follows the identical residual protocol, xgb_model.py)
            super().__init__(kind=kind, device=device)
            self.use_workload_embedding = base.use_workload_embedding
            self._embed_total = base._embed_total
            self.internal.use_workload_embedding = base.use_workload_embedding
            self.internal.workload_embed_total_dim = base._embed_total
        self.base = base

    def _base_predict(self, feats, workload_keys) -> np.ndarray:
        preds = self.base.internal.predict_on_features(
            self.base._embed(feats, workload_keys))
        return np.where(np.isfinite(preds), preds, 0.0)

    def update(self, inputs, results):
        if inputs:
            self._inputs.extend(inputs)
            self._results.extend(results)
        if not self._inputs:
            return
        from ..features.per_store import (
            get_per_store_features_from_measure_pairs,
        )

        feats, throughputs, _, _ = (
            get_per_store_features_from_measure_pairs(
                self._inputs, self._results))
        keep = [i for i, f in enumerate(feats) if len(f) and np.any(f)]
        if len(keep) < 8:
            return
        kept = [feats[i] for i in keep]
        keys = [self._inputs[i].task.workload_key for i in keep]
        residual = throughputs[keep] - self._base_predict(kept, keys)
        self.internal.fit_base(self._embed(kept, keys),
                               residual.astype(np.float32))

    def predict(self, task: SearchTask, states: Sequence) -> np.ndarray:
        feats = get_per_store_features_from_states(states, task)
        return self.predict_on_feature_list(task, feats)

    def predict_on_feature_list(self, task, feats) -> np.ndarray:
        base = self._base_predict(feats, [task.workload_key] * len(feats))
        if not self._is_fit():
            return base.astype(np.float32)
        delta = self.internal.predict_on_features(
            self._embed(feats, [task.workload_key] * len(feats)))
        delta = np.where(np.isfinite(delta), delta, 0.0)
        return (base + delta).astype(np.float32)


def parse_search_policy(search_policy: str):
    """(model kind, frozen) of a 'sketch[.<kind>[-no-update]]' spec;
    'random' for plain 'sketch'."""
    kind, no_update = "random", False
    if "." in search_policy:
        _, kind = search_policy.split(".", 1)
        if kind.endswith("-no-update"):
            kind = kind[: -len("-no-update")]
            no_update = True
    return kind, no_update


def make_search_policies(search_policy: str, tasks, seed: int = 0,
                         load_model_file: Optional[str] = None,
                         load_log_file: Optional[str] = None,
                         num_measures_per_round: int = 16, device="cuda"):
    """Per-task policies for 'sketch.<model>' specs (reference
    task_scheduler.py:44-172 make_search_policies; '-no-update' suffix
    freezes a pretrained model). A pretrained model updating online
    gets the reference's warm-up gate (num_warmup_sample =
    len(tasks) * num_measures_per_round, task_scheduler.py:100-102) so
    its first refit waits for a meaningful local sample. A learned model
    lives on ``device``."""
    from .sketch import SketchPolicy

    kind, no_update = parse_search_policy(search_policy)
    if kind == "random":
        model = RandomCostModel(seed)
    else:
        if load_model_file:
            model = LearnedCostModel.load(load_model_file, kind,
                                          device=device)
            model.num_warmup_sample = len(tasks) * num_measures_per_round
        else:
            model = LearnedCostModel(kind=kind, device=device)
        if load_log_file:
            model.update_from_file(load_log_file)
        if no_update:
            model.update = lambda *a, **k: None
    return [
        SketchPolicy(t, model, seed=seed + i) for i, t in enumerate(tasks)
    ], model
