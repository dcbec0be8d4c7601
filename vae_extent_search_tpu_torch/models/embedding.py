"""Workload (task) embedding for cost models (a copy of
``vae_extent_search_tpu/models/embedding.py`` with imports local to the
port).

Parity target: ``get_workload_embedding`` (reference
cost_model/xgb_model.py:79-87 == lgbm_model.py:81-89): a 9-dim binary
vector marking whether each of nine op-tag substrings appears in
``str(ComputeDAG(workload_key_to_tensors(key)))``. The MLP pads it to 10
dims (slot 9 reserved for an optional target one-hot,
mlp_model.py:52-66) and tiles it onto every per-store feature row; the
XGB/LGBM models append the 9 raw dims per row (xgb_model.py:301-304).

Our DAG repr is op-name-only, so ``workload_dag_str`` synthesizes the
TVM-ish text the tags were written against: one line per compute op,
``name(ax0, ax1, ...) <comb>= ...`` where <comb> mirrors TVM's reduce
printing (``+=`` / ``max=`` / ``min=``). Tag semantics are preserved
because our workload library uses the TVM op names ('Conv2dOutput',
'T_softmax_maxelem', 'T_add', default 'compute' with lambda-named axes,
...) — e.g. 'compute(b, i, j)' still singles out batch_matmul and
'max' hits both softmax max-elem stages and max-pooling reductions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# exact reference tag list and order (xgb_model.py:80-81)
WORKLOAD_EMBED_TAGS = [
    "max", "min", "add", "Conv2dOutput", "conv2d_winograd",
    "DepthwiseConv2d", "dense", "softmax", "compute(b, i, j)",
]
WORKLOAD_EMBED_DIM = len(WORKLOAD_EMBED_TAGS)  # 9
# the MLP loader pads to 10 (slot 9 = optional target one-hot slot)
MLP_EMBED_DIM = 10

_CACHE: Dict[str, np.ndarray] = {}


def _body_op_tokens(e, out) -> None:
    """Collect max/min operator tokens appearing in a compute body —
    TVM's DAG printer emits full expressions, so e.g. a relu body
    ``max(T_add[...], 0f)`` makes the 'max' tag fire in the reference;
    eliding bodies would lose those hits for every relu/clip workload."""
    from ..ir import expr as E

    if isinstance(e, (E.Max, E.Min)):
        out.add(e.op)
    if isinstance(e, E._Bin):
        _body_op_tokens(e.a, out)
        _body_op_tokens(e.b, out)
    elif isinstance(e, E.Cmp):
        _body_op_tokens(e.a, out)
        _body_op_tokens(e.b, out)
    elif isinstance(e, (E.And, E.Or)):
        for p in e.parts:
            _body_op_tokens(p, out)
    elif isinstance(e, E.Select):
        _body_op_tokens(e.cond, out)
        _body_op_tokens(e.true_value, out)
        _body_op_tokens(e.false_value, out)
    elif isinstance(e, E.Cast):
        _body_op_tokens(e.value, out)
    elif isinstance(e, E.Call):
        out.add(e.func)
        for a in e.args:
            _body_op_tokens(a, out)
    elif isinstance(e, E.TensorRead):
        for i in e.indices:
            _body_op_tokens(i, out)
    elif isinstance(e, E.Reduce):
        _body_op_tokens(e.value, out)


def workload_dag_str(workload_key: str) -> str:
    """TVM-flavored DAG text for tag matching (see module docstring)."""
    from ..ir.dag import ComputeDAG
    from ..ir import expr as E
    from ..records.workload import workload_key_to_tensors

    dag = ComputeDAG(workload_key_to_tensors(workload_key))
    lines = []
    for op in dag.ops:
        if op.is_placeholder:
            continue
        axes = ", ".join(ax.name for ax in op.axes)
        body = getattr(op, "body", None)
        if isinstance(body, E.Reduce):
            comb = {"sum": "+=", "max": "max=", "min": "min="}.get(
                body.combiner, "=")
        else:
            comb = "="
        toks: set = set()
        if body is not None:
            _body_op_tokens(body, toks)
        body_txt = " ".join(f"{t}(..)" for t in sorted(toks)) or ".."
        lines.append(f"{op.name}({axes}) {comb} {body_txt}")
    return "\n".join(lines)


def get_workload_embedding(workload_key: str) -> np.ndarray:
    """9-dim binary tag vector for a workload key (cached)."""
    emb = _CACHE.get(workload_key)
    if emb is None:
        try:
            dag_str = workload_dag_str(workload_key)
        except Exception:
            # unreconstructable key (e.g. unregistered hash): zero
            # embedding, same effect as no tag matching
            dag_str = ""
        emb = np.array(
            [1.0 if tag in dag_str else 0.0 for tag in WORKLOAD_EMBED_TAGS],
            np.float32,
        )
        _CACHE[workload_key] = emb
    return emb


def append_workload_embedding(features_list: Sequence[np.ndarray],
                              workload_keys: Sequence[str],
                              total_dim: int = MLP_EMBED_DIM
                              ) -> List[np.ndarray]:
    """Tile each program's task embedding onto its feature rows
    (SegmentDataLoader semantics, mlp_model.py:52-80). ``workload_keys``
    is per program (same length as ``features_list``); the 9 tag dims
    are zero-padded to ``total_dim``."""
    out = []
    for feats, key in zip(features_list, workload_keys):
        emb = get_workload_embedding(key)
        if total_dim > WORKLOAD_EMBED_DIM:
            emb = np.concatenate(
                [emb, np.zeros(total_dim - WORKLOAD_EMBED_DIM, np.float32)])
        feats = np.asarray(feats, np.float32)
        tiled = np.tile(emb, (len(feats), 1))
        out.append(np.concatenate([feats, tiled], axis=1)
                   if len(feats) else feats)
    return out


def embed_for_model(model, features_list, workload_key: str):
    """Featurize a task's programs the way ``model`` was fitted: append
    the workload embedding iff the model carries the contract
    (``use_workload_embedding`` / ``workload_embed_total_dim`` persisted
    by save/load). The single call site for prediction-side embedding —
    scripts must not reimplement this with diverging defaults."""
    if not getattr(model, "use_workload_embedding", False):
        return features_list
    total = getattr(model, "workload_embed_total_dim", MLP_EMBED_DIM)
    return append_workload_embedding(
        features_list, [workload_key] * len(features_list), total_dim=total)
