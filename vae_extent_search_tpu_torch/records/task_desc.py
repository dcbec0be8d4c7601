"""Compile a task's DAG into the flat affine descriptor consumed by the
native featurizer (``csrc/host/extent_featurizer.cpp``); counterpart of
``vae_extent_search_tpu/records/task_desc.py``, element for element.

The native replay needs op extents and affine access maps only — the
Python expression IR is lowered once per task into an int32 stream:

    n_ops
    per op:
      kind (0 placeholder / 1 compute)
      n_dims, extents...
      n_reduce, reduce extents...
      n_reads
      per read:
        src_op_id
        n_idx
        per idx expr: n_terms, (var_ref, coeff) * n_terms, const
          var_ref: 0..n_dims-1 = spatial dim, n_dims.. = reduce dim

Ops whose reads are not affine in the iteration vars raise
NonAffineError: the native side then derives the op table from the
full-expression descriptor (``expr_desc.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ir import expr as E
from ..ir.tensor import ComputeOp, PlaceholderOp


class NonAffineError(Exception):
    pass


def _affine_terms(e: E.Expr, var_index: Dict) -> tuple:
    """-> (dict var_ref -> coeff, const). Raises NonAffineError."""
    if isinstance(e, E.IntImm):
        return {}, e.value
    if isinstance(e, E.Var):
        if e not in var_index:
            raise NonAffineError(f"unknown var {e.name}")
        return {var_index[e]: 1}, 0
    if isinstance(e, E.Add):
        ta, ca = _affine_terms(e.a, var_index)
        tb, cb = _affine_terms(e.b, var_index)
        out = dict(ta)
        for k, v in tb.items():
            out[k] = out.get(k, 0) + v
        return out, ca + cb
    if isinstance(e, E.Sub):
        ta, ca = _affine_terms(e.a, var_index)
        tb, cb = _affine_terms(e.b, var_index)
        out = dict(ta)
        for k, v in tb.items():
            out[k] = out.get(k, 0) - v
        return out, ca - cb
    if isinstance(e, E.Mul):
        if isinstance(e.b, E.IntImm):
            t, c = _affine_terms(e.a, var_index)
            return {k: v * e.b.value for k, v in t.items()}, c * e.b.value
        if isinstance(e.a, E.IntImm):
            t, c = _affine_terms(e.b, var_index)
            return {k: v * e.a.value for k, v in t.items()}, c * e.a.value
    raise NonAffineError(f"non-affine index {type(e).__name__}")


def build_task_desc(dag) -> np.ndarray:
    """int32 descriptor for the DAG's original op list."""
    op_index = {op.uid: i for i, op in enumerate(dag.ops)}
    out: List[int] = [len(dag.ops)]
    for op in dag.ops:
        if isinstance(op, PlaceholderOp):
            out.append(0)
            out.append(len(op.shape))
            out.extend(int(s) for s in op.shape)
            out.append(0)  # n_reduce
            out.append(0)  # n_reads
            continue
        assert isinstance(op, ComputeOp)
        out.append(1)
        out.append(len(op.axes))
        out.extend(d.extent for d in op.axes)
        out.append(len(op.reduce_axes))
        out.extend(d.extent for d in op.reduce_axes)

        var_index = {}
        for i, d in enumerate(op.axes):
            var_index[d.var] = i
        for i, d in enumerate(op.reduce_axes):
            var_index[d.var] = len(op.axes) + i

        reads = E.collect_reads(op.body)
        read_blobs = []
        for r in reads:
            src = op_index.get(r.tensor.op.uid)
            if src is None:
                continue
            blob = [src, len(r.indices)]
            for idx in r.indices:
                terms, const = _affine_terms(idx, var_index)
                blob.append(len(terms))
                for var_ref, coeff in sorted(terms.items()):
                    blob.extend([var_ref, coeff])
                blob.append(const)
            read_blobs.append(blob)
        out.append(len(read_blobs))
        for blob in read_blobs:
            out.extend(blob)
    return np.asarray(out, np.int32)
