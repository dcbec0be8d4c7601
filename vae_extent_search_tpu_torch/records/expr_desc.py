"""Serialize full op-body expression trees for the native featurizer
(counterpart of ``vae_extent_search_tpu/records/expr_desc.py``, element
for element).

The affine descriptor (task_desc.py) covers bound inference for affine
accesses; the per-store featurizer additionally needs op counting,
Select/padding semantics and non-affine (winograd) indices — so ops are
also shipped as full prefix-encoded expression trees.

Stream layout (int32, floats bit-cast):
    per op: n_dims, dims..., n_reduce, reduce..., dtype_bytes,
            body_len, body_stream...
    node kinds:
      0 IntImm    [0, lo32, hi32]
      1 FloatImm  [1, bits_lo, bits_hi]   (f64 bit pattern)
      2 Var       [2, dim_ref]            (spatial 0.., then reduce)
      3..10 Add Sub Mul Div FloorDiv FloorMod Min Max
                  [k, is_float] a b
      11 Cmp      [11, is_float] a b
      12 And      [12, n] parts...
      13 Or       [13, n] parts...
      14 Select   [14] c t f
      15 Cast     [15, is_float] v
      16 Call     [16, is_float, n_args] args...
      17 Read     [17, src_op, n_idx] idx...
      18 Reduce   [18, combiner(0 sum,1 max,2 min)] value
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from ..ir import expr as E
from ..ir.tensor import ComputeOp, PlaceholderOp

_BIN_KINDS = {
    E.Add: 3, E.Sub: 4, E.Mul: 5, E.Div: 6, E.FloorDiv: 7, E.FloorMod: 8,
    E.Min: 9, E.Max: 10,
}
_COMBINER = {"sum": 0, "max": 1, "min": 2}


def _is_float(e: E.Expr) -> bool:
    return e.dtype.startswith("float") or e.dtype.startswith("bfloat")


def _emit(e: E.Expr, out: List[int], var_index: Dict, op_index: Dict):
    t = type(e)
    if isinstance(e, E.IntImm):
        v = int(e.value)
        out.extend([0, v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF])
    elif isinstance(e, E.FloatImm):
        bits = struct.unpack("<Q", struct.pack("<d", float(e.value)))[0]
        out.extend([1, bits & 0xFFFFFFFF, (bits >> 32) & 0xFFFFFFFF])
    elif isinstance(e, E.Var):
        out.extend([2, var_index[e]])
    elif t in _BIN_KINDS:
        out.extend([_BIN_KINDS[t], int(_is_float(e.a))])
        _emit(e.a, out, var_index, op_index)
        _emit(e.b, out, var_index, op_index)
    elif isinstance(e, E.Cmp):
        out.extend([11, int(_is_float(e.a))])
        _emit(e.a, out, var_index, op_index)
        _emit(e.b, out, var_index, op_index)
    elif isinstance(e, E.And):
        out.extend([12, len(e.parts)])
        for p in e.parts:
            _emit(p, out, var_index, op_index)
    elif isinstance(e, E.Or):
        out.extend([13, len(e.parts)])
        for p in e.parts:
            _emit(p, out, var_index, op_index)
    elif isinstance(e, E.Select):
        out.append(14)
        _emit(e.cond, out, var_index, op_index)
        _emit(e.true_value, out, var_index, op_index)
        _emit(e.false_value, out, var_index, op_index)
    elif isinstance(e, E.Cast):
        out.extend([15, int(_is_float(e))])
        _emit(e.value, out, var_index, op_index)
    elif isinstance(e, E.Call):
        out.extend([16, int(_is_float(e)), len(e.args)])
        for a in e.args:
            _emit(a, out, var_index, op_index)
    elif isinstance(e, E.TensorRead):
        src = op_index.get(e.tensor.op.uid, -1)
        out.extend([17, src, len(e.indices)])
        for i in e.indices:
            _emit(i, out, var_index, op_index)
    elif isinstance(e, E.Reduce):
        out.extend([18, _COMBINER[e.combiner]])
        _emit(e.value, out, var_index, op_index)
    else:
        raise ValueError(f"cannot serialize {t.__name__}")


def _dtype_bytes(dtype: str) -> int:
    if dtype.endswith("64"):
        return 8
    if dtype.endswith("16"):
        return 2
    if dtype.endswith("8"):
        return 1
    return 4


def build_expr_desc(dag) -> np.ndarray:
    """Full-expression descriptor for the DAG's op list (int32 stream)."""
    op_index = {op.uid: i for i, op in enumerate(dag.ops)}
    out: List[int] = [len(dag.ops)]
    for op in dag.ops:
        if isinstance(op, PlaceholderOp):
            out.append(0)  # kind placeholder
            out.append(len(op.shape))
            out.extend(int(s) for s in op.shape)
            out.append(0)
            out.append(_dtype_bytes(op.dtype))
            out.append(0)  # body_len
            continue
        assert isinstance(op, ComputeOp)
        out.append(1)
        out.append(len(op.axes))
        out.extend(d.extent for d in op.axes)
        out.append(len(op.reduce_axes))
        out.extend(d.extent for d in op.reduce_axes)
        out.append(_dtype_bytes(op.dtype))

        var_index = {}
        for i, d in enumerate(op.axes):
            var_index[d.var] = i
        for i, d in enumerate(op.reduce_axes):
            var_index[d.var] = len(op.axes) + i

        body: List[int] = []
        _emit(op.body, body, var_index, op_index)
        out.append(len(body))
        out.extend(body)
    # mask to int32 range
    return np.asarray(out, np.int64).astype(np.uint32).view(np.int32)
