"""Tensor-expression-lite: placeholders, compute ops, DAGs.

The minimal te surface the Ansor layer consumes (reference:
python/tvm/auto_scheduler uses te.compute / te.placeholder to define
workloads, and src/auto_scheduler/compute_dag.cc builds a ComputeDAG from the
output tensors). We keep the same user-facing shape:

    A = placeholder((M, K), name="A")
    k = reduce_axis(K, name="k")
    C = compute((M, N), lambda i, j: sum_reduce(A[i, k] * B[k, j], [k]), "C")

but everything underneath is our own small immutable IR.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from . import expr as E


_uid_counter = itertools.count()


def _fresh_uid() -> int:
    return next(_uid_counter)


class IterDim:
    """An original iteration dimension of a compute op (spatial or reduce).

    Acts as an Expr Var when used inside index expressions. ``extent`` is
    an int for static dims; reduce dims may carry a symbolic Expr extent
    (data-dependent loops, e.g. the sparse_dense row-length reduction —
    reference topi/nn/sparse.py:199-230 builds Range(0, row_elems)).
    """

    __slots__ = ("var", "name", "extent", "kind")

    def __init__(self, name: str, extent, kind: str = "spatial"):
        self.name = name
        self.extent = extent if isinstance(extent, E.Expr) else int(extent)
        self.kind = kind  # "spatial" | "reduce"
        self.var = E.Var(name)

    def __repr__(self):
        return f"IterDim({self.name}, {self.extent}, {self.kind})"


class Op:
    """Base operation."""

    name: str

    @property
    def is_placeholder(self) -> bool:
        return isinstance(self, PlaceholderOp)


class PlaceholderOp(Op):
    def __init__(self, name: str, shape: Sequence[int], dtype: str = "float32"):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.uid = _fresh_uid()

    def output(self, idx: int = 0) -> "Tensor":
        assert idx == 0
        return Tensor(self, self.shape, self.dtype)

    def __repr__(self):
        return f"PlaceholderOp({self.name}, {self.shape})"


class ComputeOp(Op):
    def __init__(
        self,
        name: str,
        axes: List[IterDim],
        body: E.Expr,
        dtype: str = "float32",
        tag: str = "",
        attrs: Optional[dict] = None,
    ):
        self.name = name
        self.axes = list(axes)  # spatial dims in order
        self.body = body
        self.dtype = dtype
        self.tag = tag
        self.attrs = dict(attrs) if attrs else {}
        self.uid = _fresh_uid()
        # reduce axes are discovered from the body's Reduce node (if any)
        self.reduce_axes: List[IterDim] = []
        if isinstance(body, E.Reduce):
            self.reduce_axes = list(body.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(d.extent for d in self.axes)

    def output(self, idx: int = 0) -> "Tensor":
        assert idx == 0
        return Tensor(self, self.shape, self.dtype)

    def inner_expr(self) -> E.Expr:
        """Body stripped of the outer Reduce wrapper (if present)."""
        return self.body.value if isinstance(self.body, E.Reduce) else self.body

    def input_tensors(self) -> List["Tensor"]:
        seen, out = set(), []
        for r in E.collect_reads(self.body):
            key = r.tensor.op.uid
            if key not in seen:
                seen.add(key)
                out.append(r.tensor)
        return out

    def reads_of(self, tensor: "Tensor") -> List[E.TensorRead]:
        return [
            r
            for r in E.collect_reads(self.body)
            if r.tensor.op.uid == tensor.op.uid
        ]

    def reads_of_uids(self, uids) -> List[E.TensorRead]:
        return [
            r for r in E.collect_reads(self.body) if r.tensor.op.uid in uids
        ]

    def __repr__(self):
        return f"ComputeOp({self.name}, {self.shape})"


@dataclass(frozen=True)
class Tensor:
    op: Op
    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def name(self) -> str:
        return self.op.name

    def __getitem__(self, indices) -> E.TensorRead:
        if not isinstance(indices, tuple):
            indices = (indices,)
        idx_exprs = []
        for i in indices:
            if isinstance(i, IterDim):
                idx_exprs.append(i.var)
            elif isinstance(i, E.Expr):
                idx_exprs.append(i)
            else:
                idx_exprs.append(E.const(i))
        return E.TensorRead(self, tuple(idx_exprs))

    def __hash__(self):
        return hash((self.op.uid, self.shape))

    def __eq__(self, other):
        return isinstance(other, Tensor) and other.op.uid == self.op.uid


# ---------------------------------------------------------------------------
# Public construction API
# ---------------------------------------------------------------------------


def placeholder(shape, name: str = "placeholder", dtype: str = "float32") -> Tensor:
    return PlaceholderOp(name, shape, dtype).output()


def reduce_axis(extent, name: str = "k") -> IterDim:
    if isinstance(extent, tuple):
        lo, hi = extent
        assert lo == 0 or isinstance(lo, E.Expr), \
            "only 0-based reduce axes supported"
        extent = hi if lo == 0 else (hi - lo)
    return IterDim(name, extent, kind="reduce")


_DEFAULT_AXIS_NAMES = ["i", "j", "k", "l", "m", "n"]


def compute(shape, fcompute: Callable, name: str, tag: str = "", dtype=None,
            attrs: Optional[dict] = None) -> Tensor:
    """Create a compute op. ``fcompute`` receives one IterDim per dim."""
    shape = tuple(int(s) for s in shape)
    n = len(shape)
    try:
        import inspect

        argnames = list(inspect.signature(fcompute).parameters)
    except (TypeError, ValueError):
        argnames = []
    if len(argnames) != n:
        argnames = [
            _DEFAULT_AXIS_NAMES[d] if d < len(_DEFAULT_AXIS_NAMES) else f"ax{d}"
            for d in range(n)
        ]
    axes = [IterDim(argnames[d], shape[d], "spatial") for d in range(n)]
    body = fcompute(*axes)
    if isinstance(body, IterDim):
        body = body.var
    if not isinstance(body, E.Expr):
        body = E.const(body)
    out_dtype = dtype or getattr(body, "dtype", "float32")
    if out_dtype == "int32" and not isinstance(body, E.Reduce):
        # compute outputs default to float32 unless explicitly integer
        out_dtype = dtype or "float32"
    op = ComputeOp(name, axes, body, dtype=dtype or "float32", tag=tag,
                   attrs=attrs)
    return op.output()


def sum_reduce(value: E.Expr, axes: Sequence[IterDim]) -> E.Reduce:
    return E.Reduce("sum", value, tuple(axes), init=0.0)


def max_reduce(value: E.Expr, axes: Sequence[IterDim]) -> E.Reduce:
    return E.Reduce("max", value, tuple(axes))


def min_reduce(value: E.Expr, axes: Sequence[IterDim]) -> E.Reduce:
    return E.Reduce("min", value, tuple(axes))


# ---------------------------------------------------------------------------
# DAG utilities
# ---------------------------------------------------------------------------


def topo_sort_ops(out_tensors: Sequence[Tensor]) -> List[Op]:
    """Topological order of all ops reachable from the tensor list.

    Bit-exact replication of the reference's stage ordering contract
    (compute_dag.cc:62-128 TopoSortOps): a stack DFS from the tensor list
    assigns discovery priorities, then Kahn's algorithm emits zero-degree
    ops highest-priority-first. Record stage ids depend on this order.
    """
    degree: dict = {}
    edge_set: dict = {}
    priority: dict = {}
    visited = set()
    by_uid: dict = {}

    stack = [t.op for t in out_tensors]
    ct = 0
    while stack:
        op = stack.pop()
        if op.uid in visited:
            continue
        priority[op.uid] = ct
        ct += 1
        visited.add(op.uid)
        by_uid[op.uid] = op
        if isinstance(op, PlaceholderOp):
            degree[op.uid] = 0
        else:
            inputs = op.input_tensors()
            degree[op.uid] = len(inputs)
            for ten in inputs:
                edge_set.setdefault(ten.op.uid, []).append(op.uid)
                stack.append(ten.op)

    import heapq

    # max-heap on priority via negation
    heap = [(-priority[uid], uid) for uid, d in degree.items() if d == 0]
    heapq.heapify(heap)
    order: List[Op] = []
    while heap:
        _, uid = heapq.heappop(heap)
        order.append(by_uid[uid])
        for dst in edge_set.get(uid, ()):
            degree[dst] -= 1
            if degree[dst] == 0:
                heapq.heappush(heap, (-priority[dst], dst))
    return order


def estimate_flops(ops: Sequence[Op]) -> float:
    """FLOP estimate: per compute op, math-op count of the body x the product
    of spatial and reduce extents (reference compute_dag.cc:549 FlopEstimator).
    """
    total = 0.0
    for op in ops:
        if not isinstance(op, ComputeOp):
            continue
        if "FLOP" in op.attrs:
            # explicit attr override (reference compute_dag.cc FlopEstimator
            # honors the op's "FLOP" attr, used by sparse workloads)
            total += float(op.attrs["FLOP"])
            continue
        counts = E.count_math_ops(op.body)
        per_point = sum(
            v
            for k, v in counts.items()
            if k.startswith("float_") or k in ("bool_op", "select_op")
        )
        if isinstance(op.body, E.Reduce):
            per_point += 1  # the reduce combiner op (FlopEstimator counts it)
        vol = 1.0
        for d in op.axes:
            vol *= d.extent
        for d in op.reduce_axes:
            # symbolic (data-dependent) extents count as 1, like the
            # reference's GetIntImm fallback on non-const loop extents
            vol *= d.extent if isinstance(d.extent, int) else 1
        total += per_point * vol
    return total
