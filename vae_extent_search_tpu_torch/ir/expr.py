"""Scalar expression IR for the tensor-expression layer.

A deliberately small, immutable expression tree. It has to support:

- building compute-op bodies (workload registry),
- interval (range) analysis for demand-driven bound inference,
- math-op counting for FLOP estimation and per-store features,
- structural hashing for workload keys.

This is our own design; the capability it mirrors in the reference is TVM's
PrimExpr (used by auto_scheduler via te/tir), see e.g.
reference src/auto_scheduler/compute_dag.cc:549 (FlopEstimator walks
expression trees) — we keep only what the Ansor layer consumes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


class Expr:
    """Base class for all scalar expressions."""

    dtype: str = "float32"

    # Arithmetic sugar so workload definitions read naturally.
    def __add__(self, other):
        return Add(self, _wrap(other))

    def __radd__(self, other):
        return Add(_wrap(other), self)

    def __sub__(self, other):
        return Sub(self, _wrap(other))

    def __rsub__(self, other):
        return Sub(_wrap(other), self)

    def __mul__(self, other):
        return Mul(self, _wrap(other))

    def __rmul__(self, other):
        return Mul(_wrap(other), self)

    def __truediv__(self, other):
        return Div(self, _wrap(other))

    def __rtruediv__(self, other):
        return Div(_wrap(other), self)

    def __floordiv__(self, other):
        return FloorDiv(self, _wrap(other))

    def __mod__(self, other):
        return FloorMod(self, _wrap(other))

    def __gt__(self, other):
        return Cmp(">", self, _wrap(other))

    def __ge__(self, other):
        return Cmp(">=", self, _wrap(other))

    def __lt__(self, other):
        return Cmp("<", self, _wrap(other))

    def __le__(self, other):
        return Cmp("<=", self, _wrap(other))

    def equal(self, other):
        return Cmp("==", self, _wrap(other))


def _wrap(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return IntImm(int(v), dtype="bool")
    if isinstance(v, int):
        return IntImm(v)
    if isinstance(v, float):
        return FloatImm(v)
    raise TypeError(f"cannot lift {type(v)} into Expr")


@dataclass(frozen=True)
class IntImm(Expr):
    value: int
    dtype: str = "int32"


@dataclass(frozen=True)
class FloatImm(Expr):
    value: float
    dtype: str = "float32"


@dataclass(frozen=True)
class Var(Expr):
    """A loop/iteration variable (identified by object identity)."""

    name: str
    dtype: str = "int32"

    # object identity semantics: two Vars with the same name are distinct
    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


@dataclass(frozen=True)
class _Bin(Expr):
    a: Expr
    b: Expr

    def __post_init__(self):
        # result dtype follows the operands (both sides match in practice;
        # prefer the float side, mirroring TVM's implicit promotion)
        da, db = self.a.dtype, self.b.dtype
        dt = da if (da.startswith("float") or da.startswith("bfloat")) else db
        object.__setattr__(self, "dtype", dt)


class Add(_Bin):
    op = "add"


class Sub(_Bin):
    op = "sub"


class Mul(_Bin):
    op = "mul"


class Div(_Bin):
    op = "div"


class FloorDiv(_Bin):
    op = "floordiv"


class FloorMod(_Bin):
    op = "floormod"


class Min(_Bin):
    op = "min"


class Max(_Bin):
    op = "max"


@dataclass(frozen=True)
class Cmp(Expr):
    op: str  # one of > >= < <= == !=
    a: Expr = None
    b: Expr = None
    dtype: str = "bool"


@dataclass(frozen=True)
class And(Expr):
    parts: Tuple[Expr, ...]
    dtype: str = "bool"


@dataclass(frozen=True)
class Or(Expr):
    parts: Tuple[Expr, ...]
    dtype: str = "bool"


@dataclass(frozen=True)
class Select(Expr):
    cond: Expr
    true_value: Expr
    false_value: Expr


@dataclass(frozen=True)
class Cast(Expr):
    value: Expr
    dtype: str = "float32"


@dataclass(frozen=True)
class Call(Expr):
    """Math intrinsic: exp, sqrt, sigmoid, ..."""

    func: str
    args: Tuple[Expr, ...]


@dataclass(frozen=True)
class TensorRead(Expr):
    """Read tensor[indices]; tensor is ir.tensor.Tensor (kept loose here)."""

    tensor: object
    indices: Tuple[Expr, ...]

    def __post_init__(self):
        object.__setattr__(self, "dtype", getattr(self.tensor, "dtype", "float32"))


@dataclass(frozen=True)
class Reduce(Expr):
    """Reduction over axes (IterDims from tensor.py) with a combiner.

    combiner: "sum" | "max" | "min"
    """

    combiner: str
    value: Expr
    axes: Tuple[object, ...]  # tuple of IterDim
    init: Optional[float] = None


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def const(v, dtype=None) -> Expr:
    e = _wrap(v)
    if dtype is not None:
        if isinstance(e, IntImm):
            e = IntImm(e.value, dtype=dtype)
        elif isinstance(e, FloatImm):
            e = FloatImm(e.value, dtype=dtype)
    return e


def if_then_else(cond, t, f) -> Expr:
    return Select(_wrap(cond), _wrap(t), _wrap(f))


def exp(x):
    return Call("exp", (_wrap(x),))


def sqrt(x):
    return Call("sqrt", (_wrap(x),))


def rsqrt(x):
    return Call("rsqrt", (_wrap(x),))


def log(x):
    return Call("log", (_wrap(x),))


def sigmoid(x):
    return Call("sigmoid", (_wrap(x),))


def tanh(x):
    return Call("tanh", (_wrap(x),))


def pow_(x, y):
    return Call("pow", (_wrap(x), _wrap(y)))


def erf(x):
    return Call("erf", (_wrap(x),))


def max_expr(a, b):
    return Max(_wrap(a), _wrap(b))


def min_expr(a, b):
    return Min(_wrap(a), _wrap(b))


# ---------------------------------------------------------------------------
# Interval arithmetic — the workhorse of demand-driven bound inference.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Interval:
    """Closed integer interval [lo, hi]."""

    lo: int
    hi: int

    @property
    def extent(self) -> int:
        return self.hi - self.lo + 1

    def __add__(self, o):
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, o):
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def __mul__(self, o):
        cands = (self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi)
        return Interval(min(cands), max(cands))


def eval_interval(e: Expr, env: dict) -> Interval:
    """Evaluate the integer range of ``e`` given Var -> Interval bindings.

    Unbound Vars evaluate to [0, 0] (they are outer loop vars pinned to a
    single point from the perspective of the region being analyzed).
    """
    if isinstance(e, IntImm):
        return Interval(e.value, e.value)
    if isinstance(e, FloatImm):
        v = int(e.value)
        return Interval(v, v)
    if isinstance(e, Var):
        return env.get(e, Interval(0, 0))
    if isinstance(e, Add):
        return eval_interval(e.a, env) + eval_interval(e.b, env)
    if isinstance(e, Sub):
        return eval_interval(e.a, env) - eval_interval(e.b, env)
    if isinstance(e, Mul):
        return eval_interval(e.a, env) * eval_interval(e.b, env)
    if isinstance(e, FloorDiv):
        a, b = eval_interval(e.a, env), eval_interval(e.b, env)
        cands = []
        for x in (a.lo, a.hi):
            for y in (b.lo, b.hi):
                if y != 0:
                    cands.append(x // y)
        if not cands:
            return Interval(0, 0)
        return Interval(min(cands), max(cands))
    if isinstance(e, FloorMod):
        b = eval_interval(e.b, env)
        a = eval_interval(e.a, env)
        if b.lo == b.hi and b.lo > 0:
            m = b.lo
            if a.lo == a.hi:
                return Interval(a.lo % m, a.lo % m)
            # non-point ranges widen to the full period — mirrors TVM's
            # arith::ConstIntBound for floormod (it does not track
            # non-wrapping spans), which the demand analysis must match
            return Interval(0, min(m - 1, max(a.hi, 0)))
        return Interval(0, max(abs(b.lo), abs(b.hi)))
    if isinstance(e, Min):
        a, b = eval_interval(e.a, env), eval_interval(e.b, env)
        return Interval(min(a.lo, b.lo), min(a.hi, b.hi))
    if isinstance(e, Max):
        a, b = eval_interval(e.a, env), eval_interval(e.b, env)
        return Interval(max(a.lo, b.lo), max(a.hi, b.hi))
    if isinstance(e, Select):
        t = eval_interval(e.true_value, env)
        f = eval_interval(e.false_value, env)
        return Interval(min(t.lo, f.lo), max(t.hi, f.hi))
    if isinstance(e, Cast):
        return eval_interval(e.value, env)
    if isinstance(e, TensorRead):
        # data-dependent index (e.g. CSR indices/indptr loads): te's
        # ConstIntBound for an unknown int32 load is the full value range;
        # touched-region features over such reads are huge in the
        # reference too (slog compresses them)
        return Interval(-(1 << 31), (1 << 31) - 1)
    raise ValueError(f"cannot range-evaluate {type(e).__name__}")


def collect_vars(e: Expr, out=None) -> set:
    """All Vars appearing in ``e``."""
    if out is None:
        out = set()
    if isinstance(e, Var):
        out.add(e)
    elif isinstance(e, _Bin):
        collect_vars(e.a, out)
        collect_vars(e.b, out)
    elif isinstance(e, Cmp):
        collect_vars(e.a, out)
        collect_vars(e.b, out)
    elif isinstance(e, (And, Or)):
        for p in e.parts:
            collect_vars(p, out)
    elif isinstance(e, Select):
        collect_vars(e.cond, out)
        collect_vars(e.true_value, out)
        collect_vars(e.false_value, out)
    elif isinstance(e, Cast):
        collect_vars(e.value, out)
    elif isinstance(e, Call):
        for a in e.args:
            collect_vars(a, out)
    elif isinstance(e, TensorRead):
        for i in e.indices:
            collect_vars(i, out)
    elif isinstance(e, Reduce):
        collect_vars(e.value, out)
    return out


def collect_reads(e: Expr, out=None) -> list:
    """All TensorRead nodes appearing in ``e`` (in evaluation order)."""
    if out is None:
        out = []
    if isinstance(e, TensorRead):
        out.append(e)
        for i in e.indices:
            collect_reads(i, out)
    elif isinstance(e, _Bin):
        collect_reads(e.a, out)
        collect_reads(e.b, out)
    elif isinstance(e, Cmp):
        collect_reads(e.a, out)
        collect_reads(e.b, out)
    elif isinstance(e, (And, Or)):
        for p in e.parts:
            collect_reads(p, out)
    elif isinstance(e, Select):
        collect_reads(e.cond, out)
        collect_reads(e.true_value, out)
        collect_reads(e.false_value, out)
    elif isinstance(e, Cast):
        collect_reads(e.value, out)
    elif isinstance(e, Call):
        for a in e.args:
            collect_reads(a, out)
    elif isinstance(e, Reduce):
        collect_reads(e.value, out)
    return out


def substitute(e: Expr, mapping: dict) -> Expr:
    """Substitute Vars (by identity) with replacement Exprs."""
    if isinstance(e, Var):
        return mapping.get(e, e)
    if isinstance(e, (IntImm, FloatImm)):
        return e
    if isinstance(e, _Bin):
        return type(e)(substitute(e.a, mapping), substitute(e.b, mapping))
    if isinstance(e, Cmp):
        return Cmp(e.op, substitute(e.a, mapping), substitute(e.b, mapping))
    if isinstance(e, And):
        return And(tuple(substitute(p, mapping) for p in e.parts))
    if isinstance(e, Or):
        return Or(tuple(substitute(p, mapping) for p in e.parts))
    if isinstance(e, Select):
        return Select(
            substitute(e.cond, mapping),
            substitute(e.true_value, mapping),
            substitute(e.false_value, mapping),
        )
    if isinstance(e, Cast):
        return Cast(substitute(e.value, mapping), e.dtype)
    if isinstance(e, Call):
        return Call(e.func, tuple(substitute(a, mapping) for a in e.args))
    if isinstance(e, TensorRead):
        return TensorRead(e.tensor, tuple(substitute(i, mapping) for i in e.indices))
    if isinstance(e, Reduce):
        return Reduce(e.combiner, substitute(e.value, mapping), e.axes, e.init)
    raise ValueError(f"cannot substitute in {type(e).__name__}")


def count_math_ops(e: Expr) -> dict:
    """Count scalar math ops by class — feeds FLOP estimation and the
    per-store feature group 1 (reference feature.cc:173-260 MathOpCounter)."""
    counts = {
        "float_add_sub": 0,
        "float_mul": 0,
        "float_div_mod": 0,
        "float_cmp": 0,
        "float_math": 0,
        "int_add_sub": 0,
        "int_mul": 0,
        "int_div_mod": 0,
        "int_cmp": 0,
        "int_math": 0,
        "bool_op": 0,
        "select_op": 0,
    }

    def is_float(x: Expr) -> bool:
        return x.dtype.startswith("float") or x.dtype.startswith("bfloat")

    def walk(x: Expr):
        if isinstance(x, (Add, Sub)):
            counts["float_add_sub" if is_float(x.a) else "int_add_sub"] += 1
            walk(x.a), walk(x.b)
        elif isinstance(x, Mul):
            counts["float_mul" if is_float(x.a) else "int_mul"] += 1
            walk(x.a), walk(x.b)
        elif isinstance(x, (Div, FloorDiv, FloorMod)):
            counts["float_div_mod" if is_float(x.a) else "int_div_mod"] += 1
            walk(x.a), walk(x.b)
        elif isinstance(x, (Min, Max)):
            counts["float_cmp" if is_float(x.a) else "int_cmp"] += 1
            walk(x.a), walk(x.b)
        elif isinstance(x, Cmp):
            counts["float_cmp" if is_float(x.a) else "int_cmp"] += 1
            walk(x.a), walk(x.b)
        elif isinstance(x, (And, Or)):
            counts["bool_op"] += 1
            for p in x.parts:
                walk(p)
        elif isinstance(x, Select):
            counts["select_op"] += 1
            walk(x.cond), walk(x.true_value), walk(x.false_value)
        elif isinstance(x, Call):
            counts["float_math" if is_float(x) else "int_math"] += 1
            for a in x.args:
                walk(a)
        elif isinstance(x, Cast):
            walk(x.value)
        elif isinstance(x, TensorRead):
            for i in x.indices:
                walk(i)
        elif isinstance(x, Reduce):
            walk(x.value)

    walk(e)
    return counts


def expr_str(e: Expr) -> str:
    """Readable rendering (used for hashing and debugging)."""
    if isinstance(e, IntImm):
        return str(e.value)
    if isinstance(e, FloatImm):
        return repr(e.value)
    if isinstance(e, Var):
        return e.name
    if isinstance(e, Add):
        return f"({expr_str(e.a)} + {expr_str(e.b)})"
    if isinstance(e, Sub):
        return f"({expr_str(e.a)} - {expr_str(e.b)})"
    if isinstance(e, Mul):
        return f"({expr_str(e.a)}*{expr_str(e.b)})"
    if isinstance(e, Div):
        return f"({expr_str(e.a)}/{expr_str(e.b)})"
    if isinstance(e, FloorDiv):
        return f"floordiv({expr_str(e.a)}, {expr_str(e.b)})"
    if isinstance(e, FloorMod):
        return f"floormod({expr_str(e.a)}, {expr_str(e.b)})"
    if isinstance(e, Min):
        return f"min({expr_str(e.a)}, {expr_str(e.b)})"
    if isinstance(e, Max):
        return f"max({expr_str(e.a)}, {expr_str(e.b)})"
    if isinstance(e, Cmp):
        return f"({expr_str(e.a)} {e.op} {expr_str(e.b)})"
    if isinstance(e, And):
        return "(" + " and ".join(expr_str(p) for p in e.parts) + ")"
    if isinstance(e, Or):
        return "(" + " or ".join(expr_str(p) for p in e.parts) + ")"
    if isinstance(e, Select):
        return (
            f"select({expr_str(e.cond)}, {expr_str(e.true_value)}, "
            f"{expr_str(e.false_value)})"
        )
    if isinstance(e, Cast):
        return f"{e.dtype}({expr_str(e.value)})"
    if isinstance(e, Call):
        return f"{e.func}(" + ", ".join(expr_str(a) for a in e.args) + ")"
    if isinstance(e, TensorRead):
        return f"{e.tensor.name}[" + ", ".join(expr_str(i) for i in e.indices) + "]"
    if isinstance(e, Reduce):
        ax = ", ".join(a.name for a in e.axes)
        return f"{e.combiner}({expr_str(e.value)}, axes=[{ax}])"
    return f"<{type(e).__name__}>"
