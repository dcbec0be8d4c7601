"""Symbolic integer sets for te-faithful bound inference.

The reference's te::InferBound pins loops outside a producer's attach point
to *symbolic* points (``up_state[iv] = SinglePoint(iv->var)``,
src/te/schedule/bound.cc:150-156), composes them through split/fuse
relations with the inferred range mins added back
(src/te/schedule/message_passing.cc:280-341 PassUpDomain), relaxes
thread-bound vars over their ranges (bound.cc:54-68 NeedRelax,
bound.cc:178-196), and finally recovers extents as the *symbolic
difference* max - min + 1 (src/arith/int_set.cc:505 CoverRange), where the
pinned vars cancel. This module supplies the minimal symbolic machinery
for that: linear forms over atoms with exact floordiv/floormod extraction,
symbolic intervals, and the EvalSet combiner rules of
src/arith/int_set.cc (Combine<FloorDiv>, Combine<FloorMod>, Union).

Atoms are either loop vars (with known numeric ranges) or opaque
floordiv/floormod/min/max sub-forms; identical atoms cancel in
differences, which is exactly the cancellation te's Analyzer::Simplify
performs on Ansor's affine-with-floordiv loop compositions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from . import expr as E


def _fdiv(a: int, b: int) -> int:
    return a // b


def _fmod(a: int, b: int) -> int:
    return a % b


# ---------------------------------------------------------------------------
# Atoms
# ---------------------------------------------------------------------------


class Atom:
    """An opaque integer-valued term with known numeric bounds."""

    __slots__ = ("key", "nlo", "nhi")

    def __init__(self, key, nlo: int, nhi: int):
        self.key = key
        self.nlo = nlo
        self.nhi = nhi

    def subst(self, env) -> "SI":
        raise NotImplementedError


class VarAtom(Atom):
    __slots__ = ("name",)

    def __init__(self, name: str, nlo: int, nhi: int):
        super().__init__(("v", name), nlo, nhi)
        self.name = name

    def subst(self, env):
        si = env.get(self.name)
        if si is not None:
            return si
        return SI(LF.atom(self), LF.atom(self))


class DivAtom(Atom):
    """floordiv(form, c) with no extractable part left in ``form``."""

    __slots__ = ("form", "c")

    def __init__(self, form: "LF", c: int):
        lo, hi = form.nbound()
        super().__init__(("div", form.key(), c), _fdiv(lo, c), _fdiv(hi, c))
        self.form = form
        self.c = c

    def subst(self, env):
        return si_floordiv_const(self.form.subst(env), self.c)


class ModAtom(Atom):
    """floormod(form, c) for a point value."""

    __slots__ = ("form", "c")

    def __init__(self, form: "LF", c: int):
        lo, hi = form.nbound()
        if _fdiv(lo, c) == _fdiv(hi, c):
            nlo, nhi = _fmod(lo, c), _fmod(hi, c)
        else:
            nlo, nhi = 0, c - 1
        super().__init__(("mod", form.key(), c), nlo, nhi)
        self.form = form
        self.c = c

    def subst(self, env):
        return si_floormod_const(self.form.subst(env), self.c)


class MinAtom(Atom):
    __slots__ = ("a", "b")

    def __init__(self, a: "LF", b: "LF"):
        alo, ahi = a.nbound()
        blo, bhi = b.nbound()
        ka, kb = a.key(), b.key()
        if kb < ka:
            a, b, ka, kb = b, a, kb, ka
        super().__init__(("min", ka, kb), min(alo, blo), min(ahi, bhi))
        self.a = a
        self.b = b

    def subst(self, env):
        sa, sb = self.a.subst(env), self.b.subst(env)
        return SI(lf_min(sa.lo, sb.lo), lf_min(sa.hi, sb.hi))


class MaxAtom(Atom):
    __slots__ = ("a", "b")

    def __init__(self, a: "LF", b: "LF"):
        alo, ahi = a.nbound()
        blo, bhi = b.nbound()
        ka, kb = a.key(), b.key()
        if kb < ka:
            a, b, ka, kb = b, a, kb, ka
        super().__init__(("max", ka, kb), max(alo, blo), max(ahi, bhi))
        self.a = a
        self.b = b

    def subst(self, env):
        sa, sb = self.a.subst(env), self.b.subst(env)
        return SI(lf_max(sa.lo, sb.lo), lf_max(sa.hi, sb.hi))


# ---------------------------------------------------------------------------
# Linear forms: const + sum(coeff * atom)
# ---------------------------------------------------------------------------


class LF:
    """Canonical linear form over atoms. Immutable by convention."""

    __slots__ = ("const", "terms", "_key")

    def __init__(self, const: int = 0, terms: Optional[Dict] = None):
        self.const = const
        # atom key -> (Atom, coeff); coeff != 0
        self.terms = terms if terms is not None else {}
        self._key = None

    # -- constructors
    @staticmethod
    def of(c: int) -> "LF":
        return LF(c)

    @staticmethod
    def atom(a: Atom, coeff: int = 1, const: int = 0) -> "LF":
        if coeff == 0:
            return LF(const)
        return LF(const, {a.key: (a, coeff)})

    # -- canonical key (for structural equality / atom nesting)
    def key(self):
        if self._key is None:
            items = tuple(sorted((k, v[1]) for k, v in self.terms.items()))
            self._key = (self.const, items)
        return self._key

    def is_const(self) -> Optional[int]:
        return self.const if not self.terms else None

    def equal(self, other: "LF") -> bool:
        return self.key() == other.key()

    # -- arithmetic
    def add(self, other: "LF") -> "LF":
        t = dict(self.terms)
        for k, (a, c) in other.terms.items():
            if k in t:
                nc = t[k][1] + c
                if nc == 0:
                    del t[k]
                else:
                    t[k] = (a, nc)
            else:
                t[k] = (a, c)
        return LF(self.const + other.const, t)

    def neg(self) -> "LF":
        return LF(-self.const, {k: (a, -c) for k, (a, c) in self.terms.items()})

    def sub(self, other: "LF") -> "LF":
        return self.add(other.neg())

    def addc(self, c: int) -> "LF":
        return LF(self.const + c, self.terms)

    def scale(self, k: int) -> "LF":
        if k == 0:
            return LF(0)
        if k == 1:
            return self
        return LF(self.const * k,
                  {kk: (a, c * k) for kk, (a, c) in self.terms.items()})

    # -- numeric bounds
    def nbound(self) -> Tuple[int, int]:
        lo = hi = self.const
        for a, c in self.terms.values():
            if c >= 0:
                lo += c * a.nlo
                hi += c * a.nhi
            else:
                lo += c * a.nhi
                hi += c * a.nlo
        return lo, hi

    # -- substitution / relaxation (env: var name -> SI)
    def subst(self, env) -> "SI":
        lo = LF(self.const)
        hi = LF(self.const)
        for a, c in self.terms.values():
            si = a.subst(env)
            si = si_scale(si, c)
            lo = lo.add(si.lo)
            hi = hi.add(si.hi)
        return SI(lo, hi)

    def __repr__(self):
        parts = [str(self.const)] if self.const or not self.terms else []
        for a, c in self.terms.values():
            parts.append(f"{c}*{a.key}")
        return "LF(" + " + ".join(parts) + ")"


# exact identities: floordiv(D*c + R, c) = D + floordiv(R, c),
# floormod(sum ci*xi + k, c) = floormod(sum (ci mod c)*xi + k mod c, c)


def lf_floordiv(f: LF, c: int) -> LF:
    """Exact symbolic floordiv of a linear form by a positive constant."""
    assert c > 0
    div_terms = {}
    rest = LF(f.const)
    for k, (a, co) in f.terms.items():
        if co % c == 0:
            div_terms[k] = (a, co // c)
        else:
            rest = rest.add(LF.atom(a, co))
    out = LF(0, div_terms)
    rc = rest.is_const()
    if rc is not None:
        return out.addc(_fdiv(rc, c))
    rlo, rhi = rest.nbound()
    if _fdiv(rlo, c) == _fdiv(rhi, c):
        return out.addc(_fdiv(rlo, c))
    return out.add(LF.atom(DivAtom(rest, c)))


def lf_floormod(f: LF, c: int) -> LF:
    """Exact symbolic floormod of a linear form by a positive constant."""
    assert c > 0
    rest = LF(_fmod(f.const, c))
    for k, (a, co) in f.terms.items():
        co = co % c
        if co:
            rest = rest.add(LF.atom(a, co))
    rc = rest.is_const()
    if rc is not None:
        return LF(_fmod(rc, c))
    rlo, rhi = rest.nbound()
    q = _fdiv(rlo, c)
    if q == _fdiv(rhi, c):
        return rest.addc(-q * c)
    return LF.atom(ModAtom(rest, c))


def lf_min(a: LF, b: LF) -> LF:
    d = a.sub(b)
    dc_lo, dc_hi = d.nbound()
    if dc_hi <= 0:
        return a
    if dc_lo >= 0:
        return b
    return LF.atom(MinAtom(a, b))


def lf_max(a: LF, b: LF) -> LF:
    d = a.sub(b)
    dc_lo, dc_hi = d.nbound()
    if dc_lo >= 0:
        return a
    if dc_hi <= 0:
        return b
    return LF.atom(MaxAtom(a, b))


# ---------------------------------------------------------------------------
# Symbolic intervals
# ---------------------------------------------------------------------------


class SI:
    """Symbolic closed interval [lo, hi]; ``everything`` = unbounded
    (arith::IntervalSet::Everything)."""

    __slots__ = ("lo", "hi", "everything")

    def __init__(self, lo: Optional[LF], hi: Optional[LF],
                 everything: bool = False):
        self.lo = lo
        self.hi = hi
        self.everything = everything

    @staticmethod
    def point(f: LF) -> "SI":
        return SI(f, f)

    @staticmethod
    def const(v: int) -> "SI":
        f = LF(v)
        return SI(f, f)

    @staticmethod
    def range(lo: int, hi: int) -> "SI":
        return SI(LF(lo), LF(hi))

    @staticmethod
    def every() -> "SI":
        return SI(None, None, everything=True)

    def is_point(self) -> bool:
        return not self.everything and self.lo.equal(self.hi)

    def nbound(self) -> Tuple[int, int]:
        lo, _ = self.lo.nbound()
        _, hi = self.hi.nbound()
        return lo, hi

    def subst(self, env) -> "SI":
        if self.everything:
            return self
        return SI(self.lo.subst(env).lo, self.hi.subst(env).hi)

    def __repr__(self):
        if self.everything:
            return "SI(everything)"
        return f"SI({self.lo!r}, {self.hi!r})"


def si_add(a: SI, b: SI) -> SI:
    if a.everything or b.everything:
        return SI.every()
    return SI(a.lo.add(b.lo), a.hi.add(b.hi))


def si_sub(a: SI, b: SI) -> SI:
    if a.everything or b.everything:
        return SI.every()
    return SI(a.lo.sub(b.hi), a.hi.sub(b.lo))


def si_addf(a: SI, f: LF) -> SI:
    if a.everything:
        return a
    return SI(a.lo.add(f), a.hi.add(f))


def si_scale(a: SI, k: int) -> SI:
    if a.everything:
        return a
    if k >= 0:
        return SI(a.lo.scale(k), a.hi.scale(k))
    return SI(a.hi.scale(k), a.lo.scale(k))


def si_mul(a: SI, b: SI) -> SI:
    if a.everything or b.everything:
        return SI.every()
    bc = b.lo.is_const() if b.is_point() else None
    if bc is not None:
        return si_scale(a, bc)
    ac = a.lo.is_const() if a.is_point() else None
    if ac is not None:
        return si_scale(b, ac)
    # non-affine product: fall back to numeric interval arithmetic
    alo, ahi = a.nbound()
    blo, bhi = b.nbound()
    cands = (alo * blo, alo * bhi, ahi * blo, ahi * bhi)
    return SI.range(min(cands), max(cands))


def si_floordiv_const(a: SI, c: int) -> SI:
    """Combine<FloorDiv> with a positive constant divisor
    (src/arith/int_set.cc): monotone, divide both ends."""
    if a.everything:
        return SI.every()
    if c == 1:
        return a
    if c > 0:
        return SI(lf_floordiv(a.lo, c), lf_floordiv(a.hi, c))
    # negative divisor: swapped ends (rare; numeric fallback)
    lo, hi = a.nbound()
    cands = (_fdiv(lo, c), _fdiv(hi, c))
    return SI.range(min(cands), max(cands))


def si_floormod_const(a: SI, c: int) -> SI:
    """Combine<FloorMod> with a positive constant divisor: tight result
    when both ends provably share the floordiv quotient, else [0, c-1]."""
    if c <= 0:
        c = abs(c) if c else 1
        return SI.range(-(c - 1), c - 1)
    if a.everything:
        return SI.range(0, c - 1)
    if a.is_point():
        return SI.point(lf_floormod(a.lo, c))
    q1 = lf_floordiv(a.lo, c)
    q2 = lf_floordiv(a.hi, c)
    if q1.equal(q2):
        qc = q1.scale(c)
        return SI(a.lo.sub(qc), a.hi.sub(qc))
    return SI.range(0, c - 1)


def si_floordiv(a: SI, b: SI) -> SI:
    if b.is_point():
        c = b.lo.is_const()
        if c is not None and c != 0:
            return si_floordiv_const(a, c)
    return SI.every()


def si_floormod(a: SI, b: SI) -> SI:
    if b.is_point():
        c = b.lo.is_const()
        if c is not None and c != 0:
            return si_floormod_const(a, c)
    return SI.every()


def si_min(a: SI, b: SI) -> SI:
    if a.everything or b.everything:
        return SI.every()
    return SI(lf_min(a.lo, b.lo), lf_min(a.hi, b.hi))


def si_max(a: SI, b: SI) -> SI:
    if a.everything or b.everything:
        return SI.every()
    return SI(lf_max(a.lo, b.lo), lf_max(a.hi, b.hi))


def si_union(a: SI, b: SI) -> SI:
    if a.everything or b.everything:
        return SI.every()
    return SI(lf_min(a.lo, b.lo), lf_max(a.hi, b.hi))


# ---------------------------------------------------------------------------
# EvalSet over expression trees
# ---------------------------------------------------------------------------


def sym_eval(e: E.Expr, env: Dict, var_atoms: Dict) -> SI:
    """arith::EvalSet equivalent: evaluate the symbolic interval of ``e``
    given Var -> SI bindings. Unbound vars stay symbolic points
    (IntSetEvaluator keeps free vars as SinglePoint(var)); their numeric
    ranges come from ``var_atoms`` (Var -> VarAtom)."""
    if isinstance(e, E.IntImm):
        return SI.const(e.value)
    if isinstance(e, E.FloatImm):
        return SI.const(int(e.value))
    if isinstance(e, E.Var):
        si = env.get(e)
        if si is not None:
            return si
        a = var_atoms.get(e)
        if a is None:
            # unknown free var: pinned single point with unknown range;
            # treat as [0, 0] like the numeric evaluator did
            return SI.const(0)
        return SI.point(LF.atom(a))
    if isinstance(e, E.Add):
        return si_add(sym_eval(e.a, env, var_atoms), sym_eval(e.b, env, var_atoms))
    if isinstance(e, E.Sub):
        return si_sub(sym_eval(e.a, env, var_atoms), sym_eval(e.b, env, var_atoms))
    if isinstance(e, E.Mul):
        return si_mul(sym_eval(e.a, env, var_atoms), sym_eval(e.b, env, var_atoms))
    if isinstance(e, (E.FloorDiv, E.Div)):
        return si_floordiv(sym_eval(e.a, env, var_atoms),
                           sym_eval(e.b, env, var_atoms))
    if isinstance(e, E.FloorMod):
        return si_floormod(sym_eval(e.a, env, var_atoms),
                           sym_eval(e.b, env, var_atoms))
    if isinstance(e, E.Min):
        return si_min(sym_eval(e.a, env, var_atoms), sym_eval(e.b, env, var_atoms))
    if isinstance(e, E.Max):
        return si_max(sym_eval(e.a, env, var_atoms), sym_eval(e.b, env, var_atoms))
    if isinstance(e, E.Select):
        return si_union(sym_eval(e.true_value, env, var_atoms),
                        sym_eval(e.false_value, env, var_atoms))
    if isinstance(e, E.Cast):
        return sym_eval(e.value, env, var_atoms)
    # TensorRead / Call / Cmp as index values: unbounded
    return SI.every()
