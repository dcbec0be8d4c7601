"""Demand-driven bound inference for schedule states.

Fills in every iterator's ``(min, extent)`` range, the equivalent of the
reference's ComputeDAG::InferBound (compute_dag.cc:1302) which re-lowers the
state through te::Schedule and te::InferBound. This is a faithful
reimplementation of te's algorithm (src/te/schedule/bound.cc) on our
loop-state IR:

- Stages are processed output-to-input (InferBound's reversed stage loop,
  bound.cc:216-232). Each stage's root ranges come from the union of its
  consumers' demanded regions (InferRootBound + GatherBound); derived
  iterator extents then pass down the split/fuse relation log
  (PassDownDomain, message_passing.cc:109-143).
- For a producer attached via compute_at, the consumer's loops outside the
  attach point are pinned to *symbolic* points (up_state[iv] =
  SinglePoint(iv->var), bound.cc:150-156) and composed up through the
  consumer's relations with inferred range mins added back (PassUpDomain,
  message_passing.cc:280-341), so inferred root ranges carry symbolic mins
  whose common offsets cancel in extents.
- Thread-bound loops relax over their full ranges depending on the
  producer's storage scope (NeedRelax, bound.cc:54-68: shared relaxes
  vthread/threadIdx.*, local relaxes nothing, global relaxes everything);
  vars on the consumer's attach path relax by substitution into the
  symbolic range mins (bound.cc:160-171, 178-196).
- Demanded regions are the symbolic evaluation of the consumer's read
  index expressions (ComputeOpNode::PropBoundToInputs), clipped to the
  tensor shape only when the shape is provably tighter on *both* ends
  (compute_op.cc "update bound's ends in pairs" rule).
- Storage scope comes from the cache stage name (.shared / .local);
  scope-less compute_at stages default by the max thread rank on their
  attach path (InferStorageScope, bound.cc:72-86 + DefaultStorageRank).

Inlined stages are chained through (the reference inline-substitutes their
bodies before bound inference, schedule_dataflow_rewrite.cc InjectInline;
we compose their read regions instead, exact for affine indices).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import expr as E
from .intset import (
    LF,
    SI,
    VarAtom,
    si_addf,
    si_add,
    si_scale,
    si_union,
    lf_floordiv,
    lf_floormod,
    sym_eval,
)
from .state import (
    AT_INLINED,
    AT_ROOT,
    THREAD_ANNOTATIONS,
    Stage,
    State,
)
from .tensor import ComputeOp, PlaceholderOp


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


_LF0 = LF(0)

# thread ranks (runtime/thread_storage_scope.h ThreadScope::Create):
# blockIdx.* -> 0, threadIdx.* -> 1, vthread -> 1
_THREAD_RANK = {4: 1, 5: 0, 6: 1, 7: 0, 8: 1, 9: 0, 10: 1}

# storage ranks: global 0, shared 1, local 3 (StorageRank enum)
_SCOPE_GLOBAL, _SCOPE_SHARED, _SCOPE_LOCAL = 0, 1, 3

# DefaultStorageRank: no threads -> global, blockIdx -> shared,
# threadIdx/vthread -> local
_DEFAULT_SCOPE = {-1: _SCOPE_GLOBAL, 0: _SCOPE_SHARED, 1: _SCOPE_LOCAL}


def _need_relax(annotation: int, found_attach: bool, scope_rank: int,
                threads: bool = True) -> bool:
    """bound.cc:54-68 NeedRelax. ``threads=False`` treats thread-bound
    loops as plain loops — the semantics of every InferBound snapshot the
    reference's search actually recorded split extents under (thread
    annotations are created only by InitThreadBind, *after* its one
    InferBound call at the top, sketch_policy_rules.cc InitThreadBind)."""
    r = _THREAD_RANK.get(annotation) if threads else None
    if r is None:
        return not found_attach
    return scope_rank <= r


class _StageBounds:
    """Per-stage numeric range propagation over the relation log
    (PassDownDomain, message_passing.cc:109-143)."""

    def __init__(self, stage: Stage):
        self.stage = stage
        self.leaf_ann = {it.uid: it.annotation for it in stage.iters}
        # thread domination (PassUpThreadBinding, message_passing.cc:56-86)
        self.dominates_thread: Dict[int, bool] = {
            uid: (ann in THREAD_ANNOTATIONS)
            for uid, ann in self.leaf_ann.items()
        }
        for rel in reversed(stage.relations):
            if rel.kind == "split":
                self.dominates_thread[rel.parent] = self.dominates_thread.get(
                    rel.outer, False
                ) or self.dominates_thread.get(rel.inner, False)
            else:  # fuse
                d = self.dominates_thread.get(rel.fused, False)
                self.dominates_thread[rel.outer] = d
                if rel.inner is not None:
                    self.dominates_thread[rel.inner] = d

    def pass_down(self, root_extents: Dict[int, int]) -> Dict[int, int]:
        """uid -> extent for every derived iterator, given root extents
        keyed by root iterator uid. Extents may be symbolic Exprs
        (data-dependent loops): splits keep the concrete factor and a
        symbolic ceildiv outer, fuses a symbolic product — te
        PassDownDomain on non-const ranges."""
        ext = dict(root_extents)
        for rel in self.stage.relations:
            if rel.kind == "split":
                if rel.parent not in ext:
                    continue
                p = ext[rel.parent]
                f = rel.factor
                if f is None:
                    continue
                if not isinstance(p, int):
                    q = p if f == 1 else (p + (f - 1)) // f
                    if not rel.by_nparts:
                        ext[rel.inner] = f
                        ext[rel.outer] = q
                    else:
                        ext[rel.outer] = f
                        ext[rel.inner] = q
                elif not rel.by_nparts:
                    inner = f if self.dominates_thread.get(rel.inner) else min(p, f)
                    ext[rel.inner] = inner
                    ext[rel.outer] = _ceil_div(p, f)
                else:
                    outer = f if self.dominates_thread.get(rel.outer) else min(p, f)
                    ext[rel.outer] = outer
                    ext[rel.inner] = _ceil_div(p, f)
            else:  # fuse
                if rel.outer not in ext:
                    continue
                if rel.inner is None:
                    ext[rel.fused] = ext[rel.outer]
                elif rel.inner in ext:
                    ext[rel.fused] = ext[rel.outer] * ext[rel.inner]
        return ext


class _Ctx:
    """Shared inference state across the stage loop."""

    def __init__(self, out: State, relax_threads: bool = True):
        self.out = out
        self.relax_threads = relax_threads
        self.sb = [_StageBounds(s) for s in out.stages]
        # per stage: uid -> extent for every iterator incl. intermediates
        self.full_ext: List[Dict[int, int]] = [dict() for _ in out.stages]
        # per stage: root uid -> symbolic range min
        self.root_min: List[Dict[int, LF]] = [dict() for _ in out.stages]
        # leaf var atoms, keyed (sid, iter uid); also indexed by E.Var for
        # sym_eval's free-var lookups
        self._atoms: Dict[Tuple[int, int], VarAtom] = {}
        self.var_atoms: Dict[E.Var, VarAtom] = {}
        self._vars: Dict[Tuple[int, int], E.Var] = {}
        self._env_cache: Dict[tuple, Dict[E.Var, SI]] = {}
        # direct readers: op uid -> [sid]
        self.readers: Dict[int, List[int]] = {}
        for sid, s in enumerate(out.stages):
            if isinstance(s.op, ComputeOp):
                for t in s.op.input_tensors():
                    self.readers.setdefault(t.op.uid, []).append(sid)
        self.sid_of_op = {s.op.uid: sid for sid, s in enumerate(out.stages)}

    def leaf_atom(self, sid: int, it) -> VarAtom:
        key = (sid, it.uid)
        a = self._atoms.get(key)
        if a is None:
            e = it.range[1] if it.range is not None else (it.extent or 1)
            v = E.Var(f"s{sid}i{it.uid}")
            a = VarAtom(v.name, 0, max(0, e - 1))
            self._atoms[key] = a
            self._vars[key] = v
            self.var_atoms[v] = a
        return a

    # -- storage scope (bound.cc:72-86 InferStorageScope)
    def scope_rank(self, sid: int) -> int:
        name = self.out.stages[sid].op.name
        if name.endswith(".shared"):
            return _SCOPE_SHARED
        if name.endswith(".local"):
            return _SCOPE_LOCAL
        max_rank = -1
        for tsid, pos in self._attach_path(sid):
            ann = self.out.stages[tsid].iters[pos].annotation
            r = _THREAD_RANK.get(ann)
            if r is not None and r > max_rank:
                max_rank = r
        return _DEFAULT_SCOPE[min(max_rank, 1)]

    def _attach_path(self, sid: int):
        """(stage, pos) pairs of all loops enclosing ``sid``'s body, from
        the attach iter outward, recursively (graph.cc CreateAttachPath)."""
        am = self.out.attach_map.stage_to_attach_iter
        path = []
        cur = sid
        seen = set()
        while cur in am and cur not in seen:
            seen.add(cur)
            tsid, tpos = am[cur]
            for p in range(tpos, -1, -1):
                path.append((tsid, p))
            cur = tsid
        return path

    # -- the te InferRootBound consumer-nest machinery -----------------

    def consumer_env(self, c_sid: int, scope_rank: int,
                     attach: Optional[Tuple[int, int]]) -> Dict[E.Var, SI]:
        """dom_map for consumer ``c_sid``'s root dim vars, relative to a
        producer with the given scope attached at ``attach`` (bound.cc
        InferRootBound's up_state + relax_set + PassUpDomain + relax)."""
        key = (c_sid, scope_rank, attach)
        env = self._env_cache.get(key)
        if env is not None:
            return env

        out = self.out
        C = out.stages[c_sid]
        attach_uid = None
        if attach is not None:
            tsid, tpos = attach
            attach_uid = out.stages[tsid].iters[tpos].uid

        found = False
        up: Dict[int, SI] = {}
        leaf_uids = set()
        # consumer nest (bound.cc:139-158)
        for it in reversed(C.iters):
            if attach_uid is not None and it.uid == attach_uid:
                found = True
            e = it.range[1] if it.range is not None else (it.extent or 1)
            leaf_uids.add(it.uid)
            if not isinstance(e, int):
                # data-dependent extent: unbounded set, clipped at reads
                # (te EvalSet over an unknown-extent range)
                up[it.uid] = SI.every()
                continue
            if e == 1:
                up[it.uid] = SI.const(0)
            elif not _need_relax(it.annotation, found, scope_rank,
                                 self.relax_threads):
                up[it.uid] = SI.point(LF.atom(self.leaf_atom(c_sid, it)))
            else:
                up[it.uid] = SI.range(0, e - 1)

        # consumer's attach nest -> relax_set (bound.cc:160-171)
        relax_env: Dict[str, SI] = {}
        for tsid2, p in self._attach_path(c_sid):
            iv = out.stages[tsid2].iters[p]
            if attach_uid is not None and iv.uid == attach_uid:
                found = True
            if _need_relax(iv.annotation, found, scope_rank,
                           self.relax_threads):
                e = iv.range[1] if iv.range is not None else (iv.extent or 1)
                if not isinstance(e, int):
                    continue
                a = self.leaf_atom(tsid2, iv)
                relax_env[a.name] = SI.range(0, max(0, e - 1))

        # PassUpDomain (message_passing.cc:280-341)
        dom_ext_raw = self.full_ext[c_sid]
        # symbolic (data-dependent) extents are unknown to the numeric
        # PassUpDomain machinery
        dom_ext = {u: e for u, e in dom_ext_raw.items()
                   if isinstance(e, int)}
        rmin = self.root_min[c_sid]

        def dmin(uid: int) -> LF:
            return rmin.get(uid, _LF0)

        def match_range(s: SI, mn: LF, ext: Optional[int]) -> bool:
            if ext is None or s.everything:
                return False
            return s.lo.equal(mn) and s.hi.equal(mn.addc(ext - 1))

        def from_range(mn: LF, ext: int) -> SI:
            return SI(mn, mn.addc(ext - 1))

        for rel in reversed(C.relations):
            if rel.kind == "split":
                o, i = up.get(rel.outer), up.get(rel.inner)
                if o is None or i is None:
                    continue
                oe = dom_ext.get(rel.outer)
                ie = dom_ext.get(rel.inner)
                pe = dom_ext.get(rel.parent)
                pmin = dmin(rel.parent)
                if (pe is not None and match_range(o, _LF0, oe)
                        and match_range(i, _LF0, ie)):
                    up[rel.parent] = from_range(pmin, pe)
                else:
                    fac = ie if ie is not None else (rel.factor or 1)
                    up[rel.parent] = si_addf(si_add(si_scale(o, fac), i), pmin)
            else:  # fuse
                f = up.get(rel.fused)
                if f is None:
                    continue
                fe_dom = dom_ext.get(rel.fused)
                omin = dmin(rel.outer)
                oe = dom_ext.get(rel.outer)
                if rel.inner is None:
                    # single-iter fuse: pure renaming (te Rebase semantics)
                    if match_range(f, _LF0, fe_dom):
                        up[rel.outer] = from_range(omin, oe if oe is not None
                                                   else fe_dom)
                    else:
                        up[rel.outer] = si_addf(f, omin)
                    continue
                imin = dmin(rel.inner)
                ie = dom_ext.get(rel.inner)
                if ie is None:
                    ie = 1
                if match_range(f, _LF0, fe_dom) and oe is not None:
                    up[rel.outer] = from_range(omin, oe)
                    up[rel.inner] = from_range(imin, ie)
                elif f.is_point():
                    v = f.lo
                    up[rel.outer] = SI.point(lf_floordiv(v, ie).add(omin))
                    up[rel.inner] = SI.point(lf_floormod(v, ie).add(imin))
                else:
                    up[rel.outer] = SI(omin.add(lf_floordiv(f.lo, ie)),
                                       omin.add(lf_floordiv(f.hi, ie)))
                    fe_form = f.hi.sub(f.lo).addc(1)
                    fe = fe_form.is_const()
                    tight = (fe is not None and fe > 0 and ie % fe == 0
                             and lf_floormod(f.lo, fe).is_const() == 0)
                    if tight:
                        up[rel.inner] = SI(imin.add(lf_floormod(f.lo, ie)),
                                           imin.add(lf_floormod(f.hi, ie)))
                    else:
                        up[rel.inner] = from_range(imin, ie)

        # root doms: CoverRange + relax (bound.cc:178-196)
        env = {}
        for uid, dim in C.root_of.items():
            s = up.get(uid)
            if s is None:
                e = dom_ext.get(uid, dim.extent)
                s = SI.every() if not isinstance(e, int) else \
                    from_range(dmin(uid), e)
            elif uid in leaf_uids:
                # root iv used directly as a leaf: loops iterate the
                # inferred range [min, min+e) (rebase-free nests), so the
                # local leaf set shifts by the root's symbolic min
                mn = dmin(uid)
                if mn is not _LF0:
                    s = si_addf(s, mn)
            if relax_env and not s.everything:
                s = s.subst(relax_env)
            env[dim.var] = s
        self._env_cache[key] = env
        return env


def _consumers_of(ctx: _Ctx, op_uid: int):
    """(consumer sid, chain of inlined ComputeOps between consumer and the
    producer, ordered consumer->producer). The reference inline-substitutes
    bodies (InjectInline), making consumers direct; we record the chain."""
    out = []
    seen = set()

    def walk(uid, chain):
        for r_sid in ctx.readers.get(uid, ()):
            st = ctx.out.stages[r_sid]
            if st.compute_at == AT_INLINED:
                key = (r_sid, uid)
                if key in seen:
                    continue
                seen.add(key)
                walk(st.op.uid, [st.op] + chain)
            else:
                out.append((r_sid, tuple(chain)))

    walk(op_uid, [])
    return out


def _clip_read(si: SI, shape_d: int) -> SI:
    """PropBoundToInputs shape clipping: replace with the tensor's full
    range only when provably covering on both ends (compute_op.cc)."""
    if si.everything:
        return SI.range(0, max(0, shape_d - 1))
    lo_n = si.lo.nbound()[1]   # max of the lower bound
    hi_n = si.hi.nbound()[0]   # min of the upper bound
    if lo_n <= 0 and hi_n >= shape_d - 1:
        return SI.range(0, max(0, shape_d - 1))
    return si


def _eval_chain(ctx: _Ctx, c_sid: int, env: Dict[E.Var, SI],
                chain, target_op) -> Optional[List[SI]]:
    """Demanded region of ``target_op`` read by consumer ``c_sid`` through
    a chain of inlined ops. Returns one SI per output dim (or None if the
    consumer never reads it under this chain)."""
    cur_op = ctx.out.stages[c_sid].op
    ops = list(chain) + [target_op]
    for nxt in ops:
        nd = len(nxt.shape) if isinstance(nxt, PlaceholderOp) else len(nxt.axes)
        per_dim: List[Optional[SI]] = [None] * nd
        for read in cur_op.reads_of_uids({nxt.uid}):
            for d, idx in enumerate(read.indices):
                if d >= nd:
                    break
                si = sym_eval(idx, env, ctx.var_atoms)
                per_dim[d] = si if per_dim[d] is None else si_union(per_dim[d], si)
        if any(p is None for p in per_dim):
            return None
        if nxt is target_op:
            shape = nxt.shape if isinstance(nxt, PlaceholderOp) else \
                tuple(a.extent for a in nxt.axes)
            return [_clip_read(p, shape[d]) for d, p in enumerate(per_dim)]
        # intermediate inlined op: its dims take the demanded region,
        # reduce axes span fully (inlined ops are elementwise in Ansor)
        env = {ax.var: per_dim[d] for d, ax in enumerate(nxt.axes)}
        for rd in nxt.reduce_axes:
            env[rd.var] = SI.range(0, rd.extent - 1) \
                if isinstance(rd.extent, int) else SI.every()
        cur_op = nxt
    return None


def infer_bound(dag, state: State, relax_threads: bool = True) -> State:
    """Return a copy of ``state`` with every iterator range defined.

    ``relax_threads=False`` emulates the reference search's InferBound
    snapshots taken before any thread binding exists (what the recorded
    SplitStep extents reflect); the default is te's full semantics for
    final states (what featurization and printing see)."""
    if not state.concrete:
        raise ValueError("only concrete states can be bound-inferred")
    out = state.copy()
    out.stages = [s.shallow_copy() for s in state.stages]

    ctx = _Ctx(out, relax_threads=relax_threads)

    def assign_ranges(sid: int, ext: Dict[int, int]):
        stage = out.stages[sid]
        new_iters = []
        for it in stage.iters:
            e = ext.get(it.uid)
            if e is None:
                e = it.extent
                if e is None:
                    # range was cleared (compute_at); data-dependent root
                    # extents are recovered from the op's dim
                    dim = stage.root_of.get(it.uid)
                    e = dim.extent if dim is not None and \
                        not isinstance(dim.extent, int) else 1
            new_iters.append(it.with_range((0, e)))
        stage.iters = new_iters

    for sid in range(len(out.stages) - 1, -1, -1):
        stage = out.stages[sid]
        if stage.op_type == "placeholder" or stage.compute_at == AT_INLINED:
            continue
        op = stage.op

        roots: Dict[int, int] = {}
        mins: Dict[int, LF] = {}
        cons = _consumers_of(ctx, op.uid)
        if not cons:
            # outputs / unread stages: full original domains (bound.cc
            # is_output branch); data-dependent extents propagate
            # symbolically through the relation log
            for uid, dim in stage.root_of.items():
                roots[uid] = dim.extent
        else:
            attach = out.attach_map.stage_to_attach_iter.get(sid)
            srank = ctx.scope_rank(sid)
            ndim = len(op.axes) if isinstance(op, ComputeOp) else 0
            tdom: List[Optional[SI]] = [None] * ndim
            for c_sid, chain in cons:
                env = ctx.consumer_env(c_sid, srank, attach)
                dem = _eval_chain(ctx, c_sid, env, chain, op)
                if dem is None:
                    continue
                for d in range(min(ndim, len(dem))):
                    tdom[d] = dem[d] if tdom[d] is None else \
                        si_union(tdom[d], dem[d])
            # GatherBound: spatial dims from the union, reduce dims full
            dim_to_uid = {id(dim): uid for uid, dim in stage.root_of.items()}
            for d, ax in enumerate(op.axes if isinstance(op, ComputeOp) else ()):
                uid = dim_to_uid.get(id(ax))
                if uid is None:
                    continue
                u = tdom[d] if d < ndim else None
                if u is None or u.everything:
                    roots[uid] = ax.extent
                    continue
                ext_form = u.hi.sub(u.lo).addc(1)
                ec = ext_form.is_const()
                if ec is None:
                    # symbolic extent the algebra couldn't cancel: take the
                    # numeric upper bound (te would keep it symbolic)
                    ec = ext_form.nbound()[1]
                roots[uid] = max(1, ec)
                if u.lo.terms or u.lo.const:
                    mins[uid] = u.lo
            for uid, dim in stage.root_of.items():
                if uid not in roots:
                    roots[uid] = dim.extent

        ext = ctx.sb[sid].pass_down(roots)
        ctx.full_ext[sid] = ext
        ctx.root_min[sid] = mins
        assign_ranges(sid, ext)

    return out
