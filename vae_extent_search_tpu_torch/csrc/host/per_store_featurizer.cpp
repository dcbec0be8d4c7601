// Native per-store 164-dim feature extractor.
//
// The C++ mirror of vae_extent_search_tpu/features/per_store.py (which in
// turn mirrors the reference's src/auto_scheduler/feature.cc): replay +
// bound inference from ves_replay.h, then per non-inlined compute stage:
// globalized store/read index expressions (PassUpIndex reconstruction over
// the split/fuse relation log, attach-offset composition, inline
// substitution), progressive-binding touched regions via interval
// arithmetic, stride/reuse analysis, arithmetic-intensity curve, and the
// exact 164-float slog layout. Golden-tested equal to the Python path in
// tests/test_native.py.
//
// Expression trees arrive via records/expr_desc.py (prefix int32 stream);
// ops are referenced by table index so cache-step retargeting is an
// in-place op_ref swap.

#include "ves_replay.h"

#include <cmath>
#include <limits>
#include <tuple>

#ifdef VES_PROF
#include <atomic>
#include <chrono>
#include <cstdio>
#endif

namespace {

using namespace ves;

constexpr int FEATURE_VEC_LEN = 164;
constexpr int CURVE_SAMPLES = 10;
constexpr int MAX_N_BUFS = 5;

// ----------------------------------------------------------------------
// Expression arena
// ----------------------------------------------------------------------

enum EKind : int8_t {
  E_INT = 0, E_FLOAT = 1, E_VAR = 2,
  E_ADD = 3, E_SUB = 4, E_MUL = 5, E_DIV = 6, E_FDIV = 7, E_FMOD = 8,
  E_MIN = 9, E_MAX = 10, E_CMP = 11, E_AND = 12, E_OR = 13, E_SELECT = 14,
  E_CAST = 15, E_CALL = 16, E_READ = 17, E_REDUCE = 18,
  E_LEAF = 19,  // a realized loop variable (uid in ival)
};

struct ENode {
  int8_t kind;
  bool is_float = false;
  long ival = 0;       // int value / var dim_ref / leaf uid
  double fval = 0.0;
  int op_ref = -1;     // for E_READ
  int a = -1, b = -1, c = -1;  // fixed-arity children
  int kids_begin = 0, n_kids = 0;  // variable-arity children
};

struct Arena {
  std::vector<ENode> nodes;
  std::vector<int> kids;

  int add(ENode n) {
    nodes.push_back(n);
    return static_cast<int>(nodes.size()) - 1;
  }
  int intc(long v) {
    ENode n; n.kind = E_INT; n.ival = v; return add(n);
  }
  int leaf(long uid) {
    ENode n; n.kind = E_LEAF; n.ival = uid; return add(n);
  }
  int bin(int8_t kind, int a, int b, bool is_float = false) {
    ENode n; n.kind = kind; n.a = a; n.b = b; n.is_float = is_float;
    return add(n);
  }
};

// full-expression op
struct FullOp {
  int kind;  // 0 placeholder, 1 compute
  std::vector<long> dims;
  std::vector<long> reduce;
  int dtype_bytes = 4;
  int body = -1;  // arena index; E_REDUCE for reductions
};

struct FullTable {
  Arena arena;
  std::vector<FullOp> ops;
};

// parse the expr_desc stream
int parse_expr(const int32_t*& p, Arena& ar) {
  int kind = *p++;
  ENode n;
  n.kind = static_cast<int8_t>(kind);
  switch (kind) {
    case E_INT: {
      uint64_t lo = static_cast<uint32_t>(*p++);
      uint64_t hi = static_cast<uint32_t>(*p++);
      n.ival = static_cast<long>(lo | (hi << 32));
      return ar.add(n);
    }
    case E_FLOAT: {
      uint64_t lo = static_cast<uint32_t>(*p++);
      uint64_t hi = static_cast<uint32_t>(*p++);
      uint64_t bits = lo | (hi << 32);
      memcpy(&n.fval, &bits, 8);
      n.is_float = true;
      return ar.add(n);
    }
    case E_VAR:
      n.ival = *p++;
      return ar.add(n);
    case E_ADD: case E_SUB: case E_MUL: case E_DIV: case E_FDIV:
    case E_FMOD: case E_MIN: case E_MAX: case E_CMP: {
      n.is_float = *p++ != 0;
      n.a = parse_expr(p, ar);
      n.b = parse_expr(p, ar);
      return ar.add(n);
    }
    case E_AND: case E_OR: {
      int cnt = *p++;
      std::vector<int> kk;
      for (int i = 0; i < cnt; ++i) kk.push_back(parse_expr(p, ar));
      n.kids_begin = static_cast<int>(ar.kids.size());
      n.n_kids = cnt;
      ar.kids.insert(ar.kids.end(), kk.begin(), kk.end());
      return ar.add(n);
    }
    case E_SELECT:
      n.a = parse_expr(p, ar);
      n.b = parse_expr(p, ar);
      n.c = parse_expr(p, ar);
      return ar.add(n);
    case E_CAST:
      n.is_float = *p++ != 0;
      n.a = parse_expr(p, ar);
      return ar.add(n);
    case E_CALL: {
      n.is_float = *p++ != 0;
      int cnt = *p++;
      std::vector<int> kk;
      for (int i = 0; i < cnt; ++i) kk.push_back(parse_expr(p, ar));
      n.kids_begin = static_cast<int>(ar.kids.size());
      n.n_kids = cnt;
      ar.kids.insert(ar.kids.end(), kk.begin(), kk.end());
      return ar.add(n);
    }
    case E_READ: {
      n.op_ref = *p++;
      int cnt = *p++;
      n.is_float = true;
      std::vector<int> kk;
      for (int i = 0; i < cnt; ++i) kk.push_back(parse_expr(p, ar));
      n.kids_begin = static_cast<int>(ar.kids.size());
      n.n_kids = cnt;
      ar.kids.insert(ar.kids.end(), kk.begin(), kk.end());
      return ar.add(n);
    }
    case E_REDUCE:
      n.ival = *p++;  // combiner
      n.is_float = true;
      n.a = parse_expr(p, ar);
      return ar.add(n);
  }
  return -1;
}

FullTable parse_expr_desc(const int32_t* d) {
  FullTable ft;
  const int32_t* p = d;
  int n_ops = *p++;
  ft.ops.resize(n_ops);
  for (int i = 0; i < n_ops; ++i) {
    FullOp& op = ft.ops[i];
    op.kind = *p++;
    int nd = *p++;
    for (int j = 0; j < nd; ++j) op.dims.push_back(*p++);
    int nr = *p++;
    for (int j = 0; j < nr; ++j) op.reduce.push_back(*p++);
    op.dtype_bytes = *p++;
    int blen = *p++;
    if (blen > 0) {
      const int32_t* q = p;
      op.body = parse_expr(q, ft.arena);
      p += blen;
    }
  }
  return ft;
}

// substitute: dim var (E_VAR, dim_ref) -> replacement exprs (arena idx).
// Identity-preserving + memoized: subtrees without a mapped dim var are
// returned AS-IS (no arena copy), and shared subtrees are walked once —
// the naive copy-everything walk was the dominant arena churn in
// build_store_infos (~32% of featurization).
struct SubstMemo {
  std::vector<int> val;
  std::vector<unsigned> stamp;
  unsigned cur = 0;

  void begin(size_t n) {
    if (val.size() < n) {
      val.resize(n);
      stamp.resize(n, 0);
    }
    ++cur;
  }
};

int substitute_impl(Arena& ar, int e, const std::vector<int>& dim_map,
                    SubstMemo& memo) {
  if (e < 0) return e;
  if (e < static_cast<int>(memo.stamp.size()) &&
      memo.stamp[e] == memo.cur) {
    return memo.val[e];
  }
  ENode n = ar.nodes[e];
  int out = e;
  switch (n.kind) {
    case E_INT: case E_FLOAT: case E_LEAF:
      break;
    case E_VAR: {
      int r = n.ival < static_cast<long>(dim_map.size())
                  ? dim_map[n.ival] : -1;
      out = r >= 0 ? r : e;
      break;
    }
    case E_SELECT: {
      int a = substitute_impl(ar, n.a, dim_map, memo);
      int b = substitute_impl(ar, n.b, dim_map, memo);
      int c = substitute_impl(ar, n.c, dim_map, memo);
      if (a != n.a || b != n.b || c != n.c) {
        n.a = a; n.b = b; n.c = c;
        out = ar.add(n);
      }
      break;
    }
    case E_CAST: case E_REDUCE: {
      int a = substitute_impl(ar, n.a, dim_map, memo);
      if (a != n.a) {
        n.a = a;
        out = ar.add(n);
      }
      break;
    }
    case E_AND: case E_OR: case E_CALL: case E_READ: {
      std::vector<int> kk;
      bool changed = false;
      for (int i = 0; i < n.n_kids; ++i) {
        int k0 = ar.kids[n.kids_begin + i];
        kk.push_back(substitute_impl(ar, k0, dim_map, memo));
        changed |= kk.back() != k0;
      }
      if (changed) {
        n.kids_begin = static_cast<int>(ar.kids.size());
        ar.kids.insert(ar.kids.end(), kk.begin(), kk.end());
        out = ar.add(n);
      }
      break;
    }
    default: {  // binaries + cmp
      int a = substitute_impl(ar, n.a, dim_map, memo);
      int b = substitute_impl(ar, n.b, dim_map, memo);
      if (a != n.a || b != n.b) {
        n.a = a; n.b = b;
        out = ar.add(n);
      }
      break;
    }
  }
  if (e < static_cast<int>(memo.stamp.size())) {
    memo.val[e] = out;
    memo.stamp[e] = memo.cur;
  }
  return out;
}

int substitute(Arena& ar, int e, const std::vector<int>& dim_map) {
  if (e < 0) return e;
  // stamped thread-local scratch: one O(arena) allocation per thread
  // lifetime instead of per call (inline_reads calls this once per
  // inlined read)
  static thread_local SubstMemo memo;
  memo.begin(ar.nodes.size());
  return substitute_impl(ar, e, dim_map, memo);
}

// simple constructors mirroring per_store.py _simp_add/_simp_mul
int simp_mul(Arena& ar, int e, long c) {
  if (c == 1) return e;
  if (ar.nodes[e].kind == E_INT) return ar.intc(ar.nodes[e].ival * c);
  return ar.bin(E_MUL, e, ar.intc(c));
}
int simp_add(Arena& ar, int a, int b) {
  if (ar.nodes[a].kind == E_INT && ar.nodes[a].ival == 0) return b;
  if (ar.nodes[b].kind == E_INT && ar.nodes[b].ival == 0) return a;
  if (ar.nodes[a].kind == E_INT && ar.nodes[b].kind == E_INT) {
    return ar.intc(ar.nodes[a].ival + ar.nodes[b].ival);
  }
  return ar.bin(E_ADD, a, b);
}

// ----------------------------------------------------------------------
// Interval evaluation (mirror of ir/expr.py eval_interval)
// ----------------------------------------------------------------------

struct IV {
  long lo, hi;
};

IV eval_iv(const Arena& ar, int e, const std::vector<IV>& env) {
  const ENode& n = ar.nodes[e];
  switch (n.kind) {
    case E_INT:
      return {n.ival, n.ival};
    case E_FLOAT: {
      long v = static_cast<long>(n.fval);
      return {v, v};
    }
    case E_LEAF:
      return env[n.ival];
    case E_VAR:
      return {0, 0};  // unbound dim var: pinned (matches python default)
    case E_ADD: {
      IV a = eval_iv(ar, n.a, env), b = eval_iv(ar, n.b, env);
      return {a.lo + b.lo, a.hi + b.hi};
    }
    case E_SUB: {
      IV a = eval_iv(ar, n.a, env), b = eval_iv(ar, n.b, env);
      return {a.lo - b.hi, a.hi - b.lo};
    }
    case E_MUL: {
      IV a = eval_iv(ar, n.a, env), b = eval_iv(ar, n.b, env);
      long c1 = a.lo * b.lo, c2 = a.lo * b.hi, c3 = a.hi * b.lo,
           c4 = a.hi * b.hi;
      return {std::min(std::min(c1, c2), std::min(c3, c4)),
              std::max(std::max(c1, c2), std::max(c3, c4))};
    }
    case E_FDIV: {
      IV a = eval_iv(ar, n.a, env), b = eval_iv(ar, n.b, env);
      long lo = std::numeric_limits<long>::max();
      long hi = std::numeric_limits<long>::min();
      bool any = false;
      for (long x : {a.lo, a.hi}) {
        for (long y : {b.lo, b.hi}) {
          if (y != 0) {
            // python floor division
            long q = x / y;
            if ((x % y != 0) && ((x < 0) != (y < 0))) q -= 1;
            lo = std::min(lo, q);
            hi = std::max(hi, q);
            any = true;
          }
        }
      }
      if (!any) return {0, 0};
      return {lo, hi};
    }
    case E_FMOD: {
      IV b = eval_iv(ar, n.b, env);
      IV a = eval_iv(ar, n.a, env);
      if (b.lo == b.hi && b.lo > 0) {
        long m = b.lo;
        if (a.lo == a.hi) {
          long r = ((a.lo % m) + m) % m;
          return {r, r};
        }
        return {0, std::min(m - 1, std::max(a.hi, 0L))};
      }
      return {0, std::max(std::labs(b.lo), std::labs(b.hi))};
    }
    case E_MIN: {
      IV a = eval_iv(ar, n.a, env), b = eval_iv(ar, n.b, env);
      return {std::min(a.lo, b.lo), std::min(a.hi, b.hi)};
    }
    case E_MAX: {
      IV a = eval_iv(ar, n.a, env), b = eval_iv(ar, n.b, env);
      return {std::max(a.lo, b.lo), std::max(a.hi, b.hi)};
    }
    case E_SELECT: {
      IV t = eval_iv(ar, n.b, env), f = eval_iv(ar, n.c, env);
      return {std::min(t.lo, f.lo), std::max(t.hi, f.hi)};
    }
    case E_CAST:
      return eval_iv(ar, n.a, env);
    default:
      return {0, 0};
  }
}

// Stamped memo for eval_iv: after identity-preserving substitution the
// index expressions are DAGs (dim exprs shared across accesses and store
// indices), and the emitter evaluates them once per (loop level, dim).
// Naive recursion re-walks shared subtrees; the memo makes each walk
// linear in distinct nodes. One epoch per env state — begin() after ANY
// env mutation.
struct EvalMemo {
  std::vector<int> stamp;
  std::vector<IV> val;
  int cur = 0;

  void begin(size_t n_nodes) {
    if (stamp.size() < n_nodes) {
      stamp.resize(n_nodes, -1);
      val.resize(n_nodes);
    }
    ++cur;
  }
};

IV eval_iv_memo(const Arena& ar, int e, const std::vector<IV>& env,
                EvalMemo& m) {
  if (m.stamp[e] == m.cur) return m.val[e];
  const ENode& n = ar.nodes[e];
  IV r;
  // leaves are already O(1); memoizing them would only churn the table
  switch (n.kind) {
    case E_INT: case E_FLOAT: case E_LEAF: case E_VAR:
      return eval_iv(ar, e, env);
    default:
      break;
  }
  switch (n.kind) {
    case E_ADD: {
      IV a = eval_iv_memo(ar, n.a, env, m), b = eval_iv_memo(ar, n.b, env, m);
      r = {a.lo + b.lo, a.hi + b.hi};
      break;
    }
    case E_SUB: {
      IV a = eval_iv_memo(ar, n.a, env, m), b = eval_iv_memo(ar, n.b, env, m);
      r = {a.lo - b.hi, a.hi - b.lo};
      break;
    }
    case E_MUL: {
      IV a = eval_iv_memo(ar, n.a, env, m), b = eval_iv_memo(ar, n.b, env, m);
      long c1 = a.lo * b.lo, c2 = a.lo * b.hi, c3 = a.hi * b.lo,
           c4 = a.hi * b.hi;
      r = {std::min(std::min(c1, c2), std::min(c3, c4)),
           std::max(std::max(c1, c2), std::max(c3, c4))};
      break;
    }
    case E_MIN: {
      IV a = eval_iv_memo(ar, n.a, env, m), b = eval_iv_memo(ar, n.b, env, m);
      r = {std::min(a.lo, b.lo), std::min(a.hi, b.hi)};
      break;
    }
    case E_MAX: {
      IV a = eval_iv_memo(ar, n.a, env, m), b = eval_iv_memo(ar, n.b, env, m);
      r = {std::max(a.lo, b.lo), std::max(a.hi, b.hi)};
      break;
    }
    case E_SELECT: {
      IV t = eval_iv_memo(ar, n.b, env, m), f = eval_iv_memo(ar, n.c, env, m);
      r = {std::min(t.lo, f.lo), std::max(t.hi, f.hi)};
      break;
    }
    case E_CAST:
      r = eval_iv_memo(ar, n.a, env, m);
      break;
    case E_FDIV: {
      // fused-loop reconstruction emits FDIV/FMOD, so both are hot
      IV a = eval_iv_memo(ar, n.a, env, m), b = eval_iv_memo(ar, n.b, env, m);
      long lo = std::numeric_limits<long>::max();
      long hi = std::numeric_limits<long>::min();
      bool any = false;
      for (long x : {a.lo, a.hi}) {
        for (long y : {b.lo, b.hi}) {
          if (y != 0) {
            long q = x / y;
            if ((x % y != 0) && ((x < 0) != (y < 0))) q -= 1;
            lo = std::min(lo, q);
            hi = std::max(hi, q);
            any = true;
          }
        }
      }
      r = any ? IV{lo, hi} : IV{0, 0};
      break;
    }
    case E_FMOD: {
      IV b = eval_iv_memo(ar, n.b, env, m);
      IV a = eval_iv_memo(ar, n.a, env, m);
      if (b.lo == b.hi && b.lo > 0) {
        long mm = b.lo;
        if (a.lo == a.hi) {
          long rr = ((a.lo % mm) + mm) % mm;
          r = {rr, rr};
        } else {
          r = {0, std::min(mm - 1, std::max(a.hi, 0L))};
        }
      } else {
        r = {0, std::max(std::labs(b.lo), std::labs(b.hi))};
      }
      break;
    }
    default:
      // E_DIV and anything else: defer to the plain evaluator
      r = eval_iv(ar, e, env);
      break;
  }
  m.stamp[e] = m.cur;
  m.val[e] = r;
  return r;
}

bool leaf_in_expr(const Arena& ar, int e, long uid) {
  const ENode& n = ar.nodes[e];
  if (n.kind == E_LEAF) return n.ival == uid;
  if (n.a >= 0 && leaf_in_expr(ar, n.a, uid)) return true;
  if (n.b >= 0 && leaf_in_expr(ar, n.b, uid)) return true;
  if (n.c >= 0 && leaf_in_expr(ar, n.c, uid)) return true;
  for (int i = 0; i < n.n_kids; ++i) {
    if (leaf_in_expr(ar, ar.kids[n.kids_begin + i], uid)) return true;
  }
  return false;
}

// ----------------------------------------------------------------------
// Math-op counting (mirror of ir/expr.py count_math_ops over the
// globalized store RHS)
// ----------------------------------------------------------------------

struct OpCounts {
  double f_addsub = 0, f_mul = 0, f_divmod = 0, f_cmp = 0, f_math = 0;
  double i_addsub = 0, i_mul = 0, i_divmod = 0, i_cmp = 0, i_math = 0;
  double bool_op = 0, select_op = 0;
};

void count_ops(const Arena& ar, int e, OpCounts& c) {
  const ENode& n = ar.nodes[e];
  switch (n.kind) {
    case E_ADD: case E_SUB:
      (n.is_float ? c.f_addsub : c.i_addsub) += 1;
      count_ops(ar, n.a, c); count_ops(ar, n.b, c);
      break;
    case E_MUL:
      (n.is_float ? c.f_mul : c.i_mul) += 1;
      count_ops(ar, n.a, c); count_ops(ar, n.b, c);
      break;
    case E_DIV: case E_FDIV: case E_FMOD:
      (n.is_float ? c.f_divmod : c.i_divmod) += 1;
      count_ops(ar, n.a, c); count_ops(ar, n.b, c);
      break;
    case E_MIN: case E_MAX: case E_CMP:
      (n.is_float ? c.f_cmp : c.i_cmp) += 1;
      count_ops(ar, n.a, c); count_ops(ar, n.b, c);
      break;
    case E_AND: case E_OR:
      c.bool_op += 1;
      for (int i = 0; i < n.n_kids; ++i) {
        count_ops(ar, ar.kids[n.kids_begin + i], c);
      }
      break;
    case E_SELECT:
      c.select_op += 1;
      count_ops(ar, n.a, c); count_ops(ar, n.b, c); count_ops(ar, n.c, c);
      break;
    case E_CALL:
      (n.is_float ? c.f_math : c.i_math) += 1;
      for (int i = 0; i < n.n_kids; ++i) {
        count_ops(ar, ar.kids[n.kids_begin + i], c);
      }
      break;
    case E_CAST:
      count_ops(ar, n.a, c);
      break;
    case E_READ:
      for (int i = 0; i < n.n_kids; ++i) {
        count_ops(ar, ar.kids[n.kids_begin + i], c);
      }
      break;
    case E_REDUCE:
      count_ops(ar, n.a, c);
      break;
    default:
      break;
  }
}

// collect E_READ node ids in evaluation order
void collect_reads(const Arena& ar, int e, std::vector<int>& out) {
  const ENode& n = ar.nodes[e];
  if (n.kind == E_READ) {
    out.push_back(e);
    for (int i = 0; i < n.n_kids; ++i) {
      collect_reads(ar, ar.kids[n.kids_begin + i], out);
    }
    return;
  }
  if (n.a >= 0) collect_reads(ar, n.a, out);
  if (n.b >= 0) collect_reads(ar, n.b, out);
  if (n.c >= 0) collect_reads(ar, n.c, out);
  for (int i = 0; i < n.n_kids; ++i) {
    collect_reads(ar, ar.kids[n.kids_begin + i], out);
  }
}

// first-order coefficient of a leaf var (per_store.py _coefficient_of)
std::pair<long, bool> coefficient_of(const Arena& ar, int e, long uid) {
  const ENode& n = ar.nodes[e];
  if (n.kind == E_LEAF) {
    return {n.ival == uid ? 1 : 0, n.ival == uid};
  }
  if (n.kind == E_MUL) {
    const ENode& a = ar.nodes[n.a];
    const ENode& b = ar.nodes[n.b];
    if (a.kind == E_LEAF && a.ival == uid && b.kind == E_INT) {
      return {b.ival, true};
    }
    if (b.kind == E_LEAF && b.ival == uid && a.kind == E_INT) {
      return {a.ival, true};
    }
    auto ca = coefficient_of(ar, n.a, uid);
    if (ca.second) return ca;
    auto cb = coefficient_of(ar, n.b, uid);
    if (cb.second) return cb;
    return {0, false};
  }
  if (n.kind == E_ADD || n.kind == E_SUB) {
    auto ca = coefficient_of(ar, n.a, uid);
    if (ca.second) return ca;
    auto cb = coefficient_of(ar, n.b, uid);
    if (cb.second) return cb;
    return {0, false};
  }
  // other patterns: unknown -> coefficient 2 if present
  if (leaf_in_expr(ar, e, uid)) return {2, true};
  return {0, false};
}

double slog(double x) {
  if (x == 0.0) return 0.0;  // log2(1) exactly; zeros dominate the
                             // one-hot and absent-buffer fields
  double v = std::log2(std::fabs(x) + 1.0);
  return x >= 0 ? v : -v;
}

}  // namespace

// the remainder (store-info construction + feature emission + C API) is
// in per_store_featurizer_part2.inc to keep hunks reviewable
#include "per_store_featurizer_part2.inc"
