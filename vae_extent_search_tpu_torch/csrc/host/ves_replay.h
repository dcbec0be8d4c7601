// Shared native schedule-replay + bound-inference core.
//
// Extracted from the extent featurizer so both native featurizers (extent
// and per-store) run the same replay and demand-driven bound inference —
// the C++ mirror of vae_extent_search_tpu/ir/{steps,bound}.py. See
// extent_featurizer.cpp for the behavioral references.
#pragma once

#include <algorithm>
#include <cmath>
#include <functional>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#ifdef VES_PROF
#include <atomic>
#include <chrono>
#endif

namespace ves {

#ifdef VES_PROF
// infer_bounds sub-stage attribution (ns): StageBounds build /
// consumer-env construction (cache misses) / read-chain eval / pass_down
inline std::atomic<int64_t> prof_ib_build{0}, prof_ib_env{0},
    prof_ib_chain{0}, prof_ib_down{0};
inline std::atomic<int64_t> prof_env_nest{0}, prof_env_pud{0},
    prof_env_roots{0}, prof_env_calls{0}, prof_env_miss{0};
#define VES_IBTIC auto _ib0 = std::chrono::steady_clock::now()
#define VES_IBTOC(a)                                                       \
  do {                                                                     \
    auto _ib1 = std::chrono::steady_clock::now();                          \
    (a) += std::chrono::duration_cast<std::chrono::nanoseconds>(_ib1 -     \
                                                                _ib0)      \
               .count();                                                   \
    _ib0 = _ib1;                                                           \
  } while (0)
#else
#define VES_IBTIC
#define VES_IBTOC(a)
#endif


// ---------------------------------------------------------------------
// Task descriptor
// ---------------------------------------------------------------------

struct AffineIdx {
  std::vector<std::pair<int, long>> terms;  // (var_ref, coeff)
  long cst = 0;
};

struct ReadDesc {
  int src_op;
  std::vector<AffineIdx> idx;
};

struct OpDesc {
  int kind;  // 0 placeholder, 1 compute
  std::vector<long> dims;
  std::vector<long> reduce;
  std::vector<ReadDesc> reads;
};

struct TaskDesc {
  std::vector<OpDesc> ops;
};

inline TaskDesc parse_task_desc(const int32_t* d) {
  TaskDesc td;
  int p = 0;
  int n_ops = d[p++];
  td.ops.resize(n_ops);
  for (int i = 0; i < n_ops; ++i) {
    OpDesc& op = td.ops[i];
    op.kind = d[p++];
    int nd = d[p++];
    for (int j = 0; j < nd; ++j) op.dims.push_back(d[p++]);
    int nr = d[p++];
    for (int j = 0; j < nr; ++j) op.reduce.push_back(d[p++]);
    int nreads = d[p++];
    op.reads.resize(nreads);
    for (int r = 0; r < nreads; ++r) {
      ReadDesc& rd = op.reads[r];
      rd.src_op = d[p++];
      int nidx = d[p++];
      rd.idx.resize(nidx);
      for (int k = 0; k < nidx; ++k) {
        int nt = d[p++];
        for (int t = 0; t < nt; ++t) {
          int var_ref = d[p++];
          long coeff = d[p++];
          rd.idx[k].terms.emplace_back(var_ref, coeff);
        }
        rd.idx[k].cst = d[p++];
      }
    }
  }
  return td;
}

// ---------------------------------------------------------------------
// Loop state
// ---------------------------------------------------------------------

enum Annotation {
  ANN_NONE = 0, ANN_UNROLL, ANN_VECTORIZE, ANN_PARALLEL, ANN_VTHREAD,
  ANN_BLOCK_X, ANN_THREAD_X, ANN_BLOCK_Y, ANN_THREAD_Y, ANN_BLOCK_Z,
  ANN_THREAD_Z, ANN_TENSORIZE,
};
inline bool is_thread_ann(int a) {
  return a >= ANN_VTHREAD && a <= ANN_THREAD_Z;
}

enum ComputeAt { AT_ROOT = 0, AT_ITER = 1, AT_INLINED = 2 };

struct Iter {
  int uid;
  long extent;  // -1 = undefined
  int8_t kind;  // 0 spatial, 1 reduce, 2 mixed
  int8_t annotation = ANN_NONE;
};

struct Rel {
  int8_t kind;  // 0 split, 1 fuse
  int parent = -1, outer = -1, inner = -1, fused = -1;
  long factor = -1;  // -1 = undefined length
  bool by_nparts = false;
};

struct Stage {
  int op;
  int8_t compute_at = AT_ROOT;
  std::vector<Iter> iters;
  std::vector<Rel> rels;
  // root uid -> (dim index; spatial dims first, then reduce) + full extent
  std::vector<std::pair<int, long>> roots;  // (uid, extent)
  std::vector<int8_t> root_is_reduce;
  long auto_unroll = 0;
  long storage_offset = 0;  // StorageAlign offset (printed as a pragma line)
  bool is_shared = false;  // shared-scope cache stage
  int8_t scope = -1;  // storage rank: -1 infer, 0 global, 1 shared, 3 local
};

// one parsed step
struct Step {
  int kind;
  int stage_id = 0;
  int iter_id = 0;
  long extent = 0;
  std::vector<long> lengths;  // -1 entries = None
  bool inner_to_outer = true;
  std::vector<int> ids;  // fused_ids / after_ids / reader_ids / src_step_ids
  int src_step_id = 0, n_split = 0, level = 0;
  int target_stage_id = 0, target_iter_id = 0;
  long pragma_value = -1;  // auto_unroll value; -1 = other pragma
  long sa_offset = 0;      // StorageAlign offset
  bool pragma_skip = false;
  bool scope_is_shared = false;
  int8_t scope = -1;  // cache scope rank: 0 global, 1 shared, 3 local
  std::string scope_str;  // cache scope name (for name tracking/printing)
};

enum StepKind {
  S_AN = 0, S_FU, S_PR, S_RE, S_SP, S_FSP, S_FFSP, S_SA, S_CA, S_CI, S_CR,
  S_CHR, S_CHW, S_RF,
};

struct State {
  std::vector<OpDesc> ops;  // extended by cache steps
  std::vector<Stage> stages;
  std::vector<int> attach_tgt, attach_pos;  // per stage; -1 = none
  std::vector<int> attach_seq;  // CA application order (python AttachMap
                                // appends attached stages in step order)
  int attach_counter = 0;
  std::vector<Step> steps;
  int uid = 0;
  bool failed = false;

  // opt-in name tracking (byte-exact PrintState parity, ir/state.py):
  // only the analytic-measure path pays the string work
  bool track_names = false;
  std::vector<std::string> iter_name;  // by uid
  std::vector<std::string> op_name;    // by op index
  // per op: spatial dim names then reduce dim names (ir ComputeOp
  // axes/reduce_axes order — matches iter creation order)
  std::vector<std::vector<std::string>> op_dim_names;

  int fresh() { return uid++; }

  void set_iname(int u, std::string s) {
    if (!track_names) return;
    if (static_cast<int>(iter_name.size()) <= u) iter_name.resize(u + 64);
    iter_name[u] = std::move(s);
  }
  const std::string& iname(int u) const {
    static const std::string kEmpty;
    return u < static_cast<int>(iter_name.size()) ? iter_name[u] : kEmpty;
  }
};

inline long ceil_div(long a, long b) { return (a + b - 1) / b; }

inline void init_state(State& st, const TaskDesc& td) {
  st.ops = td.ops;
  st.stages.resize(td.ops.size());
  st.attach_tgt.assign(td.ops.size(), -1);
  st.attach_pos.assign(td.ops.size(), -1);
  st.attach_seq.assign(td.ops.size(), -1);
  for (size_t i = 0; i < td.ops.size(); ++i) {
    Stage& s = st.stages[i];
    s.op = static_cast<int>(i);
    if (td.ops[i].kind == 0) continue;  // placeholder: no iters
    // capacity hints: Ansor schedules split/fuse every tiled dim, so
    // iters/rels grow well past the root count — pre-sizing removes
    // the doubling reallocs that showed up in the replay profile
    const size_t nd = td.ops[i].dims.size() + td.ops[i].reduce.size();
    s.iters.reserve(4 * nd + 8);
    s.rels.reserve(3 * nd + 8);
    s.roots.reserve(nd);
    s.root_is_reduce.reserve(nd);
    for (size_t d = 0; d < td.ops[i].dims.size(); ++d) {
      int u = st.fresh();
      s.iters.push_back({u, td.ops[i].dims[d], 0, ANN_NONE});
      s.roots.emplace_back(u, td.ops[i].dims[d]);
      s.root_is_reduce.push_back(0);
      if (st.track_names && i < st.op_dim_names.size() &&
          d < st.op_dim_names[i].size()) {
        st.set_iname(u, st.op_dim_names[i][d]);
      }
    }
    for (size_t d = 0; d < td.ops[i].reduce.size(); ++d) {
      int u = st.fresh();
      s.iters.push_back({u, td.ops[i].reduce[d], 1, ANN_NONE});
      s.roots.emplace_back(u, td.ops[i].reduce[d]);
      s.root_is_reduce.push_back(1);
      size_t nd = td.ops[i].dims.size();
      if (st.track_names && i < st.op_dim_names.size() &&
          nd + d < st.op_dim_names[i].size()) {
        st.set_iname(u, st.op_dim_names[i][nd + d]);
      }
    }
  }
}

// attach-map position remap after split/fuse on (stage_id)
inline void update_attach_positions(State& st, int stage_id,
                             const std::vector<std::pair<int, int>>& remap) {
  for (size_t s = 0; s < st.stages.size(); ++s) {
    if (st.attach_tgt[s] == stage_id) {
      for (auto& fr : remap) {
        if (st.attach_pos[s] == fr.first) {
          st.attach_pos[s] = fr.second;
          break;
        }
      }
    }
  }
}

inline void apply_split_common(State& st, int stage_id, int iter_id,
                        const std::vector<long>& lengths,
                        bool inner_to_outer) {
  Stage& stage = st.stages[stage_id];
  Iter it = stage.iters[iter_id];
  int old_size = static_cast<int>(stage.iters.size());
  long tosplit = it.extent;

  std::vector<Iter> outs;
  for (size_t i = 0; i < lengths.size(); ++i) {
    long l = inner_to_outer ? lengths[lengths.size() - 1 - i] : lengths[i];
    Iter res{st.fresh(), -1, it.kind, ANN_NONE};
    if (l >= 0 && tosplit >= 0) {
      res.extent = l;
      tosplit = ceil_div(tosplit, l);
    } else {
      tosplit = -1;
      if (l < 0) st.failed = st.failed;  // non-concrete handled by caller
    }
    if (st.track_names) {  // ir/steps.py _apply_split_common names
      size_t sfx = inner_to_outer ? lengths.size() - i : i;
      st.set_iname(res.uid,
                   st.iname(it.uid) + "." + std::to_string(sfx));
    }
    outs.push_back(res);
  }
  Iter last{st.fresh(), tosplit, it.kind, ANN_NONE};
  if (st.track_names) {
    st.set_iname(last.uid, st.iname(it.uid) + "." +
                               std::to_string(inner_to_outer
                                                  ? 0
                                                  : lengths.size()));
  }
  if (inner_to_outer) {
    outs.push_back(last);
    std::reverse(outs.begin(), outs.end());
  } else {
    outs.push_back(last);
  }

  // binary relation chains (see ir/steps.py _apply_split_common)
  size_t k = lengths.size();
  if (inner_to_outer) {
    int cur = it.uid;
    for (size_t j = k - 1; j >= 1; --j) {
      int tmp = st.fresh();
      stage.rels.push_back({0, cur, tmp, outs[j + 1].uid, -1,
                            lengths[j], false});
      cur = tmp;
      if (j == 1) break;
    }
    if (k >= 1) {
      stage.rels.push_back({0, cur, outs[0].uid, outs[1].uid, -1,
                            lengths[0], false});
    }
  } else {
    int cur = it.uid;
    for (size_t j = 0; j < k; ++j) {
      int inner = (j == k - 1) ? outs[j + 1].uid : st.fresh();
      stage.rels.push_back({0, cur, outs[j].uid, inner, -1, lengths[j],
                            true});
      cur = inner;
    }
  }

  stage.iters.erase(stage.iters.begin() + iter_id);
  stage.iters.insert(stage.iters.begin() + iter_id, outs.begin(), outs.end());

  std::vector<std::pair<int, int>> remap;
  for (int i = iter_id; i < old_size; ++i) {
    remap.emplace_back(i, i + static_cast<int>(lengths.size()));
  }
  update_attach_positions(st, stage_id, remap);
}

inline std::vector<long> extract_follow_split_lengths(const State& st,
                                               const Step& step) {
  const Step& src = st.steps[step.src_step_id];
  std::vector<long> lengths(src.lengths.begin(),
                            src.lengths.begin() +
                                std::min<size_t>(step.n_split - 1,
                                                 src.lengths.size()));
  long last = 1;
  for (size_t i = step.n_split - 1; i < src.lengths.size(); ++i) {
    if (src.lengths[i] < 0) { last = -1; break; }
    last *= src.lengths[i];
  }
  lengths.push_back(last);
  return lengths;
}

inline long extract_follow_fused_length(const State& st, const Step& step) {
  long ret = 1;
  for (int sid : step.ids) {
    const Step& src = st.steps[sid];
    if (step.level >= static_cast<int>(src.lengths.size()) ||
        src.lengths[step.level] < 0) {
      return -1;
    }
    ret *= src.lengths[step.level];
  }
  return ret;
}

inline void apply_cache_read(State& st, const Step& step) {
  int src_stage = step.stage_id;
  int src_op = st.stages[src_stage].op;
  // new op: identity read of src
  OpDesc cache;
  cache.kind = 1;
  cache.dims = st.ops[src_op].dims;
  ReadDesc rd;
  rd.src_op = src_op;
  for (size_t d = 0; d < cache.dims.size(); ++d) {
    AffineIdx ai;
    ai.terms.emplace_back(static_cast<int>(d), 1);
    rd.idx.push_back(ai);
  }
  cache.reads.push_back(rd);
  int new_op = static_cast<int>(st.ops.size());
  st.ops.push_back(cache);
  if (st.track_names) {  // dag._apply_cache_read: "<src>.<scope>", ax0..
    st.op_name.push_back(st.op_name[src_op] + "." + step.scope_str);
    std::vector<std::string> dn;
    for (size_t d = 0; d < cache.dims.size(); ++d) {
      dn.push_back("ax" + std::to_string(d));
    }
    st.op_dim_names.push_back(std::move(dn));
  }

  // retarget readers (pre-insertion stage ids)
  for (int rid : step.ids) {
    // reader ids are pre-insertion stage indices; the stage list is
    // untouched at this point, so they index directly
    int reader_op = st.stages[rid].op;
    for (auto& r : st.ops[reader_op].reads) {
      if (r.src_op == src_op) r.src_op = new_op;
    }
  }

  // insert the new stage after src_stage
  Stage s;
  s.op = new_op;
  for (size_t d = 0; d < cache.dims.size(); ++d) {
    int u = st.fresh();
    s.iters.push_back({u, cache.dims[d], 0, ANN_NONE});
    s.roots.emplace_back(u, cache.dims[d]);
    s.root_is_reduce.push_back(0);
    if (st.track_names) st.set_iname(u, st.op_dim_names[new_op][d]);
  }
  s.is_shared = step.scope_is_shared;
  s.scope = step.scope;
  int added = src_stage + 1;
  st.stages.insert(st.stages.begin() + added, s);
  st.attach_tgt.insert(st.attach_tgt.begin() + added, -1);
  st.attach_pos.insert(st.attach_pos.begin() + added, -1);
  st.attach_seq.insert(st.attach_seq.begin() + added, -1);
  for (size_t i = 0; i < st.attach_tgt.size(); ++i) {
    if (static_cast<int>(i) != added && st.attach_tgt[i] >= added) {
      st.attach_tgt[i] += 1;
    }
  }
}

inline void apply_cache_write(State& st, const Step& step) {
  int tgt_stage = step.stage_id;
  int orig_op = st.stages[tgt_stage].op;
  // by value: push_back below may reallocate st.ops
  OpDesc orig = st.ops[orig_op];

  // cache op: the original computation (same dims/reduce/reads)
  OpDesc cache = orig;
  int cache_op = static_cast<int>(st.ops.size());
  st.ops.push_back(cache);
  if (st.track_names) {
    // dag._apply_cache_write: cache op "<src>.<scope>", spatial dims
    // "<name>.c", reduce dims keep the original names
    st.op_name.push_back(st.op_name[orig_op] + "." + step.scope_str);
    std::vector<std::string> dn;
    const std::vector<std::string>& on = st.op_dim_names[orig_op];
    for (size_t d = 0; d < orig.dims.size(); ++d) {
      dn.push_back((d < on.size() ? on[d] : "ax" + std::to_string(d)) +
                   ".c");
    }
    for (size_t d = 0; d < orig.reduce.size(); ++d) {
      size_t k = orig.dims.size() + d;
      dn.push_back(k < on.size() ? on[k] : "k" + std::to_string(d));
    }
    st.op_dim_names.push_back(std::move(dn));
  }

  // original becomes identity copy reading the cache op
  OpDesc copy;
  copy.kind = 1;
  copy.dims = orig.dims;
  ReadDesc rd;
  rd.src_op = cache_op;
  for (size_t d = 0; d < copy.dims.size(); ++d) {
    AffineIdx ai;
    ai.terms.emplace_back(static_cast<int>(d), 1);
    rd.idx.push_back(ai);
  }
  copy.reads.push_back(rd);
  int copy_op = static_cast<int>(st.ops.size());
  st.ops.push_back(copy);
  if (st.track_names) {
    // the copy keeps the original name + spatial dim names
    // (_clone_spatial_axes with empty suffix)
    st.op_name.push_back(st.op_name[orig_op]);
    std::vector<std::string> dn(
        st.op_dim_names[orig_op].begin(),
        st.op_dim_names[orig_op].begin() +
            std::min(orig.dims.size(), st.op_dim_names[orig_op].size()));
    st.op_dim_names.push_back(std::move(dn));
  }

  // fresh cache stage inserted at tgt_stage; target stage reset to copy op
  Stage cs;
  cs.op = cache_op;
  for (size_t d = 0; d < st.ops[cache_op].dims.size(); ++d) {
    int u = st.fresh();
    cs.iters.push_back({u, st.ops[cache_op].dims[d], 0, ANN_NONE});
    cs.roots.emplace_back(u, st.ops[cache_op].dims[d]);
    cs.root_is_reduce.push_back(0);
    if (st.track_names) st.set_iname(u, st.op_dim_names[cache_op][d]);
  }
  for (size_t d = 0; d < st.ops[cache_op].reduce.size(); ++d) {
    int u = st.fresh();
    cs.iters.push_back({u, st.ops[cache_op].reduce[d], 1, ANN_NONE});
    cs.roots.emplace_back(u, st.ops[cache_op].reduce[d]);
    cs.root_is_reduce.push_back(1);
    if (st.track_names) {
      st.set_iname(
          u, st.op_dim_names[cache_op][st.ops[cache_op].dims.size() + d]);
    }
  }

  cs.scope = step.scope;

  Stage ns;
  ns.op = copy_op;
  for (size_t d = 0; d < copy.dims.size(); ++d) {
    int u = st.fresh();
    ns.iters.push_back({u, copy.dims[d], 0, ANN_NONE});
    ns.roots.emplace_back(u, copy.dims[d]);
    ns.root_is_reduce.push_back(0);
    if (st.track_names) st.set_iname(u, st.op_dim_names[copy_op][d]);
  }
  st.stages[tgt_stage] = ns;
  st.stages.insert(st.stages.begin() + tgt_stage, cs);
  st.attach_tgt.insert(st.attach_tgt.begin() + tgt_stage, -1);
  st.attach_pos.insert(st.attach_pos.begin() + tgt_stage, -1);
  st.attach_seq.insert(st.attach_seq.begin() + tgt_stage, -1);
  for (size_t i = 0; i < st.attach_tgt.size(); ++i) {
    if (static_cast<int>(i) != tgt_stage && st.attach_tgt[i] >= tgt_stage) {
      st.attach_tgt[i] += 1;
    }
  }
  // consumers of the original keep reading orig_op — but orig_op is now
  // the copy's identity...  consumers read `orig_op`; the table entry for
  // orig_op must become the copy op's content so their reads stay valid.
  st.ops[orig_op] = copy;
  // and the copy stage points at orig_op (not copy_op) for consistency
  st.stages[tgt_stage + 1].op = orig_op;
  if (st.track_names) {
    // mirror the ops-table swap: orig_op's slot now holds the copy —
    // its dim names become the copy's (spatial only), its name stays
    st.op_dim_names[orig_op] = st.op_dim_names[copy_op];
  }
}

// rfactor: src -> src.rf (partial reduction; the factored split part
// becomes a spatial dim) + src (reduction of src.rf over that dim) —
// mirror of ir/steps.py RfactorStep.apply_to_state + dag._apply_rfactor.
// The rf op's affine reads are non-affine (floordiv/mod unflattening), so
// they stay empty; demand propagation must run through the
// full-expression hook (as the featurizers do).
inline bool apply_rfactor(State& st, const Step& step) {
  int n = static_cast<int>(st.steps.size());
  // context: steps[n-1] is this RF; steps[n-2] must be the reduce split
  if (n < 2 || st.steps[n - 2].kind != S_SP) return false;
  const Step& sp = st.steps[n - 2];
  if (sp.lengths.size() != 1 || sp.lengths[0] < 0) return false;
  int stage_id = step.stage_id;
  if (stage_id < 0 || stage_id >= static_cast<int>(st.stages.size())) {
    return false;
  }
  int src_op = st.stages[stage_id].op;
  OpDesc src = st.ops[src_op];  // by value: pushes below may reallocate
  int n_spatial = static_cast<int>(src.dims.size());
  if (src.reduce.empty()) return false;
  long total = 1;
  for (long r : src.reduce) total *= r;
  long inner_len = sp.lengths[0];
  long outer_len = ceil_div(total, inner_len);
  long rf_extent, other_extent;
  if (step.iter_id == n_spatial) {
    rf_extent = outer_len;
    other_extent = inner_len;
  } else if (step.iter_id == n_spatial + 1) {
    rf_extent = inner_len;
    other_extent = outer_len;
  } else {
    return false;
  }
  int fpos = step.level;  // factor_iter_id
  if (fpos < 0 || fpos > n_spatial) return false;

  // rf op: spatial dims with the rf axis inserted at fpos
  OpDesc rf;
  rf.kind = 1;
  rf.dims = src.dims;
  rf.dims.insert(rf.dims.begin() + fpos, rf_extent);
  rf.reduce = {other_extent};
  int rf_idx = static_cast<int>(st.ops.size());
  st.ops.push_back(rf);
  if (st.track_names) {
    // dag._apply_rfactor: "<src>.rf" with "k.rf" inserted at fpos and a
    // single "k.other" reduce axis
    st.op_name.push_back(st.op_name[src_op] + ".rf");
    std::vector<std::string> dn(
        st.op_dim_names[src_op].begin(),
        st.op_dim_names[src_op].begin() +
            std::min(static_cast<size_t>(n_spatial),
                     st.op_dim_names[src_op].size()));
    dn.insert(dn.begin() + fpos, "k.rf");
    dn.push_back("k.other");
    st.op_dim_names.push_back(std::move(dn));
  }

  // the original op becomes a reduction of rf over the factored axis;
  // consumers keep reading src_op (its table slot is rewritten in place)
  OpDesc red;
  red.kind = 1;
  red.dims = src.dims;
  red.reduce = {rf_extent};
  ReadDesc rd;
  rd.src_op = rf_idx;
  for (int d = 0; d <= n_spatial; ++d) {
    AffineIdx ai;
    if (d == fpos) {
      ai.terms.emplace_back(n_spatial, 1);  // the new reduce var
    } else {
      int sd = d < fpos ? d : d - 1;
      ai.terms.emplace_back(sd, 1);
    }
    rd.idx.push_back(ai);
  }
  red.reads.push_back(rd);
  st.ops[src_op] = red;
  if (st.track_names) {
    // the original becomes a reduction of rf: spatial names kept
    // (_clone_spatial_axes), one "k.v" reduce axis
    std::vector<std::string> dn(
        st.op_dim_names[src_op].begin(),
        st.op_dim_names[src_op].begin() +
            std::min(static_cast<size_t>(n_spatial),
                     st.op_dim_names[src_op].size()));
    dn.push_back("k.v");
    st.op_dim_names[src_op] = std::move(dn);
  }

  // fresh stages (python re-creates both from the new ops)
  auto make_stage = [&](int op_idx) {
    Stage s2;
    s2.op = op_idx;
    const OpDesc& od = st.ops[op_idx];
    for (size_t d = 0; d < od.dims.size(); ++d) {
      int u = st.fresh();
      s2.iters.push_back({u, od.dims[d], 0, ANN_NONE});
      s2.roots.emplace_back(u, od.dims[d]);
      s2.root_is_reduce.push_back(0);
      if (st.track_names) st.set_iname(u, st.op_dim_names[op_idx][d]);
    }
    for (size_t d = 0; d < od.reduce.size(); ++d) {
      int u = st.fresh();
      s2.iters.push_back({u, od.reduce[d], 1, ANN_NONE});
      s2.roots.emplace_back(u, od.reduce[d]);
      s2.root_is_reduce.push_back(1);
      if (st.track_names) {
        st.set_iname(u, st.op_dim_names[op_idx][od.dims.size() + d]);
      }
    }
    return s2;
  };
  int8_t ca_type = st.stages[stage_id].compute_at;
  Stage tgt = make_stage(src_op);
  tgt.compute_at = ca_type;
  st.stages[stage_id] = tgt;
  st.stages.insert(st.stages.begin() + stage_id, make_stage(rf_idx));
  st.attach_tgt.insert(st.attach_tgt.begin() + stage_id,
                       -1);
  st.attach_pos.insert(st.attach_pos.begin() + stage_id, -1);
  st.attach_seq.insert(st.attach_seq.begin() + stage_id, -1);
  for (size_t i = 0; i < st.attach_tgt.size(); ++i) {
    if (static_cast<int>(i) != stage_id && st.attach_tgt[i] >= stage_id) {
      st.attach_tgt[i] += 1;
    }
  }
  return true;
}

inline bool apply_step(State& st, const Step& step) {
  // bounds guards: mutated candidate schedules (native evolutionary
  // search) can carry out-of-range ids; mirror the python path where
  // apply_steps raises and the child is discarded
  if (step.stage_id < 0 ||
      step.stage_id >= static_cast<int>(st.stages.size())) {
    return false;
  }
  switch (step.kind) {
    case S_AN: {
      Stage& s = st.stages[step.stage_id];
      if (step.iter_id < 0 ||
          step.iter_id >= static_cast<int>(s.iters.size())) {
        return false;
      }
      // 12 annotation kinds (kAnnStr); reject out-of-range values so
      // downstream table lookups (printer) can never read OOB — the
      // python path raises on such records and the caller falls back
      if (step.level < 0 || step.level > 11) return false;
      s.iters[step.iter_id].annotation =
          static_cast<int8_t>(step.level);  // reuse .level = annotation
      return true;
    }
    case S_FU: {
      Stage& s = st.stages[step.stage_id];
      if (step.ids.empty()) return true;
      for (int id : step.ids) {
        if (id < 0 || id >= static_cast<int>(s.iters.size())) return false;
      }
      long ext = 1;
      int kind = s.iters[step.ids.front()].kind;
      bool defined = true;
      std::vector<int> uids;
      for (int id : step.ids) {
        const Iter& it = s.iters[id];
        uids.push_back(it.uid);
        if (it.extent < 0) defined = false;
        else ext *= it.extent;
        if (it.kind != kind) kind = 2;
      }
      Iter fused{st.fresh(), defined ? ext : -1, static_cast<int8_t>(kind),
                 ANN_NONE};
      if (st.track_names) {  // FuseStep: concat names with trailing "@"
        std::string nm;
        for (int u : uids) nm += st.iname(u) + "@";
        st.set_iname(fused.uid, std::move(nm));
      }
      if (uids.size() >= 2) {
        int cur = uids[0];
        for (size_t j = 1; j < uids.size(); ++j) {
          int f = (j == uids.size() - 1) ? fused.uid : st.fresh();
          s.rels.push_back({1, -1, cur, uids[j], f, -1, false});
          cur = f;
        }
      } else {
        s.rels.push_back({1, -1, uids[0], -1, fused.uid, -1, false});
      }
      int b = step.ids.front(), e = step.ids.back();
      int old_size = static_cast<int>(s.iters.size());
      s.iters.erase(s.iters.begin() + b, s.iters.begin() + e + 1);
      s.iters.insert(s.iters.begin() + b, fused);
      std::vector<std::pair<int, int>> remap;
      for (int i = 0; i < old_size; ++i) {
        if (i <= b) continue;
        else if (i > e) remap.emplace_back(i, i - e + b);
        else remap.emplace_back(i, b);
      }
      update_attach_positions(st, step.stage_id, remap);
      return true;
    }
    case S_PR: {
      if (step.pragma_skip) return true;
      if (step.pragma_value >= 0) {
        st.stages[step.stage_id].auto_unroll = step.pragma_value;
      }
      return true;
    }
    case S_RE: {
      Stage& s = st.stages[step.stage_id];
      std::vector<Iter> ni;
      for (int id : step.ids) {
        if (id < 0 || id >= static_cast<int>(s.iters.size())) return false;
      }
      for (int id : step.ids) ni.push_back(s.iters[id]);
      s.iters = std::move(ni);
      return true;
    }
    case S_SP:
      if (step.iter_id < 0 ||
          step.iter_id >=
              static_cast<int>(st.stages[step.stage_id].iters.size())) {
        return false;
      }
      apply_split_common(st, step.stage_id, step.iter_id, step.lengths,
                         step.inner_to_outer);
      return true;
    case S_FSP: {
      if (step.iter_id < 0 ||
          step.iter_id >=
              static_cast<int>(st.stages[step.stage_id].iters.size()) ||
          step.src_step_id < 0 ||
          step.src_step_id >= static_cast<int>(st.steps.size())) {
        return false;
      }
      auto lengths = extract_follow_split_lengths(st, step);
      apply_split_common(st, step.stage_id, step.iter_id, lengths, true);
      return true;
    }
    case S_FFSP: {
      if (step.iter_id < 0 ||
          step.iter_id >=
              static_cast<int>(st.stages[step.stage_id].iters.size())) {
        return false;
      }
      for (int sid : step.ids) {
        if (sid < 0 || sid >= static_cast<int>(st.steps.size())) {
          return false;
        }
      }
      long len = extract_follow_fused_length(st, step);
      apply_split_common(st, step.stage_id, step.iter_id, {len},
                         step.inner_to_outer);
      return true;
    }
    case S_SA:
      // storage align: no effect on extents; the offset prints as a
      // "storage_offset:" pragma line (ir/steps.py StorageAlignStep)
      st.stages[step.stage_id].storage_offset = step.sa_offset;
      return true;
    case S_CA: {
      if (step.target_stage_id < 0 ||
          step.target_stage_id >= static_cast<int>(st.stages.size())) {
        return false;
      }
      Stage& s = st.stages[step.stage_id];
      for (auto& it : s.iters) it.extent = -1;
      s.compute_at = AT_ITER;
      st.attach_tgt[step.stage_id] = step.target_stage_id;
      st.attach_pos[step.stage_id] = step.target_iter_id;
      st.attach_seq[step.stage_id] = st.attach_counter++;
      return true;
    }
    case S_CI: {
      st.stages[step.stage_id].compute_at = AT_INLINED;
      st.attach_tgt[step.stage_id] = -1;
      return true;
    }
    case S_CR: {
      Stage& s = st.stages[step.stage_id];
      for (auto& it : s.iters) it.extent = -1;
      s.compute_at = AT_ROOT;
      st.attach_tgt[step.stage_id] = -1;
      return true;
    }
    case S_CHR:
      for (int rid : step.ids) {
        if (rid < 0 || rid >= static_cast<int>(st.stages.size())) {
          return false;
        }
      }
      apply_cache_read(st, step);
      return true;
    case S_CHW:
      apply_cache_write(st, step);
      return true;
    case S_RF:
      return apply_rfactor(st, step);
  }
  return false;
}

// ---------------------------------------------------------------------
// Bound inference (port of ir/bound.py)
// ---------------------------------------------------------------------

struct Bounds {
  // per stage: uid -> extent (dense arrays via uid index into vector)
  std::vector<std::vector<long>> ext;  // indexed by global uid (resized)
};

struct StageBounds {
  std::vector<char> dominates_thread;  // by uid

  void build(const State& st, const Stage& stage, int max_uid) {
    dominates_thread.assign(max_uid, 0);
    for (auto& it : stage.iters) {
      if (is_thread_ann(it.annotation)) dominates_thread[it.uid] = 1;
    }
    for (auto r = stage.rels.rbegin(); r != stage.rels.rend(); ++r) {
      if (r->kind == 0) {
        dominates_thread[r->parent] =
            dominates_thread[r->outer] | dominates_thread[r->inner];
      } else {
        char d = dominates_thread[r->fused];
        dominates_thread[r->outer] = d;
        if (r->inner >= 0) dominates_thread[r->inner] = d;
      }
    }
  }

  void pass_down(const Stage& stage, std::vector<long>& ext) const {
    for (auto& r : stage.rels) {
      if (r.kind == 0) {
        long p = ext[r.parent];
        if (p < 0 || r.factor < 0) continue;
        if (!r.by_nparts) {
          ext[r.inner] = dominates_thread[r.inner]
                             ? r.factor
                             : std::min(p, r.factor);
          ext[r.outer] = ceil_div(p, r.factor);
        } else {
          ext[r.outer] = dominates_thread[r.outer]
                             ? r.factor
                             : std::min(p, r.factor);
          ext[r.inner] = ceil_div(p, r.factor);
        }
      } else {
        long o = ext[r.outer];
        if (o < 0) continue;
        if (r.inner < 0) {
          ext[r.fused] = o;
        } else if (ext[r.inner] >= 0) {
          ext[r.fused] = o * ext[r.inner];
        }
      }
    }
  }

};

struct Interval {
  long lo, hi;
};

// ---------------------------------------------------------------------
// Symbolic integer sets (mirror of ir/intset.py)
//
// te's InferRootBound pins loops outside a producer's attach point to
// symbolic points, composes them through split/fuse relations with range
// mins added back, relaxes thread-bound vars over their ranges, and
// recovers extents as symbolic differences where the pinned vars cancel.
// Linear forms over interned atoms give O(1) structural equality.
// ---------------------------------------------------------------------

constexpr long SYM_INF = (1L << 60);

struct SAtom {
  int8_t kind;       // 0 var, 1 floordiv, 2 floormod, 3 min, 4 max
  long var_key = 0;  // kind 0: unique per (stage, iter uid)
  int f1 = -1;       // kind 1/2: inner LF; kind 3/4: a
  int f2 = -1;       // kind 3/4: b
  long c = 0;        // divisor
  long nlo = 0, nhi = 0;
};

struct SLF {
  long cst = 0;
  std::vector<std::pair<int, long>> terms;  // (atom id, coeff), sorted
  long nlo = 0, nhi = 0;                    // cached numeric bounds
};

struct SymCtx {
  std::vector<SAtom> atoms;
  std::vector<SLF> lfs;
  // open-addressing intern tables (hash, id+1); id 0 == empty slot.
  // A SymCtx lives for ONE infer_bounds call (~tens of interns), so the
  // tables start tiny; the previous unordered_map<uint64_t, vector<int>>
  // cost a heap-allocated bucket vector per distinct hash and dominated
  // the symbolic-machinery profile (intern + map ops ~12% of the
  // featurizer).
  std::vector<std::pair<uint64_t, int>> atom_tab, lf_tab;
  size_t atom_cnt = 0, lf_cnt = 0;
  int zero;

  SymCtx() : atom_tab(64), lf_tab(64) { zero = intern_lf(SLF{}); }

  static uint64_t mix(uint64_t h, uint64_t v) {
    h ^= v + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    return h;
  }

  static void grow_tab(std::vector<std::pair<uint64_t, int>>& tab) {
    std::vector<std::pair<uint64_t, int>> nt(tab.size() * 2);
    const size_t mask = nt.size() - 1;
    for (auto& e : tab) {
      if (e.second == 0) continue;
      size_t p = e.first & mask;
      while (nt[p].second != 0) p = (p + 1) & mask;
      nt[p] = e;
    }
    tab.swap(nt);
  }

  int intern_atom(SAtom a) {
    uint64_t h = mix(mix(mix(mix(a.kind, a.var_key), a.f1), a.f2), a.c);
    size_t mask = atom_tab.size() - 1;
    size_t p = h & mask;
    while (true) {
      auto& e = atom_tab[p];
      if (e.second == 0) break;
      if (e.first == h) {
        const SAtom& b = atoms[e.second - 1];
        if (b.kind == a.kind && b.var_key == a.var_key && b.f1 == a.f1 &&
            b.f2 == a.f2 && b.c == a.c) {
          return e.second - 1;
        }
      }
      p = (p + 1) & mask;
    }
    atoms.push_back(a);
    atom_tab[p] = {h, static_cast<int>(atoms.size())};
    if (++atom_cnt * 10 > atom_tab.size() * 7) grow_tab(atom_tab);
    return static_cast<int>(atoms.size()) - 1;
  }

  int intern_lf(SLF f) {
    uint64_t h = mix(0, f.cst);
    for (auto& t : f.terms) h = mix(mix(h, t.first), t.second);
    size_t mask = lf_tab.size() - 1;
    size_t p = h & mask;
    while (true) {
      auto& e = lf_tab[p];
      if (e.second == 0) break;
      if (e.first == h) {
        const SLF& b = lfs[e.second - 1];
        if (b.cst == f.cst && b.terms == f.terms) return e.second - 1;
      }
      p = (p + 1) & mask;
    }
    // numeric bounds
    f.nlo = f.nhi = f.cst;
    for (auto& t : f.terms) {
      const SAtom& a = atoms[t.first];
      if (t.second >= 0) {
        f.nlo += t.second * a.nlo;
        f.nhi += t.second * a.nhi;
      } else {
        f.nlo += t.second * a.nhi;
        f.nhi += t.second * a.nlo;
      }
    }
    lfs.push_back(std::move(f));
    lf_tab[p] = {h, static_cast<int>(lfs.size())};
    if (++lf_cnt * 10 > lf_tab.size() * 7) grow_tab(lf_tab);
    return static_cast<int>(lfs.size()) - 1;
  }

  int lf_const(long c) {
    SLF f;
    f.cst = c;
    return intern_lf(std::move(f));
  }

  int lf_atom(int atom_id, long coeff = 1, long cst = 0) {
    SLF f;
    f.cst = cst;
    if (coeff != 0) f.terms.emplace_back(atom_id, coeff);
    return intern_lf(std::move(f));
  }

  int var_atom(long key, long nlo, long nhi) {
    SAtom a;
    a.kind = 0;
    a.var_key = key;
    a.nlo = nlo;
    a.nhi = nhi;
    return intern_atom(a);
  }
};

inline long sfdiv(long a, long b) {
  long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
inline long sfmod(long a, long b) { return a - sfdiv(a, b) * b; }

inline int lf_add(SymCtx& sc, int a, int b) {
  const SLF& fa = sc.lfs[a];
  const SLF& fb = sc.lfs[b];
  SLF out;
  out.cst = fa.cst + fb.cst;
  size_t i = 0, j = 0;
  while (i < fa.terms.size() || j < fb.terms.size()) {
    if (j >= fb.terms.size() ||
        (i < fa.terms.size() && fa.terms[i].first < fb.terms[j].first)) {
      out.terms.push_back(fa.terms[i++]);
    } else if (i >= fa.terms.size() ||
               fb.terms[j].first < fa.terms[i].first) {
      out.terms.push_back(fb.terms[j++]);
    } else {
      long c = fa.terms[i].second + fb.terms[j].second;
      if (c != 0) out.terms.emplace_back(fa.terms[i].first, c);
      ++i;
      ++j;
    }
  }
  return sc.intern_lf(std::move(out));
}

inline int lf_scale(SymCtx& sc, int a, long k) {
  if (k == 1) return a;
  if (k == 0) return sc.zero;
  const SLF& fa = sc.lfs[a];
  SLF out;
  out.cst = fa.cst * k;
  for (auto& t : fa.terms) out.terms.emplace_back(t.first, t.second * k);
  return sc.intern_lf(std::move(out));
}

inline int lf_neg(SymCtx& sc, int a) { return lf_scale(sc, a, -1); }

inline int lf_sub(SymCtx& sc, int a, int b) {
  return lf_add(sc, a, lf_neg(sc, b));
}

inline int lf_addc(SymCtx& sc, int a, long c) {
  if (c == 0) return a;
  SLF out = sc.lfs[a];
  out.cst += c;
  out.nlo = out.nhi = 0;
  return sc.intern_lf(std::move(out));
}

inline bool lf_is_const(const SymCtx& sc, int a, long* v = nullptr) {
  if (!sc.lfs[a].terms.empty()) return false;
  if (v) *v = sc.lfs[a].cst;
  return true;
}

// exact: floordiv(D*c + R, c) = D + floordiv(R, c)
inline int lf_floordiv(SymCtx& sc, int f, long c) {
  SLF div_part;
  SLF rest;
  {
    const SLF& ff = sc.lfs[f];
    rest.cst = ff.cst;
    for (auto& t : ff.terms) {
      if (t.second % c == 0) {
        div_part.terms.emplace_back(t.first, t.second / c);
      } else {
        rest.terms.emplace_back(t.first, t.second);
      }
    }
  }
  int out = sc.intern_lf(std::move(div_part));
  int rest_id = sc.intern_lf(std::move(rest));
  const SLF& r = sc.lfs[rest_id];
  if (r.terms.empty()) return lf_addc(sc, out, sfdiv(r.cst, c));
  long qlo = sfdiv(r.nlo, c), qhi = sfdiv(r.nhi, c);
  if (qlo == qhi) return lf_addc(sc, out, qlo);
  SAtom a;
  a.kind = 1;
  a.f1 = rest_id;
  a.c = c;
  a.nlo = qlo;
  a.nhi = qhi;
  return lf_add(sc, out, sc.lf_atom(sc.intern_atom(a)));
}

// exact: floormod(sum ci*xi + k, c) = floormod(sum (ci mod c)*xi + k mod c, c)
inline int lf_floormod(SymCtx& sc, int f, long c) {
  SLF rest;
  {
    const SLF& ff = sc.lfs[f];
    rest.cst = sfmod(ff.cst, c);
    for (auto& t : ff.terms) {
      long co = sfmod(t.second, c);
      if (co != 0) rest.terms.emplace_back(t.first, co);
    }
  }
  int rest_id = sc.intern_lf(std::move(rest));
  const SLF& r = sc.lfs[rest_id];
  if (r.terms.empty()) return sc.lf_const(sfmod(r.cst, c));
  long q = sfdiv(r.nlo, c);
  if (q == sfdiv(r.nhi, c)) return lf_addc(sc, rest_id, -q * c);
  SAtom a;
  a.kind = 2;
  a.f1 = rest_id;
  a.c = c;
  a.nlo = 0;
  a.nhi = c - 1;
  return sc.lf_atom(sc.intern_atom(a));
}

inline int lf_min(SymCtx& sc, int a, int b) {
  if (a == b) return a;
  int d = lf_sub(sc, a, b);
  if (sc.lfs[d].nhi <= 0) return a;
  if (sc.lfs[d].nlo >= 0) return b;
  SAtom at;
  at.kind = 3;
  at.f1 = std::min(a, b);
  at.f2 = std::max(a, b);
  at.nlo = std::min(sc.lfs[a].nlo, sc.lfs[b].nlo);
  at.nhi = std::min(sc.lfs[a].nhi, sc.lfs[b].nhi);
  return sc.lf_atom(sc.intern_atom(at));
}

inline int lf_max(SymCtx& sc, int a, int b) {
  if (a == b) return a;
  int d = lf_sub(sc, a, b);
  if (sc.lfs[d].nlo >= 0) return a;
  if (sc.lfs[d].nhi <= 0) return b;
  SAtom at;
  at.kind = 4;
  at.f1 = std::min(a, b);
  at.f2 = std::max(a, b);
  at.nlo = std::max(sc.lfs[a].nlo, sc.lfs[b].nlo);
  at.nhi = std::max(sc.lfs[a].nhi, sc.lfs[b].nhi);
  return sc.lf_atom(sc.intern_atom(at));
}

// symbolic interval [lo, hi]; lo/hi = LF ids; everything = unbounded
struct SSI {
  int lo = -1, hi = -1;
  bool everything = false;

  static SSI every() {
    SSI s;
    s.everything = true;
    return s;
  }
  bool is_point() const { return !everything && lo == hi; }
};

inline SSI si_point(int f) { return SSI{f, f, false}; }
inline SSI si_const(SymCtx& sc, long v) {
  int f = sc.lf_const(v);
  return SSI{f, f, false};
}
inline SSI si_range(SymCtx& sc, long lo, long hi) {
  return SSI{sc.lf_const(lo), sc.lf_const(hi), false};
}

inline SSI si_add(SymCtx& sc, const SSI& a, const SSI& b) {
  if (a.everything || b.everything) return SSI::every();
  return SSI{lf_add(sc, a.lo, b.lo), lf_add(sc, a.hi, b.hi), false};
}

inline SSI si_addf(SymCtx& sc, const SSI& a, int f) {
  if (a.everything) return a;
  return SSI{lf_add(sc, a.lo, f), lf_add(sc, a.hi, f), false};
}

inline SSI si_sub(SymCtx& sc, const SSI& a, const SSI& b) {
  if (a.everything || b.everything) return SSI::every();
  return SSI{lf_sub(sc, a.lo, b.hi), lf_sub(sc, a.hi, b.lo), false};
}

inline SSI si_scale(SymCtx& sc, const SSI& a, long k) {
  if (a.everything) return a;
  if (k >= 0) return SSI{lf_scale(sc, a.lo, k), lf_scale(sc, a.hi, k), false};
  return SSI{lf_scale(sc, a.hi, k), lf_scale(sc, a.lo, k), false};
}

inline SSI si_mul(SymCtx& sc, const SSI& a, const SSI& b) {
  if (a.everything || b.everything) return SSI::every();
  long v;
  if (b.is_point() && lf_is_const(sc, b.lo, &v)) return si_scale(sc, a, v);
  if (a.is_point() && lf_is_const(sc, a.lo, &v)) return si_scale(sc, b, v);
  // non-affine product: numeric fallback
  long alo = sc.lfs[a.lo].nlo, ahi = sc.lfs[a.hi].nhi;
  long blo = sc.lfs[b.lo].nlo, bhi = sc.lfs[b.hi].nhi;
  long c1 = alo * blo, c2 = alo * bhi, c3 = ahi * blo, c4 = ahi * bhi;
  return si_range(sc, std::min(std::min(c1, c2), std::min(c3, c4)),
                  std::max(std::max(c1, c2), std::max(c3, c4)));
}

inline SSI si_floordiv_const(SymCtx& sc, const SSI& a, long c) {
  if (a.everything) return SSI::every();
  if (c == 1) return a;
  if (c > 0) {
    return SSI{lf_floordiv(sc, a.lo, c), lf_floordiv(sc, a.hi, c), false};
  }
  long lo = sc.lfs[a.lo].nlo, hi = sc.lfs[a.hi].nhi;
  long q1 = sfdiv(lo, c), q2 = sfdiv(hi, c);
  return si_range(sc, std::min(q1, q2), std::max(q1, q2));
}

inline SSI si_floormod_const(SymCtx& sc, const SSI& a, long c) {
  if (c <= 0) {
    long m = c == 0 ? 1 : -c;
    return si_range(sc, -(m - 1), m - 1);
  }
  if (a.everything) return si_range(sc, 0, c - 1);
  if (a.is_point()) return si_point(lf_floormod(sc, a.lo, c));
  int q1 = lf_floordiv(sc, a.lo, c);
  int q2 = lf_floordiv(sc, a.hi, c);
  if (q1 == q2) {
    int qc = lf_scale(sc, q1, c);
    return SSI{lf_sub(sc, a.lo, qc), lf_sub(sc, a.hi, qc), false};
  }
  return si_range(sc, 0, c - 1);
}

inline SSI si_floordiv(SymCtx& sc, const SSI& a, const SSI& b) {
  long v;
  if (b.is_point() && lf_is_const(sc, b.lo, &v) && v != 0) {
    return si_floordiv_const(sc, a, v);
  }
  return SSI::every();
}

inline SSI si_floormod(SymCtx& sc, const SSI& a, const SSI& b) {
  long v;
  if (b.is_point() && lf_is_const(sc, b.lo, &v) && v != 0) {
    return si_floormod_const(sc, a, v);
  }
  return SSI::every();
}

inline SSI si_min(SymCtx& sc, const SSI& a, const SSI& b) {
  if (a.everything || b.everything) return SSI::every();
  return SSI{lf_min(sc, a.lo, b.lo), lf_min(sc, a.hi, b.hi), false};
}

inline SSI si_max(SymCtx& sc, const SSI& a, const SSI& b) {
  if (a.everything || b.everything) return SSI::every();
  return SSI{lf_max(sc, a.lo, b.lo), lf_max(sc, a.hi, b.hi), false};
}

inline SSI si_union(SymCtx& sc, const SSI& a, const SSI& b) {
  if (a.everything || b.everything) return SSI::every();
  return SSI{lf_min(sc, a.lo, b.lo), lf_max(sc, a.hi, b.hi), false};
}

// substitution / relaxation: env maps var_key -> numeric [lo, hi]
using RelaxEnv = std::unordered_map<long, std::pair<long, long>>;

inline SSI lf_subst(SymCtx& sc, int f, const RelaxEnv& env);

inline SSI atom_subst(SymCtx& sc, int atom_id, const RelaxEnv& env) {
  const SAtom a = sc.atoms[atom_id];  // by value: sc may grow
  switch (a.kind) {
    case 0: {
      auto it = env.find(a.var_key);
      if (it != env.end()) {
        return si_range(sc, it->second.first, it->second.second);
      }
      int lf = sc.lf_atom(atom_id);
      return si_point(lf);
    }
    case 1:
      return si_floordiv_const(sc, lf_subst(sc, a.f1, env), a.c);
    case 2:
      return si_floormod_const(sc, lf_subst(sc, a.f1, env), a.c);
    case 3:
      return si_min(sc, lf_subst(sc, a.f1, env), lf_subst(sc, a.f2, env));
    default:
      return si_max(sc, lf_subst(sc, a.f1, env), lf_subst(sc, a.f2, env));
  }
}

inline SSI lf_subst(SymCtx& sc, int f, const RelaxEnv& env) {
  const SLF lf = sc.lfs[f];  // by value: sc may grow
  SSI out = si_const(sc, lf.cst);
  for (auto& t : lf.terms) {
    SSI si = atom_subst(sc, t.first, env);
    out = si_add(sc, out, si_scale(sc, si, t.second));
  }
  return out;
}

inline SSI si_subst(SymCtx& sc, const SSI& s, const RelaxEnv& env) {
  if (s.everything) return s;
  return SSI{lf_subst(sc, s.lo, env).lo, lf_subst(sc, s.hi, env).hi, false};
}

// read evaluator: union the demanded region of every read of `target_op`
// inside `reader_op`'s body under `env` (one SSI per reader dim, spatial
// then reduce) into `acc` (per target dim). `clip` applies te's
// PropBoundToInputs pairs-rule shape clipping. `found` reports whether any
// read of the target exists. Returns false only on evaluation failure.
using SymReadEval = std::function<bool(
    SymCtx&, int /*reader_op*/, int /*target_op*/,
    const std::vector<SSI>& /*env*/, bool /*clip*/,
    std::vector<SSI>& /*acc*/, bool& /*found*/)>;

// te PropBoundToInputs: replace with the full dim range only when the
// estimated region provably covers it on both ends (compute_op.cc)
inline SSI clip_read(SymCtx& sc, const SSI& si, long shape_d) {
  long top = std::max(0L, shape_d - 1);
  if (si.everything) return si_range(sc, 0, top);
  if (sc.lfs[si.lo].nhi <= 0 && sc.lfs[si.hi].nlo >= shape_d - 1) {
    return si_range(sc, 0, top);
  }
  return si;
}

// affine-table read evaluator (the extent featurizer path; the per-store
// featurizer passes a full-expression evaluator instead)
inline bool affine_read_eval(const State& st, SymCtx& sc, int reader_op,
                             int target_op, const std::vector<SSI>& env,
                             bool clip, std::vector<SSI>& acc,
                             bool& found) {
  const OpDesc& op = st.ops[reader_op];
  const OpDesc& src = st.ops[target_op];
  for (auto& rd : op.reads) {
    if (rd.src_op != target_op) continue;
    found = true;
    for (size_t d = 0; d < rd.idx.size(); ++d) {
      SSI si = si_const(sc, rd.idx[d].cst);
      for (auto& t : rd.idx[d].terms) {
        if (t.first < 0 || t.first >= static_cast<int>(env.size())) {
          return false;
        }
        si = si_add(sc, si, si_scale(sc, env[t.first], t.second));
      }
      if (clip && d < src.dims.size()) si = clip_read(sc, si, src.dims[d]);
      if (d < acc.size()) {
        acc[d] = acc[d].lo < 0 && !acc[d].everything
                     ? si
                     : si_union(sc, acc[d], si);
      }
    }
  }
  return true;
}


// ---------------------------------------------------------------------
// Step-token decoding
// ---------------------------------------------------------------------

inline bool decode_steps(const int32_t* toks, int64_t begin, int64_t end,
                  const char* pool, const int64_t* str_offs,
                  std::vector<Step>& steps) {
  int64_t i = begin;
  while (i < end) {
    if (i + 2 > end) return false;  // truncated header
    Step s;
    s.kind = toks[i];
    int n = toks[i + 1];
    if (s.kind < 0 || s.kind > S_RF || n < 0 || i + 2 + n > end) {
      return false;  // corrupt stream
    }
    i += 2;
    std::vector<long> args;         // scalar args in order
    std::vector<std::vector<int>> lists;
    std::vector<int> list_pos;      // which scalar-arg position the list was at
    std::vector<int> str_ids;
    std::vector<int> str_pos;
    int64_t j = i;
    int argpos = 0;
    while (j < i + n) {
      int32_t v = toks[j];
      if (v <= -1000000) {
        str_ids.push_back(-1000000 - v);
        str_pos.push_back(argpos);
        ++j;
      } else if (v < 0) {
        int ln = -v - 1;
        if (j + 1 + ln > i + n) return false;  // list overruns the step
        std::vector<int> lst(toks + j + 1, toks + j + 1 + ln);
        lists.push_back(std::move(lst));
        list_pos.push_back(argpos);
        j += 1 + ln;
      } else {
        args.push_back(v);
        ++j;
      }
      ++argpos;
    }
    i += n;

    auto need = [&](size_t k) { return args.size() >= k; };
    switch (s.kind) {
      case S_AN:  // [stage, iter, annotation]
        if (!need(3)) return false;
        s.stage_id = args[0]; s.iter_id = args[1]; s.level = args[2];
        break;
      case S_FU:  // [stage, [ids]]
        if (!need(1)) return false;
        s.stage_id = args[0];
        s.ids = lists.empty() ? std::vector<int>{} : lists[0];
        break;
      case S_PR: {  // [stage, iter, "pragma"]
        if (!need(2)) return false;
        s.stage_id = args[0]; s.iter_id = args[1];
        s.pragma_value = -1;
        if (!str_ids.empty()) {
          const char* p = pool + str_offs[str_ids[0]];
          const char* marker = strstr(p, "auto_unroll_max_step");
          if (marker) {
            const char* dollar = strchr(p, '$');
            if (dollar) s.pragma_value = atol(dollar + 1);
          } else if (strstr(p, "debug_skip_region")) {
            s.pragma_skip = true;  // rare; extents unaffected enough
          }
        }
        break;
      }
      case S_RE:
        if (!need(1)) return false;
        s.stage_id = args[0];
        s.ids = lists.empty() ? std::vector<int>{} : lists[0];
        break;
      case S_SP: {  // [stage, iter, extent, [lengths], inner_to_outer]
        if (!need(4) || lists.empty()) return false;
        s.stage_id = args[0]; s.iter_id = args[1]; s.extent = args[2];
        for (int x : lists[0]) s.lengths.push_back(x);
        s.inner_to_outer = args[3] != 0;
        break;
      }
      case S_FSP:  // [stage, iter, src_step, n_split]
        if (!need(4)) return false;
        s.stage_id = args[0]; s.iter_id = args[1];
        s.src_step_id = args[2]; s.n_split = args[3];
        break;
      case S_FFSP:  // [stage, iter, [src_ids], level, factor_or_nparts]
        if (!need(4) || lists.empty()) return false;
        s.stage_id = args[0]; s.iter_id = args[1];
        s.ids = lists[0]; s.level = args[2];
        s.inner_to_outer = args[3] != 0;
        break;
      case S_SA:  // [stage, iter, factor, offset]
        if (!need(1)) return false;
        s.stage_id = args[0];
        if (args.size() >= 4) s.sa_offset = args[3];
        break;
      case S_CA:  // [stage, target_stage, target_iter]
        if (!need(3)) return false;
        s.stage_id = args[0]; s.target_stage_id = args[1];
        s.target_iter_id = args[2];
        break;
      case S_CI:
      case S_CR:
        if (!need(1)) return false;
        s.stage_id = args[0];
        break;
      case S_CHR: {  // [stage, "scope", [reader_ids]]
        if (!need(1)) return false;
        s.stage_id = args[0];
        s.ids = lists.empty() ? std::vector<int>{} : lists[0];
        if (!str_ids.empty()) {
          const char* sc = pool + str_offs[str_ids[0]];
          s.scope_is_shared = strcmp(sc, "shared") == 0;
          s.scope = s.scope_is_shared
                        ? 1
                        : (strcmp(sc, "local") == 0 ? 3 : 0);
          s.scope_str = sc;
        }
        break;
      }
      case S_CHW:  // [stage, "scope"]
        if (!need(1)) return false;
        s.stage_id = args[0];
        if (!str_ids.empty()) {
          const char* sc = pool + str_offs[str_ids[0]];
          s.scope = strcmp(sc, "shared") == 0
                        ? 1
                        : (strcmp(sc, "local") == 0 ? 3 : 0);
          s.scope_str = sc;
        }
        break;
      case S_RF:
        if (!need(1)) return false;
        s.stage_id = args[0];
        s.iter_id = args.size() > 1 ? args[1] : 0;
        s.level = args.size() > 2 ? args[2] : 0;  // factor_iter_id
        break;
      default:
        return false;
    }
    steps.push_back(std::move(s));
  }
  return true;
}


// Run bound inference over the replayed state: fills each stage's iter
// extents and returns the per-(stage,pos) attachment lists for traversal.
struct InferResult {
  std::vector<std::vector<std::pair<int, int>>> attached;  // per stage
  bool ok = false;
};

// thread ranks (thread_storage_scope.h): blockIdx 0, threadIdx/vthread 1
inline int thread_rank(int ann) {
  switch (ann) {
    case ANN_BLOCK_X:
    case ANN_BLOCK_Y:
    case ANN_BLOCK_Z:
      return 0;
    case ANN_VTHREAD:
    case ANN_THREAD_X:
    case ANN_THREAD_Y:
    case ANN_THREAD_Z:
      return 1;
    default:
      return -1;
  }
}

// bound.cc:54-68 NeedRelax
inline bool need_relax(int ann, bool found_attach, int scope_rank) {
  int r = thread_rank(ann);
  if (r < 0) return !found_attach;
  return scope_rank <= r;
}

// Faithful mirror of ir/bound.py infer_bound (te::InferBound semantics:
// symbolic pinned points, PassUpDomain with range mins, NeedRelax by
// storage scope, pairs-rule read clipping). `read_eval` defaults to the
// affine tables; the per-store featurizer passes its full-expression
// evaluator.
inline InferResult infer_bounds(
    State& st, SymReadEval read_eval = nullptr,
    std::function<std::vector<int>(int)> list_reads = nullptr) {
  InferResult out;
  const int max_uid = st.uid;
  const int n = static_cast<int>(st.stages.size());
  SymCtx sc;
  bool fail = false;

  std::vector<StageBounds> sb(n);
  {
    VES_IBTIC;
    for (int i = 0; i < n; ++i) sb[i].build(st, st.stages[i], max_uid);
    VES_IBTOC(prof_ib_build);
  }

  out.attached.resize(n);
  for (int s = 0; s < n; ++s) {
    if (st.attach_tgt[s] >= 0) {
      out.attached[st.attach_tgt[s]].emplace_back(st.attach_pos[s], s);
    }
  }
  for (auto& v : out.attached) {
    std::stable_sort(v.begin(), v.end(), [&](auto& a, auto& b) {
      if (a.first != b.first) return a.first < b.first;
      return st.attach_seq[a.second] < st.attach_seq[b.second];
    });
  }

  if (!read_eval) {
    read_eval = [&st](SymCtx& sc2, int reader_op, int target_op,
                      const std::vector<SSI>& env, bool clip,
                      std::vector<SSI>& acc, bool& found) {
      return affine_read_eval(st, sc2, reader_op, target_op, env, clip,
                              acc, found);
    };
  }

  // direct readers: op -> reader stage ids
  std::vector<std::vector<int>> readers(st.ops.size());
  std::vector<int> sid_of_op(st.ops.size(), -1);
  for (int sid = 0; sid < n; ++sid) {
    sid_of_op[st.stages[sid].op] = sid;
  }
  for (int sid = 0; sid < n; ++sid) {
    int op_id = st.stages[sid].op;
    const OpDesc& op = st.ops[op_id];
    if (op.kind == 0) continue;
    std::vector<int> srcs;
    if (list_reads) {
      srcs = list_reads(op_id);
    } else {
      for (auto& rd : op.reads) {
        if (std::find(srcs.begin(), srcs.end(), rd.src_op) == srcs.end()) {
          srcs.push_back(rd.src_op);
        }
      }
    }
    for (int src : srcs) {
      if (src >= 0 && src < static_cast<int>(readers.size())) {
        readers[src].push_back(sid);
      }
    }
  }

  // attach path: (stage, pos) pairs enclosing `sid`'s body
  auto attach_path = [&](int sid) {
    std::vector<std::pair<int, int>> path;
    int cur = sid;
    int guard = 0;
    while (st.attach_tgt[cur] >= 0 && guard++ < n + 1) {
      int tsid = st.attach_tgt[cur];
      int tpos = st.attach_pos[cur];
      for (int p = tpos; p >= 0; --p) path.emplace_back(tsid, p);
      cur = tsid;
    }
    return path;
  };

  // storage scope rank (InferStorageScope + DefaultStorageRank)
  auto scope_rank_of = [&](int sid) -> int {
    const Stage& s = st.stages[sid];
    if (s.scope >= 0) return s.scope;
    if (s.is_shared) return 1;
    int max_rank = -1;
    for (auto& tp : attach_path(sid)) {
      const Stage& ts = st.stages[tp.first];
      if (tp.second < static_cast<int>(ts.iters.size())) {
        max_rank = std::max(max_rank,
                            thread_rank(ts.iters[tp.second].annotation));
      }
    }
    if (max_rank < 0) return 0;
    return max_rank == 0 ? 1 : 3;
  };

  // per stage: uid -> extent (incl. intermediates); root uid -> min LF
  std::vector<std::vector<long>> full_ext(n);
  std::vector<std::unordered_map<int, int>> root_min(n);

  auto leaf_var_key = [](int sid, int uid) -> long {
    return static_cast<long>(sid) * 1000003L + uid;
  };
  auto leaf_atom = [&](int sid, const Iter& it) -> int {
    long e = it.extent >= 0 ? it.extent : 1;
    return sc.var_atom(leaf_var_key(sid, it.uid), 0, std::max(0L, e - 1));
  };

  // consumer_env cache: per (consumer sid, scope, attach key)
  struct EnvKey {
    int c_sid, scope, atgt, apos;
    bool operator==(const EnvKey& o) const {
      return c_sid == o.c_sid && scope == o.scope && atgt == o.atgt &&
             apos == o.apos;
    }
  };
  struct EnvKeyHash {
    size_t operator()(const EnvKey& k) const {
      return ((size_t)k.c_sid * 131071) ^ ((size_t)k.scope * 8191) ^
             ((size_t)(k.atgt + 1) * 127) ^ (size_t)(k.apos + 1);
    }
  };
  std::unordered_map<EnvKey, std::vector<SSI>, EnvKeyHash> env_cache;

  // dom_map for a consumer's root dims relative to a producer with the
  // given scope attached at (atgt, apos); bound.cc InferRootBound
  auto consumer_env = [&](int c_sid, int scope, int atgt,
                          int apos) -> const std::vector<SSI>& {
    EnvKey key{c_sid, scope, atgt, apos};
#ifdef VES_PROF
    prof_env_calls.fetch_add(1);
#endif
    auto hit = env_cache.find(key);
    if (hit != env_cache.end()) return hit->second;
#ifdef VES_PROF
    prof_env_miss.fetch_add(1);
#endif
    VES_IBTIC;

    const Stage& C = st.stages[c_sid];
    int attach_uid = -1;
    if (atgt >= 0 &&
        apos < static_cast<int>(st.stages[atgt].iters.size())) {
      attach_uid = st.stages[atgt].iters[apos].uid;
    }

    bool found = false;
    std::vector<SSI> up(max_uid);
    std::vector<char> has(max_uid, 0), is_leaf(max_uid, 0);
    VES_IBTOC(prof_env_nest);  // (alloc accounted to nest)
    // consumer nest (bound.cc:139-158)
    for (int i = static_cast<int>(C.iters.size()) - 1; i >= 0; --i) {
      const Iter& it = C.iters[i];
      if (attach_uid >= 0 && it.uid == attach_uid) found = true;
      long e = it.extent >= 0 ? it.extent : 1;
      is_leaf[it.uid] = 1;
      has[it.uid] = 1;
      if (e == 1) {
        up[it.uid] = si_const(sc, 0);
      } else if (!need_relax(it.annotation, found, scope)) {
        up[it.uid] = si_point(sc.lf_atom(leaf_atom(c_sid, it)));
      } else {
        up[it.uid] = si_range(sc, 0, e - 1);
      }
    }

    // consumer's attach nest -> relax_set (bound.cc:160-171)
    RelaxEnv relax_env;
    for (auto& tp : attach_path(c_sid)) {
      const Stage& ts = st.stages[tp.first];
      if (tp.second >= static_cast<int>(ts.iters.size())) continue;
      const Iter& iv = ts.iters[tp.second];
      if (attach_uid >= 0 && iv.uid == attach_uid) found = true;
      if (need_relax(iv.annotation, found, scope)) {
        long e = iv.extent >= 0 ? iv.extent : 1;
        relax_env[leaf_var_key(tp.first, iv.uid)] = {0, std::max(0L, e - 1)};
      }
    }

    VES_IBTOC(prof_env_nest);
    // PassUpDomain (message_passing.cc:280-341)
    const std::vector<long>& dom_ext = full_ext[c_sid];
    auto dext = [&](int uid) -> long {
      return uid >= 0 && uid < static_cast<int>(dom_ext.size())
                 ? dom_ext[uid]
                 : -1;
    };
    auto dmin = [&](int uid) -> int {
      auto it2 = root_min[c_sid].find(uid);
      return it2 != root_min[c_sid].end() ? it2->second : sc.zero;
    };
    auto match_range = [&](const SSI& s, int mn, long ext) -> bool {
      if (ext < 0 || s.everything) return false;
      return s.lo == mn && s.hi == lf_addc(sc, mn, ext - 1);
    };
    auto from_range = [&](int mn, long ext) -> SSI {
      return SSI{mn, lf_addc(sc, mn, ext - 1), false};
    };

    for (auto r = C.rels.rbegin(); r != C.rels.rend(); ++r) {
      if (r->kind == 0) {  // split
        if (!has[r->outer] || !has[r->inner]) continue;
        const SSI& o = up[r->outer];
        const SSI& i = up[r->inner];
        long oe = dext(r->outer), ie = dext(r->inner), pe = dext(r->parent);
        int pmin = dmin(r->parent);
        if (pe >= 0 && match_range(o, sc.zero, oe) &&
            match_range(i, sc.zero, ie)) {
          up[r->parent] = from_range(pmin, pe);
        } else {
          long fac = ie >= 0 ? ie : (r->factor >= 0 ? r->factor : 1);
          up[r->parent] =
              si_addf(sc, si_add(sc, si_scale(sc, o, fac), i), pmin);
        }
        has[r->parent] = 1;
      } else {  // fuse
        if (!has[r->fused]) continue;
        const SSI f = up[r->fused];
        long fe_dom = dext(r->fused);
        int omin = dmin(r->outer);
        long oe = dext(r->outer);
        if (r->inner < 0) {
          // single-iter fuse: pure renaming (te Rebase semantics)
          if (match_range(f, sc.zero, fe_dom)) {
            up[r->outer] = from_range(omin, oe >= 0 ? oe : fe_dom);
          } else {
            up[r->outer] = si_addf(sc, f, omin);
          }
          has[r->outer] = 1;
          continue;
        }
        int imin = dmin(r->inner);
        long ie = dext(r->inner);
        if (ie < 0) ie = 1;
        if (oe >= 0 && match_range(f, sc.zero, fe_dom)) {
          up[r->outer] = from_range(omin, oe);
          up[r->inner] = from_range(imin, ie);
        } else if (f.is_point()) {
          up[r->outer] = si_point(lf_add(sc, lf_floordiv(sc, f.lo, ie),
                                         omin));
          up[r->inner] = si_point(lf_add(sc, lf_floormod(sc, f.lo, ie),
                                         imin));
        } else {
          up[r->outer] =
              SSI{lf_add(sc, omin, lf_floordiv(sc, f.lo, ie)),
                  lf_add(sc, omin, lf_floordiv(sc, f.hi, ie)), false};
          int fe_form = lf_addc(sc, lf_sub(sc, f.hi, f.lo), 1);
          long fe;
          bool tight = lf_is_const(sc, fe_form, &fe) && fe > 0 &&
                       ie % fe == 0;
          if (tight) {
            long mlo;
            tight = lf_is_const(sc, lf_floormod(sc, f.lo, fe), &mlo) &&
                    mlo == 0;
          }
          if (tight) {
            up[r->inner] =
                SSI{lf_add(sc, imin, lf_floormod(sc, f.lo, ie)),
                    lf_add(sc, imin, lf_floormod(sc, f.hi, ie)), false};
          } else {
            up[r->inner] = from_range(imin, ie);
          }
        }
        has[r->outer] = 1;
        has[r->inner] = 1;
      }
    }

    VES_IBTOC(prof_env_pud);
    // root doms: CoverRange + relax (bound.cc:178-196); env indexed by
    // the op's dim order (spatial then reduce, matching AffineIdx refs)
    std::vector<SSI> env(C.roots.size());
    for (size_t i = 0; i < C.roots.size(); ++i) {
      int uid = C.roots[i].first;
      SSI s;
      if (uid < max_uid && has[uid]) {
        s = up[uid];
        if (is_leaf[uid]) {
          int mn = dmin(uid);
          if (mn != sc.zero) s = si_addf(sc, s, mn);
        }
      } else {
        long e = dext(uid);
        s = from_range(dmin(uid), e >= 0 ? e : C.roots[i].second);
      }
      if (!relax_env.empty() && !s.everything) {
        s = si_subst(sc, s, relax_env);
      }
      env[i] = s;
    }
    VES_IBTOC(prof_env_roots);
    auto ins = env_cache.emplace(key, std::move(env));
    VES_IBTOC(prof_ib_env);
    return ins.first->second;
  };

  // consumers of an op with inlined chains (consumer sid, chain of
  // inlined ops ordered consumer->producer)
  auto consumers_of = [&](int op_uid) {
    std::vector<std::pair<int, std::vector<int>>> outc;
    std::function<void(int, std::vector<int>&)> walk = [&](int uid,
                                                           std::vector<int>&
                                                               chain) {
      if (uid < 0 || uid >= static_cast<int>(readers.size())) return;
      for (int r_sid : readers[uid]) {
        const Stage& rs = st.stages[r_sid];
        if (rs.compute_at == AT_INLINED) {
          if (static_cast<int>(chain.size()) > n) continue;  // cycle guard
          chain.insert(chain.begin(), rs.op);
          walk(rs.op, chain);
          chain.erase(chain.begin());
        } else {
          outc.emplace_back(r_sid, chain);
        }
      }
    };
    std::vector<int> chain;
    walk(op_uid, chain);
    return outc;
  };

  // demanded region of `target_op` read by consumer c_sid through a chain
  // of inlined ops; returns false if the consumer never reaches it
  auto eval_chain = [&](int c_sid, const std::vector<SSI>& env0,
                        const std::vector<int>& chain, int target_op,
                        std::vector<SSI>& result) -> bool {
    int cur_op = st.stages[c_sid].op;
    std::vector<SSI> env = env0;
    std::vector<int> ops(chain);
    ops.push_back(target_op);
    for (size_t ci = 0; ci < ops.size(); ++ci) {
      int nxt = ops[ci];
      const OpDesc& nop = st.ops[nxt];
      size_t nd = nop.dims.size();
      bool is_target = (ci + 1 == ops.size());
      std::vector<SSI> acc(nd);  // lo=-1 marks unset
      bool found = false;
      if (!read_eval(sc, cur_op, nxt, env, is_target, acc, found)) {
        fail = true;
        return false;
      }
      if (!found) return false;
      for (auto& a : acc) {
        if (a.lo < 0 && !a.everything) return false;  // partial read info
      }
      if (is_target) {
        result = std::move(acc);
        return true;
      }
      // intermediate inlined op: dims take the demanded region, reduce
      // axes span fully
      env.assign(nd + nop.reduce.size(), SSI());
      for (size_t d = 0; d < nd; ++d) env[d] = acc[d];
      for (size_t d = 0; d < nop.reduce.size(); ++d) {
        env[nd + d] = si_range(sc, 0, nop.reduce[d] - 1);
      }
      cur_op = nxt;
    }
    return false;
  };

  // ---- main reversed stage loop (bound.cc:216-232) ----
  for (int sid = n - 1; sid >= 0; --sid) {
    Stage& stage = st.stages[sid];
    const OpDesc& op = st.ops[stage.op];
    if (op.kind == 0 || stage.compute_at == AT_INLINED) continue;

    std::vector<long> roots(max_uid, -1);
    auto full_roots = [&]() {
      for (auto& kv : stage.roots) roots[kv.first] = kv.second;
    };

    auto cons = consumers_of(stage.op);
    if (cons.empty()) {
      full_roots();
    } else {
      int atgt = st.attach_tgt[sid], apos = st.attach_pos[sid];
      int srank = scope_rank_of(sid);
      size_t ndim = op.dims.size();
      std::vector<SSI> tdom(ndim);  // lo=-1 marks unset
      bool any = false;
      for (auto& cc : cons) {
        const std::vector<SSI>& env =
            consumer_env(cc.first, srank, atgt, apos);
        std::vector<SSI> dem;
        VES_IBTIC;
        bool got = eval_chain(cc.first, env, cc.second, stage.op, dem);
        VES_IBTOC(prof_ib_chain);
        if (!got) {
          continue;
        }
        any = true;
        for (size_t d = 0; d < ndim && d < dem.size(); ++d) {
          tdom[d] = (tdom[d].lo < 0 && !tdom[d].everything)
                        ? dem[d]
                        : si_union(sc, tdom[d], dem[d]);
        }
      }
      full_roots();
      if (any) {
        // GatherBound: spatial dims from the union, reduce dims full
        for (size_t i = 0; i < stage.roots.size(); ++i) {
          if (stage.root_is_reduce[i] || i >= ndim) continue;
          const SSI& u = tdom[i];
          if ((u.lo < 0 && !u.everything) || u.everything) continue;
          const SLF& lo = sc.lfs[u.lo];
          const SLF& hi = sc.lfs[u.hi];
          if (lo.nlo <= -SYM_INF || hi.nhi >= SYM_INF) continue;
          int ext_form = lf_addc(sc, lf_sub(sc, u.hi, u.lo), 1);
          long ec;
          if (!lf_is_const(sc, ext_form, &ec)) {
            ec = sc.lfs[ext_form].nhi;  // numeric upper bound
          }
          roots[stage.roots[i].first] = std::max(1L, ec);
          if (u.lo != sc.zero) {
            root_min[sid][stage.roots[i].first] = u.lo;
          }
        }
      }
    }

    std::vector<long> ext(max_uid, -1);
    for (auto& kv : stage.roots) {
      ext[kv.first] = roots[kv.first] >= 0 ? roots[kv.first] : kv.second;
    }
    VES_IBTIC;
    sb[sid].pass_down(stage, ext);
    VES_IBTOC(prof_ib_down);
    full_ext[sid] = ext;
    for (auto& it : stage.iters) {
      long e = ext[it.uid];
      it.extent = e >= 0 ? e : (it.extent >= 0 ? it.extent : 1);
    }
  }

  out.ok = !fail;
  return out;
}

// ---------------------------------------------------------------------
// Byte-exact state printing (mirror of ir/state.py State.to_str, itself
// format-parity with reference loop_state.cc:354-440 PrintState).
// Requires a track_names replay and a completed infer_bounds pass (iter
// extents written back; attachment lists from the InferResult).
// ---------------------------------------------------------------------

inline const char* const kAnnStr[] = {
    "for",        "unroll",      "vectorize",  "parallel",
    "vthread",    "blockIdx.x",  "threadIdx.x", "blockIdx.y",
    "threadIdx.y", "blockIdx.z", "threadIdx.z", "tensorize"};

inline void print_stage_text(const State& st, const InferResult& inf,
                             int sid, int base_indent, std::string& out) {
  const Stage& s = st.stages[sid];
  const std::string& opname = st.op_name[s.op];
  if (s.auto_unroll != 0) {
    out.append(base_indent, ' ');
    out += opname;
    out += " auto_unroll: ";
    out += std::to_string(s.auto_unroll);
    out += "\n";
  }
  if (s.storage_offset != 0) {
    out.append(base_indent, ' ');
    out += opname;
    out += " storage_offset: ";
    out += std::to_string(s.storage_offset);
    out += "\n";
  }
  int indent = 0;
  for (size_t i = 0; i < s.iters.size(); ++i) {
    const Iter& it = s.iters[i];
    const bool trivial = it.extent == 1;  // delete_trivial_loop
    if (!trivial) {
      out.append(base_indent + indent, ' ');
      out += kAnnStr[it.annotation];
      out += ' ';
      out += st.iname(it.uid);
      if (it.extent >= 0) {
        out += " (0,";
        out += std::to_string(it.extent);
        out += ")";
      } else {
        out += " (None)";
      }
      out += "\n";
      indent += 2;
    }
    for (const auto& pa : inf.attached[sid]) {
      if (pa.first == static_cast<int>(i)) {
        print_stage_text(st, inf, pa.second, base_indent + indent, out);
      }
    }
  }
  out.append(base_indent + indent, ' ');
  out += opname;
  out += " = ...\n";
}

inline std::string print_state_text(const State& st,
                                    const InferResult& inf) {
  std::string out = "Placeholder: ";
  bool first = true;
  for (const Stage& s : st.stages) {
    if (st.ops[s.op].kind != 0) continue;
    if (!first) out += ", ";
    out += st.op_name[s.op];
    first = false;
  }
  out += "\n";
  for (size_t i = 0; i < st.stages.size(); ++i) {
    if (st.ops[st.stages[i].op].kind == 0) continue;
    if (st.stages[i].compute_at == AT_ROOT) {
      print_stage_text(st, inf, static_cast<int>(i), 0, out);
    }
  }
  return out;
}

// structural hash of a replayed state: stage ops, compute locations,
// iterator extents/annotations and attachments — the native equivalent of
// dedup by State::ToStr (names are determined by ops and order)
inline uint64_t state_struct_hash(const State& st) {
  uint64_t h = 1469598103934665603ULL;  // FNV-1a
  auto mix = [&h](long v) {
    h ^= static_cast<uint64_t>(v);
    h *= 1099511628211ULL;
  };
  for (size_t sid = 0; sid < st.stages.size(); ++sid) {
    const Stage& s = st.stages[sid];
    mix(s.op);
    mix(s.compute_at);
    mix(s.auto_unroll);
    mix(st.attach_tgt[sid]);
    mix(st.attach_pos[sid]);
    mix(static_cast<long>(s.iters.size()));
    for (auto& it : s.iters) {
      mix(it.extent);
      mix(it.annotation);
      mix(it.kind);
    }
  }
  return h;
}

// print-order extent extraction over an inferred state (the VAE-extent
// feature: loop extents in print order + auto_unroll values,
// vae_extent_search.py:166-176)
inline void extract_extents(State& st, const InferResult& inf,
                            std::vector<float>& extents,
                            std::vector<float>& unrolls) {
  std::function<void(int)> extract = [&](int sid) {
    Stage& stage = st.stages[sid];
    if (stage.auto_unroll != 0) {
      unrolls.push_back(static_cast<float>(stage.auto_unroll));
    }
    for (size_t pos = 0; pos < stage.iters.size(); ++pos) {
      long e = stage.iters[pos].extent;
      if (e != 1 && e >= 0) {
        extents.push_back(static_cast<float>(e));
      }
      for (auto& pa : inf.attached[sid]) {
        if (pa.first == static_cast<int>(pos)) extract(pa.second);
      }
    }
  };
  for (size_t sid = 0; sid < st.stages.size(); ++sid) {
    if (st.ops[st.stages[sid].op].kind == 0 ||
        st.stages[sid].compute_at != AT_ROOT) {
      continue;
    }
    extract(static_cast<int>(sid));
  }
}

}  // namespace ves
