// Native batch extent featurizer: schedule replay + bound inference.
//
// The equivalent of the reference's C++ hot loop (feature.cc worker:
// re-apply transform steps, infer bounds, extract features over thousands
// of records — parallelized with support::parallel_for,
// feature.cc:1296-1398). Here the consumer is the VAE-extent experiment's
// feature: the loop extents in print order + auto_unroll values
// (vae_extent_search.py:166-176):
//
//   step tokens (record_parser.cpp) + affine task descriptor
//   (records/task_desc.py) -> replay the 14 step kinds onto an
//   array-based loop state -> demand-driven bound inference (the same
//   algorithm as vae_extent_search_tpu/ir/bound.py) -> print-order
//   extent vector.
//
// The replay + bound-inference core lives in ves_replay.h (shared with
// the per-store featurizer). Semantics are golden-tested against the
// Python IR in tests/test_native.py. Records containing Rfactor steps or
// non-affine ops return status 1 (caller falls back to Python).

#include "ves_replay.h"

namespace {

using namespace ves;

struct FeaturizeResult {
  std::vector<float> extents;       // flattened
  std::vector<int64_t> offsets;     // per record begin (n+1 entries)
  std::vector<int32_t> status;      // 0 ok, 1 fallback-needed, 2 error
};

}  // namespace

extern "C" {

void* ves_featurize_extents(const int32_t* task_desc,
                            const int32_t* step_tokens,
                            const int64_t* rec_begin,
                            const int64_t* rec_end, int64_t n_recs,
                            const char* string_pool,
                            const int64_t* string_offsets,
                            int n_threads) {
  TaskDesc td = parse_task_desc(task_desc);
  auto* res = new FeaturizeResult();
  res->offsets.resize(n_recs + 1, 0);
  res->status.resize(n_recs, 0);

  std::vector<std::vector<float>> per_rec_ext(n_recs);

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::vector<Step> steps;
      if (!decode_steps(step_tokens, rec_begin[r], rec_end[r], string_pool,
                        string_offsets, steps)) {
        res->status[r] = 2;
        continue;
      }
      State st;
      init_state(st, td);
      bool ok = true;
      for (auto& s : steps) {
        st.steps.push_back(s);
        if (!apply_step(st, s)) { ok = false; break; }
      }
      if (!ok) {
        res->status[r] = 1;  // fallback (rfactor etc.)
        continue;
      }
      InferResult inf = infer_bounds(st);
      if (!inf.ok) {
        res->status[r] = 2;
        continue;
      }
      std::vector<float> ext, unr;
      ves::extract_extents(st, inf, ext, unr);
      if (unr.empty()) unr.push_back(0.0f);
      ext.insert(ext.end(), unr.begin(), unr.end());
      per_rec_ext[r] = std::move(ext);
    }
  };

  if (n_threads <= 1) {
    work(0, n_recs);
  } else {
    std::vector<std::thread> pool_threads;
    int64_t chunk = (n_recs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n_recs, lo + chunk);
      if (lo >= hi) break;
      pool_threads.emplace_back(work, lo, hi);
    }
    for (auto& th : pool_threads) th.join();
  }

  for (int64_t r = 0; r < n_recs; ++r) {
    res->offsets[r] = static_cast<int64_t>(res->extents.size());
    res->extents.insert(res->extents.end(), per_rec_ext[r].begin(),
                        per_rec_ext[r].end());
  }
  res->offsets[n_recs] = static_cast<int64_t>(res->extents.size());
  return res;
}

const float* ves_fx_extents(void* h) {
  return static_cast<FeaturizeResult*>(h)->extents.data();
}
int64_t ves_fx_num_extents(void* h) {
  return static_cast<FeaturizeResult*>(h)->extents.size();
}
const int64_t* ves_fx_offsets(void* h) {
  return static_cast<FeaturizeResult*>(h)->offsets.data();
}
const int32_t* ves_fx_status(void* h) {
  return static_cast<FeaturizeResult*>(h)->status.data();
}
void ves_fx_free(void* h) { delete static_cast<FeaturizeResult*>(h); }

}  // extern "C"
