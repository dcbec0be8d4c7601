// Fast NDJSON measure-record parser (native data-loader).
//
// The reference's record reading hot loop is C++
// (src/auto_scheduler/measure_record.cc RecordReader, dmlc::JSONReader);
// this is our TPU-era equivalent: an mmap'd single-pass scanner that
// tokenizes Ansor measure-record lines
//   {"i": [[workload_key, target, hw...], [[], [steps...]]],
//    "r": [[costs...], error_no, all_cost, ts], "v": "..."}
// into flat output buffers ready for zero-copy handoff to Python/numpy:
//   - per record: offsets into a step-token stream, costs, error_no
//   - step tokens: (kind id, int args...) with strings interned
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// Build: scripts/build_native.sh -> libves_native.so

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// step token stream layout: [kind, n_args, args...]
// kind ids match STEP_CLASSES ordering in vae_extent_search_tpu/ir/steps.py
enum StepKind : int32_t {
  AN = 0, FU, PR, RE, SP, FSP, FFSP, SA, CA, CI, CR, CHR, CHW, RF,
  UNKNOWN = -1
};

int32_t step_kind_of(const char* s, size_t n) {
  switch (n) {
    case 2:
      if (!memcmp(s, "AN", 2)) return AN;
      if (!memcmp(s, "FU", 2)) return FU;
      if (!memcmp(s, "PR", 2)) return PR;
      if (!memcmp(s, "RE", 2)) return RE;
      if (!memcmp(s, "SP", 2)) return SP;
      if (!memcmp(s, "SA", 2)) return SA;
      if (!memcmp(s, "CA", 2)) return CA;
      if (!memcmp(s, "CI", 2)) return CI;
      if (!memcmp(s, "CR", 2)) return CR;
      if (!memcmp(s, "RF", 2)) return RF;
      break;
    case 3:
      if (!memcmp(s, "FSP", 3)) return FSP;
      if (!memcmp(s, "CHR", 3)) return CHR;
      if (!memcmp(s, "CHW", 3)) return CHW;
      break;
    case 4:
      if (!memcmp(s, "FFSP", 4)) return FFSP;
      break;
  }
  return UNKNOWN;
}

struct Parser {
  const char* p;
  const char* end;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
  }
  bool expect(char c) {
    skip_ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }
  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }
  // parse a JSON string; returns [begin,end) of the unescaped-ish content
  bool parse_string(const char** sb, const char** se) {
    skip_ws();
    if (p >= end || *p != '"') return false;
    ++p;
    *sb = p;
    while (p < end && *p != '"') {
      if (*p == '\\') ++p;
      ++p;
    }
    if (p >= end) return false;
    *se = p;
    ++p;
    return true;
  }
  bool parse_double(double* out) {
    skip_ws();
    char* e = nullptr;
    *out = strtod(p, &e);
    if (e == p) return false;
    p = e;
    return true;
  }
  // number OR JSON null (undefined split lengths serialize as null;
  // token convention maps None <-> -1, matching _encode_steps)
  bool parse_double_or_null(double* out) {
    skip_ws();
    if (end - p >= 4 && p[0] == 'n' && p[1] == 'u' && p[2] == 'l' &&
        p[3] == 'l') {
      p += 4;
      *out = -1.0;
      return true;
    }
    return parse_double(out);
  }
  // skip any JSON value
  bool skip_value() {
    skip_ws();
    if (p >= end) return false;
    if (*p == '"') {
      const char *a, *b;
      return parse_string(&a, &b);
    }
    if (*p == '[') {
      ++p;
      if (peek(']')) { ++p; return true; }
      while (true) {
        if (!skip_value()) return false;
        if (expect(',')) continue;
        return expect(']');
      }
    }
    if (*p == '{') {
      ++p;
      if (peek('}')) { ++p; return true; }
      while (true) {
        const char *a, *b;
        if (!parse_string(&a, &b)) return false;
        if (!expect(':')) return false;
        if (!skip_value()) return false;
        if (expect(',')) continue;
        return expect('}');
      }
    }
    double d;
    return parse_double(&d);
  }
};

struct ParseResult {
  // flattened step tokens across all records
  std::vector<int32_t> step_tokens;
  // per record
  std::vector<int64_t> rec_step_begin;   // offset into step_tokens
  std::vector<int64_t> rec_step_end;
  std::vector<int32_t> rec_task_id;      // interned (workload_key, target)
  std::vector<double> rec_mean_cost;
  std::vector<double> rec_first_cost;
  std::vector<int32_t> rec_error_no;
  // interned strings (workload keys, targets, pragma strings, scopes)
  std::string string_pool;               // NUL-separated
  std::vector<int64_t> string_offsets;
  // task table: pairs of string ids
  std::vector<int32_t> task_wkl_str;
  std::vector<int32_t> task_target_str;
  std::string error;
};

std::string unescape(const char* b, const char* e) {
  std::string s;
  s.reserve(e - b);
  for (const char* p = b; p < e; ++p) {
    if (*p == '\\' && p + 1 < e) {
      ++p;
      switch (*p) {
        case 'n': s.push_back('\n'); break;
        case 't': s.push_back('\t'); break;
        case 'r': s.push_back('\r'); break;
        default: s.push_back(*p); break;  // \" \\ \/ ...
      }
    } else {
      s.push_back(*p);
    }
  }
  return s;
}

int32_t intern(ParseResult* r, const char* b, const char* e,
               std::vector<std::pair<std::string, int32_t>>* cache) {
  std::string s = unescape(b, e);
  for (auto& kv : *cache) {
    if (kv.first == s) return kv.second;
  }
  int32_t id = static_cast<int32_t>(r->string_offsets.size());
  r->string_offsets.push_back(static_cast<int64_t>(r->string_pool.size()));
  r->string_pool.append(s);
  r->string_pool.push_back('\0');
  cache->emplace_back(std::move(s), id);
  return id;
}

// parse one step array: ["KIND", args...]; args may be ints, strings or
// int lists. Token stream: kind, n_tokens, then per arg:
//   int      -> value
//   list     -> -(len+1) marker followed by len values
//   string   -> -1000000 - string_id
bool parse_step(Parser* ps, ParseResult* res,
                std::vector<std::pair<std::string, int32_t>>* strings) {
  if (!ps->expect('[')) return false;
  const char *sb, *se;
  if (!ps->parse_string(&sb, &se)) return false;
  int32_t kind = step_kind_of(sb, se - sb);
  size_t head = res->step_tokens.size();
  res->step_tokens.push_back(kind);
  res->step_tokens.push_back(0);  // patched below
  while (ps->expect(',')) {
    ps->skip_ws();
    if (ps->peek('[')) {
      ps->expect('[');
      size_t marker = res->step_tokens.size();
      res->step_tokens.push_back(0);
      int32_t n = 0;
      if (!ps->peek(']')) {
        do {
          double d;
          if (!ps->parse_double_or_null(&d)) return false;
          res->step_tokens.push_back(static_cast<int32_t>(d));
          ++n;
        } while (ps->expect(','));
      }
      if (!ps->expect(']')) return false;
      res->step_tokens[marker] = -(n + 1);
    } else if (ps->peek('"')) {
      const char *b2, *e2;
      if (!ps->parse_string(&b2, &e2)) return false;
      int32_t sid = intern(res, b2, e2, strings);
      res->step_tokens.push_back(-1000000 - sid);
    } else {
      double d;
      if (!ps->parse_double_or_null(&d)) return false;
      res->step_tokens.push_back(static_cast<int32_t>(d));
    }
  }
  if (!ps->expect(']')) return false;
  res->step_tokens[head + 1] =
      static_cast<int32_t>(res->step_tokens.size() - head - 2);
  return true;
}

bool parse_line(const char* b, const char* e, ParseResult* res,
                std::vector<std::pair<std::string, int32_t>>* strings,
                std::vector<std::pair<std::string, int32_t>>* tasks) {
  Parser ps{b, e};
  if (!ps.expect('{')) return false;
  const char *kb, *ke;
  if (!ps.parse_string(&kb, &ke) || *kb != 'i') return false;
  if (!ps.expect(':')) return false;
  // "i": [ task, state ]
  if (!ps.expect('[')) return false;
  // task: [workload_key, target, ...]
  if (!ps.expect('[')) return false;
  const char *wb, *we, *tb, *te;
  if (!ps.parse_string(&wb, &we)) return false;
  if (!ps.expect(',')) return false;
  if (!ps.parse_string(&tb, &te)) return false;
  while (ps.expect(',')) {
    if (!ps.skip_value()) return false;
  }
  if (!ps.expect(']')) return false;

  // intern the task
  std::string task_key = unescape(wb, we);
  task_key.push_back('\x01');
  task_key += unescape(tb, te);
  int32_t task_id = -1;
  for (auto& kv : *tasks) {
    if (kv.first == task_key) { task_id = kv.second; break; }
  }
  if (task_id < 0) {
    task_id = static_cast<int32_t>(res->task_wkl_str.size());
    int32_t wid = intern(res, wb, we, strings);
    int32_t tid = intern(res, tb, te, strings);
    res->task_wkl_str.push_back(wid);
    res->task_target_str.push_back(tid);
    tasks->emplace_back(task_key, task_id);
  }

  if (!ps.expect(',')) return false;
  // state: [[], [steps...]]
  if (!ps.expect('[')) return false;
  if (!ps.expect('[')) return false;
  if (!ps.expect(']')) return false;
  if (!ps.expect(',')) return false;
  if (!ps.expect('[')) return false;
  int64_t step_begin = static_cast<int64_t>(res->step_tokens.size());
  if (!ps.peek(']')) {
    do {
      if (!parse_step(&ps, res, strings)) return false;
    } while (ps.expect(','));
  }
  if (!ps.expect(']')) return false;  // end steps
  if (!ps.expect(']')) return false;  // end state
  if (!ps.expect(']')) return false;  // end "i"
  if (!ps.expect(',')) return false;

  // "r": [[costs...], error_no, all_cost, ts]
  if (!ps.parse_string(&kb, &ke) || *kb != 'r') return false;
  if (!ps.expect(':')) return false;
  if (!ps.expect('[')) return false;
  if (!ps.expect('[')) return false;
  double sum = 0.0, first = 0.0;
  int n_costs = 0;
  if (!ps.peek(']')) {
    do {
      double d;
      if (!ps.parse_double(&d)) return false;
      if (n_costs == 0) first = d;
      sum += d;
      ++n_costs;
    } while (ps.expect(','));
  }
  if (!ps.expect(']')) return false;
  if (!ps.expect(',')) return false;
  double error_no, all_cost;
  if (!ps.parse_double(&error_no)) return false;
  if (!ps.expect(',')) return false;
  if (!ps.parse_double(&all_cost)) return false;
  // rest of the object is ignored

  res->rec_step_begin.push_back(step_begin);
  res->rec_step_end.push_back(static_cast<int64_t>(res->step_tokens.size()));
  res->rec_task_id.push_back(task_id);
  res->rec_mean_cost.push_back(n_costs ? sum / n_costs : 0.0);
  res->rec_first_cost.push_back(first);
  res->rec_error_no.push_back(static_cast<int32_t>(error_no));
  return true;
}

}  // namespace

extern "C" {

// Opaque handle API for ctypes.
void* ves_parse_file(const char* path, int64_t max_lines) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  if (st.st_size == 0) {  // empty log = zero records (serde parity)
    close(fd);
    return new ParseResult();
  }
  const char* data = static_cast<const char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return nullptr;

  auto* res = new ParseResult();
  std::vector<std::pair<std::string, int32_t>> strings, tasks;
  const char* p = data;
  const char* end = data + st.st_size;
  int64_t n = 0;
  while (p < end && (max_lines < 0 || n < max_lines)) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // skip comments/blank lines (leading '#' or whitespace-only)
    const char* q = p;
    while (q < line_end && (*q == ' ' || *q == '\t')) ++q;
    if (q < line_end && *q == '{') {
      if (parse_line(q, line_end, res, &strings, &tasks)) {
        ++n;
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  munmap(const_cast<char*>(data), st.st_size);
  return res;
}

int64_t ves_num_records(void* h) {
  return static_cast<ParseResult*>(h)->rec_task_id.size();
}
int64_t ves_num_tasks(void* h) {
  return static_cast<ParseResult*>(h)->task_wkl_str.size();
}
int64_t ves_num_step_tokens(void* h) {
  return static_cast<ParseResult*>(h)->step_tokens.size();
}
const int32_t* ves_step_tokens(void* h) {
  return static_cast<ParseResult*>(h)->step_tokens.data();
}
const int64_t* ves_rec_step_begin(void* h) {
  return static_cast<ParseResult*>(h)->rec_step_begin.data();
}
const int64_t* ves_rec_step_end(void* h) {
  return static_cast<ParseResult*>(h)->rec_step_end.data();
}
const int32_t* ves_rec_task_id(void* h) {
  return static_cast<ParseResult*>(h)->rec_task_id.data();
}
const double* ves_rec_mean_cost(void* h) {
  return static_cast<ParseResult*>(h)->rec_mean_cost.data();
}
const double* ves_rec_first_cost(void* h) {
  return static_cast<ParseResult*>(h)->rec_first_cost.data();
}
const int32_t* ves_rec_error_no(void* h) {
  return static_cast<ParseResult*>(h)->rec_error_no.data();
}
const char* ves_string_pool(void* h) {
  return static_cast<ParseResult*>(h)->string_pool.data();
}
int64_t ves_string_pool_size(void* h) {
  return static_cast<ParseResult*>(h)->string_pool.size();
}
const int64_t* ves_string_offsets(void* h) {
  return static_cast<ParseResult*>(h)->string_offsets.data();
}
int64_t ves_num_strings(void* h) {
  return static_cast<ParseResult*>(h)->string_offsets.size();
}
const int32_t* ves_task_wkl_str(void* h) {
  return static_cast<ParseResult*>(h)->task_wkl_str.data();
}
const int32_t* ves_task_target_str(void* h) {
  return static_cast<ParseResult*>(h)->task_target_str.data();
}
void ves_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
