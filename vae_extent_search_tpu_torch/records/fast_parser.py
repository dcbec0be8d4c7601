"""ctypes binding of the port's host library: the native NDJSON record
parser, the extent and per-store featurisers and the analytic runner's
batch replay (counterpart of ``vae_extent_search_tpu/records/
fast_parser.py``).

The sources are ``csrc/host/`` (copies of the JAX package's ``csrc/``),
built by ``g++`` at first use into the port's ``build/``
(``ops/build.py::HostLibrary``). The record parser mmaps a record log and
emits flat arrays: an int32 step-token stream, per-record offsets and
costs, and an interned string pool, the counterpart of the reference's
C++ RecordReader hot loop (measure_record.cc:328-371).
``load_records_fast`` rebuilds the records ``serde.load_records`` gives
from them; ``load_raw`` returns the flat arrays for the batch featurisers.

A library that does not build or load raises. The Python paths are taken
only per record, where the native side reports a record it cannot handle
(status 1: an rfactor step; a task whose descriptors cannot be built;
symbolic extents in the analytic batch); ``FALLBACKS`` counts them by
entry point and reason.
"""

from __future__ import annotations

import collections
import ctypes
import gzip
import os
import shutil
import tempfile
from typing import List, Optional

import numpy as np

from ..ops.build import HostLibrary

_STEP_KINDS = ["AN", "FU", "PR", "RE", "SP", "FSP", "FFSP", "SA", "CA",
               "CI", "CR", "CHR", "CHW", "RF"]

# records (or whole tasks, "<entry>:no_desc") handed to the Python paths,
# by "<entry point>:<reason>"; callers set it to zero and read it
FALLBACKS: collections.Counter = collections.Counter()

_P = ctypes.POINTER
_I32, _I64, _F32, _F64 = (ctypes.c_int32, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_double)
_BATCH_HEAD = [_P(_I32), _P(_I32), _P(_I32), _P(_I64), _P(_I64), _I64,
               _P(ctypes.c_char), _P(_I64)]


def _declare(lib):
    """argtypes and restypes of every C function the bindings call."""
    lib.ves_parse_file.restype = ctypes.c_void_p
    lib.ves_parse_file.argtypes = [ctypes.c_char_p, _I64]
    getters = [
        # record parser
        ("ves_num_records", _I64), ("ves_num_tasks", _I64),
        ("ves_num_step_tokens", _I64), ("ves_string_pool_size", _I64),
        ("ves_num_strings", _I64),
        ("ves_step_tokens", _P(_I32)), ("ves_rec_task_id", _P(_I32)),
        ("ves_rec_error_no", _P(_I32)), ("ves_task_wkl_str", _P(_I32)),
        ("ves_task_target_str", _P(_I32)), ("ves_rec_step_begin", _P(_I64)),
        ("ves_rec_step_end", _P(_I64)), ("ves_string_offsets", _P(_I64)),
        ("ves_rec_mean_cost", _P(_F64)), ("ves_rec_first_cost", _P(_F64)),
        ("ves_string_pool", _P(ctypes.c_char)),
        # per-store featuriser
        ("ves_ps_features", _P(_F32)), ("ves_ps_num_rows", _I64),
        ("ves_ps_offsets", _P(_I64)), ("ves_ps_status", _P(_I32)),
        ("ves_ps_keys", _P(ctypes.c_uint64)),
        # analytic batch
        ("ves_an_status", _P(_I32)), ("ves_an_text", _P(ctypes.c_char)),
        ("ves_an_text_offs", _P(_I64)), ("ves_an_stage_offs", _P(_I64)),
        ("ves_an_stage_rows", _P(_I64)), ("ves_an_iter_offs", _P(_I64)),
        ("ves_an_iter_rows", _P(_I64)),
    ]
    # extent featuriser (the full-expression entry point, v2)
    getters += [("ves_fx2_extents", _P(_F32)), ("ves_fx2_num_extents", _I64),
                ("ves_fx2_offsets", _P(_I64)), ("ves_fx2_status", _P(_I32))]
    for name, restype in getters:
        getattr(lib, name).restype = restype
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("ves_free", "ves_fx2_free", "ves_ps_free", "ves_an_free"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("ves_featurize_extents2", "ves_featurize_perstore",
                 "ves_analytic_batch"):
        getattr(lib, name).restype = ctypes.c_void_p
    # _BATCH_HEAD: (task desc (nullable: the native side derives the op
    # table from the expression desc), expr desc, step tokens, rec begin,
    # rec end, n recs, string pool, string offsets); then n threads
    lib.ves_featurize_extents2.argtypes = _BATCH_HEAD + [ctypes.c_int]
    # ..., is_gpu, cache line size, n threads, mode (0 full, 1 keys and
    # validity only)
    lib.ves_featurize_perstore.argtypes = _BATCH_HEAD + [ctypes.c_int] * 4
    # ..., names pool, names offsets, names counts (n_sp, n_rd per op),
    # n ops, n threads
    lib.ves_analytic_batch.argtypes = _BATCH_HEAD + [
        _P(ctypes.c_char), _P(_I64), _P(_I32), _I64, ctypes.c_int]


LIB = HostLibrary(_declare)


def count_fallback(key: str, n: int = 1) -> None:
    """Add ``n`` to ``FALLBACKS[key]`` (no entry for 0)."""
    if n:
        FALLBACKS[key] += int(n)


def _lib():
    """The loaded host library (built by g++ at first use; raises with the
    compiler's output when the build fails)."""
    return LIB.load()


def _ptr(a, ctype):
    return a.ctypes.data_as(_P(ctype))


class RawRecords:
    """Flat parsed arrays (copies owned by numpy; native handle freed)."""

    def __init__(self, handle, lib):
        n = lib.ves_num_records(handle)
        nt = lib.ves_num_step_tokens(handle)
        ns = lib.ves_num_strings(handle)
        ntask = lib.ves_num_tasks(handle)

        def arr(ptr, count, dtype):
            # an empty std::vector's data() may be NULL — as_array on a
            # NULL pointer raises even for a zero-length view
            if count == 0 or not ptr:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(ptr, (count,)).copy()

        self.step_tokens = arr(lib.ves_step_tokens(handle), nt, np.int32)
        self.step_begin = arr(lib.ves_rec_step_begin(handle), n, np.int64)
        self.step_end = arr(lib.ves_rec_step_end(handle), n, np.int64)
        self.task_id = arr(lib.ves_rec_task_id(handle), n, np.int32)
        self.mean_cost = arr(lib.ves_rec_mean_cost(handle), n, np.float64)
        self.first_cost = arr(lib.ves_rec_first_cost(handle), n,
                              np.float64)
        self.error_no = arr(lib.ves_rec_error_no(handle), n, np.int32)
        psize = lib.ves_string_pool_size(handle)
        pool = (ctypes.string_at(lib.ves_string_pool(handle), psize)
                if psize else b"")
        offs = arr(lib.ves_string_offsets(handle), ns, np.int64)
        self.strings = []
        for i in range(ns):
            end = offs[i + 1] - 1 if i + 1 < ns else len(pool) - 1
            self.strings.append(pool[offs[i]:end].decode())
        self.task_workload = [
            self.strings[i]
            for i in arr(lib.ves_task_wkl_str(handle), ntask, np.int32)
        ]
        self.task_target = [
            self.strings[i]
            for i in arr(lib.ves_task_target_str(handle), ntask, np.int32)
        ]

    def __len__(self):
        return len(self.task_id)

    def decode_steps(self, rec_idx: int) -> List[list]:
        """Step records (same structure as json) for one record."""
        toks = self.step_tokens
        i = int(self.step_begin[rec_idx])
        end = int(self.step_end[rec_idx])
        out = []
        while i < end:
            kind = _STEP_KINDS[toks[i]]
            n = int(toks[i + 1])
            i += 2
            args = []
            j = i
            while j < i + n:
                v = int(toks[j])
                if v <= -1000000:
                    args.append(self.strings[-1000000 - v])
                    j += 1
                elif v < 0:  # list marker -(len+1)
                    ln = -v - 1
                    # -1 inside a list = JSON null (undefined split
                    # length); legitimate step-list values are all >= 0
                    args.append([None if x == -1 else int(x)
                                 for x in toks[j + 1:j + 1 + ln]])
                    j += 1 + ln
                else:
                    args.append(v)
                    j += 1
            i += n
            out.append([kind] + args)
        return out


# detection-scan read size for _repair_glued_lines (patchable in tests
# to exercise chunk-boundary overlap handling)
_REPAIR_SCAN_CHUNK = 16 << 20


def _repair_glued_lines(path: str) -> str:
    """Kill-corrupted append logs can hold several records per line (a
    truncated write with the next append glued on). The native parser
    is one-record-per-line, so repair such files into a temp copy:
    newline before every mid-line record opener. The opener byte string
    '{"i": ' cannot occur inside a record (it would be escaped there),
    so the split is exact; truncated fragments end up on their own
    lines, which the strict parser skips — every intact record
    survives, matching serde.iter_records' recovery. Returns ``path``
    unchanged for healthy files after a CHUNKED detection scan (multi-GB
    corpora must not be slurped into RSS on the common healthy path)."""
    opener = b'{"i": '
    dirty = False
    chunk_size = _REPAIR_SCAN_CHUNK
    with open(path, "rb") as f:
        prev_tail = b"\n"
        while not dirty:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            buf = prev_tail + chunk  # overlap catches split openers
            pos = buf.find(opener, 1)
            while pos != -1:
                if buf[pos - 1:pos] != b"\n":
                    dirty = True
                    break
                pos = buf.find(opener, pos + 1)
            prev_tail = buf[-(len(opener)):]
    if not dirty:
        return path
    with open(path, "rb") as f:
        data = f.read()
    out = []
    start = 0
    pos = data.find(opener, 1)
    while pos != -1:
        if data[pos - 1:pos] != b"\n":
            out.append(data[start:pos])
            out.append(b"\n")
            start = pos
        pos = data.find(opener, pos + 1)
    out.append(data[start:])
    tmp = tempfile.NamedTemporaryFile(
        suffix=".json", prefix="ves_repair_", delete=False)
    tmp.write(b"".join(out))
    tmp.close()
    return tmp.name


def _plain_copy(path: str) -> str:
    """A gzip-compressed log (``*.gz``, which ``serde.load_records`` also
    reads) decompressed into a temporary file for the mmap parser;
    ``path`` itself otherwise."""
    if not str(path).endswith(".gz"):
        return path
    fd, tmp = tempfile.mkstemp(suffix=".json", prefix="ves_gunzip_")
    with os.fdopen(fd, "wb") as out, gzip.open(path, "rb") as src:
        shutil.copyfileobj(src, out)
    return tmp


def load_raw(path: str, max_lines: int = -1) -> RawRecords:
    lib = _lib()
    plain = _plain_copy(str(path))
    try:
        repaired = _repair_glued_lines(plain)
        try:
            handle = lib.ves_parse_file(repaired.encode(), max_lines)
        finally:
            if repaired != plain:
                os.unlink(repaired)
    finally:
        if plain != str(path):
            os.unlink(plain)
    if not handle:
        raise IOError(f"native parse failed for {path}")
    try:
        return RawRecords(handle, lib)
    finally:
        lib.ves_free(handle)


def load_records_fast(path: str, max_lines: Optional[int] = None):
    """MeasureRecord list via the native parser (serde-compatible: the
    same tasks, step records, mean cost and error code per record)."""
    from .serde import MeasureInput, MeasureRecord, MeasureResult
    from .task import SearchTask

    raw = load_raw(path, -1 if max_lines is None else max_lines)
    tasks = [
        SearchTask(wk, tgt)
        for wk, tgt in zip(raw.task_workload, raw.task_target)
    ]
    out = []
    for i in range(len(raw)):
        steps = raw.decode_steps(i)
        res = MeasureResult([float(raw.mean_cost[i])],
                            int(raw.error_no[i]), 0.0, 0.0)
        out.append(MeasureRecord(
            MeasureInput(tasks[raw.task_id[i]], steps), res
        ))
    return out


def _string_pool_arrays(strings):
    pool = b"\x00".join(s.encode() for s in strings) + b"\x00"
    offs = np.zeros(max(len(strings), 1), np.int64)
    o = 0
    for k, s in enumerate(strings):
        offs[k] = o
        o += len(s.encode()) + 1
    return pool, offs


def _copy(ptr, count, dtype, at_least: int = 0):
    """``count`` items at ``ptr`` as an owned numpy array (reading
    ``max(count, at_least)``: the C side sizes some arrays at least 1)."""
    if count == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, (max(count, at_least),))[:count].copy()


class _TaskDescCache:
    """Per-task descriptors (the affine one, None for a non-affine DAG,
    and the full-expression one), cached for repeated GA generations."""

    _cache = {}

    @classmethod
    def get(cls, task):
        key = (task.workload_key, task.target)
        hit = cls._cache.get(key)
        if hit is not None:
            return hit
        from .expr_desc import build_expr_desc
        from .task_desc import NonAffineError, build_task_desc
        from .workload import workload_key_to_dag

        dag = workload_key_to_dag(task.workload_key)
        edesc = np.ascontiguousarray(build_expr_desc(dag))
        try:
            desc = build_task_desc(dag)
        except NonAffineError:
            desc = None
        cls._cache[key] = (desc, edesc)
        return cls._cache[key]


def _descriptors(task, entry: str, n: int):
    """(affine descriptor pointer or None, expression descriptor) of the
    task, or None when its DAG cannot be encoded: its ``n`` records then
    take the Python path, counted under ``<entry>:no_desc``."""
    try:
        desc, edesc = _TaskDescCache.get(task)
    except Exception:
        count_fallback(f"{entry}:no_desc", n)
        return None
    return (_ptr(desc, _I32) if desc is not None else None), edesc


# ---------------------------------------------------------------------------
# Native batch extent featurization (csrc/host/extent_featurizer.cpp)
# ---------------------------------------------------------------------------


def featurize_extents_native(path: str, n_threads: int = 1):
    """Batch extent featurization through the native pipeline.

    Returns (extent vectors: list of float32 arrays, labels [n] float32,
    statuses [n] int32: 0 featurised, 2 error/skipped). Records the native
    side reports as status 1 take the Python path, counted in
    ``FALLBACKS["extents:status1"]``.
    Labels are -log(mean cost + 1e-8); error records and costs > 1e6 get
    status 2 (reference print_programs.py:23 filter). Records are grouped
    by task; non-affine DAGs run through the full-expression demand path
    (ves_featurize_extents2).
    """
    from ..features.extent import label_from_costs
    from .task import SearchTask

    lib = _lib()
    raw = load_raw(path, -1)
    n = len(raw)
    if n == 0:
        return [], np.zeros(0, np.float32), np.zeros(0, np.int32)

    vecs = [None] * n
    statuses = np.full(n, 2, np.int32)
    labels = np.zeros(n, np.float32)
    for i in range(n):
        if raw.error_no[i] == 0 and raw.first_cost[i] <= 1e6:
            labels[i] = label_from_costs([raw.mean_cost[i]])
            statuses[i] = 1  # provisional: python fallback

    pool, offs = _string_pool_arrays(raw.strings)
    step_tokens = np.ascontiguousarray(raw.step_tokens)
    tasks = [SearchTask(wk, tgt)
             for wk, tgt in zip(raw.task_workload, raw.task_target)]

    for tid, task in enumerate(tasks):
        idx = np.nonzero((raw.task_id == tid) & (statuses == 1))[0]
        if len(idx) == 0:
            continue
        descs = _descriptors(task, "extents", len(idx))
        if descs is None:
            continue  # python fallback for the whole task
        desc_ptr, edesc = descs
        begin = np.ascontiguousarray(raw.step_begin[idx])
        end = np.ascontiguousarray(raw.step_end[idx])
        fx = lib.ves_featurize_extents2(
            desc_ptr, _ptr(edesc, _I32), _ptr(step_tokens, _I32),
            _ptr(begin, _I64), _ptr(end, _I64), len(idx), pool,
            _ptr(offs, _I64), n_threads)
        try:
            ext = _copy(lib.ves_fx2_extents(fx), lib.ves_fx2_num_extents(fx),
                        np.float32)
            fx_offs = _copy(lib.ves_fx2_offsets(fx), len(idx) + 1, np.int64)
            fx_status = _copy(lib.ves_fx2_status(fx), len(idx), np.int32, 1)
        finally:
            lib.ves_fx2_free(fx)
        for k, rec in enumerate(idx):
            if fx_status[k] == 0:
                vecs[rec] = ext[fx_offs[k]:fx_offs[k + 1]]
                statuses[rec] = 0

    count_fallback("extents:status1", (statuses == 1).sum())
    from ..features.extent import extent_vector
    from .serde import MeasureInput

    for i in range(n):
        if statuses[i] != 1:
            continue
        try:
            inp = MeasureInput(tasks[raw.task_id[i]], raw.decode_steps(i))
            st = inp.recover_state(infer_bound=True)
            vecs[i] = extent_vector(st)
            statuses[i] = 0
        except Exception:
            statuses[i] = 2
    return vecs, labels, statuses


# ---------------------------------------------------------------------------
# Native batch per-store featurization (csrc/host/per_store_featurizer.cpp)
# ---------------------------------------------------------------------------


def _perstore_call(lib, task, tok_arr, begin, end, pool, offs,
                   n_threads, mode: int = 0, entry: str = "perstore"):
    """One native per-store batch call for a single task's records.

    Returns (rows [total,164], ps_offs [n+1], ps_status [n], keys [n]) or
    None when the task's descriptors cannot be built (its records take the
    Python path, counted under ``<entry>:no_desc``). ``mode=1`` skips
    store building and feature emission: keys and bound-inference validity
    only (rows come back empty), the GA pool path under a feature-free
    cost model."""
    from ..features.per_store import FEATURE_VEC_LEN

    n = len(begin)
    descs = _descriptors(task, entry, n)
    if descs is None:
        return None
    desc_ptr, edesc = descs
    h = lib.ves_featurize_perstore(
        desc_ptr, _ptr(edesc, _I32), _ptr(tok_arr, _I32), _ptr(begin, _I64),
        _ptr(end, _I64), n, pool, _ptr(offs, _I64), int(task.is_gpu),
        int(task.hardware_params.cache_line_bytes), n_threads, mode)
    try:
        total = lib.ves_ps_num_rows(h)
        rows = _copy(lib.ves_ps_features(h), total * FEATURE_VEC_LEN,
                     np.float32).reshape(-1, FEATURE_VEC_LEN)
        ps_offs = _copy(lib.ves_ps_offsets(h), n + 1, np.int64)
        ps_status = _copy(lib.ves_ps_status(h), n, np.int32, 1)
        keys = _copy(lib.ves_ps_keys(h), n, np.uint64, 1)
    finally:
        lib.ves_ps_free(h)
    return rows, ps_offs, ps_status, keys


def featurize_perstore_native(path: str, n_threads: int = 1,
                              max_lines: int = -1, raw=None):
    """Batch per-store (164-dim) featurization through the native pipeline.

    Returns (features: list of [n_stores_i, 164] float32 arrays, statuses
    [n] int32: 0 featurised, 2 error). Records the native side reports as
    status 1 take the Python path, counted in
    ``FALLBACKS["perstore_file:status1"]``.
    Records are grouped by task (a log may hold many tasks); tasks whose
    DAG has non-affine accesses are shipped via the full-expression
    descriptor, so winograd et al. still run natively.

    ``raw`` lets a caller that already parsed the file (RawRecords of
    the same path/max_lines) skip the second mmap+parse pass.
    """
    from ..features.per_store import get_per_store_features_from_state
    from .serde import MeasureInput
    from .task import SearchTask

    lib = _lib()
    if raw is None:
        raw = load_raw(path, max_lines)
    n = len(raw)
    feats = [None] * n
    statuses = np.full(n, 1, np.int32)
    if n == 0:
        return feats, statuses

    pool, offs = _string_pool_arrays(raw.strings)
    step_tokens = np.ascontiguousarray(raw.step_tokens)
    tasks = [SearchTask(wk, tgt)
             for wk, tgt in zip(raw.task_workload, raw.task_target)]

    for tid in range(len(tasks)):
        idx = np.nonzero(raw.task_id == tid)[0]
        if len(idx) == 0:
            continue
        res = _perstore_call(
            lib, tasks[tid], step_tokens,
            np.ascontiguousarray(raw.step_begin[idx]),
            np.ascontiguousarray(raw.step_end[idx]),
            pool, offs, n_threads, entry="perstore_file",
        )
        if res is None:
            continue  # python fallback for the whole task
        rows, ps_offs, ps_status, _ = res
        for k, rec in enumerate(idx):
            if ps_status[k] == 0:
                feats[rec] = rows[ps_offs[k]:ps_offs[k + 1]]
                statuses[rec] = 0
            else:
                statuses[rec] = ps_status[k]

    count_fallback("perstore_file:status1", (statuses == 1).sum())
    for i in range(n):
        if statuses[i] != 1:
            continue
        try:
            inp = MeasureInput(tasks[raw.task_id[i]], raw.decode_steps(i))
            st = inp.recover_state(infer_bound=True)
            feats[i] = get_per_store_features_from_state(st, inp.task)
            statuses[i] = 0
        except Exception:
            statuses[i] = 2
    return feats, statuses


def perstore_dataset_native(path: str, max_lines: int = -1,
                            n_threads: int = 1):
    """Native equivalent of per_store.get_per_store_features_from_file:
    (features, normalized_throughputs, task_ids, min_costs), with the same
    zero-row error convention and per-task min-cost normalization
    (``per_store.normalized_throughputs``), read from the parsed arrays
    without decoding the records in Python."""
    from ..features.per_store import FEATURE_VEC_LEN, normalized_throughputs

    raw = load_raw(path, max_lines)  # parsed once, shared with featurize
    feats, statuses = featurize_perstore_native(
        path, n_threads=n_threads, max_lines=max_lines, raw=raw)
    n = len(raw)
    out_feats = []
    for i in range(n):
        f = feats[i]
        if f is None or statuses[i] == 2 or f.shape[0] == 0:
            f = np.zeros((1, FEATURE_VEC_LEN), np.float32)
        out_feats.append(f)
    return (out_feats, *normalized_throughputs(
        [(raw.task_workload[t], raw.task_target[t]) for t in raw.task_id],
        raw.mean_cost, raw.error_no))


def _encode_steps(step_records, strings, string_index, out,
                  frag_cache=None):
    """Encode step records into the native token stream (the same format
    record_parser.cpp emits: [kind, n_tokens, args...]; lists as -(len+1)
    markers; strings as -1000000-id; None as -1).

    ``frag_cache``: optional dict for per-record token fragments, keyed
    by id(rec) with the record pinned in the value (GA children share
    all but the mutated step record with their parent by REFERENCE, so
    a persistent cache + persistent string pool turns re-encoding of a
    generation batch into list extends). Callers that pass it must keep
    ``strings``/``string_index`` alive alongside: fragments embed
    string-pool ids."""
    for rec in step_records:
        if frag_cache is not None:
            hit = frag_cache.get(id(rec))
            if hit is not None and hit[0] is rec:
                out.extend(hit[1])
                continue
            frag_start = len(out)
        kind = _STEP_KINDS.index(rec[0])
        toks = []
        for arg in rec[1:]:
            if isinstance(arg, bool):
                toks.append(int(arg))
            elif isinstance(arg, (int, np.integer)):
                toks.append(int(arg))
            elif arg is None:
                toks.append(-1)
            elif isinstance(arg, str):
                sid = string_index.get(arg)
                if sid is None:
                    sid = len(strings)
                    strings.append(arg)
                    string_index[arg] = sid
                toks.append(-1000000 - sid)
            elif isinstance(arg, (list, tuple)):
                toks.append(-(len(arg) + 1))
                toks.extend(-1 if x is None else int(x) for x in arg)
            else:
                raise TypeError(f"cannot encode step arg {arg!r}")
        out.append(kind)
        out.append(len(toks))
        out.extend(toks)
        if frag_cache is not None:
            frag_cache[id(rec)] = (rec, out[frag_start:])


def _encode_batch(record_lists, encode_ctx=None):
    """(token array, begin [n], end [n], string pool, string offsets) of
    step-record lists; ``encode_ctx`` as for
    ``featurize_perstore_records_native``."""
    n = len(record_lists)
    toks: List[int] = []
    begin = np.zeros(n, np.int64)
    end = np.zeros(n, np.int64)
    if encode_ctx is None:
        strings, string_index, frag_cache = [], {}, None
    else:
        strings, string_index, frag_cache = encode_ctx
    for i, recs in enumerate(record_lists):
        begin[i] = len(toks)
        _encode_steps(recs, strings, string_index, toks, frag_cache)
        end[i] = len(toks)
    tok_arr = np.asarray(toks if toks else [0], np.int32)
    pool, offs = _string_pool_arrays(strings)
    return tok_arr, begin, end, pool, offs


def featurize_perstore_states_native(task, states, n_threads: int = 1):
    """Per-store features for in-memory states through the native
    featurizer: the search-time hot loop of the learned cost model
    (reference feature.cc GetPerStoreFeaturesFromStates, called per
    evolutionary-search round). Returns a list of [n_stores_i, 164]
    arrays; states the native path cannot handle (rfactor) take the
    Python path; unlowerable states yield a single all-zero row."""
    from ..features.per_store import (
        FEATURE_VEC_LEN,
        get_per_store_features_from_state,
    )

    lib = _lib()
    n = len(states)
    if n == 0:
        return []
    feats = [None] * n
    statuses = np.full(n, 1, np.int32)
    res = _perstore_call(
        lib, task, *_encode_batch(
            [[s.to_record() for s in st.transform_steps] for st in states]),
        n_threads, entry="perstore_states")
    if res is not None:
        rows, ps_offs, ps_status, _ = res
        for i in range(n):
            if ps_status[i] == 0 and ps_offs[i + 1] > ps_offs[i]:
                feats[i] = rows[ps_offs[i]:ps_offs[i + 1]]
                statuses[i] = 0
            else:
                statuses[i] = max(int(ps_status[i]), 1)

    count_fallback("perstore_states:status1", (statuses == 1).sum())
    for i in range(n):
        if statuses[i] == 0:
            continue
        if statuses[i] == 1:
            try:
                st = task.compute_dag.infer_bound(states[i])
                f = get_per_store_features_from_state(st, task)
                feats[i] = f if f.shape[0] else np.zeros(
                    (1, FEATURE_VEC_LEN), np.float32)
                statuses[i] = 0
                continue
            except Exception:
                pass
        feats[i] = np.zeros((1, FEATURE_VEC_LEN), np.float32)
    return feats


def featurize_perstore_inputs_native(inputs, n_threads: int = 1):
    """Per-store features for in-memory MeasureInputs (cost-model update
    path). Returns a list parallel to ``inputs``; entries are None where
    the native path could not handle the record (the caller runs the
    Python featuriser on those, counted here)."""
    lib = _lib()
    n = len(inputs)
    feats = [None] * n

    groups = {}
    for i, inp in enumerate(inputs):
        groups.setdefault(
            (inp.task.workload_key, inp.task.target), []
        ).append(i)

    for idx in groups.values():
        res = _perstore_call(
            lib, inputs[idx[0]].task,
            *_encode_batch([inputs[i].step_records for i in idx]),
            n_threads, entry="perstore_inputs")
        if res is None:
            continue
        rows, ps_offs, ps_status, _ = res
        for k, i in enumerate(idx):
            if ps_status[k] == 0 and ps_offs[k + 1] > ps_offs[k]:
                feats[i] = rows[ps_offs[k]:ps_offs[k + 1]]
            else:
                count_fallback(f"perstore_inputs:status{int(ps_status[k])}")
    return feats


def featurize_perstore_records_native(task, record_lists,
                                      n_threads: int = 1,
                                      encode_ctx=None,
                                      with_features: bool = True):
    """Per-store features + structural dedup keys for step-record lists
    (the native evolutionary-search generation batch). Returns
    (features list, keys uint64 [n], statuses int32 [n]); entries with
    status != 0 have features None and key 0: the caller decides whether
    to take the Python path (rfactor) or discard (invalid child).

    ``encode_ctx``: optional ``make_encode_ctx()`` value shared across
    calls of one GA run: children reuse their parent's step-record
    objects, so per-record token fragments cache across generations.

    ``with_features=False`` skips store building + feature emission in
    the native pass (keys + replay/bound validity only, features all
    None): pool generation under a feature-free cost model, where
    emit+stores are ~half the native per-record cost."""
    lib = _lib()
    n = len(record_lists)
    feats = [None] * n
    keys = np.zeros(n, np.uint64)
    statuses = np.full(n, 2, np.int32)
    if n == 0:
        return feats, keys, statuses

    res = _perstore_call(lib, task,
                         *_encode_batch(record_lists, encode_ctx),
                         n_threads, mode=0 if with_features else 1,
                         entry="perstore_records")
    if res is None:
        return feats, keys, statuses
    rows, ps_offs, ps_status, ps_keys = res
    for i in range(n):
        statuses[i] = ps_status[i]
        keys[i] = ps_keys[i]
        if not with_features:
            continue
        if ps_status[i] == 0 and ps_offs[i + 1] > ps_offs[i]:
            feats[i] = rows[ps_offs[i]:ps_offs[i + 1]]
        elif ps_status[i] == 0:
            statuses[i] = 2  # replayed but produced no stores
    return feats, keys, statuses


def make_encode_ctx():
    """Shared encoding context for featurize_perstore_records_native:
    (string pool, string index, per-record fragment cache). One per GA
    run: the string pool must stay alive as long as fragments do."""
    return ([], {}, {})


# ---------------------------------------------------------------------------
# Native batch for the analytic runner (csrc/host/ves_replay.h)
# ---------------------------------------------------------------------------


_AN_NAMES_CACHE: dict = {}


def _analytic_names(task):
    """(names pool bytes, offsets, counts int32 [n_ops*2]) for the
    native name-tracking replay, or None when the task has symbolic
    (data-dependent) extents: those print PrimExpr text the native
    printer does not reproduce (sparse workloads; python path)."""
    key = (task.workload_key, str(task.target))
    if key in _AN_NAMES_CACHE:
        return _AN_NAMES_CACHE[key]
    from .workload import workload_key_to_dag

    dag = workload_key_to_dag(task.workload_key)
    names: List[str] = []
    counts: List[int] = []
    for op in dag.ops:
        names.append(op.name)
        axes = getattr(op, "axes", ()) or ()
        red = getattr(op, "reduce_axes", ()) or ()
        for d in list(axes) + list(red):
            if not isinstance(d.extent, (int, np.integer)):
                _AN_NAMES_CACHE[key] = None
                return None
            names.append(d.name)
        counts.extend([len(axes), len(red)])
    pool, offs = _string_pool_arrays(names)
    out = (pool, offs, np.asarray(counts, np.int32), len(dag.ops))
    _AN_NAMES_CACHE[key] = out
    return out


def analytic_batch_native(task, record_lists, n_threads: int = 1):
    """Native batch for the analytic measurer: replay + bound inference
    with name tracking, returning per record the BYTE-EXACT printed
    state (State.to_str parity: the AnalyticRunner noise key) and a
    compact schedule summary (stage rows [S,3]: compute_at/-1
    placeholder/2 inlined, auto_unroll, n_iters; iter rows [I,2]:
    extent, annotation).

    Returns (statuses int32 [n], texts List[bytes], stage_rows
    List[int64 [S,3]], iter_rows List[int64 [I,2]]), or None when the
    task has symbolic extents or no descriptors (its records take the
    State path, counted under ``analytic:symbolic`` / ``analytic:no_desc``).
    Entries with status != 0 need the State path too (``AnalyticRunner.
    run_record_lists`` counts those under ``analytic:state_path``)."""
    lib = _lib()
    n = len(record_lists)
    nm = _analytic_names(task)
    if nm is None:
        count_fallback("analytic:symbolic", n)
        return None
    descs = _descriptors(task, "analytic", n)
    if descs is None:
        return None
    desc_ptr, edesc = descs
    names_pool, names_offs, names_counts, n_ops = nm
    if n == 0:
        return (np.zeros(0, np.int32), [], [], [])
    tok_arr, begin, end, pool, offs = _encode_batch(record_lists)
    h = lib.ves_analytic_batch(
        desc_ptr, _ptr(edesc, _I32), _ptr(tok_arr, _I32), _ptr(begin, _I64),
        _ptr(end, _I64), n, pool, _ptr(offs, _I64), names_pool,
        _ptr(names_offs, _I64), _ptr(names_counts, _I32), n_ops, n_threads)
    try:
        statuses = _copy(lib.ves_an_status(h), n, np.int32, 1)
        t_offs = _copy(lib.ves_an_text_offs(h), n + 1, np.int64)
        total_text = int(t_offs[-1])
        blob = (ctypes.string_at(lib.ves_an_text(h), total_text)
                if total_text else b"")
        s_offs = _copy(lib.ves_an_stage_offs(h), n + 1, np.int64)
        i_offs = _copy(lib.ves_an_iter_offs(h), n + 1, np.int64)
        st_rows = _copy(lib.ves_an_stage_rows(h), int(s_offs[-1]) * 3,
                        np.int64, 3).reshape(-1, 3)
        it_rows = _copy(lib.ves_an_iter_rows(h), int(i_offs[-1]) * 2,
                        np.int64, 2).reshape(-1, 2)
    finally:
        lib.ves_an_free(h)

    texts = [blob[t_offs[i]:t_offs[i + 1]] for i in range(n)]
    stage_rows = [st_rows[s_offs[i]:s_offs[i + 1]] for i in range(n)]
    iter_rows = [it_rows[i_offs[i]:i_offs[i + 1]] for i in range(n)]
    return statuses, texts, stage_rows, iter_rows
