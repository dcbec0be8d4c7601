"""The port's host library (``records/fast_parser.py`` over ``csrc/host/``,
built by g++ into the port's ``build/``) against the JAX package: the
build itself, the native record parser on every committed record log, and
the task and expression descriptors the featurisers read, element for
element. The featurisers: tests/test_torch_native_features.py; the GA, the
analytic runner and the command lines: tests/test_torch_native_search.py.
"""

import glob
import gzip
import os
import shutil

import numpy as np
import pytest

from _torch_parity import jax_native_lib
from vae_extent_search_tpu.records import expr_desc as jexpr
from vae_extent_search_tpu.records import fast_parser as jfp
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records import task_desc as jtdesc
from vae_extent_search_tpu.records import workload as jwl
from vae_extent_search_tpu_torch.ops import build as tbuild
from vae_extent_search_tpu_torch.records import expr_desc as texpr
from vae_extent_search_tpu_torch.records import fast_parser as tfp
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records import task_desc as ttdesc
from vae_extent_search_tpu_torch.records import workload as twl
from vae_extent_search_tpu_torch.records.task import SearchTask as TTask
from vae_extent_search_tpu_torch.search.sketch import generate_sketches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN_LOGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "result", "**", "*.json"), recursive=True)
    if "results" not in os.path.basename(p))
GZ_LOGS = ["result/conv2d_4k_chip/pool_conv2d_4k.json.gz",
           "result/conv2d_4k_hf/pool_conv2d_4k_hf.json.gz"]
RESNET18 = os.path.join(ROOT, "result", "corpus", "resnet_18-B1-llvm.json")

# the workload families of the JAX package's tests/test_native.py
FAMILIES = [
    ("max_pool2d_auto_scheduler_test", (1, 14, 14, 64, 1)),
    ("min_nm_auto_scheduler_test", (32, 512)),
    ("softmax_abcd_auto_scheduler_test", (1, 4, 64, 64)),
    ("depthwise_conv2d_layer", (1, 14, 14, 96, 3, 3, [1, 1], [1, 1])),
    ("batch_matmul", (4, 64, 64, 32)),
    ("group_conv2d_layer", (1, 14, 14, 64, 64, 3, 3, 1, 1, 8)),
    ("conv2d_transpose_layer", (1, 8, 8, 64, 128, 4, 4, 2, 1)),
    ("avg_pool2d_layer", (1, 14, 14, 64, 7, 1, 0)),
    ("max_pool2d_layer", (1, 112, 112, 64, 3, 2, 1)),
    ("conv2d_layer", (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1])),
    ("conv3d_layer", (1, 4, 14, 14, 32, 32, 3, 3, 3, [1, 1, 1], [1, 1, 1])),
    ("softmax_nm_auto_scheduler_test", (4, 2048)),
    ("matmul_auto_scheduler_test", (64, 64, 64)),
]


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.inp.step_records == b.inp.step_records
        assert a.inp.task.workload_key == b.inp.task.workload_key
        assert a.inp.task.target == b.inp.task.target
        assert a.res.error_no == b.res.error_no
        assert a.res.mean_cost == pytest.approx(b.res.mean_cost, rel=1e-12,
                                                abs=1e-300)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_host_library_built_into_the_ports_build_directory():
    """The library is the port's own, keyed by its sources, flags and host
    CPU, in ``vae_extent_search_tpu_torch/build/``; a second build call
    finds it and compiles nothing."""
    path = tfp.LIB.library
    assert path.parent == tbuild.BUILD_DIR
    assert path.name.startswith("libves_host-") and path.suffix == ".so"
    lib = tfp.LIB.load()
    assert lib.ves_parse_file is not None and path.exists()
    assert tfp.LIB.build() == (path, "", 0.0)
    assert tbuild.GXX_FLAGS == ["-O3", "-march=native", "-shared", "-fPIC",
                                "-std=c++17"]
    assert sorted(p.name for p in tbuild.HOST_SRC.iterdir()) == sorted(
        ["record_parser.cpp", "extent_featurizer.cpp",
         "per_store_featurizer.cpp", "per_store_featurizer_part2.inc",
         "ves_replay.h"])
    for name in ("record_parser.cpp", "extent_featurizer.cpp",
                 "per_store_featurizer.cpp", "per_store_featurizer_part2.inc",
                 "ves_replay.h"):
        with open(os.path.join(ROOT, "csrc", name), "rb") as f:
            assert (tbuild.HOST_SRC / name).read_bytes() == f.read(), name


def test_host_library_key_follows_sources_and_cpu(monkeypatch, tmp_path):
    """Another CPU or another source gives another library name."""
    name = tfp.LIB.library.name
    monkeypatch.setattr(tbuild, "host_cpu", lambda: "another cpu")
    assert tfp.LIB.library.name != name
    monkeypatch.undo()
    src = tmp_path / "host"
    shutil.copytree(tbuild.HOST_SRC, src)
    (src / "ves_replay.h").write_text((src / "ves_replay.h").read_text()
                                      + "\n// edited\n")
    monkeypatch.setattr(tbuild, "HOST_SRC", src)
    assert tfp.LIB.library.name != name


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A source g++ refuses raises, naming the compiler's message; nothing
    falls back to Python and no library is left behind."""
    src = tmp_path / "host"
    shutil.copytree(tbuild.HOST_SRC, src)
    (src / "record_parser.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(tbuild, "HOST_SRC", src)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    lib = tbuild.HostLibrary(lambda lib: None)
    with pytest.raises(RuntimeError, match="g[+][+] failed") as err:
        lib.load()
    assert "record_parser.cpp" in str(err.value)
    assert [p.name for p in (tmp_path / "build").iterdir()] == \
        ["libves_host.buildlock"]


# ---------------------------------------------------------------------------
# the record parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log", PLAIN_LOGS)
def test_parser_matches_serde_on_committed_logs(log):
    """Every committed record log: the native parser gives the records of
    the port's serde and of the JAX package's, and the JAX native
    parser's where that loads."""
    path = os.path.join(ROOT, log)
    got = tfp.load_records_fast(path)
    _same_records(got, tserde.load_records(path))
    _same_records(got, jserde.load_records(path))
    if jax_native_lib():
        _same_records(got, jfp.load_records_fast(path))


@pytest.mark.parametrize("log", GZ_LOGS)
def test_parser_reads_gzip_logs_and_their_copies(log, tmp_path):
    """A gzip-compressed log parses as its decompressed copy does (the JAX
    parser reads the copy only)."""
    path = os.path.join(ROOT, log)
    plain = tmp_path / "copy.json"
    with gzip.open(path, "rb") as src, open(plain, "wb") as out:
        shutil.copyfileobj(src, out)
    got = tfp.load_records_fast(path)
    _same_records(got, tserde.load_records(path))
    _same_records(tfp.load_records_fast(str(plain)), got)
    if jax_native_lib():
        _same_records(got, jfp.load_records_fast(str(plain)))
    assert len(got) == 4000


@pytest.mark.parametrize("chunk", [7, 13, 1 << 20])
def test_glued_lines_repaired(tmp_path, monkeypatch, chunk):
    """A kill-corrupted append log (a truncated record with the next one
    glued on, and a record glued to its predecessor) keeps every intact
    record, as serde's recovery does, whatever the scan's chunk size."""
    src = tserde.load_records(RESNET18, max_lines=4)
    lines = [tserde.record_to_json(r) for r in src]
    p = tmp_path / "glued.json"
    p.write_text(lines[0] + "\n" + lines[1][:40] + lines[2] + lines[3]
                 + "\n")
    monkeypatch.setattr(tfp, "_REPAIR_SCAN_CHUNK", chunk)
    got = tfp.load_records_fast(str(p))
    want = tserde.load_records(str(p))
    _same_records(got, want)
    assert len(got) == 3
    if jax_native_lib():
        _same_records(got, jfp.load_records_fast(str(p)))
    healthy = tmp_path / "healthy.json"
    healthy.write_text("\n".join(lines) + "\n")
    assert tfp._repair_glued_lines(str(healthy)) == str(healthy)


def test_null_split_lengths_and_empty_log(tmp_path):
    """Sketch-stage SP records with JSON null lengths parse with serde's
    structure; an empty log gives no records."""
    task = TTask(twl.make_workload_key(
        "conv2d_layer", (1, 14, 14, 32, 32, 3, 3, [1, 1], [1, 1])),
        "llvm -mcpu=skylake-avx512")
    rec = next(recs for recs in (
        [st.to_record() for st in s.transform_steps]
        for s in generate_sketches(task, seed=0))
        if any(r[0] == "SP" and None in r[4] for r in recs))
    p = str(tmp_path / "nullrec.json")
    tserde.save_records(p, [tserde.make_record(task, rec, costs=[0.1],
                                                timestamp=0)], mode="w")
    got = tfp.load_records_fast(p)
    assert got[0].inp.step_records == tserde.load_records(p)[0].inp.step_records
    assert got[0].inp.step_records == rec
    empty = tmp_path / "empty.json"
    empty.write_text("")
    assert tfp.load_records_fast(str(empty)) == []


def test_corrupt_token_streams_give_statuses_not_crashes():
    """Garbage step-token streams through the per-store batch give error
    statuses, never a crash (the C side bounds-checks every header)."""
    task = TTask(twl.make_workload_key("matmul_add", (32, 32, 32)), "llvm")
    lib = tfp._lib()
    pool, offs = tfp._string_pool_arrays(["x"])
    rng = np.random.default_rng(0)
    statuses = []
    for _ in range(30):
        n_tok = int(rng.integers(1, 40))
        toks = rng.integers(-5, 20, n_tok).astype(np.int32)
        res = tfp._perstore_call(lib, task, toks, np.zeros(1, np.int64),
                                 np.asarray([n_tok], np.int64), pool, offs,
                                 1)
        statuses.append(int(res[2][0]))
    assert all(s != 0 for s in statuses)


# ---------------------------------------------------------------------------
# the descriptors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wk,args", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_descriptors_equal_jax_element_for_element(wk, args):
    """build_task_desc (or its NonAffineError) and build_expr_desc give
    the JAX package's int32 streams for every workload family."""
    jdag = jwl.workload_key_to_dag(jwl.make_workload_key(wk, args))
    tdag = twl.workload_key_to_dag(twl.make_workload_key(wk, args))
    je, te = jexpr.build_expr_desc(jdag), texpr.build_expr_desc(tdag)
    assert te.dtype == je.dtype == np.int32 and np.array_equal(te, je)
    try:
        jd = jtdesc.build_task_desc(jdag)
    except jtdesc.NonAffineError:
        with pytest.raises(ttdesc.NonAffineError):
            ttdesc.build_task_desc(tdag)
    else:
        td = ttdesc.build_task_desc(tdag)
        assert td.dtype == jd.dtype == np.int32 and np.array_equal(td, jd)
