"""The port's network-level evaluation against the JAX package, on the
CPU: the network task tables, the TenSet hash-key workloads, the record
dispatcher, the platform table, the schedule selector and the network
command lines (dump_network_info, make_dataset --hold-out / --preset,
estimate_network_latency, search, eval_model_on_dataset --networks) end
to end on the committed corpora. Host code over the same inputs: results
are held equal, except the network scores of one MLP pickle, held within
1e-6 (its predictions are float32 sums in another order).
"""

import collections
import dataclasses
import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest

from _torch_parity import np_segment_mlp_params
from vae_extent_search_tpu.models.segment import MLPModelInternal as JMLP
from vae_extent_search_tpu.records import dispatcher as jdisp
from vae_extent_search_tpu.records import networks as jnet
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.search import platforms as jplat
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu.utils.schedule_selector import (
    ScheduleSelector as JSelector,
)
from vae_extent_search_tpu_torch.cli import (
    common,
    dump_network_info,
    estimate_network_latency,
    eval_model_on_dataset,
    make_dataset,
    search,
)
from vae_extent_search_tpu_torch.models import load_model_pickle
from vae_extent_search_tpu_torch.models.embedding import embed_for_model
from vae_extent_search_tpu_torch.records import dispatcher as tdisp
from vae_extent_search_tpu_torch.records import networks as tnet
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records.task import SearchTask as TTask
from vae_extent_search_tpu_torch.search import platforms as tplat
from vae_extent_search_tpu_torch.utils.schedule_selector import (
    ScheduleSelector as TSelector,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET18 = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")
RESNET50 = os.path.join(ROOT, "result/corpus/resnet_50-B1-llvm.json")
TARGET = "llvm -mcpu=skylake-avx512"
FAMILIES = sorted({name for name, _ in jnet.build_network_keys()})


def jax_script(name):
    """scripts/<name>.py as a module (the scripts import ``common`` from
    their own folder)."""
    folder = os.path.join(ROOT, "scripts")
    if folder not in sys.path:
        sys.path.insert(0, folder)
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Both packages' dataset folders under tmp_path (the JAX scripts'
    ``common`` module and the port's), restored afterwards."""
    monkeypatch.chdir(tmp_path)
    jcommon = jax_script("common")
    sys.modules["common"] = jcommon      # what the JAX scripts import
    for mod in (common, jcommon):
        for name in ("DATASET_ROOT", "NETWORK_INFO_FOLDER",
                     "MEASURE_RECORD_FOLDER"):
            monkeypatch.setattr(mod, name, getattr(mod, name))
    common.set_dataset_root(str(tmp_path / "port"))
    jroot = str(tmp_path / "jax")
    jcommon.DATASET_ROOT = jroot
    jcommon.NETWORK_INFO_FOLDER = os.path.join(jroot, "network_info")
    jcommon.MEASURE_RECORD_FOLDER = os.path.join(jroot, "measure_records")
    yield jcommon
    sys.modules.pop("common", None)


def split_by_task(logs, folder, cap=None, subfolder_every=0, sub=""):
    """Per-task record files named clean_name((workload_key, "llvm")).json,
    as the per-task measure_records folder holds them; with
    ``subfolder_every`` k, every k-th file goes to ``folder/sub``."""
    groups = collections.OrderedDict()
    for path in logs:
        with open(path) as f:
            for line in f:
                if line.strip():
                    key = json.loads(line)["i"][0][0]
                    groups.setdefault(key, []).append(line.rstrip("\n") + "\n")
    paths = []
    for i, (key, lines) in enumerate(groups.items()):
        d = folder
        if subfolder_every and i % subfolder_every == 0:
            d = os.path.join(folder, sub)
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, common.clean_name((key, "llvm")) + ".json")
        with open(p, "w") as f:
            f.writelines(lines[:cap])
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# the network tables
# ---------------------------------------------------------------------------


def test_grid_is_the_same_108_entries():
    assert tnet.build_network_keys() == jnet.build_network_keys()
    assert len(tnet.build_network_keys()) == 108
    assert len(FAMILIES) == 14


@pytest.mark.parametrize("family", FAMILIES)
def test_network_tasks_equal_per_family(family):
    """Every grid entry of the family, at llvm and at cuda: the same
    workload keys, targets and weights, in the same order."""
    entries = [k for k in jnet.build_network_keys() if k[0] == family]
    assert entries
    for name, shape in entries:
        for target in ("llvm", "cuda"):
            try:
                jt, jw = jnet.get_network_tasks(name, *shape, target=target)
            except ValueError:
                with pytest.raises(ValueError):
                    tnet.get_network_tasks(name, *shape, target=target)
                continue
            tt, tw = tnet.get_network_tasks(name, *shape, target=target)
            assert [(t.workload_key, t.target) for t in tt] == \
                [(t.workload_key, t.target) for t in jt]
            assert list(tw) == list(jw)
            assert [t.to_record() for t in tt] == [t.to_record() for t in jt]


def test_resnet50_tasks_are_the_corpus_tasks():
    """The 26 tasks of resnet_50 [1, 224] are exactly the workload keys of
    the committed resnet-50 corpus."""
    tasks, weights = tnet.get_network_tasks("resnet_50", 1, 224, TARGET)
    keys = {r.inp.task.workload_key for r in tserde.iter_records(RESNET50)}
    assert len(tasks) == 26 and {t.workload_key for t in tasks} == keys
    assert sum(weights) > 26


# ---------------------------------------------------------------------------
# TenSet hash-key workloads
# ---------------------------------------------------------------------------

# the six op families of tests/test_aux.py::
# test_tenset_reconstruction_op_families
TENSET_CASES = {
    "depthwise": [1, 112, 112, 32, 3, 3, 32, 1, 1, 1, 1, 32,
                  1, 112, 112, 32],
    "group": [1, 56, 56, 128, 3, 3, 4, 128, 1, 1, 1, 128, 1, 56, 56, 128],
    "tconv": [1, 8, 8, 512, 4, 4, 512, 256, 1, 1, 1, 256, 1, 16, 16, 256],
    "bmm": [12, 128, 64, 12, 128, 64, 12, 128, 128],
    "pool": [1, 112, 112, 64, 1, 1, 1, 64, 1, 56, 56, 64],
    "conv3d": [1, 8, 28, 28, 32, 3, 3, 3, 32, 32, 1, 1, 1, 1, 32,
               1, 8, 28, 28, 32],
}


def _dag_summary(dag):
    return ([op.name for op in dag.ops], dag.flop_ct,
            [tuple(int(x) for x in getattr(op, "shape", ()) or ())
             for op in dag.ops])


@pytest.mark.parametrize("name", sorted(TENSET_CASES))
def test_tenset_inference_matches(name):
    from vae_extent_search_tpu.ir.dag import ComputeDAG as JDAG
    from vae_extent_search_tpu.records.tenset_workloads import (
        infer_tenset_workload as jinfer,
    )
    from vae_extent_search_tpu_torch.ir.dag import ComputeDAG as TDAG
    from vae_extent_search_tpu_torch.records.tenset_workloads import (
        infer_tenset_workload as tinfer,
    )

    args = TENSET_CASES[name]
    jt, tt = jinfer("0" * 32, args), tinfer("0" * 32, args)
    assert jt is not None and tt is not None
    assert _dag_summary(TDAG(tt)) == _dag_summary(JDAG(jt))


def test_hash_key_through_workload_registry():
    """A hash key that no shape function registers resolves through the
    TenSet inference in records/workload.py; an unknown signature raises
    KeyError in both packages."""
    from vae_extent_search_tpu.ir.dag import ComputeDAG as JDAG
    from vae_extent_search_tpu.records.workload import (
        workload_key_to_tensors as jw2t,
    )
    from vae_extent_search_tpu_torch.ir.dag import ComputeDAG as TDAG
    from vae_extent_search_tpu_torch.records.workload import (
        workload_key_to_tensors as tw2t,
    )

    for args in TENSET_CASES.values():
        key = json.dumps(["f" * 32] + args)
        assert _dag_summary(TDAG(tw2t(key))) == _dag_summary(JDAG(jw2t(key)))
    bad = json.dumps(["e" * 32, 7])
    for fn in (jw2t, tw2t):
        with pytest.raises(KeyError):
            fn(bad)


# ---------------------------------------------------------------------------
# the dispatcher, the platforms, the schedule selector
# ---------------------------------------------------------------------------


def test_apply_history_best_equal_on_corpus():
    jb = jdisp.ApplyHistoryBest.from_file(RESNET18)
    tb = tdisp.ApplyHistoryBest.from_file(RESNET18)
    keys = sorted({r.inp.task.workload_key
                   for r in tserde.iter_records(RESNET18)})
    assert len(keys) == 8
    # a compatible (scaled) workload: resnet-18's first conv at batch 2
    scaled = json.loads(keys[0])
    scaled[1] = 2
    for key in keys + [json.dumps(scaled)]:
        for target in (TARGET, "llvm", "cuda"):
            assert tb.best_cost(target, key) == jb.best_cost(target, key)
            jr, tr = jb.query(target, key), tb.query(target, key)
            assert (jr is None) == (tr is None)
            if jr is not None:
                assert tserde.record_to_json(tr) == jserde.record_to_json(jr)
    assert tb.best_cost(TARGET, json.dumps(scaled)) < float("inf")


class _StepMeasurer:
    """A deterministic measurer: the cost is a function of the printed
    steps, so equal samples get equal costs."""

    def __init__(self, result_cls):
        self.result_cls = result_cls
        self.seen = []

    def measure(self, task, states):
        out = []
        for st in states:
            text = json.dumps([s.to_record() for s in st.transform_steps])
            self.seen.append(text)
            out.append(self.result_cls([1e-6 * (len(text) % 97 + 1)], 0,
                                       0.0, 0.0))
        return out


def test_apply_history_best_or_sample_equal(monkeypatch):
    """A hit returns the recorded best without sampling; a miss samples
    the same states (Python's random, seed 2023 of the sketch policy)
    and then holds the same best cost."""
    # the JAX package takes its native GA when its library is built: the
    # port holds the Python loop's samples
    monkeypatch.setattr(jsketch.SketchPolicy, "_evolutionary_search_native",
                        lambda self, *a: None)
    recs = list(jserde.iter_records(RESNET18))
    hit = recs[0].inp.task.workload_key
    miss = json.dumps(["matmul_auto_scheduler_test", 64, 48, 32])
    jm, tm = _StepMeasurer(jserde.MeasureResult), \
        _StepMeasurer(tserde.MeasureResult)
    ja = jdisp.ApplyHistoryBestOrSample(recs, num_measure=4, measurer=jm)
    ta = tdisp.ApplyHistoryBestOrSample(
        list(tserde.iter_records(RESNET18)), num_measure=4, measurer=tm)
    assert ta.best_cost(TARGET, hit) == ja.best_cost(TARGET, hit)
    assert tm.seen == jm.seen == []
    assert ta.best_cost("llvm", miss) == ja.best_cost("llvm", miss)
    assert tm.seen == jm.seen and len(tm.seen) == 4
    with pytest.raises(NotImplementedError, match="measurer"):
        tdisp.ApplyHistoryBestOrSample([]).query("llvm", miss)


@pytest.mark.parametrize("pair", [
    ((["conv2d_layer", (1, 56, 56, 64)]), (["conv2d_layer", (1, 56, 56, 64)])),
    ((["conv2d_layer", (2, 56, 56, 64)]), (["conv2d_layer", (1, 28, 56, 64)])),
    ((["conv2d_layer", (3, 56)]), (["conv2d_layer", (2, 56)])),
    ((["conv2d_layer", (0, 56)]), (["conv2d_layer", (1, 56)])),
    ((["dense", (4, "float32")]), (["dense", (2, "float32")])),
    ((["dense", (4, "float32")]), (["dense", (2, "float16")])),
    ((["dense", (4,)]), (["matmul", (4,)])),
], ids=lambda p: "-".join(map(str, p[0][1] + p[1][1])))
def test_workload_distance_factor(pair):
    a, b = (tuple(x) for x in pair)
    assert tdisp.calc_workload_dis_factor(a, b) == \
        jdisp.calc_workload_dis_factor(a, b)


def test_target_keys_and_model():
    for target in ("llvm", TARGET, "cuda -model=t4", "cuda -keys=cuda,gpu",
                   "llvm -keys=cpu,arm -model=graviton2", ""):
        assert tdisp.target_keys_of(target) == jdisp.target_keys_of(target)
        assert tdisp.target_model_of(target) == jdisp.target_model_of(target)
        key = json.dumps(["dense", 1, [2, 3]])
        assert tdisp.decode_workload_key_flat(key) == \
            jdisp.decode_workload_key_flat(key)


@pytest.mark.parametrize("name", sorted(jplat.PLATFORMS))
def test_platform_for_target(name):
    jp = jplat.PLATFORMS[name]
    for target in (jp.target, jp.target + " -keys=x", jp.target.split()[0]):
        got, ref = tplat.platform_for_target(target), \
            jplat.platform_for_target(target)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.is_gpu == ref.is_gpu
    assert tplat.is_default_cpu_platform(tplat.platform_by_name(name)) == \
        jplat.is_default_cpu_platform(jp)


def test_schedule_selector_same_seed(tmp_path):
    keys = sorted({r.inp.task.workload_key
                   for r in jserde.iter_records(RESNET18)})
    out = []
    for cls, sub in ((JSelector, "j"), (TSelector, "t")):
        sel = cls(keys, RESNET18, seed=3)
        recs = sel.load_rec_only_high(percent=0.25)
        seen, totals = [], []
        for best in (True, False, False, False):
            path, total, idx = sel.random_look4_better(
                recs, seen, best=best, out_path=str(tmp_path / f"{sub}.json"))
            seen.append(idx)
            totals.append(total)
            with open(path) as f:
                n_lines = sum(1 for _ in f)
        out.append(({k: [(c, i) for _, c, i in v] for k, v in recs.items()},
                    seen, totals, n_lines))
    assert out[0] == out[1]
    assert out[1][3] == 8


# ---------------------------------------------------------------------------
# the command lines end to end, port against the JAX scripts
# ---------------------------------------------------------------------------


def _load_dir(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_dump_network_info_equal_pickles(roots, monkeypatch, capsys):
    jdump = jax_script("dump_network_info")
    monkeypatch.setattr(jdump, "NETWORK_INFO_FOLDER",
                        roots.NETWORK_INFO_FOLDER)
    nets = ["resnet_50", "resnet_18"]
    dumped = dump_network_info.main(["--target", TARGET, "--networks", *nets])
    monkeypatch.setattr(sys, "argv", ["x", "--target", TARGET,
                                      "--networks", *nets])
    jdump.main()
    got = _load_dir(common.NETWORK_INFO_FOLDER)
    ref = _load_dir(roots.NETWORK_INFO_FOLDER)
    assert got == ref
    assert len(got) == 7 and dumped[("resnet_50", (1, 224))] == 26
    tasks = common.load_and_register_tasks()
    assert len(tasks) == len(ref["all_tasks.pkl"]) and \
        isinstance(tasks[0], TTask)
    with pytest.raises(NotImplementedError, match="frontend"):
        dump_network_info.main(["--from-model", "resnet_18"])


def _tasks_of(ds):
    return sorted((t.workload_key, t.target, len(ds.throughputs[t]))
                  for t in ds.tasks())


@pytest.mark.parametrize("opts", [
    ["--hold-out", "resnet-50"], ["--hold-out", "all_five"],
    ["--preset", "batch-size-1"]], ids=lambda o: o[-1])
def test_make_dataset_hold_out_and_preset(roots, monkeypatch, capsys, opts):
    """Over resnet-18's eight per-task files: the hold-out of resnet-50
    keeps exactly the three tasks outside its grid (48 records), all_five
    keeps none, the preset keeps every file; equal to the JAX script."""
    files = split_by_task([RESNET18], "records")
    argv = files + ["--min-sample-size", "1", "--target", TARGET] + opts
    got = make_dataset.main(argv + ["--out-file", "p.pkl"])
    out_port = capsys.readouterr().out
    jmake = jax_script("make_dataset")
    monkeypatch.setattr(sys, "argv", ["x"] + argv + ["--out-file", "j.pkl"])
    jmake.main()
    out_jax = capsys.readouterr().out
    with open("j.pkl", "rb") as f:
        ref = pickle.load(f)
    assert _tasks_of(got) == _tasks_of(ref)
    want = {"resnet-50": (3, 48), "all_five": (0, 0),
            "batch-size-1": (8, 128)}[opts[-1]]
    assert (len(got.tasks()), len(got)) == want
    line = [ln for ln in out_jax.splitlines()
            if ln.startswith(("hold-out", "preset"))]
    assert line and line[0] in out_port
    if opts[-1] == "resnet-50":
        r50 = {t.workload_key
               for t in tnet.get_network_tasks("resnet_50", 1, 224, TARGET)[0]}
        assert not r50 & {t.workload_key for t in got.tasks()}


def test_estimate_and_search_on_resnet50(roots, capsys):
    jest = jax_script("estimate_network_latency")
    jsearch = jax_script("search")
    total, missing = estimate_network_latency.main([RESNET50, "--target",
                                                    TARGET])
    ref = jest.estimate_network_latency([RESNET50], "resnet_50", 1, 224,
                                        TARGET)
    assert (total, missing) == ref and missing == 0
    assert f"{total * 1e3:.3f}" == "9.400"
    assert "estimated latency 9.400 ms (0 tasks missing)" in \
        capsys.readouterr().out
    d, r = search.main([RESNET50, "--target", TARGET])
    tasks, weights = jnet.get_network_tasks("resnet_50", 1, 224, TARGET)
    tw = list(zip(tasks, weights))
    assert d == jsearch.default_search([RESNET50], tw) == total
    assert r == jsearch.random_search([RESNET50], tw, 5, 5)
    assert d <= r


def test_eval_networks_same_scores_as_jax(roots, monkeypatch, capsys):
    """eval_model_on_dataset --networks resnet_50 with one MLP pickle saved
    by the JAX package: the port on the CPU picks the same top-5
    schedules per task, scores them within 1e-4 of the largest score, and
gives the network scores within 1e-6. The 26
    per-task files hold the first 48 records each (the mode's least
    sample size), every third under the per-platform folder."""
    jeval = jax_script("eval_model_on_dataset")
    for mod in (common, roots):
        split_by_task([RESNET50], mod.MEASURE_RECORD_FOLDER, cap=48,
                      subfolder_every=3,
                      sub=tplat.platform_for_target(TARGET).name)
    dump_network_info.main(["--target", TARGET, "--networks", "resnet_50"])
    jdump = jax_script("dump_network_info")
    monkeypatch.setattr(jdump, "NETWORK_INFO_FOLDER",
                        roots.NETWORK_INFO_FOLDER)
    monkeypatch.setattr(sys, "argv", ["x", "--target", TARGET,
                                      "--networks", "resnet_50"])
    jdump.main()

    rng = np.random.default_rng(5)
    jm = JMLP(in_dim=174, hidden_dim=32, loss_type="lambdaRank")
    jm.params = np_segment_mlp_params(rng, 174, 32)
    jm.fea_norm_vec = rng.uniform(0.5, 4.0, 174).astype(np.float32)
    jm.use_workload_embedding, jm.workload_embed_total_dim = True, 10
    jm.save("jax_mlp.pkl")
    capsys.readouterr()

    scores = eval_model_on_dataset.main(
        ["--model", "jax_mlp.pkl", "--networks", "resnet_50", "--target",
         TARGET, "--cache-dir", "pcache", "--device", "cpu"])["resnet_50"]
    assert "=== resnet_50 (26 tasks) ===" in capsys.readouterr().out
    jtasks, jweights = jeval._network_task_datasets("resnet_50", TARGET,
                                                    "jcache")
    jmodel = jeval.load_model_pickle("jax_mlp.pkl")
    best, lats = jeval.eval_cost_model_on_weighted_tasks(
        jmodel, jtasks, jweights, [1, 5])
    for k, lat in zip((1, 5), lats):
        assert 0 < scores[k] <= 1
        assert abs(scores[k] - best / lat) <= 1e-6
    ttasks, tweights = eval_model_on_dataset.network_task_datasets(
        "resnet_50", TARGET, "pcache")
    assert tweights == jweights and len(ttasks) == 26
    tmodel = load_model_pickle("jax_mlp.pkl", device="cpu")
    from vae_extent_search_tpu.models.embedding import (
        embed_for_model as jembed,
    )

    for (tds, tt), (jds, jt) in zip(ttasks, jtasks):
        assert tt.workload_key == jt.workload_key
        tf = embed_for_model(tmodel, [np.asarray(f, np.float32)
                                      for f in tds.features[tt]],
                             tt.workload_key)
        jf = jembed(jmodel, [np.asarray(f, np.float32)
                             for f in jds.features[jt]], jt.workload_key)
        tp, jp = tmodel.predict_on_features(tf), jmodel.predict_on_features(jf)
        # float32 sums of unnormalised rows in another order: within 1e-4
        # of the largest score
        np.testing.assert_allclose(tp, jp, rtol=0,
                                   atol=1e-4 * np.abs(jp).max())
        assert list(np.argsort(-tp)[:5]) == list(np.argsort(-jp)[:5])
    # the JAX script's own report, to its 4 printed decimals
    monkeypatch.setattr(sys, "argv", [
        "x", "--model", "jax_mlp.pkl", "--networks", "resnet_50", "--target",
        TARGET, "--cache-dir", "jcache"])
    jeval.main()
    printed = [float(ln.split()[2]) for ln in capsys.readouterr().out
               .splitlines() if ln.startswith("top-")]
    assert printed == [round(scores[1], 4), round(scores[5], 4)]
