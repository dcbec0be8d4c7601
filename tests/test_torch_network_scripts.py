"""The port's remaining network command lines against the JAX scripts, on
the CPU: print_all_tasks, json_to_task_pkl, network2measure_records,
few_shot_eval and hyperparameter_opt, on the committed corpora. Host
code and the tree models over the same inputs are held equal (tables,
pickles, CSV rows and the optimisers' trials). The MLP's fits draw their
initial parameters from each package's own generator, so those runs take
the same injected numpy parameters on both sides; their rows are held
within 0.02 in each rank metric (float32 fits in another order of sums
may part near-tied predictions; on this instance they stay within 1e-4),
the rest exactly.
"""

import csv
import functools
import itertools
import json
import os
import pickle
import random
import sys

import numpy as np
import pytest
import torch

from _torch_parity import np_segment_mlp_params
from test_torch_networks import jax_script, roots, split_by_task  # noqa: F401
from vae_extent_search_tpu.data.dataset import Dataset as JDataset
from vae_extent_search_tpu.data.dataset import LearningTask as JLearningTask
from vae_extent_search_tpu.features import per_store as jps
from vae_extent_search_tpu.models import gbdt as jg
from vae_extent_search_tpu.models import segment as jseg
from vae_extent_search_tpu.models.segment import MLPModelInternal as JMLP
from vae_extent_search_tpu_torch.cli import (
    common,
    dump_network_info,
    few_shot_eval,
    hyperparameter_opt,
    json_to_task_pkl,
    network2measure_records,
    print_all_tasks,
)
from vae_extent_search_tpu_torch.convert import (
    params_from_numpy,
    tree_leaves,
)
from vae_extent_search_tpu_torch.data.dataset import (
    make_dataset_from_log_file,
)
from vae_extent_search_tpu_torch.models import gbdt as tg
from vae_extent_search_tpu_torch.models import load_model_pickle
from vae_extent_search_tpu_torch.models import segment as tseg
from _torch_parity import pin_port_python_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET18 = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")
RESNET50 = os.path.join(ROOT, "result/corpus/resnet_50-B1-llvm.json")
TARGET = "llvm -mcpu=skylake-avx512"
RANK_TOL = 0.02
METRICS = ("pairwise", "peak@1", "peak@5")


def _run_jax(mod, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    return mod.main()


def _dump_tables(roots, monkeypatch, nets):
    dump_network_info.main(["--target", TARGET, "--networks", *nets])
    jdump = jax_script("dump_network_info")
    monkeypatch.setattr(jdump, "NETWORK_INFO_FOLDER",
                        roots.NETWORK_INFO_FOLDER)
    _run_jax(jdump, monkeypatch, ["--target", TARGET, "--networks", *nets])


# ---------------------------------------------------------------------------
# the three host-only command lines
# ---------------------------------------------------------------------------


def test_print_all_tasks_same_table(roots, monkeypatch, capsys):
    _dump_tables(roots, monkeypatch, ["resnet_18", "resnet_50"])
    capsys.readouterr()
    tasks = print_all_tasks.main([])
    got = capsys.readouterr().out
    _run_jax(jax_script("print_all_tasks"), monkeypatch, [
        "--network-info-folder",
        os.path.join(roots.NETWORK_INFO_FOLDER, "all_tasks.pkl")])
    want = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == len(tasks) > 26
    assert got.startswith("[    0] flop=")
    # the option names the pickle itself, as in the JAX script
    print_all_tasks.main(["--network-info-folder", os.path.join(
        common.NETWORK_INFO_FOLDER, "all_tasks.pkl")])
    assert capsys.readouterr().out == got


def test_json_to_task_pkl_same_arrays(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    jmod = jax_script("json_to_task_pkl")
    monkeypatch.setattr(jmod, "get_per_store_features_from_file",
                        functools.partial(
                            jps.get_per_store_features_from_file,
                            use_native=False))
    pin_port_python_paths(monkeypatch)
    out = json_to_task_pkl.main([RESNET18, "--out", "port.pkl"])
    got_line = capsys.readouterr().out
    _run_jax(jmod, monkeypatch, [RESNET18, "--out", "jax.pkl"])
    assert capsys.readouterr().out == got_line.replace("port.pkl",
                                                       "jax.pkl")
    with open(out, "rb") as f:
        got = pickle.load(f)
    with open("jax.pkl", "rb") as f:
        want = pickle.load(f)
    assert len(got[0]) == len(want[0]) == 128 and len(got[3]) == 8
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)
    # the default name lands in the working directory
    json_to_task_pkl.main([RESNET18])
    assert os.path.exists("resnet_18-B1-llvm.json.task.pkl")


def test_network2measure_records_same_log(roots, monkeypatch, capsys):
    """resnet_50's 26 tasks from the per-task files of both corpora, with
    one file taken away: the same log and the same report of the missing
    file."""
    _dump_tables(roots, monkeypatch, ["resnet_50"])
    for folder in (common.MEASURE_RECORD_FOLDER,
                   roots.MEASURE_RECORD_FOLDER):
        files = split_by_task([RESNET50, RESNET18], folder)
        os.remove(sorted(files)[0])
    name = common.clean_name((("resnet_50", [1, 224]), TARGET)) + ".task.pkl"
    capsys.readouterr()
    n = network2measure_records.main([
        "--network-task-pkl",
        os.path.join(common.NETWORK_INFO_FOLDER, name),
        "--out-file", "port.json"])
    got = capsys.readouterr().out
    jmod = jax_script("network2measure_records")
    monkeypatch.setattr(jmod, "MEASURE_RECORD_FOLDER",
                        roots.MEASURE_RECORD_FOLDER)
    _run_jax(jmod, monkeypatch, [
        "--network-task-pkl", os.path.join(roots.NETWORK_INFO_FOLDER, name),
        "--out-file", "jax.json"])
    want = capsys.readouterr().out
    with open("port.json") as f, open("jax.json") as g:
        assert f.read() == g.read()
    assert got.count("missing: ") == want.count("missing: ") == 1
    assert got.splitlines()[-1] == want.splitlines()[-1].replace(
        "jax.json", "port.json")
    with open("port.json") as f:
        assert n == len(f.readlines()) > 2000


# ---------------------------------------------------------------------------
# few_shot_eval
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    """Four resnet-50 tasks (~97 records each) as each package's Dataset
    pickle, featurised once by the port."""
    d = tmp_path_factory.mktemp("fs")
    keys, lines = [], []
    with open(RESNET50) as f:
        for line in f:
            key = json.loads(line)["i"][0][0]
            if key not in keys:
                keys.append(key)
            if keys.index(key) < 4:
                lines.append(line)
    log = str(d / "four.json")
    with open(log, "w") as f:
        f.writelines(lines)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        ds = make_dataset_from_log_file([log], str(d / "port_ds.pkl"),
                                        min_sample_size=30, verbose=0)
    finally:
        os.chdir(cwd)
    jds = JDataset()
    for t in ds.tasks():
        jds.load_task_data(JLearningTask(*t), ds.features[t],
                           ds.throughputs[t], ds.min_latency[t])
    with open(d / "jax_ds.pkl", "wb") as f:
        pickle.dump(jds, f)
    assert len(ds.tasks()) == 4
    return d, ds


def _inject_mlp_init(monkeypatch):
    """Both packages' fresh MLPs start from the same numpy parameters: the
    n-th fresh model of a run takes np_segment_mlp_params(rng(n))."""
    counters = {"jax": itertools.count(), "port": itertools.count()}

    def draw(side, in_dim, hidden_dim):
        rng = np.random.default_rng(100 + next(counters[side]))
        return np_segment_mlp_params(rng, in_dim, hidden_dim)

    monkeypatch.setattr(
        jseg, "init_segment_mlp_params",
        lambda key, in_dim, hidden_dim=256, out_dim=1: draw(
            "jax", in_dim, hidden_dim))
    monkeypatch.setattr(
        tseg, "init_segment_mlp_params",
        lambda gen, in_dim, hidden_dim=256, out_dim=1, device=None:
        params_from_numpy(draw("port", in_dim, hidden_dim), device=device))


def _save_jax_mlp(path):
    rng = np.random.default_rng(5)
    m = JMLP(in_dim=174, hidden_dim=32, loss_type="rmse")
    m.params = np_segment_mlp_params(rng, 174, 32)
    m.fea_norm_vec = rng.uniform(0.5, 4.0, 174).astype(np.float32)
    m.use_workload_embedding, m.workload_embed_total_dim = True, 10
    m.save(path)


def _rows_close(got, want, exact=False):
    assert [(r["mode"], r["k"], r["n_tasks"]) for r in got] == \
        [(r["mode"], r["k"], r["n_tasks"]) for r in want]
    for a, b in zip(got, want):
        for m in METRICS:
            if exact or a["mode"] == "zero":
                assert a[m] == b[m], (a, b)
            else:
                assert abs(a[m] - b[m]) <= RANK_TOL, (a, b)


def test_few_shot_eval_mlp_base(small_ds, tmp_path, monkeypatch, capsys):
    """The four modes from one JAX-saved MLP pickle: zero's rows equal
    exactly, the trained modes' within RANK_TOL; the CSV holds the rows;
    fine_tune leaves the base's parameters as they were."""
    d, _ = small_ds
    monkeypatch.chdir(tmp_path)
    _inject_mlp_init(monkeypatch)
    _save_jax_mlp("base.pkl")
    argv = ["--base", "base.pkl", "--k", "8", "--max-tasks", "3",
            "--fine-tune-epochs", "6"]
    got = few_shot_eval.main(argv + ["--dataset", str(d / "port_ds.pkl"),
                                     "--out-csv", "out/port.csv",
                                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 tasks (>= 28 records each), K=[8]" in out
    _run_jax(jax_script("few_shot_eval"), monkeypatch, argv + [
        "--dataset", str(d / "jax_ds.pkl"), "--out-csv", "out/jax.csv"])
    with open("out/jax.csv") as f:
        want = [{k: (float(v) if k in METRICS else v) for k, v in r.items()}
                for r in csv.DictReader(f)]
    for r in want:
        r["k"], r["n_tasks"] = int(r["k"]), int(r["n_tasks"])
    assert [r["mode"] for r in got] == ["zero", "local", "fine_tune", "plus"]
    _rows_close(got, want)
    with open("out/port.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["pairwise"]) for r in rows] == \
        [r["pairwise"] for r in got]

    # fine_tune trains a copy: the base keeps its parameters
    base = load_model_pickle("base.pkl", device="cpu")
    before = [t.clone() for t in tree_leaves(base.params)]
    rng = np.random.default_rng(0)
    with open(d / "port_ds.pkl", "rb") as f:
        ds = pickle.load(f)
    task = ds.tasks()[0]
    feats = [np.asarray(f, np.float32) for f in ds.features[task]]
    r = few_shot_eval.adapt_and_eval(base, task, feats,
                                     np.asarray(ds.throughputs[task]), 8,
                                     "fine_tune", rng, 4)
    assert 0 <= r["pairwise"] <= 1
    after = tree_leaves(base.params)
    assert len(after) == len(before) == 10
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_few_shot_eval_gbdt_base(small_ds, tmp_path, monkeypatch, capsys):
    """A GBDT base, fit by each package on the same programs (the numpy
    grower on both sides): zero, local and plus give equal rows; fine_tune
    raises as the JAX script's does, before any CSV is written."""
    d, ds = small_ds
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VES_BOOST_TPU", "0")
    feats, labels, _ = ds.flatten()
    jb = jg.GBDTModelInternal(backend="xgb", n_estimators=20)
    jb.fit_base(feats, labels)
    jb.save("jax_base.pkl")
    tb = tg.GBDTModelInternal(n_estimators=20, device="cpu")
    tb.fit_base(feats, labels)
    tb.save("port_base.pkl")
    argv = ["--k", "8", "16", "--max-tasks", "3"]
    got = few_shot_eval.main(argv + [
        "--base", "port_base.pkl", "--dataset", str(d / "port_ds.pkl"),
        "--modes", "zero", "local", "plus", "--device", "cpu"])
    jmod = jax_script("few_shot_eval")
    capsys.readouterr()
    _run_jax(jmod, monkeypatch, argv + [
        "--base", "jax_base.pkl", "--dataset", str(d / "jax_ds.pkl"),
        "--modes", "zero", "local", "plus"])
    want = [eval(ln, {"nan": np.nan}) for ln in
            capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(got) == 5
    _rows_close(got, want, exact=True)
    for cli, base, ds_pkl, runner in (
            (few_shot_eval.main, "port_base.pkl", "port_ds.pkl", None),
            (None, "jax_base.pkl", "jax_ds.pkl", jmod)):
        a = argv + ["--base", base, "--dataset", str(d / ds_pkl),
                    "--modes", "zero", "fine_tune", "--out-csv", "x.csv"]
        with pytest.raises(AttributeError, match="params"):
            if cli:
                cli(a + ["--device", "cpu"])
            else:
                _run_jax(runner, monkeypatch, a)
        assert not os.path.exists("x.csv")


# ---------------------------------------------------------------------------
# hyperparameter_opt
# ---------------------------------------------------------------------------


def _objective(cfg):
    """A deterministic stand-in metric over a configuration."""
    return float(sum(hash(str(v)) % 997 for v in cfg.values()) / 997.0)


@pytest.mark.parametrize("model", ["mlp", "gbdt"])
def test_tpe_and_local_moves_equal(model):
    jh = jax_script("hyperparameter_opt")
    space = hyperparameter_opt.SPACES[model]
    assert space == jh.SPACES[model]
    tr, jr = random.Random(3), random.Random(3)
    tt, jt = hyperparameter_opt.TPE(space, tr), jh.TPE(space, jr)
    for _ in range(12):
        cfg, jcfg = tt.ask(), jt.ask()
        assert cfg == jcfg
        v = _objective(cfg)
        tt.tell(cfg, v)
        jt.tell(jcfg, v)
    cfg = hyperparameter_opt.sample(space, tr)
    assert cfg == jh.sample(space, jr)
    assert hyperparameter_opt.neighbors(space, cfg) == \
        jh.neighbors(space, cfg)


def test_gp_ucb_asks_equal():
    jh = jax_script("hyperparameter_opt")
    tr, jr = random.Random(1), random.Random(1)
    kw = dict(init_points=2, n_acq=256)
    tg_, jg_ = (hyperparameter_opt.GPUCB(hyperparameter_opt.LGBM_BOUNDS, tr,
                                         **kw),
                jh.GPUCB(jh.LGBM_BOUNDS, jr, **kw))
    tg_.probe(hyperparameter_opt.LGBM_PROBE)
    jg_.probe(jh.LGBM_PROBE)
    for _ in range(6):
        p, jp = tg_.ask(), jg_.ask()
        assert p == jp
        assert hyperparameter_opt.proc_lgbm_params(p) == \
            jh.proc_lgbm_params(jp)
        v = -abs(p["learning_rate"] - 0.1) - abs(p["num_leaves"] - 50) / 100
        tg_.tell(p, v)
        jg_.tell(jp, v)


@pytest.fixture
def hpo_ds(small_ds, tmp_path, monkeypatch):
    d, _ = small_ds
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VES_BOOST_TPU", "0")
    # the JAX script's own import of its train_model
    sys.path.insert(0, ROOT)
    return d


@pytest.mark.parametrize("algo,opts", [
    ("local", ["--n-random", "2", "--n-local", "1"]),
    ("tpe", ["--n-trials", "3"])], ids=["local", "tpe"])
def test_hyperparameter_opt_gbdt_equal(hpo_ds, monkeypatch, capsys, algo,
                                       opts):
    """--model gbdt: every trial's printed metric and the best config equal
    the JAX script's (the numpy grower on both sides)."""
    d = hpo_ds
    jh = jax_script("hyperparameter_opt")
    monkeypatch.setattr(jh, "build", lambda kind, cfg, in_dim:
                        jg.GBDTModelInternal(backend="xgb", **cfg))
    argv = ["--model", "gbdt", "--algo", algo, *opts]
    got = hyperparameter_opt.main(argv + [
        "--dataset", str(d / "port_ds.pkl"), "--device", "cpu"])
    out = capsys.readouterr().out
    want = _run_jax(jh, monkeypatch, argv + ["--dataset",
                                             str(d / "jax_ds.pkl")])
    assert capsys.readouterr().out == out
    assert got == want and out.count(" -> ") >= 3


def test_hyperparameter_opt_lgbm_gp_equal(hpo_ds, monkeypatch, capsys):
    """--model lgbm (the GP flow): the probe, 2 random and 1 GP trial, the
    best params, the saved model's predictions and the printed metrics."""
    d = hpo_ds
    jh = jax_script("hyperparameter_opt")
    argv = ["--model", "lgbm", "--init-points", "2", "--n-iter", "1",
            "--n-estimators", "12"]
    got = hyperparameter_opt.main(argv + [
        "--dataset", str(d / "port_ds.pkl"), "--out-model", "port.pkl",
        "--device", "cpu"])
    out = capsys.readouterr().out
    want = _run_jax(jh, monkeypatch, argv + [
        "--dataset", str(d / "jax_ds.pkl"), "--out-model", "jax.pkl"])
    assert capsys.readouterr().out == out.replace("port.pkl", "jax.pkl")
    assert got == want and out.count("RMSE = ") == 4
    with open(d / "port_ds.pkl", "rb") as f:
        feats, _, _ = pickle.load(f).flatten()
    tm_ = load_model_pickle("port.pkl", device="cpu")
    with open("jax.pkl", "rb") as f:
        jm_ = pickle.load(f)
    assert np.array_equal(tm_.predict_on_features(feats),
                          jm_.predict_on_features(feats))


def test_hyperparameter_opt_mlp_flow(hpo_ds, monkeypatch, capsys):
    """--model mlp --algo local: the same trials in the same order and the
    same best as the JAX script when each trial's metric is the same
    function of its config (the MLP's own metric depends on its package's
    initial draw; its fit and evaluation are held by the tests of
    cli.train_model)."""
    d = hpo_ds
    jh = jax_script("hyperparameter_opt")
    seen = {"port": [], "jax": []}

    def fake_eval(side):
        def evaluate(model, test_set):
            cfg = {k: getattr(model, k) for k in
                   hyperparameter_opt.SPACES["mlp"]}
            seen[side].append(cfg)
            return {"average peak score@1": _objective(cfg)}
        return evaluate

    class NoFit:
        def __init__(self, **cfg):
            self.__dict__.update(cfg)

        def fit_base(self, feats, labels):
            return self

    monkeypatch.setattr(hyperparameter_opt, "evaluate_model",
                        fake_eval("port"))
    monkeypatch.setattr(jh, "evaluate_model", fake_eval("jax"))
    monkeypatch.setattr(hyperparameter_opt, "build",
                        lambda kind, cfg, in_dim, device: NoFit(**cfg))
    monkeypatch.setattr(jh, "build", lambda kind, cfg, in_dim: NoFit(**cfg))
    argv = ["--model", "mlp", "--n-random", "4", "--n-local", "2"]
    got = hyperparameter_opt.main(argv + [
        "--dataset", str(d / "port_ds.pkl"), "--device", "cpu"])
    want = _run_jax(jh, monkeypatch, argv + ["--dataset",
                                             str(d / "jax_ds.pkl")])
    assert got == want and seen["port"] == seen["jax"]
    assert len(seen["port"]) >= 4


def test_mlp_trial_runs_on_the_cpu(hpo_ds, capsys):
    """One real --model mlp trial on the CPU: a finite metric."""
    d = hpo_ds
    best, val = hyperparameter_opt.main([
        "--dataset", str(d / "port_ds.pkl"), "--model", "mlp",
        "--n-random", "1", "--n-local", "0", "--device", "cpu"])
    assert np.isfinite(val) and 0 <= val <= 1
    assert set(best) == set(hyperparameter_opt.SPACES["mlp"])
