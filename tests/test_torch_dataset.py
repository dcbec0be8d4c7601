"""The port's performance dataset, LightGBM-semantics model and the three
cost-model command lines against the JAX package, on the committed log
``result/corpus/resnet_18-B1-llvm.json`` (128 records, 8 tasks) and on
synthetic tasks drawn with numpy from a seed. Host code over numpy:
results are held equal, not within a tolerance, except where a model is
trained (stated there).
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

from _torch_parity import ragged_programs
from vae_extent_search_tpu.data import dataset as jd
from vae_extent_search_tpu.models import gbdt as jg
from vae_extent_search_tpu_torch.cli import (
    eval_model_on_dataset,
    make_dataset,
    train_model,
)
from vae_extent_search_tpu_torch.data import dataset as td
from vae_extent_search_tpu_torch.models import gbdt as tg
from vae_extent_search_tpu_torch.models import load_model_pickle
from vae_extent_search_tpu_torch.models.variants import SequenceModelInternal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET18 = os.path.join(ROOT, "result/corpus/resnet_18-B1-llvm.json")


def synthetic(mod, seed=0, n_tasks=7):
    """The same tasks loaded into either package's Dataset."""
    rng = np.random.default_rng(seed)
    ds = mod.Dataset()
    for t in range(n_tasks):
        n = int(rng.integers(5, 20))
        feats = np.empty(n, dtype=object)
        feats[:] = ragged_programs(rng, n, 6)
        task = mod.LearningTask(f'["wkl", {t}]',
                                "llvm" if t % 3 else "cuda")
        ds.load_task_data(task, feats, rng.random(n).astype(np.float32),
                          float(rng.random() + 0.1))
    return ds


def assert_same(got, ref):
    assert [tuple(t) for t in got.tasks()] == [tuple(t) for t in ref.tasks()]
    for tg_, tr_ in zip(got.tasks(), ref.tasks()):
        assert np.array_equal(got.throughputs[tg_], ref.throughputs[tr_])
        assert got.min_latency[tg_] == ref.min_latency[tr_]
        assert len(got.features[tg_]) == len(ref.features[tr_])
        for a, b in zip(got.features[tg_], ref.features[tr_]):
            assert np.array_equal(a, b)
    assert len(got) == len(ref)


def test_merge_renormalises_like_jax():
    got, ref = synthetic(td, 0), synthetic(jd, 0)
    got.update_from_dataset(synthetic(td, 1))
    ref.update_from_dataset(synthetic(jd, 1))
    assert_same(got, ref)
    t = got.tasks()[0]
    # merged throughputs are relative to the smaller of the two minima
    assert got.min_latency[t] == min(synthetic(td, 0).min_latency[t],
                                     synthetic(td, 1).min_latency[t])


@pytest.mark.parametrize("scheme", ["within_task", "by_task", "by_target",
                                    "within_task_given_idxs"])
def test_splits_equal_index_for_index(scheme):
    got, ref = synthetic(td), synthetic(jd)
    if scheme == "within_task":
        g = got.random_split_within_task(0.8, seed=3)
        r = ref.random_split_within_task(0.8, seed=3)
    elif scheme == "by_task":
        g = got.random_split_by_task(0.7, seed=3)
        r = ref.random_split_by_task(0.7, seed=3)
    elif scheme == "by_target":
        g = got.random_split_by_target(["llvm"])
        r = ref.random_split_by_target(["llvm"])
        assert {t.target for t in g[1].tasks()} == {"cuda"}
    else:
        tr = {t: [0, 2] for t in got.tasks()}
        te = {t: [1] for t in got.tasks()}
        g = got.random_split_within_task(train_idxs=tr, test_idxs=te)
        r = ref.random_split_within_task(
            train_idxs={jd.LearningTask(*t): v for t, v in tr.items()},
            test_idxs={jd.LearningTask(*t): v for t, v in te.items()})
        assert len(g[0]) == 2 * len(got.tasks())
        assert len(g[1]) == len(got.tasks())
    for a, b in zip(g, r):
        assert_same(a, b)
    if scheme != "within_task_given_idxs":
        assert len(g[0]) + len(g[1]) == len(got)


@pytest.mark.parametrize("embed_dim", [None, 9, 10])
def test_flatten_equal(embed_dim):
    got, ref = td.Dataset(), jd.Dataset()
    rng = np.random.default_rng(2)
    keys = []
    from vae_extent_search_tpu_torch.records.serde import load_records

    for r in load_records(RESNET18):
        if r.inp.task.workload_key not in keys:
            keys.append(r.inp.task.workload_key)
    for key in keys[:3]:
        feats = np.empty(4, dtype=object)
        feats[:] = ragged_programs(rng, 4, 164)
        thr = rng.random(4).astype(np.float32)
        got.load_task_data(td.LearningTask(key, "llvm"), feats, thr, 1.0)
        ref.load_task_data(jd.LearningTask(key, "llvm"), feats, thr, 1.0)
    kw = {} if embed_dim is None else dict(with_workload_embedding=True,
                                           embed_total_dim=embed_dim)
    g, r = got.flatten(**kw), ref.flatten(**kw)
    assert len(g[0]) == 12 and g[0][0].shape[1] == 164 + (embed_dim or 0)
    assert all(np.array_equal(a, b) for a, b in zip(g[0], r[0]))
    assert np.array_equal(g[1], r[1]) and np.array_equal(g[2], r[2])
    assert g[2].dtype == np.int32
    empty = td.Dataset().flatten()
    assert empty[0] == [] and empty[1].shape == (0,)


def test_make_dataset_from_log_file_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = td.make_dataset_from_log_file([RESNET18], "got.pkl", 8, verbose=0)
    ref = jd.make_dataset_from_log_file([RESNET18], "ref.pkl", 8, verbose=0)
    assert len(got) == 128 and len(got.tasks()) == 8
    assert_same(got, ref)
    # each package keeps its feature caches in a folder of its own, and the
    # port's never names a class of the JAX package
    (cache,) = os.listdir(".dataset_cache_torch")
    with open(os.path.join(".dataset_cache_torch", cache), "rb") as f:
        assert b"vae_extent_search_tpu." not in f.read()
    # from the cache, capped and filtered
    again = td.make_dataset_from_log_file([RESNET18], None, 8, verbose=0)
    assert_same(again, got)
    assert len(td.make_dataset_from_log_file([RESNET18], None, 48,
                                             verbose=0)) == 0
    capped = td.make_dataset_from_log_file(
        [RESNET18], None, 1, verbose=0, max_records_per_file=20,
        exclude_workload_keys={got.tasks()[0].workload_key})
    assert 0 < len(capped) < 20
    with open("got.pkl", "rb") as f:
        assert_same(pickle.load(f), got)


def test_lgb_model_equals_jax_on_the_in_repo_booster():
    """Same numpy booster, same leaf-wise grower, same seed: equal trees."""
    rng = np.random.default_rng(4)
    feats = ragged_programs(rng, 60, 12, 1, 5)
    w = rng.random(12).astype(np.float32)
    y = np.asarray([f.sum(0) @ w for f in feats], np.float32)
    y /= y.max()
    ref = jg.LGBModelInternal(n_estimators=12).fit_base(feats, y)
    got = tg.LGBModelInternal(n_estimators=12, device="cpu").fit_base(feats, y)
    assert ref.backend == "native" and got.backend == "native"
    assert got._native_params() == ref._native_params()
    assert np.array_equal(got.predict_on_features(feats),
                          ref.predict_on_features(feats))
    # lightgbm-named overrides, as the reference's constructor takes them
    over = tg.LGBModelInternal(params={"num_leaves": 5, "max_depth": 3,
                                       "min_sum_hessian_in_leaf": 1,
                                       "boosting_type": "gbdt"}, device="cpu")
    p = over._native_params()
    assert (p["num_leaves"], p["max_depth"], p["min_child_weight"]) == (5, 3, 1)
    assert "max_depth" not in got._native_params()


def test_command_lines_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ds = make_dataset.main([RESNET18, "--min-sample-size", "8",
                            "--out-file", "ds.pkl"])
    assert len(ds) == 128
    # 20 trees instead of the 300 of the command line, for the test's time
    monkeypatch.setattr(train_model, "LGBModelInternal", functools.partial(
        tg.LGBModelInternal, n_estimators=20))
    res = train_model.main(["--dataset", "ds.pkl", "--models",
                            "mlp@rmse,random,lgb", "--device", "cpu",
                            "--seed", "1"])
    assert set(res) == {"mlp@rmse", "random", "lgb"}
    for name, metrics in res.items():
        assert list(metrics) == train_model.METRIC_NAMES
        assert all(np.isfinite(v) for v in metrics.values()), name
        assert 0 < metrics["average peak score@5"] <= 1
    assert {"lgb.pkl", "mlp_rmse.pkl", "random.pkl",
            "tmp_mlp.pkl"} <= set(os.listdir("."))
    out = capsys.readouterr().out
    assert "Train set: 112 samples / 8 tasks" in out
    mlp = load_model_pickle("mlp_rmse.pkl", device="cpu")
    assert mlp.in_dim == 174 and mlp.use_workload_embedding
    assert load_model_pickle("lgb.pkl").workload_embed_total_dim == 9
    for model in ("mlp_rmse", "lgb"):
        scores = eval_model_on_dataset.main(
            ["--model", f"{model}.pkl", "--datasets", "ds.pkl",
             "--device", "cpu"])
        assert 0 < scores["ds.pkl"][1] <= scores["ds.pkl"][5] <= 1
    assert "top-5 score" in capsys.readouterr().out
    # a rank loss prints no calibration metric
    train_model.main(["--dataset", "ds.pkl", "--models", "mlp", "--device",
                      "cpu", "--split-scheme", "by_task",
                      "--no-workload-embedding"])
    assert "RMSE: n/a (rank loss lambdaRank)" in capsys.readouterr().out
    assert load_model_pickle("mlp.pkl", device="cpu").in_dim == 164


def test_command_lines_refuse_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # everything of these command lines is ported now: the native
    # featuriser's threads (tests/test_torch_native_search.py), the
    # hold-out sets, the preset, the sequence models, --networks and the
    # graph front end's --from-model (tests/test_torch_networks.py,
    # tests/test_torch_variants.py); a pattern no file matches gives an
    # empty dataset
    assert len(make_dataset.main(["x.json", "--n-threads", "4"])) == 0
    for kind in ("lstm", "mha", "tabnet"):
        model = train_model.make_model(kind, 164, "cpu")
        assert isinstance(model, SequenceModelInternal) and \
            model.arch == kind and model.device == "cpu"
    with pytest.raises(ValueError):
        train_model.make_model("forest", 164, "cpu")
    model = train_model.make_model("lstm", 12, "cpu")
    model.fit_base([np.ones((2, 12), np.float32)] * 3, [0.2, 0.4, 0.6])
    model.save("seq.pkl")
    with open("seq.pkl", "rb") as f:
        assert pickle.load(f)["arch"] == "lstm"
    assert isinstance(load_model_pickle("seq.pkl", device="cpu"),
                      SequenceModelInternal)
    # "mlp@xgb" is the reference's two-model separator, "mlp@rmse" a loss
    assert train_model.make_model("mlp@listNet", 10, "cpu").loss_type == \
        "listNet"
    assert isinstance(train_model.make_model("xgb", 10, "cpu"),
                      tg.GBDTModelInternal)


def test_train_model_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ds = synthetic(td)
    with open("ds.pkl", "wb") as f:
        pickle.dump(ds, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            train_model.main(["--dataset", "ds.pkl", "--models", "random"])
        assert not os.path.exists("random.pkl")
        with open("m.pkl", "wb") as f:
            pickle.dump({"config": {}, "params": {}, "fea_norm_vec": None}, f)
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            eval_model_on_dataset.main(["--model", "m.pkl", "--datasets",
                                        "ds.pkl"])
