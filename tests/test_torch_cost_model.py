"""The port's in-search cost models (``search/cost_model.py``) and
``transfer_tune`` against the JAX package on the CPU (``device="cpu"``).

The neural models' parameters cross through a pickle in the JAX layout
(``convert.py``): the same weights score the same states within 1e-5 of
the largest score, with the same top 16 (TabNet in float64). Fits of the neural models are not
compared, since their random streams differ by package (``torch.Generator``
against JAX keys); the rows and labels each fit is given are, exactly. The
tree models grow on the in-repo host booster in both packages (the JAX
package's ``gbdt`` is pinned to its "native" backend, the one the port
runs, since this host has sklearn but no xgboost), so their predictions
after the same update agree to 1e-6. The JAX side runs its Python GA and
featuriser, and every policy evolves 48 states per generation.
"""

import pickle

import numpy as np
import pytest
import torch

from _torch_parity import (
    pin_jax_python_paths,
    pin_port_python_paths,
    rel_err,
    small_ga_population,
    to_jax,
)
from vae_extent_search_tpu.models import gbdt as jgbdt
from vae_extent_search_tpu.models import segment as jseg
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu.records import task as jtask
from vae_extent_search_tpu.records import workload as jwl
from vae_extent_search_tpu.search import cost_model as jcm
from vae_extent_search_tpu.search import measure as jm
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu.search import task_scheduler as jts
from vae_extent_search_tpu_torch.convert import params_to_numpy, tree_leaves
from vae_extent_search_tpu_torch.models import gbdt as tgbdt
from vae_extent_search_tpu_torch.models import segment as tseg
from vae_extent_search_tpu_torch.models import variants as tvar
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records import task as ttask
from vae_extent_search_tpu_torch.records import workload as twl
from vae_extent_search_tpu_torch.search import cost_model as tcm
from vae_extent_search_tpu_torch.search import measure as tm
from vae_extent_search_tpu_torch.search import sketch as tsketch
from vae_extent_search_tpu_torch.search import task_scheduler as tts

KINDS = ["mlp", "vae", "gbdt", "xgb", "lgb", "lstm", "mha", "tabnet"]
NEURAL = ["mlp", "vae", "lstm", "mha", "tabnet"]
TOL = 1e-5
TOP = 16

PORT = dict(cm=tcm, task=ttask, wl=twl, m=tm, sketch=tsketch, serde=tserde,
            ts=tts)
JAX = dict(cm=jcm, task=jtask, wl=jwl, m=jm, sketch=jsketch, serde=jserde,
           ts=jts)


def _jax_gbdt_native(mp):
    """The JAX package's tree models on its in-repo booster."""
    orig = jgbdt.GBDTModelInternal.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.backend, self.use_xgb = "native", False
    mp.setattr(jgbdt.GBDTModelInternal, "__init__", init)


@pytest.fixture(autouse=True)
def python_paths():
    mp = pytest.MonkeyPatch()
    pin_jax_python_paths(mp)
    pin_port_python_paths(mp)
    small_ga_population(mp, 48)
    _jax_gbdt_native(mp)
    yield
    mp.undo()


def _tasks(pkg, sizes=(32, 48, 64, 96)):
    return [pkg["task"].SearchTask(pkg["wl"].make_workload_key(
        "matmul_auto_scheduler_test", (n, n, n)), "llvm") for n in sizes]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A measured log of the four matmuls (32 analytic records each) and
    64 states of the 64^3 task in each package (equal step lists)."""
    d = tmp_path_factory.mktemp("cost_model")
    log = str(d / "measured.json")
    measurer = tm.ProgramMeasurer(tm.EmptyBuilder(),
                                  tm.AnalyticRunner(noise=0.1),
                                  callbacks=[tm.RecordToFile(log)])
    for i, task in enumerate(_tasks(PORT)):
        measurer.measure(task, tsketch.make_states(
            task, 32, evo_population=64, min_population=20, seed=3 + i))
    mp = pytest.MonkeyPatch()
    pin_jax_python_paths(mp)
    pin_port_python_paths(mp)
    try:
        states = {}
        for side, pkg in (("port", PORT), ("jax", JAX)):
            task = _tasks(pkg, (64,))[0]
            states[side] = (task, pkg["sketch"].make_states(
                task, 64, evo_population=64, min_population=20, seed=5))
    finally:
        mp.undo()
    assert [s.to_str() for s in states["port"][1]] == \
        [s.to_str() for s in states["jax"][1]]
    return {"log": log, "dir": d, **states}


def _model(pkg, kind, **kw):
    if pkg is PORT:
        kw["device"] = "cpu"
    return pkg["cm"].LearnedCostModel(kind=kind, **kw)


def _top(scores):
    return list(np.argsort(-np.asarray(scores), kind="stable")[:TOP])


# ---------------------------------------------------------------------------
# the contract of each kind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("embed", [True, False], ids=["embed", "no-embed"])
@pytest.mark.parametrize("kind", KINDS)
def test_embedding_contract_equal(kind, embed):
    port, ref = (_model(pkg, kind, use_workload_embedding=embed)
                 for pkg in (PORT, JAX))
    got = (port._embed_total, port.use_workload_embedding,
           port.internal.use_workload_embedding,
           port.internal.workload_embed_total_dim,
           getattr(port.internal, "in_dim", None))
    want = (ref._embed_total, ref.use_workload_embedding,
            ref.internal.use_workload_embedding,
            ref.internal.workload_embed_total_dim,
            getattr(ref.internal, "in_dim", None))
    assert got == want
    assert got[0] == (10 if kind in NEURAL else 9)
    assert port.device == "cpu" and port.internal.device == "cpu"


@pytest.mark.parametrize("kind", KINDS)
def test_unfit_model_scores_equal(kind, corpus):
    """An unfit model scores from default_rng(0), in both packages."""
    port, ref = _model(PORT, kind), _model(JAX, kind)
    assert not port._is_fit() and not ref._is_fit()
    got = port.predict(*corpus["port"])
    assert np.array_equal(got, ref.predict(*corpus["jax"]))
    assert np.array_equal(port.predict_on_feature_list(None, [0] * 5),
                          ref.predict_on_feature_list(None, [0] * 5))


def _capture(model, calls):
    def fit_base(features, labels, *a, **kw):
        calls.append(([np.asarray(f) for f in features],
                      np.asarray(labels)))
    model.internal.fit_base = fit_base


@pytest.mark.parametrize("kind", KINDS)
def test_update_keeps_the_same_rows_and_labels(kind, corpus):
    """update() hands the same embedded rows and throughput labels to the
    internal; below num_warmup_sample it refits nothing."""
    recs = {"port": tserde.load_records(corpus["log"]),
            "jax": jserde.load_records(corpus["log"])}
    fits = {}
    for side, pkg in (("port", PORT), ("jax", JAX)):
        m = _model(pkg, kind, num_warmup_sample=100)
        fits[side] = []
        _capture(m, fits[side])
        r = recs[side]
        m.update([x.inp for x in r[:64]], [x.res for x in r[:64]])
        assert fits[side] == []                # 64 < 100: the gate holds
        m.update([x.inp for x in r[64:]], [x.res for x in r[64:]])
        assert len(fits[side]) == 1
    (gf, gl), (wf, wl) = fits["port"][0], fits["jax"][0]
    assert len(gf) == len(wf) == 128 and np.array_equal(gl, wl)
    assert all(np.array_equal(a, b) for a, b in zip(gf, wf))
    assert gf[0].shape[1] == 164 + (10 if kind in NEURAL else 9)


def test_update_with_too_few_rows_refits_nothing(corpus):
    """Fewer than 8 lowerable programs: no refit, in both packages."""
    for pkg in (PORT, JAX):
        m = _model(pkg, "mlp")
        calls = []
        _capture(m, calls)
        recs = pkg["serde"].load_records(corpus["log"], max_lines=7)
        m.update([r.inp for r in recs], [r.res for r in recs])
        m.update(None, None)
        assert calls == [] and len(m._inputs) == 7


# ---------------------------------------------------------------------------
# the same weights, the same scores
# ---------------------------------------------------------------------------


def _small_internal(kind):
    """A narrow port internal of ``kind`` on the CPU."""
    if kind == "mlp":
        m = tseg.MLPModelInternal(in_dim=174, hidden_dim=16, n_epoch=4,
                                  device="cpu")
    elif kind == "vae":
        m = tseg.SegmentVAEModelInternal(in_dim=174, hidden_dim=16,
                                         latent_dim=8, vae_epochs=3,
                                         reg_epochs=3, device="cpu")
    else:
        m = tvar.SequenceModelInternal(kind, in_dim=174, hidden_dim=16,
                                       n_epoch=2, device="cpu")
    m.use_workload_embedding, m.workload_embed_total_dim = True, 10
    return m


@pytest.fixture(scope="module")
def saved(corpus):
    """Each neural kind fit briefly in the port and saved; tree kinds fit
    in both packages (30 rounds)."""
    out = {}
    for kind in NEURAL:
        m = tcm.LearnedCostModel(_small_internal(kind), kind)
        m.update_from_file(corpus["log"])
        assert m._is_fit()
        path = str(corpus["dir"] / f"{kind}.pkl")
        m.save(path)
        out[kind] = path
    return out


@pytest.mark.parametrize("kind", NEURAL)
def test_same_weights_same_scores(kind, corpus, saved):
    port = tcm.LearnedCostModel.load(saved[kind], kind, device="cpu")
    ref = jcm.LearnedCostModel.load(saved[kind], kind)
    assert (port.use_workload_embedding, port._embed_total) == \
        (ref.use_workload_embedding, ref._embed_total) == (True, 10)
    if kind == "tabnet":
        got, want = _tabnet_float64(port, ref, *corpus["port"])
    else:
        got = port.predict(*corpus["port"])
        want = ref.predict(*corpus["jax"])
    assert np.isfinite(got).all() and got.std() > 0
    assert rel_err(got, want) < TOL
    assert _top(got) == _top(want)


def _tabnet_float64(port, ref, task, states):
    """TabNet's scores with both packages' parameters cast to float64. In
    float32 its seven entmax masks move a score by ~1e-3 where rounding
    puts an input on the other side of a support boundary, in either
    package against float64 (tests/test_torch_variants.py holds the
    forward the same way)."""
    import jax
    import jax.numpy as jnp

    from vae_extent_search_tpu.models import variants as jv
    from vae_extent_search_tpu_torch.convert import tree_map
    from vae_extent_search_tpu_torch.features.per_store import (
        get_per_store_features_from_states,
    )

    feats = get_per_store_features_from_states(states, task)
    feats = port._embed(feats, [task.workload_key] * len(feats))
    m = port.internal
    m.params = tree_map(lambda t: t.double(), m.params)
    m.bn_state = tree_map(lambda t: t.double(), m.bn_state)
    got = m.predict_on_features(feats)
    j = ref.internal
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        x, mask = jv.pad_segments([f / j.fea_norm_vec for f in feats])
        want = np.asarray(jv.tabnet_forward(f64(j.params), f64(j.bn_state),
                                            f64(x), jnp.asarray(mask))[0])
    return got, want


def test_same_weights_same_ga(corpus, saved):
    """One evolutionary search per package with the same MLP: the same
    states come out, best first."""
    out = []
    for side, pkg in (("port", PORT), ("jax", JAX)):
        kw = {"device": "cpu"} if pkg is PORT else {}
        model = pkg["cm"].LearnedCostModel.load(saved["mlp"], "mlp", **kw)
        task, states = corpus[side]
        policy = pkg["sketch"].SketchPolicy(task, model, seed=9)
        out.append([s.to_str() for s in
                    policy.evolutionary_search(states[:20], TOP)])
    assert out[0] == out[1] and len(out[0]) == TOP


@pytest.mark.parametrize("kind", ["gbdt", "xgb", "lgb"])
def test_tree_models_after_the_same_update_equal(kind, corpus):
    out = []
    for side, pkg in (("port", PORT), ("jax", JAX)):
        m = _model(pkg, kind)
        m.internal.n_estimators = 30
        m.update_from_file(corpus["log"])
        out.append(m.predict(*corpus[side]))
    assert np.isfinite(out[0]).all() and out[0].std() > 0
    assert rel_err(out[0], out[1]) < 1e-6
    assert _top(out[0]) == _top(out[1])


@pytest.mark.parametrize("kind", ["mlp", "vae", "gbdt"])
def test_jax_pickles_load_in_the_port(kind, corpus):
    """A model the JAX package fit and saved loads through the port's
    LearnedCostModel.load(..., device="cpu") and scores alike."""
    if kind == "mlp":
        internal = jseg.MLPModelInternal(in_dim=174, hidden_dim=16,
                                         n_epoch=3)
    elif kind == "vae":
        internal = jseg.SegmentVAEModelInternal(in_dim=174, hidden_dim=16,
                                                latent_dim=8, vae_epochs=2,
                                                reg_epochs=2)
    else:
        internal = jgbdt.GBDTModelInternal(n_estimators=20)
        internal.workload_embed_total_dim = 9
    if kind != "gbdt":
        internal.workload_embed_total_dim = 10
    internal.use_workload_embedding = True
    ref = jcm.LearnedCostModel(internal, kind)
    ref.update_from_file(corpus["log"])
    path = str(corpus["dir"] / f"jax_{kind}.pkl")
    ref.save(path)
    port = tcm.LearnedCostModel.load(path, kind, device="cpu")
    if kind == "gbdt":
        assert isinstance(port.internal, tgbdt.GBDTModelInternal)
        assert port.internal.device == "cpu"
    got, want = port.predict(*corpus["port"]), ref.predict(*corpus["jax"])
    assert np.isfinite(got).all() and got.std() > 0
    assert rel_err(got, want) < (1e-6 if kind == "gbdt" else TOL)
    assert _top(got) == _top(want)


def test_a_jax_pickle_of_another_tree_backend_is_refused(corpus):
    internal = jgbdt.GBDTModelInternal(n_estimators=2)
    internal.backend = "sklearn"
    path = str(corpus["dir"] / "sk.pkl")
    with open(path, "wb") as f:
        pickle.dump(internal, f)
    with pytest.raises(ValueError, match="in-repo booster only"):
        tcm.LearnedCostModel.load(path, "gbdt", device="cpu")


# ---------------------------------------------------------------------------
# PlusMix
# ---------------------------------------------------------------------------


def test_plus_mix_mlp_equals_jax(corpus, saved):
    """The same base: equal residual labels for the delta, a frozen base,
    and, with the port's delta weights carried over, combined scores
    within 1e-5; in the port combined == base + delta exactly."""
    recs = tserde.load_records(corpus["log"])
    jrecs = jserde.load_records(corpus["log"])
    port_base = tcm.LearnedCostModel.load(saved["mlp"], "mlp", device="cpu")
    ref_base = jcm.LearnedCostModel.load(saved["mlp"], "mlp")
    before = params_to_numpy(port_base.internal.params)
    port = tcm.PlusMixCostModel(port_base)
    ref = jcm.PlusMixCostModel(ref_base)
    assert port.device == "cpu"
    assert (port.internal.hidden_dim, port.internal.loss_type,
            port.internal.in_dim) == (ref.internal.hidden_dim,
                                      ref.internal.loss_type,
                                      ref.internal.in_dim) == (128, "rmse",
                                                               174)
    port.internal.n_epoch = 5
    calls = {"port": [], "jax": []}
    fit = port.internal.fit_base

    def port_fit(features, labels, *a, **kw):
        calls["port"].append(np.asarray(labels))
        return fit(features, labels, *a, **kw)
    port.internal.fit_base = port_fit
    _capture(ref, calls["jax"])
    port.update([r.inp for r in recs], [r.res for r in recs])
    ref.update([r.inp for r in jrecs], [r.res for r in jrecs])
    assert rel_err(calls["port"][0], calls["jax"][0][1]) < TOL
    assert port._is_fit()
    after = params_to_numpy(port_base.internal.params)
    assert all(np.array_equal(a, b) for a, b in
               zip(tree_leaves(before), tree_leaves(after)))
    ref.internal.params = to_jax(params_to_numpy(port.internal.params))
    ref.internal.fea_norm_vec = port.internal.fea_norm_vec
    task, states = corpus["port"]
    got, want = port.predict(task, states), ref.predict(*corpus["jax"])
    assert rel_err(got, want) < TOL and _top(got) == _top(want)
    from vae_extent_search_tpu_torch.features.per_store import (
        get_per_store_features_from_states,
    )

    feats = get_per_store_features_from_states(states, task)
    keys = [task.workload_key] * len(feats)
    base = port._base_predict(feats, keys)
    delta = port.internal.predict_on_features(port._embed(feats, keys))
    assert np.array_equal(got, (base + delta).astype(np.float32))
    assert np.any(got != base)
    # the reference's delta is an rmse MLP with a sigmoid head: it cannot
    # fit the residuals below 0, which beside an MLP base are many
    assert calls["port"][0].min() < 0 and (delta > 0).all()


def test_plus_mix_tree_delta_equals_jax(corpus):
    """A gbdt base and its gbdt delta, in both packages: equal scores."""
    out = []
    for side, pkg in (("port", PORT), ("jax", JAX)):
        base = _model(pkg, "gbdt")
        base.internal.n_estimators = 20
        recs = pkg["serde"].load_records(corpus["log"])
        base.update([r.inp for r in recs[:64]], [r.res for r in recs[:64]])
        mixed = pkg["cm"].PlusMixCostModel(base, kind="gbdt")
        assert mixed._embed_total == 9
        mixed.internal.n_estimators = 20
        mixed.update([r.inp for r in recs[64:]], [r.res for r in recs[64:]])
        assert mixed._is_fit()
        out.append((mixed.predict(*corpus[side]),
                    base.predict(*corpus[side])))
    assert rel_err(out[0][0], out[1][0]) < 1e-6
    assert np.any(np.abs(out[0][0] - out[0][1]) > 1e-9)


# ---------------------------------------------------------------------------
# make_search_policies and the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,pretrained", [
    ("sketch", False), ("sketch.mlp", False), ("sketch.mlp", True),
    ("sketch.mlp-no-update", True), ("sketch.gbdt-no-update", False)])
def test_make_search_policies_equals_jax(spec, pretrained, corpus, saved):
    got = []
    for pkg in (PORT, JAX):
        tasks = _tasks(pkg)
        kw = {"device": "cpu"} if pkg is PORT else {}
        load = saved["mlp"] if pretrained else None
        policies, model = pkg["cm"].make_search_policies(
            spec, tasks, seed=4, load_model_file=load,
            num_measures_per_round=16, **kw)
        calls = []
        if hasattr(model, "internal"):
            model.internal.fit_base = lambda *a, **k: calls.append(1)
        recs = pkg["serde"].load_records(corpus["log"])
        model.update([r.inp for r in recs], [r.res for r in recs])
        got.append((type(model).__name__,
                    getattr(model, "num_warmup_sample", None),
                    [p.task.workload_key for p in policies],
                    [p.rng.random() for p in policies],
                    all(p.cost_model is model for p in policies),
                    len(calls), len(getattr(model, "_inputs", []))))
    assert got[0] == got[1]
    name, warmup, _, _, _, n_fits, n_inputs = got[0]
    assert name == ("RandomCostModel" if spec == "sketch"
                    else "LearnedCostModel")
    if spec == "sketch":
        return
    assert warmup == (64 if pretrained else 0)
    frozen = spec.endswith("-no-update")
    assert (n_fits, n_inputs) == ((0, 0) if frozen else (1, 128))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the refusal cannot "
                           "show")
def test_learned_models_need_cuda_unless_told_cpu(saved):
    """CUDA is the default; without a card every learned route raises and
    none moves to the CPU by itself. The random model takes no device."""
    msg = "torch.cuda.is_available"
    with pytest.raises(RuntimeError, match=msg):
        tcm.LearnedCostModel(kind="mlp")
    with pytest.raises(RuntimeError, match=msg):
        tcm.LearnedCostModel.load(saved["mlp"], "mlp")
    with pytest.raises(RuntimeError, match=msg):
        tcm.make_search_policies("sketch.gbdt", _tasks(PORT))
    # the PlusMix delta lives where its base does
    base = tcm.LearnedCostModel.load(saved["mlp"], "mlp", device="cpu")
    assert tcm.PlusMixCostModel(base).internal.device == "cpu"
    policies, model = tcm.make_search_policies("sketch", _tasks(PORT))
    assert isinstance(model, tsketch.RandomCostModel) and len(policies) == 4


# ---------------------------------------------------------------------------
# transfer_tune
# ---------------------------------------------------------------------------


def _transfer(pkg, side, corpus, base_pkl):
    """JAX tests/test_pipeline.py's setting: the four matmuls,
    round-robin, 32 trials, 8 per round, a gbdt base pretrained on 32
    analytic measurements of task 0."""
    log = str(corpus["dir"] / f"transfer_{side}.json")
    opts = pkg["task"].TuningOptions(
        num_measure_trials=32, num_measures_per_round=8,
        builder=pkg["m"].EmptyBuilder(),
        runner=pkg["m"].AnalyticRunner(noise=0.1),
        measure_callbacks=[pkg["m"].RecordToFile(log)])
    kw = {"device": "cpu"} if pkg is PORT else {}
    sched = pkg["ts"].TaskScheduler(_tasks(pkg), strategy="round-robin",
                                    callbacks=[], **kw)
    pkg["ts"].transfer_tune(sched, opts, search_policy="sketch.gbdt",
                            load_model_file=base_pkl)
    return sched, log


def _jax_base(corpus, name):
    """A gbdt base that the JAX package fit on the first 32 records of
    the log and saved: each package's transfer_tune loads it into its own
    booster (the port through its unpickler of JAX pickles)."""
    recs = jserde.load_records(corpus["log"])[:32]
    base = _model(JAX, "gbdt")
    base.update([r.inp for r in recs], [r.res for r in recs])
    path = str(corpus["dir"] / name)
    base.save(path)
    return path


def test_transfer_tune_gbdt_equals_jax(corpus):
    base_pkl = _jax_base(corpus, "base_gbdt.pkl")
    port, p_log = _transfer(PORT, "port", corpus, base_pkl)
    ref, j_log = _transfer(JAX, "jax", corpus, base_pkl)
    got = [(r.inp.task.workload_key, r.inp.step_records, r.res.costs)
           for r in tserde.load_records(p_log)]
    want = [(r.inp.task.workload_key, r.inp.step_records, r.res.costs)
            for r in jserde.load_records(j_log)]
    # stage 1 (tasks 0 and 1) and stage 2 alike, bit for bit
    assert got == want and len(got) >= 32
    assert np.array_equal(port.best_costs, ref.best_costs)
    assert port.ct == ref.ct >= 32
    mixed = port.transfer_model
    assert isinstance(mixed, tcm.PlusMixCostModel) and mixed._is_fit()
    # each package ran its own booster, the base loaded from the JAX pickle
    for model, gbdt in ((mixed, tgbdt), (ref.transfer_model, jgbdt)):
        assert isinstance(model.base.internal, gbdt.GBDTModelInternal)
        assert isinstance(model.internal, gbdt.GBDTModelInternal)
    # the frozen base predicts exactly like a pristine reload
    task, states = corpus["port"]
    from vae_extent_search_tpu_torch.features.per_store import (
        get_per_store_features_from_states,
    )

    feats = get_per_store_features_from_states(states, task)
    keys = [task.workload_key] * len(feats)
    fresh = tcm.LearnedCostModel.load(base_pkl, "gbdt", device="cpu")
    assert np.array_equal(
        mixed.base.internal.predict_on_features(
            mixed.base._embed(feats, keys)),
        fresh.internal.predict_on_features(fresh._embed(feats, keys)))
    combined = mixed.predict_on_feature_list(task, feats)
    assert np.any(np.abs(combined - mixed._base_predict(feats, keys)) > 1e-9)
    assert np.array_equal(combined, ref.transfer_model.predict(
        *corpus["jax"]))


def test_transfer_tune_no_update_fits_the_delta_from_the_log(corpus):
    """A frozen stage-1 model collects nothing: the delta fits on the
    measurement log instead, in both packages alike."""
    base_pkl = _jax_base(corpus, "base_gbdt_frozen.pkl")
    out = []
    for side, pkg in (("port", PORT), ("jax", JAX)):
        log = str(corpus["dir"] / f"frozen_{side}.json")
        opts = pkg["task"].TuningOptions(
            num_measure_trials=16, num_measures_per_round=8,
            builder=pkg["m"].EmptyBuilder(),
            runner=pkg["m"].AnalyticRunner(noise=0.1),
            measure_callbacks=[pkg["m"].RecordToFile(log)])
        kw = {"device": "cpu"} if pkg is PORT else {}
        sched = pkg["ts"].TaskScheduler(_tasks(pkg), strategy="round-robin",
                                        callbacks=[], **kw)
        pkg["ts"].transfer_tune(sched, opts,
                                search_policy="sketch.gbdt-no-update",
                                load_model_file=base_pkl)
        mixed = sched.transfer_model
        out.append((len(mixed._inputs), mixed._is_fit(),
                    mixed.predict(*corpus[side])))
    assert out[0][:2] == out[1][:2] and out[0][0] >= 16 and out[0][1]
    assert rel_err(out[0][2], out[1][2]) < 1e-6
