"""The SegmentVAE half of the port's ``models/segment.py`` against the JAX
package: the encoder under its three statistics modes, the masked moments,
the frozen statistics, the evaluation, the cost head, the learning-rate
schedule, the program flattener, and the two stochastic losses term by
term with the JAX run's own noise and dropout masks handed to the port
(JAX's threefry and torch's Philox never draw the same numbers).

Tolerance 1e-5 relative to the largest reference value (float32, sums in
another order); 1e-4 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    np_segment_predictor_params,
    np_segment_vae_params,
    ragged_programs,
    rel_err,
    to_jax,
    to_torch,
    tree_rel_err,
)
from vae_extent_search_tpu.models import segment as js
from vae_extent_search_tpu_torch.models import load_model_pickle
from vae_extent_search_tpu_torch.models import segment as ts

TOL = 1e-5
GRAD_TOL = 1e-4
IN, HID, LAT = 12, 24, 6


def flat(seed=0, n=40):
    rng = np.random.default_rng(seed)
    feats = ragged_programs(rng, n, IN, 1, 7)
    labels = rng.random(n).astype(np.float32)
    norm = js.compute_fea_norm_vec(feats)
    j = js._flatten_programs(feats, labels, norm, seg_bucket=16,
                             row_bucket=64)
    t = ts._flatten_programs(feats, labels, norm, seg_bucket=16,
                             row_bucket=64)
    return rng, feats, j, t


def test_flatten_programs_equal():
    _, feats, j, t = flat()
    assert j[4] == t[4] == 48
    for a, b in zip(j[:4], t[:4]):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())
    offs = t[5].numpy()
    assert offs.dtype == np.int32 and offs.shape == (49,)
    sizes = [len(f) for f in feats]
    assert np.array_equal(offs[:41], np.concatenate([[0], np.cumsum(sizes)]))
    assert (offs[41:] == sum(sizes)).all()
    # labels None -> zeros (the predict path)
    t2 = ts._flatten_programs(feats, None, np.ones(IN, np.float32))
    assert not t2[2].any() and t2[4] == 256 and t2[0].shape == (4096, IN)


@pytest.mark.parametrize("mode", ["batch", "stats_valid", "norm_stats"])
def test_segment_vae_encode_matches_jax(mode):
    rng, _, j, t = flat(1)
    params = np_segment_vae_params(rng, IN, HID, LAT)
    jkw, tkw = {}, {}
    if mode == "stats_valid":
        jkw["stats_valid"], tkw["stats_valid"] = j[3], t[3]
    if mode == "norm_stats":
        mean = rng.normal(size=(1, HID)).astype(np.float32)
        var = rng.random((1, HID)).astype(np.float32) + 0.1
        jkw["norm_stats"] = (jnp.asarray(mean), jnp.asarray(var))
        tkw["norm_stats"] = (torch.as_tensor(mean), torch.as_tensor(var))
    ref = js.segment_vae_encode(to_jax(params), j[0], j[1], j[4], **jkw)
    for offsets in (t[5], None):
        got = ts.segment_vae_encode(to_torch(params), t[0], t[1], t[4],
                                    offsets=offsets, **tkw)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and rel_err(g.numpy(), r) < TOL
    # the predictor's encoder is the same function on its own keys
    pp = np_segment_predictor_params(rng, IN, HID, LAT, 16)
    ref = js.segment_predictor_encode(to_jax(pp), j[0], j[1], j[4], **jkw)
    got = ts.segment_predictor_encode(to_torch(pp), t[0], t[1], t[4],
                                      offsets=t[5], **tkw)
    for g, r in zip(got, ref):
        assert rel_err(g.numpy(), r) < TOL


def test_masked_moments_and_norm_stats_match_jax():
    rng, _, j, t = flat(2)
    seg = rng.normal(size=(48, HID)).astype(np.float32)
    ref = js._masked_moments(jnp.asarray(seg), j[3])
    got = ts._masked_moments(torch.as_tensor(seg), t[3])
    for g, r in zip(got, ref):
        assert g.shape == (1, HID) and rel_err(g.numpy(), r) < TOL
    # no valid row at all: the denominator is floored at 1
    none = torch.zeros(48, dtype=torch.bool)
    assert not ts._masked_moments(torch.as_tensor(seg), none)[0].any()
    params = np_segment_predictor_params(rng, IN, HID, LAT, 16)
    ref = js._segment_norm_stats(to_jax(params), j[0], j[1], j[3], j[4])
    got = ts._segment_norm_stats(to_torch(params), t[0], t[1], t[3], t[4],
                                 t[5])
    for g, r in zip(got, ref):
        assert rel_err(g.numpy(), r) < TOL


def test_eval_segment_vae_matches_jax():
    rng, _, j, t = flat(3)
    params = np_segment_vae_params(rng, IN, HID, LAT)
    ref = js.eval_segment_vae(to_jax(params), j[0], j[1], j[3], j[4])
    got = ts.eval_segment_vae(to_torch(params), t[0], t[1], t[3], t[4], t[5])
    assert rel_err(got[0], ref[0]) < 1e-4 and rel_err(got[1], ref[1]) < TOL


def test_segment_predict_cost_matches_jax():
    rng = np.random.default_rng(4)
    params = np_segment_predictor_params(rng, IN, HID, LAT, 16)
    z = rng.normal(size=(30, LAT)).astype(np.float32)
    ref = js.segment_predict_cost(to_jax(params), jnp.asarray(z))
    got = ts.segment_predict_cost(to_torch(params), torch.as_tensor(z))
    assert got.shape == (30,) and rel_err(got.numpy(), ref) < TOL
    # dropout: the JAX run's own keep-mask handed to the port
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, 3)
    keep = np.array(jax.random.bernoulli(keys[0], 0.75, (30, 16)))
    ref = js.segment_predict_cost(to_jax(params), jnp.asarray(z), key, 0.25)
    got = ts.segment_predict_cost(to_torch(params), torch.as_tensor(z),
                                  dropout_rate=0.25,
                                  dropout_keep=[torch.as_tensor(keep)])
    assert 0 < keep.mean() < 1 and rel_err(got.numpy(), ref) < TOL
    # a Generator draws masks of the same rate
    gen = torch.Generator().manual_seed(0)
    drawn = ts.segment_predict_cost(to_torch(params), torch.as_tensor(z),
                                    gen, 0.25)
    assert not torch.equal(drawn, ts.segment_predict_cost(
        to_torch(params), torch.as_tensor(z)))


@pytest.mark.parametrize("lr,epochs", [(2e-4, 200), (1e-3, 30), (5e-4, 95)])
def test_sgdr_schedule_values_per_epoch(lr, epochs):
    ref = js._sgdr_schedule(lr, epochs)
    got = ts._sgdr_schedule(lr, epochs)
    steps = np.arange(epochs)
    r = np.asarray([float(ref(int(s))) for s in steps])
    g = np.asarray([got(int(s)) for s in steps])
    assert np.abs(g - r).max() < 1e-6 * lr
    # restarts at 30, 90, 210: the rate is back at lr there
    for s in (0, 30, 90):
        if s < epochs:
            assert got(s) == lr


def test_segment_vae_loss_terms_match_jax_with_its_noise():
    rng, _, j, t = flat(6)
    params = np_segment_vae_params(rng, IN, HID, LAT)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, (j[4], LAT), jnp.float32))

    def jloss(p):
        return js.segment_vae_loss(p, j[0], j[1], j[4], j[3], key, 1e-2,
                                   j[3])

    (ref, (ref_r, ref_k)), gref = jax.value_and_grad(jloss, has_aux=True)(
        to_jax(params))
    tp = ts.clone_params(to_torch(params), requires_grad=True)
    got, (got_r, got_k) = ts.segment_vae_loss(
        tp, t[0], t[1], t[4], t[3], None, 1e-2, t[3], t[5],
        noise=torch.as_tensor(noise))
    got.backward()
    for g, r in ((got, ref), (got_r, ref_r), (got_k, ref_k)):
        assert rel_err(g.item(), r) < TOL
    grads = jax.tree_util.tree_map(lambda p: p.grad.numpy(), tp)
    assert tree_rel_err(grads, gref) < GRAD_TOL
    # noise set to zero: the deterministic part alone
    zero, _ = ts.segment_vae_loss(to_torch(params), t[0], t[1], t[4], t[3],
                                  None, 1e-2, t[3], t[5],
                                  noise=torch.zeros(j[4], LAT))
    assert zero.item() < got.item()
    # drawn from a Generator: finite, and not the injected value
    drawn, _ = ts.segment_vae_loss(to_torch(params), t[0], t[1], t[4], t[3],
                                   torch.Generator().manual_seed(1), 1e-2,
                                   t[3], t[5])
    assert np.isfinite(drawn.item()) and drawn.item() != got.item()


def test_segment_predictor_loss_terms_match_jax_with_its_noise():
    rng, _, j, t = flat(8)
    params = np_segment_predictor_params(rng, IN, HID, LAT, 16)
    key = jax.random.PRNGKey(9)
    k_smooth, k_drop = jax.random.split(key)
    noise = np.array(jax.random.normal(k_smooth, (j[4], LAT), jnp.float32))
    keep = np.array(jax.random.bernoulli(
        jax.random.split(k_drop, 3)[0], 0.9, (j[4], 16)))
    cfg = {"noise_std": 0.05}

    def jloss(p):
        return js.segment_predictor_loss(p, j[0], j[1], j[4], j[2], j[3],
                                         key, cfg, j[3])

    (ref, ref_aux), gref = jax.value_and_grad(jloss, has_aux=True)(
        to_jax(params))
    tp = ts.clone_params(to_torch(params), requires_grad=True)
    got, got_aux = ts.segment_predictor_loss(
        tp, t[0], t[1], t[4], t[2], t[3], None, cfg, t[3], t[5],
        noise=torch.as_tensor(noise), dropout_keep=[torch.as_tensor(keep)])
    got.backward()
    assert rel_err(got.item(), ref) < TOL
    for k in ("reg", "pair", "smooth", "kld"):
        assert rel_err(got_aux[k].item(), ref_aux[k]) < 1e-4, k
    assert float(ref_aux["smooth"]) > 0
    grads = jax.tree_util.tree_map(lambda p: p.grad.numpy(), tp)
    assert tree_rel_err(grads, gref) < GRAD_TOL


def test_load_pretrained_segment_encoder_copies():
    rng = np.random.default_rng(10)
    vae = to_torch(np_segment_vae_params(rng, IN, HID, LAT))
    pred = to_torch(np_segment_predictor_params(rng, IN, HID, LAT, 16))
    out = ts.load_pretrained_segment_encoder(pred, vae)
    for k in ("segment_encoder", "l0", "l1", "fc_mean", "fc_logvar"):
        assert tree_rel_err(out[k], jax.tree_util.tree_map(
            lambda x: x.numpy(), vae[k])) == 0.0
    assert out["fc_mean"]["w"] is not vae["fc_mean"]["w"]
    assert out["cost_predictor"] is pred["cost_predictor"]
    assert "decoder" not in out


def test_fit_segment_predictor_keeps_the_best_step():
    rng, _, _, t = flat(11)
    params = to_torch(np_segment_predictor_params(rng, IN, HID, LAT, 16))
    gen = torch.Generator().manual_seed(0)
    best, info = ts.fit_segment_predictor(
        params, t[0], t[1], t[2], t[3], gen, t[4], epochs=25,
        encoder_lr=1e-3, head_lr=1e-2, stats_valid=t[3], offsets=t[5])
    losses = info["losses"].numpy()
    assert losses.shape == (25,) and np.isfinite(losses).all()
    assert float(info["best_loss"]) == losses.min() < losses[0]
    leaves = jax.tree_util.tree_leaves(best)
    assert all(not x.requires_grad for x in leaves)
    assert tree_rel_err(best, jax.tree_util.tree_map(
        lambda x: x.numpy(), params)) > 1e-3


def test_segment_vae_model_learns_and_round_trips(tmp_path):
    """The toy of tests/test_models.py::test_segment_vae_cost_model_learns."""
    rng = np.random.default_rng(3)
    feats = [rng.random((int(rng.integers(2, 9)), 12)).astype(np.float32)
             for _ in range(96)]
    w = rng.normal(size=12).astype(np.float32)
    labels = np.asarray([f.sum(0) @ w for f in feats], np.float32)
    labels = (labels - labels.mean()) / labels.std()
    m = ts.SegmentVAEModelInternal(in_dim=12, hidden_dim=64, latent_dim=16,
                                   vae_epochs=60, reg_epochs=200,
                                   encoder_lr=1e-4, head_lr=1e-3,
                                   device="cpu")
    m.fit_base(feats, labels)
    pred = m.predict_on_features(feats)
    assert np.corrcoef(pred, labels)[0, 1] > 0.6
    # frozen batch-norm stats: scores do not depend on the predict batch
    assert np.allclose(m.predict_on_features(feats[:7]), pred[:7], atol=1e-5)
    # unlowerable states (all-zero rows) score -inf
    scored = m.predict_on_features([feats[0], np.zeros((3, 12), np.float32)])
    assert np.isfinite(scored[0]) and scored[1] == -np.inf
    path = str(tmp_path / "vae_cm.pkl")
    m.save(path)
    m2 = load_model_pickle(path, device="cpu")
    assert isinstance(m2, ts.SegmentVAEModelInternal)
    assert np.array_equal(m2.predict_on_features(feats), pred)
    # the same pickle loads in the JAX package, with equal predictions
    mj = js.SegmentVAEModelInternal.load(path)
    assert rel_err(mj.predict_on_features(feats), pred) < TOL
    # and one the JAX package saved loads here
    back = str(tmp_path / "from_jax.pkl")
    mj.save(back)
    m3 = ts.SegmentVAEModelInternal.load(back, device="cpu")
    assert rel_err(m3.predict_on_features(feats), pred) < TOL
    # a refit keeps the pretrained VAE (later phases retrain the predictor)
    vae_before = jax.tree_util.tree_map(lambda x: x.numpy().copy(),
                                        m.vae_params)
    m.reg_epochs = 5
    m.fit_base(feats, labels)
    assert tree_rel_err(m.vae_params, vae_before) == 0.0
    assert np.isfinite(m.predict_on_features(feats)).all()


def test_vae_hyperparameter_search_and_few_shot_run():
    rng, feats, _, t = flat(12)
    cfgs = [{"hidden_dim": 16, "latent_dim": 4, "beta": 1e-4, "lr": 1e-3},
            {"hidden_dim": 16, "latent_dim": 8, "beta": 1e-3, "lr": 2e-4}]
    params, best, results = ts.search_segment_vae_hyperparams(
        t[0], t[1], t[3], t[4], IN, configs=cfgs, epochs=8, offsets=t[5])
    assert len(results) == 2 and results[0]["score"] >= results[1]["score"]
    assert best == results[0] and params["fc_mean"]["w"].shape[0] == 16
    by_task = {"a": feats[:20], "b": feats[20:]}
    labels = {"a": rng.random(20), "b": rng.random(20)}
    kw = dict(in_dim=IN, hidden_dim=8, n_epoch=3, device="cpu")
    for mode in ("base_only", "fine_tune", "plus", "local"):
        models = ts.few_shot_fit(ts.MLPModelInternal, by_task, labels, mode,
                                 fine_tune_epochs=2, **kw)
        assert set(by_task) <= set(models)
        assert np.isfinite(models["a"].predict_on_features(feats[:3])).all()
    with pytest.raises(ValueError):
        ts.few_shot_fit(ts.MLPModelInternal, by_task, labels, "nope", **kw)
