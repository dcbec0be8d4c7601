"""The search slice as a whole, port against the JAX package, on the
committed conv2d pool at hidden 128, latent 16: both draw the same
initial measured set, and three phases composed from each package's
public standardize -> fit_predictor -> select_programs (deterministic
training, the same dropout bits) select the same candidates. The port's
own loop, run on the CPU with small epochs, finds the optimum."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import np_predictor_params, np_vae_params, to_jax, to_torch
from vae_extent_search_tpu.models import predictor as jp
from vae_extent_search_tpu.search import active_loop as ja
from vae_extent_search_tpu.search import select as js
from vae_extent_search_tpu_torch.data.pool import load_pool
from vae_extent_search_tpu_torch.models import predictor as tp
from vae_extent_search_tpu_torch.search import active_loop as ta
from vae_extent_search_tpu_torch.search import select as ts

HID, LAT, T, MEASURE, SEED = 128, 16, 4, 32, 2000
SEL = dict(num_select=MEASURE, T_mc=T, max_centers=512)


def test_same_initial_measured_set():
    feats, labels, _ = load_pool()
    vae = np_vae_params(np.random.default_rng(0), feats.shape[1], LAT, HID)
    # max_phases=0: the loop stops after the initial draw
    rj = ja.run_active_search(feats, labels, measure_size=MEASURE,
                              max_phases=0, latent_dim=LAT, hidden_dim=HID,
                              sampling_seed=SEED,
                              pretrained_vae_params=to_jax(vae))
    rt = ta.run_active_search(feats, labels, measure_size=MEASURE,
                              max_phases=0, latent_dim=LAT, hidden_dim=HID,
                              sampling_seed=SEED,
                              pretrained_vae_params=to_torch(vae),
                              device="cpu")
    assert [int(i) for i in rt.selected_order] == [
        int(i) for i in rj.selected_order]
    assert len(rt.selected_order) == MEASURE


def test_three_phases_select_the_same_candidates():
    feats, labels, _ = load_pool()
    xj, _ = ja.standardize(feats)
    xt, _ = ta.standardize(feats)
    assert np.array_equal(xj, xt)
    n = xt.shape[0]
    rng = np.random.default_rng(SEED)
    order = list(rng.choice(n, size=MEASURE, replace=False))
    cfg = dict(dropout=0.0, noise_std=0.0)
    X_j, y_j = jnp.asarray(xj), jnp.asarray(labels)
    X_t, y_t = torch.as_tensor(xt), torch.as_tensor(labels)
    for phase in range(3):
        prng = np.random.default_rng(100 + phase)
        params = np_predictor_params(prng, xt.shape[1], HID, LAT, HID)
        bits = prng.integers(0, 2 ** 32, (T, n, HID), dtype=np.uint32)
        used = np.zeros(n, bool)
        used[order] = True
        cidx = np.zeros(SEL["max_centers"], np.int64)
        cidx[:len(order)] = order
        cval = np.arange(SEL["max_centers"]) < len(order)
        gate = len(order) < 128

        pj, _ = jp.fit_predictor(to_jax(params), X_j, y_j,
                                 jnp.asarray(used), jax.random.PRNGKey(0),
                                 jp.PredictorConfig(**cfg), 20)
        sj, vj, rj, _ = js.select_programs(
            pj, X_j, jnp.asarray(used), jnp.asarray(~used),
            jax.random.PRNGKey(phase),
            js.SelectionConfig(fused_interpret=True, **SEL),
            gate_uncertainty_to_remaining=gate, mask_bits=jnp.asarray(bits),
            center_idx=jnp.asarray(cidx.astype(np.int32)),
            center_valid=jnp.asarray(cval))

        pt, _ = tp.fit_predictor(to_torch(params), X_t, y_t,
                                 torch.as_tensor(used),
                                 torch.Generator().manual_seed(0),
                                 tp.PredictorConfig(**cfg), 20)
        with torch.no_grad():
            st, vt, rt, _ = ts.select_programs(
                pt, X_t, torch.as_tensor(used), torch.as_tensor(~used),
                torch.Generator().manual_seed(phase),
                ts.SelectionConfig(**SEL),
                gate_uncertainty_to_remaining=gate,
                mask_bits=torch.as_tensor(bits),
                center_idx=torch.as_tensor(cidx),
                center_valid=torch.as_tensor(cval))
        sel_j = np.asarray(sj)[np.asarray(vj)]
        sel_t = st.numpy()[vt.numpy()]
        assert set(sel_t.tolist()) == set(sel_j.tolist()), phase
        assert np.array_equal(rt.numpy(), np.asarray(rj)), phase
        order += sel_t.tolist()


def test_port_search_finds_the_optimum_on_cpu():
    feats, labels, _ = load_pool()
    res = ta.run_active_search(feats, labels, measure_size=MEASURE,
                               latent_dim=LAT, hidden_dim=HID, vae_epochs=20,
                               reg_epochs=30, sampling_seed=SEED,
                               device="cpu")
    assert res.found
    assert int(np.argmax(labels)) in res.selected_order
    assert res.train_size == len(set(res.selected_order))
    assert res.train_size == MEASURE * (res.phase + 1)
    assert len(res.reg_r2_history) == res.phase
