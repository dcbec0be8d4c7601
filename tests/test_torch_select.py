"""One selection phase of the PyTorch port against the JAX package:
same parameters, same injected dropout bits, same center buffer. The JAX
side runs its fused Pallas head in interpret mode (the
``fused_interpret`` seam), the port the kernel's plain version; the
selected indices, their validity and the new remaining mask are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_predictor_params, to_jax, to_torch
from vae_extent_search_tpu.search import select as js
from vae_extent_search_tpu_torch.search import select as ts

N, D, HID, LAT, HP, T = 600, 17, 128, 16, 128, 4
SEL = dict(num_select=32, T_mc=T, topk_factor=5, grad_num=2, rand_num=0,
           max_centers=256)


def _phase(seed, tied, gate, n_meas=64, centers="buffer", **sel_kw):
    rng = np.random.default_rng(seed)
    params = np_predictor_params(rng, D, HID, LAT, HP)
    x = rng.standard_normal((N, D)).astype(np.float32)
    if tied:
        # duplicate rows score exactly alike: every top-k over them is a
        # tie that only the lowest-index-first rule decides
        x[1::2] = x[0::2]
    bits = rng.integers(0, 2 ** 32, (T, N, HP), dtype=np.uint32)
    meas = rng.choice(N, n_meas, replace=False)
    used = np.zeros(N, bool)
    used[meas] = True
    cidx = np.zeros(SEL["max_centers"], np.int64)
    cidx[:n_meas] = meas
    cval = np.arange(SEL["max_centers"]) < n_meas
    buf = centers == "buffer"
    fused = sel_kw.get("w_unc", 0.3) > 0

    sel_j, val_j, rem_j, _ = js.select_programs(
        to_jax(params), jnp.asarray(x), jnp.asarray(used),
        jnp.asarray(~used), jax.random.PRNGKey(0),
        js.SelectionConfig(fused_interpret=True, **SEL, **sel_kw),
        gate_uncertainty_to_remaining=gate,
        mask_bits=jnp.asarray(bits) if fused else None,
        center_idx=jnp.asarray(cidx.astype(np.int32)) if buf else None,
        center_valid=jnp.asarray(cval) if buf else None)
    with torch.no_grad():
        sel_t, val_t, rem_t, _ = ts.select_programs(
            to_torch(params), torch.as_tensor(x), torch.as_tensor(used),
            torch.as_tensor(~used), torch.Generator().manual_seed(0),
            ts.SelectionConfig(**SEL, **sel_kw),
            gate_uncertainty_to_remaining=gate,
            mask_bits=torch.as_tensor(bits) if fused else None,
            center_idx=torch.as_tensor(cidx) if buf else None,
            center_valid=torch.as_tensor(cval) if buf else None)
    return ((np.asarray(sel_j), np.asarray(val_j), np.asarray(rem_j)),
            (sel_t.numpy(), val_t.numpy(), rem_t.numpy()))


def _assert_same(phase):
    (sj, vj, rj), (st, vt, rt) = phase
    assert np.array_equal(vt, vj)
    assert np.array_equal(st[vt], sj[vj])
    assert np.array_equal(rt, rj)
    assert vt.sum() == SEL["num_select"]


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_select_programs_matches_jax(tied, gate):
    _assert_same(_phase(0, tied, gate))


def test_select_programs_mask_derived_centers():
    """Without the compact center buffer the diversity stage takes its
    centers from used_mask | picked (first_k_true)."""
    _assert_same(_phase(1, False, False, centers="mask"))


@pytest.mark.parametrize("tied", [False, True])
def test_select_programs_unfused_path(tied):
    """No uncertainty budget: the fused-head gate refuses on both sides
    and the phase runs the unfused path (encoder, head, autograd z-grad
    norms, diversity on mu), which draws no random numbers it uses."""
    _assert_same(_phase(2, tied, False, w_cost=0.5, w_unc=0.0, w_div=0.5))


def test_random_select_distinct_remaining():
    rem = torch.zeros(50, dtype=torch.bool)
    rem[10:30] = True
    idx, valid = ts.random_select(torch.Generator().manual_seed(0), rem, 25)
    picked = idx[valid].tolist()
    assert len(picked) == 20 == len(set(picked))
    assert all(10 <= i < 30 for i in picked)
    assert valid[20:].sum() == 0


def test_masked_top_k_ties_lowest_index_first():
    scores = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, 0.5])
    mask = torch.tensor([True, True, False, True, True, True])
    idx, valid = ts.masked_top_k(scores, mask, 4)
    ref_idx, ref_valid = js.masked_top_k(jnp.asarray(scores.numpy()),
                                         jnp.asarray(mask.numpy()), 4)
    assert idx.tolist() == np.asarray(ref_idx).tolist() == [1, 4, 3, 0]
    assert valid.tolist() == np.asarray(ref_valid).tolist()
    # k beyond the pool pads invalid
    idx, valid = ts.masked_top_k(scores, mask, 8)
    assert valid.tolist() == [True] * 5 + [False] * 3


def test_scatter_and_first_k_true():
    mask = torch.zeros(8, dtype=torch.bool)
    idx = torch.tensor([2, 5, 2, 0])
    valid = torch.tensor([True, True, False, False])
    on = ts.scatter_set(mask, idx, valid)
    assert on.tolist() == [False, False, True, False, False, True, False,
                           False]
    assert ts.scatter_unset(on, idx[:1], valid[:1]).tolist() == [
        False] * 5 + [True, False, False]
    assert ts.first_k_true(on, 3, fill=7).tolist() == [2, 5, 7]
    ref = js.first_k_true(jnp.asarray(on.numpy()), 3, fill=7)
    assert np.asarray(ref).tolist() == [2, 5, 7]


@pytest.mark.parametrize("n,k,density", [
    (50, 8, 0.3), (50, 8, 0.0), (50, 8, 1.0), (5, 12, 0.6), (300, 256, 0.5),
])
def test_first_k_true_matches_the_nonzero_compaction(n, k, density):
    """The sync-free compaction against the nonzero it replaced: the
    first k set indices in order, ``fill`` past the set ones (k past n
    too)."""
    mask = torch.as_tensor(np.random.default_rng(n + k).random(n) < density)
    on = torch.nonzero(mask).flatten()[:k].tolist()
    want = on + [n] * (k - len(on))
    assert ts.first_k_true(mask, k, fill=n).tolist() == want
    ref = js.first_k_true(jnp.asarray(mask.numpy()), k, fill=n)
    assert np.asarray(ref).tolist() == want


def test_budget_split_matches_jax():
    for kw in (dict(num_select=32), dict(num_select=64, w_cost=0.4,
                                         w_unc=0.3, w_div=0.3, grad_num=4),
               dict(num_select=17, rand_num=3)):
        a, b = ts.SelectionConfig(**kw), js.SelectionConfig(**kw)
        assert (a.budget, a.n_cost, a.n_unc, a.n_div) == (
            b.budget, b.n_cost, b.n_unc, b.n_div)
