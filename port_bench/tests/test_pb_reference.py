"""The plain reference against the port's plain path at a tiny size: the
scoring with the same dropout words, the selection replayed on the port's
own scores, and k-center greedy."""

import json

import numpy as np
import pytest
import torch

from pb_helpers import REPO
from port_bench import workload
from port_bench.reference import model, philox, select
from vae_extent_search_tpu_torch.ops.fused_head import fused_head_stats_plain
from vae_extent_search_tpu_torch.ops.kcenter import k_center_greedy_pool_core
from vae_extent_search_tpu_torch.search.select import (SelectionConfig,
                                                       select_programs)

CFG = json.loads((REPO / "port_bench/configs/vae_extent.json").read_text())
TINY = dict(CFG, hidden_dim=32, latent_dim=8, predictor_hidden=16, T_mc=3)


def words(seed, n, T, H0):
    w = torch.stack([philox.dropout_words(seed, t, torch.arange(n), H0)
                     for t in range(T)])
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
    return w.to(torch.int32).view(torch.uint32).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_equal_the_ports_plain_version(dtype):
    n, seed = 300, 2 ** 31 + 77
    X = workload.draw_pool(TINY, {"pool_rows": n}, 5, "cpu")
    p = workload.WeightSource(TINY, 5, "cpu").draw()
    ct = getattr(torch, dtype)
    pc = {k: ([{kk: vv.to(ct) for kk, vv in l.items()} for l in v]
              if isinstance(v, list) else {kk: vv.to(ct) for kk, vv in
                                           v.items()})
          for k, v in p.items()}
    cost, gnorm, _, var = fused_head_stats_plain(
        pc["cost_predictor"], X.to(ct), TINY["T_mc"], 0.1,
        mask_bits=words(seed, n, TINY["T_mc"], 16),
        encoder=(pc["encoder"], pc["fc_mu"]))
    ref = model.scores(p, X, seed, TINY["T_mc"], 0.1, dtype, dtype,
                       block=128)
    assert torch.equal(cost, ref.cost)
    assert torch.equal(gnorm, ref.gnorm)
    torch.testing.assert_close(var, ref.mc_var, rtol=1e-4, atol=1e-6)


def test_philox_known_answers():
    # Random123's known-answer vectors for philox4x32_10
    out = philox.philox4x32_10(*[torch.tensor(v) for v in (
        0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344)],
        (0x299f31d0 << 32) | 0xa4093822)
    assert [int(o) for o in out] == [0xd16cfe09, 0x94fdcceb, 0x5001e420,
                                     0x24126ea1]
    out = philox.philox4x32_10(*[torch.tensor(0)] * 4, 0)
    assert [int(o) for o in out] == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                     0x9b00dbd8]


@pytest.mark.parametrize("gated", [True, False])
def test_replay_gives_the_ports_picks(gated):
    n = 600
    X = workload.draw_pool(TINY, {"pool_rows": n}, 9, "cpu")
    p = workload.WeightSource(TINY, 9, "cpu").draw()
    cfg = SelectionConfig(num_select=12, T_mc=3, topk_factor=3,
                          max_centers=64)
    remaining = torch.ones(n, dtype=torch.bool)
    remaining[:40] = False
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    gen.set_state(state)
    centers = torch.arange(64)
    valid = centers < 40
    idx, ok, rem, aux = select_programs(
        p, X, ~remaining, remaining, gen, cfg,
        gate_uncertainty_to_remaining=gated, center_idx=centers,
        center_valid=valid, mask_bits=words(seed, n, 3, 16))
    b = select.budget(dict(num_select=12, grad_num=2, rand_num=0,
                           w_unc=0.3, w_div=0.2, topk_factor=3,
                           uncertainty_topk=128))
    rp = select.replay(aux["cost_pred"].numpy(), aux["grad_norm"].numpy(),
                       aux["mc_var"].numpy(), remaining.numpy(), b, gated)
    fixed = b.n_cost + b.grad + b.n_unc
    want = np.concatenate([q[0] for q in rp.parts])
    assert np.array_equal(idx[:fixed].numpy(), want)
    assert ok.all()

    def norm(z):
        z = z.double()
        return (z / (z.norm(dim=-1, keepdim=True) + 1e-12)).numpy()

    zp = norm(model.encode(p, X[torch.as_tensor(rp.pool)], "float32",
                           "float32"))
    zc = norm(model.encode(p, X[torch.cat([centers[valid],
                                           idx[:fixed]])],
                           "float32", "float32"))
    li, lv = select.kcenter_greedy(zp, rp.avail, zc, b.n_div)
    assert np.array_equal(rp.pool[li], idx[fixed:].numpy())
    pos = {int(r): i for i, r in enumerate(rp.pool)}
    gaps = select.kcenter_gaps(zp, rp.avail, zc,
                               np.array([pos[int(r)] for r in idx[fixed:]]),
                               lv)
    assert gaps.max() < 1e-9


def test_kcenter_greedy_equals_the_ports():
    g = torch.Generator().manual_seed(1)
    zp = torch.randn(50, 6, generator=g, dtype=torch.float64)
    zc = torch.randn(9, 6, generator=g, dtype=torch.float64)
    avail = torch.rand(50, generator=g) > 0.3
    got, got_v = k_center_greedy_pool_core(zp, avail, zc,
                                           torch.ones(9, dtype=torch.bool), 7)
    li, lv = select.kcenter_greedy(zp.numpy(), avail.numpy(), zc.numpy(), 7)
    assert np.array_equal(got.numpy(), li) and np.array_equal(got_v, lv)
