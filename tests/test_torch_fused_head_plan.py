"""The fused cost head's launch plan (the T MC passes split over grid
groups where the candidate tiles alone do not fill the card) and the plain
version of the kernel's second pass, which adds the groups' sums. The
grouped plain statistics are held against the ungrouped plain version and
against the JAX Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_predictor_params, rel_err, to_jax, to_torch
from vae_extent_search_tpu.ops.fused_head_pallas import (
    fused_head_stats as jax_fused_head_stats,
)
from vae_extent_search_tpu_torch.ops.fused_head import (
    BM,
    fused_head_passes_plain,
    fused_head_stats,
    fused_head_stats_plain,
    launch_plan,
    mc_finish_plain,
    pass_bounds,
)

H100_SMS = 132


def _check_bounds(G, bounds, T):
    assert len(bounds) == G + 1 and bounds[0] == 0 and bounds[-1] == T
    assert all(a <= b for a, b in zip(bounds, bounds[1:]))
    if G > 1:  # group 0 runs the backward alone; every pass group has one
        assert bounds[1] == 0
        assert all(b > a for a, b in zip(bounds[1:], bounds[2:]))
        assert G - 1 <= T


@pytest.mark.parametrize("T", [10, 7, 2])
def test_bench_shape_keeps_one_group(T):
    """8,192 tiles fill many waves: one group, no second kernel."""
    assert launch_plan(262_144, T, H100_SMS) == (1, (0, T))


@pytest.mark.parametrize("n", [773, 1000])
def test_main_shape_fills_the_card(n):
    """A block on every SM but at most one per SM (a second adds ~1.3x to
    an SM's rate, measured)."""
    G, bounds = launch_plan(n, 10, H100_SMS)
    _check_bounds(G, bounds, 10)
    blocks = -(-n // BM) * G
    assert G > 1 and H100_SMS - -(-n // BM) < blocks <= H100_SMS, (G, blocks)


def test_main_shape_plan_shortens_the_longest_block():
    """At N = 773, T = 10: five groups, the backward alone in group 0 and
    3, 3, 2, 2 passes in the other four (125 blocks)."""
    assert launch_plan(773, 10, H100_SMS) == (5, (0, 0, 3, 6, 8, 10))
    # T = 7 there: pass groups of unequal length
    assert launch_plan(773, 7, H100_SMS) == (5, (0, 0, 2, 4, 6, 7))


@pytest.mark.parametrize("n", [1, 33, 200, 773, 1000, 4096, 9000, 262_144])
@pytest.mark.parametrize("T", [1, 2, 7, 10, 40])
@pytest.mark.parametrize("sms", [132, 8])
def test_groups_cover_every_pass_once(n, T, sms):
    G, bounds = launch_plan(n, T, sms)
    _check_bounds(G, bounds, T)
    tiles = -(-n // BM)
    if G > 1:
        assert tiles * G <= sms  # an SM for every block
        # no smaller G gives as short a longest block
        assert all(-(-T // (g - 1)) > -(-T // (G - 1)) for g in range(2, G))
    else:
        assert T == 1 or tiles * 2 > sms
    assert G <= 32


def test_one_pass_gives_one_group():
    for n in (32, 773, 1000):
        assert launch_plan(n, 1, H100_SMS) == (1, (0, 1))


def test_pass_bounds_refuses_what_the_kernel_does_not_take():
    assert pass_bounds(7, 4) == (0, 0, 3, 5, 7)
    for T, G in ((7, 9), (10, 0), (40, 33)):
        with pytest.raises(ValueError):
            pass_bounds(T, G)


N, D, HID, L, HP, RATE = 300, 24, 128, 16, 128, 0.1


def _inputs(seed, T):
    rng = np.random.default_rng(seed)
    params = np_predictor_params(rng, D, HID, L, HP)
    x = rng.standard_normal((N, D)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (T, N, HP), dtype=np.uint32)
    return params, x, bits


def _grouped(deltas, bounds):
    """The groups' sums s_g, s2_g [G, N], each added in pass order as a
    block of the kernel adds them."""
    s, s2 = [], []
    for a, b in zip(bounds, bounds[1:]):
        sg = torch.zeros_like(deltas[0])
        s2g = torch.zeros_like(deltas[0])
        for dt in deltas[a:b]:
            sg = sg + dt
            s2g = s2g + dt * dt
        s.append(sg)
        s2.append(s2g)
    return torch.stack(s), torch.stack(s2)


# the same sums in another grouping: float32 rounding of the order, 1e-6
# relative to each output's max |ref|
@pytest.mark.parametrize("T,G", [(10, 5), (7, 4), (10, 11), (2, 3), (10, 1),
                                 (1, 1)])
def test_finish_of_grouped_sums_matches_plain(T, G):
    params, x, bits = _inputs(4, T)
    pt = to_torch(params)
    args = (pt["cost_predictor"], torch.as_tensor(x), T, RATE)
    kw = dict(mask_bits=torch.as_tensor(bits),
              encoder=(pt["encoder"], pt["fc_mu"]))
    with torch.no_grad():
        cost, gnorm, deltas = fused_head_passes_plain(*args, **kw)
        ref = fused_head_stats_plain(*args, **kw)
    s, s2 = _grouped(deltas, pass_bounds(T, G))
    assert s.shape == (G, N)
    mean, var = mc_finish_plain(cost, s, s2, T)
    assert torch.equal(cost, ref[0]) and torch.equal(gnorm, ref[1])
    assert rel_err(mean.numpy(), ref[2].numpy()) < 1e-6
    if T > 1:
        assert rel_err(var.numpy(), ref[3].numpy()) < 1e-6
    else:
        assert torch.count_nonzero(var) == 0


def test_grouped_plain_matches_jax_kernel():
    """The split statistics at the main path's plan against the JAX
    kernel in interpret mode with the same bits (1e-5, as the ungrouped
    plain version is held in test_torch_fused_head.py)."""
    T = 10
    params, x, bits = _inputs(5, T)
    pj, pt = to_jax(params), to_torch(params)
    ref = jax_fused_head_stats(
        pj["cost_predictor"], jnp.asarray(x), 0, T=T, rate=RATE,
        interpret=True, mask_bits=jnp.asarray(bits),
        encoder=(pj["encoder"], pj["fc_mu"]), mu_layout="none")[1:]
    with torch.no_grad():
        cost, gnorm, deltas = fused_head_passes_plain(
            pt["cost_predictor"], torch.as_tensor(x), T, RATE,
            mask_bits=torch.as_tensor(bits),
            encoder=(pt["encoder"], pt["fc_mu"]))
    G, bounds = launch_plan(773, T, H100_SMS)
    mean, var = mc_finish_plain(cost, *_grouped(deltas, bounds), T)
    for name, g, r in zip(("cost", "gnorm", "mc_mean", "mc_var"),
                          (cost, gnorm, mean, var), ref):
        assert rel_err(g.numpy(), r) < 1e-5, (name, rel_err(g.numpy(), r))


def test_cpu_wrapper_takes_groups_and_runs_plain():
    """On a CPU tensor the wrapper runs the plain version whatever G."""
    T = 4
    params, x, bits = _inputs(6, T)
    pt = to_torch(params)
    enc = (pt["encoder"], pt["fc_mu"])
    xt, bt = torch.as_tensor(x), torch.as_tensor(bits)
    before = fused_head_stats.launches
    with torch.no_grad():
        got = fused_head_stats(pt["cost_predictor"], xt, 0, T=T, rate=RATE,
                               mask_bits=bt, encoder=enc, groups=3)
        ref = fused_head_stats_plain(pt["cost_predictor"], xt, T, RATE,
                                     mask_bits=bt, encoder=enc)
    assert fused_head_stats.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
