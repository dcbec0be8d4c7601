"""The port's k-center greedy step (``ops/kcenter.py``) against a plain
Python farthest-first loop, on pools of small integer latents: every
squared distance is an exact integer in float32 on either side, so the
picks must be equal, and duplicate rows make exact ties that only the
lowest-index rule decides. The ``cuda`` case runs the same pools on the
card. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kcenter.py
"""

import numpy as np
import pytest
import torch

from vae_extent_search_tpu_torch.ops.kcenter import k_center_greedy_pool_core

NEG_INF = -1e30


def plain_k_center(z_pool, avail, centers, c_valid, k):
    """Farthest-first over Python numbers: each step takes the available
    row farthest from its nearest center or earlier pick (the first such
    row on ties, none available: row 0), valid while one was available."""
    def sq(a, b):
        return sum((x - y) ** 2 for x, y in zip(a, b))

    min_sq = [min([sq(z, c) for c, ok in zip(centers, c_valid) if ok],
                  default=float("inf")) for z in z_pool]
    avail = list(avail)
    sel, val = [], []
    for _ in range(k):
        score = [m if a else NEG_INF for m, a in zip(min_sq, avail)]
        j = score.index(max(score))
        sel.append(j)
        val.append(avail[j])
        avail[j] = False
        min_sq = [min(m, sq(z, z_pool[j])) for m, z in zip(min_sq, z_pool)]
    return sel, val


def pool(seed, p=48, c=10, d=5, dup=2, n_avail=None, n_valid=None):
    """Integer latents in [-3, 3]: each distinct row ``dup`` times, some
    rows unavailable, some centers invalid (or the counts given)."""
    rng = np.random.default_rng(seed)
    z = np.repeat(rng.integers(-3, 4, (p // dup, d)), dup, axis=0)
    z = z[rng.permutation(p)]
    centers = rng.integers(-3, 4, (c, d))
    avail = rng.random(p) < 0.8
    if n_avail is not None:
        avail = np.arange(p) < n_avail
    c_valid = rng.random(c) < 0.6
    if n_valid is not None:
        c_valid = np.arange(c) < n_valid
    return z, avail, centers, c_valid


CASES = {
    "tied": dict(dup=2),
    "tied_no_center_valid": dict(dup=3, n_valid=0),
    "fewer_available_than_k": dict(dup=2, n_avail=5),
    "fewer_available_no_center_valid": dict(dup=4, n_avail=3, n_valid=0),
}


def check(device, case, seed, k=12):
    z, avail, centers, c_valid = pool(seed, **CASES[case])
    ref_sel, ref_val = plain_k_center(z.tolist(), avail.tolist(),
                                      centers.tolist(), c_valid.tolist(), k)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    sel, val = k_center_greedy_pool_core(
        t(z, torch.float32), t(avail, torch.bool), t(centers, torch.float32),
        t(c_valid, torch.bool), k)
    assert sel.device.type == val.device.type == torch.device(device).type
    assert sel.shape == val.shape == (k,)
    assert sel.tolist() == ref_sel
    assert val.tolist() == ref_val
    if "fewer" in case:
        n_avail = int(avail.sum())
        assert ref_val == [True] * n_avail + [False] * (k - n_avail)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k_center_matches_a_plain_farthest_first_loop(case, seed):
    check("cpu", case, seed)


def test_ties_go_to_the_lowest_index():
    """Rows 1 and 3 repeat row 0's latent; with no valid center every
    available row ties at +inf, so the first pick is the lowest available
    row, and its duplicates then tie at distance 0 behind every other."""
    z = torch.tensor([[0.0, 0.0], [0.0, 0.0], [2.0, 0.0], [0.0, 0.0],
                      [0.0, 2.0]])
    avail = torch.tensor([False, True, True, True, True])
    centers = torch.zeros(2, 2)
    sel, val = k_center_greedy_pool_core(
        z, avail, centers, torch.zeros(2, dtype=torch.bool), 5)
    # 1 (first of the +inf ties), then 2 and 4 tie at 4 (2 first), then
    # 3 (distance 0 to row 1), then nothing left: row 0, invalid
    assert sel.tolist() == [1, 2, 4, 3, 0]
    assert val.tolist() == [True, True, True, True, False]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_k_center_on_the_card_matches_the_plain_loop(dev, case):
    for seed in range(3):
        check(dev, case, seed)
