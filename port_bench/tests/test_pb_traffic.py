"""The inputs depend on the seed alone."""

import json

import numpy as np
import torch

from port_bench import workload
from pb_helpers import REPO, SMALL_TRAFFIC

CFG = json.loads((REPO / "port_bench/configs/vae_extent.json").read_text())
BIG = 2 ** 31 + 12345


def test_pool_is_a_function_of_the_seed():
    a = workload.draw_pool(CFG, SMALL_TRAFFIC, BIG, "cpu", chunk=300)
    b = workload.draw_pool(CFG, SMALL_TRAFFIC, BIG, "cpu", chunk=1024)
    c = workload.draw_pool(CFG, SMALL_TRAFFIC, BIG + 1, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (SMALL_TRAFFIC["pool_rows"], CFG["input_dim"])
    assert torch.isfinite(a).all()


def test_pool_columns_take_the_frozen_columns_values():
    with np.load(workload.HERE / CFG["pool_file"]) as z:
        real = z["features"]
    a = workload.draw_pool(CFG, SMALL_TRAFFIC, 7, "cpu").numpy()
    for j in range(real.shape[1]):
        assert len(np.unique(a[:, j])) <= len(np.unique(real[:, j]))


def test_weights_and_episodes_are_functions_of_the_seed():
    w1 = workload.WeightSource(CFG, BIG, "cpu")
    w2 = workload.WeightSource(CFG, BIG, "cpu")
    p1, p2 = w1.draw(), w2.draw()
    assert torch.equal(p1["encoder"][0]["w"], p2["encoder"][0]["w"])
    assert p1["encoder"][0]["w"].shape == (17, 256)
    assert p1["cost_predictor"][2]["w"].shape == (256, 1)
    # each phase gets new tensors with new values
    q1 = w1.draw()
    assert not torch.equal(q1["fc_mu"]["w"], p1["fc_mu"]["w"])
    bound = (3.0 / 256) ** 0.5
    assert q1["fc_mu"]["w"].abs().max() <= bound
    e1 = workload.episode_start(SMALL_TRAFFIC, BIG, 3)
    e2 = workload.episode_start(SMALL_TRAFFIC, BIG, 3)
    assert np.array_equal(e1, e2)
    assert len(set(e1.tolist())) == SMALL_TRAFFIC["initial_measured"]
    assert not np.array_equal(e1, workload.episode_start(SMALL_TRAFFIC,
                                                         BIG, 4))
