"""The port's ``make_states`` on GPU targets against the JAX package's
Python GA, on the CPU: 200 states of each of the five workloads of
tests/test_torch_sketch_gpu.py at two seeds, the same states in the same
order, and ``AnalyticRunner(fidelity="high")`` (the roofline's GPU
branch) pricing them bit for bit. The JAX side runs on its Python paths
(see that file).
"""

import pytest

from test_torch_sketch_gpu import NAMES, _same, _tasks, jax_python  # noqa: F401
from vae_extent_search_tpu.search import measure as jm
from vae_extent_search_tpu.search import sketch as jsketch
from vae_extent_search_tpu_torch.search import measure as tm
from vae_extent_search_tpu_torch.search import sketch as tsketch

SEEDS = (3, 2023)


@pytest.fixture(scope="module")
def pools(jax_python):
    """make_states(task, 200, seed) of each package, per (workload, seed)."""
    out = {}
    for name in NAMES:
        jt, tt = _tasks(name)
        for seed in SEEDS:
            out[name, seed] = (jt, jsketch.make_states(jt, 200, seed=seed),
                               tt, tsketch.make_states(tt, 200, seed=seed))
    return out


# ---------------------------------------------------------------------------
# make_states and the states' costs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", NAMES)
def test_make_states_equal(pools, name, seed):
    jt, js, tt, ts = pools[name, seed]
    _same(js, ts)
    assert len({s.to_str() for s in ts}) == len(ts) > 0
    if name.startswith(("conv2d", "matmul")):
        assert len(ts) == 200


@pytest.mark.parametrize("name", NAMES)
def test_hf_costs_on_gpu_states_equal(pools, name):
    """AnalyticRunner(fidelity="high") on the first seed's states (the GPU
    branch of the roofline), bit for bit."""
    jt, js, tt, ts = pools[name, SEEDS[0]]
    kw = dict(fidelity="high", noise=0.0)
    got = [(r.costs, r.error_no) for r in tm.AnalyticRunner(**kw).run(tt, ts)]
    want = [(r.costs, r.error_no)
            for r in jm.AnalyticRunner(**kw).run(jt, js)]
    assert got == want
    assert all(e == 0 for _, e in got)
