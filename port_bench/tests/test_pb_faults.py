"""The comparison passes the port and fails the control and each planted
fault, at the cells' widths and limits over a small pool, on the CPU
through the port's plain kernel versions (the timed path broken
underneath, the rest of a run as the benchmark drives it)."""

import time

import pytest

from pb_helpers import add_cell, cell_limits
from port_bench import faults, harness
from vae_extent_search_tpu_torch.search.select import select_programs

CELLS = ("vae_extent", "vae_perstore")


def run(root, config, mode, seed=2 ** 31 + 3):
    name = add_cell(root, config, "small",
                    cell_limits(f"{config}.select_262k"))
    cell = harness.workload.load_cell(root, name)
    fn = faults.select_fn(mode, cell.config, seed, select_programs)
    return harness.run_cell(root, name, seed, 0.0, False,
                            time.perf_counter(), rehearse=True,
                            select_fn=fn, min_phases=16)


@pytest.mark.parametrize("config", CELLS)
@pytest.mark.parametrize("mode", ["sound", "control", *faults.FAULTS])
def test_only_the_port_is_correct(checkout, config, mode):
    res = run(checkout, config, mode)
    assert res["checked_phases"] == 8
    assert res["correct"] is (mode == "sound"), res["compared"]
