"""The port's profiler ranges and its count of host syncs in the selection
phase: ``utils/misc.py::span`` is a shared no-op outside a profiler and a
``record_function`` range inside one, ``select_programs`` opens its stage
ranges once each under one "select_programs" range, and every
"select.sync" range is one count of ``select_programs.host_syncs``. The
``cuda`` cases hold the count against PyTorch's own sync detection on the
card at the benchmark cells' shapes. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import itertools
import tracemalloc
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from vae_extent_search_tpu_torch.models.predictor import (
    PredictorConfig, init_predictor_params)
from vae_extent_search_tpu_torch.search import select as ts
from vae_extent_search_tpu_torch.search.active_loop import _ModelPhase
from vae_extent_search_tpu_torch.utils import misc

N, D, HID, LAT, HP, T = 400, 17, 64, 16, 64, 4
STAGES = ("select.prepare", "select.score", "select.pool_topk",
          "select.picks", "select.kcenter")


def expected_syncs(cfg, fused):
    """The places one phase waits for the card: the host's read of the
    kernel's seed, drawn only for the fused head. Nothing after it reads
    the card: not the top-ks, the k-center loop, nor the mask-derived
    centers. (The random stage's noise would add its copy with a
    generator on another device than the data; ``phase`` makes both on
    one device, as every caller does.)"""
    seed_draw = int(fused)
    return seed_draw


def phase_inputs(device="cpu", n=N, d=D, hid=HID, lat=LAT, hp=HP, t=T,
                 n_meas=40, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_predictor_params(g, d, hid, lat, hp, device=device)
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                        device=device)
    bits = torch.as_tensor(rng.integers(0, 2 ** 32, (t, n, hp),
                                        dtype=np.uint32), device=device)
    used = torch.zeros(n, dtype=torch.bool, device=device)
    used[torch.as_tensor(rng.choice(n, n_meas, replace=False),
                         device=device)] = True
    return params, X, bits, used, g


def phase(cfg, fused=True, buffer=True, gate=False, device="cpu",
          **shape):
    """One selection phase, its inputs made: call it to run it."""
    params, X, bits, used, g = phase_inputs(device, **shape)
    cidx = torch.nonzero(used).flatten()
    centers = torch.zeros(cfg.max_centers, dtype=torch.int64, device=device)
    centers[:cidx.numel()] = cidx
    valid = torch.arange(cfg.max_centers, device=device) < cidx.numel()
    remaining = ~used

    def run():
        with torch.no_grad():
            return ts.select_programs(
                params, X, used, remaining, g, cfg,
                gate_uncertainty_to_remaining=gate,
                mask_bits=bits if fused and device == "cpu" else None,
                center_idx=centers if buffer else None,
                center_valid=valid if buffer else None)
    return run


def cpu_cfg(fused, **kw):
    return ts.SelectionConfig(num_select=32, T_mc=T, topk_factor=5,
                              max_centers=256,
                              fused_head="auto" if fused else "off", **kw)


def profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def test_span_outside_a_profiler_is_one_shared_noop(monkeypatch):
    assert misc.span("select.prepare") is misc.span("select.sync")
    assert misc.span("x") is misc._NO_SPAN

    def loop(it, make):
        for _ in it:
            with make():
                pass

    def peak(make):
        loop(itertools.repeat(None, 3), make)
        it = itertools.repeat(None, 10000)
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            loop(it, make)
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()

    # 10,000 spans hold no more memory at their peak than 10,000 entries
    # of the shared context itself
    assert peak(lambda: misc.span("select.sync")) <= peak(
        lambda: misc._NO_SPAN)

    def refuse(*a, **k):
        raise AssertionError("record_function outside a profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    sel, valid, _, _ = phase(cpu_cfg(True))()
    assert int(valid.sum()) == 32


@pytest.mark.parametrize("fused,buffer,kw", [
    (True, True, {}),
    (False, True, {}),
    (True, False, {"rand_num": 3}),
])
def test_profiled_phase_records_each_stage_once(fused, buffer, kw):
    cfg = cpu_cfg(fused, **kw)
    run = phase(cfg, fused, buffer)
    before = ts.select_programs.host_syncs
    events = profiled(run)
    counted = ts.select_programs.host_syncs - before
    assert counted == expected_syncs(cfg, fused)

    (outer,) = [(a, b) for n, a, b in events if n == "select_programs"]
    stages = STAGES + (("select.random",) if cfg.rand_num else ())
    for name in stages:
        (got,) = [(a, b) for n, a, b in events if n == name]
        assert outer[0] <= got[0] and got[1] <= outer[1], name
    assert not [n for n, _, _ in events if n == "select.random"
                and not cfg.rand_num]
    syncs = [(a, b) for n, a, b in events if n == "select.sync"]
    assert len(syncs) == counted
    assert all(outer[0] <= a and b <= outer[1] for a, b in syncs)
    # the port opens no range under the benchmark's own prefix
    names = {n for n, _, _ in events}
    assert not {n for n in names if n.startswith("pb.")}


def test_model_phase_select_opens_one_select_programs_range():
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (N, D)).astype(np.float32))
    cfg = ts.SelectionConfig(num_select=16, T_mc=T, max_centers=128)
    step = _ModelPhase(X, None, PredictorConfig(), cfg, HID, LAT, 1, 0, 1,
                       list(range(20)))
    params = init_predictor_params(torch.Generator().manual_seed(1), D, HID,
                                   LAT, HP)
    used = torch.zeros(N, dtype=torch.bool)
    used[:20] = True
    events = profiled(lambda: step.select(params, used, ~used, 20))
    assert [n for n, _, _ in events].count("select_programs") == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

SYNC_MESSAGE = "called a synchronizing CUDA operation"
# the benchmark cells' shapes: 262,144 candidates of the extent rows in
# float32 and of the flattened per-store rows in bfloat16
CELLS = {"extent_f32": (17, "float32"), "perstore_bf16": (820, "bfloat16")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fused,buffer,gate", [
    ("extent_f32", True, True, True),
    ("extent_f32", True, True, False),
    ("perstore_bf16", True, True, True),
    ("perstore_bf16", True, True, False),
    ("extent_f32", False, True, False),
    ("extent_f32", True, False, False),
])
def test_host_syncs_match_the_cards_sync_detection(dev, cell, fused, buffer,
                                                   gate):
    d, dtype = CELLS[cell]
    cfg = ts.SelectionConfig(num_select=32, T_mc=10, topk_factor=5,
                             max_centers=4096, compute_dtype=dtype,
                             fused_head="auto" if fused else "off")
    shape = dict(n=262144, d=d, hid=256, lat=64, hp=256, t=10, n_meas=96)
    run = phase(cfg, fused, buffer, gate, "cuda", **shape)
    run()   # builds the kernel's library, warms every operation
    torch.cuda.synchronize()
    before = ts.select_programs.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    seen = sum(SYNC_MESSAGE in str(w.message) for w in caught)
    counted = ts.select_programs.host_syncs - before
    assert seen == counted == expected_syncs(cfg, fused)
