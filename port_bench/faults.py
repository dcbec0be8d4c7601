"""Selection phases broken on purpose, each in the place of the port's
``select_programs``, to show that the comparison fails them, and the
control: the plain reference in the port's place, computed in the
nearest precision below the configuration's.

- ``unchanged``: after its first call the phase returns its input state
  unchanged (the remaining rows) with the first call's picks and scores;
- ``half_batch``: the phase scores only the first half of the pool and
  gives every row of the other half the mean of the scored half;
- ``altered_pick``: one pick, at a position drawn from the seed, is
  replaced by another remaining row;
- ``gnorm_pool``: the fused head's gradient norms are wrong on the rows
  of the candidate pool alone (the ``num_select * topk_factor`` highest
  costs among the remaining rows, where the gradient picks are made):
  each such row takes the next pool row's norm, and the selection
  follows them;
- ``control``: the reference at the configuration's ``control`` formats.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .reference import model, select
from .workload import FAULT, sub_seed

FAULTS = ("unchanged", "half_batch", "altered_pick", "gnorm_pool")


def unchanged(program: Callable) -> Callable:
    first = {}

    def fn(params, X, used, remaining, gen, cfg, **kw):
        if not first:
            first["out"] = program(params, X, used, remaining, gen, cfg, **kw)
            return first["out"]
        sel_idx, sel_valid, _, aux = first["out"]
        return sel_idx, sel_valid, remaining, aux
    return fn


def half_batch(program: Callable) -> Callable:
    def fn(params, X, used, remaining, gen, cfg, **kw):
        h = X.shape[0] // 2
        if kw.get("mask_bits") is not None:
            kw["mask_bits"] = kw["mask_bits"][:, :h].contiguous()
        inside = kw["center_idx"] < h
        kw["center_valid"] = kw["center_valid"] & inside
        kw["center_idx"] = torch.where(inside, kw["center_idx"], 0)
        sel_idx, sel_valid, rem_h, aux = program(
            params, X[:h], used[:h], remaining[:h], gen, cfg, **kw)
        full = {k: torch.cat([v, v.mean().expand(X.shape[0] - h)])
                for k, v in aux.items()}
        return sel_idx, sel_valid, torch.cat([rem_h, remaining[h:]]), full
    return fn


def altered_pick(program: Callable, seed: int) -> Callable:
    rng = np.random.default_rng(sub_seed(seed, FAULT))

    def fn(params, X, used, remaining, gen, cfg, **kw):
        sel_idx, sel_valid, rem, aux = program(params, X, used, remaining,
                                               gen, cfg, **kw)
        pos = int(rng.integers(sel_idx.shape[0]))
        free = torch.nonzero(rem).flatten()
        new = free[int(rng.integers(free.shape[0]))]
        old = sel_idx[pos]
        sel_idx = sel_idx.clone()
        sel_idx[pos] = new
        rem = rem.clone()
        rem[new] = False
        rem[old] = True
        return sel_idx, sel_valid, rem, aux
    return fn


def gnorm_pool(program: Callable) -> Callable:
    import vae_extent_search_tpu_torch.search.select as port_select

    real = port_select.fused_head_stats
    phase = {}

    def wrong(*args, **kw):
        cost, gnorm, *rest = real(*args, **kw)
        scores = torch.where(phase["remaining"], cost.float(),
                             torch.tensor(-float("inf"), device=cost.device))
        pool = torch.topk(scores, phase["k_pool"]).indices
        gnorm = gnorm.clone()
        gnorm[pool] = gnorm[pool.roll(1)]
        return (cost, gnorm, *rest)

    def fn(params, X, used, remaining, gen, cfg, **kw):
        phase.update(remaining=remaining,
                     k_pool=cfg.num_select * cfg.topk_factor)
        port_select.fused_head_stats = wrong
        try:
            return program(params, X, used, remaining, gen, cfg, **kw)
        finally:
            port_select.fused_head_stats = real
    return fn


def control(cfg: Dict) -> Callable:
    """The reference in the port's place at ``cfg["control"]``'s formats:
    its scores, its selection on them, its k-center on its latents."""
    op_fmt, bias_fmt = cfg["control"]["op_fmt"], cfg["control"]["bias_fmt"]
    b = select.budget(cfg)

    def fn(params, X, used, remaining, gen, scfg,
           gate_uncertainty_to_remaining, center_idx, center_valid,
           mask_bits=None):
        dev = X.device
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                 device=gen.device))
        sc = model.scores(params, X, seed, cfg["T_mc"], cfg["dropout_rate"],
                          op_fmt, bias_fmt)
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        rem = host(remaining)
        rp = select.replay(host(sc.cost), host(sc.gnorm), host(sc.mc_var),
                           rem, b, gate_uncertainty_to_remaining)
        idx = np.concatenate([p[0] for p in rp.parts])
        valid = np.concatenate([p[1] for p in rp.parts])
        centers = np.concatenate([host(center_idx)[host(center_valid)],
                                  idx[valid]])

        def latents(rows):
            return model.unit_latents(params, X, rows, op_fmt, bias_fmt)

        li, lv = select.kcenter_greedy(latents(rp.pool), rp.avail,
                                       latents(centers), b.n_div)
        idx = np.concatenate([idx, rp.pool[li]])
        valid = np.concatenate([valid, lv])
        picked = np.zeros_like(rem)
        picked[idx[valid]] = True
        aux = {"cost_pred": sc.cost, "mc_var": sc.mc_var,
               "grad_norm": sc.gnorm}
        return (torch.as_tensor(idx, device=dev),
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(rem & ~picked, device=dev), aux)
    return fn


def select_fn(mode: str, cfg: Dict, seed: int, program: Callable
              ) -> Callable:
    """What takes the port's place in a run of ``mode``: "sound" (the
    port itself), "control" or one of ``FAULTS``."""
    if mode == "sound":
        return program
    if mode == "control":
        return control(cfg)
    if mode == "altered_pick":
        return altered_pick(program, seed)
    if mode in FAULTS:
        return globals()[mode](program)
    raise ValueError(f"unknown mode {mode!r}")
