"""The comparison that decides ``correct``: a sample of the window's
phases, one per episode position, judged against the plain reference
(``reference/``) at the configuration's precision.

Numbers, each the worst over the sampled phases:

- ``cost_err``: the largest |cost - reference| over all rows, as a share
  of the reference's largest |cost|;
- ``gnorm_err``: the largest |gnorm - reference| over all rows, as a
  share of the reference's largest gnorm;
- ``gnorm_pool_err``: the same, over the rows of the phase's candidate
  pool alone (its ``num_select * topk_factor`` highest costs among the
  remaining rows), where the gradient picks are made;
- ``gnorm_p999_err``: the same error of the row ranked N // 1000 + 1 from
  the worst, so that at most N // 1000 rows lie past its limit;
- ``mcvar_err``: the largest |MC variance - reference| over all rows, as
  a share of the reference's largest variance;
- ``pick_mismatch``: the cost, gradient and uncertainty picks that differ
  from the selection replayed on the phase's own scores, plus the rows
  whose returned remaining mask is not the input's less the picks;
- ``kcenter_gap``: the widest gap by which a k-center pick's distance to
  its nearest center lies below the farthest available pool row's, as a
  share of the latter, on the reference's latents, following the phase's
  own picks step by step.

A cell's limits (``limits/<cell>.json``) give each number its limit; a
number whose limit is null is read but not compared (a bfloat16 cell's
``gnorm_err``: a unit at its ReLU kink flips its mask under another
summation order, and its row's norm jumps by some per cent; PERF.md).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .reference import model, select

NUMBERS = ("cost_err", "gnorm_err", "gnorm_pool_err", "gnorm_p999_err",
           "mcvar_err", "pick_mismatch", "kcenter_gap")


def _rel(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return (got.float() - ref).abs() / ref.abs().max().clamp_min(1e-30)


def phase_seed(gen_state: torch.Tensor, device) -> int:
    """The dropout seed a phase draws: the first draw of the selection
    generator from the state it had when the phase began."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=g, device=device))


def judge_phase(rec, X: torch.Tensor, cfg: Dict) -> Dict:
    """The numbers of one sampled phase ``rec`` (``harness.Kept``)."""
    op_fmt = bias_fmt = cfg["compute_dtype"]
    b = select.budget(cfg)
    sel_idx, sel_valid, remaining_out, aux = rec.outputs
    ref = model.scores(rec.params, X, phase_seed(rec.gen_state, X.device),
                       cfg["T_mc"], cfg["dropout_rate"], op_fmt, bias_fmt)
    out = {
        "cost_err": float(_rel(aux["cost_pred"], ref.cost).max()),
        "mcvar_err": float(_rel(aux["mc_var"], ref.mc_var).max()),
    }

    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    cost, gnorm, var = (host(aux[k]) for k in ("cost_pred", "grad_norm",
                                                "mc_var"))
    remaining = host(rec.remaining_in)
    idx, valid = host(sel_idx), host(sel_valid)
    rp = select.replay(cost, gnorm, var, remaining, b, rec.gated)
    rel = _rel(aux["grad_norm"], ref.gnorm)
    out["gnorm_err"] = float(rel.max())
    out["gnorm_pool_err"] = float(
        rel[torch.as_tensor(rp.pool, device=rel.device)].max())
    out["gnorm_p999_err"] = float(
        torch.topk(rel, rel.shape[0] // 1000 + 1).values[-1])
    n_fixed = b.n_cost + b.grad + b.n_unc
    want_idx = np.concatenate([p[0] for p in rp.parts])
    want_valid = np.concatenate([p[1] for p in rp.parts])
    got_idx, got_valid = idx[:n_fixed], valid[:n_fixed]
    wrong = (got_valid != want_valid) | (want_valid & (got_idx != want_idx))
    picked = np.zeros_like(remaining)
    picked[idx[valid]] = True
    wrong_rows = (host(remaining_out) != (remaining & ~picked)).sum()
    out["pick_mismatch"] = int(wrong.sum() + wrong_rows)

    # k-center: centers are the measured ring and this phase's fixed picks
    div_idx = idx[n_fixed:n_fixed + b.n_div]
    div_valid = valid[n_fixed:n_fixed + b.n_div]
    ring = host(rec.center_idx)[host(rec.center_valid)]
    centers = np.concatenate([ring, got_idx[got_valid]])
    pos = {int(r): i for i, r in enumerate(rp.pool)}
    picks = np.array([pos.get(int(r), -1) for r in div_idx], np.int64)

    def latents(rows):
        return model.unit_latents(rec.params, X, rows, op_fmt, bias_fmt)

    gaps = select.kcenter_gaps(latents(rp.pool), rp.avail, latents(centers),
                               picks, div_valid)
    out["kcenter_gap"] = float(gaps.max()) if len(gaps) else 0.0
    return out


def compare(kept: Dict, X: torch.Tensor, cfg: Dict) -> Dict:
    """The worst of each number over the sampled phases."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            per = [judge_phase(rec, X, cfg)
                   for _, rec in sorted(kept.items())]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return {k: max((p[k] for p in per), default=float("inf"))
            for k in NUMBERS}


def compared(limits: Dict):
    """The numbers a cell compares: those whose limit is not null."""
    return [k for k in NUMBERS if limits[k] is not None]


def passes(numbers: Dict, limits: Dict) -> bool:
    return all(numbers[k] <= limits[k] for k in compared(limits))
