"""The scoring stage of one selection phase, written from the model's
description: a 3-layer ReLU encoder and ``fc_mu`` to the latent z, a cost
head of two ReLU layers and a linear output, the norm of d cost / d z,
and T passes of MC dropout after the head's first ReLU.

A model served in a narrower format is emulated: every matmul operand
(weights, the layer's input) is rounded to ``op_fmt`` and products are
summed in float32; every bias is rounded to ``bias_fmt`` and added in
float32. The dropout words are Philox 4x32-10 (``philox.py``) under the
phase's seed: a unit of h0 is kept where its word is at least
rate * 2**32 and kept units are scaled by 1 / (1 - rate).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .philox import dropout_words
from .precision import rounder


class Scores(NamedTuple):
    cost: torch.Tensor    # [N] f32
    gnorm: torch.Tensor   # [N] f32, |d cost / d z|
    mc_var: torch.Tensor  # [N] f32, sample variance (ddof 1) of T passes


def keep_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def _layers(params: Dict, op, bias):
    def wb(layer):
        return op(layer["w"].float()), bias(layer["b"].float())
    return ([wb(l) for l in params["encoder"]], wb(params["fc_mu"]),
            [wb(l) for l in params["cost_predictor"]])


def encode(params: Dict, x: torch.Tensor, op_fmt: str, bias_fmt: str):
    """The latent z = fc_mu(encoder(x)) of rows ``x`` [n, D]."""
    op, bias = rounder(op_fmt), rounder(bias_fmt)
    enc, (wm, bm), _ = _layers(params, op, bias)
    h = x.float()
    for w, b in enc:
        h = torch.relu(op(h) @ w + b)
    return op(h) @ wm + bm


def unit_latents(params: Dict, X: torch.Tensor, rows, op_fmt: str,
                 bias_fmt: str):
    """The L2-normalised latents of rows ``rows`` of ``X``, float64 numpy."""
    z = encode(params, X[torch.as_tensor(rows, device=X.device)], op_fmt,
               bias_fmt)
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
    return z.cpu().numpy().astype("float64")


def scores(params: Dict, X: torch.Tensor, seed: int, T: int, rate: float,
           op_fmt: str, bias_fmt: str, block: int = 16384) -> Scores:
    """Cost, gradient norm and MC variance of every row of ``X`` [N, D],
    ``block`` rows at a time; row n takes the dropout words of candidate
    n."""
    op, bias = rounder(op_fmt), rounder(bias_fmt)
    _, _, head = _layers(params, op, bias)
    (w0, b0), (w1, b1), (w2, b2) = head
    w2, b2 = w2[:, 0], b2[0]
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    thresh = keep_threshold(rate)
    zero = torch.zeros((), dtype=torch.float32, device=X.device)
    out = [[], [], []]
    for r0 in range(0, X.shape[0], block):
        x = X[r0:r0 + block]
        z = encode(params, x, op_fmt, bias_fmt)
        a0 = op(z) @ w0 + b0
        h0 = torch.relu(a0)
        a1 = op(h0) @ w1 + b1
        cost = op(torch.relu(a1)) @ w2 + b2
        g1 = torch.where(a1 > 0, w2, zero)
        g0 = torch.where(a0 > 0, op(g1) @ w1.T, zero)
        gz = op(g0) @ w0.T
        gnorm = torch.sqrt((gz * gz).sum(-1))
        hs = op(h0 * scale.to(X.device))
        rows = torch.arange(r0, r0 + x.shape[0], device=X.device)
        preds = []
        for t in range(T):
            keep = dropout_words(seed, t, rows, h0.shape[1]) >= thresh
            a1t = torch.where(keep, hs, zero) @ w1 + b1
            preds.append(op(torch.relu(a1t)) @ w2 + b2)
        var = torch.stack(preds).var(0, correction=1)
        for acc, v in zip(out, (cost, gnorm, var)):
            acc.append(v)
    return Scores(*(torch.cat(v) for v in out))
