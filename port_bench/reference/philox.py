"""Philox 4x32-10 (Salmon, Moraes, Dror, Shaw: "Parallel random numbers:
as easy as 1, 2, 3", SC 2011) in plain torch int64 arithmetic.

Every 32-bit word is held in an int64 tensor. A 32 x 32-bit product is
split at 16 bits so that no intermediate passes 2**49 and nothing relies
on signed overflow.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit halves of the 64-bit product a * m."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(c0, c1, c2, c3, key: int):
    """The four output words for counters (c0, c1, c2, c3) (int64 tensors
    or ints, broadcast together) under the 64-bit ``key`` (low word
    first)."""
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def dropout_words(seed: int, t: int, rows: torch.Tensor, units: int):
    """[len(rows), units] int64 words in [0, 2**32): the word of unit u of
    candidate n in pass t is word u % 4 of the block at counter
    (u // 4, t, n mod 2**32, n // 2**32) under key ``seed``."""
    quads = -(-units // 4)
    n = rows.to(torch.int64)[:, None]
    q = torch.arange(quads, dtype=torch.int64, device=rows.device)[None, :]
    out = philox4x32_10(q, torch.full_like(n, t), n & MASK32, n >> 32, seed)
    words = torch.stack(torch.broadcast_tensors(*out), dim=-1)
    return words.reshape(n.shape[0], 4 * quads)[:, :units]
