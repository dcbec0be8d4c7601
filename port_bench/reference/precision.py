"""Rounding of float32 values to a narrower format and back, to emulate a
model served in that format: "float32" (no rounding), "tf32" (10
mantissa bits, round to nearest, ties away, as ``cvt.rna.tf32.f32``),
"bfloat16" (round to nearest even) and "fp8_e4m3" (saturating at 448,
round to nearest even)."""

from __future__ import annotations

import torch

FORMATS = ("float32", "tf32", "bfloat16", "fp8_e4m3")
FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def rounder(fmt: str):
    """The function rounding a float32 tensor to ``fmt`` and back."""
    if fmt == "float32":
        return lambda x: x
    if fmt == "tf32":
        return _tf32
    if fmt == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if fmt == "fp8_e4m3":
        return lambda x: x.clamp(-FP8_MAX, FP8_MAX).to(
            torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown format {fmt!r} (one of {FORMATS})")
