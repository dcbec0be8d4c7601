"""Device selection for the port's entry points.

There is no fallback: a caller asks for ``cuda`` or ``cpu`` and gets
exactly that, or an error.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    absent. On CUDA, float32 matmuls and convolutions are pinned to full
    float32 (no TF32), the precision the JAX reference computes in."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def make_generator(seed: int, stream: int, device) -> torch.Generator:
    """An explicit torch Generator on ``device`` for stream ``stream`` of
    ``seed``; distinct streams of one seed are independent."""
    s = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))
