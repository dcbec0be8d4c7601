"""Minimal functional NN layers on tensors (counterpart of
``vae_extent_search_tpu/models/modules.py``).

Parameters are nested dicts/lists of tensors, a dense layer being
``{"w": [in, out], "b": [out]}``. Initialization matches torch.nn.Linear
defaults (kaiming-uniform weights, uniform bias in
[-1/sqrt(fan_in), 1/sqrt(fan_in)]). Random draws come from an explicit
``torch.Generator`` (on the device the parameters live on) or a numpy
``Generator`` — never from a global RNG.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

RNG = Union[torch.Generator, np.random.Generator]


def _uniform(gen: RNG, shape, bound: float, device, dtype) -> torch.Tensor:
    if isinstance(gen, np.random.Generator):
        a = gen.uniform(-bound, bound, shape).astype(np.float32)
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device=device, dtype=dtype)


def dense_init(gen: RNG, in_dim: int, out_dim: int, device=None,
               dtype: torch.dtype = torch.float32) -> Dict:
    if device is None:
        device = "cpu" if isinstance(gen, np.random.Generator) else gen.device
    bound_w = math.sqrt(1.0 / in_dim) * math.sqrt(3.0)  # kaiming uniform a=√5
    w = _uniform(gen, (in_dim, out_dim), bound_w, device, dtype)
    b = _uniform(gen, (out_dim,), math.sqrt(1.0 / in_dim), device, dtype)
    return {"w": w, "b": b}


def dense(params: Dict, x: torch.Tensor) -> torch.Tensor:
    w, b = params["w"], params["b"]
    if w.dtype == torch.bfloat16:
        # bf16 matmul INPUTS with f32 accumulation and f32 outputs, as the
        # JAX package's dense (preferred_element_type=f32): products of
        # two bf16 values are exact in f32, so upcasting the rounded
        # operands and multiplying in f32 gives the same numbers
        y = x.to(torch.bfloat16).float() @ w.float()
        return y + b.float()
    return x @ w + b


def mlp_init(gen: RNG, dims: Sequence[int], device=None,
             dtype: torch.dtype = torch.float32) -> List[Dict]:
    """Stack of Linear layers with given [in, h1, ..., out] dims."""
    return [dense_init(gen, dims[i], dims[i + 1], device, dtype)
            for i in range(len(dims) - 1)]


def mlp_apply(layers: List[Dict], x: torch.Tensor,
              final_activation: bool = False) -> torch.Tensor:
    """Linear+ReLU stack; ReLU after every layer except (optionally) last."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = dense(layer, x)
        if i < n - 1 or final_activation:
            x = torch.relu(x)
    return x


def dropout(gen: torch.Generator, x: torch.Tensor, rate: float) -> torch.Tensor:
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=gen.device).to(x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
