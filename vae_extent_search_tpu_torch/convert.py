"""Parameter conversion between the JAX package's pytrees and the port.

Both packages store a dense layer as ``{"w": [in, out], "b": [out]}``
(``vae_extent_search_tpu/models/modules.py:19-25``) nested in lists and
dicts; the port keeps that layout, so this module is the only place a
layout would be mapped and the mapping is the identity. Arrays cross as
numpy, which is how tests hand the same parameters to both packages.
The sequence models (``models/variants.py``) cross as a pair: their
parameter tree and TabNet's batch-norm running statistics (None for the
LSTM and the MHA).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Leaves in a fixed order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree: Any, device="cpu",
                      dtype: torch.dtype = torch.float32) -> Any:
    """JAX-layout numpy (or jax) arrays -> torch tensors on ``device``."""
    return tree_map(
        lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(
            device=device, dtype=dtype), tree)


def params_to_numpy(tree: Any) -> Any:
    """Torch tensors -> float32 numpy arrays in the JAX layout."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def clone_params(tree: Any, requires_grad: bool = False) -> Any:
    """Detached copies of every leaf (never aliases the input)."""
    return tree_map(
        lambda t: t.detach().clone().requires_grad_(requires_grad), tree)


def variant_from_numpy(params: Any, bn_state: Any = None, device="cpu"):
    """A sequence model's JAX-layout (params, bn_state) as numpy (or jax)
    arrays -> the port's tensor trees on ``device``."""
    return (params_from_numpy(params, device),
            None if bn_state is None else params_from_numpy(bn_state, device))


def variant_to_numpy(params: Any, bn_state: Any = None):
    """The port's (params, bn_state) -> float32 numpy trees in the JAX
    layout (what ``SequenceModelInternal.save`` pickles)."""
    return (params_to_numpy(params),
            None if bn_state is None else params_to_numpy(bn_state))
