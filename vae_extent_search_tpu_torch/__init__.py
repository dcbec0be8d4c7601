"""PyTorch/CUDA port of the VAE-extent active search.

The package mirrors ``vae_extent_search_tpu``'s module names so each
counterpart is easy to find, but imports nothing from it (nor ``jax``):
it runs on ``torch``, numpy and the standard library alone. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; asking for
``cuda`` on a host without a GPU raises (see :func:`resolve_device`).

The one hand-written kernel of the search path is
``ops/fused_head.py`` + ``csrc/fused_head.cu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
