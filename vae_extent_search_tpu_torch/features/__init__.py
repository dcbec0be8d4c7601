"""Extent featurisation (a copy of ``vae_extent_search_tpu/features/``'s
``extent.py``)."""

from .extent import (
    extent_features_from_records,
    extent_vector,
    extent_vector_from_text,
    find_common_unit_loops,
    label_from_costs,
)
