"""Host featurisers: printed-extent vectors (``extent.py``) and the
164-dim per-store rows (``per_store.py``), copies of the JAX package's
Python featurisers with imports local to the port; the per-store batch
entry points run the port's native featuriser by default
(``records/fast_parser.py``)."""

from .extent import (
    extent_features_from_records,
    extent_vector,
    extent_vector_from_text,
    find_common_unit_loops,
    label_from_costs,
)
from .per_store import (
    FEATURE_VEC_LEN,
    get_per_store_features_from_file,
    get_per_store_features_from_measure_pairs,
    get_per_store_features_from_state,
    get_per_store_features_from_states,
    perstore_features_from_records,
)
