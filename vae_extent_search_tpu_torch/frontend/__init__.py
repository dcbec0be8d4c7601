"""Model -> SearchTask front end: torch.fx graph tracing (a copy of
``vae_extent_search_tpu/frontend/``, which is torch already).

The reference extracts tuning tasks by building models through relay
(relay_integration.py:82-149, dump_network_info.py:27-62). This front end
traces any torch.nn.Module with torch.fx, shape-propagates an example
input, and maps each compute node to a workload-registry SearchTask: no
hand-maintained shape tables required. The Hugging Face path
(``extract_tasks_from_hf``) needs ``transformers``, which it imports only
when called.
"""

from .torch_fx import extract_tasks_from_module  # noqa: F401
from .zoo import build_zoo_model, ZOO_BUILDERS  # noqa: F401
