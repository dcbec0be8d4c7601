"""Generic model -> SearchTask extraction via torch.fx (a copy of
``vae_extent_search_tpu/frontend/torch_fx.py``).

Parity target: the reference's relay task extraction
(relay_integration.py:82-149 ``extract_tasks``: build a relay module,
collect every complex op call as a SearchTask with a use-count weight;
dump_network_info.py:27-62 feeds torchvision/transformers models into
it). The redesign: no relay — ``torch.fx.symbolic_trace`` gives
the operator graph of any torch.nn.Module, ``ShapeProp`` executes it
once on a meta example to annotate every node with concrete
input/output shapes, and each compute node maps onto the workload
registry (records/workload.py) exactly like the hand-enumerated grid in
records/networks.py. Identical layer workloads dedup into one task with
a multiplicity weight, mirroring relay's per-op use counts.

Supported node classes (the ops the tuning registry models):

=====================  =====================================
torch op               workload key
=====================  =====================================
nn.Conv2d (groups=1)   conv2d_layer
nn.Conv2d (depthwise)  depthwise_conv2d_layer
nn.Conv2d (grouped)    group_conv2d_layer
nn.ConvTranspose2d     conv2d_transpose_layer
nn.Conv3d              conv3d_layer
nn.Linear / F.linear   matmul_add
matmul/bmm (3D+)       batch_matmul  (leading dims folded)
matmul (2D)            matmul_add
nn.MaxPool2d           max_pool2d_layer
nn.AvgPool2d           avg_pool2d_layer
nn.AdaptiveAvgPool2d   avg_pool2d_layer (kernel = input extent)
=====================  =====================================

Everything else (elementwise, normalization, reshape) is fused into its
producer by every backend the registry targets, matching the
reference's relay task granularity — those nodes are skipped.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..records.task import SearchTask
from ..records.workload import make_workload_key


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1] if len(v) > 1 else v[0])
    return int(v), int(v)


def _triple(v):
    if isinstance(v, (tuple, list)):
        vv = list(v) + [v[-1]] * (3 - len(v))
        return tuple(int(x) for x in vv[:3])
    return (int(v),) * 3


def _shape(node) -> Optional[Tuple[int, ...]]:
    meta = node.meta.get("tensor_meta")
    if meta is None:
        return None
    return tuple(int(s) for s in meta.shape)


class _TaskAccumulator:
    """Ordered key -> multiplicity map (relay extract_tasks semantics:
    one task per distinct workload, weight = use count)."""

    def __init__(self, target: str):
        self.target = target
        self._order: List[str] = []
        self._weights = {}

    def add(self, key: str, count: float = 1.0):
        if key not in self._weights:
            self._order.append(key)
            self._weights[key] = 0.0
        self._weights[key] += count

    def result(self) -> Tuple[List[SearchTask], List[float]]:
        tasks = [SearchTask(k, self.target) for k in self._order]
        weights = [float(self._weights[k]) for k in self._order]
        return tasks, weights


def _conv2d_key(in_shape, out_ch, kernel, stride, padding, groups):
    b, ci, h, w = in_shape
    kh, kw = _pair(kernel)
    s = _pair(stride)
    p = _pair(padding)
    if groups == 1:
        return make_workload_key(
            "conv2d_layer",
            (b, h, w, out_ch, ci, kh, kw, [s[0], s[1]], [p[0], p[1]]))
    if groups == ci and out_ch == ci:
        return make_workload_key(
            "depthwise_conv2d_layer",
            (b, h, w, ci, kh, kw, [s[0], s[1]], [p[0], p[1]]))
    return make_workload_key(
        "group_conv2d_layer",
        (b, h, w, out_ch, ci, kh, kw, [s[0], s[1]], [p[0], p[1]], groups))


def _add_module_task(acc: "_TaskAccumulator", mod, node) -> None:
    import torch.nn as nn

    in_shape = _shape(node.args[0]) if node.args else None
    if in_shape is None:
        return
    if isinstance(mod, nn.Conv2d):
        acc.add(_conv2d_key(in_shape, mod.out_channels, mod.kernel_size,
                            mod.stride, mod.padding, mod.groups))
    elif isinstance(mod, nn.ConvTranspose2d):
        b, ci, h, w = in_shape
        kh, kw = _pair(mod.kernel_size)
        s, p = _pair(mod.stride), _pair(mod.padding)
        acc.add(make_workload_key(
            "conv2d_transpose_layer",
            (b, h, w, mod.out_channels, ci, kh, kw,
             [s[0], s[1]], [p[0], p[1]])))
    elif isinstance(mod, nn.Conv3d):
        b, ci, d, h, w = in_shape
        kd, kh, kw = _triple(mod.kernel_size)
        s, p = _triple(mod.stride), _triple(mod.padding)
        acc.add(make_workload_key(
            "conv3d_layer",
            (b, d, h, w, mod.out_channels, ci, kd, kh, kw,
             list(s), list(p))))
    elif isinstance(mod, nn.Linear):
        rows = 1
        for s in in_shape[:-1]:
            rows *= s
        acc.add(make_workload_key(
            "matmul_add", (rows, mod.in_features, mod.out_features,
                           "float32")))
    elif isinstance(mod, nn.MaxPool2d):
        b, c, h, w = in_shape
        k = _pair(mod.kernel_size)[0]
        s = _pair(mod.stride if mod.stride is not None
                  else mod.kernel_size)[0]
        p = _pair(mod.padding)[0]
        acc.add(make_workload_key(
            "max_pool2d_layer", (b, h, w, c, k, s, p)))
    elif isinstance(mod, nn.AvgPool2d):
        b, c, h, w = in_shape
        k = _pair(mod.kernel_size)[0]
        s = _pair(mod.stride if mod.stride is not None
                  else mod.kernel_size)[0]
        p = _pair(mod.padding)[0]
        acc.add(make_workload_key(
            "avg_pool2d_layer", (b, h, w, c, k, s, p)))
    elif isinstance(mod, nn.AdaptiveAvgPool2d):
        b, c, h, w = in_shape
        out = mod.output_size
        oh = out[0] if isinstance(out, (tuple, list)) else out
        oh = 1 if oh is None else int(oh)
        if oh == 1:  # global average pool: kernel spans the input
            acc.add(make_workload_key(
                "avg_pool2d_layer", (b, h, w, c, h, 1, 0)))
        else:
            acc.add(make_workload_key(
                "avg_pool2d_layer", (b, h, w, c, h // oh, h // oh, 0)))


def _add_function_task(acc: "_TaskAccumulator", node) -> None:
    import operator

    import torch
    import torch.nn.functional as F

    fn = node.target
    if fn in (torch.matmul, operator.matmul, torch.bmm):
        a, b = _shape(node.args[0]), _shape(node.args[1])
        if a is None or b is None:
            return
        if len(a) == 2 and len(b) == 2:
            acc.add(make_workload_key(
                "matmul_add", (a[0], a[1], b[1], "float32")))
        else:
            batch = 1
            for s in a[:-2]:
                batch *= s
            # relay folds every leading dim into the batch_matmul batch
            # (reference python/tvm/topi/nn/batch_matmul.py:24); the
            # contraction dim K comes from A's last axis, M from B's
            acc.add(make_workload_key(
                "batch_matmul", (batch, a[-2], b[-1], a[-1], "float32")))
    elif fn is F.linear:
        a, w = _shape(node.args[0]), _shape(node.args[1])
        if a is None or w is None:
            return
        rows = 1
        for s in a[:-1]:
            rows *= s
        acc.add(make_workload_key(
            "matmul_add", (rows, w[1], w[0], "float32")))
    elif fn is F.scaled_dot_product_attention:
        # one fused node = the two attention batched matmuls relay
        # extracts separately: scores = Q K^T and context = S V
        q, v = _shape(node.args[0]), _shape(node.args[2])
        if q is None or v is None:
            return
        batch = 1
        for s in q[:-2]:
            batch *= s
        seq, head_dim = q[-2], q[-1]
        kseq = v[-2]
        acc.add(make_workload_key(
            "batch_matmul", (batch, seq, kseq, head_dim, "float32")))
        acc.add(make_workload_key(
            "batch_matmul", (batch, seq, v[-1], kseq, "float32")))
    elif fn is F.adaptive_avg_pool2d:
        a = _shape(node.args[0])
        if a is None:
            return
        b, c, h, w = a
        out = node.args[1]
        oh = out[0] if isinstance(out, (tuple, list)) else out
        if int(oh) == 1:
            acc.add(make_workload_key(
                "avg_pool2d_layer", (b, h, w, c, h, 1, 0)))
    elif fn is F.max_pool2d:
        a = _shape(node.args[0])
        if a is None:
            return
        b, c, h, w = a
        k = _pair(node.args[1])[0]
        s = _pair(node.args[2])[0] if len(node.args) > 2 else k
        p = _pair(node.args[3])[0] if len(node.args) > 3 else 0
        acc.add(make_workload_key(
            "max_pool2d_layer", (b, h, w, c, k, s, p)))


def extract_tasks_from_module(model, input_shape,
                              target: str = "llvm",
                              example_inputs=None
                              ) -> Tuple[List[SearchTask], List[float]]:
    """Trace ``model`` and return (tasks, weights).

    ``input_shape``: shape of a single float example input (ignored when
    ``example_inputs`` — a tuple of real tensors, e.g. int token ids for
    a language model — is given). Models with data-dependent Python
    control flow need a wrapper that fixes the branch, same as any
    tracing frontend (relay's torch importer shares the constraint).
    """
    import torch
    from torch import fx
    from torch.fx.passes.shape_prop import ShapeProp

    was_training = getattr(model, "training", False)
    model = model.eval() if hasattr(model, "eval") else model
    gm = fx.symbolic_trace(model)
    if example_inputs is None:
        example_inputs = (torch.zeros(*input_shape),)
    with torch.no_grad():
        ShapeProp(gm).propagate(*example_inputs)
    if was_training:
        model.train()
    return _tasks_from_graph(gm, target)


def extract_tasks_from_hf(model, batch_size: int, seq_length: int,
                          target: str = "llvm"
                          ) -> Tuple[List[SearchTask], List[float]]:
    """Trace a HuggingFace transformers model (transformers.utils.fx
    handles the library's dynamic control flow) and extract tasks from
    an [batch, seq] input_ids example — the reference's
    dump_network_info.py:66-80 path for the bert grid."""
    import torch
    from torch.fx.passes.shape_prop import ShapeProp
    from transformers.utils import fx as hf_fx

    model = model.eval()
    gm = hf_fx.symbolic_trace(model, input_names=["input_ids"])
    ids = torch.zeros(batch_size, seq_length, dtype=torch.long)
    with torch.no_grad():
        ShapeProp(gm).propagate(ids)
    return _tasks_from_graph(gm, target)


def _tasks_from_graph(gm, target: str):
    acc = _TaskAccumulator(target)
    modules = dict(gm.named_modules())
    for node in gm.graph.nodes:
        if node.op == "call_module":
            _add_module_task(acc, modules[node.target], node)
        elif node.op == "call_function":
            _add_function_task(acc, node)
    return acc.result()
