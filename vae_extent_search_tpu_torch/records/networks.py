"""Network -> task-list definitions (the network grid).

A copy of ``vae_extent_search_tpu/records/networks.py``.

Parity target: scripts/dump_network_info.py — build per-network task lists
+ weights for the benchmark grid (resnet/mobilenet/resnext/bert/dcgan x
batch sizes x image sizes, :139-204). The reference extracts tasks through
relay; we enumerate each architecture's distinct layer workloads directly
(standard published layer shapes) with multiplicity weights.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .task import SearchTask
from .workload import make_workload_key

# (N,H,W,CO,CI,KH,KW,stride,pad) conv shapes with multiplicities
_RESNET50_CONVS = [
    # (H, W, CO, CI, KH, KW, stride, pad, weight)
    (224, 224, 64, 3, 7, 7, 2, 3, 1),
    (56, 56, 256, 64, 1, 1, 1, 0, 4),
    (56, 56, 64, 64, 1, 1, 1, 0, 1),
    (56, 56, 64, 64, 3, 3, 1, 1, 3),
    (56, 56, 64, 256, 1, 1, 1, 0, 2),
    (56, 56, 512, 256, 1, 1, 2, 0, 1),
    (56, 56, 128, 256, 1, 1, 1, 0, 1),
    (56, 56, 128, 128, 3, 3, 2, 1, 1),
    (28, 28, 512, 128, 1, 1, 1, 0, 4),
    (28, 28, 128, 512, 1, 1, 1, 0, 3),
    (28, 28, 128, 128, 3, 3, 1, 1, 3),
    (28, 28, 1024, 512, 1, 1, 2, 0, 1),
    (28, 28, 256, 512, 1, 1, 1, 0, 1),
    (28, 28, 256, 256, 3, 3, 2, 1, 1),
    (14, 14, 1024, 256, 1, 1, 1, 0, 6),
    (14, 14, 256, 1024, 1, 1, 1, 0, 5),
    (14, 14, 256, 256, 3, 3, 1, 1, 5),
    (14, 14, 2048, 1024, 1, 1, 2, 0, 1),
    (14, 14, 512, 1024, 1, 1, 1, 0, 1),
    (14, 14, 512, 512, 3, 3, 2, 1, 1),
    (7, 7, 2048, 512, 1, 1, 1, 0, 3),
    (7, 7, 512, 2048, 1, 1, 1, 0, 2),
    (7, 7, 512, 512, 3, 3, 1, 1, 2),
]

_RESNET18_CONVS = [
    (224, 224, 64, 3, 7, 7, 2, 3, 1),
    (56, 56, 64, 64, 3, 3, 1, 1, 4),
    (56, 56, 128, 64, 1, 1, 2, 0, 1),
    (56, 56, 128, 64, 3, 3, 2, 1, 1),
    (28, 28, 128, 128, 3, 3, 1, 1, 3),
    (28, 28, 256, 128, 1, 1, 2, 0, 1),
    (28, 28, 256, 128, 3, 3, 2, 1, 1),
    (14, 14, 256, 256, 3, 3, 1, 1, 3),
    (14, 14, 512, 256, 1, 1, 2, 0, 1),
    (14, 14, 512, 256, 3, 3, 2, 1, 1),
    (7, 7, 512, 512, 3, 3, 1, 1, 3),
]

# depthwise layers: (H, W, C, KH, KW, stride, pad, weight)
_MOBILENET_V2_DEPTHWISE = [
    (112, 112, 32, 3, 3, 1, 1, 1),
    (112, 112, 96, 3, 3, 2, 1, 1),
    (56, 56, 144, 3, 3, 1, 1, 1),
    (56, 56, 144, 3, 3, 2, 1, 1),
    (28, 28, 192, 3, 3, 1, 1, 2),
    (28, 28, 192, 3, 3, 2, 1, 1),
    (14, 14, 384, 3, 3, 1, 1, 4),
    (14, 14, 576, 3, 3, 1, 1, 2),
    (14, 14, 576, 3, 3, 2, 1, 1),
    (7, 7, 960, 3, 3, 1, 1, 3),
]

_MOBILENET_V2_CONVS = [
    (224, 224, 32, 3, 3, 3, 2, 1, 1),
    (112, 112, 16, 32, 1, 1, 1, 0, 1),
    (112, 112, 96, 16, 1, 1, 1, 0, 1),
    (56, 56, 24, 96, 1, 1, 1, 0, 1),
    (56, 56, 144, 24, 1, 1, 1, 0, 2),
    (56, 56, 24, 144, 1, 1, 1, 0, 1),
    (28, 28, 32, 144, 1, 1, 1, 0, 1),
    (28, 28, 192, 32, 1, 1, 1, 0, 3),
    (28, 28, 32, 192, 1, 1, 1, 0, 2),
    (14, 14, 64, 192, 1, 1, 1, 0, 1),
    (14, 14, 384, 64, 1, 1, 1, 0, 4),
    (14, 14, 64, 384, 1, 1, 1, 0, 3),
    (14, 14, 96, 384, 1, 1, 1, 0, 1),
    (14, 14, 576, 96, 1, 1, 1, 0, 3),
    (14, 14, 96, 576, 1, 1, 1, 0, 2),
    (7, 7, 160, 576, 1, 1, 1, 0, 1),
    (7, 7, 960, 160, 1, 1, 1, 0, 3),
    (7, 7, 160, 960, 1, 1, 1, 0, 2),
    (7, 7, 320, 960, 1, 1, 1, 0, 1),
    (7, 7, 1280, 320, 1, 1, 1, 0, 1),
]

# bert scales: hidden size x layer count (reference dump_network_info
# grid: bert_{tiny,medium,base,large}); per layer the dense workloads are
# QKV/attn-out projections (4 per layer) and the two FFN matmuls
# (hidden_size, num_hidden_layers) per reference
# dump_network_info.py:66-75 config_dict; intermediate_size = 4*hidden
_BERT_DIMS = {
    "tiny": (512, 6, 8),
    "base": (768, 12, 12),
    "medium": (1024, 12, 16),
    "large": (1024, 24, 16),
}


def _bert_matmuls(seq_length: int, hidden: int, layers: int):
    return [
        (seq_length, hidden, hidden, 4 * layers),
        (seq_length, hidden, 4 * hidden, layers),
        (seq_length, 4 * hidden, hidden, layers),
    ]


def _bert_batch_matmuls(seq_length: int, hidden: int, layers: int,
                        heads: int):
    """The attention score (QK^T) and context (SV) batched matmuls —
    relay extracts these as topi batch_matmul with the head axis folded
    into the batch (reference python/tvm/topi/nn/batch_matmul.py:24)."""
    head_dim = hidden // heads
    return [
        # (B_factor, N, M, K, weight): scores = Q[s,d] @ K[s,d]^T
        (heads, seq_length, seq_length, head_dim, layers),
        # context = S[s,s] @ V[s,d]^T (relay transposes V for NT matmul)
        (heads, seq_length, head_dim, seq_length, layers),
    ]


# dcgan generator (relay/testing/dcgan.py get_net, ngf=128, 64x64 base):
# dense code->8192 then four 4x4/stride-2 transposed convs; entries are
# (H_in, W_in, CO, CI) per deconv stage at the 64-px base size.
_DCGAN_TCONVS = [
    (4, 4, 512, 1024),
    (8, 8, 256, 512),
    (16, 16, 128, 256),
    (32, 32, 3, 128),
]

# resnext50_32x4d: the bottleneck 3x3 convs are 32-group convolutions
# (torchvision resnext50_32x4d; reference dump_network_info.py:36-37);
# entries (H, W, C, stride, weight) with CO=CI=C, k3 p1 g32
_RESNEXT50_GROUP_CONVS = [
    (56, 56, 128, 1, 3),
    (56, 56, 256, 2, 1),
    (28, 28, 256, 1, 3),
    (28, 28, 512, 2, 1),
    (14, 14, 512, 1, 5),
    (14, 14, 1024, 2, 1),
    (7, 7, 1024, 1, 2),
]

# resnext50_32x4d plain convs: stem + bottleneck 1x1 reduce/expand +
# downsample projections (H, W, CO, CI, KH, KW, stride, pad, weight)
_RESNEXT50_CONVS = [
    (224, 224, 64, 3, 7, 7, 2, 3, 1),
    (56, 56, 128, 64, 1, 1, 1, 0, 1),
    (56, 56, 128, 256, 1, 1, 1, 0, 2),
    (56, 56, 256, 128, 1, 1, 1, 0, 3),
    (56, 56, 256, 64, 1, 1, 1, 0, 1),
    (56, 56, 256, 256, 1, 1, 1, 0, 1),
    (28, 28, 256, 512, 1, 1, 1, 0, 3),
    (28, 28, 512, 256, 1, 1, 1, 0, 4),
    (56, 56, 512, 256, 1, 1, 2, 0, 1),
    (28, 28, 512, 512, 1, 1, 1, 0, 1),
    (14, 14, 512, 1024, 1, 1, 1, 0, 5),
    (14, 14, 1024, 512, 1, 1, 1, 0, 6),
    (28, 28, 1024, 512, 1, 1, 2, 0, 1),
    (14, 14, 1024, 1024, 1, 1, 1, 0, 1),
    (7, 7, 1024, 2048, 1, 1, 1, 0, 2),
    (7, 7, 2048, 1024, 1, 1, 1, 0, 3),
    (14, 14, 2048, 1024, 1, 1, 2, 0, 1),
]


def _scale_hw(convs, image_size: int, base: int = 224):
    scale = image_size / float(base)
    out = []
    for (h, w, co, ci, kh, kw, s, p, wt) in convs:
        if h >= 7:  # spatial layers scale with the input image
            h2 = max(1, int(round(h * scale)))
            w2 = max(1, int(round(w * scale)))
        else:
            h2, w2 = h, w
        out.append((h2, w2, co, ci, kh, kw, s, p, wt))
    return out


_WIDE_RESNET50_CONVS = [
    # wide_resnet50_2: bottleneck inner width doubled, expansion
    # channels unchanged (Zagoruyko & Komodakis 2016; torchvision
    # width_per_group=128) — traced via frontend/zoo.py
    (224, 224, 64, 3, 7, 7, 2, 3, 1),
    (56, 56, 256, 64, 1, 1, 1, 0, 1),
    (56, 56, 128, 64, 1, 1, 1, 0, 1),
    (56, 56, 128, 128, 3, 3, 1, 1, 3),
    (56, 56, 256, 128, 1, 1, 1, 0, 3),
    (56, 56, 128, 256, 1, 1, 1, 0, 2),
    (56, 56, 512, 256, 1, 1, 2, 0, 1),
    (56, 56, 256, 256, 1, 1, 1, 0, 1),
    (56, 56, 256, 256, 3, 3, 2, 1, 1),
    (28, 28, 512, 256, 1, 1, 1, 0, 4),
    (28, 28, 256, 512, 1, 1, 1, 0, 3),
    (28, 28, 256, 256, 3, 3, 1, 1, 3),
    (28, 28, 1024, 512, 1, 1, 2, 0, 1),
    (28, 28, 512, 512, 1, 1, 1, 0, 1),
    (28, 28, 512, 512, 3, 3, 2, 1, 1),
    (14, 14, 1024, 512, 1, 1, 1, 0, 6),
    (14, 14, 512, 1024, 1, 1, 1, 0, 5),
    (14, 14, 512, 512, 3, 3, 1, 1, 5),
    (14, 14, 2048, 1024, 1, 1, 2, 0, 1),
    (14, 14, 1024, 1024, 1, 1, 1, 0, 1),
    (14, 14, 1024, 1024, 3, 3, 2, 1, 1),
    (7, 7, 2048, 1024, 1, 1, 1, 0, 3),
    (7, 7, 1024, 2048, 1, 1, 1, 0, 2),
    (7, 7, 1024, 1024, 3, 3, 1, 1, 2),
]


NETWORK_CONVS = {
    "resnet_50": _RESNET50_CONVS,
    "resnet_18": _RESNET18_CONVS,
    "wide_resnet_50": _WIDE_RESNET50_CONVS,
    "mobilenet_v2": _MOBILENET_V2_CONVS,
    "resnext_50": _RESNEXT50_CONVS,
}


# Full traced task tables (op, args-with-batch-1, weight) at each
# family's native input size, generated by tracing frontend/zoo.py
# models with frontend/torch_fx.py (the reference extracts these
# through relay from the same torchvision graphs,
# dump_network_info.py:27-62). Regenerate with
# ``dump_network_info.py --from-model <name>`` after zoo changes.
_TRACED_TASKS = {
    "mobilenet_v3": [
        ('conv2d_layer', (1, 224, 224, 16, 3, 3, 3, (2, 2), (1, 1)), 1),
        ('depthwise_conv2d_layer', (1, 112, 112, 16, 3, 3, (1, 1), (1, 1)), 1),
        ('conv2d_layer', (1, 112, 112, 16, 16, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 112, 112, 64, 16, 1, 1, (1, 1), (0, 0)), 1),
        ('depthwise_conv2d_layer', (1, 112, 112, 64, 3, 3, (2, 2), (1, 1)), 1),
        ('conv2d_layer', (1, 56, 56, 24, 64, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 56, 56, 72, 24, 1, 1, (1, 1), (0, 0)), 2),
        ('depthwise_conv2d_layer', (1, 56, 56, 72, 3, 3, (1, 1), (1, 1)), 1),
        ('conv2d_layer', (1, 56, 56, 24, 72, 1, 1, (1, 1), (0, 0)), 1),
        ('depthwise_conv2d_layer', (1, 56, 56, 72, 5, 5, (2, 2), (2, 2)), 1),
        ('avg_pool2d_layer', (1, 28, 28, 72, 28, 1, 0), 1),
        ('conv2d_layer', (1, 1, 1, 24, 72, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 1, 1, 72, 24, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 40, 72, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 120, 40, 1, 1, (1, 1), (0, 0)), 2),
        ('depthwise_conv2d_layer', (1, 28, 28, 120, 5, 5, (1, 1), (2, 2)), 2),
        ('avg_pool2d_layer', (1, 28, 28, 120, 28, 1, 0), 2),
        ('conv2d_layer', (1, 1, 1, 32, 120, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 1, 1, 120, 32, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 28, 28, 40, 120, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 28, 28, 240, 40, 1, 1, (1, 1), (0, 0)), 1),
        ('depthwise_conv2d_layer', (1, 28, 28, 240, 3, 3, (2, 2), (1, 1)), 1),
        ('conv2d_layer', (1, 14, 14, 80, 240, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 200, 80, 1, 1, (1, 1), (0, 0)), 1),
        ('depthwise_conv2d_layer', (1, 14, 14, 200, 3, 3, (1, 1), (1, 1)), 1),
        ('conv2d_layer', (1, 14, 14, 80, 200, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 184, 80, 1, 1, (1, 1), (0, 0)), 2),
        ('depthwise_conv2d_layer', (1, 14, 14, 184, 3, 3, (1, 1), (1, 1)), 2),
        ('conv2d_layer', (1, 14, 14, 80, 184, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 14, 14, 480, 80, 1, 1, (1, 1), (0, 0)), 1),
        ('depthwise_conv2d_layer', (1, 14, 14, 480, 3, 3, (1, 1), (1, 1)), 1),
        ('avg_pool2d_layer', (1, 14, 14, 480, 14, 1, 0), 1),
        ('conv2d_layer', (1, 1, 1, 120, 480, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 1, 1, 480, 120, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 112, 480, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 672, 112, 1, 1, (1, 1), (0, 0)), 2),
        ('depthwise_conv2d_layer', (1, 14, 14, 672, 3, 3, (1, 1), (1, 1)), 1),
        ('avg_pool2d_layer', (1, 14, 14, 672, 14, 1, 0), 1),
        ('conv2d_layer', (1, 1, 1, 168, 672, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 1, 1, 672, 168, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 14, 14, 112, 672, 1, 1, (1, 1), (0, 0)), 1),
        ('depthwise_conv2d_layer', (1, 14, 14, 672, 5, 5, (2, 2), (2, 2)), 1),
        ('avg_pool2d_layer', (1, 7, 7, 672, 7, 1, 0), 1),
        ('conv2d_layer', (1, 7, 7, 160, 672, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 960, 160, 1, 1, (1, 1), (0, 0)), 3),
        ('depthwise_conv2d_layer', (1, 7, 7, 960, 5, 5, (1, 1), (2, 2)), 2),
        ('avg_pool2d_layer', (1, 7, 7, 960, 7, 1, 0), 3),
        ('conv2d_layer', (1, 1, 1, 240, 960, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 1, 1, 960, 240, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 7, 7, 160, 960, 1, 1, (1, 1), (0, 0)), 2),
        ('matmul_add', (1, 960, 1280, 'float32'), 1),
        ('matmul_add', (1, 1280, 1000, 'float32'), 1),
    ],
    "densenet_121": [
        ('conv2d_layer', (1, 224, 224, 64, 3, 7, 7, (2, 2), (3, 3)), 1),
        ('max_pool2d_layer', (1, 112, 112, 64, 3, 2, 1), 1),
        ('conv2d_layer', (1, 56, 56, 128, 64, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 56, 56, 32, 128, 3, 3, (1, 1), (1, 1)), 6),
        ('conv2d_layer', (1, 56, 56, 128, 96, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 56, 56, 128, 128, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 56, 56, 128, 160, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 56, 56, 128, 192, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 56, 56, 128, 224, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 56, 56, 128, 256, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 56, 56, 128, 2, 2, 0), 1),
        ('conv2d_layer', (1, 28, 28, 128, 128, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 32, 128, 3, 3, (1, 1), (1, 1)), 12),
        ('conv2d_layer', (1, 28, 28, 128, 160, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 192, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 224, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 256, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 288, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 320, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 352, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 384, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 416, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 448, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 128, 480, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 28, 28, 256, 512, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 28, 28, 256, 2, 2, 0), 1),
        ('conv2d_layer', (1, 14, 14, 128, 256, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 32, 128, 3, 3, (1, 1), (1, 1)), 24),
        ('conv2d_layer', (1, 14, 14, 128, 288, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 320, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 352, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 384, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 416, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 448, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 480, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 512, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 544, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 576, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 608, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 640, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 672, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 704, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 736, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 768, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 800, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 832, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 864, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 896, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 928, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 960, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 128, 992, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 14, 14, 512, 1024, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 14, 14, 512, 2, 2, 0), 1),
        ('conv2d_layer', (1, 7, 7, 128, 512, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 32, 128, 3, 3, (1, 1), (1, 1)), 16),
        ('conv2d_layer', (1, 7, 7, 128, 544, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 576, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 608, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 640, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 672, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 704, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 736, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 768, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 800, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 832, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 864, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 896, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 928, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 960, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 7, 7, 128, 992, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 7, 7, 1024, 7, 1, 0), 1),
        ('matmul_add', (1, 1024, 1000, 'float32'), 1),
    ],
    "inception_v3": [
        ('conv2d_layer', (1, 299, 299, 32, 3, 3, 3, (2, 2), (0, 0)), 1),
        ('conv2d_layer', (1, 149, 149, 32, 32, 3, 3, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 147, 147, 64, 32, 3, 3, (1, 1), (1, 1)), 1),
        ('max_pool2d_layer', (1, 147, 147, 64, 3, 2, 0), 1),
        ('conv2d_layer', (1, 73, 73, 80, 64, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 73, 73, 192, 80, 3, 3, (1, 1), (0, 0)), 1),
        ('max_pool2d_layer', (1, 71, 71, 192, 3, 2, 0), 1),
        ('conv2d_layer', (1, 35, 35, 64, 192, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 35, 35, 48, 192, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 35, 35, 64, 48, 5, 5, (1, 1), (2, 2)), 3),
        ('conv2d_layer', (1, 35, 35, 96, 64, 3, 3, (1, 1), (1, 1)), 4),
        ('conv2d_layer', (1, 35, 35, 96, 96, 3, 3, (1, 1), (1, 1)), 3),
        ('avg_pool2d_layer', (1, 35, 35, 192, 3, 1, 1), 1),
        ('conv2d_layer', (1, 35, 35, 32, 192, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 35, 35, 64, 256, 1, 1, (1, 1), (0, 0)), 3),
        ('conv2d_layer', (1, 35, 35, 48, 256, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 35, 35, 256, 3, 1, 1), 1),
        ('conv2d_layer', (1, 35, 35, 64, 288, 1, 1, (1, 1), (0, 0)), 4),
        ('conv2d_layer', (1, 35, 35, 48, 288, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 35, 35, 288, 3, 1, 1), 1),
        ('conv2d_layer', (1, 35, 35, 384, 288, 3, 3, (2, 2), (0, 0)), 1),
        ('conv2d_layer', (1, 35, 35, 96, 96, 3, 3, (2, 2), (0, 0)), 1),
        ('max_pool2d_layer', (1, 35, 35, 288, 3, 2, 0), 1),
        ('conv2d_layer', (1, 17, 17, 192, 768, 1, 1, (1, 1), (0, 0)), 12),
        ('conv2d_layer', (1, 17, 17, 128, 768, 1, 1, (1, 1), (0, 0)), 2),
        ('conv2d_layer', (1, 17, 17, 128, 128, 1, 7, (1, 1), (0, 3)), 2),
        ('conv2d_layer', (1, 17, 17, 192, 128, 7, 1, (1, 1), (3, 0)), 1),
        ('conv2d_layer', (1, 17, 17, 128, 128, 7, 1, (1, 1), (3, 0)), 2),
        ('conv2d_layer', (1, 17, 17, 192, 128, 1, 7, (1, 1), (0, 3)), 1),
        ('avg_pool2d_layer', (1, 17, 17, 768, 3, 1, 1), 4),
        ('conv2d_layer', (1, 17, 17, 160, 768, 1, 1, (1, 1), (0, 0)), 4),
        ('conv2d_layer', (1, 17, 17, 160, 160, 1, 7, (1, 1), (0, 3)), 4),
        ('conv2d_layer', (1, 17, 17, 192, 160, 7, 1, (1, 1), (3, 0)), 2),
        ('conv2d_layer', (1, 17, 17, 160, 160, 7, 1, (1, 1), (3, 0)), 4),
        ('conv2d_layer', (1, 17, 17, 192, 160, 1, 7, (1, 1), (0, 3)), 2),
        ('conv2d_layer', (1, 17, 17, 192, 192, 1, 7, (1, 1), (0, 3)), 4),
        ('conv2d_layer', (1, 17, 17, 192, 192, 7, 1, (1, 1), (3, 0)), 4),
        ('conv2d_layer', (1, 17, 17, 320, 192, 3, 3, (2, 2), (0, 0)), 1),
        ('conv2d_layer', (1, 17, 17, 192, 192, 3, 3, (2, 2), (0, 0)), 1),
        ('max_pool2d_layer', (1, 17, 17, 768, 3, 2, 0), 1),
        ('conv2d_layer', (1, 8, 8, 384, 1280, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 8, 8, 448, 1280, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 8, 8, 384, 448, 3, 3, (1, 1), (1, 1)), 2),
        ('conv2d_layer', (1, 8, 8, 320, 1280, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 8, 8, 384, 384, 1, 3, (1, 1), (0, 1)), 4),
        ('conv2d_layer', (1, 8, 8, 384, 384, 3, 1, (1, 1), (1, 0)), 4),
        ('avg_pool2d_layer', (1, 8, 8, 1280, 3, 1, 1), 1),
        ('conv2d_layer', (1, 8, 8, 192, 1280, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 8, 8, 384, 2048, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 8, 8, 448, 2048, 1, 1, (1, 1), (0, 0)), 1),
        ('conv2d_layer', (1, 8, 8, 320, 2048, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 8, 8, 2048, 3, 1, 1), 1),
        ('conv2d_layer', (1, 8, 8, 192, 2048, 1, 1, (1, 1), (0, 0)), 1),
        ('avg_pool2d_layer', (1, 8, 8, 2048, 8, 1, 0), 1),
        ('matmul_add', (1, 2048, 1000, 'float32'), 1),
    ],
    "resnet3d_18": [
        ('conv3d_layer', (1, 16, 112, 112, 64, 3, 3, 7, 7, (1, 2, 2), (1, 3, 3)), 1),
        ('conv3d_layer', (1, 16, 56, 56, 64, 64, 3, 3, 3, (1, 1, 1), (1, 1, 1)), 4),
        ('conv3d_layer', (1, 16, 56, 56, 128, 64, 1, 1, 1, (2, 2, 2), (0, 0, 0)), 1),
        ('conv3d_layer', (1, 16, 56, 56, 128, 64, 3, 3, 3, (2, 2, 2), (1, 1, 1)), 1),
        ('conv3d_layer', (1, 8, 28, 28, 128, 128, 3, 3, 3, (1, 1, 1), (1, 1, 1)), 3),
        ('conv3d_layer', (1, 8, 28, 28, 256, 128, 1, 1, 1, (2, 2, 2), (0, 0, 0)), 1),
        ('conv3d_layer', (1, 8, 28, 28, 256, 128, 3, 3, 3, (2, 2, 2), (1, 1, 1)), 1),
        ('conv3d_layer', (1, 4, 14, 14, 256, 256, 3, 3, 3, (1, 1, 1), (1, 1, 1)), 3),
        ('conv3d_layer', (1, 4, 14, 14, 512, 256, 1, 1, 1, (2, 2, 2), (0, 0, 0)), 1),
        ('conv3d_layer', (1, 4, 14, 14, 512, 256, 3, 3, 3, (2, 2, 2), (1, 1, 1)), 1),
        ('conv3d_layer', (1, 2, 7, 7, 512, 512, 3, 3, 3, (1, 1, 1), (1, 1, 1)), 3),
        ('matmul_add', (1, 512, 400, 'float32'), 1),
    ],
    # vgg16 config D, no BN (reference dump_network_info.py:46-48):
    # 3x3 conv stacks + 2x2 max-pools, adaptive 7x7 avg-pool,
    # 4096-4096-1000 classifier. Table traced from frontend/zoo.py.
    "vgg_16": [
        ('conv2d_layer', (1, 224, 224, 64, 3, 3, 3, (1, 1), (1, 1)), 1),
        ('conv2d_layer', (1, 224, 224, 64, 64, 3, 3, (1, 1), (1, 1)), 1),
        ('max_pool2d_layer', (1, 224, 224, 64, 2, 2, 0), 1),
        ('conv2d_layer', (1, 112, 112, 128, 64, 3, 3, (1, 1), (1, 1)), 1),
        ('conv2d_layer', (1, 112, 112, 128, 128, 3, 3, (1, 1), (1, 1)), 1),
        ('max_pool2d_layer', (1, 112, 112, 128, 2, 2, 0), 1),
        ('conv2d_layer', (1, 56, 56, 256, 128, 3, 3, (1, 1), (1, 1)), 1),
        ('conv2d_layer', (1, 56, 56, 256, 256, 3, 3, (1, 1), (1, 1)), 2),
        ('max_pool2d_layer', (1, 56, 56, 256, 2, 2, 0), 1),
        ('conv2d_layer', (1, 28, 28, 512, 256, 3, 3, (1, 1), (1, 1)), 1),
        ('conv2d_layer', (1, 28, 28, 512, 512, 3, 3, (1, 1), (1, 1)), 2),
        ('max_pool2d_layer', (1, 28, 28, 512, 2, 2, 0), 1),
        ('conv2d_layer', (1, 14, 14, 512, 512, 3, 3, (1, 1), (1, 1)), 3),
        ('max_pool2d_layer', (1, 14, 14, 512, 2, 2, 0), 1),
        ('avg_pool2d_layer', (1, 7, 7, 512, 1, 1, 0), 1),
        ('matmul_add', (1, 25088, 4096, 'float32'), 1),
        ('matmul_add', (1, 4096, 4096, 'float32'), 1),
        ('matmul_add', (1, 4096, 1000, 'float32'), 1),
    ],
}

# native input size per traced family (the 224 default sentinel maps
# here; other grid sizes scale spatial dims like _scale_hw)
_TRACED_BASE = {"mobilenet_v3": 224, "densenet_121": 224,
                "inception_v3": 299, "resnet3d_18": 112, "vgg_16": 224}


def _scale_traced(op, args, scale):
    """Scale a traced task's spatial dims for an off-base image size,
    mirroring _scale_hw's conventions (maps under 7 px and non-spatial
    ops unscaled; global-pool kernels follow the map)."""
    a = list(args)

    def sc(v):
        return max(1, int(round(v * scale)))

    if op in ("conv2d_layer", "depthwise_conv2d_layer",
              "group_conv2d_layer"):
        if a[1] >= 7:
            a[1], a[2] = sc(a[1]), sc(a[2])
    elif op == "conv3d_layer":
        if a[2] >= 7:
            a[2], a[3] = sc(a[2]), sc(a[3])
    elif op in ("max_pool2d_layer", "avg_pool2d_layer"):
        h = a[1]
        if h >= 7:
            a[1], a[2] = sc(a[1]), sc(a[2])
            if a[4] == h:  # global pool: kernel spans the map
                a[4] = a[1]
    return a


def _traced_task_keys(name, batch_size, image_size):
    base = _TRACED_BASE[name]
    if image_size == 224 and base != 224:
        image_size = base
    scale = image_size / float(base)
    for op, args, wt in _TRACED_TASKS[name]:
        a = _scale_traced(op, args, scale)
        a[0] = batch_size  # matmul_add rows are batch x feat for heads
        a = [list(x) if isinstance(x, tuple) else x for x in a]
        yield make_workload_key(op, tuple(a)), float(wt)


def build_network_keys() -> List[Tuple[str, Tuple]]:
    """The full benchmark grid of the reference's dump_network_info.py
    (:139-204): network family x batch size x image/seq size. (The
    reference file short-circuits after the resnet block with an early
    ``return``; this is the grid its dead code and README describe.)"""
    keys = []
    for batch_size in [1]:
        for image_size in [224, 240, 256]:
            for layer in [18, 50]:
                keys.append((f"resnet_{layer}", (batch_size, image_size)))
    for batch_size in [1, 4, 8]:
        for image_size in [224, 240, 256]:
            for name in ["mobilenet_v2", "mobilenet_v3",
                         "wide_resnet_50", "resnext_50"]:
                keys.append((name, (batch_size, image_size)))
    for batch_size in [1, 2, 4]:
        keys.append(("inception_v3", (batch_size, 299)))
        for image_size in [224, 240, 256]:
            keys.append(("densenet_121", (batch_size, image_size)))
        for image_size in [112, 128, 144]:
            keys.append(("resnet3d_18", (batch_size, image_size)))
        for seq_length in [64, 128, 256]:
            for scale in ["tiny", "medium", "base", "large"]:
                keys.append((f"bert_{scale}", (batch_size, seq_length)))
    for batch_size in [1, 4, 8]:
        for image_size in [64, 80, 96]:
            keys.append(("dcgan", (batch_size, image_size)))
    return keys


def get_network_tasks(name: str, batch_size: int = 1, image_size: int = 224,
                      target: str = "llvm") -> Tuple[List[SearchTask], List[float]]:
    """Tasks + weights for a named network."""
    tasks, weights = [], []
    if name.startswith("bert_"):
        # image_size carries the sequence length for bert grid keys
        hidden, n_layers, n_heads = _BERT_DIMS[name.split("_", 1)[1]]
        # 224 is the image-size default sentinel; bert keys carry the
        # sequence length in that slot
        seq = 128 if image_size == 224 else image_size
        for (n_tok, d_in, d_out, wt) in _bert_matmuls(seq, hidden,
                                                      n_layers):
            key = make_workload_key(
                "matmul_add", (batch_size * n_tok, d_in, d_out, "float32")
            )
            tasks.append(SearchTask(key, target))
            weights.append(float(wt))
        for (b_fac, n, m, k, wt) in _bert_batch_matmuls(
                seq, hidden, n_layers, n_heads):
            key = make_workload_key(
                "batch_matmul", (batch_size * b_fac, n, m, k, "float32")
            )
            tasks.append(SearchTask(key, target))
            weights.append(float(wt))
        return tasks, weights

    if name == "dcgan":
        # relay/testing/dcgan.py generator: dense + 4 transposed convs;
        # non-default image sizes scale the spatial grid (base 64)
        base_size = 64 if image_size == 224 else image_size
        bs4 = max(1, base_size // 16)
        key = make_workload_key(
            "matmul_add", (batch_size, 100, bs4 * bs4 * 1024, "float32")
        )
        tasks.append(SearchTask(key, target))
        weights.append(1.0)
        for i, (h, w, co, ci) in enumerate(_DCGAN_TCONVS):
            h2, w2 = bs4 * (h // 4), bs4 * (w // 4)
            key = make_workload_key(
                "conv2d_transpose_layer",
                (batch_size, h2, w2, co, ci, 4, 4, [2, 2], [1, 1]),
            )
            tasks.append(SearchTask(key, target))
            weights.append(1.0)
        return tasks, weights

    if name in _TRACED_TASKS:
        for key, wt in _traced_task_keys(name, batch_size, image_size):
            tasks.append(SearchTask(key, target))
            weights.append(wt)
        return tasks, weights

    base = NETWORK_CONVS.get(name)
    if base is None:
        raise ValueError(f"unknown network {name}")
    convs = _scale_hw(base, image_size, 224)
    for (h, w, co, ci, kh, kw, s, p, wt) in convs:
        key = make_workload_key(
            "conv2d_layer", (batch_size, h, w, co, ci, kh, kw, [s, s], [p, p])
        )
        tasks.append(SearchTask(key, target))
        weights.append(float(wt))
    if name == "resnext_50":
        scale = image_size / 224.0
        for (h, w, c, s, wt) in _RESNEXT50_GROUP_CONVS:
            h2 = max(1, int(round(h * scale)))
            w2 = max(1, int(round(w * scale)))
            key = make_workload_key(
                "group_conv2d_layer",
                (batch_size, h2, w2, c, c, 3, 3, [s, s], [1, 1], 32),
            )
            tasks.append(SearchTask(key, target))
            weights.append(float(wt))
    if name == "mobilenet_v2":
        scale = image_size / 224.0
        for (h, w, c, kh, kw, s, p, wt) in _MOBILENET_V2_DEPTHWISE:
            h2 = max(1, int(round(h * scale)))
            w2 = max(1, int(round(w * scale)))
            key = make_workload_key(
                "depthwise_conv2d_layer",
                (batch_size, h2, w2, c, kh, kw, [s, s], [p, p]),
            )
            tasks.append(SearchTask(key, target))
            weights.append(float(wt))
    for key in _head_task_keys(name, batch_size, image_size):
        tasks.append(SearchTask(key, target))
        weights.append(1.0)
    return tasks, weights


# per-family (stem_maxpool?, feat_channels, extra_dense_in) for the
# non-conv tasks relay extraction also yields: stem max pool, global
# average pool, classifier dense(s) (torchvision model heads)
_NETWORK_HEADS = {
    "resnet_18": (True, 512, None),
    "resnet_50": (True, 2048, None),
    "wide_resnet_50": (True, 2048, None),
    "resnext_50": (True, 2048, None),
    "mobilenet_v2": (False, 1280, None),
    # mbv3 / inception_v3 / densenet_121 heads now live in their
    # _TRACED_TASKS tables (get_network_tasks returns early for them)
}

def _head_task_keys(name: str, batch_size: int, image_size: int):
    """Workload keys for the non-conv layers of a conv-family network:
    stem max pool, global average pool, and the classifier matmul(s).
    Mirrors what the reference's relay task extraction yields beyond
    convolutions (dump_network_info.py get_network_with_key builds the
    full torchvision graph; complex reduce ops become their own tasks)."""
    head = _NETWORK_HEADS.get(name)
    if head is None:
        return
    stem_pool, feat_ch, extra_dense = head
    base = 299 if name == "inception_v3" else 224
    scale = image_size / float(base)
    if stem_pool:
        # 3x3/stride-2/pad-1 max pool on the post-stem 112-px, 64-ch map
        h = max(1, int(round(112 * scale)))
        yield make_workload_key(
            "max_pool2d_layer", (batch_size, h, h, 64, 3, 2, 1)
        )
    # global average pool over the final feature map (7 px at 224 base,
    # 8 px at 299) then the classifier dense to 1000 classes
    fs = max(1, int(round((8 if base == 299 else 7) * scale)))
    yield make_workload_key(
        "avg_pool2d_layer", (batch_size, fs, fs, feat_ch, fs, 1, 0)
    )
    if extra_dense is not None:
        yield make_workload_key(
            "matmul_add", (batch_size, feat_ch, extra_dense, "float32")
        )
        feat_ch = extra_dense
    yield make_workload_key(
        "matmul_add", (batch_size, feat_ch, 1000, "float32")
    )
