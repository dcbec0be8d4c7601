"""The port's graph front end (``frontend/``) and layout rewriting
(``ir/layout.py``) against the JAX package's on the CPU: the same tasks
and weights from the same zoo networks (the JAX ``tests/test_frontend.py``
set), off-grid and custom modules, the Hugging Face path where
``transformers`` is installed, and ``rewrite_layout`` /
``transform_array`` on the same schedules."""

import json

import numpy as np
import pytest
import torch

from vae_extent_search_tpu import frontend as jfront
from vae_extent_search_tpu.ir import layout as jlayout
from vae_extent_search_tpu.records import serde as jserde
from vae_extent_search_tpu_torch import frontend as tfront
from vae_extent_search_tpu_torch.frontend import torch_fx as tfx
from vae_extent_search_tpu_torch.ir import layout as tlayout
from vae_extent_search_tpu_torch.records import SearchTask, make_workload_key
from vae_extent_search_tpu_torch.records import serde as tserde
from vae_extent_search_tpu_torch.records.networks import get_network_tasks
from vae_extent_search_tpu_torch.search.sketch import make_states

ZOO = [
    ("resnet_18", (1, 3, 224, 224)),
    ("resnet_50", (1, 3, 224, 224)),
    ("wide_resnet_50", (1, 3, 224, 224)),
    ("resnext_50", (1, 3, 224, 224)),
    ("mobilenet_v2", (1, 3, 224, 224)),
    ("mobilenet_v3", (1, 3, 224, 224)),
    ("densenet_121", (1, 3, 224, 224)),
    ("inception_v3", (1, 3, 299, 299)),
    ("resnet3d_18", (1, 3, 16, 112, 112)),
    ("vgg_16", (1, 3, 224, 224)),
    ("dcgan", (1, 100)),
]


def _tasks(tasks, weights):
    return [(t.workload_key, t.target, w) for t, w in zip(tasks, weights)]


@pytest.mark.parametrize("name,shape", ZOO, ids=[n for n, _ in ZOO])
def test_zoo_tasks_equal_jax(name, shape):
    """Each zoo network traced by the port gives the JAX front end's tasks
    and weights, in the same order, and the static table's set."""
    got = _tasks(*tfront.extract_tasks_from_module(
        tfront.build_zoo_model(name), shape, "llvm"))
    want = _tasks(*jfront.extract_tasks_from_module(
        jfront.build_zoo_model(name), shape, "llvm"))
    assert got == want
    size = {"dcgan": 64, "inception_v3": 299,
            "resnet3d_18": 112}.get(name, 224)
    static = {t.workload_key: w for t, w in zip(*get_network_tasks(
        name, 1, size))}
    assert {k: w for k, _, w in got} == static


def test_zoo_builders_are_the_jax_ones():
    assert sorted(tfront.ZOO_BUILDERS) == sorted(jfront.ZOO_BUILDERS)
    assert {n for n, _ in ZOO} <= set(tfront.ZOO_BUILDERS)


@pytest.mark.parametrize("shape", [(2, 3, 160, 160), (4, 3, 96, 128)])
def test_off_grid_shapes_equal_jax(shape):
    """Shapes the static grid never enumerated come from shape
    propagation, in both packages alike (the target carried through)."""
    tgt = "cuda"
    got = _tasks(*tfront.extract_tasks_from_module(
        tfront.build_zoo_model("resnet_18"), shape, tgt))
    want = _tasks(*jfront.extract_tasks_from_module(
        jfront.build_zoo_model("resnet_18"), shape, tgt))
    assert got == want
    convs = [json.loads(k) for k, _, _ in got
             if json.loads(k)[0] == "conv2d_layer"]
    assert all(k[1] == shape[0] for k in convs)
    assert convs[0][2:4] == list(shape[2:])
    assert {t for _, t, _ in got} == {tgt}


def test_custom_module_equals_jax():
    """Any fx-traceable module: conv, depthwise, grouped, transposed and
    3-D convs, pools, linear and batched matmuls map onto the registry in
    both packages alike."""
    import torch.nn as nn

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(8, 16, 3, 2, 1)
            self.dw = nn.Conv2d(16, 16, 3, 1, 1, groups=16)
            self.gc = nn.Conv2d(16, 32, 3, 1, 1, groups=4)
            self.up = nn.ConvTranspose2d(32, 8, 4, 2, 1)
            self.pool = nn.MaxPool2d(2)
            self.avg = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(8, 10)

        def forward(self, x):
            x = self.gc(self.dw(self.conv(x)))
            x = self.pool(self.up(x))
            y = self.avg(x).flatten(1)
            a = y[:, None, :].expand(-1, 6, -1)
            att = torch.matmul(a, a.transpose(1, 2))
            return self.fc(y) + att.sum()

    shape = (4, 8, 32, 32)
    got = _tasks(*tfront.extract_tasks_from_module(Net(), shape))
    want = _tasks(*jfront.extract_tasks_from_module(Net(), shape))
    assert got == want
    ops = [json.loads(k)[0] for k, _, _ in got]
    assert ops[:4] == ["conv2d_layer", "depthwise_conv2d_layer",
                       "group_conv2d_layer", "conv2d_transpose_layer"]
    assert "matmul_add" in ops and "batch_matmul" in ops


def test_traced_bert_equals_jax():
    """The Hugging Face path (transformers' fx tracer), where transformers
    is installed: bert_tiny's tasks as the JAX front end traces them."""
    transformers = pytest.importorskip("transformers")
    from vae_extent_search_tpu.frontend.torch_fx import extract_tasks_from_hf

    cfg = transformers.BertConfig(hidden_size=512, num_hidden_layers=6,
                                  num_attention_heads=8,
                                  intermediate_size=2048)
    torch.manual_seed(0)
    got = _tasks(*tfx.extract_tasks_from_hf(transformers.BertModel(cfg),
                                            1, 128))
    want = _tasks(*extract_tasks_from_hf(transformers.BertModel(cfg), 1,
                                         128))
    assert got == want and len(got) >= 5


# ---------------------------------------------------------------------------
# layout rewriting
# ---------------------------------------------------------------------------


def _states(target, seed, n=8, wl=(1, 14, 14, 64, 64, 3, 3, [1, 1], [1, 1])):
    task = SearchTask(make_workload_key("conv2d_layer", wl), target)
    return task, make_states(task, n, evo_population=16, min_population=n,
                             seed=seed)


@pytest.mark.parametrize("target,seed", [
    ("llvm -mcpu=skylake-avx512", 3), ("llvm -mcpu=skylake-avx512", 5),
    ("llvm", 7), ("cuda", 4)])
def test_rewrite_layout_equals_jax(tmp_path, target, seed):
    """tests/test_ir_replay.py's setting (conv2d 1 x 14 x 14 x 64 -> 64,
    3 x 3): the port's schedules, carried as records to the JAX package;
    both rewrite the weight's layout alike, the new DAG keeps the FLOPs
    and replays the schedule, and transform_array repacks a weight to the
    same array."""
    task, states = _states(target, seed)
    path = str(tmp_path / "l.json")
    tserde.save_records(path, [tserde.make_record(task, st.transform_steps,
                                                  [1.0]) for st in states],
                        mode="w")
    rng = np.random.default_rng(seed)
    n_done = 0
    for trec, jrec in zip(tserde.load_records(path),
                          jserde.load_records(path)):
        tdag, jdag = trec.inp.task.compute_dag, jrec.inp.task.compute_dag
        new_t, lay_t = tlayout.rewrite_layout(tdag, trec.inp.step_records)
        new_j, lay_j = jlayout.rewrite_layout(jdag, jrec.inp.step_records)
        assert lay_t == lay_j
        assert new_t.flop_ct == pytest.approx(new_j.flop_ct, rel=1e-12)
        if not lay_t:
            continue
        n_done += 1
        (orig, new), = lay_t.values()
        w = rng.standard_normal([e for _, e in orig]).astype(np.float32)
        got = tlayout.transform_array(w, orig, new)
        assert np.array_equal(got, jlayout.transform_array(w, orig, new))
        assert got.shape == tuple(e for _, e in new)
        assert abs(new_t.flop_ct - tdag.flop_ct) <= 1e-6 * tdag.flop_ct
        new_t.infer_bound(new_t.apply_steps(trec.inp.step_records))
    if target.startswith("llvm"):
        assert n_done >= 3


def test_transform_array_is_a_permutation():
    """Repacking moves every element once: the sorted values are the
    original's, and splitting an axis into tiles in loop order is a
    reshape + transpose of the original array."""
    orig = [("a", 4), ("b", 6)]
    new = [("b", 2), ("a", 4), ("b", 3)]
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = tlayout.transform_array(w, orig, new)
    assert got.shape == (2, 4, 3)
    assert np.array_equal(got, jlayout.transform_array(w, orig, new))
    assert np.array_equal(got, w.reshape(4, 2, 3).transpose(1, 0, 2))
    assert np.array_equal(np.sort(got.ravel()), w.ravel())
