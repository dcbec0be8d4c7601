"""The port's multi-process runtime (``parallel/multihost.py``) against the
JAX package's: round-robin task shards and record-log merges equal on the
same inputs; a 2-rank gloo cluster forms from the ``VES_*`` variables and
its shards are disjoint and cover the tasks."""

import os

import pytest
import torch

from _torch_mh import run_ranks
from vae_extent_search_tpu.parallel import multihost as jm
from vae_extent_search_tpu_torch.parallel import multihost as tm


@pytest.mark.parametrize("n,count", [(10, 3), (7, 2), (3, 4), (0, 2),
                                     (13, 1)])
def test_shard_tasks_matches_jax(n, count):
    tasks = [f"task{i}" for i in range(n)]
    shards = [tm.shard_tasks(tasks, i, count) for i in range(count)]
    assert shards == [jm.shard_tasks(tasks, i, count) for i in range(count)]
    assert sorted(sum(shards, [])) == sorted(tasks)


def test_shard_tasks_without_a_group_is_everything():
    assert tm.shard_tasks(list(range(5))) == list(range(5))


def _logs(tmp_path, sub):
    d = tmp_path / sub
    d.mkdir()
    (d / "a.json").write_text("x\ny\n\ny\n")
    (d / "b.json").write_text("y\nz\n")
    return [str(d / "a.json"), str(d / "b.json"), str(d / "nope.json")], d


@pytest.mark.parametrize("dedup", [True, False])
def test_merge_record_logs_matches_jax(tmp_path, dedup):
    """Same lines written and the same count, then a retried merge: with
    dedup it writes nothing twice (idempotent), and the output among the
    inputs is skipped."""
    outs = {}
    for name, mod in (("jax", jm), ("torch", tm)):
        paths, d = _logs(tmp_path, name)
        out = str(d / "merged.json")
        n1 = mod.merge_record_logs(paths, out, dedup=dedup)
        n2 = mod.merge_record_logs(paths + [out], out, dedup=dedup)
        outs[name] = (n1, n2, open(out).read())
    assert outs["torch"] == outs["jax"]
    if dedup:
        assert outs["torch"][:2] == (3, 0)
        assert outs["torch"][2].splitlines() == ["x", "y", "z"]


def test_no_cluster_is_a_noop(monkeypatch):
    for k in ("VES_COORDINATOR", "VES_NUM_PROCESSES", "VES_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tm.maybe_initialize_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


def test_default_backend(monkeypatch):
    """gloo on the CPU and where ranks share cards; NCCL only with a card
    per rank."""
    assert tm.default_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tm.default_backend(2, "cuda") == "gloo"
    assert tm.default_backend(1, "cuda") == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tm.default_backend(4, "cuda") == "nccl"
    assert tm.local_device("cuda", 5) == torch.device("cuda", 1)
    assert tm.local_device("cpu", 5) == torch.device("cpu")


def test_two_rank_gloo_cluster(tmp_path):
    tasks = [f"t{i}" for i in range(11)]
    reps = run_ranks("cluster", {"tasks": tasks}, 2, str(tmp_path))
    assert [r["rank"] for r in reps] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in reps)
    assert all(r["gathered"] == [0, 1] for r in reps)
    a, b = reps[0]["shard"], reps[1]["shard"]
    assert not set(a) & set(b) and sorted(a + b) == sorted(tasks)
    assert abs(len(a) - len(b)) <= 1
    assert a == jm.shard_tasks(tasks, 0, 2)
    assert os.environ.get("VES_PROCESS_ID") is None
