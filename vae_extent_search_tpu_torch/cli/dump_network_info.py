"""Dump network task info for the benchmark grid (counterpart of
``scripts/dump_network_info.py``).

Parity: reference scripts/dump_network_info.py: builds per-network task
lists for the network grid and writes ``*.task.pkl`` files plus the global
``all_tasks.pkl`` registry (:139-241), under ``$VES_DATASET_ROOT/
network_info``. Host work over the static shape tables of
``records/networks.py``; no device is involved.

    python -m vae_extent_search_tpu_torch.cli.dump_network_info \\
        --target "llvm -mcpu=skylake-avx512"

``--from-model NAME`` traces a real model graph through the front end
(``frontend/``) instead of the static tables, the reference's relay
extraction path, and writes that one network's task pickle: a zoo model
at ``--batch-size`` x 3 x ``--image-size``^2 (dcgan: its 100-wide noise,
64 px where the size is left at 224), or a ``bert_*`` model at
``--seq-length`` through ``transformers`` (where that is installed).

    python -m vae_extent_search_tpu_torch.cli.dump_network_info \
        --from-model resnet_18 --target "llvm -mcpu=skylake-avx512"
"""

from __future__ import annotations

import argparse
import os
import pickle

from ..records.networks import build_network_keys, get_network_tasks
from . import common


def dump_network_info(target: str = "llvm", networks=None):
    """Write one task pickle per grid entry (of ``networks``, or all 108)
    and merge the tasks into ``all_tasks.pkl``. Returns
    {(name, (batch, size)): number of tasks}."""
    folder = common.NETWORK_INFO_FOLDER
    os.makedirs(folder, exist_ok=True)
    all_tasks = {}
    keys = build_network_keys()
    if networks:
        keys = [k for k in keys if k[0] in networks]

    dumped = {}
    for name, shape_args in keys:
        try:
            tasks, weights = get_network_tasks(name, *shape_args,
                                               target=target)
        except ValueError:
            continue
        network_key = (name, list(shape_args))
        out = os.path.join(folder,
                           common.clean_name((network_key, target))
                           + ".task.pkl")
        with open(out, "wb") as f:
            pickle.dump(([t.to_record() for t in tasks], weights), f)
        for t in tasks:
            all_tasks[(t.workload_key, t.target)] = t.to_record()
        dumped[(name, tuple(shape_args))] = len(tasks)
        print(f"{name} {shape_args}: {len(tasks)} tasks -> {out}")

    # all_tasks.pkl is the GLOBAL registry across platforms (the
    # reference's spans all its hardware targets): merge with any
    # existing registry so a cuda grid dump does not clobber the llvm
    # one; this run's tasks win on key collisions
    reg_path = os.path.join(folder, "all_tasks.pkl")
    if os.path.exists(reg_path):
        with open(reg_path, "rb") as f:
            for rec in pickle.load(f):
                all_tasks.setdefault((rec[0], rec[1]), rec)
    with open(reg_path, "wb") as f:
        pickle.dump(list(all_tasks.values()), f)
    print(f"all_tasks.pkl: {len(all_tasks)} unique tasks")
    return dumped


def trace_model_tasks(name: str, batch_size: int, image_size: int,
                      seq_length: int, target: str):
    """(tasks, weights) of a real model's traced graph (``frontend/``)
    instead of the static tables: the reference's relay extraction path
    (relay_integration.py:82-149)."""
    if name.startswith("bert_"):
        from transformers import BertConfig, BertModel

        from ..frontend.torch_fx import extract_tasks_from_hf
        from ..records.networks import _BERT_DIMS

        hidden, layers, heads = _BERT_DIMS[name.split("_", 1)[1]]
        cfg = BertConfig(
            hidden_size=hidden, num_hidden_layers=layers,
            num_attention_heads=heads, intermediate_size=4 * hidden,
            max_position_embeddings=max(512, seq_length))
        return extract_tasks_from_hf(BertModel(cfg), batch_size,
                                     seq_length, target)

    from ..frontend import build_zoo_model, extract_tasks_from_module

    if name == "dcgan":
        from ..frontend.zoo import _make_dcgan

        # 224 is the image-size default sentinel; dcgan's native base is
        # 64 px (get_network_tasks' convention)
        model = _make_dcgan(64 if image_size == 224 else image_size)
        shape = (batch_size, 100)
    else:
        model = build_zoo_model(name)
        shape = (batch_size, 3, image_size, image_size)
    return extract_tasks_from_module(model, shape, target)


def dump_traced_model(name: str, batch_size: int = 1, image_size: int = 224,
                      seq_length: int = 128, target: str = "llvm"):
    """Write one traced network's task pickle (the static dump's name
    and format); returns its path."""
    tasks, weights = trace_model_tasks(name, batch_size, image_size,
                                       seq_length, target)
    folder = common.NETWORK_INFO_FOLDER
    os.makedirs(folder, exist_ok=True)
    size = seq_length if name.startswith("bert_") else image_size
    network_key = (name, [batch_size, size])
    out = os.path.join(folder, common.clean_name((network_key, target))
                       + ".task.pkl")
    with open(out, "wb") as f:
        pickle.dump(([t.to_record() for t in tasks], weights), f)
    for t, w in zip(tasks, weights):
        print(f"  w={w:g}  {t.workload_key}")
    print(f"{name} (traced): {len(tasks)} tasks -> {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--target", type=str, default="llvm")
    p.add_argument("--networks", nargs="*", default=None)
    p.add_argument("--from-model", type=str, default=None,
                   help="trace a real model graph (zoo/HF name) instead "
                        "of using the static shape tables")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--seq-length", type=int, default=128)
    args = p.parse_args(argv)
    if args.from_model:
        return dump_traced_model(args.from_model, args.batch_size,
                                 args.image_size, args.seq_length,
                                 args.target)
    return dump_network_info(args.target, args.networks)


if __name__ == "__main__":
    main()
