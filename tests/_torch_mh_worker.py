"""One rank of a multi-process run of the PyTorch port on the CPU (gloo).

    python tests/_torch_mh_worker.py <case> <inputs.pkl> <output.pkl>

The rank joins the process group from the ``VES_*`` variables
(``parallel/multihost.py``), runs ``case`` on the inputs and pickles its
result. It imports neither jax nor the JAX package.
"""

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vae_extent_search_tpu_torch.convert import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)
from vae_extent_search_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    maybe_initialize_distributed,
    shard_tasks,
)


def case_cluster(mesh, inp):
    from vae_extent_search_tpu_torch.parallel.mesh import all_gather

    t = torch.tensor([mesh.rank], dtype=torch.int64)
    return {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend,
            "shard": shard_tasks(inp["tasks"]),
            "gathered": all_gather(t, mesh).view(-1).tolist()}


def case_select(mesh, inp):
    from vae_extent_search_tpu_torch.parallel.mesh import host, shard_batch
    from vae_extent_search_tpu_torch.search.select import (
        SelectionConfig,
        select_programs,
    )

    params = params_from_numpy(inp["params"])
    X = shard_batch(inp["X"], mesh)
    out = []
    for v in inp["variants"]:
        cfg = SelectionConfig(**v["cfg"])
        bits = (torch.as_tensor(inp["bits"]) if v.get("bits") else None)
        kw = {}
        if v.get("centers"):
            kw = dict(center_idx=torch.as_tensor(inp["center_idx"]),
                      center_valid=torch.as_tensor(inp["center_valid"]))
        gen = torch.Generator().manual_seed(v.get("seed", 0))
        with torch.no_grad():
            sel, valid, rem, aux = select_programs(
                params, X, shard_batch(inp["used"], mesh),
                shard_batch(~inp["used"], mesh), gen, cfg,
                gate_uncertainty_to_remaining=v.get("gate", False),
                mask_bits=bits, mesh=mesh, **kw)
        out.append({"sel": sel.numpy(), "valid": valid.numpy(),
                    "rem": host(rem, mesh),
                    **{k: host(a, mesh) for k, a in aux.items()}})
    return out


def case_train_step(mesh, inp):
    from vae_extent_search_tpu_torch.models.predictor import PredictorConfig
    from vae_extent_search_tpu_torch.parallel.mesh import (
        make_sharded_train_step,
        shard_batch,
    )

    cfg = PredictorConfig(**inp["config"])
    step, init_opt = make_sharded_train_step(mesh, cfg)
    params = params_from_numpy(inp["params"])
    opt = init_opt(params)
    gen = torch.Generator().manual_seed(inp.get("seed", 0))
    X = shard_batch(inp["X"], mesh)
    y = shard_batch(inp["y"], mesh)
    mask = None if inp.get("mask") is None else shard_batch(inp["mask"],
                                                            mesh)
    losses = []
    for _ in range(inp["steps"]):
        params, opt, loss = step(params, opt, X, y, mask, gen)
        losses.append(float(loss))
    return {"losses": losses, "params": params_to_numpy(params)}


def case_score(mesh, inp):
    from vae_extent_search_tpu_torch.parallel.mesh import (
        host,
        shard_batch,
        sharded_score_candidates,
    )

    score = sharded_score_candidates(mesh)
    gen = torch.Generator().manual_seed(inp.get("seed", 0))
    out = score(params_from_numpy(inp["params"]),
                shard_batch(inp["X"], mesh), gen, inp["T"],
                inp.get("rate", 0.1))
    return [host(t, mesh) for t in out]


def case_search(mesh, inp):
    from vae_extent_search_tpu_torch.search.active_loop import (
        run_active_search,
    )

    res = run_active_search(inp["feats"], inp["labels"], device="cpu",
                            mesh=mesh, **inp["kw"])
    return {"found": res.found, "phase": res.phase,
            "train_size": res.train_size,
            "selected_order": [int(i) for i in res.selected_order],
            "r2": res.reg_r2_history}


def case_boost(mesh, inp):
    from vae_extent_search_tpu_torch.models import boost, boost_device

    dm = boost.DMatrix(inp["rows"], label=inp["label"],
                       pack_ids=inp["pack_ids"], group_sizes=inp["groups"])
    bst = boost_device.train(inp["params"], dm, evals=[(dm, "tr")],
                             device="cpu", mesh=mesh, **inp["common"])
    return {"trees": [(t.feature, t.threshold, t.value, t.left, t.right)
                      for t in bst.trees],
            "pred": bst.predict(dm)}


def main():
    case, inp_path, out_path = sys.argv[1:4]
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    torch.set_num_threads(1)
    maybe_initialize_distributed(device="cpu", timeout_s=120)
    mesh = make_mesh(data=inp.get("data"), model=inp.get("model", 1),
                     device="cpu")
    res = globals()["case_" + case](mesh, inp)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    bad = [k for k in sys.modules
           if k.split(".")[0] in ("jax", "jaxlib", "vae_extent_search_tpu")]
    assert not bad, bad


if __name__ == "__main__":
    main()
