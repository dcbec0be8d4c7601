"""The VAE-extent-search experiment, offline record-replay arm
(counterpart of ``scripts/vae_extent_search.py``: the ``vae``/``ae``/``vib``
encoder arms with a random, diversity or kmeans initial set, the ``gbdt``
tree-model baseline arm and the ``grid`` sweep).

Loads a featurized candidate pool (``--pool``, an npz) or featurises a
record log (``--record-file``: each record replayed, its extent vector, or
with ``--features per_store`` its flattened per-store rows, and -log(mean
cost), as ``scripts/vae_extent_search.py`` does). The ``vae`` arm
pretrains the pool VAE once (not for ``--encoder vib``, which has no
pretrain), then runs the active search for each sampling seed until the
recorded-optimal schedule is found; it writes a per-run CSV and appends
the seed average to ``vae_extent_total_avg.csv``. The ``gbdt`` arm fits
the pack-sum GBDT on the measured set each phase and writes
``gbdt_search_<time>.csv``. The ``grid`` arm runs the ``vae`` arm for
every config of ``DEFAULT_GRID`` whose (measure_size, weights) is not in
``<out-dir>/vae_extent_total_avg.csv`` yet, over one shared VAE pretrain.
Columns are the JAX script's. ``--profile-dir`` (default
``$VES_TRACE_DIR``) writes a ``torch.profiler`` Chrome trace of the run
there (``utils/misc.py::trace_profile``).

    python -m vae_extent_search_tpu_torch.cli.vae_extent_search \\
        --measure-size 32 --seeds 2000 2001 --out-dir result/torch
    python -m vae_extent_search_tpu_torch.cli.vae_extent_search \\
        --arm gbdt --measure-size 32 --seeds 2000 2001 --out-dir result/torch

Runs on CUDA by default; ``--device cpu`` runs on the CPU. Asking for
CUDA on a host without a GPU is an error.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from ..data.pool import load_pool, pool_from_records
from ..search.active_loop import (
    expand_hyper_grid,
    filter_already_measured,
    pretrain_pool_vae,
    run_active_search,
    run_gbdt_baseline_search,
)
from ..search.select import SelectionConfig
from ..utils import span, trace_profile

# the default sweep grid of the grid arm
DEFAULT_GRID = {
    "measure_size": [32, 64],
    "weights": [(0.5, 0.3, 0.2), (0.4, 0.3, 0.3), (0.7, 0.2, 0.1)],
    "grad_num": [2, 4],
    "rand_num": [0],
    "uncertainty_topk": [64, 128],
}


def _load(pool=None, record_file=None, features="extent"):
    if record_file is not None:
        if pool is not None:
            raise ValueError("pass a pool or a record file, not both")
        return pool_from_records(record_file, features)
    if features != "extent":
        raise ValueError(f"--features {features} featurises a record log: "
                         "pass --record-file (a pool npz holds its features "
                         "already)")
    return load_pool(pool)


def run_experiment(pool=None, out_dir="result", measure_size=64,
                   seeds=(2000,), weights=(0.5, 0.3, 0.2), grad_num=2,
                   rand_num=0, uncertainty_topk=128, max_phases=60,
                   vae_epochs=500, reg_epochs=1000, latent_dim=64,
                   hidden_dim=256, verbose=False, encoder_mode="vae",
                   device="cuda", record_file=None, features="extent",
                   init_mode="random", pretrained_vae_params=None):
    """Run the search for every seed in ``seeds`` on the pool at ``pool``
    (an npz of features/labels; default: the committed conv2d pool) or on
    ``record_file`` featurised as ``features`` ("extent" or "per_store").
    ``pretrained_vae_params`` skips the pretrain (the grid arm shares one).
    Returns (per-seed rows, seed-average row)."""
    feats, labels, _ = _load(pool, record_file, features)
    print(f"pool: {feats.shape[0]} candidates x {feats.shape[1]} features")
    os.makedirs(out_dir, exist_ok=True)
    tag = time.strftime("%m%d_%H%M")

    # the pool VAE is pretrained once and shared across sampling seeds
    if pretrained_vae_params is None and encoder_mode != "vib":
        t_vae = time.time()
        with span("vae_pretrain"):
            pretrained_vae_params = pretrain_pool_vae(
                feats, latent_dim=latent_dim, hidden_dim=hidden_dim,
                vae_epochs=vae_epochs,
                vae_beta=0.0 if encoder_mode == "ae" else 0.01,
                deterministic=encoder_mode == "ae", device=device)
        print(f"{encoder_mode.upper()} pretrain ({vae_epochs} epochs): "
              f"{time.time() - t_vae:.1f}s (shared across seeds)")

    rows = []
    for seed in seeds:
        res = run_active_search(
            feats, labels, measure_size=measure_size, max_phases=max_phases,
            latent_dim=latent_dim, hidden_dim=hidden_dim,
            vae_epochs=vae_epochs, reg_epochs=reg_epochs,
            selection=SelectionConfig(
                num_select=measure_size, w_cost=weights[0],
                w_unc=weights[1], w_div=weights[2], grad_num=grad_num,
                rand_num=rand_num, uncertainty_topk=uncertainty_topk),
            sampling_seed=seed, init_mode=init_mode,
            encoder_mode=encoder_mode, verbose=verbose,
            pretrained_vae_params=pretrained_vae_params, device=device)
        rows.append({
            "measure_size": measure_size,
            "weights": str(tuple(weights)),
            "uncertainty_topk": uncertainty_topk,
            "grad_num": grad_num,
            "rand_num": rand_num,
            "phase": res.phase,
            "used_time": round(res.used_time, 2),
            "train_size": res.train_size,
            "val_reg_r2": str([round(r, 4) for r in res.reg_r2_history]),
            # the FINAL model's Recall@1 over the full pool, not the
            # search's found rate (that is "found")
            "top-1": 0 if res.final_recall_topk is None
            else int(res.final_recall_topk),
            "optimum_rank": "" if res.final_optimum_rank is None
            else res.final_optimum_rank,
            "found": int(res.found),
            "sampling_seed": seed,
        })
        print(f"seed {seed}: found={res.found} phase={res.phase} "
              f"train_size={res.train_size} time={res.used_time:.1f}s "
              f"(predictor training {sum(res.fit_seconds):.2f}s, selection "
              f"{sum(res.select_seconds):.3f}s)")

    with open(os.path.join(out_dir, f"vae_extent_search_{tag}.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)

    avg = {
        "measure_size": measure_size,
        "weights": str(tuple(weights)),
        "phase": np.mean([r["phase"] for r in rows]),
        "train_size": np.mean([r["train_size"] for r in rows]),
        "used_time": np.mean([r["used_time"] for r in rows]),
        "top-1": np.mean([r["top-1"] for r in rows]),
        "found": np.mean([r["found"] for r in rows]),
        "n_seeds": len(rows),
    }
    avg_csv = os.path.join(out_dir, "vae_extent_total_avg.csv")
    exists = os.path.exists(avg_csv)
    with open(avg_csv, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(avg.keys()))
        if not exists:
            w.writeheader()
        w.writerow(avg)
    print("avg:", avg)
    return rows, avg


def run_gbdt_arm(pool=None, out_dir="result", measure_size=64, seeds=(2000,),
                 max_phases=60, engine="auto", device="cuda",
                 record_file=None, features="extent"):
    """The tree-model baseline arm (reference result_xgb corpus) on the
    pool at ``pool`` (default: the committed conv2d pool) or on
    ``record_file`` featurised as ``features``. Returns the per-seed
    rows."""
    feats, labels, _ = _load(pool, record_file, features)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for seed in seeds:
        res = run_gbdt_baseline_search(
            feats, labels, measure_size=measure_size, max_phases=max_phases,
            sampling_seed=seed, engine=engine, device=device)
        rows.append({
            "measure_size": measure_size, "phase": res.phase,
            "train_size": res.train_size,
            "used_time": round(res.used_time, 2),
            "top-1": 0 if res.final_recall_topk is None
            else int(res.final_recall_topk),
            "optimum_rank": "" if res.final_optimum_rank is None
            else res.final_optimum_rank,
            "found": int(res.found), "sampling_seed": seed,
        })
        print(f"gbdt seed {seed}: found={res.found} phase={res.phase} "
              f"train_size={res.train_size} time={res.used_time:.1f}s "
              f"(model fitting {sum(res.fit_seconds):.2f}s)")
    tag = time.strftime("%m%d_%H%M")
    out_csv = os.path.join(out_dir, f"gbdt_search_{tag}.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return rows


def run_grid(pool=None, out_dir="result", seeds=(2000,), max_phases=60,
             vae_epochs=500, reg_epochs=1000, latent_dim=64, hidden_dim=256,
             verbose=False, device="cuda", record_file=None,
             features="extent"):
    """Run the ``vae`` arm for every config of ``DEFAULT_GRID`` whose
    (measure_size, weights) is not in ``<out_dir>/vae_extent_total_avg.csv``
    yet, each appending its seed average there. No grid axis touches the
    VAE, so it is pretrained once for the sweep. Returns the configs
    run."""
    os.makedirs(out_dir, exist_ok=True)
    avg_csv = os.path.join(out_dir, "vae_extent_total_avg.csv")
    rows = filter_already_measured(expand_hyper_grid(DEFAULT_GRID), avg_csv,
                                   ["measure_size", "weights"])
    print(f"{len(rows)} grid configs to run")
    if not rows:
        return rows
    feats, _, _ = _load(pool, record_file, features)
    with span("vae_pretrain"):
        vae_params = pretrain_pool_vae(feats, latent_dim=latent_dim,
                                       hidden_dim=hidden_dim,
                                       vae_epochs=vae_epochs, device=device)
    for cfg in rows:
        print("config:", cfg)
        run_experiment(
            pool, out_dir, cfg["measure_size"], seeds, cfg["weights"],
            cfg["grad_num"], cfg["rand_num"], cfg["uncertainty_topk"],
            max_phases=max_phases, vae_epochs=vae_epochs,
            reg_epochs=reg_epochs, latent_dim=latent_dim,
            hidden_dim=hidden_dim, verbose=verbose, device=device,
            record_file=record_file, features=features,
            pretrained_vae_params=vae_params)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pool", type=str, default=None,
                   help="npz with features/labels (default: the committed "
                        "conv2d_4k extent pool)")
    p.add_argument("--record-file", type=str, default=None,
                   help="a record log (NDJSON, or .gz) to featurise "
                        "instead of --pool")
    p.add_argument("--features", type=str, default="extent",
                   choices=["extent", "per_store"],
                   help="model input featurised from --record-file: "
                        "printed-extent vectors (the reference experiment) "
                        "or flattened 164-dim per-store feature rows")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--out-dir", type=str, default="result")
    p.add_argument("--arm", type=str, default="vae",
                   choices=["vae", "gbdt", "grid"],
                   help="the encoder search (see --encoder), the GBDT "
                        "baseline arm, or the vae arm over DEFAULT_GRID's "
                        "configs not yet in the out-dir's average CSV")
    p.add_argument("--engine", type=str, default="auto",
                   choices=["auto", "device", "host"],
                   help="gbdt arm: grow trees on the device, with the numpy "
                        "grower, or by the row count (auto)")
    p.add_argument("--measure-size", type=int, default=64)
    p.add_argument("--seeds", type=int, nargs="+",
                   default=list(range(2000, 2005)))
    p.add_argument("--weights", type=float, nargs=3, default=[0.5, 0.3, 0.2])
    p.add_argument("--grad-num", type=int, default=2)
    p.add_argument("--rand-num", type=int, default=0)
    p.add_argument("--uncertainty-topk", type=int, default=128)
    p.add_argument("--max-phases", type=int, default=60)
    p.add_argument("--vae-epochs", type=int, default=500)
    p.add_argument("--reg-epochs", type=int, default=1000)
    p.add_argument("--latent-dim", type=int, default=64)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--init-mode", type=str, default="random",
                   choices=["random", "diversity", "kmeans"],
                   help="initial measured set: random, farthest-point "
                        "latent diversity, or k-means++ representatives")
    p.add_argument("--encoder", type=str, default="vae",
                   choices=["vae", "ae", "vib"],
                   help="VAE pretrain + cost predictor, the plain-AE "
                        "ablation (reconstruction-only pretrain, no KL), "
                        "or the variational information bottleneck (no "
                        "pretrain; sampled z, smooth-L1, cosine KL warm-up)")
    p.add_argument("--profile-dir", type=str,
                   default=os.environ.get("VES_TRACE_DIR"),
                   help="write a torch.profiler Chrome trace of the run "
                        "(CPU ops and CUDA kernels) under this directory; "
                        "also settable via VES_TRACE_DIR")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    with trace_profile(args.profile_dir):
        _dispatch(args)


def _dispatch(args):
    if args.arm == "gbdt":
        run_gbdt_arm(args.pool, args.out_dir, args.measure_size,
                     tuple(args.seeds), args.max_phases, engine=args.engine,
                     device=args.device, record_file=args.record_file,
                     features=args.features)
    elif args.arm == "grid":
        run_grid(args.pool, args.out_dir, tuple(args.seeds), args.max_phases,
                 args.vae_epochs, args.reg_epochs, args.latent_dim,
                 args.hidden_dim, verbose=args.verbose, device=args.device,
                 record_file=args.record_file, features=args.features)
    else:
        run_experiment(
            args.pool, args.out_dir, args.measure_size, tuple(args.seeds),
            tuple(args.weights), args.grad_num, args.rand_num,
            args.uncertainty_topk, max_phases=args.max_phases,
            vae_epochs=args.vae_epochs, reg_epochs=args.reg_epochs,
            latent_dim=args.latent_dim, hidden_dim=args.hidden_dim,
            verbose=args.verbose, encoder_mode=args.encoder,
            device=args.device, record_file=args.record_file,
            features=args.features, init_mode=args.init_mode)


if __name__ == "__main__":
    main()
