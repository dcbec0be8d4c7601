"""Online SegmentVAE tuning: generate candidates, measure live, retrain per
phase (counterpart of ``scripts/vae_experiments/tune_vae.py``).

Parity: reference scripts/vae_experiments/tune_vae.py: choose a task ->
``make_states`` generates ~2,000 unique candidates through the sketch GA
(tuning.py:9-62) -> per-store 164-dim features (tune_vae.py:94-97) ->
pretrain a SegmentVAE (200 epochs, lr 2e-4, beta 1e-4) -> per phase:
select 64 candidates (random, as the reference's stub, tuning.py:65-68,
or by the model), measure them through a ``Runner`` with ProgramMeasurer,
retrain the segment regression on all measured (tune_vae.py:73-166).

    python -m vae_extent_search_tpu_torch.cli.tune_vae            # on CUDA
    python -m vae_extent_search_tpu_torch.cli.tune_vae --device cpu \\
        --n-candidates 200 --n-phases 2
    python -m vae_extent_search_tpu_torch.cli.tune_vae --target cuda \
        --runner analytic_hf --workload-key \
        '["conv2d_layer", 1, 56, 56, 64, 64, 3, 3, [1,1], [1,1]]'

A ``cuda`` target takes the GA's GPU-target rules (thread binding,
shared-memory cache reads) and the per-store featuriser's GPU rows.
The candidates' per-store rows, their segment ids and offsets live on the
device; every segment sum of the SegmentVAE and the regression runs the
``segment_sum`` CUDA kernel there, forward and backward (the plain
version on the CPU). The offsets are made once on the host, from rows
that are contiguous per program by construction. Generation, featurising
and measurement are host work. The selection's randomness is numpy's
``default_rng(seed)``, as in the JAX script; the models' comes from one
``torch.Generator`` seeded with ``seed``. CUDA is the default device, and
asking for it without a GPU is an error.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..device import make_generator, resolve_device
from ..features.per_store import get_per_store_features_from_states
from ..models.segment import (
    compute_fea_norm_vec,
    fit_segment_predictor,
    fit_segment_vae,
    init_segment_predictor_params,
    init_segment_vae_params,
    load_pretrained_segment_encoder,
    search_segment_vae_hyperparams,
    segment_predict_cost,
    segment_predictor_encode,
)
from ..ops.segment_sum import check_contiguous, segment_ids_to_offsets
from ..records import SearchTask, make_workload_key
from ..search.measure import (
    AnalyticRunner,
    EmptyBuilder,
    ProgramMeasurer,
    RecordToFile,
    runner_from_spec,
)
from ..search.sketch import make_states

DEFAULT_WORKLOAD = ("conv2d_layer", (1, 14, 14, 128, 128, 3, 3, [1, 1],
                                     [1, 1]))


def flatten_features(features_list, fea_norm_vec=None, device="cpu"):
    """(rows [R, D] float32, segment ids [R] int32, offsets [n_seg+1]
    int32, n_seg) on ``device``: the programs' rows one after another."""
    rows = np.concatenate(features_list).astype(np.float32)
    if fea_norm_vec is not None:
        rows = rows / fea_norm_vec
    seg_ids = np.concatenate(
        [np.full(len(f), i, np.int32) for i, f in enumerate(features_list)]
    )
    n_seg = len(features_list)
    check_contiguous(seg_ids, n_seg)
    offsets = segment_ids_to_offsets(seg_ids, n_seg)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(rows), to(seg_ids), to(offsets), n_seg


def encode_candidates(pred_params, rows, seg_ids, offsets, n_seg):
    """(mean latents [n_seg, L], scores [n_seg]) of every candidate as host
    arrays: a train-mode encode of all of them, and the mean latent through
    the cost head without dropout (higher scores are faster)."""
    with torch.no_grad():
        mu, _, _ = segment_predictor_encode(pred_params, rows, seg_ids,
                                            n_seg, offsets=offsets)
        scores = segment_predict_cost(pred_params, mu)
        return mu.cpu().numpy(), scores.cpu().numpy()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_tuning(task: SearchTask, n_candidates=2000, measure_size=64,
               n_phases=10, vae_epochs=200, reg_epochs=300,
               runner=None, log_file="tune_vae.json", select="random",
               seed=2023, verbose=True, tune_vae_hparams=False,
               device="cuda", details: Optional[dict] = None):
    """Returns (best cost, wall seconds). ``details``, where given, is
    filled with the part times (``seconds``), the candidates, their rows
    and the last phase's regression parameters."""
    dev = resolve_device(device)
    t0 = time.time()
    seconds = {"phases": []}

    def lap(t):
        _sync(dev)
        return time.perf_counter() - t

    t = time.perf_counter()
    print(f"generating {n_candidates} candidate states ...")
    states = make_states(task, n_candidates, seed=seed)
    seconds["generate"] = lap(t)
    print(f"  got {len(states)} unique states in {time.time()-t0:.1f}s")

    t = time.perf_counter()
    feats = get_per_store_features_from_states(states, task)
    fea_norm = compute_fea_norm_vec(feats)
    rows, seg_ids, offsets, n_seg = flatten_features(feats, fea_norm, dev)
    seconds["featurise"] = lap(t)

    gen = make_generator(seed, 0, dev)
    in_dim = rows.shape[1]
    valid_all = torch.ones(n_seg, dtype=torch.bool, device=dev)

    # ---- SegmentVAE pretraining ----
    t = time.perf_counter()
    if tune_vae_hparams:
        # KL/dim-targeted config search (reference
        # VAE_Trainer.hyperparameter_search)
        vae_params, best_cfg, _ = search_segment_vae_hyperparams(
            rows, seg_ids, valid_all, n_seg, in_dim,
            epochs=vae_epochs, seed=seed, verbose=verbose, offsets=offsets,
        )
        vae_dims = {"hidden_dim": best_cfg["hidden_dim"],
                    "latent_dim": best_cfg["latent_dim"]}
        if verbose:
            print(f"vae hparam search best: "
                  f"beta={best_cfg['beta']:g} lr={best_cfg['lr']:g} "
                  f"latent={best_cfg['latent_dim']} "
                  f"KL/dim={best_cfg['kl_per_dim']:.4f} "
                  f"R2={best_cfg['recon_r2']:.4f}")
    else:
        vae_dims = {}
        vae_params = init_segment_vae_params(gen, in_dim, device=dev)
        vae_params, vae_losses = fit_segment_vae(
            vae_params, rows, seg_ids, valid_all, gen, n_seg, vae_epochs,
            offsets=offsets,
        )
        if verbose:
            losses = vae_losses.cpu().numpy()
            print(f"vae pretrain: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}")
    seconds["pretrain"] = lap(t)

    measurer = ProgramMeasurer(
        EmptyBuilder(), runner or AnalyticRunner(noise=0.2),
        callbacks=[RecordToFile(log_file)],
    )

    rng = np.random.default_rng(seed)
    measured = np.zeros(n_seg, bool)
    labels = np.zeros(n_seg, np.float32)

    pred_params = None
    for phase in range(n_phases):
        # ---- select ----
        t = time.perf_counter()
        remaining = np.where(~measured)[0]
        if len(remaining) == 0:
            break
        k = min(measure_size, len(remaining))
        if select == "random" or pred_params is None:
            sel = rng.choice(remaining, size=k, replace=False)
        else:
            _, scores = encode_candidates(pred_params, rows, seg_ids,
                                          offsets, n_seg)
            order = remaining[np.argsort(-scores[remaining])]
            sel = order[:k]
        t_select = lap(t)

        # ---- measure ----
        t = time.perf_counter()
        batch_states = [states[i] for i in sel]
        results = measurer.measure(task, batch_states)
        for i, res in zip(sel, results):
            measured[i] = True
            cost = res.mean_cost if res.error_no == 0 else 1e10
            labels[i] = -np.log(cost + 1e-8)
        t_measure = time.perf_counter() - t

        # ---- retrain regression on all measured ----
        t = time.perf_counter()
        pred_params = init_segment_predictor_params(gen, in_dim,
                                                    **vae_dims, device=dev)
        pred_params = load_pretrained_segment_encoder(pred_params, vae_params)
        pred_params, info = fit_segment_predictor(
            pred_params, rows, seg_ids, torch.from_numpy(labels).to(dev),
            torch.from_numpy(measured).to(dev), gen, n_seg, reg_epochs,
            offsets=offsets,
        )
        t_fit = lap(t)
        seconds["phases"].append({"select": t_select, "measure": t_measure,
                                  "fit": t_fit})
        if verbose:
            best_c = measurer.best_cost.get(task.workload_key, float("inf"))
            print(f"phase {phase}: measured {int(measured.sum())}, "
                  f"best cost {best_c:.6g}, "
                  f"train loss {float(info['best_loss']):.4f}")

    if details is not None:
        details.update(seconds=seconds, states=states, rows=rows,
                       seg_ids=seg_ids, offsets=offsets, n_seg=n_seg,
                       measured=measured, pred_params=pred_params)
    return measurer.best_cost.get(task.workload_key), time.time() - t0


def main(argv=None, details: Optional[dict] = None):
    """The command line; ``details`` as in ``run_tuning``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload-key", type=str, default=None)
    p.add_argument("--target", type=str, default="llvm -mcpu=skylake-avx512")
    p.add_argument("--n-candidates", type=int, default=2000)
    p.add_argument("--measure-size", type=int, default=64)
    p.add_argument("--n-phases", type=int, default=10)
    p.add_argument("--select", type=str, default="model",
                   choices=["random", "model"])
    p.add_argument("--log-file", type=str, default="tune_vae.json")
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--runner", type=str, default="analytic",
                   help="any runner_from_spec spec: analytic | "
                        "analytic_hf | replay | command:<cmd> | "
                        "service:<key>@<host>:<port> | cuda_matmul | "
                        "cuda_conv2d")
    p.add_argument("--noise", type=float, default=0.2,
                   help="simulated-measurement jitter for the analytic "
                        "runners")
    p.add_argument("--tune-vae-hparams", action="store_true",
                   help="KL/dim-targeted VAE config search before the "
                        "phase loop (reference hyperparameter_search)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda without a GPU raises")
    args = p.parse_args(argv)

    wk = args.workload_key or make_workload_key(*DEFAULT_WORKLOAD)
    task = SearchTask(wk, args.target)
    runner = runner_from_spec(args.runner, noise=args.noise,
                              seed=args.seed)
    best, wall = run_tuning(
        task, args.n_candidates, args.measure_size, args.n_phases,
        select=args.select, log_file=args.log_file, seed=args.seed,
        runner=runner, tune_vae_hparams=args.tune_vae_hparams,
        device=args.device, details=details,
    )
    print(f"best cost: {best:.6g}  wall: {wall:.1f}s")
    return best, wall


if __name__ == "__main__":
    main()
