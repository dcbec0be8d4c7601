"""Sweep the float32 matmul kernel's lattice on the card beside torch.matmul.

    python -m vae_extent_search_tpu_torch.cli.matmul_sweep --dims 1536 4608

For each square size D, every (bm, bn, bk) of the f32 lattice
(``ops/matmul.py``: ``F32_BM`` x ``F32_BN`` x ``F32_BK``) is held against
the plain version and timed by the tuner's card timer (device time,
``search/kernel_tuner.py::cuda_seconds``), beside ``torch.matmul`` on the
same operands in full float32 (TF32 off) and the bound: the operations at
an H100's published f32 peak, or the bytes (each operand read once, C
written once) at its memory rate, whichever is longer. Needs CUDA. Prints
the card's name and power limit first, one line per size, and the whole
sweep as one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from ..device import resolve_device
from ..ops import matmul as om
from ..search.kernel_tuner import MatmulRunner, cuda_seconds, time_library_matmul

# relative to max |plain|: the same f32 products summed in another order
TOL = 1e-5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs="+", default=[1536],
                    help="square sizes M = N = K")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runner = MatmulRunner("float32", device=dev)
    configs = [(bm, bn, bk) for bm in om.F32_BM for bn in om.F32_BN
               for bk in om.F32_BK]
    out = {"card": card, "sizes": {}}
    for D in args.dims:
        a, b = runner.operands(D, D, D)
        want = om.matmul_plain(a, b)
        times = {}
        for cfg in configs:
            err = float((om.matmul(a, b, *cfg) - want).abs().max()
                        / want.abs().max())
            if not err <= TOL:
                raise RuntimeError(f"{cfg} at {D}^3: rel err {err:g} (tol "
                                   f"{TOL:g})")
            times["x".join(map(str, cfg))] = cuda_seconds(
                lambda: om.matmul(a, b, *cfg)).seconds * 1e3
        lib = time_library_matmul(D, D, D, "float32", device=dev).seconds * 1e3
        flops = 2.0 * D ** 3
        bound = max(flops / om.PEAK_FLOPS["float32"],
                    3 * D * D * 4 / om.HBM_BYTES_S) * 1e3
        order = sorted(times, key=times.get)
        print(f"D={D}: torch.matmul {lib:.4f} ms ({flops / lib / 1e9:.1f} "
              f"TFLOP/s), bound {bound:.4f} ms; fastest "
              + ", ".join(f"{c} {times[c]:.4f} ms ({flops / times[c] / 1e9:.1f}"
                          f" TFLOP/s)" for c in order[:5]), flush=True)
        out["sizes"][D] = {"library_ms": lib, "bound_ms": bound,
                           "best_cfg": order[0], "times_ms": times}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
