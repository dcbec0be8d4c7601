"""Run one cell of the benchmark of ``vae_extent_search_tpu_torch``.

    python3 port_bench/run.py --workload vae_extent.select_262k \
        --seed 7 --seconds 10 --trace 0

from the root of a checkout. Prints the run's result as the last line of
standard output, and the numbers compared with their limits as the last
lines of standard error. Exits with another code than 0, and prints no
result, where there is no CUDA card (or fewer than the cell asks for),
where the port cannot be imported, or where jax, jaxlib, flax or the JAX
package were loaded. ``--rehearse-cpu`` runs the same path on the CPU
with the port's plain kernel versions, for the tests.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vae_extent_search_tpu")

# every cache of a build or a compile stays inside the checkout, at a
# fixed path, so that only a cell's first run in it builds
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["OMP_NUM_THREADS"] = "1"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness, workload

    cell = workload.load_cell(ROOT, args.workload)
    if not args.rehearse_cpu:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    torch.set_num_threads(1)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START,
                              rehearse=args.rehearse_cpu)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
