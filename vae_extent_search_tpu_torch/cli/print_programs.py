"""Print recorded schedules as loop-nest text (counterpart of
``scripts/print_programs.py``).

Parity: reference scripts/print_programs.py: ``return_all_states`` streams
records, rebuilds the full bound state and yields (state, cost), leaving
out error records with cost > 1e6 (:22-49). Host work; no device is
involved.

    python -m vae_extent_search_tpu_torch.cli.print_programs measured.json --idx 0
"""

from __future__ import annotations

import argparse

from ..records import iter_records


def return_all_states(json_file, max_lines=None, cost_filter=1e6):
    """[(state, mean_cost)] for valid records (print_programs.py:22-49)."""
    out = []
    for rec in iter_records(json_file, max_lines):
        if not rec.res.costs or rec.res.costs[0] > cost_filter:
            continue
        st = rec.inp.recover_state(infer_bound=True)
        out.append((st, rec.res.mean_cost))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log", type=str)
    p.add_argument("--max-lines", type=int, default=None)
    p.add_argument("--idx", type=int, default=None)
    args = p.parse_args(argv)

    states = return_all_states(args.log, args.max_lines)
    if args.idx is not None:
        states = [states[args.idx]]
    for i, (st, cost) in enumerate(states):
        print(f"=== program {i}  cost {cost:.6g} ===")
        print(st.to_str(True))
    return states


if __name__ == "__main__":
    main()
