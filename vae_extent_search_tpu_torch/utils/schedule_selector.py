"""Best/random schedule mixing from record logs.

A copy of ``vae_extent_search_tpu/utils/schedule_selector.py``.

Parity target: scripts/vae_experiments/util_manager.py:263-340
ScheduleSelector — for latency-attribution experiments: keep the top
percent of records per workload, then compose one schedule per task
(random within the top set, or the best), write the mix as its own record
log, and report the summed recorded cost. Repeated mixes are rejected via
their line-index signatures.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Tuple


class ScheduleSelector:
    def __init__(self, workload_keys: Sequence[str], log_path: str,
                 seed: int = 0):
        self.workload_keys = list(workload_keys)
        self.log_path = log_path
        self.rng = random.Random(seed)

    def load_rec_only_high(self, percent: float = 0.05,
                           cost_filter: float = 1000.0) -> Dict:
        """{workload_key: [(record, mean_cost, line_idx), ...]} keeping only
        the cheapest ``percent`` of valid records per workload."""
        from ..records import iter_records

        records: Dict[str, List[Tuple]] = {wk: [] for wk in self.workload_keys}
        for line_idx, rec in enumerate(iter_records(self.log_path)):
            if rec.res.error_no != 0:
                continue
            cost = rec.res.mean_cost
            if cost >= cost_filter:
                continue
            wk = rec.inp.task.workload_key
            for key in self.workload_keys:
                if key in wk or wk in key:
                    records[key].append((rec, cost, line_idx))
                    break
        for wk in records:
            records[wk].sort(key=lambda x: x[1])
            keep = max(1, int(len(records[wk]) * percent))
            records[wk] = records[wk][:keep]
        return records

    def random_look4_better(self, records: Dict, seen: Optional[List] = None,
                            best: bool = False,
                            out_path: Optional[str] = None):
        """Compose one schedule per workload (best or random-in-top), write
        the mix as a record log, return (path, total_cost, line_indices)."""
        from ..records.serde import save_records

        seen_indices = [list(x) for x in (seen or [])]
        out_path = out_path or os.path.join(
            os.path.dirname(os.path.abspath(self.log_path)) or ".",
            "tmp_mix.json",
        )
        for _ in range(1000):
            chosen, line_indices, total = [], [], 0.0
            for wk in self.workload_keys:
                pool = records.get(wk)
                if not pool:
                    continue
                rec, cost, line_idx = pool[0] if best else \
                    self.rng.choice(pool)
                chosen.append(rec)
                line_indices.append(line_idx)
                total += cost
            if line_indices not in seen_indices:
                break
        save_records(out_path, chosen, mode="w")
        return out_path, total * 1000.0, line_indices
