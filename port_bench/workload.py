"""What a cell runs, found by name, and the inputs drawn from its seed.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
is a JSON file of its own (``configs/<config>.json``, ``traffic/<traffic>
.json``), and the limits that decide ``correct`` are ``limits/<cell>.json``.
The one generator here reads any of them:

- the candidate pool: ``pool_rows`` rows, each column's values drawn
  uniformly from that column of the configuration's frozen pool
  (``pool_file``), then standardised as the search standardises its pool
  (log1p, then each column to mean 0 and standard deviation 1);
- the parameters of each phase: a fresh draw of every weight and bias at
  the configuration's widths, uniform in +-sqrt(3 / fan_in) for weights
  and +-sqrt(1 / fan_in) for biases (torch.nn.Linear's initialisation);
- the episodes: each starts from ``initial_measured`` rows drawn without
  replacement and runs ``episode_phases`` phases, each adding its picks to
  the measured set.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# streams of the run's seed
POOL, WEIGHTS, SELECT, EPISODES, SAMPLE, FAULT = range(6)


def sub_seed(seed: int, stream: int, *more: int) -> int:
    """A 63-bit seed for ``stream`` of the run's ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream, *more])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(has {sorted(cells)})")
    w = cells[name]
    bench = root / "port_bench"
    return Cell(name, w["config"], w["traffic"], int(w["chips"]),
                json.loads((bench / "configs" / f"{w['config']}.json")
                           .read_text()),
                json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
                json.loads((bench / "limits" / f"{name}.json").read_text()))


def layer_dims(cfg: Dict) -> Dict[str, List[int]]:
    """[in, out] of every dense layer the predictor holds."""
    D, H, L = cfg["input_dim"], cfg["hidden_dim"], cfg["latent_dim"]
    P = cfg["predictor_hidden"]
    enc = [D] + [H] * cfg["encoder_layers"]
    head = [L] + [P] * cfg["predictor_layers"] + [1]
    return {"encoder": list(zip(enc[:-1], enc[1:])), "fc_mu": [(H, L)],
            "fc_logvar": [(H, L)], "cost_predictor": list(zip(head[:-1],
                                                                head[1:]))}


class WeightSource:
    """Fresh predictor parameters on the device, one draw per call, in
    float32 (the type the search hands to the selection phase): one
    uniform draw of every value, scaled by each value's bound, split into
    views 16-byte aligned."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(sub_seed(seed, WEIGHTS))
        self.device = device
        self.layout = []
        bounds = []
        off = 0
        for key, dims in layer_dims(cfg).items():
            for fan_in, fan_out in dims:
                for shape, bound in (((fan_in, fan_out), (3.0 / fan_in) ** .5),
                                     ((fan_out,), (1.0 / fan_in) ** .5)):
                    n = int(np.prod(shape))
                    self.layout.append((key, shape, off))
                    bounds.append((off, n, bound))
                    off += -(-n // 4) * 4
        self.total = off
        scale = torch.zeros(off, dtype=torch.float32)
        for o, n, bound in bounds:
            scale[o:o + n] = 2.0 * bound
        self.scale = scale.to(device)
        self.shift = self.scale / 2

    def draw(self) -> Dict:
        flat = torch.rand(self.total, generator=self.gen,
                          device=self.device).mul_(self.scale).sub_(self.shift)
        params: Dict = {}
        it = iter(self.layout)
        for key, shape, off in it:
            _, bshape, boff = next(it)
            layer = {"w": flat[off:off + int(np.prod(shape))].view(shape),
                     "b": flat[boff:boff + bshape[0]]}
            params.setdefault(key, []).append(layer)
        for key in ("fc_mu", "fc_logvar"):
            params[key] = params[key][0]
        return params


def standardize(X: torch.Tensor) -> torch.Tensor:
    """log1p, then each column to mean 0 and (population) standard
    deviation 1, a column of standard deviation under 1e-12 divided by 1
    (the search's ``standardize``), in place on the device."""
    X.log1p_()
    mean = X.mean(0)
    std = X.std(0, correction=0)
    std = torch.where(std < 1e-12, torch.ones_like(std), std)
    return X.sub_(mean).div_(std)


def draw_pool(cfg: Dict, traffic: Dict, seed: int, device,
              chunk: int = 32768) -> torch.Tensor:
    """[pool_rows, D] float32 standardised candidate rows on the device."""
    with np.load(HERE / cfg["pool_file"]) as z:
        real = torch.as_tensor(z["features"].astype(np.float32))
    n, D = int(traffic["pool_rows"]), real.shape[1]
    if D != cfg["input_dim"]:
        raise ValueError(f"{cfg['pool_file']} has {D} columns, the "
                         f"configuration {cfg['input_dim']}")
    real = real.to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, POOL))
    X = torch.empty(n, D, dtype=torch.float32, device=device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        idx = torch.randint(0, real.shape[0], (r1 - r0, D), generator=gen,
                            device=device)
        X[r0:r1] = real.gather(0, idx)
    return standardize(X)


def episode_start(traffic: Dict, seed: int, episode: int) -> np.ndarray:
    """The measured rows an episode starts from."""
    rng = np.random.default_rng(sub_seed(seed, EPISODES, episode))
    return rng.choice(int(traffic["pool_rows"]),
                      int(traffic["initial_measured"]), replace=False)
