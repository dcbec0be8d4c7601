"""Analytic hardware platform registry: TenSet's 6-platform dimension.

A copy of ``vae_extent_search_tpu/search/platforms.py``.

The reference dataset spans six hardware platforms (reference
README.md:20-27 — Intel Platinum 8272CL, Intel E5-2673 v4, AMD EPYC
7452, AWS Graviton2, NVIDIA K80, NVIDIA T4), and cross-platform
structure is first-class there: ``random_split_by_target``
(dataset.py:152-179), ``transfer_tune`` (task_scheduler.py:498-583) and
the transfer-learning ablation (tl_compare) all key on the target
string. TPU hosts do not execute candidate AVX/NEON/CUDA kernels
(SURVEY §7 keeps real timing as an external adapter), so each platform
here is an *analytic* profile: a target string carried in the records,
the HardwareParams that shape its schedule space (sketch rules), and the
roofline constants that price its schedules in the two analytic runners
(search/measure.py::AnalyticRunner, search/analytic_hf.py).

Profile constants are plausible for each machine class (vector width,
core count, bandwidth hierarchy, GPU occupancy limits) — chosen for
*relative* pricing that makes cross-platform transfer a real learning
problem, not for absolute accuracy. The default platform
(platinum-8272) is bit-identical to the framework's historical default
constants, so corpora generated before this registry existed replay
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .analytic_hf import DEFAULT_HW, HFHardware


@dataclass(frozen=True)
class BaseRunnerConsts:
    """Constants of the low-fidelity AnalyticRunner cost
    (search/measure.py:118-162)."""

    peak_gflops: float = 100.0
    num_cores: int = 8
    vector_width: int = 16
    l1_elems: float = 4096.0


@dataclass(frozen=True)
class Platform:
    name: str           # short platform name (record-folder name)
    target: str         # target string carried in records / LearningTask
    hf: HFHardware      # analytic_hf roofline constants
    base: BaseRunnerConsts
    # HardwareParams fields that differ per platform (sketch-rule knobs)
    num_cores: int = 8
    vector_unit_bytes: int = 64

    @property
    def is_gpu(self) -> bool:
        return self.target.split()[0] == "cuda"


# ---------------------------------------------------------------------------
# The six platforms. CPU profiles vary the vector ISA (avx512=16 f32
# lanes / avx2=8 / neon=4), core count and memory hierarchy; the two
# GPU profiles share the k80-era CPU-side fields (unused for GPU
# states) and differ in SM-array scale and bandwidth. DEFAULT_HW *is*
# the platinum-8272 profile and the K80 GPU profile (its GPU-side
# fields were always K80-ish), keeping historical corpora bit-stable.
# ---------------------------------------------------------------------------

_PLATINUM_HF = DEFAULT_HW  # scalar 6e9, vw 16, 8 cores, dram 30e9

_E5_HF = HFHardware(
    scalar_ips=4.6e9, vector_width=8, num_cores=12,
    bw_dram=25e9, bw_l2=200e9, bw_l1=800e9,
    l1_bytes=32 * 1024, l2_bytes=256 * 1024,
)

_EPYC_HF = HFHardware(
    scalar_ips=5.5e9, vector_width=8, num_cores=32,
    bw_dram=85e9, bw_l2=300e9, bw_l1=1200e9,
    l1_bytes=32 * 1024, l2_bytes=512 * 1024,
)

_GRAVITON2_HF = HFHardware(
    scalar_ips=5.0e9, vector_width=4, num_cores=64,
    bw_dram=100e9, bw_l2=250e9, bw_l1=900e9,
    l1_bytes=64 * 1024, l2_bytes=1024 * 1024,
)

_K80_HF = DEFAULT_HW  # gpu: 2e12 ips, 26624 par, 160e9 dram, 48K smem

_T4_HF = HFHardware(
    # turing: fewer resident threads than kepler but far higher clocks,
    # bandwidth and issue throughput
    gpu_peak_ips=8e12, gpu_max_par=40960.0,
    gpu_bw_dram=300e9, gpu_bw_smem=2400e9,
    gpu_smem_bytes=64 * 1024, launch_s=5e-7,
)

PLATFORMS: Dict[str, Platform] = {
    p.name: p
    for p in [
        Platform(
            name="platinum-8272",
            target="llvm -mcpu=skylake-avx512",
            hf=_PLATINUM_HF,
            base=BaseRunnerConsts(),  # the historical defaults
            num_cores=8, vector_unit_bytes=64,
        ),
        Platform(
            name="e5-2673",
            target="llvm -mcpu=core-avx2",
            hf=_E5_HF,
            base=BaseRunnerConsts(peak_gflops=55.0, num_cores=12,
                                  vector_width=8, l1_elems=4096.0),
            num_cores=12, vector_unit_bytes=32,
        ),
        Platform(
            name="epyc-7452",
            target="llvm -mcpu=znver2",
            hf=_EPYC_HF,
            base=BaseRunnerConsts(peak_gflops=160.0, num_cores=32,
                                  vector_width=8, l1_elems=4096.0),
            num_cores=32, vector_unit_bytes=32,
        ),
        Platform(
            name="graviton2",
            target="llvm -mtriple=aarch64-linux-gnu -mattr=+neon",
            hf=_GRAVITON2_HF,
            base=BaseRunnerConsts(peak_gflops=160.0, num_cores=64,
                                  vector_width=4, l1_elems=8192.0),
            num_cores=64, vector_unit_bytes=16,
        ),
        Platform(
            name="k80",
            target="cuda -model=k80",
            hf=_K80_HF,
            base=BaseRunnerConsts(),  # GPU states don't use base consts
            num_cores=-1, vector_unit_bytes=16,
        ),
        Platform(
            name="t4",
            target="cuda -model=t4",
            hf=_T4_HF,
            base=BaseRunnerConsts(),
            num_cores=-1, vector_unit_bytes=16,
        ),
    ]
}

_DEFAULT_CPU = PLATFORMS["platinum-8272"]
_DEFAULT_GPU = PLATFORMS["k80"]


def is_default_cpu_platform(p: Platform) -> bool:
    """True for the platform whose constants are the historical
    framework defaults (platinum-8272): callers preserving pre-registry
    behavior (HardwareParams host-cpu-count, AnalyticRunner defaults)
    key on this."""
    return p is _DEFAULT_CPU


def platform_by_name(name: str) -> Platform:
    try:
        return PLATFORMS[name]
    except KeyError:
        raise KeyError(
            f"unknown platform {name!r}; known: {sorted(PLATFORMS)}"
        ) from None


def platform_for_target(target: str) -> Platform:
    """Resolve a target string to its platform profile.

    Exact target-string matches win; otherwise fall back by -model=
    (GPUs) / -mcpu= / -mtriple= fragments, then to the default profile
    of the target kind — bare ``llvm`` is platinum-8272 and bare
    ``cuda`` is k80, which keeps every pre-registry corpus priced
    exactly as before.
    """
    target = target or "llvm"
    for p in PLATFORMS.values():
        if p.target == target:
            return p
    kind = target.split()[0]
    if kind == "cuda":
        for p in PLATFORMS.values():
            if p.is_gpu and _frag(p.target, "-model=") == _frag(target,
                                                               "-model="):
                if _frag(target, "-model="):
                    return p
        return _DEFAULT_GPU
    for p in PLATFORMS.values():
        if not p.is_gpu:
            for key in ("-mcpu=", "-mtriple="):
                fp, ft = _frag(p.target, key), _frag(target, key)
                if fp and ft and fp == ft:
                    return p
    return _DEFAULT_CPU


def _frag(target: str, key: str) -> Optional[str]:
    for tok in target.split():
        if tok.startswith(key):
            return tok[len(key):]
    return None
