"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. At first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library in
``vae_extent_search_tpu_torch/build/`` (gitignored) and loaded with
ctypes. Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from functools import lru_cache
from pathlib import Path
from typing import Callable, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# shared memory a block may use on an H100 (227 KB), and an SM's (228 KB)
MAX_SMEM_BYTES = 232_448
SM_SMEM_BYTES = 233_472


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


class CudaLibrary:
    """``csrc/<name>.cu`` built into ``build/lib<name>.so``; ``declare``
    sets the argtypes and restypes of the C functions on the loaded
    library."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / f"{name}.cu"
        self.library = BUILD_DIR / f"lib{name}.so"
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()

    def build(self, force: bool = False) -> Tuple[Path, str, float]:
        """Compile the source if the library is missing or older than it
        or than a header in ``csrc/`` (or always, with ``force``). Returns
        (library path, compiler output, seconds spent compiling; 0.0 when
        nothing was rebuilt).
        Builds of different libraries may run at the same time."""
        newest = max(p.stat().st_mtime
                     for p in [self.source, *CSRC.glob("*.cuh")])
        if (not force and self.library.exists()
                and self.library.stat().st_mtime >= newest):
            return self.library, "", 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                               str(self.source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, self.library)
        return self.library, proc.stdout + proc.stderr, seconds

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                path, _, _ = self.build()
                lib = ctypes.CDLL(str(path))
                self._declare(lib)
                self._lib = lib
            return self._lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The number of SMs of the CUDA device ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count
