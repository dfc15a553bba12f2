"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into ``build/kernels/<name>-<hash>.so`` at the root of the checkout (a
directory ``.gitignore`` lists), for ``sm_90a`` (Hopper). The hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded from the cache. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("whole_search", "random_rollout")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives (source+flags hash in the name)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, verbose: bool) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: tuple[str, ...] = KERNELS, verbose: bool = False) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per kernel (0 when cached);
    raises with the compiler's output if a build fails. With ``verbose``,
    ptxas's register/shared-memory report is printed."""
    t0 = time.perf_counter()
    jobs = {name: _start(name, verbose) for name in names}
    seconds = {}
    for name, job in jobs.items():
        if job is None:
            seconds[name] = 0.0
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        if verbose and log:
            print(log)
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    return seconds


@cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
