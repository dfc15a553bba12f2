"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each library is a ``csrc/<source>.cu`` with a plain C interface, compiled
with its own defines at first use into ``build/kernels/<name>-<hash>.so`` at
the root of the checkout (a directory ``.gitignore`` lists), for ``sm_90a``
(Hopper). The hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded from the cache. Every build keeps
ptxas's report (registers, stack frame and spills per kernel) beside its
library, in ``<name>-<hash>.log``. The whole-search
source builds one library per weight variant, so that its four kernels
compile in parallel. Nothing here runs when the module is imported.
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
# Library name -> (source in csrc/, defines).
LIBRARIES = {
    "whole_search": ("whole_search", ("-DWHOLE_SEARCH_BF16=0", "-DWHOLE_SEARCH_STREAMED=0")),
    "whole_search_bf16": ("whole_search", ("-DWHOLE_SEARCH_BF16=1", "-DWHOLE_SEARCH_STREAMED=0")),
    "whole_search_streamed": ("whole_search", ("-DWHOLE_SEARCH_BF16=0", "-DWHOLE_SEARCH_STREAMED=1")),
    "whole_search_bf16_streamed": ("whole_search", ("-DWHOLE_SEARCH_BF16=1", "-DWHOLE_SEARCH_STREAMED=1")),
    "random_rollout": ("random_rollout", ()),
    "ring_all_reduce": ("ring_all_reduce", ()),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # fmt: skip


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the built library ``name`` lives (source+flags hash in the name)."""
    source, defines = LIBRARIES[name]
    flags = " ".join(NVCC_FLAGS + defines).encode()
    digest = hashlib.sha256((CSRC / f"{source}.cu").read_bytes() + flags).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's output of the build of library ``name`` (built first if
    needed), ptxas's report included."""
    build_all((name,))
    return library_path(name).with_suffix(".log").read_text()


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    source, defines = LIBRARIES[name]
    cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: tuple[str, ...] = tuple(LIBRARIES)) -> dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    library, all started together. Returns seconds per library (0 when cached);
    raises with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in names}
    seconds = {}
    for name, job in jobs.items():
        if job is None:
            seconds[name] = 0.0
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    return seconds


@cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
