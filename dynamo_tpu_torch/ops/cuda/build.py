"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `dynamo_tpu_torch/csrc/<name>.cu` exports plain C functions
and compiles on its own into `dynamo_tpu_torch/_build/<name>-<hash>.so`
(the hash covers the source, the shared header and the flags, so an edit
rebuilds and an unchanged tree reuses the library).  `build_all` starts
one nvcc per source at once and waits for all of them.

Nothing here runs at import: a kernel's first launch builds and loads its
library.  The CPU tests never reach this module's build path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("paged_decode", "paged_prefill", "moe_grouped")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build on first use")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    log = open(BUILD_DIR / f"{name}.log", "w")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish(name: str, job) -> None:
    proc, log, tmp, out = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {rc}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every named kernel library, one nvcc per source, all started
    together; returns the seconds each build took (0 when reused)."""
    t0 = time.monotonic()
    with _lock:
        jobs = {n: _start(n) for n in names}
        times = {}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
            times[n] = time.monotonic() - t0 if job is not None else 0.0
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel source, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib

