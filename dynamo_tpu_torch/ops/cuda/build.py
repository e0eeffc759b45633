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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("paged_decode", "paged_prefill", "moe_grouped",
                  "ring_flash")
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


def ptxas_report(name: str) -> list:
    """Per kernel instantiation of a built library, what `-Xptxas -v`
    said: registers, spill bytes (stores, loads), static shared memory and
    any warning (such as wgmma serialization), read from the build log
    (demangled where `c++filt` exists)."""
    log = (BUILD_DIR / f"{name}.log").read_text().splitlines()
    by_name = {m.group(1): {"kernel": m.group(1)} for m in (
        re.search(r"Compiling entry function '(\w+)'", ln) for ln in log) if m}
    out, entry = list(by_name.values()), None
    for line in log:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = by_name[m.group(1)]
            continue
        if "warning" in line or "Performance Loss" in line:
            m = re.search(r"function '(\w+)'", line)
            target = by_name.get(m.group(1)) if m else entry
            if target is not None:
                target.setdefault("warnings", []).append(line.strip())
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            entry["smem_static"] = int(s.group(1)) if s else 0
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            e["kernel"] for e in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        for e, n in zip(out, names):
            n = n.replace("(anonymous namespace)::", "").removeprefix("void ")
            e["kernel"] = n.split("(")[0]
    return out


def sass_counts(name: str,
                opcodes: Iterable[str] = ("HGMMA", "HMMA", "FFMA")) -> dict:
    """How many instructions of each opcode the built library's SASS
    holds (`cuobjdump -sass`)."""
    tool = Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     sass)
    return {op: sum(1 for o in ops if o == op) for op in opcodes}


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

