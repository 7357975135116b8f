"""Builds the CUDA sources in ``csrc/`` and loads them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` under
the repository root, at first use; the file name carries a hash of the
source and the flags, so an edited source is rebuilt.  Nothing here runs
at import time: the CPU tests import every module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
#: Per source name: ``{"seconds": build time, "log": nvcc's output}``
#: (empty log when the library was already built).
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the toolkit's under CUDA_HOME or
    /usr/local/cuda; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> tuple:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str):
    """Start nvcc for one source; returns (popen, src, out, tmp, t0) or
    None when the library is already built."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, src, out, tmp, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return
    proc, src, out, tmp, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build(names) -> None:
    """Build the named sources, one nvcc process each, all started
    together."""
    with _lock:
        jobs = [(name, _compile(name)) for name in names]
        for name, job in jobs:
            _finish(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _compile(name))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib
