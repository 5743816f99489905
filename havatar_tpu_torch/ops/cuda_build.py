"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/`` at the root of the checkout (git ignores it),
then loaded with ``ctypes``. The library's file name carries a hash of its
source, of every ``csrc/*.cuh`` header (the sources share device code
through them) and of the flags, so an edited source or header is rebuilt and
an unchanged one is reused. Nothing here runs at import time: a library is
built on its first CUDA use, and importing needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # source name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile the named sources that have no current library, one ``nvcc``
    per source, all started together. The library appears under its final
    name only once ``nvcc`` has succeeded."""
    with _lock:
        jobs = []
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
