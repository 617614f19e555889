"""Build and load the hand-written CUDA kernels and host routines.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``<repo>/build/kernels/lib<name>-<hash>.so`` at
first use (the hash is the source's, so an edited source rebuilds and a
stale library is never loaded) and bound with ``ctypes``.  Each
``csrc/<name>.cpp`` is a host routine, built the same way with the host C++
compiler (``load_host``).  Nothing here runs at import time; a missing
``nvcc`` or a failed build raises, and ``load_host`` returns ``None`` where
no C++ compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "CXX_FLAGS", "build",
           "build_all", "load", "load_host", "build_logs"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc's output (registers, smem)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on a machine with the CUDA toolkit")


def _cxx() -> Optional[str]:
    for cand in ("c++", "g++"):
        path = shutil.which(cand)
        if path:
            return path
    return None


def _target(src: Path, flags: List[str]) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _start(name: str, suffix: str = ".cu"):
    """Start one compiler for ``csrc/<name><suffix>`` unless its library
    already exists: ``nvcc`` for ``.cu``, the host C++ compiler for
    ``.cpp``.  Returns ``(target, process or None, temp path or None)``."""
    src = CSRC / f"{name}{suffix}"
    cuda = suffix == ".cu"
    flags = NVCC_FLAGS if cuda else CXX_FLAGS
    target = _target(src, flags)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc() if cuda else _cxx(), *flags, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: Path, proc, tmp) -> Path:
    if proc is None:
        return target
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{proc.args[0]} failed for {name}:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent builder never sees half
    return target


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` if its library is missing; return its path."""
    return _finish(name, *_start(name))


def build_all(names: Iterable[str]) -> List[Path]:
    """Compile several sources at once, one nvcc process each."""
    names = list(names)
    started = [(n, *_start(n)) for n in names]
    return [_finish(n, t, p, tmp) for n, t, p, tmp in started]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def load_host(name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the host routine ``csrc/<name>.cpp``;
    cached per process.  ``None`` where no C++ compiler is found."""
    with _lock:
        key = name + ".cpp"
        if key not in _libs:
            _libs[key] = None if _cxx() is None else ctypes.CDLL(
                str(_finish(name, *_start(name, ".cpp"))))
        return _libs[key]
