"""Build, load and launch the hand-written CUDA kernels and host routines.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``<repo>/build/kernels/lib<name>-<hash>.so`` at
first use (the hash covers the source, the ``csrc/`` headers it includes
and the flags, so an edited source or header rebuilds and a stale library
is never loaded) and bound with ``ctypes`` by :func:`bind`.  Each
``csrc/<name>.cpp`` is a host routine, built the same way with the host C++
compiler (``bind(..., host=True)``).  Nothing here runs at import time; a
missing ``nvcc`` or a failed build raises, and a host routine binds to
``None`` where no C++ compiler is found.

The wrappers launch through the same few steps: :func:`check` each tensor,
:func:`device_stream` for the launch's device and stream, the bound C
function, then :func:`count_launch` on its return code; :func:`num_sms`
sizes persistent grids.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "CXX_FLAGS", "build",
           "build_all", "bind", "build_logs", "check", "device_stream",
           "count_launch", "num_sms"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}  # bound libraries by key
build_logs: Dict[str, str] = {}  # name -> nvcc's output (registers, smem)

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


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


def _headers(src: Path) -> List[Path]:
    """The headers beside ``src`` that it includes with ``#include "..."``,
    directly or through one another: each once, depth first, in the order
    of their ``#include`` lines."""
    found: List[Path] = []

    def walk(path: Path) -> None:
        for m in _INCLUDE.finditer(path.read_bytes()):
            header = src.parent / m.group(1).decode()
            if header.is_file() and header not in found:
                found.append(header)
                walk(header)

    walk(src)
    return found


def _target(src: Path, flags: List[str]) -> Path:
    text = src.read_bytes() + b"".join(h.read_bytes() for h in _headers(src))
    digest = hashlib.sha1(text + " ".join(flags).encode()).hexdigest()[:12]
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


def bind(name: str, symbols: Dict[str, Sequence], *, restype=ctypes.c_int,
         host: bool = False) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<name>.cu`` — ``.cpp`` with
    ``host`` — and give each of ``symbols``, ``{symbol: argtypes}``, its
    ``argtypes`` and ``restype``; once per process, after which this is a
    dictionary lookup.  The library's functions are its attributes.  A
    host routine binds to ``None`` where no C++ compiler is found."""
    key = name + ".cpp" if host else name
    try:
        return _libs[key]
    except KeyError:
        pass
    with _lock:
        if key not in _libs:
            lib = None
            if not host:
                lib = ctypes.CDLL(str(build(name)))
            elif _cxx() is not None:
                lib = ctypes.CDLL(str(_finish(name, *_start(name, ".cpp"))))
            if lib is not None:
                for symbol, argtypes in symbols.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
            _libs[key] = lib
        return _libs[key]


def check(name: str, t: torch.Tensor, dtype, shape, device: torch.device,
          contiguous: bool = True) -> None:
    """Refuse a kernel argument: ``ValueError`` unless ``t`` (the argument
    ``name``) lies on ``device`` with ``shape`` (a tuple) and, with
    ``contiguous``, contiguous; ``TypeError`` unless its dtype is ``dtype``
    (a dtype, or a tuple of those it may be)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype is not dtype and not (isinstance(dtype, tuple)
                                     and t.dtype in dtype):
        want = f"one of {dtype}" if isinstance(dtype, tuple) else dtype
        raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_SAME_DEVICE = contextlib.nullcontext()


def device_stream(dev: torch.device):
    """``(context, stream)`` for a launch on the card ``dev``: a context
    that makes ``dev`` current (none to enter when it already is: the
    kernel, its stream and its shared-memory limit are the current
    device's) and the raw handle of ``dev``'s current stream."""
    ctx = (_SAME_DEVICE if dev.index == torch._C._cuda_getDevice()
           else torch.cuda.device(dev))
    return ctx, torch._C._cuda_getCurrentRawStream(dev.index)


def count_launch(rc: int, kernel: str, counts: Dict[str, int],
                 key: str) -> None:
    """After a launch that returned CUDA error code ``rc``: raise a
    ``RuntimeError`` naming ``kernel`` unless it is 0, else add one to
    ``counts[key]``."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    counts[key] += 1


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """The SM count of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
