"""The ingress result cache's probe sweeps as one host call per chunk.

``csrc/result_cache.cpp`` walks every row's probe chain in C++ on
:class:`~repro_torch.core.ingress.ResultCache`'s own numpy arrays, passed
by pointer, where the plain versions (``ref.result_cache_lookup_ref`` and
``ref.result_cache_insert_ref``) sweep the chunk in rounds of numpy calls.
Both leave the same table and return the same numbers; the tests hold
them to each other.  The library is built with the host C++ compiler at
first use (``_build.bind(..., host=True)``); where there is none,
``load_library`` and ``sweeps`` return ``None`` and the cache keeps the
plain sweeps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from . import _build

__all__ = ["load_library", "sweeps", "lookup", "insert"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SYMBOLS = {"rc_lookup": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P],
            "rc_insert": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                          _I, _P, _P]}


def load_library() -> Optional[ctypes.CDLL]:
    return _build.bind("result_cache", _SYMBOLS, restype=_I, host=True)


def sweeps():
    """``(lookup, insert)`` bound to the loaded library, with the plain
    versions' signatures; ``None`` where no C++ compiler is found."""
    lib = load_library()
    if lib is None:
        return None
    return functools.partial(lookup, lib), functools.partial(insert, lib)


def _rows(a: np.ndarray, dtype, n: int, width: Optional[int] = None):
    """``a`` as a C-contiguous array of ``dtype`` and shape ``(n,)`` or
    ``(n, width)``; refuses anything else before a pointer is taken."""
    a = np.ascontiguousarray(a)
    want = (n,) if width is None else (n, width)
    if a.dtype != dtype or a.shape != want:
        raise ValueError(f"expected {np.dtype(dtype)} {want}, got "
                         f"{a.dtype} {a.shape}")
    return a


def _out(a: np.ndarray, dtype, rows: int, width: Optional[int] = None):
    """Checks an output buffer the routine writes: C-contiguous, of
    ``dtype``, at least ``rows`` rows of ``width``."""
    if a.dtype != dtype or not a.flags.c_contiguous or a.shape[0] < rows \
            or a.shape[1:] != (() if width is None else (width,)):
        raise ValueError(f"output buffer {a.dtype} {a.shape} does not hold "
                         f"{rows} rows of {np.dtype(dtype)}")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def lookup(lib: ctypes.CDLL, keys: np.ndarray, vals: np.ndarray,
           state: np.ndarray, max_probe: int, words: np.ndarray,
           hashes: np.ndarray, hit_slot: np.ndarray, hit_vals: np.ndarray):
    """The native twin of ``ref.result_cache_lookup_ref`` through ``lib``,
    same arguments after it and same results: ``(hits, slots visited)``."""
    cap, kw = keys.shape
    vb = vals.shape[1]
    n = words.shape[0]
    words = _rows(words, np.uint64, n, kw)
    hashes = _rows(hashes, np.uint64, n)
    _out(hit_slot, np.int64, n)
    _out(hit_vals, np.uint8, n, vb)
    visited = ctypes.c_int64(0)
    n_hit = lib.rc_lookup(
        _ptr(keys), _ptr(vals), _ptr(state), cap, kw, vb, max_probe,
        _ptr(words), _ptr(hashes), n, _ptr(hit_slot), _ptr(hit_vals),
        ctypes.byref(visited))
    return n_hit, visited.value


def insert(lib: ctypes.CDLL, keys: np.ndarray, vals: np.ndarray,
           state: np.ndarray, model: np.ndarray, claim: np.ndarray,
           max_probe: int, words: np.ndarray, new_vals: np.ndarray,
           model_ids: np.ndarray, hashes: np.ndarray):
    """The native twin of ``ref.result_cache_insert_ref`` through ``lib``,
    same arguments after it and same results: ``(admitted, tombstones
    reclaimed, slots visited)``."""
    cap, kw = keys.shape
    vb = vals.shape[1]
    n = words.shape[0]
    words = _rows(words, np.uint64, n, kw)
    new_vals = _rows(new_vals, np.uint8, n, vb)
    model_ids = _rows(model_ids, np.int64, n)
    hashes = _rows(hashes, np.uint64, n)
    reclaimed = ctypes.c_int64(0)
    visited = ctypes.c_int64(0)
    admitted = lib.rc_insert(
        _ptr(keys), _ptr(vals), _ptr(state), _ptr(model), _ptr(claim), cap,
        kw, vb, max_probe, _ptr(words), _ptr(new_vals), _ptr(model_ids),
        _ptr(hashes), n, ctypes.byref(reclaimed), ctypes.byref(visited))
    return admitted, reclaimed.value, visited.value
