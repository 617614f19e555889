"""Wrapper of the hand-written CUDA Taylor activation kernel
(``csrc/taylor_activation.cu``), the port of
``repro.kernels.taylor_activation.taylor_activation_pallas``: the paper's
integer Horner chain (C2) over int32 codes of any shape.

For tensors on the CPU it runs the plain version (the clamp, then
``ref.taylor_activation_ref``).  For tensors on the card it launches the
kernel on the current stream or raises — there is no fallback.  Every
launch adds one to ``launches["taylor_activation"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .ref import int32_coeffs, taylor_activation_ref

__all__ = ["taylor_activation", "CLAMP", "launches", "reset_launches",
           "load_library"]

#: the kernel's input clamp, ±(2**14 - 1) (the MLP's sigmoid arm uses ±2**14)
CLAMP = (1 << 14) - 1

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"taylor_activation": 0}

# coefficient sets already on a card: (constants, device) -> int32 tensor
_coeff_cache: Dict[Tuple[tuple, torch.device], torch.Tensor] = {}


def reset_launches() -> None:
    launches["taylor_activation"] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"taylor_activation_launch": [_P, _P, ctypes.c_int64, _P, _I, _I,
                                         _P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("taylor_activation", _SYMBOLS)


def _device_coeffs(coeffs: tuple, dev: torch.device) -> torch.Tensor:
    key = (coeffs, dev)
    t = _coeff_cache.get(key)
    if t is None:
        if len(_coeff_cache) >= 64:
            _coeff_cache.clear()
        t = torch.tensor(coeffs, dtype=torch.int32, device=dev)
        _coeff_cache[key] = t
    return t


def taylor_activation(x_q: torch.Tensor, coeffs, x_frac: int) -> torch.Tensor:
    """Integer-Horner polynomial activation: int32 codes at ``x_frac``
    fractional bits, clamped to ±``CLAMP``, through the ascending
    fixed-point constants ``coeffs`` (paper Table 4) → int32 codes at the
    constants' scale, same shape.  ``x_frac <= 0`` shifts nothing."""
    consts = tuple(int32_coeffs(coeffs))
    if x_q.device.type == "cpu":
        return taylor_activation_ref(torch.clamp(x_q, -CLAMP, CLAMP), consts,
                                     x_frac)
    if x_q.device.type != "cuda":
        raise ValueError(f"no taylor_activation kernel for device {x_q.device}")
    _build.check("x_q", x_q, torch.int32, x_q.shape, x_q.device)
    if x_frac > 31:
        raise ValueError(f"x_frac={x_frac} above the int32 shift range")
    out = torch.empty_like(x_q)
    if x_q.numel() == 0:
        return out
    dev = x_q.device
    c = _device_coeffs(consts, dev)
    ctx, stream = _build.device_stream(dev)
    with ctx:
        rc = load_library().taylor_activation_launch(
            x_q.data_ptr(), out.data_ptr(), x_q.numel(), c.data_ptr(),
            len(consts), int(x_frac), stream)
    _build.count_launch(rc, "taylor_activation", launches,
                        "taylor_activation")
    return out
