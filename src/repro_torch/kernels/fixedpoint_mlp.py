"""Wrapper of the hand-written CUDA fused multi-model MLP kernel
(``csrc/fixedpoint_mlp.cu``), the port of
``repro.kernels.fixedpoint_mlp.fixedpoint_mlp_pallas``.

:func:`fixedpoint_mlp` takes the control plane's own table layout:

  x_q (B, W) int32 · slot (B,) int32 in ``[0, M)`` · w (M, L, W, W) int8/16/32 ·
  b (M, L, W) int32 · act, layer_on (M, L) int32 → (B, W) int32

For tensors on the CPU it runs the plain version
(``ref.fused_mlp_gather_ref``).  For tensors on the card it launches the
kernel on the current stream or raises — there is no fallback.  Every
launch adds one to ``launches[variant]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build
from .ref import fused_mlp_gather_ref

__all__ = ["fixedpoint_mlp", "KERNEL_VARIANTS", "MAX_WIDTH", "launches",
           "reset_launches", "load_library"]

KERNEL_VARIANTS = ("int16", "int8")
MAX_WIDTH = 128  # kMaxWidth in the CUDA source
_MAX_COEFFS = 8

#: kernel launches per weight lane since the last :func:`reset_launches`
launches: Dict[str, int] = {v: 0 for v in KERNEL_VARIANTS}

_W_BYTES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}


def reset_launches() -> None:
    for v in KERNEL_VARIANTS:
        launches[v] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"fixedpoint_mlp_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _P, _I, _I, _I, _P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("fixedpoint_mlp", _SYMBOLS)


@functools.lru_cache(maxsize=64)
def _packed(coeffs: tuple) -> Tuple[tuple, ctypes.Array]:
    """Taylor constants as Python ints and as the kernel's int32 array, made
    once per tuple of constants."""
    ints = tuple(int(c) for c in coeffs)
    return ints, (ctypes.c_int32 * len(ints))(*ints)


def _constants(sig_coeffs) -> Tuple[tuple, ctypes.Array]:
    if not isinstance(sig_coeffs, tuple):
        sig_coeffs = tuple(np.asarray(sig_coeffs).reshape(-1).tolist())
    return _packed(sig_coeffs)


def fixedpoint_mlp(x_q: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, act: torch.Tensor, layer_on: torch.Tensor,
                   *, frac: int, sig_coeffs, leaky_alpha_q: int,
                   variant: str = "int16") -> torch.Tensor:
    """Fused multi-model fixed-point MLP forward (see the module note).

    ``variant="int8"`` saturates codes into the int8 lane at entry and after
    every layer and needs int8 weight codes (``ControlPlane(weight_bits=8)``).
    """
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown kernel variant: {variant!r}")
    x = x_q
    coeffs, sig = _constants(sig_coeffs)
    lane_bits = 8 if variant == "int8" else None
    if x.device.type == "cpu":
        return fused_mlp_gather_ref(x, slot, w, b, act, layer_on, frac=frac,
                                    sig_coeffs=coeffs,
                                    leaky_alpha_q=leaky_alpha_q,
                                    lane_bits=lane_bits)
    if x.device.type != "cuda":
        raise ValueError(f"no fixedpoint_mlp kernel for device {x.device}")
    n_batch, width = x.shape
    n_models, n_layers = act.shape
    dev = x.device
    _build.check("x", x, torch.int32, (n_batch, width), dev)
    _build.check("slot", slot, torch.int32, (n_batch,), dev)
    w_types = (torch.int8,) if variant == "int8" else tuple(_W_BYTES)
    _build.check("w", w, w_types, (n_models, n_layers, width, width), dev)
    _build.check("b", b, torch.int32, (n_models, n_layers, width), dev)
    _build.check("act", act, torch.int32, (n_models, n_layers), dev)
    _build.check("layer_on", layer_on, torch.int32, (n_models, n_layers), dev)
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"width {width} outside the kernel's [1, {MAX_WIDTH}]")
    if not 1 <= len(coeffs) <= _MAX_COEFFS:
        raise ValueError(f"{len(coeffs)} Taylor constants; the kernel takes "
                         f"1..{_MAX_COEFFS}")
    if not 1 <= frac <= 30:
        raise ValueError(f"frac={frac} outside the kernel's [1, 30]")
    out = torch.empty_like(x)
    if n_batch == 0:
        return out
    ctx, stream = _build.device_stream(dev)
    with ctx:
        rc = load_library().fixedpoint_mlp_launch(
            x.data_ptr(), slot.data_ptr(), w.data_ptr(), _W_BYTES[w.dtype],
            b.data_ptr(), act.data_ptr(), layer_on.data_ptr(), out.data_ptr(),
            n_batch, n_models, n_layers, width, int(frac), sig, len(coeffs),
            int(leaky_alpha_q), int(variant == "int8"), stream)
    _build.count_launch(rc, "fixedpoint_mlp", launches, variant)
    return out
