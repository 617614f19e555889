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
from typing import Dict

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


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("fixedpoint_mlp")
    fn = lib.fixedpoint_mlp_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, p, p, p, i, i, i, i, i, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    coeffs = [int(c) for c in np.asarray(sig_coeffs).reshape(-1).tolist()]
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
    _check("x", x, (torch.int32,), (n_batch, width), dev)
    _check("slot", slot, (torch.int32,), (n_batch,), dev)
    w_types = (torch.int8,) if variant == "int8" else tuple(_W_BYTES)
    _check("w", w, w_types, (n_models, n_layers, width, width), dev)
    _check("b", b, (torch.int32,), (n_models, n_layers, width), dev)
    _check("act", act, (torch.int32,), (n_models, n_layers), dev)
    _check("layer_on", layer_on, (torch.int32,), (n_models, n_layers), dev)
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
    lib = load_library()
    sig = (ctypes.c_int32 * len(coeffs))(*coeffs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fixedpoint_mlp_launch(
            x.data_ptr(), slot.data_ptr(), w.data_ptr(), _W_BYTES[w.dtype],
            b.data_ptr(), act.data_ptr(), layer_on.data_ptr(), out.data_ptr(),
            n_batch, n_models, n_layers, width, int(frac), sig, len(coeffs),
            int(leaky_alpha_q), int(variant == "int8"), stream)
    if rc != 0:
        raise RuntimeError(f"fixedpoint_mlp launch failed: CUDA error {rc}")
    launches[variant] += 1
    return out
