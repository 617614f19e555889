"""Wrapper of the hand-written CUDA W8A8 GEMM (``csrc/fixedpoint_matmul.cu``),
the port of ``repro.kernels.fixedpoint_matmul.fixedpoint_matmul_pallas``:
the paper's integer datapath (C1) on Hopper's int8 tensor cores.

  x_codes (M, K) int8 · w_codes (K, N) int8 · x_scale (M, 1) float32 ·
  w_scale (1, N) float32 → (M, N) float32 = (acc · x_scale) · w_scale

For tensors on the CPU it runs the plain version
(``ref.fixedpoint_matmul_ref``).  For tensors on the card it launches the
kernel on the current stream or raises — there is no fallback.  Any M, N
and K: the kernel predicates the ragged edges itself (the wrapper pads
nothing).  Every launch adds one to ``launches["fixedpoint_matmul"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .ref import fixedpoint_matmul_ref

__all__ = ["fixedpoint_matmul", "launches", "reset_launches", "load_library"]

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"fixedpoint_matmul": 0}

_MAX_M = 65535 * 128  # the grid's y extent × the block's rows


def reset_launches() -> None:
    launches["fixedpoint_matmul"] = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("fixedpoint_matmul")
    fn = lib.fixedpoint_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fixedpoint_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                      x_scale: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """W8A8 GEMM with per-row / per-column scales (see the module note)."""
    if x_codes.device.type == "cpu":
        return fixedpoint_matmul_ref(x_codes, w_codes, x_scale, w_scale)
    if x_codes.device.type != "cuda":
        raise ValueError(f"no fixedpoint_matmul kernel for device "
                         f"{x_codes.device}")
    if x_codes.dim() != 2 or w_codes.dim() != 2:
        raise ValueError(f"2-D codes expected, got {tuple(x_codes.shape)} and "
                         f"{tuple(w_codes.shape)}")
    (m, k), n = x_codes.shape, w_codes.shape[1]
    dev = x_codes.device
    _check("x_codes", x_codes, torch.int8, (m, k), dev)
    _check("w_codes", w_codes, torch.int8, (k, n), dev)
    _check("x_scale", x_scale, torch.float32, (m, 1), dev)
    _check("w_scale", w_scale, torch.float32, (1, n), dev)
    if m > _MAX_M:
        raise ValueError(f"M={m} above the kernel's grid limit {_MAX_M}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fixedpoint_matmul_launch(
            x_codes.data_ptr(), w_codes.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"fixedpoint_matmul launch failed: CUDA error {rc}")
    launches["fixedpoint_matmul"] += 1
    return out
