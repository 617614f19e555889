"""Wrapper of the hand-written CUDA per-row activation quantize
(``csrc/row_quantize.cu``): ``core.quantize.absmax_quantize(x, bits,
axis=-1)`` in one pass over ``x``, the same codes and scales bit for bit,
and the scale widened to float32 besides (the W8A8 GEMM's operand).

  x (…, K) bf16, fp16 or fp32, last dim contiguous
  → codes (…, K) int8, scale (…, 1) in x's dtype, scale32 (M, 1) float32

The plain version is the chain in ``core/quantize.py::absmax_quantize``,
which runs wherever :func:`kernel_applies` says no.  This wrapper launches
the kernel on the current stream or raises.  Every launch adds one to
``launches["row_quantize"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

__all__ = ["row_quantize", "kernel_applies", "DTYPES", "MAX_K", "launches",
           "reset_launches", "load_library"]

#: the input types the kernel takes, by the code its launch takes
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

#: the longest row the kernel holds on chip (32 warps of 32 elements a
#: thread); longer rows keep the plain chain
MAX_K = 32768

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"row_quantize": 0}

# 1e-8 (the plain chain's absmax floor) rounded to each type
_FLOOR = {dt: float(torch.tensor(1e-8, dtype=dt)) for dt in DTYPES}


def reset_launches() -> None:
    launches["row_quantize"] = 0


def kernel_applies(device_type: str, dtype: torch.dtype, shape,
                   last_stride: int, axis: int, bits: int) -> bool:
    """Whether the kernel computes ``absmax_quantize`` of a tensor with
    these attributes: on the card, bf16, fp16 or fp32, the absmax over the
    last axis with a stride of 1, 1 ≤ K ≤ :data:`MAX_K`, codes of 1 to 8
    bits.  (DTensors, autograd and dispatch modes are the caller's to
    refuse: see ``core.quantize``.)"""
    ndim = len(shape)
    return (device_type == "cuda" and dtype in DTYPES and ndim >= 1
            and axis in (-1, ndim - 1) and 1 <= bits <= 8
            and last_stride == 1 and 1 <= shape[-1] <= MAX_K)


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F = ctypes.c_float
_SYMBOLS = {"row_quantize_launch": [_P] * 4 + [_I64] * 3 + [_I, _F, _F, _P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("row_quantize", _SYMBOLS)


def row_quantize(x: torch.Tensor, bits: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(codes, scale, scale32)``: ``absmax_quantize(x, bits, -1)``'s pair
    and the scale in float32 as an (M, 1) contiguous tensor, M the product
    of x's leading dims.  Leading dims that do not flatten to one row
    stride are copied first (an exact copy).  Raises on what
    :func:`kernel_applies` refuses."""
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the row quantize kernel takes "
                         "CUDA tensors (the plain form is "
                         "core.quantize.absmax_quantize)")
    if not kernel_applies("cuda", x.dtype, x.shape,
                          x.stride(-1) if x.dim() else 0, -1, bits):
        raise ValueError(f"the row quantize kernel does not take x "
                         f"{tuple(x.shape)} {x.dtype} (strides "
                         f"{x.stride()}) at bits={bits}")
    k = x.shape[-1]
    rows = x if x.is_contiguous() else x.reshape(-1, k)
    m = x.numel() // k
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    f32 = x.dtype == torch.float32
    scale32 = (scale.view(m, 1) if f32 else
               torch.empty((m, 1), dtype=torch.float32, device=x.device))
    if m == 0:
        return codes, scale, scale32
    ctx, stream = _build.device_stream(x.device)
    with ctx:
        rc = load_library().row_quantize_launch(
            rows.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            None if f32 else scale32.data_ptr(), m, k,
            rows.stride(0) if rows is not x and m > 1 else k,
            DTYPES[x.dtype], 2.0 ** (bits - 1) - 1, _FLOOR[x.dtype], stream)
    _build.count_launch(rc, "row_quantize", launches, "row_quantize")
    return codes, scale, scale32
