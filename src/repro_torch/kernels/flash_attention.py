"""Wrapper of the hand-written CUDA flash-attention forward
(``csrc/flash_attention.cu``): the causal forward of ``models/flash.py``
on Hopper's bf16/fp16 tensor cores, with wgmma and TMA.

  q (B, H, S, Dqk) pre-scaled · k (B, H_kv, S, Dqk) · v (B, H_kv, S, Dv)
  → out (B, H, S, Dv) in the input type, lse (B, H, S) float32

Query head ``h`` reads KV head ``h // (H / H_kv)``: grouped heads share
K/V by index.  The inputs are strided views with the last dim contiguous
(what ``(B, S, H, D).transpose(1, 2)`` gives); nothing is copied.  The
kernel takes the pairs in :data:`HEAD_DIMS` in bf16 or fp16, causal only.

The plain version is ``models/flash.py::_flash_fwd`` (on repeated K/V),
which ``models/flash.py::flash_attention`` runs wherever
:func:`kernel_applies` says no.  This wrapper launches the kernel on the
current stream or raises: CPU tensors, other dtypes, shapes, strides or
alignments are refused.  Every launch adds one to
``launches["flash_attention"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

__all__ = ["flash_attention_fwd", "kernel_applies", "tma_ready", "chunk_rows",
           "HEAD_DIMS", "DTYPES", "L2_SHARE", "launches", "reset_launches",
           "load_library"]

#: the (Dqk, Dv) pairs the kernel is built for
HEAD_DIMS = ((128, 128), (192, 128))
#: the input types it takes
DTYPES = (torch.bfloat16, torch.float16)

#: bytes of distinct K/V the blocks on the card at once should read (of the
#: H100's 50 MB L2)
L2_SHARE = 16 << 20

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def kernel_applies(device_type: str, dtype: torch.dtype, q_shape, k_shape,
                   v_shape, causal: bool, mode_active: bool = False) -> bool:
    """Whether the kernel computes this call: CUDA tensors in bf16 or
    fp16, causal, q (B, H, S, Dqk), k (B, H_kv, S, Dqk), v (B, H_kv, S, Dv)
    with (Dqk, Dv) built and H % H_kv == 0, and no dispatch mode active (the
    dry run's cost counter, fake tensors), which must see the plain ops."""
    if device_type != "cuda" or dtype not in DTYPES or not causal \
            or mode_active:
        return False
    if not (len(q_shape) == len(k_shape) == len(v_shape) == 4):
        return False
    b, h, s, dqk = q_shape
    hkv = k_shape[1]
    return (tuple(k_shape) == (b, hkv, s, dqk)
            and tuple(v_shape[:3]) == (b, hkv, s)
            and (dqk, v_shape[3]) in HEAD_DIMS
            and hkv > 0 and h % hkv == 0 and s > 0)


def chunk_rows(b: int, h: int, hkv: int, s: int, dqk: int, dv: int) -> int:
    """(batch, head) rows the kernel walks together, longest causal rows
    first across them: as many as keep their distinct K/V (a KV head's
    bytes shared by its H / H_kv query heads) within :data:`L2_SHARE`, at
    least one and at most all B·H."""
    per_row = s * (dqk + dv) * 2 * hkv // h
    return max(1, min(b * h, L2_SHARE // max(per_row, 1)))


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SYMBOLS = {"flash_attention_fwd_launch": [_P] * 5 + [_I] * 7 + [_I64] * 9
            + [_I, _P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("flash_attention", _SYMBOLS)


def _tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, row) strides in elements; a dim of size 1 takes any
    stride, so it is given one TMA accepts."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 8 for i in range(3))


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA reads the 4-d ``t`` as it lies: last dim contiguous, the
    other strides positive multiples of 16 bytes, a 16-byte aligned start."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(x > 0 and x % 8 == 0 for x in _tma_strides(t)))


def _strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    if not tma_ready(t):
        raise ValueError(f"{name} (strides {t.stride()}) must have its last "
                         "dim contiguous, its other strides multiples of 8 "
                         "elements and a 16-byte aligned start (TMA)")
    return _tma_strides(t)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal forward on the card: ``(out, lse)`` as
    ``models.flash._flash_fwd`` returns them (see the module docstring)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the flash kernel "
                             "takes CUDA tensors (the plain form is "
                             "models.flash._flash_fwd)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            "q, k and v all bf16 or all fp16")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    b, h, s, dqk = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    if tuple(k.shape) != (b, hkv, s, dqk) or tuple(v.shape[:3]) != (b, hkv, s):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, H, S, Dqk), "
                         "(B, H_kv, S, Dqk), (B, H_kv, S, Dv)")
    if (dqk, dv) not in HEAD_DIMS:
        raise ValueError(f"(Dqk, Dv) = {(dqk, dv)} is not built; the kernel "
                         f"takes {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    strides = [_strides(n, t) for n, t in (("q", q), ("k", k), ("v", v))]
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    ctx, stream = _build.device_stream(q.device)
    with ctx:
        rc = load_library().flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, s, dqk, dv,
            int(q.dtype == torch.float16), *strides[0], *strides[1],
            *strides[2], chunk_rows(b, h, hkv, s, dqk, dv), stream)
    _build.count_launch(rc, "flash_attention", launches, "flash_attention")
    return out, lse
