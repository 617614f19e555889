"""Wrapper of the hand-written CUDA Mamba-2 SSD chunk scan
(``csrc/ssd_scan.cu``): the grouped SSD of a prefill in float32, each
head's state kept on chip across its chunks, in one launch.

  xh (B, T, H, P), bmat/cmat (B, T, G, N) in bf16, fp16 or fp32 (one type),
  dt (B, T, H) and a (H,) float32, any strides
  → y (B, T, H, P) float32 and the state after the last position
    (B, H, P, N) float32

Head h reads group h // (H / G), and the state starts at zero: the values
of ``models.ssm.ssd_grouped`` on the float32 copies of its inputs, within
float32 rounding (the kernel's chunk, :data:`CHUNK` positions, is its own;
the result does not depend on it).  The plain version is ``ssd_grouped``,
which ``models.zamba2.ssd`` keeps off the card and under autograd,
DTensors and dispatch modes.  This wrapper launches the kernel on the
current stream or raises on what :func:`kernel_applies` refuses.  Every
launch adds one to ``launches["ssd_scan"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

__all__ = ["ssd_scan", "kernel_applies", "plan", "DTYPES", "MAX_P", "MAX_N",
           "MAX_HEADS", "CHUNK", "launches", "reset_launches", "load_library"]

#: the input types of xh, bmat and cmat, by the code the launch takes
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

#: the kernel's limits: head dim P ≤ MAX_P, state size N ≤ MAX_N
MAX_P = 64
MAX_N = 64

#: the most heads one block takes (their states share its shared memory)
MAX_HEADS = 4

#: positions a chunk of the kernel holds
CHUNK = 64

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"ssd_scan": 0}


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def kernel_applies(xh: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   dt: torch.Tensor, a: torch.Tensor) -> bool:
    """Whether the kernel computes the SSD of these operands: all on one
    card, xh (B, T, H, P), bmat and cmat (B, T, G, N) in one of
    :data:`DTYPES`, dt (B, T, H) and a (H,) in float32, B, T ≥ 1, G ≥ 1
    dividing H, 1 ≤ P ≤ :data:`MAX_P`, 1 ≤ N ≤ :data:`MAX_N`.  Any strides,
    0 included (B and C of one group expanded over the groups).
    (DTensors, autograd and dispatch modes are the caller's to refuse: see
    ``models.zamba2``.)"""
    dev = xh.device
    return (dev.type == "cuda"
            and all(t.device == dev for t in (bmat, cmat, dt, a))
            and _fits(xh, bmat, cmat, dt, a))


def _fits(xh, bmat, cmat, dt, a) -> bool:
    """:func:`kernel_applies`' rule on dtypes and shapes alone, on whatever
    device."""
    if not (xh.dim() == 4 and bmat.dim() == cmat.dim() == 4
            and dt.dim() == 3 and a.dim() == 1):
        return False
    b, t, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    return (xh.dtype in DTYPES and bmat.dtype == cmat.dtype == xh.dtype
            and dt.dtype == a.dtype == torch.float32
            and tuple(bmat.shape) == tuple(cmat.shape) == (b, t, g, n)
            and tuple(dt.shape) == (b, t, h) and tuple(a.shape) == (h,)
            and b >= 1 and t >= 1 and g >= 1 and h % g == 0
            and 1 <= p <= MAX_P and 1 <= n <= MAX_N)


def plan(batch: int, heads: int, groups: int, num_sms: int) -> int:
    """Heads a block takes: the fewest that leave no more blocks than the
    card has SMs (each block keeps its heads' states in shared memory,
    one block an SM), at most :data:`MAX_HEADS` and at most a group's
    heads.  At B = 4, H = 112, G = 2 on 132 SMs: 4 (112 blocks)."""
    per = heads // groups
    rows = batch * groups
    hb = 1
    while hb < min(MAX_HEADS, per) and rows * -(-per // hb) > num_sms:
        hb += 1
    return hb


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SYMBOLS = {"ssd_scan_launch": [_P] * 7 + [_I64] * 6 + [_I64] * 16
            + [_I, _I, _P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("ssd_scan", _SYMBOLS)


def ssd_scan(xh: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, state)``: the grouped SSD of a prefill from a zero state, y
    (B, T, H, P) and the state after the last position (B, H, P, N), both
    float32 and contiguous.  Raises on what :func:`kernel_applies`
    refuses."""
    if not kernel_applies(xh, bmat, cmat, dt, a):
        raise ValueError(
            f"the SSD scan kernel does not take xh {tuple(xh.shape)} "
            f"{xh.dtype} on {xh.device}, B/C {tuple(bmat.shape)} "
            f"{bmat.dtype}/{cmat.dtype}, dt {tuple(dt.shape)} {dt.dtype}, a "
            f"{tuple(a.shape)} {a.dtype} (the plain form is "
            "models.ssm.ssd_grouped)")
    b, t, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=xh.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xh.device)
    hb = plan(b, h, g, _build.num_sms(xh.device.index))
    ctx, stream = _build.device_stream(xh.device)
    with ctx:
        rc = load_library().ssd_scan_launch(
            xh.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
            a.data_ptr(), y.data_ptr(), state.data_ptr(), b, t, h, g, p, n,
            *xh.stride(), *bmat.stride(), *cmat.stride(), *dt.stride(),
            a.stride(0), DTYPES[xh.dtype], hb, stream)
    _build.count_launch(rc, "ssd_scan", launches, "ssd_scan")
    return y, state
