"""Wrapper of the hand-written CUDA WKV chunk-scan kernel
(``csrc/wkv_scan.cu``), the port of
``repro.kernels.wkv_scan.wkv_scan_pallas``: RWKV-6's chunked linear
recurrence in float32, with the D×D state of each (B·H) row kept on chip
across its chunks.

For tensors on the CPU it runs the plain version (``ref.wkv_scan_ref``).
For tensors on the card it launches the kernels on the current stream or
raises — there is no fallback.  Each call is two device kernels: one block
per (row, chunk) computes each chunk's own part of ``o`` and its state
increment into a (BH, NC, D, D) workspace, then one block per (row, 16
state columns) walks the chunks in order, adding a·S and carrying S.  Every
call that launches adds one to ``launches["wkv_scan"]``, whatever the
number of device kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .ref import wkv_scan_ref

__all__ = ["wkv_scan", "wkv_scan_op", "wkv_flops", "MAX_D", "MAX_C",
           "launches", "reset_launches", "load_library"]

#: the kernel's limits: head dim D ≤ MAX_D, chunk length 1 ≤ C ≤ MAX_C
MAX_D = 64
MAX_C = 256

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"wkv_scan": 0}


def reset_launches() -> None:
    launches["wkv_scan"] = 0


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SYMBOLS = {"wkv_scan_launch": [_P] * 7 + [_I64, _I64, _I, _I, _P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("wkv_scan", _SYMBOLS)


def _check_shapes(a, b, v, tot, diag) -> None:
    if a.dim() != 4:
        raise ValueError(f"a must be (BH, NC, C, D), got {tuple(a.shape)}")
    bh, nc, c, d = a.shape
    want = {"b": (b, (bh, nc, c, d)), "v": (v, (bh, nc, c, d)),
            "tot": (tot, (bh, nc, 1, d)), "diag": (diag, (bh, nc, c, 1))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if not (1 <= d <= MAX_D and 1 <= c <= MAX_C):
        raise ValueError(f"the WKV kernel takes head dim 1..{MAX_D} and chunk "
                         f"1..{MAX_C}, got D={d}, C={c}")


def wkv_scan(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
             tot: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """Chunked WKV scan: a/b/v (BH, NC, C, D), tot (BH, NC, 1, D), diag
    (BH, NC, C, 1), float32 → o (BH, NC, C, D) float32 (see
    ``ref.wkv_scan_ref`` for the recurrence)."""
    _check_shapes(a, b, v, tot, diag)
    if a.device.type == "cpu":
        return wkv_scan_ref(a, b, v, tot, diag)
    args = (a, b, v, tot, diag)
    if a.device.type != "cuda":
        raise ValueError(f"no wkv_scan kernel for device {a.device}")
    for name, t in zip(("a", "b", "v", "tot", "diag"), args):
        _build.check(name, t, torch.float32, t.shape, a.device)
    bh, nc, c, d = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    state = torch.empty((bh, nc, d, d), dtype=torch.float32, device=a.device)
    ctx, stream = _build.device_stream(a.device)
    with ctx:
        rc = load_library().wkv_scan_launch(
            *(t.data_ptr() for t in args), out.data_ptr(), state.data_ptr(),
            bh, nc, c, d, stream)
    _build.count_launch(rc, "wkv_scan", launches, "wkv_scan")
    return out


# ---------------------------------------------------------------------------
# the custom op: ``torch.ops.repro_torch.wkv_scan``
# ---------------------------------------------------------------------------


def wkv_flops(bh: int, nc: int, c: int, d: int) -> int:
    """The scan's operations (PERF.md §6's bound): per (row, chunk)
    2C(C−1)D (the strictly-causal scores and their product with v)
    + 4CD² (a·S and the state increment) + 3CD + 2D² (the diagonal bonus,
    the decay of S)."""
    return bh * nc * (2 * c * (c - 1) * d + 4 * c * d * d + 3 * c * d
                      + 2 * d * d)


@torch.library.custom_op("repro_torch::wkv_scan", mutates_args=())
def wkv_scan_op(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                tot: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """:func:`wkv_scan` as a custom op: one opaque op to dispatch modes
    and DTensor (run it on local shards), with a fake (meta) version for
    the dry run and a FLOP formula for ``torch.utils.flop_counter``."""
    return wkv_scan(a, b, v, tot, diag)


@wkv_scan_op.register_fake
def _(a, b, v, tot, diag):
    _check_shapes(a, b, v, tot, diag)
    return torch.empty_like(a)


def _register_flops() -> None:
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    packet = torch.ops.repro_torch.wkv_scan
    if packet in flop_registry:
        return

    @register_flop_formula(packet)
    def _(a_shape, *args, out_shape=None, **kwargs) -> int:
        return wkv_flops(*a_shape)


_register_flops()
