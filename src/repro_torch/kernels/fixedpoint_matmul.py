"""Wrapper of the hand-written CUDA W8A8 GEMM (``csrc/fixedpoint_matmul.cu``),
the port of ``repro.kernels.fixedpoint_matmul.fixedpoint_matmul_pallas``:
the paper's integer datapath (C1) on Hopper's int8 tensor cores.

  x_codes (M, K) int8 · w_codes (K, N) int8 · x_scale (M, 1) float32 ·
  w_scale (1, N) float32 → (M, N) float32 = (acc · x_scale) · w_scale

For tensors on the CPU it runs the plain version
(``ref.fixedpoint_matmul_ref``).  For tensors on the card it launches a
kernel on the current stream or raises — there is no fallback.

``w_codes`` has the reference's shape and values, (K, N), in either of two
layouts: K-major (strides (1, K), as ``core.quantize`` stores weight codes)
or row-major (contiguous).  Every call runs one kernel: TMA loads of x and
of K-major w, ``wgmma`` on a persistent grid, split-K where the output tiles
leave SMs idle (:func:`plan`).  Operands TMA cannot take are copied first:

  * a row-major w, to K-major;
  * K % 16 != 0 (TMA strides are multiples of 16 bytes) or K == 0: x and w
    get zero codes appended up to the next multiple of 16 — zero codes add
    nothing to the int32 sums, so the bits stay the same;
  * an operand that does not start on a 16-byte boundary, to a fresh one.

Each copied operand adds one to ``relayouts["fixedpoint_matmul"]``.  Every
call that launches adds one to ``launches["fixedpoint_matmul"]``.
:func:`run_split` launches the kernel with a split of K chosen by the
caller, to check every split against the exact product.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .ref import fixedpoint_matmul_ref

__all__ = ["fixedpoint_matmul", "fixedpoint_matmul_op", "run_split", "plan", "launches", "relayouts",
           "reset_launches", "load_library"]

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"fixedpoint_matmul": 0}
#: weight-layout copies made before a launch
relayouts: Dict[str, int] = {"fixedpoint_matmul": 0}

TILE = 128          # the kernel's output tile and K step (bytes)
SPLIT = 4           # slices of K where split-K pays (see plan)
LONG_K_STEPS = 64   # K steps from which it pays


def reset_launches() -> None:
    launches["fixedpoint_matmul"] = 0
    relayouts["fixedpoint_matmul"] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"fixedpoint_matmul_wgmma_launch": [_P] * 7 + [_I] * 6 + [_P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("fixedpoint_matmul", _SYMBOLS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int, num_sms: int) -> int:
    """Slices of K for an (M, K) · (K, N) call on a card with ``num_sms``
    SMs: ``SPLIT`` where that many slices of every 128×128 output tile still
    fit in one wave and K is long (at least ``LONG_K_STEPS`` 128-byte
    steps), else 1.  The rule is the one measured on an H100 at the paths'
    shapes (PERF.md): split-K pays at decode-sized M on the long K (down,
    K = 8960) and nowhere else.  No slice of K is ever empty."""
    tiles = _cdiv(m, TILE) * _cdiv(n, TILE)
    long_k = _cdiv(max(k, 1), TILE) >= LONG_K_STEPS
    return SPLIT if long_k and tiles * SPLIT <= num_sms else 1


def _k_major(w: torch.Tensor) -> bool:
    """Whether a (K, N) ``w`` has strides (1, K) (size-1 dims aside)."""
    k, n = w.shape
    return (k <= 1 or w.stride(0) == 1) and (n <= 1 or w.stride(1) == k)


def _checked(x_codes, w_codes, x_scale, w_scale):
    if x_codes.device.type != "cuda":
        raise ValueError(f"no fixedpoint_matmul kernel for device "
                         f"{x_codes.device}")
    if x_codes.dim() != 2 or w_codes.dim() != 2:
        raise ValueError(f"2-D codes expected, got {tuple(x_codes.shape)} and "
                         f"{tuple(w_codes.shape)}")
    (m, k), n = x_codes.shape, w_codes.shape[1]
    dev = x_codes.device
    _build.check("x_codes", x_codes, torch.int8, (m, k), dev)
    _build.check("w_codes", w_codes, torch.int8, (k, n), dev,
                 contiguous=False)  # either layout below
    _build.check("x_scale", x_scale, torch.float32, (m, 1), dev)
    _build.check("w_scale", w_scale, torch.float32, (1, n), dev)
    if not (w_codes.is_contiguous() or _k_major(w_codes)):
        raise ValueError("w_codes must be K-major (strides (1, K)) or "
                         "row-major (contiguous)")
    return m, k, n


def _tma_operands(x_codes: torch.Tensor, w_codes: torch.Tensor):
    """``(x, w)`` as the kernel loads them: K a positive multiple of
    16 (zero codes appended), w K-major, both 16-byte aligned.  Each copied
    operand is counted in ``relayouts``."""
    k = x_codes.shape[1]
    kp = max(16, _cdiv(k, 16) * 16)
    copies = 0
    if kp != k:
        x_codes = torch.nn.functional.pad(x_codes, (0, kp - k))
        w_codes = torch.nn.functional.pad(w_codes.t(), (0, kp - k)).t()
        copies = 2
    else:
        if x_codes.data_ptr() % 16:
            x_codes = x_codes.clone()
            copies += 1
        if not _k_major(w_codes) or w_codes.data_ptr() % 16:
            w_codes = w_codes.t().clone(
                memory_format=torch.contiguous_format).t()
            copies += 1
    relayouts["fixedpoint_matmul"] += copies
    return x_codes, w_codes


def run_split(x_codes: torch.Tensor, w_codes: torch.Tensor,
              x_scale: torch.Tensor, w_scale: torch.Tensor,
              split: int) -> torch.Tensor:
    """Launch the kernel on card tensors with ``split`` slices of K
    (operands copied as :func:`fixedpoint_matmul` copies them, which
    launches it with :func:`plan`'s split).  Raises on a split that leaves
    a slice of K empty."""
    _, k, _ = _checked(x_codes, w_codes, x_scale, w_scale)
    nk = _cdiv(max(k, 1), TILE)
    kper = _cdiv(nk, split) if split >= 1 else 0
    if kper < 1 or _cdiv(nk, kper) != split:
        raise ValueError(f"the kernel takes a split that leaves no slice of "
                         f"K empty, got K={k}, split={split}")
    x_codes, w_codes = _tma_operands(x_codes, w_codes)
    return _launch(x_codes, w_codes, x_scale, w_scale, split)


# per (device, stream): int32 arrival counts of split-K tiles, zero between
# launches (the last slice of a tile to arrive resets its count)
_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}


def _arrival_counts(dev: torch.device, stream: int,
                    tiles: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
        _arrivals[key] = buf
    return buf


def _launch(x_codes, w_codes, x_scale, w_scale, split: int) -> torch.Tensor:
    (m, k), n = x_codes.shape, w_codes.shape[1]
    dev = x_codes.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    tiles = _cdiv(m, TILE) * _cdiv(n, TILE)
    ctx, stream = _build.device_stream(dev)
    part = arrivals = None
    if split > 1:  # partial sums, and each tile's count of arrivals
        part = torch.empty((split, m, n), dtype=torch.int32, device=dev)
        arrivals = _arrival_counts(dev, stream, tiles)
    with ctx:
        rc = load_library().fixedpoint_matmul_wgmma_launch(
            x_codes.data_ptr(), w_codes.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if arrivals is None else arrivals.data_ptr(), m, n, k,
            split, _cdiv(_cdiv(k, TILE), split),
            min(_build.num_sms(dev.index), tiles * split), stream)
    _build.count_launch(rc, "fixedpoint_matmul", launches,
                        "fixedpoint_matmul")
    return out


def fixedpoint_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                      x_scale: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """W8A8 GEMM with per-row / per-column scales (see the module note)."""
    if x_codes.device.type == "cpu":
        return fixedpoint_matmul_ref(x_codes, w_codes, x_scale, w_scale)
    m, k, n = _checked(x_codes, w_codes, x_scale, w_scale)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32,
                           device=x_codes.device)
    x_codes, w_codes = _tma_operands(x_codes, w_codes)
    return _launch(x_codes, w_codes, x_scale, w_scale,
                   plan(m, n, k, _build.num_sms(x_codes.device.index)))


# ---------------------------------------------------------------------------
# the custom op: ``torch.ops.repro_torch.fixedpoint_matmul``
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::fixedpoint_matmul", mutates_args=())
def fixedpoint_matmul_op(x_codes: torch.Tensor, w_codes: torch.Tensor,
                         x_scale: torch.Tensor,
                         w_scale: torch.Tensor) -> torch.Tensor:
    """:func:`fixedpoint_matmul` as a custom op: one opaque op to dispatch
    modes and DTensor (run it on local shards), with a fake (meta) version
    for the dry run and a FLOP formula (2·M·N·K) for
    ``torch.utils.flop_counter``."""
    return fixedpoint_matmul(x_codes, w_codes, x_scale, w_scale)


@fixedpoint_matmul_op.register_fake
def _(x_codes, w_codes, x_scale, w_scale):
    if x_codes.dim() != 2 or w_codes.dim() != 2 or \
            x_codes.shape[1] != w_codes.shape[0]:
        raise ValueError(f"codes of shapes {tuple(x_codes.shape)} and "
                         f"{tuple(w_codes.shape)} do not multiply")
    return x_codes.new_empty((x_codes.shape[0], w_codes.shape[1]),
                             dtype=torch.float32)


def _register_flops() -> None:
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    packet = torch.ops.repro_torch.fixedpoint_matmul
    if packet in flop_registry:
        return

    @register_flop_formula(packet)
    def _(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
        return 2 * x_shape[0] * x_shape[1] * w_shape[1]


_register_flops()
