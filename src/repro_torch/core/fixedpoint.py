"""Fixed-point arithmetic core (paper §3.1, Table 2).

A float weight ``w`` is encoded as ``w_q = round(w * 2**s) + b`` and decoded
as ``w ≈ (w_q - b) / 2**s``, where ``s`` is the scale (fractional bits) and
``b`` an integer offset.  The data plane then computes on the integer codes
only, re-scaling products with a rounding arithmetic shift.

Counterpart of ``repro.core.fixedpoint``, bit-identical on the same inputs:
encode/decode, the rounding shift and ``requantize``; :class:`QTensor`
(integer codes plus their format, a plain dataclass — PyTorch needs no
pytree); ``quantize``/``dequantize`` (per tensor or per channel); the
integer ops ``qmatmul``, ``qadd`` and ``qmul``; ``fake_quant`` with its
straight-through gradient; and ``calibrate_scale``/``choose_format``.
Three PyTorch traps are handled explicitly:

  * float → int32 casts: PyTorch wraps out-of-range values (``2**31`` becomes
    ``-2**31``) where the reference saturates, so :func:`encode` saturates
    explicitly into the storage type;
  * rounding stays float32-first (``sign·floor(|x|+0.5)`` on the float32
    product), exactly as the reference, so the codes match bit for bit;
  * PyTorch has no integer matmul on the card: :func:`qmatmul` takes the
    exact wrapped int32 accumulator of ``kernels.ref.int32_matmul``;
  * on the card, dividing by a Python (or CPU) scalar multiplies by its
    reciprocal, which can differ from a division in the last bit:
    :func:`true_divide` divides by a tensor on the operand's device, and the
    port's float code divides through it wherever the divisor is not a
    power of two.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.ref import int32_matmul

__all__ = ["FixedPointFormat", "QTensor", "true_divide", "encode", "decode",
           "quantize", "dequantize", "requantize", "qmatmul", "qadd", "qmul",
           "fake_quant", "calibrate_scale", "choose_format", "INT8", "INT16",
           "INT32"]


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """A fixed-point format ``Q(total_bits, frac_bits)`` with optional offset.

    ``frac_bits`` is the paper's ``s`` (scale exponent); ``offset`` its ``b``.
    ``total_bits`` bounds the representable integer range; codes saturate.
    """

    total_bits: int
    frac_bits: int
    offset: int = 0
    signed: bool = True

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.total_bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.total_bits - 1) - 1 if self.signed else 2 ** self.total_bits - 1

    @property
    def dtype(self) -> torch.dtype:
        if self.total_bits <= 8:
            return torch.int8
        if self.total_bits <= 16:
            return torch.int16
        return torch.int32

    def with_frac_bits(self, frac_bits: int) -> "FixedPointFormat":
        return dataclasses.replace(self, frac_bits=frac_bits)


INT8 = FixedPointFormat(total_bits=8, frac_bits=6)
INT16 = FixedPointFormat(total_bits=16, frac_bits=12)
INT32 = FixedPointFormat(total_bits=32, frac_bits=16)  # paper's s=16 (Table 4)


def true_divide(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a Python number ``b``, rounded as one IEEE division on
    every device.  PyTorch's CUDA kernel multiplies by the reciprocal of a
    Python or CPU-scalar divisor, which can differ in the last bit from the
    reference's division; a divisor tensor on ``a``'s device keeps the
    division."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def encode(w, s: int, b: int = 0, *, total_bits: int = 32,
           signed: bool = True) -> torch.Tensor:
    """``w_q = round(w * 2**s) + b`` with saturation to ``total_bits``.

    Round half away from zero on the float32 product, clip in float32 to the
    format's range, then saturate explicitly into the storage type: a clipped
    float32 ``qmax`` of a 32-bit format rounds up to ``2**31``, which the
    reference's cast saturates to ``2**31 - 1`` and a plain PyTorch cast
    would wrap (likewise an unsigned format's codes above the signed storage
    type's maximum).  NaN encodes as 0.  Returns a CPU tensor of ``fmt.dtype``.
    """
    w = torch.as_tensor(w, dtype=torch.float32)
    scaled = w * (2.0 ** s)
    rounded = torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)
    fmt = FixedPointFormat(total_bits=total_bits, frac_bits=s, offset=b,
                           signed=signed)
    q = torch.clamp(rounded + b, fmt.qmin, fmt.qmax)
    q = torch.nan_to_num(q, nan=0.0)
    info = torch.iinfo(fmt.dtype)  # the cast saturates into the storage type
    out = q.to(torch.int64)  # exact: |q| <= 2**32 after the float clip
    return torch.clamp(out, info.min, info.max).to(fmt.dtype)


def decode(w_q, s: int, b: int = 0) -> torch.Tensor:
    """``w ≈ (w_q - b) / 2**s`` — Table 2 "Decoding" row."""
    return (torch.as_tensor(w_q).to(torch.float32) - b) / (2.0 ** s)


def _rounding_shift_right(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Arithmetic right shift with round-to-nearest (ties away from zero) —
    the requantization primitive.  The rounding add wraps in ``x``'s type,
    as the reference's does; a negative ``shift`` is a left shift."""
    if shift <= 0:
        return torch.bitwise_left_shift(x, -shift) if shift < 0 else x
    rounding = torch.full_like(x, (1 << (shift - 1)) - 1) + (x >= 0).to(x.dtype)
    return torch.bitwise_right_shift(x + rounding, shift)


def requantize(acc: torch.Tensor, from_frac: int, to_frac: int,
               fmt: FixedPointFormat) -> torch.Tensor:
    """Re-scale an int32 accumulator from ``2**from_frac`` to ``2**to_frac``
    fractional bits and saturate into ``fmt``."""
    out = _rounding_shift_right(acc.to(torch.int32), from_frac - to_frac)
    out = torch.clamp(out, fmt.qmin, fmt.qmax)
    return out.to(fmt.dtype)


# ---------------------------------------------------------------------------
# QTensor — integer codes + their format
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QTensor:
    """Quantized tensor: integer codes plus (frac_bits, offset) metadata.

    ``frac_bits`` stays a scalar Python int (shift amounts are static on the
    integer path); ``channel_scale`` optionally carries a per-channel float
    multiplier along ``channel_axis`` (per-channel quantization)."""

    q: torch.Tensor  # integer codes
    frac_bits: int  # the shift amount s
    offset: int = 0  # b
    channel_scale: Optional[torch.Tensor] = None
    channel_axis: Optional[int] = None

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def dequantize(self) -> torch.Tensor:
        x = decode(self.q, self.frac_bits, self.offset)
        if self.channel_scale is not None:
            shape = [1] * x.dim()
            shape[self.channel_axis] = -1
            x = x * self.channel_scale.reshape(shape)
        return x


def quantize(x, fmt: FixedPointFormat = INT32, *,
             channel_axis: Optional[int] = None) -> QTensor:
    """Quantize a float array to a :class:`QTensor`.  With ``channel_axis``
    set, each channel is scaled so its max ``|x|`` maps to the top code and
    the float multiplier is kept in ``channel_scale``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if channel_axis is None:
        q = encode(x, fmt.frac_bits, fmt.offset, total_bits=fmt.total_bits,
                   signed=fmt.signed)
        return QTensor(q=q, frac_bits=fmt.frac_bits, offset=fmt.offset)
    axes = tuple(i for i in range(x.dim()) if i != channel_axis)
    absmax = torch.amax(torch.abs(x), dim=axes, keepdim=True)
    absmax = torch.clamp_min(absmax, 1e-12)
    q = encode(x / absmax, fmt.frac_bits, fmt.offset,
               total_bits=fmt.total_bits, signed=fmt.signed)
    return QTensor(q=q, frac_bits=fmt.frac_bits, offset=fmt.offset,
                   channel_scale=absmax.squeeze(axes).to(torch.float32),
                   channel_axis=channel_axis)


def dequantize(t: QTensor) -> torch.Tensor:
    return t.dequantize()


# ---------------------------------------------------------------------------
# Integer-domain arithmetic
# ---------------------------------------------------------------------------


def qmatmul(a: QTensor, w: QTensor, *, out_fmt: FixedPointFormat = INT32,
            bias_q: Optional[torch.Tensor] = None) -> QTensor:
    """Integer matmul ``a @ w`` with a wrapping int32 accumulator and
    requantization from ``a.frac_bits + w.frac_bits`` to
    ``out_fmt.frac_bits``.  Offsets must be zero (symmetric operands)."""
    if a.offset != 0 or w.offset != 0:
        raise ValueError("integer qmatmul requires symmetric (offset=0) operands")
    acc = int32_matmul(a.q, w.q)
    if bias_q is not None:
        acc = acc + torch.as_tensor(bias_q).to(torch.int32)
    out = requantize(acc, a.frac_bits + w.frac_bits, out_fmt.frac_bits,
                     out_fmt)
    cs = w.channel_scale
    return QTensor(q=out, frac_bits=out_fmt.frac_bits, channel_scale=cs,
                   channel_axis=(acc.dim() - 1) if cs is not None else None)


def _align(a: QTensor, b: QTensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Bring two QTensors onto a common fractional-bit grid (int32)."""
    frac = max(a.frac_bits, b.frac_bits)
    aq = torch.bitwise_left_shift(a.q.to(torch.int32), frac - a.frac_bits)
    bq = torch.bitwise_left_shift(b.q.to(torch.int32), frac - b.frac_bits)
    return aq, bq, frac


def qadd(a: QTensor, b: QTensor, *,
         out_fmt: FixedPointFormat = INT32) -> QTensor:
    aq, bq, frac = _align(a, b)
    out = requantize(aq + bq, frac, out_fmt.frac_bits, out_fmt)
    return QTensor(q=out, frac_bits=out_fmt.frac_bits)


def qmul(a: QTensor, b: QTensor, *,
         out_fmt: FixedPointFormat = INT32) -> QTensor:
    acc = a.q.to(torch.int32) * b.q.to(torch.int32)
    out = requantize(acc, a.frac_bits + b.frac_bits, out_fmt.frac_bits,
                     out_fmt)
    return QTensor(q=out, frac_bits=out_fmt.frac_bits)


# ---------------------------------------------------------------------------
# Fake quantization (QAT) and calibration
# ---------------------------------------------------------------------------


class _FakeQuant(torch.autograd.Function):
    """Snap onto the fixed-point grid; the gradient passes straight through
    where ``x · 2**frac_bits`` lies inside the code range and is zero
    outside it."""

    @staticmethod
    def forward(ctx, x, frac_bits: int, total_bits: int):
        scale = 2.0 ** frac_bits
        qmax = 2.0 ** (total_bits - 1) - 1
        xs = x * scale
        ctx.save_for_backward((xs >= -qmax - 1) & (xs <= qmax))
        return torch.clamp(torch.round(xs), -qmax - 1, qmax) / scale

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return torch.where(in_range, g, torch.zeros_like(g)), None, None


def fake_quant(x: torch.Tensor, frac_bits: int,
               total_bits: int) -> torch.Tensor:
    """Snap float values onto the fixed-point grid; straight-through
    gradient inside the representable range."""
    return _FakeQuant.apply(x, frac_bits, total_bits)


def calibrate_scale(x, total_bits: int = 8, *,
                    percentile: float = 100.0) -> int:
    """The largest ``frac_bits`` such that (a percentile of) ``|x|`` fits:
    ``s = total_bits - 1 - int_bits``.  Pure numpy, at conversion time."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if percentile >= 100.0:
        m = float(np.max(np.abs(x))) if x.size else 0.0
    else:
        m = float(np.percentile(np.abs(x), percentile)) if x.size else 0.0
    if m == 0.0:
        return total_bits - 1
    int_bits = max(0, int(np.ceil(np.log2(m + 1e-12))) + 1)
    return max(0, total_bits - 1 - int_bits)


def choose_format(x, total_bits: int = 8, **kw) -> FixedPointFormat:
    return FixedPointFormat(total_bits=total_bits,
                            frac_bits=calibrate_scale(x, total_bits, **kw))
