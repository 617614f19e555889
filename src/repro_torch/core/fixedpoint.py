"""Fixed-point arithmetic core (paper §3.1, Table 2), integer subset.

A float weight ``w`` is encoded as ``w_q = round(w * 2**s) + b`` and decoded
as ``w ≈ (w_q - b) / 2**s``, where ``s`` is the scale (fractional bits) and
``b`` an integer offset.  The data plane then computes on the integer codes
only, re-scaling products with a rounding arithmetic shift.

Counterpart of ``repro.core.fixedpoint`` (encode/decode, the rounding shift
and ``requantize``), bit-identical on the same inputs.  Two PyTorch traps
are handled explicitly:

  * float → int32 casts: PyTorch wraps out-of-range values (``2**31`` becomes
    ``-2**31``) where the reference saturates, so :func:`encode` saturates
    explicitly into the storage type;
  * rounding stays float32-first (``sign·floor(|x|+0.5)`` on the float32
    product), exactly as the reference, so the codes match bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["FixedPointFormat", "encode", "decode", "requantize"]


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
