"""Plain PyTorch versions of the serving kernels — the integer semantics the
hand-written kernels must reproduce bit for bit, and the path a wrapper
takes for tensors on the CPU.

Counterparts of ``repro.kernels.ref`` (``rounding_rshift``, ``lane_clamp``,
``_select_activation_ref``, ``fused_mlp_ref``, ``fused_mlp_gather_ref``).
Every product and sum is int32 with two's-complement wraparound, as in the
reference: products are int32 tensor multiplies, and reductions use
``sum(..., dtype=torch.int32)`` so the accumulator wraps to int32 *before*
the rounding shift (a plain ``sum`` would promote to int64 and shift the
unwrapped value).  No integer matrix product is used, so the same code runs
on the card, where PyTorch has no int32 ``matmul``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["rounding_rshift", "lane_clamp", "fused_mlp_ref",
           "fused_mlp_gather_ref"]


def rounding_rshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Arithmetic right shift, round-to-nearest, ties away from zero (the
    requantization primitive).  The rounding add wraps in int32."""
    if shift <= 0:
        return x
    rounding = torch.full_like(x, (1 << (shift - 1)) - 1) + (x >= 0).to(x.dtype)
    return torch.bitwise_right_shift(x + rounding, shift)


def lane_clamp(x: torch.Tensor, lane_bits: Optional[int]) -> torch.Tensor:
    """Saturate codes into a ``lane_bits``-wide signed lane (the int8
    weight-lane's requantize boundary); identity when ``None``."""
    if lane_bits is None:
        return x
    hi = (1 << (lane_bits - 1)) - 1
    return torch.clamp(x, -hi - 1, hi)


def _select_activation_ref(y: torch.Tensor, opcode: torch.Tensor, *,
                           frac: int, sig_coeffs: Sequence[int],
                           leaky_alpha_q: int) -> torch.Tensor:
    """Opcode-gated integer activation: 1 relu, 2 Taylor sigmoid (Horner
    over ``clip(y, ±2**14)``), 3 leaky relu, 4 hard sigmoid; any other
    opcode is the identity.  ``opcode`` broadcasts against ``y``."""
    relu = torch.clamp_min(y, 0)
    leaky = torch.where(y > 0, y, rounding_rshift(y * int(leaky_alpha_q), frac))
    xc = torch.clamp(y, -(1 << 14), 1 << 14)
    coeffs = [int(c) for c in sig_coeffs]
    sig = torch.full_like(y, coeffs[-1])
    for c in coeffs[-2::-1]:
        sig = rounding_rshift(sig * xc, frac) + c
    hsig = torch.clamp(rounding_rshift(y, 2) + (1 << (frac - 1)), 0, 1 << frac)
    out = y
    out = torch.where(opcode == 1, relu, out)
    out = torch.where(opcode == 2, sig, out)
    out = torch.where(opcode == 3, leaky, out)
    out = torch.where(opcode == 4, hsig, out)
    return out


def fused_mlp_ref(x_q: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, act: torch.Tensor, layer_on: torch.Tensor,
                  *, frac: int, sig_coeffs, leaky_alpha_q: int,
                  lane_bits: Optional[int] = None) -> torch.Tensor:
    """The masked-GEMM form of the fused multi-model MLP (the literal
    formulation of the TPU kernel).  Layer-major operands: x_q (B, W) int32;
    slot (B, 1) int32; w (L, M·W, W); b (L, M, W) int32; act/layer_on
    (L, M, 1) int32.  A slot outside ``[0, M)`` selects no model: every
    layer is off and the row returns its (lane-clamped) input."""
    n_batch, width = x_q.shape
    n_layers, mw, _ = w.shape
    n_models = mw // width
    m_iota = torch.arange(n_models, dtype=torch.int32, device=x_q.device)
    onehot = (slot == m_iota[None, :]).to(torch.int32)  # (B, M)
    x = lane_clamp(x_q, lane_bits)
    for l in range(n_layers):
        z = (onehot[:, :, None] * x[:, None, :]).reshape(n_batch, mw)
        acc = (z[:, :, None] * w[l].to(torch.int32)[None]).sum(
            1, dtype=torch.int32)
        acc = acc + (onehot[:, :, None] * b[l][None]).sum(1, dtype=torch.int32)
        y = rounding_rshift(acc, frac)
        opcode = (onehot * act[l][:, 0][None]).sum(1, dtype=torch.int32)
        y = _select_activation_ref(y, opcode[:, None], frac=frac,
                                   sig_coeffs=sig_coeffs,
                                   leaky_alpha_q=leaky_alpha_q)
        y = lane_clamp(y, lane_bits)
        on = (onehot * layer_on[l][:, 0][None]).sum(1, dtype=torch.int32) > 0
        x = torch.where(on[:, None], y, x)
    return x


def fused_mlp_gather_ref(x_q: torch.Tensor, slot: torch.Tensor,
                         w: torch.Tensor, b: torch.Tensor, act: torch.Tensor,
                         layer_on: torch.Tensor, *, frac: int, sig_coeffs,
                         leaky_alpha_q: int,
                         lane_bits: Optional[int] = None) -> torch.Tensor:
    """The gather form, on the control plane's own layout: each packet's
    layer is gathered by slot and applied as an int32 batched matvec.
    x_q (B, W) int32 · slot (B,) in ``[0, M)`` · w (M, L, W, W) · b (M, L, W)
    · act/layer_on (M, L) → (B, W) int32.  Bit-identical to
    :func:`fused_mlp_ref` for valid slots."""
    slot = slot.to(torch.int64)
    n_layers = w.shape[1]
    x = lane_clamp(x_q, lane_bits)
    for l in range(n_layers):
        wl = w[slot, l].to(torch.int32)  # (B, W, W)
        acc = (x[:, :, None] * wl).sum(1, dtype=torch.int32) + b[slot, l]
        y = rounding_rshift(acc, frac)
        y = _select_activation_ref(y, act[slot, l][:, None], frac=frac,
                                   sig_coeffs=sig_coeffs,
                                   leaky_alpha_q=leaky_alpha_q)
        y = lane_clamp(y, lane_bits)
        x = torch.where(layer_on[slot, l][:, None] > 0, y, x)
    return x
