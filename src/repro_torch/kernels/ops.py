"""Public wrappers around the serving kernels with backend dispatch.

Counterpart of ``repro.kernels.ops`` for the fused MLP.  ``backend``:

  * ``"auto"``   — the kernel wrapper: the CUDA kernel for tensors on the
                   card, its plain version (gather form) for CPU tensors;
  * ``"kernel"`` — the CUDA kernel; raises for tensors that are not on the
                   card;
  * ``"ref"``    — the masked-GEMM plain version (the TPU kernel's literal
                   formulation) on any device — the cross-check path.

Callers hand over tables exactly as the control plane stores them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ref
from .fixedpoint_mlp import KERNEL_VARIANTS, fixedpoint_mlp

__all__ = ["fused_mlp", "KERNEL_VARIANTS"]


def fused_mlp(x_q: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor, act: torch.Tensor, layer_on: torch.Tensor, *,
              frac: int, sig_coeffs, leaky_alpha_q: int,
              backend: str = "auto", variant: str = "int16") -> torch.Tensor:
    """Fused multi-model fixed-point MLP over the stacked control-plane
    tables: x_q (B, W) int32 · slot (B,) int32 · w (M, L, W, W) ·
    b (M, L, W) · act/layer_on (M, L) → (B, W) int32 output codes.

    ``variant`` selects the weight lane: ``"int16"`` (int32 arithmetic on
    any weight codes) or ``"int8"`` (codes saturated into int8 at entry and
    after every layer; weights must be int8 codes).
    """
    if backend not in ("auto", "kernel", "ref"):
        raise ValueError(f"unknown backend: {backend!r}")
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown kernel variant: {variant!r}")
    coeffs = tuple(int(c) for c in np.asarray(sig_coeffs).reshape(-1).tolist())
    if backend == "kernel" and x_q.device.type != "cuda":
        raise ValueError("backend='kernel' needs tensors on the card, got "
                         f"{x_q.device}")
    if backend in ("auto", "kernel"):
        return fixedpoint_mlp(x_q, slot.to(torch.int32).contiguous(), w, b,
                              act, layer_on, frac=frac, sig_coeffs=coeffs,
                              leaky_alpha_q=leaky_alpha_q, variant=variant)
    # backend == "ref": layer-major stacked operands, masked-GEMM form
    n_batch, width = x_q.shape
    n_models, n_layers = act.shape
    wl = w.permute(1, 0, 2, 3).to(torch.int32).reshape(
        n_layers, n_models * width, width)
    bl = b.permute(1, 0, 2).to(torch.int32)
    al = act.t().to(torch.int32)[:, :, None]
    onl = layer_on.t().to(torch.int32)[:, :, None]
    return ref.fused_mlp_ref(x_q, slot.to(torch.int32)[:, None], wl, bl, al,
                             onl, frac=frac, sig_coeffs=coeffs,
                             leaky_alpha_q=leaky_alpha_q,
                             lane_bits=8 if variant == "int8" else None)
