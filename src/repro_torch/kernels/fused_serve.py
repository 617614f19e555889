"""The lane-dispatch core of the serving program.

Counterpart of ``repro.kernels.fused_serve.serve_lanes`` (MLP half): parsed
int32 feature codes and Model IDs in, int32 output codes out — Model-ID
resolution through the control plane's ``id_map``, the fused MLP kernel,
and per-model output masking.  ``core.inference.DataPlaneEngine`` calls it
for both its wire path and its feature path, so the two cannot drift.  The
forest lane arrives with its own slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import fused_mlp

__all__ = ["LaneConfig", "serve_lanes"]


class LaneConfig(NamedTuple):
    """Static configuration of the serving program."""

    frac: int
    sig_coeffs: tuple
    leaky_alpha_q: int
    max_features: int
    kernel_variant: str = "int16"   # MLP weight lane


def serve_lanes(x0: torch.Tensor, model_id: torch.Tensor, tables,
                cfg: LaneConfig, *, use_mlp: bool = True,
                use_forest: bool = False) -> torch.Tensor:
    """Parsed feature codes → output codes.

    x0 (B, ≥W or <W) int32 codes at ``cfg.frac`` · model_id (B,) int32 →
    (B, min(max_features, W)) int32.  Ids the ``id_map`` does not resolve
    (and dead padding rows, which carry Model ID 0) egress zeros; lanes at
    or past a model's ``out_dim`` egress zeros.
    """
    if use_forest:
        raise NotImplementedError("the forest lane is not ported yet")
    width = tables.w.shape[-1]
    if x0.shape[1] < width:
        x0 = torch.nn.functional.pad(x0, (0, width - x0.shape[1]))
    else:
        x0 = x0[:, :width]
    x0 = x0.contiguous()
    if not use_mlp:
        return torch.zeros_like(x0)[:, : cfg.max_features]
    n_ids = tables.id_map.shape[0]
    idx = model_id.to(torch.int64)
    idx = torch.where(idx < 0, idx + n_ids, idx).clamp(0, n_ids - 1)
    slot = tables.id_map[idx]  # (B,) — mixed models
    valid = slot >= 0
    slot = torch.clamp_min(slot, 0).to(torch.int32)
    x = fused_mlp(x0, slot, tables.w, tables.b, tables.act, tables.layer_on,
                  frac=cfg.frac, sig_coeffs=cfg.sig_coeffs,
                  leaky_alpha_q=cfg.leaky_alpha_q, variant=cfg.kernel_variant)
    lane = torch.arange(width, device=x0.device)[None, :]
    out_dim = tables.out_dim[slot.to(torch.int64)][:, None]
    keep = (lane < out_dim) & valid[:, None]
    outputs = torch.where(keep, x, torch.zeros_like(x))
    return outputs[:, : cfg.max_features]
