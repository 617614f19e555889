"""The lane-dispatch core of the serving program.

Counterpart of ``repro.kernels.fused_serve.serve_lanes``: parsed int32
feature codes and Model IDs in, int32 output codes out — Model-ID
resolution through both control-plane ``id_map`` tables (MLP slots and
forest slots, one namespace), the fused MLP kernel, the tree-ensemble
traversal kernel (pointer chase or range table) and per-model output
masking.  ``core.inference.DataPlaneEngine`` calls it for both its wire
path and its feature path, so the two cannot drift.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import forest_traverse, fused_mlp

__all__ = ["LaneConfig", "serve_lanes"]


class LaneConfig(NamedTuple):
    """Static configuration of the serving program."""

    frac: int
    sig_coeffs: tuple
    leaky_alpha_q: int
    max_features: int
    max_tree_depth: int = 6
    kernel_variant: str = "int16"   # MLP weight lane
    forest_variant: str = "chase"   # forest traversal lowering


def _resolve(id_map: torch.Tensor, model_id: torch.Tensor):
    """Model ID → (slot clamped to >= 0 as int32, resolved mask), with the
    reference's index handling: a negative id counts from the end of the
    map and an id past it clamps to the last entry."""
    n_ids = id_map.shape[0]
    idx = model_id.to(torch.int64)
    idx = torch.where(idx < 0, idx + n_ids, idx).clamp(0, n_ids - 1)
    slot = id_map[idx]
    return torch.clamp_min(slot, 0).to(torch.int32), slot >= 0


def serve_lanes(x0: torch.Tensor, model_id: torch.Tensor, tables,
                ftables, rtables, cfg: LaneConfig, *, use_mlp: bool = True,
                use_forest: bool = False) -> torch.Tensor:
    """Parsed feature codes → output codes.

    x0 (B, ≥W or <W) int32 codes at ``cfg.frac`` · model_id (B,) int32 →
    (B, min(max_features, W)) int32.  Per packet, whichever id map resolves
    the Model ID picks the egress row; unresolved ids (and dead padding
    rows, which carry Model ID 0) egress zeros; lanes at or past a model's
    ``out_dim`` egress zeros.  ``ftables``/``rtables`` (the forest node and
    range tables of one generation) are read only when ``use_forest``.
    """
    width = tables.w.shape[-1]
    if x0.shape[1] < width:
        x0 = torch.nn.functional.pad(x0, (0, width - x0.shape[1]))
    else:
        x0 = x0[:, :width]
    x0 = x0.contiguous()
    lane = torch.arange(width, device=x0.device)[None, :]

    if use_mlp:
        slot, valid = _resolve(tables.id_map, model_id)
        x = fused_mlp(x0, slot, tables.w, tables.b, tables.act,
                      tables.layer_on, frac=cfg.frac,
                      sig_coeffs=cfg.sig_coeffs,
                      leaky_alpha_q=cfg.leaky_alpha_q,
                      variant=cfg.kernel_variant)
        out_dim = tables.out_dim[slot.to(torch.int64)][:, None]
        keep = (lane < out_dim) & valid[:, None]
        outputs = torch.where(keep, x, torch.zeros_like(x))
    else:
        # lane-pure forest batch: ids not in the forest map (including
        # uninstalled ones) egress zeros, as MLP-lane invalid ids do
        outputs = torch.zeros_like(x0)

    if use_forest:
        fslot, fvalid = _resolve(ftables.id_map, model_id)
        fx = forest_traverse(x0, fslot, ftables.nodes, ftables.tree_on,
                             ftables.mode, max_depth=cfg.max_tree_depth,
                             frac=cfg.frac, variant=cfg.forest_variant,
                             ranges=rtables)
        f_out_dim = ftables.out_dim[fslot.to(torch.int64)][:, None]
        fout = torch.where(lane < f_out_dim, fx, torch.zeros_like(fx))
        outputs = torch.where(fvalid[:, None], fout, outputs)

    return outputs[:, : cfg.max_features]
