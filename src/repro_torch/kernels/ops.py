"""Public wrappers around the serving kernels with backend dispatch.

Counterpart of ``repro.kernels.ops`` for the fused MLP and the forest
traversal.  ``backend``:

  * ``"auto"``   — the kernel wrapper: the CUDA kernel for tensors on the
                   card, its plain version (gather form) for CPU tensors;
  * ``"kernel"`` — the CUDA kernel; raises for tensors that are not on the
                   card;
  * ``"ref"``    — the masked (one-hot) plain version (the TPU kernel's
                   literal formulation) on any device — the cross-check path.

Callers hand over tables exactly as the control plane stores them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import forest_traversal as ft
from . import ref
from .fixedpoint_mlp import KERNEL_VARIANTS, fixedpoint_mlp
from .forest_traversal import FOREST_VARIANTS

__all__ = ["fused_mlp", "forest_traverse", "KERNEL_VARIANTS",
           "FOREST_VARIANTS"]


def _check_backend(backend: str, x_q: torch.Tensor) -> None:
    if backend not in ("auto", "kernel", "ref"):
        raise ValueError(f"unknown backend: {backend!r}")
    if backend == "kernel" and x_q.device.type != "cuda":
        raise ValueError("backend='kernel' needs tensors on the card, got "
                         f"{x_q.device}")


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
    _check_backend(backend, x_q)
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown kernel variant: {variant!r}")
    coeffs = tuple(int(c) for c in np.asarray(sig_coeffs).reshape(-1).tolist())
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


def forest_traverse(x_q: torch.Tensor, slot: torch.Tensor,
                    nodes: torch.Tensor, tree_on: torch.Tensor,
                    mode: torch.Tensor, *, max_depth: int, frac: int,
                    backend: str = "auto", variant: str = "chase",
                    ranges=None) -> torch.Tensor:
    """Fused multi-forest traversal over the stacked control-plane tables:
    x_q (B, W) int32 · slot (B,) int32 · nodes (F, T, N, 5) int32 ·
    tree_on (F, T) · mode (F,) → (B, W) int32 output codes
    (``ref.FOREST_REGRESS``: lane 0 = Σ leaf codes; ``FOREST_CLASSIFY``:
    lane c = ``1 << frac`` per tree voting class c).

    ``variant="chase"`` is the level-bounded pointer chase over ``nodes``;
    ``"range"`` is the range-table form over ``ranges`` — a ``(feat,
    thresh, lmask, payload)`` tuple or a ``control_plane.RangeTables``
    (``nodes`` is then not read).  Both kernels take these layouts as they
    are; only ``backend="ref"`` relays them out into the TPU kernel's
    tree-major operands for the masked forms.
    """
    _check_backend(backend, x_q)
    if variant not in FOREST_VARIANTS:
        raise ValueError(f"unknown forest variant: {variant!r}")
    slot = slot.to(torch.int32).contiguous()
    if variant == "range":
        if ranges is None:
            raise ValueError("variant='range' needs the compiled range "
                             "tables (ControlPlane.range_tables())")
        feat, thresh, lmask, payload = (
            (ranges.feat, ranges.thresh, ranges.lmask, ranges.payload)
            if hasattr(ranges, "lmask") else ranges)
        if backend != "ref":
            return ft.forest_range(x_q, slot, feat, thresh, lmask, payload,
                                   tree_on, mode, frac=frac)
        # tree-major field-major columns: feat | thresh | mask | payload
        rng_t = torch.cat([a.to(torch.int32).permute(1, 0, 2)
                           for a in (feat, thresh, lmask, payload)], dim=2)
        return ref.forest_range_ref(
            x_q, slot[:, None], rng_t, _tree_major(tree_on),
            mode.to(torch.int32)[:, None], n_entries=feat.shape[-1],
            n_leaves=payload.shape[-1], frac=frac)
    if backend != "ref":
        return ft.forest_traverse(x_q, slot, nodes, tree_on, mode,
                                  max_depth=max_depth, frac=frac)
    # nodes_t[t, f, field*N + n] == nodes[f, t, n, field]
    n_forests, n_trees, n_nodes, _ = nodes.shape
    nodes_t = nodes.permute(1, 0, 3, 2).to(torch.int32).reshape(
        n_trees, n_forests, 5 * n_nodes)
    return ref.forest_traverse_ref(
        x_q, slot[:, None], nodes_t, _tree_major(tree_on),
        mode.to(torch.int32)[:, None], max_depth=max_depth, frac=frac)


def _tree_major(tree_on: torch.Tensor) -> torch.Tensor:
    """(F, T) → (T, F, 1) int32, the masked forms' liveness operand."""
    return tree_on.t().to(torch.int32)[:, :, None]
