"""Public wrappers around the kernels with backend dispatch.

Counterpart of ``repro.kernels.ops`` for the fused MLP, the forest
traversal, the flow update, the W8A8 GEMM, the Taylor activation and the
WKV chunk scan.
``backend``:

  * ``"auto"``   — the kernel wrapper: the CUDA kernel for tensors on the
                   card, its plain version (gather form) for CPU tensors;
  * ``"kernel"`` — the CUDA kernel; raises for tensors that are not on the
                   card;
  * ``"ref"``    — the masked (one-hot) plain version (the TPU kernel's
                   literal formulation) on any device — the cross-check path;
                   for the GEMM, the Taylor activation and the WKV scan,
                   whose plain versions have one form, that form.

The GEMM and the WKV scan (the kernels on the LM paths) run as custom ops
(``torch.ops.repro_torch.fixedpoint_matmul`` / ``.wkv_scan``): opaque to
DTensor, which runs them on local shards, with fake (meta) versions and
FLOP formulas for the dry run; on the card the op launches the same
kernel and counts the same launch.

Callers hand over tables exactly as the control plane stores them.
:func:`flow_update` takes the same three names with its own CPU path (see
there).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fixedpoint_matmul as fmm
from . import forest_traversal as ft
from . import ref
from . import taylor_activation as tak
from . import wkv_scan as wk
from .fixedpoint_mlp import KERNEL_VARIANTS, fixedpoint_mlp
from .flow_update import flow_update_gather, flow_update_kernel
from .forest_traversal import FOREST_VARIANTS

__all__ = ["fixedpoint_matmul", "taylor_activation", "wkv_scan", "fused_mlp",
           "forest_traverse", "flow_update", "KERNEL_VARIANTS",
           "FOREST_VARIANTS"]


def _check_backend(backend: str, x_q: torch.Tensor) -> None:
    if backend not in ("auto", "kernel", "ref"):
        raise ValueError(f"unknown backend: {backend!r}")
    if backend == "kernel" and x_q.device.type != "cuda":
        raise ValueError("backend='kernel' needs tensors on the card, got "
                         f"{x_q.device}")


def fixedpoint_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      backend: str = "auto") -> torch.Tensor:
    """W8A8 GEMM: (M, K) int8 · (K, N) int8 with per-row (M, 1) and
    per-column (1, N) float32 scales → (M, N) float32."""
    _check_backend(backend, x_codes)
    if backend == "ref":
        return ref.fixedpoint_matmul_ref(x_codes, w_codes, x_scale, w_scale)
    return fmm.fixedpoint_matmul_op(x_codes, w_codes, x_scale, w_scale)


def taylor_activation(x_q: torch.Tensor, coeffs, x_frac: int,
                      backend: str = "auto") -> torch.Tensor:
    """Integer-Horner polynomial activation on int32 codes (any shape),
    clamped to ±(2**14 - 1) first."""
    _check_backend(backend, x_q)
    if backend == "ref":
        return ref.taylor_activation_ref(
            torch.clamp(x_q, -tak.CLAMP, tak.CLAMP), coeffs, x_frac)
    return tak.taylor_activation(x_q, coeffs, x_frac)


def wkv_scan(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
             tot: torch.Tensor, diag: torch.Tensor, *,
             backend: str = "auto") -> torch.Tensor:
    """RWKV-6 chunked WKV scan, float32: a/b/v (BH, NC, C, D), tot
    (BH, NC, 1, D), diag (BH, NC, C, 1) → o (BH, NC, C, D), the state of
    each row carried across its chunks from zero.

    The scan has no backward (nor has the reference's Pallas kernel): with
    grad mode on and an input that requires grad it raises, on every
    device and backend, rather than return a result cut from the graph.
    Train through ``models.rwkv6``'s ``"chunked"`` route."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (a, b, v, tot, diag)):
        raise RuntimeError(
            "ops.wkv_scan has no backward; differentiate the RWKV-6 model "
            "through wkv='chunked' (its loss_fn's default)")
    _check_backend(backend, a)
    if backend == "ref":
        return ref.wkv_scan_ref(a, b, v, tot, diag)
    return wk.wkv_scan_op(a, b, v, tot, diag)


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
    if backend in ("auto", "kernel"):
        return fixedpoint_mlp(x_q, slot.to(torch.int32).contiguous(), w, b,
                              act, layer_on, frac=frac, sig_coeffs=sig_coeffs,
                              leaky_alpha_q=leaky_alpha_q, variant=variant)
    coeffs = tuple(int(c) for c in np.asarray(sig_coeffs).reshape(-1).tolist())
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
    if slot.dtype != torch.int32 or not slot.is_contiguous():
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


def flow_update(state, cms, slots, cells, ts, length, live, *, frac: int,
                ewma_shift: int = 3, byte_shift: int = 6,
                dur_shift: int = 10, backend: str = "auto",
                copy: bool = True, rank=None):
    """Stateful per-flow register update + feature emit for one batch of
    parsed raw headers (see ``kernels.flow_update`` for the stage's role
    and ``ref.flow_update_numpy`` for the exact semantics).  Returns
    ``(new_state, new_cms, features)``; the caller (the flow engine) owns
    the register file and feeds each batch the previous batch's state.

    ``backend``:

      * ``"auto"``   — the CUDA kernel for tensors on the card; otherwise
        the rank-round numpy lowering ``flow_update_gather`` (the flow
        engine's CPU serving path), which takes ``copy=False`` to update a
        numpy register file in place and ``rank`` to skip re-ranking;
      * ``"kernel"`` — the CUDA kernel; raises for inputs not on the card;
      * ``"ref"``    — the pure-Python oracle (tests only).

    Tensors in give tensors out, on the same device; numpy in gives numpy
    out.  The kernel and the oracle always return fresh arrays.
    """
    if backend not in ("auto", "kernel", "ref"):
        raise ValueError(f"unknown backend: {backend!r}")
    kw = dict(frac=frac, ewma_shift=ewma_shift, byte_shift=byte_shift,
              dur_shift=dur_shift)
    on_card = isinstance(state, torch.Tensor) and state.device.type == "cuda"
    if backend == "kernel" and not on_card:
        raise ValueError("backend='kernel' needs tensors on the card, got "
                         f"{getattr(state, 'device', type(state).__name__)}")
    if on_card and backend != "ref":
        return flow_update_kernel(state, cms, slots, cells, ts, length, live,
                                  **kw)
    as_tensor = isinstance(state, torch.Tensor)
    args = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            for a in (state, cms, slots, cells, ts, length, live)]
    if backend == "ref":
        out = ref.flow_update_numpy(*args, **kw)
    else:
        out = flow_update_gather(*args, copy=copy, rank=rank, **kw)
    if as_tensor:
        return tuple(torch.from_numpy(np.asarray(o)).to(state.device)
                     for o in out)
    return out
