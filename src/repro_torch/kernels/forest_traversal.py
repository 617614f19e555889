"""Wrappers of the hand-written CUDA tree-ensemble traversal kernels
(``csrc/forest_traversal.cu``), the ports of
``repro.kernels.forest_traversal.forest_traverse_pallas`` (``"chase"``) and
``forest_range_pallas`` (``"range"``).

Both take the control plane's own table layout:

  chase: x_q (B, W) int32 · slot (B,) int32 · nodes (F, T, N, 5) int32 ·
         tree_on (F, T) int32 · mode (F,) int32 → (B, W) int32
  range: x_q · slot · feat, thresh, lmask (F, T, NI) int32 (lmask as
         ``uint32`` bit patterns) · payload (F, T, L) int32, L <= 32 ·
         tree_on · mode → (B, W) int32

For tensors on the CPU they run the plain version
(``ref.forest_traverse_gather_ref`` / ``ref.forest_range_gather_ref``).
For tensors on the card they launch the kernel on the current stream or
raise — there is no fallback.  Every launch adds one to
``launches[variant]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build
from .ref import forest_range_gather_ref, forest_traverse_gather_ref

__all__ = ["forest_traverse", "forest_range", "FOREST_VARIANTS", "MAX_WIDTH",
           "launches", "reset_launches", "load_library"]

# "chase": the level-bounded pointer chase (work ∝ visited nodes, serially
# dependent steps); "range": the pForest range-table form (work ∝ all
# internal nodes, no serial chain)
FOREST_VARIANTS = ("chase", "range")
MAX_WIDTH = 128  # kMaxWidth in the CUDA source

#: kernel launches per variant since the last :func:`reset_launches`
launches: Dict[str, int] = {v: 0 for v in FOREST_VARIANTS}


def reset_launches() -> None:
    for v in FOREST_VARIANTS:
        launches[v] = 0


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("forest_traversal")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
            (lib.forest_chase_launch, [p] * 6 + [i] * 7 + [p]),
            (lib.forest_range_launch, [p] * 9 + [i] * 7 + [p])):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(x, slot, tree_on, mode, n_forests, n_trees, frac):
    if x.device.type != "cuda":
        raise ValueError(f"no forest kernel for device {x.device}")
    n_batch, width = x.shape
    dev = x.device
    _check("x", x, (n_batch, width), dev)
    _check("slot", slot, (n_batch,), dev)
    _check("tree_on", tree_on, (n_forests, n_trees), dev)
    _check("mode", mode, (n_forests,), dev)
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"width {width} outside the kernel's [1, {MAX_WIDTH}]")
    if not 0 <= frac <= 30:
        raise ValueError(f"frac={frac} outside the kernel's [0, 30]")
    return n_batch, width


def _finish(rc: int, variant: str) -> None:
    if rc != 0:
        raise RuntimeError(f"forest {variant} launch failed: CUDA error {rc}")
    launches[variant] += 1


def forest_traverse(x_q: torch.Tensor, slot: torch.Tensor,
                    nodes: torch.Tensor, tree_on: torch.Tensor,
                    mode: torch.Tensor, *, max_depth: int,
                    frac: int) -> torch.Tensor:
    """Pointer-chase traversal over the stacked node tables (see the module
    note); ``max_depth`` steps per tree."""
    if x_q.device.type == "cpu":
        return forest_traverse_gather_ref(x_q, slot, nodes, tree_on, mode,
                                          max_depth=max_depth, frac=frac)
    n_forests, n_trees, n_nodes, _ = nodes.shape
    n_batch, width = _check_common(x_q, slot, tree_on, mode, n_forests,
                                   n_trees, frac)
    _check("nodes", nodes, (n_forests, n_trees, n_nodes, 5), x_q.device)
    if max_depth < 0:
        raise ValueError(f"max_depth={max_depth} < 0")
    out = torch.empty_like(x_q)
    if n_batch == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        rc = lib.forest_chase_launch(
            x_q.data_ptr(), slot.data_ptr(), nodes.data_ptr(),
            tree_on.data_ptr(), mode.data_ptr(), out.data_ptr(), n_batch,
            n_forests, n_trees, n_nodes, width, int(max_depth), int(frac),
            stream)
    _finish(rc, "chase")
    return out


def forest_range(x_q: torch.Tensor, slot: torch.Tensor, feat: torch.Tensor,
                 thresh: torch.Tensor, lmask: torch.Tensor,
                 payload: torch.Tensor, tree_on: torch.Tensor,
                 mode: torch.Tensor, *, frac: int) -> torch.Tensor:
    """Range-table traversal over the stacked range tables (see the module
    note)."""
    if x_q.device.type == "cpu":
        return forest_range_gather_ref(x_q, slot, feat, thresh, lmask,
                                       payload, tree_on, mode, frac=frac)
    n_forests, n_trees, n_entries = feat.shape
    n_leaves = payload.shape[-1]
    n_batch, width = _check_common(x_q, slot, tree_on, mode, n_forests,
                                   n_trees, frac)
    dev = x_q.device
    for name, t in (("feat", feat), ("thresh", thresh), ("lmask", lmask)):
        _check(name, t, (n_forests, n_trees, n_entries), dev)
    _check("payload", payload, (n_forests, n_trees, n_leaves), dev)
    if not 1 <= n_leaves <= 32:
        raise ValueError(f"{n_leaves} leaves outside the 32-bit leaf mask's "
                         "[1, 32]")
    if n_entries < 1:
        raise ValueError("the range tables need at least one entry")
    out = torch.empty_like(x_q)
    if n_batch == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.forest_range_launch(
            x_q.data_ptr(), slot.data_ptr(), feat.data_ptr(),
            thresh.data_ptr(), lmask.data_ptr(), payload.data_ptr(),
            tree_on.data_ptr(), mode.data_ptr(), out.data_ptr(), n_batch,
            n_forests, n_trees, n_entries, n_leaves, width, int(frac), stream)
    _finish(rc, "range")
    return out
