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

The range kernel groups the packets by forest itself: each block serves
:func:`plan`'s ``chunk`` packets of one forest and stages that forest's
tables in shared memory when they fit (``staged``), else reads them from
global memory; the plan depends on the sizes alone.  The chase kernel
serves one packet per warp in index order.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from . import _build
from .ref import forest_range_gather_ref, forest_traverse_gather_ref

__all__ = ["forest_traverse", "forest_range", "FOREST_VARIANTS", "MAX_WIDTH",
           "STAGE_LIMIT", "Plan", "plan", "stage_bytes", "launches",
           "reset_launches", "load_library"]

# "chase": the level-bounded pointer chase (work ∝ visited nodes, serially
# dependent steps); "range": the pForest range-table form (work ∝ all
# internal nodes, no serial chain)
FOREST_VARIANTS = ("chase", "range")
MAX_WIDTH = 128  # kMaxWidth in the CUDA source
STAGE_LIMIT = 96 * 1024  # kStageLimit: the largest staged table, bytes
_MAX_CHUNK = 4096  # keeps the grid near one block per SM up to B ≈ 540k

#: kernel launches per variant since the last :func:`reset_launches`
launches: Dict[str, int] = {v: 0 for v in FOREST_VARIANTS}


def reset_launches() -> None:
    for v in FOREST_VARIANTS:
        launches[v] = 0


class Plan(NamedTuple):
    chunk: int    # packets of one forest per block, a power of two
    staged: bool  # the forest's tables staged in shared memory


def _round4(n: int) -> int:
    return (n + 3) & ~3


def stage_bytes(n_trees: int, n_entries: int, n_leaves: int) -> int:
    """Shared memory the range kernel stages one forest's tables in: the
    copies of feat, thresh, lmask and payload, their 16-byte entry
    records and tree_on (``Layout`` in the CUDA source)."""
    tn = n_trees * n_entries
    raw = 3 * _round4(tn) + _round4(n_trees * n_leaves)
    return 4 * (_round4(n_trees) + raw + 4 * tn)


def plan(n_batch: int, n_trees: int, n_entries: int, n_leaves: int,
         num_sms: int) -> Plan:
    """The range kernel's launch plan from the sizes alone: ``chunk``, the
    power of two at or above B / SMs (about one busy block per SM: every
    block reads all of ``slot``, so the grid must not grow with B), within
    [16, 4096] (16 is one packet per warp of a block), and the tables
    staged when they fit :data:`STAGE_LIMIT`."""
    chunk = 16
    while chunk < _MAX_CHUNK and chunk * num_sms < n_batch:
        chunk *= 2
    staged = stage_bytes(n_trees, n_entries, n_leaves) <= STAGE_LIMIT
    return Plan(chunk, staged)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"forest_chase_launch": [_P] * 6 + [_I] * 7 + [_P],
            "forest_range_launch": [_P] * 9 + [_I] * 9 + [_P],
            "forest_range_prologue_launch": [_P] * 9 + [_I] * 9 + [_P],
            "forest_empty_launch": [_P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("forest_traversal", _SYMBOLS)


def _check_common(x, slot, tree_on, mode, n_forests, n_trees, frac):
    if not x.is_cuda:
        raise ValueError(f"no forest kernel for device {x.device}")
    n_batch, width = x.shape
    dev = x.device
    _build.check("x", x, torch.int32, (n_batch, width), dev)
    _build.check("slot", slot, torch.int32, (n_batch,), dev)
    _build.check("tree_on", tree_on, torch.int32, (n_forests, n_trees), dev)
    _build.check("mode", mode, torch.int32, (n_forests,), dev)
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"width {width} outside the kernel's [1, {MAX_WIDTH}]")
    if not 0 <= frac <= 30:
        raise ValueError(f"frac={frac} outside the kernel's [0, 30]")
    return n_batch, width, dev


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
    n_batch, width, dev = _check_common(x_q, slot, tree_on, mode, n_forests,
                                        n_trees, frac)
    _build.check("nodes", nodes, torch.int32, (n_forests, n_trees, n_nodes, 5),
                 dev)
    if max_depth < 0:
        raise ValueError(f"max_depth={max_depth} < 0")
    out = torch.empty_like(x_q)
    if n_batch == 0:
        return out
    ctx, stream = _build.device_stream(dev)
    with ctx:
        rc = load_library().forest_chase_launch(
            x_q.data_ptr(), slot.data_ptr(), nodes.data_ptr(),
            tree_on.data_ptr(), mode.data_ptr(), out.data_ptr(), n_batch,
            n_forests, n_trees, n_nodes, width, int(max_depth), int(frac),
            stream)
    _build.count_launch(rc, "forest chase", launches, "chase")
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
    n_batch, width, dev = _check_common(x_q, slot, tree_on, mode, n_forests,
                                        n_trees, frac)
    for name, t in (("feat", feat), ("thresh", thresh), ("lmask", lmask)):
        _build.check(name, t, torch.int32, (n_forests, n_trees, n_entries),
                     dev)
    _build.check("payload", payload, torch.int32,
                 (n_forests, n_trees, n_leaves), dev)
    if not 1 <= n_leaves <= 32:
        raise ValueError(f"{n_leaves} leaves outside the 32-bit leaf mask's "
                         "[1, 32]")
    if n_entries < 1:
        raise ValueError("the range tables need at least one entry")
    out = torch.empty_like(x_q)
    if n_batch == 0:
        return out
    chunk, staged = plan(n_batch, n_trees, n_entries, n_leaves,
                         _build.num_sms(dev.index))
    ctx, stream = _build.device_stream(dev)
    with ctx:
        rc = load_library().forest_range_launch(
            x_q.data_ptr(), slot.data_ptr(), feat.data_ptr(),
            thresh.data_ptr(), lmask.data_ptr(), payload.data_ptr(),
            tree_on.data_ptr(), mode.data_ptr(), out.data_ptr(), n_batch,
            n_forests, n_trees, n_entries, n_leaves, width, int(frac), chunk,
            int(staged), stream)
    _build.count_launch(rc, "forest range", launches, "range")
    return out
