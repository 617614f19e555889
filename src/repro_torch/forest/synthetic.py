"""Random forest tables, for holding the traversal kernels against their
plain versions.

Counterpart of the table generators in the reference's forest tests: binary
trees grown level by level within a depth bound, leaves self-looping,
mixed classify/regress forests and ragged tree counts, plus their
range-table compilation stacked into the control plane's layout; and
tables that ``install_forest`` rejects, on which the kernels must still
match the masked plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..kernels.ref import FOREST_CLASSIFY
from .ranges import pack_forest_ranges

__all__ = ["random_nodes", "random_forest_tables", "stack_ranges",
           "rejected_tables"]


def random_nodes(rng: np.random.Generator, n_trees: int, n_nodes: int,
                 width: int, depth: int, mode: int,
                 out_dim: int) -> np.ndarray:
    """Random valid packed node tables ``(n_trees, n_nodes, 5)`` for one
    forest: splits on features ``[0, width)`` at thresholds in
    ``[-800, 800)``, classify leaves in ``[0, out_dim)``, regress leaves in
    ``[-1500, 1500)``."""
    nodes = np.zeros((n_trees, n_nodes, 5), np.int32)
    for t in range(n_trees):
        is_leaf = np.ones(n_nodes, bool)
        left = np.arange(n_nodes, dtype=np.int64)
        right = np.arange(n_nodes, dtype=np.int64)
        nxt, queue = 1, [(0, 0)]
        n_splits = int(rng.integers(0, n_nodes // 2 + 1))
        done = 0
        while queue and done < n_splits and nxt + 1 < n_nodes:
            i, d = queue.pop(0)
            if d >= depth:
                continue
            is_leaf[i] = False
            left[i], right[i] = nxt, nxt + 1
            queue += [(nxt, d + 1), (nxt + 1, d + 1)]
            nxt += 2
            done += 1
        internal = ~is_leaf
        nodes[t, internal, 0] = rng.integers(0, width, internal.sum())
        nodes[t, internal, 1] = rng.integers(-800, 800, internal.sum())
        nodes[t, :, 2] = left
        nodes[t, :, 3] = right
        if mode == FOREST_CLASSIFY:
            leaf_vals = rng.integers(0, out_dim, n_nodes)
        else:
            leaf_vals = rng.integers(-1500, 1500, n_nodes)
        nodes[t, is_leaf, 4] = leaf_vals[is_leaf]
    return nodes


def random_forest_tables(rng: np.random.Generator, n_forests: int,
                         width: int, depth: int, *,
                         n_trees: Optional[int] = None,
                         n_nodes: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacked ``(F, T, N, 5)`` node tables with ``tree_on`` (F, T) and
    ``mode`` (F,): mixed classify/regress forests, each with a random
    number of live trees.  ``T`` and ``N`` are drawn (1–4 trees, 2–16
    nodes) unless given."""
    if n_trees is None:
        n_trees = int(rng.integers(1, 5))
    if n_nodes is None:
        n_nodes = int(rng.integers(2, 17))
    nodes = np.zeros((n_forests, n_trees, n_nodes, 5), np.int32)
    tree_on = np.zeros((n_forests, n_trees), np.int32)
    mode = rng.integers(0, 2, n_forests).astype(np.int32)
    for f in range(n_forests):
        out_dim = int(rng.integers(2, width + 1))
        nodes[f] = random_nodes(rng, n_trees, n_nodes, width, depth,
                                int(mode[f]), out_dim)
        tree_on[f, : int(rng.integers(1, n_trees + 1))] = 1
    return nodes, tree_on, mode


def stack_ranges(nodes: np.ndarray, tree_on: np.ndarray, depth: int, *,
                 n_entries: Optional[int] = None,
                 n_leaves: Optional[int] = None):
    """Compile every forest of ``nodes`` to range tables and pad them to
    common extents (at least ``n_entries`` / ``n_leaves`` when given), in
    the layout ``ControlPlane.range_tables()`` publishes.  Returns
    ``(feat, thresh, lmask, payload)`` with ``lmask`` as int32 bit
    patterns."""
    packs = [pack_forest_ranges(nodes[f], tree_on[f], max_depth=depth)
             for f in range(nodes.shape[0])]
    ni = max([p.feat.shape[1] for p in packs] + [n_entries or 1])
    nl = max([p.payload.shape[1] for p in packs] + [n_leaves or 1])
    n_forests, n_trees = nodes.shape[0], nodes.shape[1]
    feat = np.zeros((n_forests, n_trees, ni), np.int32)
    thresh = np.full((n_forests, n_trees, ni), np.iinfo(np.int32).max,
                     np.int32)
    lmask = np.zeros((n_forests, n_trees, ni), np.int32)
    payload = np.zeros((n_forests, n_trees, nl), np.int32)
    for f, p in enumerate(packs):
        feat[f, :, : p.feat.shape[1]] = p.feat
        thresh[f, :, : p.thresh.shape[1]] = p.thresh
        lmask[f, :, : p.lmask.shape[1]] = p.lmask
        payload[f, :, : p.payload.shape[1]] = p.payload
    return feat, thresh, lmask, payload


def rejected_tables(rng: np.random.Generator, n_forests: int, n_trees: int,
                    n_nodes: int, width: int, depth: int, n_entries: int,
                    n_leaves: int):
    """Tables that ``install_forest`` rejects: node indices outside
    ``[0, N)``, features outside ``[0, W)``, classify leaves outside
    ``[0, W)``, and range entries whose masks AND to 0 or leave only bits at
    or above ``L``.  Returns ``(nodes, tree_on, mode, (feat, thresh, lmask,
    payload))``; callers add slots outside ``[0, F)`` themselves."""
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    flat = nodes.reshape(-1, 5)
    pick = rng.random(flat.shape[0])
    bad_kid = pick < 0.15
    flat[bad_kid, 2] = rng.integers(-5, n_nodes + 8, int(bad_kid.sum()))
    bad_feat = pick > 0.85
    flat[bad_feat, 0] = rng.integers(-4, 2 * width, int(bad_feat.sum()))
    flat[(pick > 0.4) & (pick < 0.5), 4] = -3
    flat[(pick > 0.5) & (pick < 0.6), 4] = width + 2
    shape = (n_forests, n_trees, n_entries)
    feat = rng.integers(-2, width + 3, shape)
    thresh = rng.integers(-600, 600, shape)
    i32 = np.iinfo(np.int32)
    lmask = rng.integers(i32.min, i32.max, shape, endpoint=True
                         ).astype(np.int32)
    lmask[:, :, 0] &= ~np.int32((1 << min(n_leaves, 31)) - 1)
    payload = rng.integers(-4, width + 4, (n_forests, n_trees, n_leaves))
    return nodes, tree_on, mode, tuple(
        np.asarray(a, np.int32) for a in (feat, thresh, lmask, payload))
