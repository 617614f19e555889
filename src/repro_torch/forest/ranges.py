"""Range-table compilation of tree ensembles (the pForest ternary-match
lowering).

Counterpart of ``repro.forest.ranges``, with the same walk validation and
the same error messages.  Every internal node ``(feature, threshold)``
becomes one range-table entry carrying a *leaf mask*: the leaves still
reachable when ``x[feature] <= threshold`` fails (the left subtree's
leaves dropped).  Evaluation ANDs the masks of every failed comparison and
the exit leaf is the lowest set bit (leaves numbered in order, left to
right).  Thresholds are the packed tables' own int32 codes, so the range
form reproduces the pointer chase bit for bit on every well-formed tree.

The leaf masks are stored as **int32 bit patterns** (the reference stores
``uint32``): PyTorch has no ``uint32`` arithmetic on the CPU, and ``&``,
``~``, ``+``, ``-`` and ``(x >> k) & 1`` for ``k < 32`` give the same bits
on int32.  ``np.uint32`` masks convert with ``.view(np.int32)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RangePacked", "pack_forest_ranges", "range_bounds"]

_INT32_MAX = np.int32(np.iinfo(np.int32).max)


def range_bounds(max_nodes: int):
    """Static range-table extents for a ``max_nodes`` node budget: a proper
    binary tree with ``i`` internal nodes has ``i + 1`` leaves, so
    ``n = 2i + 1 <= max_nodes`` bounds both.  Returns
    ``(max_internal, max_leaves)``."""
    max_internal = max(0, (int(max_nodes) - 1) // 2)
    return max_internal, max_internal + 1


@dataclasses.dataclass(frozen=True)
class RangePacked:
    """Range-table form of one ensemble, padded to ``(n_trees, NI)`` /
    ``(n_trees, L)`` extents.  Padded entries carry ``thresh = INT32_MAX``
    so their comparison always holds and the mask is never applied."""

    feat: np.ndarray     # (T, NI) int32 feature index per entry
    thresh: np.ndarray   # (T, NI) int32 quantized threshold code
    lmask: np.ndarray    # (T, NI) int32 bit pattern of the surviving-leaf mask
    payload: np.ndarray  # (T, L) int32 leaf payload codes
    depth: int           # max root->leaf edges seen during the walk


def _compile_tree(nodes: np.ndarray, *, max_depth: int):
    """Walk one packed tree (``(N, 5)`` rows, leaves self-looping) and return
    ``(entries, payloads, depth)``, ``entries`` a list of ``(feature,
    threshold, surviving_mask)``.  Raises ``ValueError`` on any structure
    the level-bounded traversal could not have served."""
    n_nodes = nodes.shape[0]
    leaves: list = []       # in-order leaf node ids
    internal: list = []     # (node id, depth) in walk order
    seen = set()

    # iterative in-order walk (max_nodes is a table bound, not a Python
    # recursion bound)
    stack = [(0, 0)]
    depth_max = 0
    while stack:
        node, depth = stack.pop()
        if node in seen:
            raise ValueError(
                f"node {node} reachable twice — child pointers do not form "
                "a tree; the range compilation (and the pointer chase's "
                "self-loop contract) require a proper binary tree")
        if not 0 <= node < n_nodes:
            raise ValueError(f"child pointer {node} outside [0, {n_nodes})")
        seen.add(node)
        depth_max = max(depth_max, depth)
        left, right = int(nodes[node, 2]), int(nodes[node, 3])
        if left == node and right == node:   # leaf (self-loop)
            if len(leaves) >= 32:
                raise ValueError(
                    "tree has more than 32 leaves — beyond the range "
                    "lane's 32-bit leaf mask (raise max_nodes past 64 only "
                    "for the pointer-chase lane)")
            leaves.append(node)
            continue
        if left == node or right == node:
            raise ValueError(
                f"node {node} half-self-loops — neither leaf nor split")
        if depth + 1 > max_depth:
            raise ValueError(
                f"tree depth exceeds the unroll bound {max_depth}")
        internal.append((node, depth))
        stack.append((right, depth + 1))   # pushed first → popped second:
        stack.append((left, depth + 1))    # left subtree walks first

    # per internal node, the leaf set under its left subtree (in-order
    # numbering makes every subtree's leaf set a contiguous bit run)
    leaf_idx = {n: i for i, n in enumerate(leaves)}

    def subtree_mask(node: int) -> int:
        left, right = int(nodes[node, 2]), int(nodes[node, 3])
        if left == node:
            return 1 << leaf_idx[node]
        return subtree_mask(left) | subtree_mask(right)

    full = (1 << len(leaves)) - 1
    entries = []
    for node, _ in internal:
        drop = subtree_mask(int(nodes[node, 2]))
        entries.append((int(nodes[node, 0]), int(nodes[node, 1]),
                        (full & ~drop) & 0xFFFFFFFF))
    payloads = [int(nodes[n, 4]) for n in leaves]
    return entries, payloads, depth_max


def pack_forest_ranges(nodes: np.ndarray, tree_on: np.ndarray, *,
                       max_depth: int) -> RangePacked:
    """Compile one packed ensemble's node tables ``(T, N, 5)`` into range
    tables.  Dead trees (``tree_on == 0``) stay all padding; the data
    plane's ``tree_on`` gate is the only liveness authority."""
    nodes = np.asarray(nodes, np.int32)
    tree_on = np.asarray(tree_on)
    n_trees = nodes.shape[0]
    compiled = []
    depth = 0
    for t in range(n_trees):
        if not tree_on[t]:
            compiled.append(([], [0], 0))
            continue
        entries, payloads, d = _compile_tree(nodes[t], max_depth=max_depth)
        depth = max(depth, d)
        compiled.append((entries, payloads, d))
    ni = max(1, max(len(e) for e, _, _ in compiled))
    nl = max(1, max(len(p) for _, p, _ in compiled))
    feat = np.zeros((n_trees, ni), np.int32)
    thresh = np.full((n_trees, ni), _INT32_MAX, np.int32)
    lmask = np.zeros((n_trees, ni), np.uint32)
    payload = np.zeros((n_trees, nl), np.int32)
    for t, (entries, payloads, _) in enumerate(compiled):
        for i, (f, th, m) in enumerate(entries):
            feat[t, i] = f
            thresh[t, i] = th
            lmask[t, i] = m
        payload[t, : len(payloads)] = payloads
    return RangePacked(feat=feat, thresh=thresh, lmask=lmask.view(np.int32),
                       payload=payload, depth=depth)
