"""Tree-ensemble control-plane compiler (the pForest / Planter pipeline).

Counterpart of ``repro.forest.compile``, numpy with the port's own
``core.fixedpoint.encode``; the same inputs and seed give identical trees
and packed tables:

  * :func:`train_tree` / :func:`train_forest` — the pure-NumPy CART trainer
    (gini for classification, variance for regression; bootstrap rows +
    per-split feature subsampling), with the reference's rng draw sequence;
  * :class:`Forest` / :meth:`Forest.from_arrays` — the sklearn-convention
    import path (``children_left[i] == -1`` marks a leaf);
  * :func:`pack_forest` — thresholds and regression leaves quantized onto
    the wire code grid (int32) and packed into the dense node tables the
    data plane traverses (feature | threshold | left | right | leaf; leaves
    self-loop so a ``max_depth``-bounded traversal needs no leaf test).

:func:`train_tree`'s node budget is the reference's: the check before a
split reserves room for the two children only, so a tree can end up
larger than ``max_nodes`` (ROADMAP R3).  The port keeps that behaviour so
its trees stay identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core.fixedpoint import encode
from ..kernels.ref import FOREST_CLASSIFY, FOREST_REGRESS

__all__ = ["DecisionTree", "Forest", "PackedForest", "train_tree",
           "train_forest", "pack_forest", "predict_float",
           "FOREST_REGRESS", "FOREST_CLASSIFY", "FIELD_FEAT", "FIELD_THRESH",
           "FIELD_LEFT", "FIELD_RIGHT", "FIELD_LEAF"]

# Node-table field order (shared contract with kernels/ref.py).
FIELD_FEAT, FIELD_THRESH, FIELD_LEFT, FIELD_RIGHT, FIELD_LEAF = range(5)


@dataclasses.dataclass(frozen=True)
class DecisionTree:
    """One trained tree in flat array form (sklearn convention):
    ``feature``/``threshold`` on internal nodes, ``left``/``right`` child
    indices with ``-1`` on leaves, ``value`` the leaf payload (class index
    or float value), read on leaves only."""

    feature: np.ndarray    # (n_nodes,) int32
    threshold: np.ndarray  # (n_nodes,) float32
    left: np.ndarray       # (n_nodes,) int32, -1 on leaves
    right: np.ndarray      # (n_nodes,) int32, -1 on leaves
    value: np.ndarray      # (n_nodes,) float32

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    def depth(self) -> int:
        """Max edge count root→leaf (the data plane's unroll bound)."""
        def rec(i: int, d: int) -> int:
            if self.left[i] < 0:
                return d
            return max(rec(int(self.left[i]), d + 1),
                       rec(int(self.right[i]), d + 1))
        return rec(0, 0)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Float-domain per-row prediction (training-side reference)."""
        out = np.empty(X.shape[0], np.float64)
        for r in range(X.shape[0]):
            i = 0
            while self.left[i] >= 0:
                i = int(self.left[i]) if X[r, self.feature[i]] \
                    <= self.threshold[i] else int(self.right[i])
            out[r] = self.value[i]
        return out


@dataclasses.dataclass(frozen=True)
class Forest:
    """A trained ensemble plus its task metadata."""

    trees: List[DecisionTree]
    task: str            # "classify" | "regress"
    n_classes: int = 0   # classification only

    def __post_init__(self):
        if self.task not in ("classify", "regress"):
            raise ValueError(f"unknown task: {self.task!r}")
        if self.task == "classify" and self.n_classes < 2:
            raise ValueError("classification forest needs n_classes >= 2")

    @property
    def n_trees(self) -> int:
        return len(self.trees)

    @classmethod
    def from_arrays(cls, feature: Sequence[np.ndarray],
                    threshold: Sequence[np.ndarray],
                    children_left: Sequence[np.ndarray],
                    children_right: Sequence[np.ndarray],
                    value: Sequence[np.ndarray], *, task: str,
                    n_classes: int = 0) -> "Forest":
        """Import an externally trained ensemble: one array per tree, in the
        sklearn flat convention.  Values are class indices (classify) or
        float leaf values (regress)."""
        trees = []
        for f, th, l, r, v in zip(feature, threshold, children_left,
                                  children_right, value):
            trees.append(DecisionTree(
                feature=np.asarray(f, np.int32),
                threshold=np.asarray(th, np.float32),
                left=np.asarray(l, np.int32),
                right=np.asarray(r, np.int32),
                value=np.asarray(v, np.float32)))
        return cls(trees=trees, task=task, n_classes=n_classes)


def predict_float(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Float-domain ensemble prediction: majority vote (ties → lowest class)
    for classification, mean for regression."""
    per_tree = np.stack([t.predict(X) for t in forest.trees])  # (T, n)
    if forest.task == "regress":
        return per_tree.mean(axis=0)
    votes = np.zeros((X.shape[0], forest.n_classes), np.int64)
    for t in range(per_tree.shape[0]):
        votes[np.arange(X.shape[0]), per_tree[t].astype(np.int64)] += 1
    return votes.argmax(axis=1).astype(np.float64)


# ---------------------------------------------------------------------------
# CART trainer — pure NumPy
# ---------------------------------------------------------------------------


def _leaf_value(y: np.ndarray, task: str) -> float:
    if task == "regress":
        return float(y.mean()) if y.size else 0.0
    vals, counts = np.unique(y, return_counts=True)
    return float(vals[counts.argmax()]) if y.size else 0.0


def _impurity_gain(x: np.ndarray, y: np.ndarray, task: str, n_classes: int,
                   min_leaf: int):
    """Best split of one feature column: ``(gain, threshold)`` or None.
    Vectorized over all cut points via prefix sums — variance reduction for
    regression, gini decrease for classification."""
    n = x.shape[0]
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    # a boundary between positions i and i+1 needs distinct xs
    ok = xs[1:] != xs[:-1]
    nl = np.arange(1, n)          # left sizes at each boundary
    ok &= (nl >= min_leaf) & (n - nl >= min_leaf)
    if not ok.any():
        return None
    if task == "regress":
        csum = np.cumsum(ys)[:-1]
        csq = np.cumsum(ys * ys)[:-1]
        tot, totsq = csum[-1] + ys[-1], csq[-1] + ys[-1] * ys[-1]
        sse_l = csq - csum ** 2 / nl
        nr = n - nl
        sse_r = (totsq - csq) - (tot - csum) ** 2 / nr
        score = -(sse_l + sse_r)          # maximize ⇒ minimize child SSE
        parent = -(totsq - tot ** 2 / n)
    else:
        onehot = ys[:, None].astype(np.int64) == np.arange(n_classes)[None, :]
        cl = np.cumsum(onehot, axis=0)[:-1].astype(np.float64)  # (n-1, C)
        ctot = cl[-1] + onehot[-1]
        cr = ctot[None, :] - cl
        nr = (n - nl).astype(np.float64)
        gini_l = nl - (cl ** 2).sum(1) / nl          # nl * gini(left)
        gini_r = nr - (cr ** 2).sum(1) / nr
        score = -(gini_l + gini_r)
        parent = -(n - (ctot ** 2).sum() / n)
    score = np.where(ok, score, -np.inf)
    i = int(score.argmax())
    gain = float(score[i] - parent)
    if not np.isfinite(score[i]) or gain <= 1e-12:
        return None
    return gain, float((xs[i] + xs[i + 1]) / 2.0)


def train_tree(X: np.ndarray, y: np.ndarray, *, task: str = "classify",
               n_classes: int = 0, max_depth: int = 5, min_leaf: int = 2,
               max_nodes: int = 127,
               feature_frac: Optional[float] = None,
               rng: Optional[np.random.Generator] = None) -> DecisionTree:
    """Grow one CART tree (depth-, leaf- and node-budget-bounded).

    ``feature_frac`` subsamples candidate split features per node;
    ``max_nodes`` is the node budget checked before each split (see the
    module note: it reserves room for the two children only).
    """
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    if task == "classify" and n_classes == 0:
        n_classes = int(y.max()) + 1 if y.size else 2
    rng = rng or np.random.default_rng(0)
    d = X.shape[1]
    n_sub = d if feature_frac is None else max(1, int(round(d * feature_frac)))

    feature, threshold, left, right, value = [], [], [], [], []

    def new_node() -> int:
        feature.append(0)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        return len(feature) - 1

    def build(idx: np.ndarray, depth: int) -> int:
        node = new_node()
        ysub = y[idx]
        value[node] = _leaf_value(ysub, task)
        pure = np.all(ysub == ysub[0]) if ysub.size else True
        if depth >= max_depth or idx.size < 2 * min_leaf or pure \
                or len(feature) + 2 > max_nodes:
            return node
        feats = (np.arange(d) if n_sub == d
                 else np.sort(rng.choice(d, n_sub, replace=False)))
        best = None
        for j in feats:
            res = _impurity_gain(X[idx, j], ysub, task, n_classes, min_leaf)
            if res is not None and (best is None or res[0] > best[0]):
                best = (res[0], int(j), res[1])
        if best is None:
            return node
        _, j, th = best
        go_left = X[idx, j] <= th
        feature[node], threshold[node] = j, th
        left[node] = build(idx[go_left], depth + 1)
        right[node] = build(idx[~go_left], depth + 1)
        return node

    build(np.arange(X.shape[0]), 0)
    return DecisionTree(feature=np.asarray(feature, np.int32),
                        threshold=np.asarray(threshold, np.float32),
                        left=np.asarray(left, np.int32),
                        right=np.asarray(right, np.int32),
                        value=np.asarray(value, np.float32))


def train_forest(X: np.ndarray, y: np.ndarray, *, task: str = "classify",
                 n_trees: int = 8, max_depth: int = 5, min_leaf: int = 2,
                 max_nodes: int = 127, feature_frac: Optional[float] = None,
                 bootstrap: bool = True, seed: int = 0) -> Forest:
    """Random forest: bootstrap rows + per-split feature subsampling.
    ``feature_frac`` defaults to ``sqrt(d)/d`` for classification and
    ``1.0`` for regression (the standard Breiman settings)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n_classes = 0
    if task == "classify":
        n_classes = int(y.max()) + 1
    if feature_frac is None:
        d = X.shape[1]
        feature_frac = (np.sqrt(d) / d) if task == "classify" else 1.0
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(n_trees):
        idx = (rng.integers(0, X.shape[0], X.shape[0]) if bootstrap
               else np.arange(X.shape[0]))
        trees.append(train_tree(
            X[idx], y[idx], task=task, n_classes=n_classes,
            max_depth=max_depth, min_leaf=min_leaf, max_nodes=max_nodes,
            feature_frac=feature_frac, rng=rng))
    return Forest(trees=trees, task=task, n_classes=n_classes)


# ---------------------------------------------------------------------------
# Packing — quantize + lay out the dense padded node tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedForest:
    """Node tables for one ensemble at its natural ``(n_trees, n_nodes)``
    extents (``ControlPlane.install_forest`` pads them into its slot).
    Regression leaf codes are pre-divided by ``n_trees``, so the data
    plane's sum over trees is the mean vote."""

    nodes: np.ndarray    # (T, N, 5) int32 — feat|thresh|left|right|leaf
    tree_on: np.ndarray  # (T,) int32
    mode: int            # FOREST_REGRESS | FOREST_CLASSIFY
    out_dim: int         # 1 (regress) or n_classes (classify)
    depth: int           # max tree depth — must be <= the plane's unroll
    frac_bits: int       # code grid the thresholds/leaves were encoded at


def _encode32(a: np.ndarray, frac_bits: int) -> np.ndarray:
    return encode(a, frac_bits, total_bits=32).numpy()


def pack_forest(forest: Forest, *, frac_bits: int) -> PackedForest:
    """Quantize and pack an ensemble into traversal tables.  Thresholds land
    on the wire-feature code grid (int32); leaves self-loop (``left ==
    right == self``, feature 0, threshold 0)."""
    if forest.n_trees == 0:
        raise ValueError("cannot pack an empty forest")
    n_trees = forest.n_trees
    n_nodes = max(t.n_nodes for t in forest.trees)
    nodes = np.zeros((n_trees, n_nodes, 5), np.int32)
    depth = 0
    for ti, tree in enumerate(forest.trees):
        k = tree.n_nodes
        depth = max(depth, tree.depth())
        is_leaf = tree.left < 0
        self_idx = np.arange(k, dtype=np.int32)
        nodes[ti, :k, FIELD_FEAT] = np.where(is_leaf, 0, tree.feature)
        th_q = _encode32(tree.threshold, frac_bits)
        nodes[ti, :k, FIELD_THRESH] = np.where(is_leaf, 0, th_q)
        nodes[ti, :k, FIELD_LEFT] = np.where(is_leaf, self_idx, tree.left)
        nodes[ti, :k, FIELD_RIGHT] = np.where(is_leaf, self_idx, tree.right)
        if forest.task == "classify":
            leaf_q = tree.value.astype(np.int32)
        else:
            leaf_q = _encode32(tree.value / n_trees, frac_bits)
        nodes[ti, :k, FIELD_LEAF] = np.where(is_leaf, leaf_q, 0)
    mode = FOREST_CLASSIFY if forest.task == "classify" else FOREST_REGRESS
    out_dim = forest.n_classes if forest.task == "classify" else 1
    return PackedForest(nodes=nodes, tree_on=np.ones(n_trees, np.int32),
                        mode=mode, out_dim=out_dim, depth=depth,
                        frac_bits=frac_bits)
