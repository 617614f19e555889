"""Trees of dicts, lists and tuples, walked in JAX's leaf order.

JAX flattens a dict in the order of its sorted keys and a list or tuple in
index order.  The optimizer's global gradient norm and the checkpoint
store's leaf order follow that order, and a leaf's path is spelled as
``jax.tree_util.keystr`` spells it: ``['blocks']['w']`` for dict keys,
``[0]`` for sequence indices.  Anything that is not a dict, list or tuple
is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple

__all__ = ["leaves_with_paths", "leaves", "map_leaves", "unflatten"]


def leaves_with_paths(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of ``tree``, in JAX's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree) -> List[Any]:
    """The leaves of ``tree``, in JAX's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_leaves(fn: Callable, tree, *rest):
    """``fn(leaf, *nodes)`` over the leaves of ``tree``, where ``nodes`` are
    the subtrees of ``rest`` at the same place (each of ``rest`` is
    flattened up to ``tree``'s structure, as ``jax.tree_util.tree_map``
    does).  The result has ``tree``'s structure; leaves are visited in
    JAX's order."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, new_leaves: Iterable) -> Any:
    """A tree of ``like``'s structure whose leaves are ``new_leaves``, taken
    in JAX's order."""
    it = iter(new_leaves)
    return map_leaves(lambda _: next(it), like)
