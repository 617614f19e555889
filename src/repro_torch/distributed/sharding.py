"""Divisibility-aware sharding rule engine.

Counterpart of ``repro.distributed.sharding``.  Given a parameter tree (or
cache or batch structure) and a mesh, produce a spec per leaf: a tuple with
one entry per dim, each ``None`` (replicated), a mesh axis name, or a tuple
of axis names, as the reference's ``PartitionSpec`` spells it.

  * **TP** over the ``model`` axis: column-parallel for QKV/up projections
    (head-aligned where the op needs whole heads on a device), row-parallel
    for output/down projections, expert-parallel for MoE stacks;
  * **FSDP** over the ``data`` axis: every still-unsharded large dim of a
    big leaf is additionally sharded (ZeRO-3-style);
  * **fallbacks**: any rule whose divisibility/alignment check fails walks
    to the next candidate dim, or replicates — and records WHY, word for
    word as the reference does (e.g. qwen2's 12 heads on a 16-way model
    axis ⇒ attention TP falls back to d_ff TP).

Nothing here inspects values — only paths and shapes — so it works on
meta tensors (the dry run) and real parameters identically, and on a
duck-typed mesh with ``.shape`` (axis name → size) and ``.axis_names``.
Paths are spelled as ``jax.tree_util.keystr`` spells them
(``core.tree.leaves_with_paths``).

A spec becomes DTensor placements, one per mesh dim
(:func:`placements`): a tensor dim whose entry names a mesh axis is
``Shard(dim)`` on that mesh dim, every other mesh dim ``Replicate()``;
:meth:`ShardingPlan.distribute` turns a tree into DTensors on a
``torch.distributed.device_mesh.DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

from ..configs.base import ModelConfig
from ..core import tree as T

__all__ = ["ShardingPlan", "make_plan", "batch_axes", "batch_spec",
           "cache_specs", "logical_batch_sharding", "placements",
           "axis_sizes"]

Spec = Tuple  # one entry per dim: None | axis name | tuple of axis names


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` or of a duck-typed mesh whose
    ``.shape`` maps names to sizes (the reference's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def placements(spec: Spec, mesh) -> list:
    """DTensor placements (one per mesh dim) of ``spec``: ``Shard(d)`` on
    every mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others.  A tensor dim sharded on several axes (``("pod", "data")``)
    takes them in mesh order, as the reference's spec lists them."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in _axis_names(mesh):
        place = Replicate()
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if name in axes:
                place = Shard(d)
                break
        out.append(place)
    return out


@dataclasses.dataclass
class ShardingPlan:
    """Specs per leaf + a log of every fallback the engine took."""

    specs: Dict[str, Spec]
    fallbacks: List[str]
    mesh: object

    def tree_specs(self, tree):
        """Spec tree matching ``tree``'s structure."""
        return T.unflatten(tree, [self.specs[p] for p, _ in
                                  T.leaves_with_paths(tree)])

    def distribute(self, tree):
        """``tree``'s leaves as DTensors on the plan's ``DeviceMesh``, each
        sharded by its spec.  Every rank holds the same full leaf (a seeded
        init, a restored checkpoint) and keeps its own shard: nothing is
        sent (``src_data_rank=None``), and a replicated leaf keeps its
        storage and strides (K-major weight codes stay K-major)."""
        from torch.distributed.tensor import DTensor, Shard, distribute_tensor

        def one(leaf, spec):
            pl = placements(spec, self.mesh)
            if not any(isinstance(p, Shard) for p in pl):
                return DTensor.from_local(leaf, self.mesh, pl,
                                          run_check=False)
            return distribute_tensor(leaf, self.mesh, pl, src_data_rank=None)

        return T.unflatten(tree, [one(leaf, self.specs[p]) for p, leaf in
                                  T.leaves_with_paths(tree)])


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod','data') on multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


# ---------------------------------------------------------------------------
# rule table
# ---------------------------------------------------------------------------

# (path regex, kind) — kind drives which dims are TP candidates.
#   col:   shard LAST dim over model (column parallel)
#   row:   shard SECOND-TO-LAST dim over model (row parallel)
#   moe:   shard expert dim (−3) over model, fallback to the hidden dim
#   embed: shard vocab (−2) over model, fallback to d_model (−1)
#   rep:   always replicate on model (norms/bias/scalars/small tables)
_RULES: List[Tuple[str, str]] = [
    (r"\['(wq|wk|wv|wq_a|wq_b|wk_b|wv_b|wg|up|gate|in_z|in_x|in_dt|wkv_a)'\]\['w'\]", "col"),
    (r"\['time_mix'\]\['(wr|wk|wv)'\]\['w'\]", "col"),
    (r"\['channel_mix'\]\['wk'\]\['w'\]", "col"),
    (r"\['channel_mix'\]\['wv'\]\['w'\]", "row"),
    (r"\['channel_mix'\]\['wr'\]\['w'\]", "col"),
    (r"\['(wo|down|out_proj)'\]\['w'\]", "row"),
    (r"\['w_(gate|up|down)'\]", "moe"),
    (r"\['(embed|head|pos_dec)'\]", "embed"),
    (r"\['wr'\]\['w'\]", "col"),
]


def _alignment_for(path: str, cfg: ModelConfig) -> int:
    """Column-parallel alignment: whole heads must stay on one device."""
    if re.search(r"\['(wq|wk|wv)'\]", path) and "time_mix" not in path \
            and "channel_mix" not in path:
        return cfg.head_dim  # q, and kv columns: head-aligned
    if re.search(r"\['wq_b'\]", path):  # MLA query up: (dn+dr) per head
        return max(cfg.qk_nope_dim + cfg.qk_rope_dim, 1)
    if re.search(r"\['wk_b'\]", path):  # MLA key up: dn per head
        return max(cfg.qk_nope_dim, 1)
    if re.search(r"\['wv_b'\]", path):  # MLA value up: dv per head
        return max(cfg.v_head_dim, 1)
    if re.search(r"\['(in_z|in_x)'\]", path):  # mamba channels: ssm heads
        return cfg.ssm_head_dim
    if "time_mix" in path:  # rwkv wkv recurrence couples whole heads
        return cfg.rwkv_head_dim
    return 1


def _kv_heads_shardable(path: str, cfg: ModelConfig, model_size: int) -> bool:
    """K/V projections can only TP if kv heads divide the model axis."""
    if re.search(r"\['(wk|wv)'\]\['w'\]", path) and "mix" not in path:
        return cfg.n_kv_heads % model_size == 0
    return True


def _spec_for_leaf(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                   sizes: Dict[str, int], fallbacks: List[str],
                   fsdp_min: int = 1 << 20) -> Spec:
    ndim = len(shape)
    model = "model" if "model" in sizes else None
    model_n = sizes[model] if model else 1
    data_n = sizes.get("data", 1)

    axes: List[Optional[str]] = [None] * ndim
    if ndim == 0 or max(shape) == 1:
        return ()

    kind = "rep"
    for pat, k in _RULES:
        if re.search(pat, path):
            kind = k
            break
    if ndim < 2:
        kind = "rep"

    def try_shard(dim: int, axis: str, n: int, align: int = 1) -> bool:
        if axes[dim] is not None or n <= 1:
            return False
        if shape[dim] % n == 0 and (shape[dim] // n) % align == 0:
            axes[dim] = axis
            return True
        return False

    # --- TP over the model axis -----------------------------------------
    if model and kind != "rep":
        if kind == "col":
            align = _alignment_for(path, cfg)
            ok = (_kv_heads_shardable(path, cfg, model_n)
                  and try_shard(ndim - 1, model, model_n, align))
            if not ok:
                fallbacks.append(
                    f"{path}: col-TP blocked (dim {shape[-1]} % {model_n} "
                    f"× align {align}) → replicated on model")
        elif kind == "row":
            if not try_shard(ndim - 2, model, model_n,
                             _alignment_for(path, cfg)):
                fallbacks.append(
                    f"{path}: row-TP blocked ({shape[-2]} % {model_n}) → "
                    "replicated on model")
        elif kind == "moe":
            # expert parallelism; fallback: replicate experts on model and
            # let the MoE rows shard over data×model instead (layers.moe_ffn
            # row_spec) — hidden-TP would fight the row sharding
            if not try_shard(ndim - 3, model, model_n):
                fallbacks.append(
                    f"{path}: EP blocked ({shape[ndim-3]} experts % "
                    f"{model_n}) → experts replicated on model; MoE rows "
                    "shard over data×model")
        elif kind == "embed":
            if not try_shard(ndim - 2, model, model_n):
                if try_shard(ndim - 1, model, model_n):
                    fallbacks.append(
                        f"{path}: vocab-shard blocked ({shape[ndim-2]} % "
                        f"{model_n}) → sharded on d_model")
                else:
                    fallbacks.append(f"{path}: embed unshardable on model")

    # --- FSDP over the data axis ------------------------------------------
    if data_n > 1 and math.prod(shape) >= fsdp_min:
        # shard the largest still-free dim (skip tiny leading stack dims)
        order = sorted(range(ndim), key=lambda d: -shape[d])
        for d in order:
            if try_shard(d, "data", data_n):
                break
        else:
            fallbacks.append(f"{path}: FSDP found no divisible dim "
                             f"{shape} % {data_n} → replicated on data")

    return tuple(axes)


def make_plan(tree, cfg: ModelConfig, mesh, *,
              fsdp_min: int = 1 << 20) -> ShardingPlan:
    """Build the sharding plan for a parameter/optimizer-state tree."""
    sizes = axis_sizes(mesh)
    specs: Dict[str, Spec] = {}
    fallbacks: List[str] = []
    for path, leaf in T.leaves_with_paths(tree):
        specs[path] = _spec_for_leaf(path, tuple(leaf.shape), cfg, sizes,
                                     fallbacks, fsdp_min)
    return ShardingPlan(specs=specs, fallbacks=fallbacks, mesh=mesh)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------


def batch_spec(mesh, global_batch: int,
               fallbacks: Optional[List[str]] = None) -> Spec:
    """Shard the batch dim over every data axis that divides it."""
    sizes = axis_sizes(mesh)
    usable = []
    remaining = global_batch
    for a in batch_axes(mesh):
        if remaining % sizes[a] == 0:
            usable.append(a)
            remaining //= sizes[a]
        elif fallbacks is not None:
            fallbacks.append(f"batch {global_batch} % {a}={sizes[a]} → "
                             f"'{a}' axis idle for batch sharding")
    if not usable:
        return ()
    # one axis reads as its name, as a PartitionSpec entry ('data',) does
    return (usable[0] if len(usable) == 1 else tuple(usable),)


def logical_batch_sharding(mesh, tree, global_batch: int,
                           fallbacks: Optional[List[str]] = None):
    """Placements for a batch dict: dim 0 = batch, the rest replicated."""
    bs = batch_spec(mesh, global_batch, fallbacks)
    return T.map_leaves(
        lambda leaf: placements(tuple(bs) + (None,) * (len(leaf.shape) - 1),
                                mesh), tree)


def cache_specs(tree, cfg: ModelConfig, mesh, batch: int,
                fallbacks: Optional[List[str]] = None) -> ShardingPlan:
    """KV-cache / recurrent-state sharding: batch over data axes, head/latent
    dims over model where aligned.

    Cache layouts (leading layer-stack dims ignored):
      dense kv       (B, S, H_kv, dh)   → (data, None, model?, None)
      kv int8 scales (B, S, H_kv, 1)
      mla            (B, S, lkv|dr)     → (data, None, model?)
      rwkv state     (B, H, dh, dh)     → (data, model?, None, None)
      ssm state      (B, H, dh, N)      → (data, model?, None, None)
      conv state     (B, K, C)          → (data, None, model?)
      taylor-linear  (B, H, F, d)/(B,H,F) → (data, model?, ...)
      shifts         (B, D)             → (data, None)
    """
    fallbacks = [] if fallbacks is None else fallbacks
    model_n = axis_sizes(mesh).get("model", 1)
    bspec = batch_spec(mesh, batch, fallbacks)
    b_ax = bspec[0] if len(bspec) else None

    specs: Dict[str, Spec] = {}
    for path, leaf in T.leaves_with_paths(tree):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        # find batch dim: first dim equal to `batch` after any layer-stack dims
        axes: List = [None] * ndim
        bdim = None
        for d, s in enumerate(shape):
            if s == batch:
                bdim = d
                break
        if bdim is not None and b_ax is not None:
            axes[bdim] = b_ax
        if model_n > 1 and bdim is not None:
            # candidate head/latent dims after batch
            for d in range(bdim + 1, ndim):
                if ("ckv" in path or "krope" in path):
                    # MLA latent: shard the latent dim (contraction-sharded)
                    if d == ndim - 1 and shape[d] % model_n == 0:
                        axes[d] = "model"
                        break
                    continue
                if d == bdim + 2 and shape[d] % model_n == 0 and ndim >= 4:
                    axes[d] = "model"  # (B,S,H,dh) kv heads
                    break
                if d == bdim + 1 and ndim >= 3 and shape[d] % model_n == 0 \
                        and ("s" in path or "attn" in path
                             or "conv" not in path):
                    if ndim >= 3 and d != ndim - 1:
                        axes[d] = "model"  # (B,H,...) recurrent heads
                        break
            else:
                if ndim > 1:
                    fallbacks.append(f"{path}: cache head dims not divisible "
                                     f"by model={model_n} → replicated on model")
        specs[path] = tuple(axes)
    return ShardingPlan(specs=specs, fallbacks=fallbacks, mesh=mesh)
