"""Activation sharding constraints.

Counterpart of ``repro.distributed.constrain``.  The reference pins the
sharding of activations at block boundaries with
``with_sharding_constraint`` when a launcher has installed a mesh.  Here
the launcher installs a ``DeviceMesh`` (``activation_mesh(mesh)``) and
layers call :func:`constrain` / :func:`constrain_batch`, which redistribute
a DTensor activation to the spec's placements (``DTensor.redistribute``:
an all-gather, all-reduce or all-to-all as the layouts need).  They are
the identity when no mesh is installed, when the activation is a plain
tensor (single-device runs), or when no entry of the spec survives the
guards: an axis absent from the mesh, or one that does not divide the dim
(e.g. the ``long_500k`` batch of 1), is dropped (replicated), as in the
reference.

Where GSPMD would pick layouts by itself, the port states them: the
linears run as explicit column- or row-parallel matmuls with the FSDP
gather (:func:`tp_matmul`), and the ops whose rows are independent
(attention, the WKV scan, the SSD, the MoE dispatch, the cross-entropy,
the embedding lookup, the kernel ops) run on each rank's local shards
(:func:`local_rows`, :func:`local_sums`, :func:`local_lookup`, over
``local_map``), each with its gradients' layouts.
"""

from __future__ import annotations

import math
import types
from contextlib import contextmanager
from typing import Sequence, Tuple

import torch

__all__ = ["activation_mesh", "constrain", "constrain_batch", "data_axes",
           "mesh_axis_size", "current_mesh", "pins", "local_rows",
           "tp_layout", "reduce_partial", "gather_data", "tp_matmul",
           "local_sums", "local_lookup", "is_dtensor"]

# Process-wide, not thread-local: on the card the autograd engine runs the
# backward (and the remat recomputation inside it) on its own device
# thread, which must see the mesh the forward was traced under.
_STATE = types.SimpleNamespace(mesh=None, pins={})


def pins() -> list:
    """The places, since the mesh was installed, where the port moved an
    activation to a layout of its own choosing (a pin before an op
    DTensor cannot take as it is, or a local-shard region whose inputs
    had to move): one entry per place, in first-use order."""
    return list(_STATE.pins)


@contextmanager
def activation_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh``) as the ambient
    activation-sharding target for the block."""
    prev = _STATE.mesh, _STATE.pins
    _STATE.mesh, _STATE.pins = mesh, {}
    try:
        yield
    finally:
        _STATE.mesh, _STATE.pins = prev


def current_mesh():
    """The installed activation mesh, or ``None``."""
    return _STATE.mesh


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes() -> Tuple[str, ...]:
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def mesh_axis_size(name: str) -> int:
    """Size of a mesh axis in the ambient activation mesh (1 if absent)."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return _sizes(mesh)[name]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, spec: Sequence, why: str = "",
              force: bool = False) -> torch.Tensor:
    """Redistribute ``x`` to ``spec`` with divisibility guards.

    ``spec`` entries: None, an axis name, a tuple of axis names, or the
    string "batch" (resolved to the data axes) or "all" (the data axes and
    ``model``).  Any entry whose axes are absent from the mesh or don't
    divide the dim is dropped (replicated).  ``why`` names a pin that
    exists because DTensor has no sharding rule for the next op: it is
    logged (:func:`pins`) when the pin moves data.  ``force`` applies the
    spec even when every entry was dropped (replicated everywhere): a pin
    before an op that cannot take the current layout."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    sizes = _sizes(mesh)
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        if entry in ("batch", "all"):
            axes_t = data_axes()
            if entry == "all" and "model" in sizes:
                axes_t = axes_t + ("model",)
            if not axes_t:
                out.append(None)
                continue
            entry = axes_t if len(axes_t) > 1 else axes_t[0]
        axes = entry if isinstance(entry, tuple) else (entry,)
        if not all(a in sizes for a in axes):
            out.append(None)
            continue
        if x.shape[dim] % math.prod(sizes[a] for a in axes) != 0:
            out.append(None)
            continue
        out.append(entry)
    if all(e is None for e in out) and not force:
        return x
    from .sharding import placements
    target = placements(tuple(out), mesh)
    if tuple(x.placements) == tuple(target):
        return x
    if why:
        _STATE.pins[why] = None
    return x.redistribute(x.device_mesh, target)


def constrain_batch(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Shard ``dim`` over the data axes (the canonical activation pin)."""
    spec: list = [None] * x.dim()
    spec[dim] = "batch"
    return constrain(x, spec)


def local_rows(fn, args: Sequence[torch.Tensor], rows: Sequence[Sequence],
               out_rows: Sequence[Sequence], why: str):
    """``fn(*args)`` on each rank's local shards, for a function whose
    outputs are independent across some "row" axes (batch, heads): each
    arg keeps the row axes ``args[0]`` is sharded on and is replicated on
    every other mesh dim, and the outputs come back sharded the same way
    (``torch.distributed.tensor.experimental.local_map``).  ``rows[i][r]``
    is the dim of ``args[i]`` that holds row axis ``r`` (``None`` where it
    has none); ``out_rows`` the same for each output.  With no mesh
    installed or plain tensors, ``fn(*args)``.  ``why`` names the place in
    :func:`pins` (it computes the same function on the local rows)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def row_of(place):  # the row axis args[0] shards on this mesh dim
        if isinstance(place, Shard) and place.dim in rows[0]:
            return list(rows[0]).index(place.dim)
        return None

    axes = [row_of(p) for p in args[0].placements]

    def layout(dims):
        return [Shard(dims[r]) if r is not None and dims[r] is not None
                else Replicate() for r in axes]

    def grad_layout(dims):  # an arg without a sharded row axis is used by
        # every rank's rows: its gradient is a partial sum there
        return [Partial() if r is not None and dims[r] is None else p
                for r, p in zip(axes, layout(dims))]

    in_pl = tuple(layout(d) for d in rows)
    out_pl = tuple(layout(d) for d in out_rows)
    if any(tuple(a.placements) != tuple(p) for a, p in zip(args, in_pl)):
        _STATE.pins[why] = None
    wrapped = local_map(fn, out_placements=out_pl if len(out_pl) > 1
                        else out_pl[0], in_placements=in_pl,
                        in_grad_placements=tuple(grad_layout(d)
                                                 for d in rows),
                        device_mesh=args[0].device_mesh,
                        redistribute_inputs=True)
    return wrapped(*args)


def tp_layout(x: torch.Tensor, w: torch.Tensor):
    """``(x, w)`` pinned for ``x @ w`` under a mesh, by ``w``'s placement on
    the ``model`` axis (from the sharding plan): column-parallel (``w``'s
    last dim sharded) takes ``x`` replicated on ``model`` and gives an
    output sharded on its last dim; row-parallel (``w``'s second-to-last
    dim sharded) takes ``x`` sharded on its last dim and gives a partial
    sum; otherwise both are replicated on ``model``.  ``w`` is gathered on
    the data axes (FSDP) and ``x`` keeps its rows' sharding there.  Plain
    tensors, or no mesh installed: unchanged.  Returns the kind too:
    ``"col"``, ``"row"`` or ``"rep"``."""
    mesh = current_mesh()
    if mesh is None or not (is_dtensor(x) and is_dtensor(w)):
        return x, w, "rep"
    from torch.distributed.tensor import Replicate, Shard
    names = w.device_mesh.mesh_dim_names
    kind = "rep"
    if "model" in names:
        place = w.placements[names.index("model")]
        if isinstance(place, Shard) and place.dim in (w.dim() - 1, -1):
            kind = "col"
        elif isinstance(place, Shard) and place.dim in (w.dim() - 2, -2):
            kind = "row"
    x_pl, w_pl = [], []
    for name, xp, wp in zip(names, x.placements, w.placements):
        if name == "model":
            x_pl.append(Shard(x.dim() - 1) if kind == "row" else Replicate())
            w_pl.append(wp if kind != "rep" else Replicate())
        else:
            keep = isinstance(xp, Shard) and xp.dim < x.dim() - 1
            x_pl.append(xp if keep else Replicate())
            w_pl.append(Replicate())
    if tuple(x.placements) != tuple(x_pl):
        x = x.redistribute(x.device_mesh, x_pl)
    if tuple(w.placements) != tuple(w_pl):
        w = w.redistribute(w.device_mesh, w_pl)
    return x, w, kind


def reduce_partial(y: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums reduced (all-reduce to replicated) on the
    mesh dims that hold them, in its own dtype: the all-reduce after a
    row-parallel matmul.  Anything else unchanged."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Partial, Replicate
    target = [Replicate() if isinstance(p, Partial) else p
              for p in y.placements]
    if tuple(target) == tuple(y.placements):
        return y
    return y.redistribute(y.device_mesh, target)


def gather_data(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight gathered on the data axes (the FSDP all-gather
    before its use), its ``model`` placement kept; anything else
    unchanged."""
    if current_mesh() is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    target = [p if name == "model" else Replicate()
              for name, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    if tuple(target) == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, target)


def tp_matmul(x: torch.Tensor, w: torch.Tensor, fn=None) -> torch.Tensor:
    """``fn(x, w)`` (default ``x @ w.to(x.dtype)``) for a weight ``w`` of the
    sharding plan: under a mesh the operands take their tensor-parallel
    layout (:func:`tp_layout`) and ``fn`` runs on each rank's shards
    (``local_map``), the layouts of the output and of both gradients
    stated as Megatron's: column-parallel gives columns sharded on
    ``model`` and an input gradient summed over it; row-parallel gives a
    partial sum on ``model`` (reduced in the activation dtype,
    :func:`reduce_partial`).  The weight's gradient is a partial sum over
    the data axes its rows were sharded on, which the FSDP gather's
    backward reduce-scatters.  Plain tensors or no mesh: ``fn(x, w)``."""
    fn = fn or (lambda a, b: a @ b.to(a.dtype))
    x, w, kind = tp_layout(x, w)
    if not is_dtensor(x):
        return fn(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = x.dim() - 1
    out_pl, xg_pl, wg_pl = [], [], []
    for name, xp, wp in zip(x.device_mesh.mesh_dim_names, x.placements,
                            w.placements):
        if name == "model":
            out_pl.append(Shard(last) if kind == "col" else
                          Partial() if kind == "row" else Replicate())
            xg_pl.append(Partial() if kind == "col" else xp)
            wg_pl.append(wp)
        else:
            out_pl.append(xp)
            xg_pl.append(xp)
            wg_pl.append(Partial() if isinstance(xp, Shard) else Replicate())
    y = local_map(fn, out_placements=out_pl,
                  in_placements=(tuple(x.placements), tuple(w.placements)),
                  in_grad_placements=(xg_pl, wg_pl),
                  device_mesh=x.device_mesh)(x, w)
    return reduce_partial(y)


def local_sums(fn, x: torch.Tensor, w: torch.Tensor, *rows, why: str = ""):
    """``fn(x, w, *rows)`` returning scalar sums, on each rank's rows: ``x``
    and ``rows`` (tensors or ``None``) keep their leading dim's sharding on
    the data axes and are replicated on the rest, ``w`` is gathered whole,
    and each sum comes back as a partial sum over the data axes the rows
    were sharded on (reduced by the first op that needs its value).  The
    gradient of ``w`` is such a partial sum too; that of ``x`` is the
    rows' own.  Plain tensors or no mesh: ``fn(x, w, *rows)``."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return fn(x, w, *rows)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = x.device_mesh
    row_pl = [p if isinstance(p, Shard) and p.dim == 0 and name != "model"
              else Replicate() for name, p in zip(dm.mesh_dim_names,
                                                  x.placements)]
    whole = [Replicate()] * dm.ndim
    sums = [Partial() if isinstance(p, Shard) else Replicate()
            for p in row_pl]
    if tuple(x.placements) != tuple(row_pl):
        _STATE.pins[why] = None
    present = [r for r in rows if r is not None]

    def local(x_, w_, *present_):
        it = iter(present_)
        return fn(x_, w_, *(None if r is None else next(it) for r in rows))

    out = local_map(local, out_placements=(sums, sums),
                    in_placements=(row_pl, whole, *[row_pl] * len(present)),
                    in_grad_placements=(row_pl, sums,
                                        *[row_pl] * len(present)),
                    device_mesh=dm, redistribute_inputs=True)(
        x, w, *present)
    return out


def _row_placements(x) -> list:
    """``x``'s placements kept where its leading dim is sharded on a data
    axis, replicated everywhere else."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim == 0 and name != "model"
            else Replicate() for name, p in zip(x.device_mesh.mesh_dim_names,
                                                x.placements)]


def local_lookup(fn, table: torch.Tensor, idx: torch.Tensor, *,
                 why: str) -> torch.Tensor:
    """``fn(table, idx)`` (a row lookup) on each rank's rows of ``idx``
    against the whole ``table`` (gathered): the output's leading dim keeps
    ``idx``'s data-axis sharding and is replicated on ``model``; the
    table's gradient is a partial sum over those data axes.  Plain tensors
    or no mesh: ``fn(table, idx)``."""
    if current_mesh() is None or not (is_dtensor(idx) or
                                      is_dtensor(table)):
        return fn(table, idx)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = (idx if is_dtensor(idx) else table).device_mesh
    if not is_dtensor(idx):
        from torch.distributed.tensor import DTensor
        idx = DTensor.from_local(idx, dm, [Replicate()] * dm.ndim,
                                 run_check=False)
    rows = _row_placements(idx)
    whole = [Replicate()] * dm.ndim
    partial = [Partial() if isinstance(p, Shard) else Replicate()
               for p in rows]
    if any(isinstance(p, Shard) for p in table.placements):
        _STATE.pins[why] = None
    return local_map(fn, out_placements=rows, in_placements=(whole, rows),
                     in_grad_placements=(partial, rows), device_mesh=dm,
                     redistribute_inputs=True)(table, idx)
