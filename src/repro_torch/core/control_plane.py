"""Control-plane tables (paper §2, §3 item 3, Fig 2): the MLP family and
the tree-ensemble (forest) family.

Model parameters (weights, biases, activation opcodes, tree node tables)
live in control-plane tables, so a model can be retrained and re-installed
at runtime without rebuilding the data plane.  In the port the data plane
is the engine's kernel launches: every table is a device pointer argument,
never a compiled-in constant, so ``install()`` and ``install_forest()``
only publish new buffers.

Counterpart of ``repro.core.control_plane.ControlPlane`` for both families:
the same quantization and packing (bit-identical host tables after the
same install sequence), slot recycling, one Model-ID namespace across the
families, prepare-then-commit generation swaps sharing one ``version``,
event and fault hooks, and per-(family generation, device) snapshot caches
that upload with ``torch.as_tensor(..., device=)``.  Forest installs
publish two lowerings in one swap: the dense node tables
(:class:`ForestTables`, the pointer chase) and their range-table
compilation (:class:`RangeTables`).  The feature-spec, SLO and reflex
families arrive with their slices; until then their ``*_active`` latches
read ``False``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .fixedpoint import FixedPointFormat, encode

__all__ = [
    "ACT_NONE",
    "ACT_RELU",
    "ACT_SIGMOID",
    "ACT_LEAKY_RELU",
    "ACT_HARD_SIGMOID",
    "ACTIVATIONS",
    "ModelTables",
    "ForestTables",
    "RangeTables",
    "ControlPlane",
    "tables_from_numpy",
    "forest_tables_from_numpy",
    "range_tables_from_numpy",
]

# Activation opcodes stored per (model, layer) in the action table.
ACT_NONE = 0
ACT_RELU = 1
ACT_SIGMOID = 2  # Taylor-approximated (order is a data-plane config)
ACT_LEAKY_RELU = 3
ACT_HARD_SIGMOID = 4

ACTIVATIONS = {
    "none": ACT_NONE,
    "relu": ACT_RELU,
    "sigmoid": ACT_SIGMOID,
    "leaky_relu": ACT_LEAKY_RELU,
    "hard_sigmoid": ACT_HARD_SIGMOID,
}

_N_MODEL_IDS = 65536  # the 16-bit Model ID field
_INT32_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass
class ModelTables:
    """Dense, padded parameter tables (the match-action RAM), as tensors.

    Shapes (``M`` models, ``L`` layers, ``W`` width):
      * ``w``        (M, L, W, W)  weight codes (int8/int16/int32)
      * ``b``        (M, L, W)     int32 bias codes at ``2*frac`` bits
      * ``act``      (M, L)        int32 activation opcodes
      * ``layer_on`` (M, L)        int32, 1 if the layer exists
      * ``out_dim``  (M,)          int32 number of output features
      * ``id_map``   (65536,)      int32 Model-ID → slot (-1 = not installed)
    """

    w: torch.Tensor
    b: torch.Tensor
    act: torch.Tensor
    layer_on: torch.Tensor
    out_dim: torch.Tensor
    id_map: torch.Tensor


@dataclasses.dataclass
class ForestTables:
    """Dense, padded tree-ensemble tables (the pForest/Planter match-action
    RAM), as tensors.

    Shapes (``F`` forests, ``T`` trees, ``N`` nodes):
      * ``nodes``    (F, T, N, 5)  int32 node records — feature | quantized
                                   threshold | left | right | leaf payload;
                                   leaves self-loop (left == right == self)
      * ``tree_on``  (F, T)        int32, 1 if the tree exists
      * ``mode``     (F,)          int32 vote mode (FOREST_REGRESS /
                                   FOREST_CLASSIFY)
      * ``out_dim``  (F,)          int32 output lanes (1 or n_classes)
      * ``id_map``   (65536,)      int32 Model-ID → forest slot (-1 = none)
    """

    nodes: torch.Tensor
    tree_on: torch.Tensor
    mode: torch.Tensor
    out_dim: torch.Tensor
    id_map: torch.Tensor


@dataclasses.dataclass
class RangeTables:
    """The range-table compilation of the forest family (the pForest
    ternary-match lowering, ``repro_torch.forest.ranges``), published by
    the same generation swap as :class:`ForestTables`.  Shapes (``NI =
    (max_nodes-1)//2`` entries, ``L = NI+1`` leaves):

      * ``feat``     (F, T, NI)  int32 feature index per range entry
      * ``thresh``   (F, T, NI)  int32 threshold code (padding: INT32_MAX)
      * ``lmask``    (F, T, NI)  int32 bit pattern of the uint32
                                 surviving-leaf mask when the entry's
                                 ``x <= thresh`` fails
      * ``payload``  (F, T, L)   int32 per-leaf output codes (in-order leaf
                                 numbering — exit leaf = lowest set bit)

    Tree liveness, vote mode, output dims and the Model-ID map are those of
    :class:`ForestTables` (one forest family, two lowerings).
    """

    feat: torch.Tensor
    thresh: torch.Tensor
    lmask: torch.Tensor
    payload: torch.Tensor


def _put(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def tables_from_numpy(w, b, act, layer_on, out_dim, id_map,
                      device="cpu") -> ModelTables:
    """Build :class:`ModelTables` on ``device`` from host arrays in the
    control plane's layout — e.g. the reference control plane's tables."""
    return ModelTables(w=_put(w, None, device), b=_put(b, np.int32, device),
                       act=_put(act, np.int32, device),
                       layer_on=_put(layer_on, np.int32, device),
                       out_dim=_put(out_dim, np.int32, device),
                       id_map=_put(id_map, np.int32, device))


def forest_tables_from_numpy(nodes, tree_on, mode, out_dim, id_map,
                             device="cpu") -> ForestTables:
    """Build :class:`ForestTables` on ``device`` from host arrays in the
    control plane's layout — e.g. the reference control plane's."""
    return ForestTables(*(_put(a, np.int32, device)
                          for a in (nodes, tree_on, mode, out_dim, id_map)))


def range_tables_from_numpy(feat, thresh, lmask, payload,
                            device="cpu") -> RangeTables:
    """Build :class:`RangeTables` on ``device`` from host arrays in the
    control plane's layout; a ``uint32`` leaf mask (the reference's) becomes
    its int32 bit pattern."""
    lmask = np.asarray(lmask)
    if lmask.dtype == np.uint32:
        lmask = lmask.view(np.int32)
    return RangeTables(feat=_put(feat, np.int32, device),
                       thresh=_put(thresh, np.int32, device),
                       lmask=_put(lmask, np.int32, device),
                       payload=_put(payload, np.int32, device))


class ControlPlane:
    """Host-side registry that owns and mutates the MLP and forest tables.

    ``frac_bits`` is shared by features, weights and tree thresholds.
    Installs are double-buffered: a writer prepares private copies of the
    live host tables and swaps them in under the lock, bumping the
    generation.  ``tables(device)``, ``forest_tables(device)`` and
    ``range_tables(device)`` return snapshots cached per (family
    generation, device), so a batch in flight keeps the old buffers and
    steady-state serving re-uploads nothing.  Model IDs form one namespace:
    an id resolves in at most one family's ``id_map``.
    """

    def __init__(self, *, max_models: int = 16, max_layers: int = 4,
                 max_width: int = 32, weight_bits: int = 16,
                 frac_bits: int = 8, max_forests: int = 8,
                 max_trees: int = 16, max_nodes: int = 64,
                 max_tree_depth: int = 6):
        self.max_models = max_models
        self.max_layers = max_layers
        self.max_width = max_width
        self.fmt = FixedPointFormat(total_bits=weight_bits, frac_bits=frac_bits)
        self.frac_bits = frac_bits
        self._lock = threading.Lock()
        # fault-injection hook (serve.faults.FaultPlan.install attaches it);
        # fired between table preparation and the commit point of every
        # install so the all-or-nothing swap property is testable
        self.fault_plan = None
        # obs EventLog hook: every committed swap is recorded
        self.events = None
        # ``fn(kind, model_id)`` callbacks run after every committed swap
        self.install_listeners: List = []
        w_dtype = self.fmt.dtype
        self._w = torch.zeros((max_models, max_layers, max_width, max_width),
                              dtype=w_dtype)
        self._b = torch.zeros((max_models, max_layers, max_width),
                              dtype=torch.int32)
        self._act = torch.zeros((max_models, max_layers), dtype=torch.int32)
        self._layer_on = torch.zeros((max_models, max_layers),
                                     dtype=torch.int32)
        self._out_dim = torch.zeros((max_models,), dtype=torch.int32)
        self._id_map = torch.full((_N_MODEL_IDS,), -1, dtype=torch.int32)
        self._slots: Dict[int, int] = {}
        self._free_slots: List[int] = []  # recycled by remove()
        self._next_slot = 0
        # -- tree-ensemble family (same swap discipline, shared version) --
        self.max_forests = max_forests
        self.max_trees = max_trees
        self.max_nodes = max_nodes
        self.max_tree_depth = max_tree_depth
        self._f_nodes = torch.zeros((max_forests, max_trees, max_nodes, 5),
                                    dtype=torch.int32)
        self._f_tree_on = torch.zeros((max_forests, max_trees),
                                      dtype=torch.int32)
        self._f_mode = torch.zeros((max_forests,), dtype=torch.int32)
        self._f_out_dim = torch.zeros((max_forests,), dtype=torch.int32)
        self._f_id_map = torch.full((_N_MODEL_IDS,), -1, dtype=torch.int32)
        # range-table lowering of the same family: static extents derive
        # from max_nodes; the 32-bit leaf mask caps it at 32 leaves per
        # tree, so a plane with a larger node budget has no range family
        from ..forest.ranges import range_bounds
        ni, nl = range_bounds(max_nodes)
        self._r_ni, self._r_nl = max(1, ni), max(1, nl)
        self.range_available = nl <= 32
        if self.range_available:
            shape = (max_forests, max_trees, self._r_ni)
            self._r_feat = torch.zeros(shape, dtype=torch.int32)
            self._r_th = torch.full(shape, _INT32_MAX, dtype=torch.int32)
            self._r_mask = torch.zeros(shape, dtype=torch.int32)
            self._r_payload = torch.zeros(
                (max_forests, max_trees, self._r_nl), dtype=torch.int32)
        self._f_slots: Dict[int, int] = {}
        self._f_free_slots: List[int] = []
        self._f_next_slot = 0
        # latched on the first forest install: the engine's "run the forest
        # lane" switch keys off it, so it flips at most once per process
        self._forest_ever = False
        self._version = 0
        # per-family write counters: the shared ``_version`` is the cache
        # and staleness key, but snapshots re-upload per family, so a swap
        # in one family never re-uploads the other's tables
        self._mlp_gen = 0
        self._forest_gen = 0
        # per-device snapshot caches: device → (family generation, tables)
        self._snapshot: Dict[torch.device, Tuple[int, ModelTables]] = {}
        self._forest_snapshot: Dict[torch.device,
                                    Tuple[int, ForestTables]] = {}
        self._range_snapshot: Dict[torch.device, Tuple[int, RangeTables]] = {}

    def _fire_fault(self, site: str) -> None:
        """Fault-injection hook (no-op without an installed plan), at the
        last point before an install's commit: anything it raises leaves the
        live tables and the version unchanged."""
        plan = self.fault_plan
        if plan is not None:
            plan.fire(site, shard=-1)

    def _emit(self, kind: str, model_id: int, **detail) -> None:
        """Record a committed swap in the attached event log and notify the
        install listeners (after the version bump)."""
        events = self.events
        if events is not None:
            events.emit(kind, shard=-1, generation=self._version,
                        model_id=int(model_id), **detail)
        for fn in list(self.install_listeners):
            fn(kind, int(model_id))

    # -- control-plane writes -------------------------------------------

    def install(self, model_id: int,
                layers: Sequence[Tuple[np.ndarray, np.ndarray]],
                activations: Sequence[str],
                final_activation: str = "none") -> int:
        """Quantize and install (or hot-swap) a model.  Returns its slot.

        ``layers``: [(W0, b0), …] with ``W_l`` of shape (in, out) floats.
        ``activations``: one name per hidden layer; the last layer uses
        ``final_activation``.
        """
        if len(layers) > self.max_layers:
            raise ValueError(f"model has {len(layers)} layers > max {self.max_layers}")
        acts = list(activations) + [final_activation]
        acts = acts[: len(layers)]
        # validate + quantize everything before touching any table state
        quantized = []
        for l, (w, bias) in enumerate(layers):
            w = np.asarray(w, np.float32)
            bias = np.asarray(bias, np.float32)
            din, dout = w.shape
            if din > self.max_width or dout > self.max_width:
                raise ValueError(f"layer {l} ({din}x{dout}) exceeds max width")
            opcode = ACTIVATIONS[acts[l]]  # KeyError before any mutation
            wq = encode(w, self.frac_bits, total_bits=self.fmt.total_bits)
            # bias pre-shifted onto the accumulator grid (2*frac bits)
            bq = encode(bias, 2 * self.frac_bits, total_bits=32)
            quantized.append((din, dout, wq, bq, opcode))
        with self._lock:
            if model_id in self._f_slots:
                raise ValueError(
                    f"model id {model_id} is installed as a forest — "
                    "remove() it before installing an MLP under the same id")
            slot = self._slots.get(model_id)
            if slot is None and not self._free_slots \
                    and self._next_slot >= self.max_models:
                raise ValueError("control plane table full")
            # prepare on private copies; the commit block is plain
            # assignments, so an exception up to the fault hook rolls back
            w, b, act = self._w.clone(), self._b.clone(), self._act.clone()
            layer_on = self._layer_on.clone()
            out_dim, id_map = self._out_dim.clone(), self._id_map.clone()
            slots, free = dict(self._slots), list(self._free_slots)
            next_slot = self._next_slot
            if slot is None:
                # prefer recycled slots
                slot = free.pop() if free else next_slot
                if slot == next_slot:
                    next_slot += 1
                slots[model_id] = slot
                id_map[model_id] = slot
            w[slot] = 0
            b[slot] = 0
            layer_on[slot] = 0
            for l, (din, dout, wq, bq, opcode) in enumerate(quantized):
                w[slot, l, :din, :dout] = wq
                b[slot, l, :dout] = bq
                act[slot, l] = opcode
                layer_on[slot, l] = 1
            out_dim[slot] = int(np.asarray(layers[-1][0]).shape[1])
            self._fire_fault("install")
            # -- commit (atomic under the lock) --
            self._w, self._b, self._act = w, b, act
            self._layer_on, self._out_dim = layer_on, out_dim
            self._id_map = id_map
            self._slots, self._free_slots = slots, free
            self._next_slot = next_slot
            self._mlp_gen += 1
            self._version += 1
            self._emit("install", model_id, family="mlp", slot=slot)
            return slot

    def installed_ids(self) -> frozenset:
        """Model ids currently installed in either family."""
        with self._lock:
            return frozenset(self._slots) | frozenset(self._f_slots)

    def remove(self, model_id: int) -> None:
        """Uninstall a model from whichever family holds it (no-op if
        neither does)."""
        with self._lock:
            slot = self._slots.pop(model_id, None)
            if slot is not None:
                # copy-on-write: published snapshots keep their buffers
                self._id_map = self._id_map.clone()
                self._layer_on = self._layer_on.clone()
                self._id_map[model_id] = -1
                self._layer_on[slot] = 0
                self._free_slots.append(slot)
                self._mlp_gen += 1
                self._version += 1
                self._emit("remove", model_id, family="mlp")
                return
            fslot = self._f_slots.pop(model_id, None)
            if fslot is None:
                return
            self._f_id_map = self._f_id_map.clone()
            self._f_tree_on = self._f_tree_on.clone()
            self._f_id_map[model_id] = -1
            self._f_tree_on[fslot] = 0
            self._f_free_slots.append(fslot)
            self._forest_gen += 1
            self._version += 1
            self._emit("remove", model_id, family="forest")

    # -- tree-ensemble family -------------------------------------------

    def install_forest(self, model_id: int, forest) -> int:
        """Quantize, pack and install (or hot-swap) a tree ensemble.
        Returns its forest slot.

        ``forest`` is a :class:`repro_torch.forest.Forest` (packed here at
        this plane's ``frac_bits``) or a pre-built
        :class:`repro_torch.forest.PackedForest`.  Same all-or-nothing
        generation swap as :meth:`install`: everything is validated,
        quantized and range-compiled before any table state is touched, and
        both lowerings publish in one version bump.
        """
        from ..forest.compile import Forest, PackedForest, pack_forest
        if isinstance(forest, Forest):
            packed = pack_forest(forest, frac_bits=self.frac_bits)
        elif isinstance(forest, PackedForest):
            packed = forest
        else:
            raise TypeError(
                f"install_forest wants a Forest or PackedForest, "
                f"got {type(forest).__name__}")
        nodes = np.asarray(packed.nodes, np.int32)
        n_trees, n_nodes, _ = nodes.shape
        if n_trees > self.max_trees:
            raise ValueError(
                f"forest has {n_trees} trees > max {self.max_trees}")
        if n_nodes > self.max_nodes:
            raise ValueError(
                f"forest has {n_nodes}-node trees > max {self.max_nodes}")
        if packed.depth > self.max_tree_depth:
            raise ValueError(
                f"forest depth {packed.depth} exceeds the data plane's "
                f"unroll bound max_tree_depth={self.max_tree_depth}")
        if packed.frac_bits != self.frac_bits:
            raise ValueError(
                f"forest packed at {packed.frac_bits} fractional bits; "
                f"this control plane's wire grid is {self.frac_bits}")
        feats = nodes[:, :, 0]
        if feats.size and (int(feats.max()) >= self.max_width
                           or int(feats.min()) < 0):
            raise ValueError(
                f"forest splits on feature {int(feats.max())} >= "
                f"max_width={self.max_width}")
        kids = nodes[:, :, 2:4]
        if kids.size and (int(kids.min()) < 0
                          or int(kids.max()) >= n_nodes):
            raise ValueError(
                "forest child pointers outside [0, n_nodes) — leaves must "
                "self-loop (pack_forest does this); dangling pointers would "
                "break the level-bounded traversal")
        if packed.mode == 1:  # FOREST_CLASSIFY: leaves are vote-lane indices
            leaves = nodes[:, :, 4]
            if leaves.size and (int(leaves.min()) < 0
                                or int(leaves.max()) >= packed.out_dim):
                raise ValueError(
                    f"classification leaf label outside [0, "
                    f"{packed.out_dim}) — an out-of-range label would vote "
                    "into a masked-off (or nonexistent) lane and silently "
                    "vanish at egress")
        if packed.out_dim > self.max_width:
            raise ValueError(
                f"forest out_dim {packed.out_dim} exceeds "
                f"max_width={self.max_width} vote lanes")
        # range compilation before any table state is touched: its walk
        # also validates tree structure (acyclicity, depth, leaf budget)
        # that the bounds checks above cannot see
        ranges = None
        if self.range_available:
            from ..forest.ranges import pack_forest_ranges
            ranges = pack_forest_ranges(nodes, packed.tree_on,
                                        max_depth=self.max_tree_depth)
        with self._lock:
            if model_id in self._slots:
                raise ValueError(
                    f"model id {model_id} is installed as an MLP — "
                    "remove() it before installing a forest under the "
                    "same id")
            slot = self._f_slots.get(model_id)
            if slot is None and not self._f_free_slots \
                    and self._f_next_slot >= self.max_forests:
                raise ValueError("forest table full")
            # prepare-then-commit, as install(): both lowerings stage on
            # private copies and publish together
            f_nodes, f_tree_on = self._f_nodes.clone(), self._f_tree_on.clone()
            f_mode, f_out_dim = self._f_mode.clone(), self._f_out_dim.clone()
            f_id_map = self._f_id_map.clone()
            f_slots, f_free = dict(self._f_slots), list(self._f_free_slots)
            f_next = self._f_next_slot
            if slot is None:
                slot = f_free.pop() if f_free else f_next
                if slot == f_next:
                    f_next += 1
                f_slots[model_id] = slot
                f_id_map[model_id] = slot
            f_nodes[slot] = 0
            f_tree_on[slot] = 0
            f_nodes[slot, :n_trees, :n_nodes] = torch.from_numpy(nodes)
            f_tree_on[slot, :n_trees] = torch.as_tensor(
                np.asarray(packed.tree_on, np.int32))
            f_mode[slot] = int(packed.mode)
            f_out_dim[slot] = int(packed.out_dim)
            if ranges is not None:
                r_feat, r_th = self._r_feat.clone(), self._r_th.clone()
                r_mask, r_payload = self._r_mask.clone(), self._r_payload.clone()
                r_feat[slot] = 0
                r_th[slot] = _INT32_MAX
                r_mask[slot] = 0
                r_payload[slot] = 0
                ni = ranges.feat.shape[1]
                nl = ranges.payload.shape[1]
                r_feat[slot, :n_trees, :ni] = torch.from_numpy(ranges.feat)
                r_th[slot, :n_trees, :ni] = torch.from_numpy(ranges.thresh)
                r_mask[slot, :n_trees, :ni] = torch.from_numpy(ranges.lmask)
                r_payload[slot, :n_trees, :nl] = torch.from_numpy(
                    ranges.payload)
            self._fire_fault("install")
            # -- commit (atomic under the lock) --
            self._f_nodes, self._f_tree_on = f_nodes, f_tree_on
            self._f_mode, self._f_out_dim = f_mode, f_out_dim
            self._f_id_map = f_id_map
            self._f_slots, self._f_free_slots = f_slots, f_free
            self._f_next_slot = f_next
            if ranges is not None:
                self._r_feat, self._r_th = r_feat, r_th
                self._r_mask, self._r_payload = r_mask, r_payload
            self._forest_ever = True
            self._forest_gen += 1
            self._version += 1
            self._emit("install_forest", model_id, family="forest",
                       slot=slot)
            return slot

    def is_forest_id(self, model_ids: np.ndarray) -> np.ndarray:
        """Vectorized host-side family lookup (current generation): True
        where a Model ID resolves to a forest slot.  The ingress pipeline
        stages lane-pure batches with it."""
        with self._lock:
            return self._f_id_map.numpy()[np.asarray(model_ids,
                                                      np.int64)] >= 0

    @property
    def forest_active(self) -> bool:
        """True once any forest has ever been installed (monotone — the
        engine's forest-lane switch keys off it, so it flips at most once
        per process)."""
        return self._forest_ever

    # -- latches of the families still to port ----------------------------

    @property
    def slo_active(self) -> bool:
        """True once a latency budget was ever installed; always False until
        the SLO family is ported."""
        return False

    @property
    def reflex_active(self) -> bool:
        """True once a reflex program was ever installed; always False until
        the reflex family is ported."""
        return False

    # -- data-plane reads -------------------------------------------------

    @staticmethod
    def _upload(device, cls, **host):
        return cls(**{k: torch.as_tensor(t, device=device).contiguous()
                      for k, t in host.items()})

    def tables(self, device="cpu") -> ModelTables:
        """Snapshot of the current MLP table generation on ``device``,
        cached until the next MLP write (one cache entry per device).
        In-flight batches holding an older snapshot keep their buffers
        alive.  On the CPU the snapshot is the host tables themselves, which
        writers replace and never mutate."""
        device = torch.device(device)
        with self._lock:
            snap = self._snapshot.get(device)
            if snap is None or snap[0] != self._mlp_gen:
                snap = (self._mlp_gen, self._upload(
                    device, ModelTables, w=self._w, b=self._b, act=self._act,
                    layer_on=self._layer_on, out_dim=self._out_dim,
                    id_map=self._id_map))
                self._snapshot[device] = snap
            return snap[1]

    def forest_tables(self, device="cpu") -> ForestTables:
        """Snapshot of the forest node tables — same caching as
        :meth:`tables`, keyed on the forest family's own write counter."""
        with self._lock:
            return self._forest_tables_locked(torch.device(device))

    def _forest_tables_locked(self, device: torch.device) -> ForestTables:
        snap = self._forest_snapshot.get(device)
        if snap is None or snap[0] != self._forest_gen:
            snap = (self._forest_gen, self._upload(
                device, ForestTables, nodes=self._f_nodes,
                tree_on=self._f_tree_on, mode=self._f_mode,
                out_dim=self._f_out_dim, id_map=self._f_id_map))
            self._forest_snapshot[device] = snap
        return snap[1]

    def range_tables(self, device="cpu") -> RangeTables:
        """Snapshot of the range-table lowering — keyed on the same forest
        write counter as :meth:`forest_tables` (the two publish together)."""
        if not self.range_available:
            raise RuntimeError(
                f"range tables unavailable: max_nodes={self.max_nodes} "
                "exceeds the 32-leaf mask bound (needs max_nodes <= 64)")
        with self._lock:
            return self._range_tables_locked(torch.device(device))

    def _range_tables_locked(self, device: torch.device) -> RangeTables:
        snap = self._range_snapshot.get(device)
        if snap is None or snap[0] != self._forest_gen:
            snap = (self._forest_gen, self._upload(
                device, RangeTables, feat=self._r_feat, thresh=self._r_th,
                lmask=self._r_mask, payload=self._r_payload))
            self._range_snapshot[device] = snap
        return snap[1]

    def forest_snapshots(self, want_ranges: bool, device="cpu"
                         ) -> Tuple[ForestTables, Optional[RangeTables]]:
        """Both forest lowerings of the **same** generation under one lock:
        the range traversal takes liveness, mode and id_map from
        :class:`ForestTables` and its rows from :class:`RangeTables`, and an
        ``install_forest`` between two separate reads would hand it a torn
        pair."""
        device = torch.device(device)
        with self._lock:
            ftables = self._forest_tables_locked(device)
            rtables = (self._range_tables_locked(device) if want_ranges
                       else None)
            return ftables, rtables

    @property
    def version(self) -> int:
        """Table generation — bumped by every install/remove swap."""
        return self._version
