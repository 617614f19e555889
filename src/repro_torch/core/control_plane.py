"""Control-plane tables (paper §2, §3 item 3, Fig 2): the MLP family, the
tree-ensemble (forest) family and the flow engine's feature-spec family.

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
compilation (:class:`RangeTables`).  The feature-spec family
(:class:`FeatureSpec`) is host-only state the flow frontend reads, swapped
under the same discipline, and so are the latency-SLO family (per-model
budgets the ingress deadline scheduler reads) and the reflex family
(per-model threshold/vote programs the ingress answers overload packets
with, evaluated in host numpy with the reference's integer arithmetic).

At LM scale, :class:`WeightRegistry` holds named parameter trees with the
same hot-swap rule: a checkpoint of the installed structure swaps in, a
structure change raises.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ref import N_FLOW_FEATURES
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
    "FeatureSpec",
    "ControlPlane",
    "tables_from_numpy",
    "forest_tables_from_numpy",
    "range_tables_from_numpy",
    "WeightRegistry",
    "tree_structure",
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


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Flow-feature → model-input column mapping (the Planter "feature
    mapping stage" as its own control-plane object).

    ``columns[j]`` names the flow-engine feature lane
    (``kernels.ref.FLOW_FEATURE_NAMES`` order) that feeds the model's input
    column ``j``.  Installed per Model ID with the same generation-swap
    discipline as the weight tables, so an MLP and a forest can consume
    different register subsets from one shared flow table, and re-mapping a
    live model is one host-side swap — no new serving configuration.
    """

    columns: Tuple[int, ...]

    def __post_init__(self):
        if not self.columns:
            raise ValueError("FeatureSpec needs at least one column")
        for c in self.columns:
            if not 0 <= int(c) < N_FLOW_FEATURES:
                raise ValueError(
                    f"FeatureSpec column {c} outside the flow engine's "
                    f"[0, {N_FLOW_FEATURES}) feature lanes")


class ControlPlane:
    """Host-side registry that owns and mutates the MLP, forest and
    feature-spec tables.

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
        # -- flow feature-spec family (host-only: read by the flow
        #    frontend, never uploaded — an install is still a generation
        #    swap so readers see one coherent mapping) --
        self._spec_map = np.full((_N_MODEL_IDS,), -1, np.int32)
        self._spec_rows = np.full((0, max_width), -1, np.int32)
        self._spec_lens = np.zeros((0,), np.int32)
        self._specs: Dict[int, FeatureSpec] = {}
        # per-generation read table (identity row prepended so slot -1 maps
        # to it via +1): the frontend's hot path is one gather
        self._spec_read_cache: Optional[Tuple] = None
        # -- latency-SLO family (host-only: per-model budgets in µs read by
        #    the ingress deadline scheduler; inf = no budget) --
        self._slo_us = np.full((_N_MODEL_IDS,), np.inf, np.float64)
        self._slo_models: Dict[int, float] = {}
        self._slo_any = False  # monotone: ingress gates its deadline math
        # -- reflex family (host-only: serve.reflex.ReflexProgram packed
        #    into dense padded arrays, same prepare-then-commit swap) --
        self._rx_map = np.full((_N_MODEL_IDS,), -1, np.int32)
        self._rx_lane = np.zeros((0, max_width), np.int32)
        self._rx_thr = np.zeros((0, max_width), np.int32)
        self._rx_w = np.zeros((0, max_width), np.int32)
        self._rx_bias = np.zeros((0,), np.int64)
        self._rx_true = np.zeros((0, max_width), np.int32)
        self._rx_false = np.zeros((0, max_width), np.int32)
        self._rx_out_dim = np.zeros((0,), np.int32)
        self._rx_programs: Dict[int, object] = {}
        self._rx_any = False   # monotone: ingress gates its reflex lane
        self._rx_read_cache: Optional[Tuple] = None
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
                final_activation: str = "none",
                slo_budget_us: Optional[float] = None) -> int:
        """Quantize and install (or hot-swap) a model.  Returns its slot.

        ``layers``: [(W0, b0), …] with ``W_l`` of shape (in, out) floats.
        ``activations``: one name per hidden layer; the last layer uses
        ``final_activation``.  ``slo_budget_us`` optionally installs the
        model's latency budget in the same generation swap
        (:meth:`install_slo_budget`).
        """
        slo = self._check_slo(slo_budget_us)
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
            slo_us = self._prep_slo(model_id, slo)
            self._fire_fault("install")
            # -- commit (atomic under the lock) --
            self._w, self._b, self._act = w, b, act
            self._layer_on, self._out_dim = layer_on, out_dim
            self._id_map = id_map
            self._slots, self._free_slots = slots, free
            self._next_slot = next_slot
            self._commit_slo(model_id, slo, slo_us)
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

    def install_forest(self, model_id: int, forest,
                       slo_budget_us: Optional[float] = None) -> int:
        """Quantize, pack and install (or hot-swap) a tree ensemble.
        Returns its forest slot.

        ``forest`` is a :class:`repro_torch.forest.Forest` (packed here at
        this plane's ``frac_bits``) or a pre-built
        :class:`repro_torch.forest.PackedForest`.  Same all-or-nothing
        generation swap as :meth:`install`: everything is validated,
        quantized and range-compiled before any table state is touched, and
        both lowerings publish in one version bump (with the optional
        ``slo_budget_us``).
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
        slo = self._check_slo(slo_budget_us)
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
            slo_us = self._prep_slo(model_id, slo)
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
            self._commit_slo(model_id, slo, slo_us)
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

    # -- flow feature-spec family ----------------------------------------

    def install_feature_spec(self, model_id: int, spec) -> int:
        """Install (or hot-swap) the :class:`FeatureSpec` mapping flow-engine
        feature lanes onto ``model_id``'s input columns.  Returns the spec
        slot.

        Validate everything, prepare copies, commit under the lock with one
        version bump: a reinstall publishes a new mapping for the *next*
        raw batch and never adds a serving configuration.  The version bump
        orphans cached egress rows built under the old mapping.  A spec
        outlives ``remove()`` of its model (the mapping belongs to the Model
        ID); drop it with :meth:`remove_feature_spec`.
        """
        if not isinstance(spec, FeatureSpec):
            spec = FeatureSpec(columns=tuple(int(c) for c in spec))
        if not 0 <= int(model_id) < _N_MODEL_IDS:
            raise ValueError(f"model id {model_id} outside the 16-bit "
                             "Model ID field")
        if len(spec.columns) > self.max_width:
            raise ValueError(
                f"FeatureSpec has {len(spec.columns)} columns > "
                f"max_width={self.max_width} input lanes")
        with self._lock:
            # prepare-then-commit (same crash-safety contract as install())
            smap = self._spec_map
            rows, lens = self._spec_rows.copy(), self._spec_lens.copy()
            slot = int(smap[model_id])
            if slot < 0:  # the map only changes when a new slot is minted
                smap = smap.copy()
                slot = rows.shape[0]
                rows = np.concatenate(
                    [rows, np.full((1, self.max_width), -1, np.int32)])
                lens = np.concatenate([lens, np.zeros(1, np.int32)])
                smap[model_id] = slot
            rows[slot] = -1
            rows[slot, : len(spec.columns)] = spec.columns
            lens[slot] = len(spec.columns)
            self._fire_fault("install")
            # -- commit (atomic under the lock) --
            self._spec_map, self._spec_rows, self._spec_lens = \
                smap, rows, lens
            self._specs[model_id] = spec
            self._version += 1
            self._emit("install_feature_spec", model_id, slot=slot)
            return slot

    def remove_feature_spec(self, model_id: int) -> None:
        """Uninstall a feature spec; the model id falls back to the identity
        mapping (no-op if none installed)."""
        with self._lock:
            if self._specs.pop(model_id, None) is None:
                return
            self._spec_map = self._spec_map.copy()
            self._spec_map[model_id] = -1  # row slot retired (specs are tiny)
            self._version += 1
            self._emit("remove", model_id, family="spec")

    def feature_spec(self, model_id: int) -> Optional[FeatureSpec]:
        with self._lock:
            return self._specs.get(model_id)

    def feature_spec_rows(self, model_ids: np.ndarray, width: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized per-packet spec gather for the flow frontend: returns
        ``(cols, lens)`` with ``cols`` of shape ``(B, width)`` holding each
        packet's flow-feature lane per model input column (``-1`` = unused
        column, encoded as a zero code) and ``lens`` the declared feature
        counts.  Ids with no installed spec use the identity mapping over
        the first ``min(N_FLOW_FEATURES, width)`` lanes."""
        mids = np.asarray(model_ids, np.int64).reshape(-1)
        with self._lock:
            cache = self._spec_read_cache
            if cache is None or cache[0] != self._version:
                ident = np.full((1, self.max_width), -1, np.int32)
                k = min(N_FLOW_FEATURES, self.max_width)
                ident[0, :k] = np.arange(k, dtype=np.int32)
                cache = (self._version, self._spec_map,
                         np.concatenate([ident, self._spec_rows]),
                         np.concatenate([np.asarray([k], np.int32),
                                         self._spec_lens]))
                self._spec_read_cache = cache
        _, smap, rows_ext, lens_ext = cache
        slot = smap[mids] + 1  # 0 = the identity row
        w = min(width, rows_ext.shape[1])
        cols = rows_ext[slot][:, :w]
        if w < width:
            cols = np.concatenate(
                [cols, np.full((mids.shape[0], width - w), -1, np.int32)],
                axis=1)
        return cols, np.minimum(lens_ext[slot], width)

    # -- latency-SLO family ---------------------------------------------

    @staticmethod
    def _check_slo(budget_us) -> Optional[float]:
        """Validate an SLO budget before any table state is touched (the
        all-or-nothing install contract extends to a budget riding along)."""
        if budget_us is None:
            return None
        b = float(budget_us)
        if not (b > 0.0 and np.isfinite(b)):
            raise ValueError(
                f"slo_budget_us must be a positive finite microsecond "
                f"count, got {budget_us!r}")
        return b

    def _prep_slo(self, model_id: int, slo: Optional[float]):
        """Copy-on-write budget row for an install's prepare block (caller
        holds the lock; None when no budget rides this install)."""
        if slo is None:
            return None
        slo_us = self._slo_us.copy()
        slo_us[int(model_id)] = slo
        return slo_us

    def _commit_slo(self, model_id: int, slo, slo_us) -> None:
        if slo_us is None:
            return
        self._slo_us = slo_us
        self._slo_models[int(model_id)] = slo
        self._slo_any = True

    def install_slo_budget(self, model_id: int, budget_us: float) -> None:
        """Install (or hot-swap) ``model_id``'s latency budget in
        microseconds, under the same prepare-then-commit generation swap.
        The ingress deadline scheduler reads it per packet at staging time
        and ships a short batch rather than let the oldest packet's
        remaining budget drop below the measured dispatch cost.  Like a
        feature spec, the budget belongs to the Model ID: it may precede
        the model and it survives ``remove()``."""
        slo = self._check_slo(budget_us)
        if slo is None:
            raise ValueError(
                "budget_us is required (remove_slo_budget() clears one)")
        if not 0 <= int(model_id) < _N_MODEL_IDS:
            raise ValueError(f"model id {model_id} outside the 16-bit "
                             "Model ID field")
        with self._lock:
            slo_us = self._prep_slo(model_id, slo)
            self._fire_fault("install")
            # -- commit (atomic under the lock) --
            self._commit_slo(model_id, slo, slo_us)
            self._version += 1
            self._emit("install_slo", model_id, budget_us=slo)

    def remove_slo_budget(self, model_id: int) -> None:
        """Clear a model's latency budget (no-op if none installed)."""
        with self._lock:
            if self._slo_models.pop(int(model_id), None) is None:
                return
            self._slo_us = self._slo_us.copy()
            self._slo_us[int(model_id)] = np.inf
            self._version += 1
            self._emit("remove", model_id, family="slo")

    def slo_budget(self, model_id: int) -> float:
        """This model's latency budget in µs (inf when none installed)."""
        with self._lock:
            return float(self._slo_us[int(model_id) & 0xFFFF])

    def slo_budget_rows(self, model_ids: np.ndarray) -> np.ndarray:
        """Vectorized per-packet budget gather (µs, float64; inf = no
        budget).  Copy-on-write publishes make the grabbed array an
        immutable snapshot, so the gather runs outside the lock."""
        with self._lock:
            slo = self._slo_us
        return slo[np.asarray(model_ids, np.int64).reshape(-1)]

    @property
    def slo_active(self) -> bool:
        """True once any latency budget has ever been installed (monotone:
        the ingress deadline scheduler's cheap per-batch gate)."""
        return self._slo_any

    # -- reflex family ---------------------------------------------------

    def install_reflex(self, model_id: int, program) -> int:
        """Install (or hot-swap) ``model_id``'s reflex program — a
        vectorized threshold/vote rule (:class:`repro_torch.serve.
        ReflexProgram`) that answers on the host when the model lane would
        blow the packet's budget — packed into dense padded arrays under
        the same prepare-then-commit generation swap.  Returns the reflex
        slot.  The program is duck-read (``lanes``/``thresholds``/
        ``weights``/``bias``/``on_true``/``on_false``)."""
        lanes = np.asarray(program.lanes, np.int64).reshape(-1)
        thr = np.asarray(program.thresholds, np.int64).reshape(-1)
        wts = np.asarray(program.weights, np.int64).reshape(-1)
        bias = int(getattr(program, "bias", 0))
        on_true = np.asarray(program.on_true, np.int64).reshape(-1)
        on_false = np.asarray(program.on_false, np.int64).reshape(-1)
        if lanes.size == 0 or not (lanes.size == thr.size == wts.size):
            raise ValueError("reflex program needs equal-length, non-empty "
                             "lanes/thresholds/weights")
        if lanes.size > self.max_width:
            raise ValueError(f"reflex program has {lanes.size} terms > "
                             f"max_width={self.max_width}")
        if int(lanes.min()) < 0 or int(lanes.max()) >= self.max_width:
            raise ValueError(
                f"reflex lane outside [0, max_width={self.max_width})")
        if on_true.size == 0 or on_true.size != on_false.size \
                or on_true.size > self.max_width:
            raise ValueError("reflex output rows must be equal length in "
                             f"[1, max_width={self.max_width}]")
        i32 = np.iinfo(np.int32)
        for name, a in (("thresholds", thr), ("weights", wts),
                        ("on_true", on_true), ("on_false", on_false)):
            if int(a.min()) < i32.min or int(a.max()) > i32.max:
                raise ValueError(f"reflex {name} outside int32 code range")
        if not 0 <= int(model_id) < _N_MODEL_IDS:
            raise ValueError(f"model id {model_id} outside the 16-bit "
                             "Model ID field")
        with self._lock:
            # prepare-then-commit (same crash-safety contract as install())
            rmap = self._rx_map
            lane_t, thr_t = self._rx_lane.copy(), self._rx_thr.copy()
            w_t, bias_t = self._rx_w.copy(), self._rx_bias.copy()
            true_t, false_t = self._rx_true.copy(), self._rx_false.copy()
            od_t = self._rx_out_dim.copy()
            slot = int(rmap[model_id])
            if slot < 0:
                rmap = rmap.copy()
                slot = lane_t.shape[0]

                def _grow(a):
                    return np.concatenate(
                        [a, np.zeros((1,) + a.shape[1:], a.dtype)])
                lane_t, thr_t, w_t = _grow(lane_t), _grow(thr_t), _grow(w_t)
                bias_t = _grow(bias_t)
                true_t, false_t = _grow(true_t), _grow(false_t)
                od_t = _grow(od_t)
                rmap[model_id] = slot
            k, d = lanes.size, on_true.size
            # padding terms carry weight 0, so they never vote
            lane_t[slot] = 0
            thr_t[slot] = i32.max
            w_t[slot] = 0
            lane_t[slot, :k], thr_t[slot, :k], w_t[slot, :k] = lanes, thr, wts
            bias_t[slot] = bias
            true_t[slot] = 0
            false_t[slot] = 0
            true_t[slot, :d], false_t[slot, :d] = on_true, on_false
            od_t[slot] = d
            self._fire_fault("install")
            # -- commit (atomic under the lock) --
            self._rx_map = rmap
            self._rx_lane, self._rx_thr, self._rx_w = lane_t, thr_t, w_t
            self._rx_bias = bias_t
            self._rx_true, self._rx_false = true_t, false_t
            self._rx_out_dim = od_t
            self._rx_programs[int(model_id)] = program
            self._rx_any = True
            self._version += 1
            self._emit("install_reflex", model_id, slot=slot)
            return slot

    def remove_reflex(self, model_id: int) -> None:
        """Uninstall a reflex program; the model id falls back to the
        model lane alone (no-op if none installed)."""
        with self._lock:
            if self._rx_programs.pop(int(model_id), None) is None:
                return
            self._rx_map = self._rx_map.copy()
            self._rx_map[int(model_id)] = -1  # slot retired (programs tiny)
            self._version += 1
            self._emit("remove", model_id, family="reflex")

    def reflex_program(self, model_id: int):
        with self._lock:
            return self._rx_programs.get(int(model_id))

    def reflex_mask(self, model_ids: np.ndarray) -> np.ndarray:
        """Vectorized: True where a Model ID has a reflex program (the
        watermark controller's "can this packet take the reflex lane"
        check)."""
        with self._lock:
            rmap = self._rx_map
        return rmap[np.asarray(model_ids, np.int64).reshape(-1)] >= 0

    def reflex_evaluate(self, model_ids: np.ndarray, x0: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized reflex-lane evaluation.  For each packet whose Model
        ID has a program: ``votes = bias + Σ_k w_k·[x[lane_k] ≥ thr_k]``
        (int64); the output code row is ``on_true`` when votes ≥ 0 else
        ``on_false``.  Returns ``(mask, out)`` with ``out`` of shape
        ``(B, max_width)`` int32 (zero rows where ``mask`` is False).  Host
        numpy; the per-generation read cache makes the steady-state cost
        one map gather plus the term math."""
        mids = np.asarray(model_ids, np.int64).reshape(-1)
        with self._lock:
            cache = self._rx_read_cache
            if cache is None or cache[0] != self._version:
                cache = (self._version, self._rx_map, self._rx_lane,
                         self._rx_thr, self._rx_w, self._rx_bias,
                         self._rx_true, self._rx_false)
                self._rx_read_cache = cache
        _, rmap, lane, thr, w, bias, tr, fl = cache
        slot = rmap[mids]
        mask = slot >= 0
        out = np.zeros((mids.size, self.max_width), np.int32)
        if not mask.any():
            return mask, out
        s = slot[mask]
        x = np.asarray(x0)[mask]
        # lanes are validated < max_width at install; a narrower serving
        # width clamps (clamped padding terms carry weight 0 regardless)
        idx = np.minimum(lane[s], x.shape[1] - 1)
        terms = (np.take_along_axis(x, idx, axis=1) >= thr[s])
        votes = bias[s] + np.einsum("bk,bk->b", w[s].astype(np.int64),
                                    terms.astype(np.int64))
        out[mask] = np.where((votes >= 0)[:, None], tr[s], fl[s])
        return mask, out

    @property
    def reflex_active(self) -> bool:
        """True once any reflex program has ever been installed (monotone:
        the ingress watermark controller's cheap gate)."""
        return self._rx_any

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

    def invalidate_snapshot(self) -> None:
        """Drop every cached device snapshot (MLP, forest and range), so the
        next ``tables()``, ``forest_tables()`` or ``range_tables()`` call
        uploads from the host buffers again.  Normal operation never needs
        it (the family counters invalidate a snapshot on every write); it
        forces a fresh transfer for benchmarks and tests."""
        with self._lock:
            self._snapshot.clear()
            self._forest_snapshot.clear()
            self._range_snapshot.clear()

    @property
    def version(self) -> int:
        """Table generation — bumped by every install/remove swap."""
        return self._version

    def table_bytes(self) -> int:
        """Bytes of the host tables the data plane reads: the MLP and forest
        families, and the range tables where the plane has them."""
        bufs = [self._w, self._b, self._act, self._layer_on, self._out_dim,
                self._id_map, self._f_nodes, self._f_tree_on, self._f_mode,
                self._f_out_dim, self._f_id_map]
        if self.range_available:
            bufs += [self._r_feat, self._r_th, self._r_mask, self._r_payload]
        return sum(t.numel() * t.element_size() for t in bufs)


def tree_structure(tree):
    """The structure of a tree of dicts, lists and tuples, in place of
    JAX's treedef: each dict's (sorted) keys, each sequence's type and
    arity, leaves as ``None``."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k]))
                              for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(tree_structure(v) for v in tree))
    return None


class WeightRegistry:
    """LM-scale control plane: named parameter trees with hot-swap.

    Counterpart of ``repro.core.control_plane.WeightRegistry``.  Installing
    a checkpoint of the same structure swaps it in; the server's serving
    configurations stay as they were.  A structure change (other key paths,
    or a ``(codes, scale)`` pair where a tensor was) raises.  The codes of
    installed ``(codes, scale)`` pairs are stored K-major
    (``core.quantize.k_major``), the layout the card's GEMM reads.
    """

    def __init__(self):
        self._models: Dict[str, object] = {}
        self._structs: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.swaps = 0

    def install(self, name: str, params) -> None:
        from .quantize import k_major_pairs  # quantize → inference → here
        params = k_major_pairs(params)
        with self._lock:
            struct = tree_structure(params)
            if name in self._structs and struct != self._structs[name]:
                raise ValueError(
                    f"hot-swap for '{name}' changed parameter structure; "
                    "a structure change is a data-plane re-synthesis")
            self._models[name] = params
            self._structs[name] = struct
            self.swaps += 1

    def get(self, name: str):
        with self._lock:
            return self._models[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)
