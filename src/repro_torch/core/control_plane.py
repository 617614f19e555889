"""Control-plane weight tables (paper §2, §3 item 3, Fig 2), MLP family.

Model parameters (weights, biases, activation opcodes) live in control-plane
tables, so a model can be retrained and re-installed at runtime without
rebuilding the data plane.  In the port the data plane is the engine's
kernel launch: every table is a device pointer argument, never a compiled-in
constant, so ``install()`` only publishes new buffers.

Counterpart of ``repro.core.control_plane.ControlPlane`` for the MLP family:
the same quantization (bit-identical host tables after the same install
sequence), slot recycling, prepare-then-commit generation swap, ``version``,
event and fault hooks, and a per-(generation, device) snapshot cache that
uploads with ``torch.as_tensor(..., device=)``.  The forest, feature-spec,
SLO and reflex families arrive with their slices; until then their
``*_active`` latches read ``False``.
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
    "ControlPlane",
    "tables_from_numpy",
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


def tables_from_numpy(w, b, act, layer_on, out_dim, id_map,
                      device="cpu") -> ModelTables:
    """Build :class:`ModelTables` on ``device`` from host arrays in the
    control plane's layout — e.g. the reference control plane's tables."""
    def put(a, dtype=None):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    return ModelTables(w=put(w), b=put(b, np.int32), act=put(act, np.int32),
                       layer_on=put(layer_on, np.int32),
                       out_dim=put(out_dim, np.int32),
                       id_map=put(id_map, np.int32))


class ControlPlane:
    """Host-side registry that owns and mutates the MLP tables.

    ``frac_bits`` is shared by features and weights.  Installs are
    double-buffered: a writer prepares private copies of the live host
    tables and swaps them in under the lock, bumping the generation.
    ``tables(device)`` returns a snapshot cached per (generation, device),
    so a batch in flight keeps the old buffers and steady-state serving
    re-uploads nothing.
    """

    def __init__(self, *, max_models: int = 16, max_layers: int = 4,
                 max_width: int = 32, weight_bits: int = 16,
                 frac_bits: int = 8):
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
        self._version = 0
        self._mlp_gen = 0
        # per-device snapshot cache: device → (mlp generation, tables)
        self._snapshot: Dict[torch.device, Tuple[int, ModelTables]] = {}

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
        """Model ids currently installed."""
        with self._lock:
            return frozenset(self._slots)

    def remove(self, model_id: int) -> None:
        """Uninstall a model (no-op if it is not installed)."""
        with self._lock:
            slot = self._slots.pop(model_id, None)
            if slot is None:
                return
            # copy-on-write: published snapshots keep their buffers
            self._id_map = self._id_map.clone()
            self._layer_on = self._layer_on.clone()
            self._id_map[model_id] = -1
            self._layer_on[slot] = 0
            self._free_slots.append(slot)
            self._mlp_gen += 1
            self._version += 1
            self._emit("remove", model_id, family="mlp")

    # -- latches of the families still to port ----------------------------

    @property
    def forest_active(self) -> bool:
        """True once a forest was ever installed; always False until the
        forest family is ported."""
        return False

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

    def tables(self, device="cpu") -> ModelTables:
        """Snapshot of the current table generation on ``device``, cached
        until the next write bumps the generation (one cache entry per
        device).  In-flight batches holding an older snapshot keep their
        buffers alive.  On the CPU the snapshot is the host tables
        themselves, which writers replace and never mutate."""
        device = torch.device(device)
        with self._lock:
            snap = self._snapshot.get(device)
            if snap is None or snap[0] != self._mlp_gen:
                def put(t):
                    return torch.as_tensor(t, device=device).contiguous()
                snap = (self._mlp_gen, ModelTables(
                    w=put(self._w), b=put(self._b), act=put(self._act),
                    layer_on=put(self._layer_on), out_dim=put(self._out_dim),
                    id_map=put(self._id_map)))
                self._snapshot[device] = snap
            return snap[1]

    @property
    def version(self) -> int:
        """Table generation — bumped by every install/remove swap."""
        return self._version
