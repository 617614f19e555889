"""The packet-serving driver: the paper's in-network data plane processing
encapsulated feature packets against control-plane tables, with weight
hot-swap that never rebuilds anything.

Counterpart of ``repro.launch.serve.PacketServer`` (MLP and tree-ensemble
surfaces).  Serving runs through the ingress pipeline (``core/ingress.py``):
ragged per-connection chunks are coalesced into fixed-shape mixed-model
batches, byte-identical duplicates short-circuit through a
generation-aware result cache, and each batch is one launch of the fused
MLP kernel on the card.  With tree ensembles installed
(:meth:`PacketServer.install_forest`), MLP- and forest-family packets stage
into lane-pure batches, and a forest batch is one launch of the forest
traversal kernel (range table or pointer chase).  Egress rows come back in
exact submission order, byte-identical to the reference's.  The raw-packet
flow engine, SLO budgets and reflex programs arrive with their slices.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core.control_plane import ControlPlane
from ..core.inference import DataPlaneEngine, DeviceResult
from ..core.ingress import BatchError, IngressPipeline
from ..core.packet import HEADER_BYTES
from ..obs import Observability

__all__ = ["PacketServer", "BatchError"]


class PacketServer:
    """Deployment wrapper: ControlPlane + DataPlaneEngine + ingress pipeline.

    Two serving surfaces:

      * **stream API** — ``submit_packets()`` accepts ragged per-connection
        chunks; ``drain_packets()`` returns per-packet egress rows (or
        per-packet error slots) in exact submission order: coalescing queue
        → duplicate cache → fused kernel → deparse.  With forests installed
        the queue stages MLP- and forest-family packets into lane-pure
        batches.
      * **batch API** — ``submit_async()``/``drain()`` dispatch
        caller-formed wire batches with up to ``max_inflight`` results
        outstanding; a batch failing validation occupies a
        :class:`~repro_torch.core.ingress.BatchError` slot in the drain.

    ``device`` is the card by default; construction raises when there is
    none.  Pass ``device="cpu"`` to serve on the CPU.  ``forest_variant``
    (``"auto"``, ``"chase"`` or ``"range"``) picks the forest traversal;
    ``"auto"`` is the range form on the card and the chase on the CPU.
    """

    def __init__(self, *, max_models: int = 16, max_layers: int = 4,
                 max_width: int = 32, frac_bits: int = 8,
                 weight_bits: int = 16, taylor_order: int = 3,
                 kernel_variant: str = "int16",
                 forest_variant: str = "auto",
                 max_inflight: int = 8, ingress_batch: int = 2048,
                 use_cache: bool = True, cache_capacity_pow2: int = 16,
                 max_forests: int = 8, max_trees: int = 16,
                 max_nodes: int = 64, max_tree_depth: int = 6,
                 flush_after: Optional[float] = None,
                 adaptive_batch: bool = False,
                 queue_capacity: Optional[int] = None,
                 max_retries: int = 2, retry_backoff: float = 0.0,
                 clock=None, obs=None, trace_every: int = 0,
                 device="cuda"):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if obs is None:
            obs = Observability(clock=clock, trace_every=trace_every)
        self.obs = obs
        self.control_plane = ControlPlane(
            max_models=max_models, max_layers=max_layers,
            max_width=max_width, weight_bits=weight_bits,
            frac_bits=frac_bits, max_forests=max_forests,
            max_trees=max_trees, max_nodes=max_nodes,
            max_tree_depth=max_tree_depth)
        self.engine = DataPlaneEngine(self.control_plane,
                                      max_features=max_width,
                                      taylor_order=taylor_order,
                                      kernel_variant=kernel_variant,
                                      forest_variant=forest_variant,
                                      device=device)
        # the pipeline pools max_inflight+2 staging buffers of
        # ingress_batch feature rows each
        self.ingress = IngressPipeline(
            self.engine, batch_size=ingress_batch,
            max_inflight=max_inflight, use_cache=use_cache,
            cache_capacity_pow2=cache_capacity_pow2,
            flush_after=flush_after, adaptive_batch=adaptive_batch,
            max_retries=max_retries, retry_backoff=retry_backoff,
            clock=clock, queue_capacity=queue_capacity, obs=obs)
        self.control_plane.events = obs.events
        self.max_inflight = max_inflight
        self._inflight: deque = deque()
        self._window_t0: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def install(self, model_id: int, layers, activations, **kw) -> int:
        """Quantize + install (hot-swap) a model — safe mid-serving: the new
        table generation applies from the next dispatched batch, nothing is
        rebuilt, in-flight batches keep the old tables, and the bumped
        generation orphans every cached egress row."""
        return self.control_plane.install(model_id, layers, activations, **kw)

    def install_forest(self, model_id: int, forest) -> int:
        """Quantize + install (hot-swap) a tree ensemble
        (:class:`repro_torch.forest.Forest` or ``PackedForest``) — the same
        mid-serving safety and cache-invalidation contract as
        :meth:`install`: one generation counter covers both families."""
        return self.control_plane.install_forest(model_id, forest)

    def remove(self, model_id: int) -> None:
        """Uninstall a model of either family and drop its cached egress
        rows."""
        self.control_plane.remove(model_id)
        self.ingress.on_model_removed(model_id)

    def process(self, packets) -> DeviceResult:
        """Synchronous single-batch wire path (blocks until egress is
        ready).  Closes any open async window first so its wall-clock is
        credited once."""
        if self._window_t0 is not None:
            self.drain()
        return self.engine.process(packets)

    # -- streaming ingress (coalescing queue + duplicate cache) ------------

    def submit_packets(self, packets) -> tuple:
        """Feed one ragged per-connection chunk into the ingress pipeline.
        Returns ``(first_ticket, n_packets)``; results arrive in submission
        order via :meth:`drain_packets`."""
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        return self.ingress.submit(packets)

    def drain_packets(self, timeout_us: Optional[float] = None) -> list:
        """Flush the pipeline and return one entry per submitted packet in
        submission order: an egress row (``np.ndarray``) or a
        :class:`~repro_torch.core.ingress.PacketError` slot.
        ``timeout_us`` bounds the drain."""
        out = self.ingress.drain(timeout_us)
        self._close_window()
        return out

    def _close_window(self) -> None:
        if self._window_t0 is not None:
            self.engine.add_seconds(time.perf_counter() - self._window_t0)
            self._window_t0 = None

    # -- async serving loop (batch-level API) ------------------------------

    @staticmethod
    def _validate_batch(packets):
        """Shape/dtype validation that never reads a device tensor's data.
        Returns the batch in a form ``engine.run`` accepts."""
        if isinstance(packets, torch.Tensor):
            shape, is_int = tuple(packets.shape), not (
                packets.is_floating_point() or packets.is_complex()
                or packets.dtype == torch.bool)
            dtype = packets.dtype
        else:
            packets = np.asarray(packets)  # list-of-lists etc.; may raise
            shape, dtype = packets.shape, packets.dtype
            is_int = np.issubdtype(dtype, np.integer)
        if len(shape) != 2:
            raise ValueError(
                f"packet batch must be 2-D (n_packets, wire_len), "
                f"got shape {tuple(shape)}")
        if shape[1] < HEADER_BYTES:
            raise ValueError(
                f"wire length {shape[1]} shorter than the "
                f"{HEADER_BYTES}-byte encapsulation header")
        if dtype not in (np.uint8, torch.uint8):
            if not is_int:
                raise ValueError(f"packet bytes must be integer, "
                                 f"got dtype {dtype}")
            # host arrays get a cheap range check; device tensors keep the
            # engine's modular uint8 cast
            if isinstance(packets, np.ndarray) and packets.size \
                    and (packets.min() < 0 or packets.max() > 255):
                raise ValueError("packet byte values outside [0, 255]")
        return packets

    def submit_async(self, packets) -> Union[DeviceResult, BatchError]:
        """Dispatch one ingress batch without blocking; returns its
        :class:`DeviceResult`.  With ``max_inflight`` batches pending, the
        oldest is retired first.  A batch that fails validation is rejected
        in place: a :class:`BatchError` occupies its submission-order slot
        and is returned."""
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        try:
            arr = self._validate_batch(packets)
        except (ValueError, TypeError) as e:
            shape = getattr(packets, "shape", None)
            n = int(shape[0]) if shape is not None and len(shape) == 2 else 0
            err = BatchError(reason=str(e), n_packets=n)
            self._inflight.append(err)
            self._prune_error_slots()
            return err
        while self._count_pending() >= self.max_inflight:
            self._retire_one()
        out = self.engine.run(arr, block=False)
        self._inflight.append(out)
        return out

    _MAX_ERROR_SLOTS = 1024

    def _prune_error_slots(self) -> None:
        n_err = sum(1 for o in self._inflight if isinstance(o, BatchError))
        i = 0
        while n_err > self._MAX_ERROR_SLOTS and i < len(self._inflight):
            if isinstance(self._inflight[i], BatchError):
                del self._inflight[i]
                n_err -= 1
            else:
                i += 1

    def _count_pending(self) -> int:
        return sum(1 for o in self._inflight if not isinstance(o, BatchError))

    def _retire_one(self) -> None:
        """Block on the oldest pending result (error slots stay queued)."""
        for i, o in enumerate(self._inflight):
            if not isinstance(o, BatchError):
                o.block_until_ready()
                del self._inflight[i]
                return

    def drain(self) -> List[Union[DeviceResult, BatchError]]:
        """Block until every in-flight batch has retired; credit the
        submit→drain window's wall-clock to the engine.  Returns the entries
        still in flight in submission order."""
        outs = list(self._inflight)
        self._inflight.clear()
        for o in outs:
            if not isinstance(o, BatchError):
                o.block_until_ready()
        self._close_window()
        return outs

    def stats(self) -> Dict[str, float]:
        return {"packets_per_s": self.engine.packets_per_second(),
                "throughput_gbps": self.engine.throughput_gbps(),
                "recompiles": self.engine.trace_count,
                "table_generation": self.control_plane.version,
                "cache_hit_rate": self.ingress.cache_hit_rate(),
                "cache_entries": (len(self.ingress.cache)
                                  if self.ingress.cache is not None else 0)}
