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
traversal kernel (range table or pointer chase).  Raw 5-tuple headers
enter through :meth:`PacketServer.submit_raw`: the flow engine
(``repro_torch.flow``) resolves each packet's flow, updates its registers
with the flow-update kernel and builds each model's inputs from its
FeatureSpec.  Egress rows come back in exact submission order,
byte-identical to the reference's.  Per-model latency budgets
(:meth:`PacketServer.install_slo_budget`) drive the ingress deadline
scheduler, and reflex programs (:meth:`PacketServer.install_reflex`)
answer packets past the queue's high watermark on the host, confirmed
asynchronously on the model lane.  The drift monitor, the shadow lane and
the ``slo:submit_p99`` health rule are constructor options.

:class:`~repro_torch.serve.ShardedPacketServer` (re-exported here) is the
N-shard fabric with the same surface, and :func:`main` the operator CLI
(``python -m repro_torch.launch.serve``).

:class:`LMServer` is the LM-scale counterpart: a batched decode loop over
a model from ``repro_torch.models`` with control-plane weight hot-swap
(``core.control_plane.WeightRegistry``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.control_plane import ControlPlane, WeightRegistry
from ..core.inference import DataPlaneEngine, DeviceResult, resolve_device
from ..core.ingress import BatchError, IngressPipeline
from ..core.packet import HEADER_BYTES
from ..models.api import build_model
from ..obs import Observability
from ..obs.trace import FLOW_PARSE
from ..serve import ShardedPacketServer

if TYPE_CHECKING:
    from ..flow import FlowFrontend

__all__ = ["PacketServer", "ShardedPacketServer", "LMServer", "BatchError"]


class PacketServer:
    """Deployment wrapper: ControlPlane + DataPlaneEngine + ingress pipeline.

    Three serving surfaces:

      * **raw-packet API** — ``submit_raw()`` accepts raw 5-tuple header
        batches: the flow engine resolves each packet's flow, updates its
        registers (counters, EWMAs, count-min sketch) and builds each
        model's input columns from its installed FeatureSpec before handing
        the rows to the stream path below.
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
    ``flow_capacity_pow2`` and ``flow_idle_timeout`` size and age the flow
    table; ``strict_model_ids=True`` turns raw rows whose Model ID is not
    installed into per-packet error slots.  ``queue_capacity`` and
    ``queue_high_watermark`` bound the model lane's queue (past the
    watermark, packets of a model with a reflex program answer on the
    reflex lane; past the capacity, packets shed).  ``drift_window``,
    ``drift_lanes`` and ``psi_threshold`` turn on the drift monitor,
    ``shadow_model``/``shadow_every`` shadow-score a packet sample against
    another model, and ``slo_budget`` (seconds) adds the
    ``slo:submit_p99`` health rule over the submit latency.
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
                 flow_capacity_pow2: int = 14,
                 flow_idle_timeout: Optional[int] = None,
                 strict_model_ids: bool = False,
                 queue_capacity: Optional[int] = None,
                 queue_high_watermark: Optional[int] = None,
                 max_retries: int = 2, retry_backoff: float = 0.0,
                 clock=None, obs=None, trace_every: int = 0,
                 drift_window: int = 0, drift_lanes: int = 8,
                 psi_threshold: float = 0.25,
                 shadow_model: Optional[int] = None, shadow_every: int = 8,
                 slo_budget: Optional[float] = None,
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
            clock=clock, queue_capacity=queue_capacity,
            queue_high_watermark=queue_high_watermark, obs=obs)
        self.control_plane.events = obs.events
        # -- model-quality plane: drift taps + shadow lane + SLO ----------
        obs.enable_quality_plane(
            self.control_plane, [self.ingress], drift_window=drift_window,
            drift_lanes=drift_lanes, psi_threshold=psi_threshold,
            shadow_model=shadow_model, shadow_every=shadow_every,
            slo_budget=slo_budget, slo_rule="slo:submit_p99",
            submit_p99=lambda: (self._submit_h.percentile(99.0)
                                if self._submit_h.count else None))
        self._submit_h = (None if slo_budget is None else
                          obs.registry.histogram("server_submit_seconds"))
        self.max_inflight = max_inflight
        self.strict_model_ids = strict_model_ids
        self._inflight: deque = deque()
        self._window_t0: Optional[float] = None
        # flow engine (stage 0): created on first use so feature-vector
        # deployments never allocate the register file
        self._flow_capacity_pow2 = flow_capacity_pow2
        self._flow_idle_timeout = flow_idle_timeout
        self._flow: Optional["FlowFrontend"] = None

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

    # -- raw-packet ingress (stateful flow engine, stage 0) ----------------

    @property
    def flow(self) -> "FlowFrontend":
        """The stateful flow engine (:class:`repro_torch.flow.FlowFrontend`),
        created on first use; its counters and a ``flow_occupancy`` gauge
        join the server's metrics registry."""
        if self._flow is None:
            from ..flow import FlowFrontend
            flow = FlowFrontend(self.ingress,
                                capacity_pow2=self._flow_capacity_pow2,
                                idle_timeout=self._flow_idle_timeout)
            reg = self.obs.registry
            for name, cell in flow.table.stats.cells():
                reg.attach(name, cell)
            for name, cell in flow.stats.cells():
                reg.attach(name, cell)
            g_occ = reg.gauge("flow_occupancy")
            reg.register_collector(lambda: g_occ.set(len(flow.table)))
            self._flow = flow
        return self._flow

    def install_feature_spec(self, model_id: int, columns) -> int:
        """Install (hot-swap) the flow-feature → input-column mapping for a
        model (:class:`~repro_torch.core.control_plane.FeatureSpec`).
        Applies from the next ``submit_raw()`` batch; adds no serving
        configuration."""
        return self.control_plane.install_feature_spec(model_id, columns)

    def install_slo_budget(self, model_id: int, budget_us: float) -> int:
        """Install (hot-swap) a model's per-packet latency budget: the
        deadline-aware batch closer ships a short batch rather than let a
        staged packet's remaining budget drop below the measured dispatch
        cost."""
        return self.control_plane.install_slo_budget(model_id, budget_us)

    def install_reflex(self, model_id: int, program) -> int:
        """Install (hot-swap) a model's reflex fallback program
        (:class:`~repro_torch.serve.reflex.ReflexProgram`) and attach the
        asynchronous model-lane confirmer, so ``reflex_agreement`` is
        measured."""
        gen = self.control_plane.install_reflex(model_id, program)
        if self.ingress.reflex_confirm is None:
            from ..serve.reflex import ReflexConfirmer
            self.ingress.reflex_confirm = ReflexConfirmer(self.ingress)
        return gen

    def remove_reflex(self, model_id: int) -> None:
        self.control_plane.remove_reflex(model_id)

    def submit_raw(self, raw) -> tuple:
        """Feed one batch of **raw 5-tuple headers**
        (``repro_torch.data.packets.RAW_HEADER_BYTES``-byte rows) through
        the flow engine: per-flow register update → feature extraction →
        per-model FeatureSpec gather → the ingress pipeline.  Returns
        ``(first_ticket, n_packets)``; results arrive via
        :meth:`drain_packets` in submission order, interleaving freely with
        :meth:`submit_packets` chunks.

        Rows that fail admission — truncated/oversized headers, a
        wrong-width batch, or (with ``strict_model_ids=True``) a Model ID
        not currently installed — never touch flow state and resolve as
        per-packet :class:`~repro_torch.core.ingress.PacketError` slots at
        their submission-order positions
        (:func:`repro_torch.data.packets.validate_raw_rows`)."""
        stages = self.ingress.stages
        d = stages.enter()
        try:
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            from ..data.packets import validate_raw_rows
            known = (self.control_plane.installed_ids()
                     if self.strict_model_ids else None)
            k = stages.push(FLOW_PARSE)
            rows, bad, reasons = validate_raw_rows(raw, known_model_ids=known)
            stages.leave(k)
            t0 = time.perf_counter() if self._submit_h is not None else 0.0
            try:
                if bad is None:
                    return self.flow.submit_raw(rows)
                return self.flow.submit_raw(rows, drop_mask=bad,
                                            drop_reason=reasons)
            finally:
                if self._submit_h is not None:
                    self._submit_h.observe(time.perf_counter() - t0)
        finally:
            stages.leave(d)

    # -- streaming ingress (coalescing queue + duplicate cache) ------------

    def submit_packets(self, packets) -> tuple:
        """Feed one ragged per-connection chunk into the ingress pipeline.
        Returns ``(first_ticket, n_packets)``; results arrive in submission
        order via :meth:`drain_packets`."""
        stages = self.ingress.stages
        d = stages.enter()
        try:
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            if self._submit_h is None:
                return self.ingress.submit(packets)
            t0 = time.perf_counter()
            try:
                return self.ingress.submit(packets)
            finally:
                self._submit_h.observe(time.perf_counter() - t0)
        finally:
            stages.leave(d)

    def drain_packets(self, timeout_us: Optional[float] = None) -> list:
        """Flush the pipeline and return one entry per submitted packet in
        submission order: an egress row (``np.ndarray``) or a
        :class:`~repro_torch.core.ingress.PacketError` slot.
        ``timeout_us`` bounds the drain: unresolved tickets backfill as
        ``PacketError(DRAIN_TIMEOUT)`` instead of waiting on a wedged
        device."""
        stages = self.ingress.stages
        d = stages.enter()
        try:
            out = self.ingress.drain(timeout_us)
            self._close_window()
            if self.obs.health is not None:
                # step alert rules once per drain window (drift rules also
                # step on the monitor's own window cadence)
                self.obs.health.evaluate()
            return out
        finally:
            stages.leave(d)

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
        out = {"packets_per_s": self.engine.packets_per_second(),
               "throughput_gbps": self.engine.throughput_gbps(),
               "recompiles": self.engine.trace_count,
               "table_generation": self.control_plane.version,
               "cache_hit_rate": self.ingress.cache_hit_rate(),
               "cache_entries": (len(self.ingress.cache)
                                 if self.ingress.cache is not None else 0)}
        if self._flow is not None:
            out["flow_table_hit_rate"] = self._flow.flow_table_hit_rate()
            out["flows"] = len(self._flow.table)
        return out


def _leaf_signature(tree, path: str = "") -> tuple:
    """Key paths with each tensor's shape and dtype: what a compiled decode
    step would be specialised on."""
    if isinstance(tree, dict):
        return tuple(x for k in sorted(tree)
                     for x in _leaf_signature(tree[k], f"{path}[{k!r}]"))
    if isinstance(tree, (list, tuple)):
        return ((path, type(tree).__name__, len(tree)),) + tuple(
            x for i, v in enumerate(tree)
            for x in _leaf_signature(v, f"{path}[{i}]"))
    return ((path, tuple(tree.shape), tree.dtype),)


class LMServer:
    """Batched LM decode loop with control-plane weight hot-swap.

    Counterpart of ``repro.launch.serve.LMServer``.  The prompt and the new
    tokens go through ``decode_step`` one position at a time, as in the
    reference.  ``install()`` swaps checkpoints of the same structure
    without changing the serving configuration: ``trace_count`` counts the
    distinct static configurations used (batch, max_seq, dtype and the
    installed parameters' key paths, shapes and dtypes), as the reference's
    jit retrace count does.

    ``device`` is the card by default; construction raises when there is
    none.  Greedy decoding (``temperature=0``) follows the reference token
    for token.  With ``temperature > 0`` tokens are sampled with a
    ``torch.Generator`` seeded from ``seed``, which cannot reproduce
    ``jax.random.categorical``'s draws.
    """

    def __init__(self, cfg, *, batch: int = 8, max_seq: int = 256,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg, device=self.device)
        self.registry = WeightRegistry()
        self.batch = batch
        self.max_seq = max_seq
        self.trace_count = 0
        self._configs: set = set()
        self.stats = {"tokens": 0, "seconds": 0.0}

    def install(self, name: str, params) -> None:
        self.registry.install(name, params)

    def new_session(self):
        return self.model.init_caches(self.batch, self.max_seq)

    def _note_config(self, params) -> None:
        key = (self.batch, self.max_seq, self.cfg.dtype,
               _leaf_signature(params))
        if key not in self._configs:
            self._configs.add(key)
            self.trace_count += 1

    def generate(self, name: str, prompt_tokens: np.ndarray, n_tokens: int,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Greedy/temperature decode of ``n_tokens`` past the prompt;
        returns the new tokens, (batch, n_tokens) int32."""
        params = self.registry.get(name)
        self._note_config(params)
        caches = self.new_session()
        b, prompt_len = prompt_tokens.shape
        if b != self.batch:
            raise ValueError(f"prompt batch {b} != server batch {self.batch}")
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = torch.as_tensor(np.asarray(prompt_tokens, np.int32),
                               device=self.device)
        out = []
        t0 = time.perf_counter()
        cur = toks[:, :1]
        for t in range(prompt_len + n_tokens - 1):
            pos = torch.full((b,), t, dtype=torch.int32, device=self.device)
            logits, caches = self.model.decode_step(params, caches, cur, pos)
            if t + 1 < prompt_len:
                cur = toks[:, t + 1: t + 2]
                continue
            last = logits[:, -1].to(torch.float32)
            if gen is not None:
                probs = torch.softmax(last / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            cur = nxt[:, None].to(torch.int32)
            out.append(cur[:, 0])
        tokens = torch.stack(out, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["tokens"] += b * (prompt_len + n_tokens - 1)
        self.stats["seconds"] += dt
        return tokens

    def tokens_per_second(self) -> float:
        s = self.stats
        return s["tokens"] / s["seconds"] if s["seconds"] else 0.0


def main(argv=None) -> int:
    """``python -m repro_torch.launch.serve`` — drive a synthetic raw-header
    trace through a (possibly sharded) server and export the telemetry
    snapshot.  ``--metrics-json`` writes the snapshot as JSON and
    ``--prometheus`` prints the text exposition.  The server runs on the
    card unless ``--device cpu`` is given."""
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="serve a synthetic raw trace; export telemetry")
    p.add_argument("--packets", type=int, default=4096,
                   help="total raw packets to serve (default 4096)")
    p.add_argument("--shards", type=int, default=1,
                   help="1 = PacketServer, >1 = ShardedPacketServer")
    p.add_argument("--flows", type=int, default=64,
                   help="synthetic flow count (default 64)")
    p.add_argument("--chunk", type=int, default=512,
                   help="submit chunk size (default 512)")
    p.add_argument("--trace-every", type=int, default=0,
                   help="sample 1-in-N packet lifecycles (0 = off)")
    p.add_argument("--drift-window", type=int, default=0,
                   help="enable the drift monitor with this window size "
                        "(feature rows per model; 0 = off)")
    p.add_argument("--shadow-model", type=int, default=None,
                   help="shadow-score a deterministic packet sample "
                        "against this Model ID (installs a copy of the "
                        "primary under that id)")
    p.add_argument("--metrics-json", metavar="PATH", default=None,
                   help="write the observability snapshot as JSON")
    p.add_argument("--prometheus", action="store_true",
                   help="print the Prometheus text exposition to stdout")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to serve on (default cuda; cpu for the "
                        "host)")
    args = p.parse_args(argv)

    from ..data.packets import raw_trace

    width = 16
    kw: Dict[str, Any] = dict(
        max_models=4, max_width=width, ingress_batch=256, max_inflight=2,
        flow_capacity_pow2=12, trace_every=args.trace_every,
        drift_window=args.drift_window, shadow_model=args.shadow_model,
        device=args.device)
    if args.shards > 1:
        srv: Any = ShardedPacketServer(n_shards=args.shards, **kw)
    else:
        srv = PacketServer(**kw)
    rng = np.random.default_rng(args.seed)
    r = np.random.default_rng(args.seed + 1)
    w1 = r.normal(size=(width, width)).astype(np.float32) * 0.3
    w2 = r.normal(size=(width, 4)).astype(np.float32) * 0.3
    layers = [(w1, np.zeros(width, np.float32)),
              (w2, np.zeros(4, np.float32))]
    srv.install(1, layers, ["relu"], final_activation="sigmoid")
    srv.install_feature_spec(1, (2, 3, 4, 5) * (width // 4))
    if args.shadow_model is not None:
        # identical copy — the shadow lane should report full agreement
        srv.install(args.shadow_model, layers, ["relu"],
                    final_activation="sigmoid")

    raw = raw_trace(rng, args.packets, n_flows=args.flows,
                    model_ids=(1,), pattern="mixed")
    t0 = time.perf_counter()
    for i in range(0, raw.shape[0], args.chunk):
        srv.submit_raw(raw[i: i + args.chunk])
    out = srv.drain_packets()
    dt = time.perf_counter() - t0
    n_err = sum(1 for o in out if not isinstance(o, np.ndarray))

    snap = srv.obs.snapshot()
    snap["run"] = {"packets": int(raw.shape[0]), "errors": int(n_err),
                   "seconds": dt, "packets_per_s": raw.shape[0] / dt,
                   "shards": args.shards, "device": str(args.device)}
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True, default=str)
    if args.prometheus:
        print(srv.obs.to_prometheus_text(), end="")
    print(f"served {raw.shape[0]} packets on {args.shards} shard(s) "
          f"({args.device}) in {dt * 1e3:.1f} ms "
          f"({raw.shape[0] / dt:,.0f} pkt/s), {n_err} error slots"
          + (f"; metrics -> {args.metrics_json}"
             if args.metrics_json else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
