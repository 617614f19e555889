"""Sharded serving fabric: N data-plane shards behind one RSS dispatcher.

Counterpart of ``repro.serve.fabric``.  The single-engine
:class:`~repro_torch.launch.serve.PacketServer` is the paper's deployment
shape — one NIC, one register file, one serving pipeline.  A
:class:`ShardedPacketServer` owns N complete shard stacks
(``DataPlaneEngine`` + ``IngressPipeline`` + ``FlowFrontend``), places each
on a device (:func:`repro_torch.launch.mesh.shard_devices`: round robin
over the cards, so on a one-card host every shard shares ``cuda:0``, and
every shard on the CPU with ``device="cpu"``), and routes traffic the way
receive-side scaling does on real NICs:

* **flow affinity** — raw packets are dispatched by a hash of the 5-tuple
  (``shard = key_hash mod N``), so every packet of a flow lands on exactly
  one shard.  That shard's :class:`~repro_torch.flow.table.FlowTable` owns
  the flow's registers: per-flow state needs no cross-shard coherence, and
  because a flow's register trajectory depends only on its own packets
  (relative order preserved by the dispatch slicing), the per-packet
  features are bit-exact with single-shard serving.
* **one global sketch** — heavy-hitter counts are a whole-fabric property,
  and per-shard sketches would diverge from N=1 whenever flows on
  different shards collide in a cell.  The dispatcher computes the
  count-min estimates globally (:func:`repro_torch.kernels.flow_update.
  cms_estimate_update`, over the whole arrival batch in original order,
  against one fabric-owned sketch) and rides them into each shard through
  ``extract()``'s ``cms_est_q`` override.  Each shard's flow kernel still
  updates that shard's own sketch; only the feature lane changes.
* **round-robin for stateless traffic** — ``submit_packets()`` chunks
  carry no flow state, so whole chunks round-robin across alive shards.
* **global-order egress** — every submit records how its packets were
  scattered; ``drain_packets()`` drains all shards and interleaves their
  (shard-ordered) results back into exact global submission order.
* **cross-shard generation fence** — all shards share ONE
  :class:`~repro_torch.core.control_plane.ControlPlane` (its single
  ``version`` counter is the fence), and every fabric operation — submits,
  drains, installs — serializes on the fabric lock, so an ``install()``
  lands entirely between arrival batches.  Shards on one device share one
  snapshot upload per table generation (the control plane caches per
  (family generation, device)), and installs add no serving configuration
  on any shard.

N=1 degenerates to the single-engine behavior (same values, same order).

**Fault tolerance**:

* **watchdog + strikes** — every per-shard submit is timed on the host; a
  submit that exceeds ``watchdog_timeout`` or raises counts a strike, and
  a shard whose own pipeline reports ``max_consecutive_failures``
  whole-batch dispatch losses (or that accumulates that many strikes) is
  killed.  On the card a submit returns once its batches are queued, so
  device time never reaches the watchdog: only host-side stalls strike.
* **failover with live flow-state migration** — killing a shard
  checkpoints its :class:`~repro_torch.flow.table.FlowTable` under the
  fence and re-homes every flow onto the survivors by rendezvous (HRW)
  hashing, register rows bit-exact: the register file lives on the host
  and every flow update copies it back before ``extract`` returns, so a
  shard whose device is wedged still has correct state to hand over.
  Routing uses the same rendezvous function over the same alive set, so
  the migration destination always equals the future routing destination.
* **graceful degradation** — a dead shard's unresolved tickets surface as
  per-packet :class:`~repro_torch.core.ingress.PacketError` slots
  (``drain_packets`` never hangs and never loses global order), malformed
  raw rows are rejected per packet at admission
  (:func:`repro_torch.data.packets.validate_raw_rows`), and the last alive
  shard refuses to die.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.control_plane import ControlPlane
from ..core.inference import DataPlaneEngine
from ..core.ingress import IngressPipeline, PacketError, hash_words
from ..data.packets import (RAW_KEY_BYTES, RawHeaderBatch,
                            parse_raw_headers, validate_raw_rows)
from ..flow import FlowFrontend, FlowParams
from ..flow.table import FlowTable
from ..kernels.flow_update import cms_estimate_update
from ..kernels.ref import sat_shl_np
from ..launch.mesh import shard_devices
from ..obs import Observability, StatsAdapter

__all__ = ["ShardedPacketServer", "rss_shard"]


def rss_shard(key_hashes: np.ndarray, n_shards: int) -> np.ndarray:
    """RSS dispatch function: 64-bit flow-key hashes → shard ids.

    Pure and stateless — the same 5-tuple always maps to the same shard
    (the flow-affinity invariant the property tests pin down).  The hash is
    :func:`repro.flow.table.FlowTable.pack_keys`'s mixing hash, i.e. the
    exact value the shard's own flow table will re-derive, so dispatcher
    and table can never disagree about a key.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return (np.asarray(key_hashes, np.uint64)
            % np.uint64(n_shards)).astype(np.int64)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the rendezvous score mixer (vectorized;
    uint64 wraparound is the point)."""
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


class _Shard:
    """One complete serving stack: engine + pipeline + (lazy) flow frontend,
    pinned to one device."""

    def __init__(self, shard_id: int, cp: ControlPlane, device, *,
                 max_width: int, taylor_order: int,
                 kernel_variant: str, forest_variant: str,
                 ingress_batch: int, max_inflight: int, use_cache: bool,
                 cache_capacity_pow2: int,
                 flush_after: Optional[float], adaptive_batch: bool,
                 flow_capacity_pow2: int, flow_idle_timeout: Optional[int],
                 max_retries: int, retry_backoff: float, clock,
                 queue_capacity: Optional[int] = None,
                 queue_high_watermark: Optional[int] = None,
                 obs: Optional[Observability] = None):
        self.shard_id = shard_id
        self.device = device
        self.engine = DataPlaneEngine(
            cp, max_features=max_width, taylor_order=taylor_order,
            kernel_variant=kernel_variant,
            forest_variant=forest_variant, device=device)
        self.pipeline = IngressPipeline(
            self.engine, batch_size=ingress_batch,
            max_inflight=max_inflight, use_cache=use_cache,
            cache_capacity_pow2=cache_capacity_pow2,
            flush_after=flush_after, adaptive_batch=adaptive_batch,
            max_retries=max_retries, retry_backoff=retry_backoff,
            clock=clock, shard_id=shard_id,
            queue_capacity=queue_capacity,
            queue_high_watermark=queue_high_watermark, obs=obs)
        self._flow_capacity_pow2 = flow_capacity_pow2
        self._flow_idle_timeout = flow_idle_timeout
        self._flow: Optional[FlowFrontend] = None

    @property
    def flow(self) -> FlowFrontend:
        if self._flow is None:
            self._flow = FlowFrontend(
                self.pipeline, capacity_pow2=self._flow_capacity_pow2,
                idle_timeout=self._flow_idle_timeout)
            # graft the (standalone) flow counters into the shared
            # registry under this shard's label, plus an occupancy gauge
            reg = self.pipeline.obs.registry
            flow = self._flow
            for name, cell in flow.table.stats.cells():
                reg.attach(name, cell, shard=self.shard_id)
            for name, cell in flow.stats.cells():
                reg.attach(name, cell, shard=self.shard_id)
            g_occ = reg.gauge("flow_occupancy", shard=self.shard_id)
            reg.register_collector(lambda: g_occ.set(len(flow.table)))
        return self._flow


class _Submit:
    """Global-order record of one submit: which shard(s) got its packets.
    ``shard_ids[i] == -1`` marks a packet that never reached a shard
    (malformed at admission, or its shard's submit failed); ``reasons``
    then carries its per-packet error string."""

    __slots__ = ("shard_ids", "reasons")

    def __init__(self, shard_ids: np.ndarray, reasons=None):
        self.shard_ids = shard_ids  # (n,) int64 — per-packet shard
        self.reasons = reasons      # None | (n,) object of strings


class ShardedPacketServer:
    """N-shard serving fabric with the :class:`PacketServer` surface.

    Parameters are the single-engine server's plus ``n_shards``;
    ``ingress_batch`` is **per shard** (each shard keeps its own
    fixed-shape staging, so per-shard batch shapes — and therefore serving
    configurations — are identical to a standalone server's).  ``device``
    is the card by default (shards round-robin over the visible cards;
    construction raises when there is none); ``device="cpu"`` puts every
    shard on the CPU.  ``strict_model_ids=True`` rejects raw rows whose
    Model ID is not installed at admission, as the single-engine server
    does (an option the reference's fabric does not have).
    """

    def __init__(self, *, n_shards: int = 1, max_models: int = 16,
                 max_layers: int = 4, max_width: int = 32,
                 frac_bits: int = 8, weight_bits: int = 16,
                 taylor_order: int = 3,
                 kernel_variant: str = "int16", forest_variant: str = "auto",
                 max_inflight: int = 8, ingress_batch: int = 2048,
                 use_cache: bool = True, cache_capacity_pow2: int = 16,
                 max_forests: int = 8,
                 max_trees: int = 16, max_nodes: int = 64,
                 max_tree_depth: int = 6,
                 flush_after: Optional[float] = None,
                 adaptive_batch: bool = False,
                 flow_capacity_pow2: int = 14,
                 flow_idle_timeout: Optional[int] = None,
                 strict_model_ids: bool = False,
                 watchdog_timeout: Optional[float] = None,
                 max_consecutive_failures: int = 3,
                 queue_capacity: Optional[int] = None,
                 queue_high_watermark: Optional[int] = None,
                 max_retries: int = 2, retry_backoff: float = 0.0,
                 clock=None, obs: Optional[Observability] = None,
                 trace_every: int = 0,
                 drift_window: int = 0, drift_lanes: int = 8,
                 psi_threshold: float = 0.25,
                 shadow_model: Optional[int] = None, shadow_every: int = 8,
                 slo_budget: Optional[float] = None, device="cuda"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if watchdog_timeout is not None and watchdog_timeout <= 0:
            raise ValueError("watchdog_timeout must be positive (or None)")
        if max_consecutive_failures < 1:
            raise ValueError("max_consecutive_failures must be >= 1")
        self.n_shards = n_shards
        self.strict_model_ids = strict_model_ids
        # one telemetry bundle for the whole fabric: shards share the
        # registry (distinguished by the ``shard`` label) and the event log
        self.obs = obs if obs is not None else Observability(
            clock=clock, trace_every=trace_every)
        self.control_plane = ControlPlane(
            max_models=max_models, max_layers=max_layers,
            max_width=max_width, weight_bits=weight_bits,
            frac_bits=frac_bits, max_forests=max_forests,
            max_trees=max_trees, max_nodes=max_nodes,
            max_tree_depth=max_tree_depth)
        self.control_plane.events = self.obs.events
        devices = shard_devices(n_shards, device)
        self.shards = [
            _Shard(s, self.control_plane, devices[s],
                   max_width=max_width, taylor_order=taylor_order,
                   kernel_variant=kernel_variant,
                   forest_variant=forest_variant,
                   ingress_batch=ingress_batch, max_inflight=max_inflight,
                   use_cache=use_cache,
                   cache_capacity_pow2=cache_capacity_pow2,
                   flush_after=flush_after,
                   adaptive_batch=adaptive_batch,
                   flow_capacity_pow2=flow_capacity_pow2,
                   flow_idle_timeout=flow_idle_timeout,
                   max_retries=max_retries, retry_backoff=retry_backoff,
                   clock=clock, queue_capacity=queue_capacity,
                   queue_high_watermark=queue_high_watermark, obs=self.obs)
            for s in range(n_shards)]
        # global count-min sketch (see the module docstring: the one piece
        # of flow state that is a whole-fabric property)
        self.flow_params = FlowParams(frac=frac_bits)
        self.cms = np.zeros(
            (self.flow_params.cms_depth,
             1 << self.flow_params.cms_width_pow2), np.int32)
        self._key_words = (RAW_KEY_BYTES + 7) // 8
        # THE fence: every fabric operation holds this, so installs
        # serialize against submits/drains and a split arrival batch can
        # never straddle a generation bump (reentrant: public methods may
        # stack)
        self._lock = threading.RLock()
        self._order: deque = deque()   # _Submit records, submission order
        self._n_slots = 0              # global tickets this drain window
        self._rr = 0                   # round-robin cursor (stateless path)
        self._window_t0: Optional[float] = None
        # -- supervision state --------------------------------------------
        self.watchdog_timeout = watchdog_timeout
        self.max_consecutive_failures = max_consecutive_failures
        self.fault_plan = None  # FaultPlan.install() target hook
        self._alive = np.ones(n_shards, bool)
        self._strikes = np.zeros(n_shards, np.int64)
        self._window_degraded = False
        # rendezvous seeds: deterministic per-shard, so dead-homed flows
        # re-home identically across fabric instances and across restarts
        self._hrw_seeds = _mix64(
            (np.arange(1, n_shards + 1, dtype=np.uint64)
             * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(0xFA17FA17))
        # fault_stats rides on the shared registry under the canonical
        # ``fabric_*_total`` names
        reg = self.obs.registry
        fs = StatsAdapter()
        for canon in ("fabric_deaths_total",
                      "fabric_migrated_flows_total",
                      "fabric_watchdog_strikes_total",
                      "fabric_submit_failures_total",
                      "fabric_rejected_rows_total",
                      "fabric_lost_results_total",
                      "fabric_degraded_windows_total"):
            fs.bind(canon, reg.counter(canon))
        fs.bind_value("dead_shards", [])
        self.fault_stats = fs
        g_alive = reg.gauge("fabric_alive_shards")
        reg.register_collector(
            lambda: g_alive.set(int(self._alive.sum())))
        # per-shard submit latency (wall time of one shard's slice of a
        # raw submit — the watchdog's own measurement, exported)
        self._submit_hist = [
            reg.histogram("fabric_submit_seconds", shard=s)
            for s in range(n_shards)]
        # -- model-quality plane: drift taps + shadow lane + SLO ----------
        def _p99() -> Optional[float]:
            ps = [h.percentile(99.0) for h in self._submit_hist if h.count]
            return max(ps) if ps else None

        self.obs.enable_quality_plane(
            self.control_plane, [sh.pipeline for sh in self.shards],
            drift_window=drift_window, drift_lanes=drift_lanes,
            psi_threshold=psi_threshold, shadow_model=shadow_model,
            shadow_every=shadow_every, slo_budget=slo_budget,
            slo_rule="slo:fabric_submit_p99", submit_p99=_p99)

    # -- control plane (broadcast by construction: one shared plane) -------

    def install(self, model_id: int, layers, activations, **kw) -> int:
        """Hot-swap a model across the whole fabric.  One shared control
        plane means one generation counter: the swap is atomic across
        shards by construction, and the fabric lock keeps it from landing
        mid-dispatch of a split arrival batch."""
        with self._lock:
            return self.control_plane.install(
                model_id, layers, activations, **kw)

    def install_forest(self, model_id: int, forest) -> int:
        with self._lock:
            return self.control_plane.install_forest(model_id, forest)

    def install_feature_spec(self, model_id: int, columns) -> int:
        with self._lock:
            return self.control_plane.install_feature_spec(model_id, columns)

    def install_slo_budget(self, model_id: int, budget_us: float) -> int:
        """Hard-latency budget for a model's packets, fabric-wide (one
        shared SLO table; see :meth:`ControlPlane.install_slo_budget`)."""
        with self._lock:
            return self.control_plane.install_slo_budget(model_id, budget_us)

    def install_reflex(self, model_id: int, program) -> int:
        """Install a model's reflex fallback program fabric-wide and make
        sure every shard pipeline has a :class:`ReflexConfirmer` attached,
        so reflex-served answers get asynchronously model-confirmed."""
        from .reflex import ReflexConfirmer
        with self._lock:
            gen = self.control_plane.install_reflex(model_id, program)
            for sh in self.shards:
                if sh.pipeline.reflex_confirm is None:
                    sh.pipeline.reflex_confirm = ReflexConfirmer(sh.pipeline)
            return gen

    def remove_reflex(self, model_id: int) -> None:
        with self._lock:
            self.control_plane.remove_reflex(model_id)

    def remove(self, model_id: int) -> None:
        with self._lock:
            self.control_plane.remove(model_id)
            for sh in self.shards:
                sh.pipeline.on_model_removed(model_id)

    # -- supervision: strikes, death, failover -----------------------------

    @property
    def alive_shards(self) -> List[int]:
        """Shard ids still accepting traffic (observability + drills)."""
        return np.nonzero(self._alive)[0].tolist()

    def _rendezvous(self, hashes: np.ndarray) -> np.ndarray:
        """Highest-random-weight re-homing over the *current* alive set.

        Both the router (``_route``) and the failover migration call this
        same function, so a migrated flow's destination always equals its
        future routing destination; and because HRW removal only remaps
        the flows that had chosen the removed member, the equality
        survives further deaths without any remap table."""
        alive = np.nonzero(self._alive)[0]
        h = np.asarray(hashes, np.uint64)
        scores = _mix64(h[:, None] ^ self._hrw_seeds[None, alive])
        return alive[np.argmax(scores, axis=1)].astype(np.int64)

    def _route(self, hashes: np.ndarray) -> np.ndarray:
        """RSS first; flows homed on a dead shard fall through to
        rendezvous over the survivors."""
        sids = rss_shard(hashes, self.n_shards)
        dead = ~self._alive[sids]
        if dead.any():
            sids[dead] = self._rendezvous(
                np.asarray(hashes, np.uint64)[dead])
        return sids

    def _strike(self, s: int, reason: str) -> bool:
        """One supervision strike against shard ``s``; kills it at
        ``max_consecutive_failures`` (a healthy submit resets the count)."""
        self._strikes[s] += 1
        self.fault_stats["fabric_watchdog_strikes_total"] += 1
        self.obs.events.emit(
            "watchdog_strike", shard=int(s),
            generation=self.control_plane.version,
            reason=reason, strikes=int(self._strikes[s]))
        if self._strikes[s] >= self.max_consecutive_failures:
            return self.kill_shard(s, reason)
        return False

    def kill_shard(self, s: int, reason: str = "operator kill") -> bool:
        """Declare shard ``s`` dead and fail its flows over to the
        survivors (public so chaos drills can kill by hand).

        The dead shard's :class:`FlowTable` is checkpointed under the
        generation fence and every live flow re-homed by rendezvous —
        register rows bit-exact, because the register file is host memory
        that every flow update copies back into before ``submit_raw``
        returns (a wedged *device* never had the only copy).  The
        pipeline object stays around so its already-ticketed work drains
        (as results where the device still answers, as per-packet errors
        where it does not).  Returns ``False`` — and kills nothing — when
        ``s`` is the last alive shard: the fabric degrades, it does not
        go dark."""
        with self._lock:
            if not self._alive[s]:
                return True
            if int(self._alive.sum()) <= 1:
                return False
            self._alive[s] = False
            self._window_degraded = True
            sh = self.shards[s]
            flows_at_death = (len(sh._flow.table)
                              if sh._flow is not None else 0)
            self.obs.events.emit(
                "shard_killed", shard=int(s),
                generation=self.control_plane.version,
                reason=reason, flows=int(flows_at_death))
            migrated = 0
            if sh._flow is not None and len(sh._flow.table):
                snap = sh.flow.snapshot()["table"]
                keys, regs = snap["keys"], snap["registers"]
                hashes = hash_words(keys)
                dest = self._rendezvous(hashes)
                for t in self.alive_shards:
                    sel = dest == t
                    if sel.any():
                        adopted = self.shards[t].flow.table.adopt(
                            keys[sel], hashes[sel], regs[sel])
                        migrated += adopted
                        self.obs.events.emit(
                            "flow_migration", shard=int(t),
                            generation=self.control_plane.version,
                            source=int(s), flows=int(adopted))
            self.fault_stats["fabric_deaths_total"] += 1
            self.fault_stats["fabric_migrated_flows_total"] += migrated
            self.fault_stats["dead_shards"].append(
                {"shard": int(s), "reason": reason,
                 "migrated_flows": int(migrated)})
            return True

    # -- dispatch ----------------------------------------------------------

    def dispatch_shards(self, raw) -> np.ndarray:
        """Pure RSS mapping for a raw header batch: per-packet shard ids
        (no state is touched — exposed for tests and observability)."""
        fields = parse_raw_headers(raw)
        _, hashes = FlowTable.pack_keys(fields.key_bytes, self._key_words)
        return rss_shard(hashes, self.n_shards)

    def submit_raw(self, raw) -> Tuple[int, int]:
        """Raw 5-tuple ingress through the RSS dispatcher: parse once,
        hash once, update the global sketch once (arrival order), then
        scatter each packet to its flow's home shard (relative order
        preserved).  Returns global ``(first_ticket, n_packets)``."""
        with self._lock:
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            known = (self.control_plane.installed_ids()
                     if self.strict_model_ids else None)
            raw_arr, bad, reasons = validate_raw_rows(
                raw, known_model_ids=known)
            n = raw_arr.shape[0]
            first = self._n_slots
            if n == 0:
                return first, 0
            shard_ids = np.full(n, -1, np.int64)
            if bad is None:
                gidx = np.arange(n)
            else:
                self.fault_stats["fabric_rejected_rows_total"] += int(bad.sum())
                gidx = np.nonzero(~bad)[0]
            if gidx.size:
                rows = raw_arr if bad is None else raw_arr[gidx]
                fields = parse_raw_headers(rows)
                _, hashes = FlowTable.pack_keys(fields.key_bytes,
                                                self._key_words)
                sids = self._route(hashes)
                shard_ids[gidx] = sids
                # global CMS over *admitted* rows, arrival order, against
                # the fabric sketch — exactly the N=1 computation (the
                # single-engine server rejects malformed rows before its
                # sketch sees them too)
                cells = self.flow_params.cms_cells(hashes)
                est = cms_estimate_update(self.cms, cells)
                est_q = sat_shl_np(est, self.flow_params.frac)
                for s in np.unique(sids).tolist():
                    sel = sids == s
                    fields_s = RawHeaderBatch(
                        key_bytes=fields.key_bytes[sel],
                        model_id=fields.model_id[sel],
                        ts=fields.ts[sel], length=fields.length[sel])
                    t0 = time.perf_counter()
                    try:
                        self.shards[s].flow.submit_raw(
                            rows[sel], fields=fields_s,
                            cms_est_q=est_q[sel])
                    except Exception as e:  # shard wedged at submit
                        self.fault_stats["fabric_submit_failures_total"] += 1
                        self._window_degraded = True
                        if reasons is None:
                            reasons = np.full(n, None, object)
                        idx = gidx[sel]
                        shard_ids[idx] = -1
                        reasons[idx] = f"shard {s} submit failed: {e}"
                        self._strike(s, f"submit raised: {e}")
                        continue
                    dt = time.perf_counter() - t0
                    self._submit_hist[s].observe(dt)
                    pl = self.shards[s].pipeline
                    if (pl.consecutive_dispatch_failures
                            >= self.max_consecutive_failures):
                        self.kill_shard(
                            s, "consecutive whole-batch dispatch failures")
                    elif (self.watchdog_timeout is not None
                            and dt > self.watchdog_timeout):
                        self._strike(
                            s, f"watchdog: submit took {dt * 1e3:.1f}ms")
                    else:
                        self._strikes[s] = 0
            self._order.append(_Submit(shard_ids, reasons))
            self._n_slots += n
            return first, n

    def submit_packets(self, packets) -> Tuple[int, int]:
        """Encapsulated-packet ingress (no flow state): whole chunks
        round-robin across shards.  Returns global ``(first_ticket,
        n_packets)``."""
        with self._lock:
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            arr = np.asarray(packets)
            n = arr.shape[0] if arr.ndim == 2 else 0
            for _ in range(self.n_shards):  # next *alive* shard
                s = self._rr
                self._rr = (self._rr + 1) % self.n_shards
                if self._alive[s]:
                    break
            first = self._n_slots
            self.shards[s].pipeline.submit(arr)
            self._order.append(
                _Submit(np.full(n, s, np.int64)))
            self._n_slots += n
            return first, n

    def drain_packets(self, timeout_us: Optional[float] = None
                      ) -> List[Union[np.ndarray, PacketError]]:
        """Drain every shard and merge the results back into exact global
        submission order (each shard's drain is already in that shard's
        submission order; the recorded scatter says how to interleave).
        Per-packet error slots are re-ticketed to their global position.

        ``timeout_us`` bounds the whole fabric drain: each shard gets
        whatever remains of the window when its turn comes, so one wedged
        shard burns only the budget — its unresolved tickets come back as
        ``PacketError(DRAIN_TIMEOUT)`` slots and later shards still get
        (at least) a zero-budget drain, which resolves everything already
        retired and backfills the rest."""
        with self._lock:
            deadline = (None if timeout_us is None
                        else time.perf_counter() + float(timeout_us) * 1e-6)
            per: List[deque] = []
            for sh in self.shards:
                if deadline is None:
                    budget = None
                else:
                    budget = max(0.0,
                                 (deadline - time.perf_counter()) * 1e6)
                try:
                    per.append(deque(sh.pipeline.drain(budget)))
                except Exception as e:  # a wedged shard cannot hang drain
                    self._window_degraded = True
                    per.append(deque())
                    self._strike(sh.shard_id, f"drain raised: {e}")
            out: List[Union[np.ndarray, PacketError]] = []
            for rec in self._order:
                rl = rec.reasons
                for i, sid in enumerate(rec.shard_ids.tolist()):
                    if sid < 0:  # never reached a shard
                        why = (rl[i] if rl is not None and rl[i]
                               else "rejected at admission")
                        out.append(PacketError(ticket=len(out), reason=why))
                        continue
                    if not per[sid]:  # shard died with this result pending
                        self.fault_stats["fabric_lost_results_total"] += 1
                        out.append(PacketError(
                            ticket=len(out),
                            reason=f"shard {sid} lost this result "
                                   "(shard failure)"))
                        continue
                    r = per[sid].popleft()
                    if isinstance(r, PacketError):
                        r = PacketError(ticket=len(out), reason=r.reason)
                    out.append(r)
            if not self._window_degraded:
                assert all(not q for q in per), \
                    "shard drained more results than the fabric dispatched"
            else:
                self.fault_stats["fabric_degraded_windows_total"] += 1
                self.obs.events.emit(
                    "window_degraded", shard=-1,
                    generation=self.control_plane.version,
                    packets=len(out))
            self._window_degraded = False
            self._order.clear()
            self._n_slots = 0
            self._close_window()
            if self.obs.health is not None:
                # step alert rules once per drain window (drift rules also
                # step on the monitor's own window cadence)
                self.obs.health.evaluate()
            return out

    def _close_window(self) -> None:
        if self._window_t0 is not None:
            dt = time.perf_counter() - self._window_t0
            # every shard shares the window's wall-clock, so the aggregate
            # rate (sum of per-shard rates) is total packets / wall time —
            # the honest number for a host that serializes shard work
            for sh in self.shards:
                sh.engine.add_seconds(dt)
            self._window_t0 = None

    def process(self, packets):
        """Synchronous single-batch path (first alive shard — API parity
        with the single-engine server; no flow state involved)."""
        with self._lock:
            if self._window_t0 is not None:
                self.drain_packets()
            return self.shards[self.alive_shards[0]].engine.process(packets)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Fabric-level aggregates plus the per-shard breakdown.

        Deliberately **lock-free**: every value is a snapshot read of a
        registry cell or a plain attribute (GIL-atomic), so an operator
        polling ``stats()`` can never stall a concurrent ``submit_raw``
        holding the fabric lock — pinned by a regression test."""
        per_shard = []
        for sh in self.shards:
            d = {"shard": sh.shard_id,
                 "alive": bool(self._alive[sh.shard_id]),
                 "packets_per_s": sh.engine.packets_per_second(),
                 "throughput_gbps": sh.engine.throughput_gbps(),
                 "recompiles": sh.engine.trace_count,
                 "cache_hit_rate": sh.pipeline.cache_hit_rate(),
                 "packets": sh.pipeline.stats["ingress_packets_total"]}
            if sh._flow is not None:
                d["flows"] = len(sh._flow.table)
            per_shard.append(d)
        return {
            "n_shards": self.n_shards,
            "packets_per_s": sum(d["packets_per_s"] for d in per_shard),
            "throughput_gbps": sum(d["throughput_gbps"]
                                   for d in per_shard),
            "recompiles": sum(d["recompiles"] for d in per_shard),
            "table_generation": self.control_plane.version,
            "flows": sum(d.get("flows", 0) for d in per_shard),
            "alive_shards": self.alive_shards,
            "faults": self.fault_stats.as_dict(),
            "shards": per_shard,
        }
