"""Zero-copy ingress pipeline: coalescing batch queue + duplicate-result cache.

The data plane (``core/inference.py``) is batch-shaped: one serving
configuration per ``(batch, wire_len)`` shape.  Real ingress traffic is
nothing like that — per-connection packet chunks arrive ragged, and on
QoS/anomaly flows the same feature vector shows up over and over (per-flow
telemetry repeats until the flow changes state).  Feeding ragged arrivals
straight to the engine adds a configuration per shape; feeding duplicates
pays a full device round trip for bytes the device has already answered.

This module is the host-side stage in front of the engine, split into the
three pieces the paper's NIC gets for free from hardware:

  * :class:`ResultCache` — a generation-aware egress-row cache.  The key is
    the exact ingress wire row (Model ID, Scale, flags and the quantized
    feature block — i.e. ``(model_id, quantized feature vector)`` by
    construction) plus the control-plane **table generation**, so an
    ``install()``/``remove()`` invalidates automatically: the generation
    bump makes every cached key unreachable before the new tables can ever
    serve a lookup.  Storage is a flat open-addressing hash table held in
    numpy arrays, keyed on the wire row packed into uint64 words; lookups
    and inserts for a whole packet chunk are one call of a C++ host routine
    on those arrays (``kernels/csrc/result_cache.cpp``), or, where no C++
    compiler is found, vectorized numpy probe rounds that leave the same
    table — no per-packet Python on the hot path.
  * :class:`IngressPipeline` — the coalescing queue.  ``submit()`` accepts a
    ragged per-connection chunk, resolves cache hits immediately, dedupes the
    misses (byte-identical packets in one chunk dispatch once), byte-parses
    the fresh rows **once on the host** (``parse_packets_np`` — the
    bit-identical twin of the device parser) and packs their int32 feature
    codes into **fixed-shape** staging batches; partially-filled batches
    are padded with dead rows at ``flush()`` so the engine only ever sees
    its static shapes — no new configuration no matter how ragged the
    arrivals are.  Every dispatch is the pure-compute fused serving program
    (``engine.run_features`` over ``kernels/fused_serve.py``): no byte
    codec inside the device program; the egress wire rows are encoded once
    per retired batch (``emit_results_np``).  Staging is **family-aware**:
    once any tree ensemble is installed, MLP- and forest-family rows stage
    into separate batches so every device dispatch is lane-pure and the
    engine skips the other family's compute entirely (an install racing
    the staging falls back to the always-correct both-lane program for
    that batch); per-packet tickets make the reordering invisible at
    egress.  Host staging is multi-buffered: while batch N computes on the
    device, batch N+1 is being packed into the next pooled staging buffer
    (the buffer for a dispatched batch is not reused until its results
    retire, so dispatch hands the engine a stable view with no defensive
    copy).  With ``adaptive_batch=True`` an arrival-rate EWMA picks each
    new staging batch's device size from a static ≤3-rung ladder (small
    batches at light load for latency, the full batch under sustained
    load).  A **cold-traffic admission gate** (chunk-level EWMA of the
    observed duplication) turns the speculative cache/pending insert
    sweeps off on unique/adversarial traffic — the cold path pays lookups
    (which miss fast) but not inserts — and re-opens within a chunk or two
    when the always-on intra-chunk dedup sees duplicates again.
  * per-packet **tickets** — every submitted packet gets a ticket; results
    (or :class:`PacketError` slots for malformed packets) are delivered in
    exact submission order regardless of which packets hit the cache, which
    were coalesced, and which rode which device batch.

Packet-level flow::

    submit(chunk) ──▶ validate ──▶ cache lookup ──▶ hit: resolve ticket
                                        │miss
                                        ▼
                            dedupe (row-hash) ──▶ parse fresh rows (host,
                                                  once) ──▶ staging ──▶ full?
                                                        │ yes
                                                        ▼
                          engine.run_features(x0, mids, block=False) (async)
                                                        │ retire
                                                        ▼
               emit egress rows (host, once) ──▶ scatter to tickets +
                                     cache.insert(generation at dispatch)
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from ..kernels import ref as _ref, result_cache as _rc
from .packet import (FEATURE_BYTES, FLAG_REFLEX, HEADER_BYTES,
                     emit_results_np, parse_packets_np)
from ..obs import Observability, StageClock, StatsAdapter
from ..obs.trace import (ENGINE_DISPATCH, INGRESS_DRAIN, INGRESS_KEY,
                         INGRESS_LOOKUP, INGRESS_RETIRE, INGRESS_STAGE,
                         INGRESS_WAIT)

__all__ = ["PacketError", "BatchError", "ResultCache", "IngressPipeline",
           "pack_rows", "STATUS_PENDING", "STATUS_READY", "STATUS_ERROR",
           "DEADLINE_SHED", "DRAIN_TIMEOUT"]

STATUS_PENDING = 0
STATUS_READY = 1
STATUS_ERROR = 2

# Typed PacketError reasons of the hard-latency layer: callers match on
# these exact strings (the fabric re-tickets them across the merge, the
# bench's ticket-accounting oracle counts them).
DEADLINE_SHED = "deadline shed: ingress queue past hard capacity"
DRAIN_TIMEOUT = "drain timeout: unresolved at window deadline"


@dataclasses.dataclass(frozen=True)
class PacketError:
    """Per-packet error slot: delivered in the packet's submission-order
    position instead of an egress row."""

    ticket: int
    reason: str


@dataclasses.dataclass(frozen=True)
class BatchError:
    """Batch-level rejection marker for the legacy ``PacketServer`` drain
    path: occupies the rejected batch's submission-order slot and expands to
    per-packet error slots."""

    reason: str
    n_packets: int

    @property
    def per_packet(self) -> List[PacketError]:
        return [PacketError(ticket=i, reason=self.reason)
                for i in range(self.n_packets)]


# ---------------------------------------------------------------------------
# Row hashing/packing — the shared vectorized primitives
# ---------------------------------------------------------------------------

# splitmix64 finalizer constants (public-domain mix; uint64 wrap-around is the
# point, numpy unsigned arithmetic wraps silently)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)

# deterministic odd multipliers, one per packed key word.  64 words cover
# wire rows up to 512 bytes (max_features 126) — far beyond paper scale;
# ResultCache validates the bound so an oversized key fails loudly at
# construction instead of deep inside hash_words.
_MULTS = ((np.random.default_rng(0xC0FFEE).integers(
    0, 2 ** 63, 64, np.uint64) << np.uint64(1)) | np.uint64(1))


def pack_rows(rows: np.ndarray, n_words: int) -> np.ndarray:
    """Pack uint8 rows ``(N, L)`` into ``(N, n_words)`` uint64 words
    (zero-padded).  Packing is injective for a fixed ``L``, so word equality
    is byte equality — every comparison in the cache runs 8 bytes at a
    time."""
    n, length = rows.shape
    buf = np.zeros((n, n_words * 8), np.uint8)
    buf[:, :length] = rows
    return buf.view(np.uint64).reshape(n, n_words)


def hash_words(words: np.ndarray) -> np.ndarray:
    """64-bit mixing hash of packed rows — vectorized over the chunk.

    Unrolled column accumulation: one (N,) multiply-add per key word beats
    the ``(N, K)`` temporary + axis reduce by a wide margin at chunk scale.
    """
    h = words[:, 0] * _MULTS[0]
    for k in range(1, words.shape[1]):
        h = h + words[:, k] * _MULTS[k]
    h ^= h >> np.uint64(30)
    h *= _MIX1
    h ^= h >> np.uint64(27)
    h *= _MIX2
    h ^= h >> np.uint64(31)
    return h


def _dedup_rows(words: np.ndarray, hashes: np.ndarray,
                want_rank: bool = False):
    """Exact first-occurrence dedup of packed rows.

    Sorts by the *folded* 32-bit hash (numpy's stable radix sort scales
    with key bytes — 4-byte keys sort ~2× faster than 8-byte ones; the
    mixing hash's low word is uniformly distributed) and verifies the full
    64-bit hash plus word equality between sort-neighbours, so a hash or
    fold collision can only ever *miss* a coalescing opportunity, never
    merge two distinct packets (identical rows share a fold, so they stay
    adjacent; an interleaving fold collision merely splits their group).
    Returns ``(uniq_idx, inverse)`` with ``rows[uniq_idx][inverse] ==
    rows``.
    """
    n = words.shape[0]
    order = np.argsort(hashes.astype(np.uint32), kind="stable")
    sw = words[order]
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = (hashes[order][1:] != hashes[order][:-1]) \
        | (sw[1:] != sw[:-1]).any(axis=1)
    group = np.cumsum(new) - 1
    inverse = np.empty(n, np.int64)
    inverse[order] = group
    if not want_rank:
        return order[new], inverse
    # per-group occurrence rank in original order (the stable sort keeps
    # equal rows in arrival order) — callers that need both dedup and
    # within-group ranking get them from the one argsort.  Late import:
    # the definition lives with the flow-update kernel (its consumer);
    # importing it at module top would cycle through core.__init__.
    from ..kernels.flow_update import rank_from_order
    return order[new], inverse, rank_from_order(order, new)


# ---------------------------------------------------------------------------
# ResultCache — vectorized open-addressing egress-row cache
# ---------------------------------------------------------------------------


class ResultCache:
    """Generation-scoped ``ingress row → egress row`` cache.

    * A lookup or insert whose ``generation`` is **newer** than the cache's
      flushes the whole table first — entries computed under old tables can
      never be served once ``ControlPlane.install()``/``remove()`` has
      bumped the generation.  An insert carrying an **older** generation
      (results of a batch that was already in flight when a writer swapped
      tables) is dropped: stale rows never enter the table.
    * ``drop_model()`` tombstones one model's entries (used by explicit
      ``remove()`` paths; the generation bump already guarantees staleness
      safety, this just releases the slots immediately).  Tombstoned slots
      are reclaimed: an ``insert()`` probing onto one claims it in place,
      and once tombstones exceed ``tombstone_limit`` of capacity the table
      is **compacted** (live entries re-hashed, tombstones dropped) — so
      long-running serving with model churn never degrades toward
      all-tombstone probe chains.
    * Storage is bounded: when the table passes its load limit it is flushed
      wholesale (epoch eviction).  Cheap, branch-free, and a cache miss is
      always safe — the pipeline simply dispatches.

    Keys are ingress rows packed into uint64 words (:func:`pack_rows`); all
    operations take the whole packet chunk at once (double hashing over a
    power-of-two table).  ``lookup`` and ``insert`` walk the probe chains in
    one native call (``kernels.result_cache``) where ``native`` is true,
    else in the plain numpy rounds (``kernels.ref``); ``probe_keys`` and
    ``probe_slots`` count the rows that walked a chain and the slots they
    visited, in both.
    """

    def __init__(self, key_words: int, val_bytes: int, *,
                 capacity_pow2: int = 15, max_probe: int = 32,
                 load_limit: float = 0.7, tombstone_limit: float = 0.25):
        if not 0 < key_words <= _MULTS.size:
            raise ValueError(
                f"key_words={key_words} outside (0, {_MULTS.size}] — wire "
                f"rows beyond {_MULTS.size * 8} bytes are not supported")
        cap = 1 << capacity_pow2
        self._cap = cap
        self._max_probe = max_probe
        self._load_limit = load_limit
        self._tombstone_limit = tombstone_limit
        self.key_words = key_words
        self.val_bytes = val_bytes
        self._keys = np.zeros((cap, key_words), np.uint64)
        self._vals = np.zeros((cap, val_bytes), np.uint8)
        self._state = np.zeros(cap, np.uint8)  # 0 empty · 1 full · 2 tombstone
        self._model = np.full(cap, -1, np.int64)
        # claim-arbitration scratch (insert probe rounds) — stale contents
        # are harmless: every round writes before it reads back
        self._claim = np.zeros(cap, np.int64)
        # the probe sweeps: one native call per chunk where a C++ compiler
        # is found, else the plain numpy rounds; both leave the same table
        native = _rc.sweeps()
        self.native = native is not None
        self._lookup, self._insert = native or (
            _ref.result_cache_lookup_ref, _ref.result_cache_insert_ref)
        self._count = 0
        self._tombstones = 0
        self._gen = -1
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.flushes = 0
        self.compactions = 0
        self.stale_inserts_dropped = 0
        self.probe_keys = 0    # rows that walked a probe chain
        self.probe_slots = 0   # slots those chains visited

    # -- internals --------------------------------------------------------

    def _sync_generation(self, generation: int) -> bool:
        """Flush on a newer generation; return False if ``generation`` is
        stale (strictly older than the cache's)."""
        if generation == self._gen:
            return True
        if self._gen != -1 and generation < self._gen:
            return False
        self.clear()
        self._gen = generation
        return True

    # -- public API -------------------------------------------------------

    def clear(self) -> None:
        self._state[:] = 0
        self._count = 0
        self._tombstones = 0
        self.flushes += 1

    def _compact(self) -> None:
        """Rebuild the table in place, dropping every tombstone (live
        entries re-hash onto clean probe chains).  Best-effort like the
        rest of the cache: a re-inserted entry that exhausts its probe
        budget is dropped, never corrupted."""
        live = self._state == 1
        keys = self._keys[live].copy()
        vals = self._vals[live].copy()
        mids = self._model[live].copy()
        self._state[:] = 0
        self._count = 0
        self._tombstones = 0
        self.compactions += 1
        if keys.shape[0]:
            ins0 = self.insertions  # re-admissions are not new insertions
            self.insert(keys, vals, mids, self._gen)
            self.insertions = ins0

    @property
    def tombstones(self) -> int:
        return self._tombstones

    def __len__(self) -> int:
        return self._count

    @property
    def generation(self) -> int:
        return self._gen

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def lookup(self, words: np.ndarray, generation: int,
               hashes: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe a whole chunk of packed rows.  Returns ``(hit_mask, vals)``
        where ``hit_mask`` is ``(N,)`` bool and ``vals`` is
        ``(hit_mask.sum(), val_bytes)`` — egress rows for the hits, in chunk
        order."""
        n = words.shape[0]
        if n == 0 or not self._sync_generation(generation) or self._count == 0:
            self.misses += n
            return np.zeros(n, bool), np.zeros((0, self.val_bytes), np.uint8)
        if hashes is None:
            hashes = hash_words(words)
        hit_slot = np.empty(n, np.int64)
        hit_vals = np.empty((n, self.val_bytes), np.uint8)
        n_hit, visited = self._lookup(self._keys, self._vals, self._state,
                                      self._max_probe, words, hashes,
                                      hit_slot, hit_vals)
        self.probe_keys += n
        self.probe_slots += visited
        self.hits += n_hit
        self.misses += n - n_hit
        return hit_slot >= 0, hit_vals[:n_hit]

    def insert(self, words: np.ndarray, vals: np.ndarray,
               model_ids: np.ndarray, generation: int,
               hashes: Optional[np.ndarray] = None,
               assume_unique: bool = False) -> int:
        """Insert a chunk of ``(packed ingress row → egress row)`` pairs
        computed under table ``generation``.  Returns the number of rows
        admitted (stale generations and probe-exhausted rows are dropped —
        the cache is best-effort by design).

        ``assume_unique`` skips the internal dedup when the caller already
        guarantees *mostly* distinct keys (the ingress pipeline dedups
        every chunk before staging, so its retire-side inserts never pay a
        second argsort).  Probe rounds arbitrate claim collisions by
        **scatter** (last write into the claim scratch wins, losers
        re-probe) — no sort, no ``np.unique``, no ``np.isin`` on the
        insert hot path.  Duplicate keys slipping through in one call
        (e.g. the best-effort pending window missed a row that then staged
        twice) stay safe either way: an arbitration loser whose slot was
        just claimed by its own key resolves as a value refresh instead of
        claiming a second slot.
        """
        n = words.shape[0]
        if n == 0:
            return 0
        if not self._sync_generation(generation):
            self.stale_inserts_dropped += n
            return 0
        if self._tombstones > self._cap * self._tombstone_limit:
            self._compact()
        if hashes is None:
            hashes = hash_words(words)
        if not assume_unique:
            # dedupe within the call so two identical rows never race one
            # slot (identical keys in one round would both "win" the claim
            # scatter and double-count)
            uidx, _ = _dedup_rows(words, hashes)
            if uidx.size != n:
                words, vals = words[uidx], vals[uidx]
                model_ids, hashes = model_ids[uidx], hashes[uidx]
                n = uidx.size
        if self._count + n > self._cap * self._load_limit:
            self.clear()
            self._gen = generation
        admitted, reclaimed, visited = self._insert(
            self._keys, self._vals, self._state, self._model, self._claim,
            self._max_probe, words, vals, model_ids, hashes)
        self._count += admitted
        self._tombstones -= reclaimed
        self.probe_keys += n
        self.probe_slots += visited
        self.insertions += admitted
        return admitted

    def drop_model(self, model_id: int) -> int:
        """Tombstone every entry belonging to ``model_id``; returns the
        number of entries dropped.  Past ``tombstone_limit`` the table is
        compacted immediately, so churny remove() loops keep probe chains
        short instead of accumulating dead slots."""
        sel = (self._state == 1) & (self._model == int(model_id))
        n = int(sel.sum())
        if n:
            self._state[sel] = 2
            self._count -= n
            self._tombstones += n
            if self._tombstones > self._cap * self._tombstone_limit:
                self._compact()
        return n

    def contains_model(self, model_id: int) -> bool:
        return bool(((self._state == 1) & (self._model == int(model_id))).any())


# ---------------------------------------------------------------------------
# IngressPipeline — coalescing fixed-shape batch queue over the engine
# ---------------------------------------------------------------------------


class _RowStore:
    """Growable 2-D uint8 row store (amortized append, vectorized reads)."""

    def __init__(self, width: int, cap: int = 1024):
        self._a = np.empty((cap, width), np.uint8)
        self.n = 0

    def ensure(self, n: int) -> None:
        if n > self._a.shape[0]:
            cap = self._a.shape[0]
            while cap < n:
                cap *= 2
            a = np.empty((cap, self._a.shape[1]), np.uint8)
            a[: self.n] = self._a[: self.n]
            self._a = a

    @property
    def a(self) -> np.ndarray:
        return self._a

    def reset(self) -> None:
        self.n = 0


@dataclasses.dataclass
class _InFlight:
    future: object          # engine DeviceResult (int32 output codes)
    miss_idx: np.ndarray    # global miss index per real row (batch order)
    count: int              # real (non-padding) rows in the batch
    size: int               # dispatched device batch rows (incl. padding)
    buf_idx: int            # staging buffer holding the ingress rows
    generation: Optional[int]  # table generation at dispatch (None = ambiguous)
    lanes: str = "both"     # lane program dispatched (salvage probes reuse
                            # it — same dispatch shape)
    t_dispatch: float = 0.0  # dispatch timestamp (cost-EWMA sample start)
    t_issue: float = 0.0     # clock before the dispatch's first device call
    hold_until: float = 0.0  # overload chaos: earliest retire time (0 = now)


@dataclasses.dataclass
class _OpenBatch:
    """A partially-filled staging batch for one model family."""

    family: str             # "mlp" | "forest" — the engine lane hint
    buf: int                # index into the shared staging-buffer pool
    size: int               # target device batch rows (adaptive sizing)
    fill: int               # rows staged so far
    t0: float               # age clock (flush_after knob)
    gen0: int               # generation the rows were family-classified at
    miss_idx: np.ndarray    # (batch_size,) global miss index scratch
    deadline: float = float("inf")  # earliest staged-row SLO deadline
                                    # (absolute clock seconds)


@dataclasses.dataclass
class _ChunkRecord:
    tickets: np.ndarray     # tickets of this chunk's cache-missing packets
    miss_idx: np.ndarray    # global miss index per missing packet
    hi: int                 # 1 + max(miss_idx): resolvable once retired past


class IngressPipeline:
    """Coalescing ingress queue + result cache in front of a
    :class:`~repro_torch.core.inference.DataPlaneEngine`.

    Parameters
    ----------
    engine:
        The batched data-plane engine.  Its ``max_features`` fixes the wire
        shape; its control plane's generation counter drives cache
        invalidation.
    batch_size:
        Fixed device batch (every dispatch is exactly this many rows — ragged
        arrivals never add a configuration).
    max_inflight:
        Device batches in flight before dispatch blocks on the oldest.
        ``max_inflight + 2`` staging buffers are pooled (up to two open
        family batches + the in-flight window) so the buffer backing a
        dispatched batch is never written until its results retire.
    use_cache / cache_capacity_pow2:
        Duplicate-result short-circuit (on by default).
    flush_after:
        Latency knob: maximum age in seconds a partially-filled staging
        batch may wait before it is dispatched padded.  The age clock
        starts when the first row enters an empty staging buffer and is
        checked at the end of every ``submit()`` (and by ``poll()``, for
        callers with idle gaps between arrivals).  ``None`` (default)
        preserves the fill-or-flush behavior: a partial batch waits for
        ``flush()``; ``0.0`` dispatches whatever is staged as soon as the
        submit that staged it returns.
    adaptive_batch:
        Load-adaptive batch sizing (the ROADMAP "next step" past
        ``flush_after``): an EWMA of the arrival rate picks each new
        staging batch's device size from a small static ladder
        (``batch_size`` and two smaller rungs — at most 3 dispatch shape
        variants), so light traffic rides small low-latency batches while
        sustained load keeps the full fixed-shape throughput batch.
        ``flush_after`` semantics are unchanged (same injectable clock —
        the age knob still bounds the tail when the rate estimate is
        wrong).  Off by default: sizing is then exactly the fixed
        ``batch_size`` behavior.
    clock:
        Monotonic-seconds source for the ``flush_after`` age checks and the
        arrival-rate EWMA (default ``time.perf_counter``).  Injectable so
        age-based behavior is testable without wall-clock sleeps — tests
        advance a fake clock deterministically instead of racing the
        scheduler.
    """

    # Cold-traffic admission gate: the caches only pay off on duplicate
    # traffic, so their *insert* sweeps are speculative work.  A chunk-level
    # EWMA of the observed short-circuit rate (cache hits + dedup/window
    # coalesces per packet) gates admission: unique/adversarial cold
    # traffic stops paying full insert sweeps after the first chunks.
    # Re-opening has two detectors: the always-on intra-chunk dedup (sees
    # within-chunk repeats immediately), and **probe inserts** — while the
    # gate is closed, every retired batch still admits a 1-in-8 stride
    # sample of its rows, so duplication that only repeats *across* chunks
    # starts hitting the sampled entries and re-opens the gate within a
    # few chunks instead of latching shut forever.  The gate is a
    # **hysteresis** pair, not one threshold: a closed gate's observable
    # hit rate is attenuated by the probe stride (only 1-in-8 rows are in
    # the cache to hit), so it re-opens at ``threshold / stride`` —
    # cross-chunk duplication at e.g. 20% shows up as ≈ 20%/8 = 2.5%
    # through the probe sample, which a flat 5% reopen bar would latch
    # shut forever despite the true rate being 4× the threshold.  Both
    # comparisons gate the *same* effective duplication: open-state closes
    # below 5% observed, closed-state re-opens at the stride-attenuated
    # image of that same 5%.  Correctness never depends on the gate — a
    # skipped insert can only cost a future hit.
    _ADMIT_THRESHOLD = 0.05
    _ADMIT_ALPHA = 0.5
    _PROBE_STRIDE = 8
    # dispatch-cost EWMA smoothing (deadline scheduler): biased toward
    # history so one slow batch widens the safety margin gradually
    _COST_ALPHA = 0.25
    # hard wall-clock ceiling on one overload-chaos hold (seconds): a
    # chaos spec may inflate latency, never wedge a retire unboundedly
    _OVERLOAD_HOLD_CAP = 0.5

    def __init__(self, engine, *, batch_size: int = 2048,
                 max_inflight: int = 2, use_cache: bool = True,
                 cache_capacity_pow2: int = 16,
                 flush_after: Optional[float] = None,
                 adaptive_batch: bool = False,
                 clock=None, shard_id: int = 0,
                 max_retries: int = 2, retry_backoff: float = 0.0,
                 queue_capacity: Optional[int] = None,
                 queue_high_watermark: Optional[int] = None,
                 obs: Optional[Observability] = None):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if max_inflight <= 0:
            raise ValueError("max_inflight must be positive")
        if flush_after is not None and flush_after < 0:
            raise ValueError("flush_after must be >= 0 seconds (or None)")
        if max_retries < 0 or retry_backoff < 0:
            raise ValueError("max_retries/retry_backoff must be >= 0")
        if queue_capacity is not None and queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1 rows (or None)")
        if queue_high_watermark is not None and queue_high_watermark < 0:
            raise ValueError("queue_high_watermark must be >= 0 (or None)")
        if queue_capacity is not None and queue_high_watermark is not None \
                and queue_high_watermark > queue_capacity:
            raise ValueError("queue_high_watermark must be <= queue_capacity")
        self.engine = engine
        self.cp = engine.cp
        # shard-local identity: tickets, miss indices, the result cache and
        # the pending window are all per-pipeline state, so a pipeline IS a
        # shard — the id only names it (stats, fabric drain bookkeeping);
        # no cross-shard coherence exists to need it for correctness.
        self.shard_id = int(shard_id)
        self.batch_size = batch_size
        self.max_inflight = max_inflight
        self.width = engine.max_features
        self.wire_bytes = HEADER_BYTES + FEATURE_BYTES * engine.max_features
        out_feats = min(engine.max_features, int(engine.cp.max_width))
        self.out_feats = out_feats
        self.out_bytes = HEADER_BYTES + FEATURE_BYTES * out_feats
        # Cache/dedup keys are the raw wire rows packed into uint64 words:
        # the steady path (lookup hit) touches nothing but the incoming
        # bytes — no parse, no key construction.  The flow engine's
        # feature-domain entry encodes the identical wire row for its key
        # (one vectorized host encode), so both surfaces share one key
        # space.
        self.key_words = (self.wire_bytes + 7) // 8
        self.cache: Optional[ResultCache] = (
            ResultCache(self.key_words, self.out_bytes,
                        capacity_pow2=cache_capacity_pow2)
            if use_cache else None)
        # pending-window index: rows staged or in flight → global miss index,
        # so a duplicate arriving before its original has even retired
        # coalesces onto the same dispatch instead of re-dispatching.  Same
        # generation discipline as the result cache (values are 8-byte
        # little-endian miss indices).
        self._pending: Optional[ResultCache] = (
            ResultCache(self.key_words, 8,
                        capacity_pow2=cache_capacity_pow2)
            if use_cache else None)

        if self.key_words > _MULTS.size:
            raise ValueError(
                f"wire rows of {self.wire_bytes} bytes exceed the "
                f"{_MULTS.size * 8}-byte hashing bound "
                f"(max_features={engine.max_features})")

        # Load-adaptive size ladder (static: each rung is one dispatch shape)
        if adaptive_batch:
            rungs = {batch_size}
            for div in (4, 16):
                if batch_size // div >= 64:
                    rungs.add(batch_size // div)
            self.batch_sizes = tuple(sorted(rungs))
        else:
            self.batch_sizes = (batch_size,)
        self.adaptive_batch = adaptive_batch
        self._rate_ewma = 0.0
        self._last_submit_t: Optional[float] = None

        # Family-aware multi-buffered host staging — **feature domain**:
        # each chunk is byte-parsed once on the host (parse_packets_np) and
        # staged as int32 feature codes + header fields, so every device
        # dispatch is the pure-compute fused serving program
        # (engine.run_features) with no in-program byte codec.  Up to two
        # open batches (one per model family — MLP and forest rows stage
        # separately so device batches are **lane-pure**) plus up to
        # max_inflight batches on the device.  The packed key words/hashes
        # computed at submit time ride along so the retire-side cache
        # insert never re-packs or re-hashes a row; a buffer backing a
        # dispatched batch returns to the free pool only when its results
        # retire (the retire-side egress encode reads it).
        n_bufs = max_inflight + 2
        self._stg_x0 = [np.zeros((batch_size, self.width), np.int32)
                        for _ in range(n_bufs)]
        self._stg_mid = [np.zeros(batch_size, np.int32)
                         for _ in range(n_bufs)]
        self._stg_flags = [np.zeros(batch_size, np.int32)
                           for _ in range(n_bufs)]
        self._staging_words = [np.zeros((batch_size, self.key_words),
                                        np.uint64)
                               for _ in range(n_bufs)]
        self._staging_hashes = [np.zeros(batch_size, np.uint64)
                                for _ in range(n_bufs)]
        self._free_bufs: Deque[int] = deque(range(n_bufs))
        self._open: Dict[str, _OpenBatch] = {}
        self.flush_after = flush_after
        self._clock = clock if clock is not None else time.perf_counter
        self._dup_ewma = 1.0  # optimistic start: admit until proven unique
        self._gate_open = True  # hysteresis state (see the class comment)

        # Hard-latency layer: the watermark controller's bounds on
        # model-lane queue depth (staged + in-flight rows) and the measured
        # dispatch→retire cost the deadline scheduler subtracts from the
        # oldest staged row's remaining budget.  The EWMA seeds itself from
        # the first retired batch; tests inject a fixed cost directly.
        self.queue_capacity = queue_capacity
        self.queue_high_watermark = queue_high_watermark
        self.dispatch_cost_ewma = 0.0
        # async model-lane confirmation of reflex answers — attached
        # externally (serve.reflex.ReflexConfirmer), like ``shadow``
        self.reflex_confirm = None

        self._inflight: Deque[_InFlight] = deque()
        self._chunks: Deque[_ChunkRecord] = deque()

        self._n_tickets = 0
        self._results = _RowStore(self.out_bytes)
        self._status = np.zeros(1024, np.uint8)
        self._errors: Dict[int, PacketError] = {}

        self._n_miss = 0       # global miss-row indices assigned so far
        self._miss_done = 0    # fully-retired prefix of the miss sequence
        self._miss_out = _RowStore(self.out_bytes)
        # family batches retire out of index order; the prefix pointer
        # advances over this per-index retirement map
        self._miss_retired = np.zeros(1024, bool)
        # per-miss-row failure codes parallel to _miss_retired: 0 = served,
        # 1 = dispatch failed / quarantined, 2 = egress row corrupted.  A
        # failed row is still "retired" (the prefix advances, chunks
        # resolve, drain never hangs) — it just resolves to a PacketError.
        self._miss_failed = np.zeros(1024, np.uint8)

        # degraded-mode serving: bounded retry-with-backoff around every
        # device dispatch, then same-shape bisection probes to quarantine
        # the offending rows while the rest of the batch serves.  The
        # consecutive-failure streak (whole batches lost, reset by any
        # served row) is what a supervising fabric reads to declare the
        # shard dead.
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.consecutive_dispatch_failures = 0
        # fault-injection hook (serve.faults); chaos mode (REPRO_CHAOS=1)
        # self-installs a transient plan so the whole tier-1 suite runs
        # through the retry path.  Function-level import: serve.__init__
        # pulls in the fabric, which imports this module.
        from ..serve.faults import chaos_plan_from_env
        self.fault_plan = chaos_plan_from_env()

        # Observability: counters live in the metrics registry under
        # the canonical <subsystem>_<noun>_total names; ``self.stats`` is a
        # thin adapter over the same cells (reads and the ``stats["k"] += n``
        # write pattern).  A server passes its shared ``obs`` so every
        # shard's cells land in one registry under a shard label; a
        # standalone pipeline gets a private one.
        self.obs = obs if obs is not None else Observability(clock=clock)
        self.tracer = self.obs.make_tracer(shard=self.shard_id, clock=clock)
        # always-on self-time counters of the host stages (obs.trace.STAGES)
        # in the shared registry under this pipeline's shard label
        self.stages = StageClock(self.obs.registry, clock=self._clock,
                                 shard=self.shard_id)
        # model-quality plane: the feature/prediction taps read
        # ``self.obs.drift`` per batch (one attribute check when off); an
        # attached ShadowScorer samples staged rows into its replay lane
        self.shadow = None
        if self.fault_plan is not None \
                and getattr(self.fault_plan, "events", None) is None:
            # chaos-mode self-installed plans log their firings here too
            self.fault_plan.events = self.obs.events
        reg = self.obs.registry
        sid = self.shard_id
        stats = StatsAdapter()

        def _c(canonical: str) -> None:
            stats.bind(canonical, reg.counter(canonical, shard=sid))

        _c("ingress_packets_total")
        _c("ingress_cache_hits_total")
        _c("ingress_coalesced_total")
        _c("ingress_dispatched_rows_total")
        _c("ingress_padded_rows_total")
        _c("ingress_batches_total")
        _c("ingress_errors_total")
        _c("ingress_dispatch_retries_total")
        _c("ingress_dispatch_failures_total")
        _c("ingress_quarantined_rows_total")
        _c("ingress_probe_batches_total")
        _c("ingress_corrupted_rows_total")
        _c("ingress_reflex_served_total")
        _c("ingress_shed_total")
        _c("ingress_drain_timeouts_total")
        # On the card, one pair of timing events per staging buffer (a
        # buffer's batch retires before the buffer dispatches again): each
        # batch's time on the device clock, from its first copy up to the
        # end of its copy back.  With the default clock the tracer stamps
        # dispatch and device_done from the same pair.
        events = [engine.timing_events() for _ in range(n_bufs)]
        self._events = events if events[0] is not None else None
        if self._events is not None:
            self._c_device = reg.counter(
                "engine_batch_device_seconds_total",
                "device seconds per batch, first copy in to copy back, "
                "from the batch's own events", shard=sid)
        self._event_stamps = (self._events is not None and clock is None
                              and self.obs.clock is None)
        lanes_sub = StatsAdapter()
        for lane in ("mlp", "forest", "both"):
            lanes_sub.bind(lane, reg.counter("ingress_lane_batches_total",
                                             shard=sid, lane=lane))
        stats.bind_nested("lane_batches", lanes_sub)
        self.stats = stats

        # Pull-mirrored state (zero hot-path cost): cache/pending counters,
        # occupancy gauges, admission-gate state, engine totals and the
        # configuration count are sampled into the registry at export time.
        cache_cells = {
            "cache_hits_total": reg.counter("cache_hits_total", shard=sid),
            "cache_misses_total": reg.counter("cache_misses_total",
                                              shard=sid),
            "cache_insertions_total": reg.counter("cache_insertions_total",
                                                  shard=sid),
            "cache_flushes_total": reg.counter("cache_flushes_total",
                                               shard=sid),
            "cache_compactions_total": reg.counter("cache_compactions_total",
                                                   shard=sid),
            "cache_stale_inserts_total": reg.counter(
                "cache_stale_inserts_total", shard=sid),
        }
        # probe work of both tables, counted by the sweeps themselves
        probe_cells = [
            (reg.counter("cache_probe_slots_total",
                         "slots visited by probe chains",
                         shard=sid, table=table),
             reg.counter("cache_probe_keys_total",
                         "rows that walked a probe chain",
                         shard=sid, table=table))
            for table in ("result", "pending")]
        reg.gauge("cache_native", "1 where the probe sweeps run natively",
                  shard=sid).set(
            1.0 if self.cache is not None and self.cache.native else 0.0)
        g_entries = reg.gauge("cache_entries", shard=sid)
        g_tomb = reg.gauge("cache_tombstones", shard=sid)
        g_gate = reg.gauge("ingress_gate_open",
                           "cold-traffic admission gate state", shard=sid)
        g_inflight = reg.gauge("ingress_inflight_batches", shard=sid)
        eng_cells = {
            "engine_packets_total": reg.counter("engine_packets_total",
                                                shard=sid),
            "engine_bytes_in_total": reg.counter("engine_bytes_in_total",
                                                 shard=sid),
            "engine_bytes_out_total": reg.counter("engine_bytes_out_total",
                                                  shard=sid),
        }
        c_retrace = reg.counter("engine_retraces_total",
                                "serving configurations per engine",
                                shard=sid)

        def _collect() -> None:
            cache = self.cache
            if cache is not None:
                cache_cells["cache_hits_total"].set(cache.hits)
                cache_cells["cache_misses_total"].set(cache.misses)
                cache_cells["cache_insertions_total"].set(cache.insertions)
                cache_cells["cache_flushes_total"].set(cache.flushes)
                cache_cells["cache_compactions_total"].set(cache.compactions)
                cache_cells["cache_stale_inserts_total"].set(
                    cache.stale_inserts_dropped)
                g_entries.set(len(cache))
                g_tomb.set(cache.tombstones)
            for (slots, keys), table in zip(probe_cells,
                                            (cache, self._pending)):
                if table is not None:
                    slots.set(table.probe_slots)
                    keys.set(table.probe_keys)
            g_gate.set(1.0 if self._gate_open else 0.0)
            g_inflight.set(len(self._inflight))
            es = self.engine.stats
            eng_cells["engine_packets_total"].set(int(es["packets"]))
            eng_cells["engine_bytes_in_total"].set(int(es["bytes_in"]))
            eng_cells["engine_bytes_out_total"].set(int(es["bytes_out"]))
            c_retrace.set(int(self.engine.trace_count))

        reg.register_collector(_collect)

    # -- ticket bookkeeping ------------------------------------------------

    def _alloc_tickets(self, n: int) -> np.ndarray:
        t0 = self._n_tickets
        self._n_tickets += n
        self._results.ensure(self._n_tickets)
        self._results.n = self._n_tickets
        if self._n_tickets > self._status.shape[0]:
            cap = self._status.shape[0]
            while cap < self._n_tickets:
                cap *= 2
            status = np.zeros(cap, np.uint8)
            status[: t0] = self._status[: t0]
            self._status = status
        return np.arange(t0, t0 + n, dtype=np.int64)

    def _mark_errors(self, tickets: np.ndarray, reason) -> None:
        """Resolve tickets as :class:`PacketError` slots.  ``reason`` is one
        string for the whole group or a per-ticket sequence."""
        self._status[tickets] = STATUS_ERROR
        if isinstance(reason, str):
            for t in tickets.tolist():
                self._errors[t] = PacketError(ticket=t, reason=reason)
        else:
            for t, r in zip(tickets.tolist(), reason):
                self._errors[t] = PacketError(ticket=t, reason=str(r))
        self.stats["ingress_errors_total"] += tickets.size
        if self.tracer is not None:
            self.tracer.on_retire(tickets)

    # -- ingress -----------------------------------------------------------

    def submit(self, pkts) -> Tuple[int, int]:
        """Accept one ragged per-connection chunk of ingress packets.

        Returns ``(first_ticket, n_packets)``.  Malformed packets occupy
        error slots; everything else resolves from cache or rides a device
        batch.  Never blocks on the device unless the in-flight window is
        full.  With ``flush_after`` set, an over-age partial staging batch
        is dispatched (padded) before this call returns.
        """
        d = self.stages.enter()
        try:
            first, n = self._submit(pkts)
            self._observe_rate(n)
            return first, n
        finally:
            try:
                self._maybe_flush_aged()
                self._maybe_close_deadline()
            finally:
                self.stages.leave(d)

    def poll(self) -> bool:
        """Latency-SLO tick for callers with idle arrival gaps: dispatch
        the partial staging batch if it has exceeded ``flush_after`` or if
        the oldest staged packet's remaining deadline budget has dropped
        to the measured dispatch cost.  Returns True when a dispatch
        happened.  No-op without either knob."""
        aged = self._maybe_flush_aged()
        return self._maybe_close_deadline() or aged

    def _maybe_flush_aged(self) -> bool:
        if self.flush_after is None or not self._open:
            return False
        now = self._clock()
        fired = False
        for fam, o in list(self._open.items()):
            if o.fill and now - o.t0 >= self.flush_after:
                self._dispatch(fam)
                fired = True
        return fired

    def _maybe_close_deadline(self) -> bool:
        """Deadline-aware batch closing: ship an open batch short (padded
        to its rung size — the same dispatch shape) rather than
        let its earliest staged deadline minus the measured dispatch cost
        pass.  The comparison is exact on the injectable clock: a batch
        ships when ``remaining <= dispatch_cost_ewma`` and waits at
        ``remaining`` one epsilon above it."""
        if not self._open or not self.cp.slo_active:
            return False
        now = self._clock()
        cost = self.dispatch_cost_ewma
        fired = False
        for fam, o in list(self._open.items()):
            if o.fill and o.deadline - now <= cost:
                self._dispatch(fam)
                fired = True
        return fired

    def _submit(self, pkts) -> Tuple[int, int]:
        arr = np.asarray(pkts)
        if arr.ndim != 2:
            raise ValueError("packet chunk must be 2-D (n_packets, wire_len)")
        arr = np.ascontiguousarray(arr, np.uint8)
        n, length = arr.shape
        first = self._n_tickets
        tickets = self._alloc_tickets(n)
        if n == 0:
            return first, 0
        self.stats["ingress_packets_total"] += n
        if length < HEADER_BYTES or length > self.wire_bytes:
            self._mark_errors(
                tickets, f"wire length {length} outside "
                         f"[{HEADER_BYTES}, {self.wire_bytes}]")
            return first, n

        k = self.stages.push(INGRESS_KEY)
        if length < self.wire_bytes:  # fixed wire shape: zero-pad the tail
            rows = np.zeros((n, self.wire_bytes), np.uint8)
            rows[:, :length] = arr
        else:
            rows = arr

        # per-packet validation: declared feature count must fit the parser's
        # static bound (P4 header-stack depth)
        fcnt = rows[:, 2].astype(np.int64)
        bad = fcnt > self.engine.max_features
        if bad.any():
            self._mark_errors(
                tickets[bad],
                f"feature count exceeds max_features={self.engine.max_features}")
            good = ~bad
            rows_g = rows[good]
            tickets_g = tickets[good]
            if rows_g.shape[0] == 0:
                self.stages.leave(k)
                return first, n
        else:
            rows_g, tickets_g = rows, tickets

        self._ingest(rows_g, tickets_g)
        self.stages.leave(k)
        return first, n

    def submit_features(self, x0, model_id, flags=None, *,
                        error_mask=None,
                        error_reason="rejected upstream") -> Tuple[int, int]:
        """Feature-domain ingress (the flow engine's entry): already-parsed
        int32 feature codes + Model IDs.  The wire-row **key** is still
        built (one vectorized encode — byte-identical to what the device
        encoder would emit for the same fields), so the two surfaces share
        one key space and e.g. a converged flow's rows hit entries a wire
        replay of the same features populated; but the parsed features ride
        along, so miss rows stage with no byte parse at all.  Returns
        ``(first_ticket, n_packets)``.

        ``error_mask`` marks rows an upstream stage already rejected
        (malformed raw headers, flow-table overflow): they take error slots
        at their submission-order positions — ``error_reason`` is one
        string or a per-row sequence — and never touch the cache, the
        pending window, or a device batch."""
        d = self.stages.enter()
        try:
            x0 = np.ascontiguousarray(x0, np.int32)
            n = x0.shape[0]
            first = self._n_tickets
            tickets = self._alloc_tickets(n)
            if n == 0:
                return first, 0
            self.stats["ingress_packets_total"] += n
            k = self.stages.push(INGRESS_KEY)
            mid = np.ascontiguousarray(model_id, np.int32).reshape(n)
            fl = (np.zeros(n, np.int32) if flags is None
                  else np.ascontiguousarray(flags, np.int32).reshape(n))
            tickets_g = tickets
            if error_mask is not None:
                em = np.asarray(error_mask, bool).reshape(n)
                if em.any():
                    reasons = (error_reason if isinstance(error_reason, str)
                               else np.asarray(error_reason, object)[em])
                    self._mark_errors(tickets[em], reasons)
                    good = np.nonzero(~em)[0]
                    if good.size == 0:
                        return first, n
                    x0, mid, fl = x0[good], mid[good], fl[good]
                    tickets_g = tickets[good]
            if x0.shape[1] < self.width:
                x0 = np.concatenate(
                    [x0, np.zeros((x0.shape[0], self.width - x0.shape[1]),
                                  np.int32)],
                    axis=1)
            from .packet import encode_packets_np
            rows = encode_packets_np(mid, self.engine.frac, x0, flags=fl)
            self._ingest(rows, tickets_g, parsed=(mid, fl, x0))
            self.stages.leave(k)
            self._observe_rate(n)
            return first, n
        finally:
            try:
                self._maybe_flush_aged()
                self._maybe_close_deadline()
            finally:
                self.stages.leave(d)

    def _ingest(self, rows: np.ndarray, tickets: np.ndarray,
                parsed=None) -> None:
        """The shared ingress path: cache lookup → dedup → pending window →
        lane-pure **feature-domain** staging, with the cold-traffic
        admission gate updated from this chunk's observed duplication.

        Keys are the raw wire rows (packed to uint64 words — the steady
        path touches nothing else); the byte parse happens **once, only
        for the fresh rows that will actually dispatch** (host twin of the
        device parser, bit-identical), or never, when the caller already
        has the parsed fields (``parsed = (mid, flags, x0)``).

        Entered in the ``ingress_key`` stage; each phase swaps the stage
        clock's innermost stage, which the caller closes.
        """
        n = rows.shape[0]
        stages = self.stages
        if self.tracer is not None:
            self.tracer.on_submit(tickets)
        words = pack_rows(rows, self.key_words)
        hashes = hash_words(words)
        stages.swap(INGRESS_LOOKUP)
        generation = self.cp.version
        if self.cache is not None:
            hit_mask, hit_vals = self.cache.lookup(words, generation, hashes)
        else:
            hit_mask = np.zeros(n, bool)
        if hit_mask.any():
            ht = tickets[hit_mask]
            self._results.a[ht] = hit_vals
            self._status[ht] = STATUS_READY
            n_hit = int(hit_mask.sum())
            self.stats["ingress_cache_hits_total"] += n_hit
            self.engine.credit_packets(n_hit)  # served without a dispatch
            if self.tracer is not None:
                self.tracer.on_retire(ht)  # short-circuit span closes here
            miss = ~hit_mask
            miss_sel = np.nonzero(miss)[0]
            miss_tickets = tickets[miss_sel]
            miss_words, miss_hashes = words[miss_sel], hashes[miss_sel]
        else:
            n_hit = 0
            miss_sel = np.arange(n)
            miss_tickets = tickets
            miss_words, miss_hashes = words, hashes
        if miss_sel.size == 0:
            self._observe_duplication(n, n)
            return

        # coalesce semantically-identical packets within the chunk: uniques
        # dispatch once, every duplicate ticket rides the same result row
        uniq_idx, inverse = _dedup_rows(miss_words, miss_hashes)
        n_uniq = uniq_idx.size
        uniq_words = miss_words[uniq_idx]
        uniq_hashes = miss_hashes[uniq_idx]

        # coalesce against the pending window: a unique row already staged or
        # in flight attaches to that dispatch's miss index instead of paying
        # a second device trip
        uniq_global = np.empty(n_uniq, np.int64)
        if self._pending is not None:
            pend_mask, pend_vals = self._pending.lookup(
                uniq_words, generation, uniq_hashes)
            if pend_mask.any():
                uniq_global[pend_mask] = pend_vals.view(np.int64).ravel()
            fresh = ~pend_mask
        else:
            fresh = np.ones(n_uniq, bool)
        n_fresh = int(fresh.sum())
        stages.swap(INGRESS_STAGE)

        # the one byte-parse of the serving path — fresh unique rows only
        # (or a slice of the caller's already-parsed fields)
        if n_fresh:
            fsel = miss_sel[uniq_idx[fresh]]
            if parsed is None:
                fresh_mid, _, fresh_flags, fresh_x0 = parse_packets_np(
                    rows[fsel], self.width)
            else:
                mid, flags, x0 = parsed
                fresh_x0 = x0[fsel]
                fresh_mid = mid[fsel]
                fresh_flags = flags[fsel]
        else:
            fresh_mid = fresh_flags = fresh_x0 = None

        # watermark controller (overload backpressure): fresh unique rows
        # past the high watermark answer on the reflex lane instead of
        # queueing; past hard capacity they shed as typed error slots —
        # first-occurrence order is submission order, so the split is
        # exact.  Cache hits, coalesced duplicates and pending-window
        # attaches consume no queue and always admit.
        act = (self._admission_actions(fresh_mid, uniq_idx[fresh])
               if n_fresh else None)
        if act is not None:
            keep = act == 0
            uact = np.zeros(n_uniq, np.int8)
            uact[fresh] = act
            pact = uact[inverse]
            n_stage = int(keep.sum())
            gidx = np.full(n_fresh, -1, np.int64)
            gidx[keep] = self._n_miss + np.arange(n_stage)
            uniq_global[fresh] = gidx
        else:
            keep = pact = None
            n_stage = n_fresh
            uniq_global[fresh] = self._n_miss + np.arange(n_fresh)
        self._n_miss += n_stage

        if pact is None:
            n_coalesced = miss_sel.size - n_fresh
        else:
            n_coalesced = int((pact == 0).sum()) - n_stage
        self.stats["ingress_coalesced_total"] += n_coalesced
        self.engine.credit_packets(n_coalesced)  # ride an existing dispatch
        self._observe_duplication(n, n_hit + n_coalesced)

        if pact is None:
            miss_idx = uniq_global[inverse]
            self._chunks.append(_ChunkRecord(
                tickets=miss_tickets,
                miss_idx=miss_idx,
                hi=int(miss_idx.max()) + 1))
        else:
            sel0 = pact == 0
            if sel0.any():
                miss_idx = uniq_global[inverse[sel0]]
                self._chunks.append(_ChunkRecord(
                    tickets=miss_tickets[sel0],
                    miss_idx=miss_idx,
                    hi=int(miss_idx.max()) + 1))
            if (pact == 1).any():
                self._serve_reflex(miss_tickets, inverse, pact, fresh, act,
                                   fresh_mid, fresh_flags, fresh_x0,
                                   generation)
            sel2 = pact == 2
            if sel2.any():
                shed = miss_tickets[sel2]
                self._mark_errors(shed, DEADLINE_SHED)
                self.stats["ingress_shed_total"] += shed.size
                self.obs.events.emit(
                    "deadline_shed", shard=self.shard_id,
                    generation=generation, count=int(shed.size),
                    depth=self.queue_depth())

        if n_stage:
            if keep is not None:
                s_x0, s_mid = fresh_x0[keep], fresh_mid[keep]
                s_flags = fresh_flags[keep]
                s_words = uniq_words[fresh][keep]
                s_hashes = uniq_hashes[fresh][keep]
                s_idx = uniq_global[fresh][keep]
                s_tickets = miss_tickets[uniq_idx[fresh]][keep]
            else:
                s_x0, s_mid, s_flags = fresh_x0, fresh_mid, fresh_flags
                s_words = uniq_words[fresh]
                s_hashes = uniq_hashes[fresh]
                s_idx = uniq_global[fresh]
                s_tickets = miss_tickets[uniq_idx[fresh]]
            # drift-injection chaos site: shift a feature lane's codes on
            # the fresh rows so the injected distribution shift rides
            # through real serving and the drift tap alike
            plan = self.fault_plan
            if plan is not None and plan.has_site("drift"):
                s_x0 = plan.shift_features(s_x0, self.shard_id)
            # model-quality feature tap: fresh staged rows only — the rows
            # that actually dispatch; byte-identical repeats short-circuit
            # above and carry no new distribution information
            drift = self.obs.drift
            if drift is not None:
                drift.observe_features(s_mid, s_x0)
            if self.shadow is not None:
                self.shadow.observe(s_tickets, s_x0, s_mid)
            if self.tracer is not None:
                self.tracer.on_stage(s_tickets, s_idx)
            if self._pending is not None and self._admit():
                idx_bytes = s_idx.reshape(-1, 1).view(np.uint8)
                self._pending.insert(s_words, idx_bytes,
                                     s_mid.astype(np.int64),
                                     generation, s_hashes,
                                     assume_unique=True)
            # per-row SLO deadlines (absolute clock seconds) ride into the
            # staging batch; each open batch tracks its earliest one
            deadlines = None
            if self.cp.slo_active:
                budget = self.cp.slo_budget_rows(s_mid)
                if np.isfinite(budget).any():
                    deadlines = self._clock() + budget * 1e-6
            # lane-pure staging: forest-family rows and MLP-family rows ride
            # separate fixed-shape batches, so each dispatch runs only its
            # own lane's compute (unknown ids stage as MLP — both lanes
            # egress zeros for them)
            if self.cp.forest_active:
                isf = self.cp.is_forest_id(s_mid)
            else:
                isf = None
            if isf is None or not isf.any():
                self._stage("mlp", s_x0, s_mid, s_flags,
                            s_words, s_hashes, s_idx, generation, deadlines)
            elif isf.all():
                self._stage("forest", s_x0, s_mid, s_flags,
                            s_words, s_hashes, s_idx, generation, deadlines)
            else:
                m = ~isf
                dm = deadlines[m] if deadlines is not None else None
                df = deadlines[isf] if deadlines is not None else None
                self._stage("mlp", s_x0[m], s_mid[m], s_flags[m],
                            s_words[m], s_hashes[m], s_idx[m],
                            generation, dm)
                self._stage("forest", s_x0[isf], s_mid[isf],
                            s_flags[isf], s_words[isf],
                            s_hashes[isf], s_idx[isf], generation, df)
        stages.swap(INGRESS_RETIRE)
        self._resolve_ready_chunks()

    # -- hard-latency layer ------------------------------------------------

    def queue_depth(self) -> int:
        """Model-lane backlog: staged-but-undispatched rows plus real rows
        in flight on the device — the watermark controller's signal.
        Completed device futures are reaped opportunistically first, so
        depth reflects the device's *actual* service rate: a fast shard's
        backlog drains between bursts while a saturated one's lingers."""
        self._reap_ready()
        d = 0
        for o in self._open.values():
            d += o.fill
        for rec in self._inflight:
            d += rec.count
        return d

    def _reap_ready(self) -> None:
        """Retire in-flight batches whose device future has already
        completed (non-blocking, oldest-first; stops at the first batch
        still cooking or held by the overload chaos site)."""
        while self._inflight and self._batch_ready(self._inflight[0],
                                                   self._clock()):
            self._retire_oldest()

    def _batch_ready(self, rec: _InFlight, by: float) -> bool:
        """Whether ``rec`` can retire at time ``by`` without blocking: the
        overload chaos site holds it no later than ``by``, and its
        completion event (``DeviceResult.is_ready``) has fired.  A future
        without an event counts as not ready; one whose poll raises counts
        as ready — :meth:`_retire_oldest` salvages it."""
        if rec.hold_until and rec.hold_until > by:
            return False
        ready = getattr(rec.future, "is_ready", None)
        if ready is None:
            return False
        try:
            return bool(ready())
        except Exception:  # noqa: BLE001 — retired via the salvage path
            return True

    def _admission_actions(self, mid: np.ndarray,
                           pos: np.ndarray) -> Optional[np.ndarray]:
        """Watermark controller: per-fresh-unique-row admission actions —
        0 = stage for the model lane, 1 = answer on the reflex lane,
        2 = shed.  Returns None when unconstrained (no bounds configured,
        or everything fits below the high watermark), so steady-state
        traffic pays one comparison.

        ``pos`` carries each unique row's submission position (the dedup
        hands uniques over in hash order), and admission is allocated in
        submission order: the earliest rows get the queue space — exactly
        what an in-order N=1 oracle would do.  Rows landing below the
        high watermark stage.  Past it, a row whose model has a reflex
        program answers there instead of queueing; a row without one
        keeps queueing up to hard capacity and sheds past it.  Depth
        counts model-lane rows only: cache hits, coalesced duplicates and
        reflex answers consume no queue."""
        cap = self.queue_capacity
        high = self.queue_high_watermark
        if cap is None and high is None:
            return None
        n = mid.shape[0]
        depth = self.queue_depth()
        high_eff = high if high is not None else cap
        free_high = max(0, high_eff - depth)
        if free_high >= n:
            return None
        order = np.argsort(pos, kind="stable")
        act_s = np.zeros(n, np.int8)            # submission-ordered view
        rem = np.arange(n) >= free_high
        if self.cp.reflex_active:
            rx = rem & self.cp.reflex_mask(mid[order])
        else:
            rx = np.zeros(n, bool)
        act_s[rx] = 1
        hard = rem & ~rx
        if hard.any() and cap is not None:
            free_cap = max(0, cap - depth - free_high)
            hidx = np.nonzero(hard)[0]
            act_s[hidx[free_cap:]] = 2
        act = np.empty(n, np.int8)
        act[order] = act_s
        return act

    def _serve_reflex(self, miss_tickets, inverse, pact, fresh, act,
                      fresh_mid, fresh_flags, fresh_x0, generation) -> None:
        """Answer overload rows on the reflex lane: evaluate each unique
        row's installed program (host numpy — no device round trip), emit
        ``FLAG_REFLEX``-tagged egress rows, resolve every ticket riding
        those rows, and hand the pairs to the async confirmer."""
        rxu = np.nonzero(act == 1)[0]              # fresh-row positions
        rx_mid = fresh_mid[rxu]
        rx_x0 = fresh_x0[rxu]
        rx_flags = fresh_flags[rxu]
        _, outw = self.cp.reflex_evaluate(rx_mid, rx_x0)
        out_codes = outw[:, : self.out_feats]
        rx_rows = emit_results_np(rx_mid, rx_flags | FLAG_REFLEX,
                                  out_codes, self.engine.frac)
        u_row = np.full(fresh.shape[0], -1, np.int64)
        u_row[np.nonzero(fresh)[0][rxu]] = np.arange(rxu.size)
        sel1 = pact == 1
        t1 = miss_tickets[sel1]
        self._results.a[t1] = rx_rows[u_row[inverse[sel1]]]
        self._status[t1] = STATUS_READY
        self.engine.credit_packets(t1.size)   # served without a dispatch
        self.stats["ingress_reflex_served_total"] += t1.size
        if self.tracer is not None:
            self.tracer.on_retire(t1)
        self.obs.events.emit("reflex_served", shard=self.shard_id,
                             generation=generation, count=int(t1.size),
                             depth=self.queue_depth())
        if self.reflex_confirm is not None:
            self.reflex_confirm.observe(rx_x0, rx_mid, out_codes)

    # -- cold-traffic admission gate --------------------------------------

    def _observe_duplication(self, n: int, short_circuited: int) -> None:
        """Fold one chunk's observed short-circuit rate into the admission
        EWMA and step the gate's hysteresis: an open gate closes when the
        EWMA falls below the threshold; a closed gate re-opens at the
        threshold divided by the probe stride, because a closed gate's hit
        rate is stride-attenuated (only the 1-in-``_PROBE_STRIDE`` probe
        sample is in the cache to be hit) — both comparisons measure the
        same ≥5% true duplication (see the class comment)."""
        if n:
            obs = short_circuited / n
            self._dup_ewma = (self._ADMIT_ALPHA * self._dup_ewma
                              + (1.0 - self._ADMIT_ALPHA) * obs)
            was_open = self._gate_open
            if self._gate_open:
                self._gate_open = self._dup_ewma >= self._ADMIT_THRESHOLD
            else:
                self._gate_open = (self._dup_ewma >= self._ADMIT_THRESHOLD
                                   / self._PROBE_STRIDE)
            if self._gate_open != was_open:
                self.obs.events.emit(
                    "gate_open" if self._gate_open else "gate_closed",
                    shard=self.shard_id, generation=self.cp.version,
                    dup_ewma=round(self._dup_ewma, 4))

    def _admit(self) -> bool:
        """True when cache/pending insert sweeps are currently worth their
        cost (recent traffic showed duplication)."""
        return self._gate_open

    def _pick_size(self) -> int:
        """Load-adaptive device batch size for a newly-opened staging batch:
        the largest ladder rung the EWMA'd arrival rate would fill within
        the latency horizon (``flush_after``, else a 5 ms default), so
        light traffic rides small batches and sustained load the full one.
        With ``adaptive_batch=False`` the ladder is a single rung."""
        if len(self.batch_sizes) == 1:
            return self.batch_sizes[0]
        horizon = self.flush_after if self.flush_after is not None else 0.005
        expect = self._rate_ewma * horizon
        size = self.batch_sizes[0]
        for s in self.batch_sizes:
            if s <= expect:
                size = s
        return size

    def _observe_rate(self, n: int) -> None:
        if not self.adaptive_batch:
            return
        now = self._clock()
        if self._last_submit_t is not None:
            dt = now - self._last_submit_t
            inst = n / dt if dt > 1e-9 else self._rate_ewma
            self._rate_ewma = 0.5 * self._rate_ewma + 0.5 * inst
        self._last_submit_t = now

    def _open_batch(self, family: str, generation: int) -> _OpenBatch:
        while not self._free_bufs:  # pool sized so this never loops, but
            self._retire_oldest()   # stay safe if invariants ever shift
        o = _OpenBatch(family=family, buf=self._free_bufs.popleft(),
                       size=self._pick_size(), fill=0,
                       t0=self._clock(), gen0=generation,
                       miss_idx=np.empty(self.batch_size, np.int64))
        self._open[family] = o
        return o

    def _stage(self, family: str, x0: np.ndarray, mid: np.ndarray,
               flags: np.ndarray, words: np.ndarray, hashes: np.ndarray,
               miss_idx: np.ndarray, generation: int,
               deadlines: Optional[np.ndarray] = None) -> None:
        """Append unique miss rows (parsed feature codes + header fields,
        plus their packed key words/hashes and global miss indices) to the
        family's staging batch, dispatching every time it reaches its
        device size.  ``deadlines`` (absolute clock seconds per row, inf
        when the row's model has no SLO) folds into the open batch's
        earliest deadline, which the deadline-aware closer watches."""
        pos = 0
        total = x0.shape[0]
        while pos < total:
            o = self._open.get(family)
            if o is None:
                o = self._open_batch(family, generation)
            space = o.size - o.fill
            take = min(space, total - pos)
            lo, hi = o.fill, o.fill + take
            self._stg_x0[o.buf][lo:hi] = x0[pos: pos + take]
            self._stg_mid[o.buf][lo:hi] = mid[pos: pos + take]
            self._stg_flags[o.buf][lo:hi] = flags[pos: pos + take]
            self._staging_words[o.buf][lo:hi] = words[pos: pos + take]
            self._staging_hashes[o.buf][lo:hi] = hashes[pos: pos + take]
            o.miss_idx[lo:hi] = miss_idx[pos: pos + take]
            if deadlines is not None:
                dmin = float(deadlines[pos: pos + take].min())
                if dmin < o.deadline:
                    o.deadline = dmin
            o.fill += take
            pos += take
            if o.fill == o.size:
                self._dispatch(family)

    def _dispatch(self, family: Optional[str] = None) -> None:
        if family is None:  # flush path: every open batch goes out
            for fam in list(self._open):
                self._dispatch(fam)
            return
        o = self._open.pop(family, None)
        if o is None:
            return
        stages = self.stages
        k = stages.push(ENGINE_DISPATCH)
        while len(self._inflight) >= self.max_inflight:
            self._retire_oldest()
        size = o.size
        x0 = self._stg_x0[o.buf][:size]
        mid = self._stg_mid[o.buf][:size]
        count = o.fill
        in_row = HEADER_BYTES + FEATURE_BYTES * self.width
        out_row = self.out_bytes
        if count < size:
            # dead padding rows: Model ID 0, which the id_map resolves to
            # "not installed" → zeroed egress, discarded at retire
            x0[count:] = 0
            mid[count:] = 0
            self._stg_flags[o.buf][count:size] = 0
            self.stats["ingress_padded_rows_total"] += size - count
            # engine.run_features counts the whole batch — padding is not
            # traffic
            self.engine.credit_packets(count - size)
        gen_before = self.cp.version
        # the family classification is only as current as its generation: a
        # racing install()/remove() may have reassigned an id, so fall back
        # to the always-correct both-lane program for this batch
        lanes = o.family if gen_before == o.gen0 else "both"
        t_issue = stages.last  # before the batch's first device call
        events = None if self._events is None else self._events[o.buf]
        try:
            future = self._run_guarded(x0, mid, lanes, events)
            gen_after = self.cp.version
            if lanes != "both" and gen_after != gen_before:
                # a table write landed between the lane decision and the
                # run's snapshot — the lane-pure program may now be wrong
                # for this batch (e.g. an id reassigned across families).
                # Discard that dispatch and redo on the both-lane program,
                # which is correct under any generation's tables.
                self.engine.credit_packets(-size)  # never served
                self.engine.credit_bytes(-size * in_row, -size * out_row)
                lanes = "both"
                gen_before = self.cp.version
                future = self._run_guarded(x0, mid, lanes, events)
                gen_after = self.cp.version
        except Exception as err:
            # every retry exhausted at the dispatch site: the device never
            # accepted this batch.  Salvage row-by-row with same-shape
            # probes; unservable rows resolve as PacketError (drain never
            # hangs, the server never dies).
            self.stats["ingress_dispatch_failures_total"] += 1
            self._salvage_failed_batch(o.buf, o.miss_idx[:count].copy(),
                                       count, size, lanes, err)
            stages.leave(k)
            return
        generation = gen_before if gen_after == gen_before else None
        # overload chaos (slow-device): an armed factor holds this batch's
        # retire until factor× the measured cost has elapsed — rows linger
        # in flight exactly as they would behind a saturated device, so
        # the watermark controller sees the backlog and sheds shard-local
        hold = 0.0
        plan = self.fault_plan
        if plan is not None and plan.has_site("overload"):
            factor = plan.overload_factor(self.shard_id, mid[:count])
            if factor > 1.0:
                # capped so a chaos spec can never wedge a retire for more
                # than one bounded-drain window's worth of wall time
                hold = self._clock() + min(
                    (factor - 1.0) * max(self.dispatch_cost_ewma, 1e-4),
                    self._OVERLOAD_HOLD_CAP)
        self._inflight.append(_InFlight(
            future=future, miss_idx=o.miss_idx[:count].copy(), count=count,
            size=size, buf_idx=o.buf, generation=generation, lanes=lanes,
            t_dispatch=self._clock(), t_issue=t_issue, hold_until=hold))
        self.stats["ingress_dispatched_rows_total"] += size
        self.stats["ingress_batches_total"] += 1
        self.stats["lane_batches"][lanes] += 1
        if self.tracer is not None:
            self.tracer.on_dispatch(
                o.miss_idx[:count], at=t_issue if self._event_stamps else None)
        stages.leave(k)

    def _run_guarded(self, x0: np.ndarray, mid: np.ndarray, lanes: str,
                     events=None):
        """One device dispatch under the fault plan and the bounded
        retry-with-backoff policy.  The stall site fires first (an injected
        wedge a supervising watchdog must notice — it delays, never
        raises); a dispatch-site fault or a real engine error is retried
        ``max_retries`` times with exponential backoff before giving up.
        ``events`` is the staging buffer's timing-event pair (the card)."""
        last = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.stats["ingress_dispatch_retries_total"] += 1
                if self.retry_backoff:
                    time.sleep(self.retry_backoff * (1 << (attempt - 1)))
            try:
                plan = self.fault_plan
                if plan is not None:
                    plan.fire("stall", self.shard_id, mid)
                    plan.fire("dispatch", self.shard_id, mid)
                return self.engine.run_features(x0, mid, block=False,
                                                lanes=lanes, events=events)
            except Exception as e:  # noqa: BLE001 — any device failure
                last = e
        raise last

    # -- failure salvage ---------------------------------------------------

    def _salvage_failed_batch(self, buf: int, miss_idx: np.ndarray,
                              count: int, size: int, lanes: str,
                              err: Exception) -> None:
        """A batch the device would not serve (dispatch raised after every
        retry, or its future raised at retire): bisect it with same-shape
        probe dispatches to quarantine the offending rows, serve the rest,
        and resolve every miss row either way — the failure never strands a
        ticket.  Reuses the failing batch's lane program and shape, so the
        probes add no new dispatch shape."""
        in_row = HEADER_BYTES + FEATURE_BYTES * self.width
        out_row = self.out_bytes
        ok, out = self._bisect_probe(buf, count, size, lanes)
        n_ok = int(ok.sum())
        if n_ok:
            # some rows served — the device is alive, the failure was the
            # batch's content (or transient): not a shard-death signal
            self.consecutive_dispatch_failures = 0
            self.stats["ingress_quarantined_rows_total"] += count - n_ok
        else:
            self.consecutive_dispatch_failures += 1
        hi = int(miss_idx.max()) + 1 if miss_idx.size else 0
        self._miss_out.ensure(hi)
        self._miss_out.a[miss_idx] = 0
        if n_ok:
            rows = emit_results_np(
                self._stg_mid[buf][:count][ok],
                self._stg_flags[buf][:count][ok],
                out[ok], self.engine.frac)
            self._miss_out.a[miss_idx[ok]] = rows
        self._miss_out.n = max(self._miss_out.n, hi)
        self._ensure_retired(self._n_miss)
        self._miss_retired[miss_idx] = True
        if count - n_ok:
            self._miss_failed[miss_idx[~ok]] = 1
        rem = self._miss_retired[self._miss_done: self._n_miss]
        self._miss_done = (self._n_miss if rem.all()
                           else self._miss_done + int(np.argmin(rem)))
        # one batch's worth of engine accounting (the probes all
        # self-cancel): +size packets rejoins the -(size-count) padding
        # adjustment applied at dispatch for a net of `count`, exactly the
        # success path.  Quarantined batches stay out of the result cache.
        self.engine.credit_packets(size)
        self.engine.credit_bytes(size * in_row, size * out_row)
        self._free_bufs.append(buf)
        self._resolve_ready_chunks()

    def _bisect_probe(self, buf: int, count: int, size: int, lanes: str
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Group-bisection over a failing batch's real rows: probe subsets
        with **same-shape** dispatches (unselected rows zeroed to Model ID
        0 — uninstalled, zero egress — so every probe reuses the failing
        batch's dispatch shape).  Returns ``(ok_mask, outputs)`` over the
        ``count`` real rows; rows never cleared by a passing probe within
        the probe budget stay quarantined.  Probe credits self-cancel —
        the caller accounts the batch once."""
        x0 = self._stg_x0[buf][:size]
        mid = self._stg_mid[buf][:size]
        in_row = HEADER_BYTES + FEATURE_BYTES * self.width
        out_row = self.out_bytes
        ok = np.zeros(count, bool)
        out = np.zeros((count, self.out_feats), np.int32)
        plan = self.fault_plan

        def probe(sel: np.ndarray) -> np.ndarray:
            self.stats["ingress_probe_batches_total"] += 1
            xp = np.zeros((size, self.width), np.int32)
            mp = np.zeros(size, np.int32)
            xp[sel] = x0[sel]
            mp[sel] = mid[sel]
            if plan is not None:
                plan.fire("stall", self.shard_id, mp)
                plan.fire("dispatch", self.shard_id, mp)
            fut = self.engine.run_features(xp, mp, block=False, lanes=lanes)
            try:  # run_features credited on return — self-cancel even on a
                return np.asarray(fut)  # future that raises here
            finally:
                self.engine.credit_packets(-size)
                self.engine.credit_bytes(-size * in_row, -size * out_row)

        # worst case the bisection degenerates to one probe per row (every
        # row bad, tested individually, plus the interior splits) — 2n
        # bounds that; typical cost is O(k log n) for k bad rows
        budget = 2 * count + 8
        stack = [np.arange(count)]
        while stack and budget > 0:
            sel = stack.pop()
            budget -= 1
            try:
                res = probe(sel)
            except Exception:  # noqa: BLE001 — split and keep probing
                if sel.size > 1:
                    half = sel.size // 2
                    stack.append(sel[half:])
                    stack.append(sel[:half])
                continue
            ok[sel] = True
            out[sel] = res[sel, : self.out_feats]
        return ok, out

    # -- retire ------------------------------------------------------------

    def _ensure_retired(self, n: int) -> None:
        if n > self._miss_retired.shape[0]:
            cap = self._miss_retired.shape[0]
            while cap < n:
                cap *= 2
            a = np.zeros(cap, bool)
            a[: self._miss_retired.shape[0]] = self._miss_retired
            self._miss_retired = a
            f = np.zeros(cap, np.uint8)
            f[: self._miss_failed.shape[0]] = self._miss_failed
            self._miss_failed = f

    def _retire_oldest(self) -> None:
        stages = self.stages
        k = stages.push(INGRESS_WAIT)
        rec = self._inflight.popleft()
        if rec.hold_until:
            rem = rec.hold_until - self._clock()
            if rem > 0:       # injected slow device: the batch is not done
                time.sleep(rem)
        try:
            out = np.asarray(rec.future)  # blocks until the batch is done
        except Exception as err:  # noqa: BLE001 — device died mid-batch
            stages.swap(ENGINE_DISPATCH)  # the salvage's probe dispatches
            # run_features credited this batch when it dispatched; cancel
            # so the salvage pass accounts it exactly once
            in_row = HEADER_BYTES + FEATURE_BYTES * self.width
            self.engine.credit_packets(-rec.size)
            self.engine.credit_bytes(-rec.size * in_row,
                                     -rec.size * self.out_bytes)
            self.stats["ingress_dispatch_failures_total"] += 1
            self._salvage_failed_batch(rec.buf_idx, rec.miss_idx, rec.count,
                                       rec.size, rec.lanes, err)
            stages.leave(k)
            return
        stages.swap(INGRESS_RETIRE)
        # a whole batch came back: the device is alive
        self.consecutive_dispatch_failures = 0
        # measured dispatch→retire cost feeds the deadline-aware closer:
        # an EWMA seeded from the first retired batch, so the scheduler's
        # notion of "how long a trip costs" tracks the device it has
        dt = self._clock() - rec.t_dispatch
        self.dispatch_cost_ewma = (
            dt if self.dispatch_cost_ewma == 0.0
            else (1.0 - self._COST_ALPHA) * self.dispatch_cost_ewma
            + self._COST_ALPHA * dt)
        done_at = None
        if self._events is not None:
            # the batch's own events: its first copy in to its copy back,
            # on the device clock (done has fired: the wait above)
            start, done = self._events[rec.buf_idx]
            dev_s = start.elapsed_time(done) * 1e-3
            self._c_device.value += dev_s
            if self._event_stamps:
                done_at = rec.t_issue + dev_s
        if self.tracer is not None:
            self.tracer.on_device_done(rec.miss_idx, at=done_at)
        # model-quality prediction tap: per-model egress-code distribution
        # over the batch's real rows (int32 output codes, pre-encode)
        drift = self.obs.drift
        if drift is not None:
            drift.observe_predictions(
                self._stg_mid[rec.buf_idx][: rec.count],
                out[: rec.count, : self.out_feats])
        # the one egress encode of the serving path (host twin of the
        # device deparser, byte-identical): int32 output codes → wire rows
        rows = emit_results_np(self._stg_mid[rec.buf_idx][: rec.count],
                               self._stg_flags[rec.buf_idx][: rec.count],
                               out[: rec.count, : self.out_feats],
                               self.engine.frac)
        plan = self.fault_plan
        if plan is not None:
            rows = plan.corrupt_egress(rows, self.shard_id)
        # egress verification (the wire CRC stand-in): every emitted row
        # must echo the Model ID it was staged with — emit_results_np
        # writes the id itself, so a mismatch means the row bytes were
        # damaged after encode and must not reach the caller or the cache
        echo = (rows[:, 0].astype(np.int32) << 8) | rows[:, 1]
        bad = echo != self._stg_mid[rec.buf_idx][: rec.count]
        idx = rec.miss_idx
        hi = int(idx.max()) + 1 if idx.size else 0
        self._miss_out.ensure(hi)
        self._miss_out.a[idx] = rows
        self._miss_out.n = max(self._miss_out.n, hi)
        self._ensure_retired(self._n_miss)
        self._miss_retired[idx] = True
        if bad.any():
            self._miss_failed[idx[bad]] = 2
            self.stats["ingress_corrupted_rows_total"] += int(bad.sum())
        # family batches retire out of global-index order; chunks resolve
        # against the fully-retired prefix
        rem = self._miss_retired[self._miss_done: self._n_miss]
        self._miss_done = (self._n_miss if rem.all()
                           else self._miss_done + int(np.argmin(rem)))
        if self.cache is not None and rec.generation is not None \
                and not bad.any():
            # gate open: admit the whole batch; gate closed: admit a stride
            # sample so reappearing cross-chunk duplication still produces
            # the hits that re-open the gate (see the class comment).
            # A batch with corrupted rows stays out entirely — a damaged
            # egress row must never be replayed from the cache.
            sl = (slice(None, rec.count) if self._admit()
                  else slice(None, rec.count, self._PROBE_STRIDE))
            words = self._staging_words[rec.buf_idx][sl]
            hashes = self._staging_hashes[rec.buf_idx][sl]
            mids = self._stg_mid[rec.buf_idx][sl].astype(np.int64)
            self.cache.insert(words, rows[sl], mids, rec.generation, hashes,
                              assume_unique=True)
        self._free_bufs.append(rec.buf_idx)
        self._resolve_ready_chunks()
        stages.leave(k)

    _FAIL_REASONS = {
        1: "device dispatch failed — row quarantined",
        2: "egress row corrupted — dropped at verification",
    }

    def _resolve_ready_chunks(self) -> None:
        """Deliver results for head chunks whose every miss row has retired
        (chunks attaching only to already-retired rows resolve straight from
        submit — no further device traffic involved).  Miss rows that
        retired as failures resolve their tickets to PacketError slots."""
        while self._chunks and self._chunks[0].hi <= self._miss_done:
            ch = self._chunks.popleft()
            if self.tracer is not None:
                self.tracer.on_retire(ch.tickets)
            fail = self._miss_failed[ch.miss_idx]
            if fail.any():
                bad = fail > 0
                codes = fail[bad]
                self._mark_errors(
                    ch.tickets[bad],
                    [self._FAIL_REASONS[int(c)] for c in codes])
                good = ~bad
                self._results.a[ch.tickets[good]] = \
                    self._miss_out.a[ch.miss_idx[good]]
                self._status[ch.tickets[good]] = STATUS_READY
            else:
                self._results.a[ch.tickets] = self._miss_out.a[ch.miss_idx]
                self._status[ch.tickets] = STATUS_READY

    def flush(self, timeout_us: Optional[float] = None) -> None:
        """Dispatch the partial staging batch (padded to the fixed shape) and
        retire every in-flight batch; afterwards every submitted ticket is
        READY or ERROR.

        With ``timeout_us`` the retire loop is bounded: once the window
        expires, every still-PENDING ticket backfills as
        ``PacketError(DRAIN_TIMEOUT)`` instead of blocking on a wedged
        device.  The bound is best-effort by one step — a single retire
        that wedges *inside* the window can overshoot it by its own
        duration (retires block; there is no preemption).  On the card a
        bounded flush polls each batch's completion event
        (``DeviceResult.is_ready``) against the window before it retires
        the batch, so it never blocks on a device queue, and a batch that
        the ``"overload"`` chaos site holds past the window counts as not
        ready."""
        deadline = (None if timeout_us is None
                    else self._clock() + float(timeout_us) * 1e-6)
        expired = False
        stages = self.stages
        self._dispatch()
        while self._inflight:
            if deadline is not None and (
                    self._clock() >= deadline
                    or not self._ready_by(self._inflight[0], deadline)):
                expired = True
                break
            self._retire_oldest()
        if not expired and (self.shadow is not None
                            or self.reflex_confirm is not None):
            k = stages.push(ENGINE_DISPATCH)  # their replay dispatches
            if self.shadow is not None:
                self.shadow.flush()
            if self.reflex_confirm is not None:
                self.reflex_confirm.flush()
            stages.leave(k)
        k = stages.push(INGRESS_RETIRE)
        self._resolve_ready_chunks()
        if expired:
            stages.swap(INGRESS_DRAIN)
            self._abandon_pending()
        stages.leave(k)
        assert not self._chunks, "unresolved chunks after full retire"

    _POLL_S = 20e-6  # sleep between completion-event polls

    def _ready_by(self, rec: _InFlight, deadline: float) -> bool:
        """Poll :meth:`_batch_ready` until ``rec`` can retire by the
        bounded flush's ``deadline`` (True) or the deadline passes, or the
        overload site holds ``rec`` past it (False)."""
        while not self._batch_ready(rec, deadline):
            if rec.hold_until > deadline or self._clock() >= deadline:
                return False
            time.sleep(self._POLL_S)
        return True

    def _abandon_pending(self) -> None:
        """A bounded drain expired: resolve every still-PENDING ticket as
        ``PacketError(DRAIN_TIMEOUT)`` and drop the work that would have
        produced it (chunk records and in-flight bookkeeping — the futures
        themselves are joined by :meth:`reset_tickets`)."""
        n = self._n_tickets
        pending = np.nonzero(self._status[:n] == STATUS_PENDING)[0]
        self._mark_errors(pending.astype(np.int64), DRAIN_TIMEOUT)
        self.stats["ingress_drain_timeouts_total"] += 1
        self.obs.events.emit(
            "drain_timeout", shard=self.shard_id,
            generation=int(self.cp.version),
            backfilled=int(pending.size), inflight=len(self._inflight))
        self._chunks.clear()

    # -- egress ------------------------------------------------------------

    def results_array(self) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized egress view: ``(status, rows)`` over all tickets in
        submission order (rows of ERROR tickets are unspecified).  Call
        :meth:`flush` first to guarantee nothing is PENDING."""
        n = self._n_tickets
        return self._status[:n].copy(), self._results.a[:n].copy()

    def drain(self, timeout_us: Optional[float] = None
              ) -> List[Union[np.ndarray, PacketError]]:
        """Flush, then return one entry per submitted packet in submission
        order — an egress row, or a :class:`PacketError` slot — and reset
        ticket state (the cache persists across drains).  ``timeout_us``
        bounds the flush (see :meth:`flush`); expired tickets come back as
        ``PacketError(DRAIN_TIMEOUT)`` slots in their submission
        positions."""
        d = self.stages.enter()
        try:
            self.flush(timeout_us)
            self.stages.push(INGRESS_DRAIN)
            status, rows = self.results_array()
            if not self._errors:  # common case: one vectorized unpack
                out: List[Union[np.ndarray, PacketError]] = list(rows)
            else:
                out = [self._errors[t] if status[t] == STATUS_ERROR
                       else rows[t] for t in range(self._n_tickets)]
            self.reset_tickets()
            return out
        finally:
            self.stages.leave(d)

    def reset_tickets(self) -> None:
        """Forget delivered tickets/results (between serving windows).

        Any unfinished work is discarded: staged-but-undispatched rows are
        dropped and in-flight batches are retired to the floor (blocking
        first, so a staging buffer is never overwritten while the device
        may still read it).  Miss indices restart at zero, so stale chunk
        records or pending-window mappings must never survive the reset.
        """
        for rec in self._inflight:
            try:
                rec.future.block_until_ready()
            except Exception:  # noqa: BLE001 — results are being discarded;
                pass           # a failed future must not break the reset
        self._inflight.clear()
        self._chunks.clear()
        self._open.clear()
        self._free_bufs = deque(range(len(self._stg_x0)))
        self._n_tickets = 0
        self._results.reset()
        self._status[:] = 0
        self._errors.clear()
        self._n_miss = 0
        self._miss_done = 0
        self._miss_out.reset()
        self._miss_retired[:] = False
        self._miss_failed[:] = 0
        if self._pending is not None:
            self._pending.clear()
        if self.tracer is not None:
            # tickets and miss indices restart at zero: open spans from the
            # old namespace must not alias the new one (closed spans keep)
            self.tracer.clear_open()

    # -- maintenance hooks -------------------------------------------------

    def on_model_removed(self, model_id: int) -> None:
        """Drop a removed model's cached egress rows immediately (the
        generation bump already makes them unreachable; this frees slots)."""
        if self.cache is not None:
            self.cache.drop_model(model_id)

    def cache_hit_rate(self) -> float:
        return self.cache.hit_rate() if self.cache is not None else 0.0
