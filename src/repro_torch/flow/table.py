"""Vectorized open-addressing flow table — the stateful register file a
P4 SmartNIC keys on the 5-tuple.

Counterpart of ``repro.flow.table`` (the same probes, claims, expiry,
compaction, eviction and overflow rejection, so one key stream gives the
reference's slots).  The register file is a host numpy array: the table
zeroes rows on claim, expiry and eviction between batches, and a shard's
registers therefore never live only on a device.

Same storage discipline as the ingress
:class:`~repro_torch.core.ingress.ResultCache`
(64-bit key hash + exact word-wise verify, double hashing over a
power-of-two table, tombstone compaction) but with *ownership* semantics
instead of cache semantics: a lookup that misses **claims** a slot (zeroed
registers — a new flow), a hit returns the slot whose register row the
flow-update kernel then mutates, and the table is never allowed to fail —
when space runs out it makes room (expire idle flows → compact → as a last
resort flush the whole table, the hardware register-file eviction
analogue).

The safety property the reference's tests assert by construction and by
hypothesis: **a slot never serves another flow's registers** — every claim
(new flow, idle-expired flow, any slot reuse after eviction) zeroes the
register row before the kernel ever sees it, and exact key verification
means hash collisions can only cost probes, never alias two flows.

Slots are only meaningful within one ``lookup_or_insert`` call's batch (the
frontend resolves, updates, and drops them); compaction and flushes may
relocate flows between batches, which is why the table hands out slots per
batch instead of stable flow handles.  ``generation`` counts those
relocation events.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.ingress import _dedup_rows, hash_words, pack_rows
from ..kernels.ref import N_FLOW_REGISTERS, REG_LAST_TS, REG_PKT_COUNT

__all__ = ["FlowTable"]


class FlowTable:
    """Open-addressing 5-tuple → register-row table with idle expiry.

    Parameters
    ----------
    key_words:
        Packed key width in uint64 words
        (:func:`~repro_torch.core.ingress.pack_rows`).
    capacity_pow2:
        ``2**capacity_pow2`` slots — the register-file size, a synthesis-time
        bound like every other table in this repo.
    idle_timeout:
        Ticks of inactivity after which a flow's state expires (its next
        packet restarts the flow with zeroed registers — the P4 register
        aging analogue).  ``None`` disables expiry.
    load_limit / tombstone_limit / max_probe:
        Same roles as in ``ResultCache``.
    """

    def __init__(self, key_words: int, *, capacity_pow2: int = 14,
                 max_probe: int = 32, load_limit: float = 0.7,
                 tombstone_limit: float = 0.25,
                 idle_timeout: Optional[int] = None):
        if key_words <= 0:
            raise ValueError("key_words must be positive")
        if idle_timeout is not None and idle_timeout <= 0:
            raise ValueError("idle_timeout must be positive ticks (or None)")
        cap = 1 << capacity_pow2
        self._cap = cap
        self._mask = np.int64(cap - 1)
        self._max_probe = max_probe
        self._load_limit = load_limit
        self._tombstone_limit = tombstone_limit
        self.key_words = key_words
        self.idle_timeout = idle_timeout
        self._keys = np.zeros((cap, key_words), np.uint64)
        self._slot_state = np.zeros(cap, np.uint8)  # 0 empty·1 live·2 tomb
        self.registers = np.zeros((cap, N_FLOW_REGISTERS), np.int32)
        self._count = 0
        self._tombstones = 0
        self.generation = 0  # bumped whenever slots may have moved/reset
        # Canonical metric names (``flow_<noun>_total`` — see README
        # "Observability").  Cells are standalone counters; a serving
        # wrapper grafts them into its shared registry
        # (``MetricsRegistry.attach``) so a fabric exports per-shard flow
        # stats without touching this class.
        from ..obs import Counter, StatsAdapter
        stats = StatsAdapter()
        for canonical in ("flow_lookups_total",
                          "flow_hits_total",
                          "flow_created_total",
                          "flow_expiries_total",
                          "flow_evictions_total",
                          "flow_flushes_total",
                          "flow_compactions_total",
                          "flow_rejects_total",
                          "flow_adopted_total"):
            stats.bind(canonical, Counter())
        self.stats = stats

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._cap

    def hit_rate(self) -> float:
        n = self.stats["flow_lookups_total"]
        return self.stats["flow_hits_total"] / n if n else 0.0

    # -- internals ---------------------------------------------------------

    def _slots_steps(self, hashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        slot = (hashes & np.uint64(self._mask)).astype(np.int64)
        step = ((((hashes >> np.uint64(32)) << np.uint64(1)) | np.uint64(1))
                .astype(np.int64)) & self._mask
        return slot, step

    def _probe(self, words: np.ndarray, hashes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized full probe of distinct keys: returns ``(match_slot,
        free_slot)`` — the live slot holding the key (else -1) and the first
        reusable (empty/tombstone) slot on its chain (else -1)."""
        n = words.shape[0]
        slot, step = self._slots_steps(hashes)
        match = np.full(n, -1, np.int64)
        free = np.full(n, -1, np.int64)
        cur = slot.copy()
        active = np.arange(n)
        for _ in range(self._max_probe):
            if active.size == 0:
                break
            s = cur[active]
            st = self._slot_state[s]
            m = (self._keys[s] == words[active]).all(axis=1) & (st == 1)
            match[active[m]] = s[m]
            ff = (st != 1) & (free[active] < 0)
            free[active[ff]] = s[ff]
            keep = ~m & (st != 0)  # an empty slot terminates the chain
            active = active[keep]
            cur[active] = (cur[active] + step[active]) & self._mask
        return match, free

    def _flush(self) -> None:
        """Wholesale eviction — the register-file reset.  Every live flow's
        state is discarded (counted as evictions); the next packet of any
        flow starts it fresh."""
        self.stats["flow_evictions_total"] += self._count
        self.stats["flow_flushes_total"] += 1
        self._slot_state[:] = 0
        self.registers[:] = 0
        self._count = 0
        self._tombstones = 0
        self.generation += 1

    def _insert_new(self, words: np.ndarray, hashes: np.ndarray,
                    regs: Optional[np.ndarray] = None) -> np.ndarray:
        """Claim slots for distinct keys known to be absent.  Returns the
        claimed slots.  Collisions on one free slot are arbitrated
        (np.unique); losers re-probe against the updated table, so the loop
        settles every key (a flush above guarantees chain headroom)."""
        n = words.shape[0]
        out = np.full(n, -1, np.int64)
        pending = np.arange(n)
        while pending.size:
            match, free = self._probe(words[pending], hashes[pending])
            if (match >= 0).any():
                # a duplicate key slipped past the caller's dedup (fold
                # collision) and its twin already claimed: resolve, never
                # double-claim — one flow must never own two register rows
                m = match >= 0
                out[pending[m]] = match[m]
                pending = pending[~m]
                free = free[~m]
                if pending.size == 0:
                    break
            if (free < 0).any():
                # chains exhausted mid-claim: evict everything and restart
                # (claims already made in this call re-claim cleanly below
                # only for still-pending keys; settled keys keep their
                # slots only if no flush happened — so re-claim all)
                self._flush()
                pending = np.arange(n)
                out[:] = -1
                continue
            uniq, first = np.unique(free, return_index=True)
            wi = pending[first]
            ws = free[first]
            self._tombstones -= int((self._slot_state[ws] == 2).sum())
            self._keys[ws] = words[wi]
            self._slot_state[ws] = 1
            self.registers[ws] = 0 if regs is None else regs[wi]
            self._count += ws.size
            out[wi] = ws
            settled = np.isin(pending, wi, assume_unique=True)
            pending = pending[~settled]
        return out

    def _compact(self) -> None:
        """Rebuild in place: live flows re-hash onto tombstone-free chains,
        registers move with their keys."""
        live = np.nonzero(self._slot_state == 1)[0]
        keys = self._keys[live].copy()
        regs = self.registers[live].copy()
        self._slot_state[:] = 0
        self.registers[:] = 0
        self._count = 0
        self._tombstones = 0
        self.stats["flow_compactions_total"] += 1
        self.generation += 1
        if keys.shape[0]:
            self._insert_new(keys, hash_words(keys), regs)

    def expire(self, now: int) -> int:
        """Tombstone every flow idle for more than ``idle_timeout`` ticks
        (their registers are dead; the slot is reusable).  Returns the
        number expired; no-op without a timeout."""
        if self.idle_timeout is None:
            return 0
        idle = ((self._slot_state == 1)
                & (self.registers[:, REG_LAST_TS]
                   < np.int64(now) - self.idle_timeout))
        n = int(idle.sum())
        if n:
            self._slot_state[idle] = 2
            self.registers[idle] = 0
            self._count -= n
            self._tombstones += n
            self.stats["flow_expiries_total"] += n
            if self._tombstones > self._cap * self._tombstone_limit:
                self._compact()
        return n

    # -- the one public resolution op --------------------------------------

    def lookup_or_insert(self, words: np.ndarray, hashes: np.ndarray,
                         now: np.ndarray, want_rank: bool = False):
        """Resolve a batch of packed 5-tuple keys to register slots,
        claiming zeroed slots for unseen flows.

        ``now`` is the per-packet arrival tick (drives idle expiry: a
        matched flow whose state is older than ``idle_timeout`` restarts
        with zeroed registers).  Returns ``(slots, is_new)`` with ``slots``
        (B,) int64 and ``is_new`` True exactly where a packet (re)opens
        its flow.  Duplicate keys within the batch resolve to one slot;
        only the first occurrence is marked new.

        **Hard overflow degrades, never raises**: when one batch carries
        more unique flows than the table can physically hold (or churn
        keeps the table from settling), the overflow flows' packets get
        slot ``-1`` — whole flows are rejected, so the surviving packets'
        slots (and within-flow ranks) stay valid — and the caller turns
        them into per-packet errors.  One hostile burst degrades the
        burst; it cannot kill the server (counted in
        ``stats["flow_rejects_total"]``).

        ``want_rank=True`` appends each packet's within-flow occurrence
        rank (batch order) to the return — the flow-update lowering needs
        exactly this grouping, and computing it here reuses the dedup's
        argsort.  It comes back ``None`` in the astronomically rare case
        the dedup's hash fold split one key into two groups (two groups on
        one slot would make the rank unsafe for the scatter), in which
        case the caller falls back to ranking by slot.
        """
        n = words.shape[0]
        self.stats["flow_lookups_total"] += n
        if n == 0:
            empty = np.zeros(0, np.int64), np.zeros(0, bool)
            return empty + (np.zeros(0, np.int64),) if want_rank else empty
        now = np.asarray(now, np.int64).reshape(-1)
        if want_rank:
            uidx, inverse, rank = _dedup_rows(words, hashes, want_rank=True)
        else:
            uidx, inverse = _dedup_rows(words, hashes)
        uwords, uhash, unow = words[uidx], hashes[uidx], now[uidx]
        limit = int(self._cap * self._load_limit)
        if uidx.size > limit:
            # physically unservable batch: even a full eviction cannot give
            # every flow its own register row.  Serve the earliest-arriving
            # ``limit`` flows and reject the rest per-flow (slot -1) — a
            # hostile burst costs itself, not the server
            keep_u = np.zeros(uidx.size, bool)
            keep_u[np.argsort(uidx)[:limit]] = True
            sel_u = np.nonzero(keep_u)[0]
        else:
            sel_u = np.arange(uidx.size)
        uwords, uhash, unow = uwords[sel_u], uhash[sel_u], unow[sel_u]

        # Generation-stable resolution: maintenance (expire/compact/flush)
        # relocates slots, and a claim can itself trigger a flush — any
        # generation bump after the probe invalidates the probe, so redo
        # the whole resolution until one pass settles untouched.  Two
        # passes suffice in practice (one to make room, one to settle).
        # "(re)opened" marks accumulate ACROSS attempts: a key claimed in
        # one attempt probes as a hit on the retry, but its registers were
        # zeroed in this call — it still (re)opens its flow.  No mark can
        # go stale the other way: nothing inside this call un-zeroes a
        # register row.
        claimed = np.zeros(sel_u.size, bool)
        reopened = np.zeros(sel_u.size, bool)
        for _ in range(4):
            gen0 = self.generation
            match, _ = self._probe(uwords, uhash)
            miss = match < 0
            n_new = int(miss.sum())
            if n_new and self._count + n_new > self._cap * self._load_limit:
                # make room before claiming: age out idle flows, rebuild
                # chains; wholesale eviction only if truly full of live flows
                self.expire(int(unow.max()))
                if self._tombstones:
                    self._compact()
                if self._count + n_new > self._cap * self._load_limit:
                    self._flush()
                continue
            if self.idle_timeout is not None and n_new < sel_u.size:
                hit = ~miss
                hs = match[hit]
                idle = (self.registers[hs, REG_PKT_COUNT] > 0) \
                    & (self.registers[hs, REG_LAST_TS]
                       < unow[hit] - self.idle_timeout)
                if idle.any():
                    self.registers[hs[idle]] = 0  # same key, state restarts
                    self.stats["flow_expiries_total"] += int(idle.sum())
                    reopened[np.nonzero(hit)[0][idle]] = True
            if n_new:
                match[miss] = self._insert_new(uwords[miss], uhash[miss])
                claimed |= miss
            if self.generation == gen0:
                self.stats["flow_created_total"] += int(claimed.sum())
                break
        else:
            # pathological churn: the table never settled.  Serve whatever
            # the final probe resolves and reject the rest per-flow — the
            # old behavior here was a server-killing RuntimeError
            match, _ = self._probe(uwords, uhash)
            unres = match < 0
            self.stats["flow_created_total"] += int((claimed & ~unres).sum())

        # assemble over ALL unique flows: overflow/unsettled flows carry
        # slot -1 (their packets are rejected; everything else is exact)
        slots_u = np.full(uidx.size, -1, np.int64)
        slots_u[sel_u] = match
        new_u = np.zeros(uidx.size, bool)
        new_u[sel_u] = (claimed | reopened) & (match >= 0)

        slots = slots_u[inverse]
        is_new = np.zeros(n, bool)  # only a flow's first occurrence is new
        is_new[uidx[new_u]] = True
        n_rej = int((slots < 0).sum())
        if n_rej:
            self.stats["flow_rejects_total"] += n_rej
        self.stats["flow_hits_total"] += n - int(is_new.sum()) - n_rej
        if not want_rank:
            return slots, is_new
        served = match[match >= 0]
        if served.size != np.count_nonzero(np.bincount(
                served, minlength=1)):  # a fold split: groups ≠ flows
            rank = None
        return slots, is_new, rank

    # -- checkpoint / restore / migration ----------------------------------

    def snapshot(self) -> dict:
        """Checkpoint every live flow — packed key words + register rows +
        the generation counter (the ROADMAP's "serialize/restore FlowTable
        under a generation fence" primitive; the failover path's source of
        truth).  Tombstoned and expired slots are dead state and are not
        captured; slot numbers are deliberately absent (slots are
        per-batch handles, never stable flow ids)."""
        live = np.nonzero(self._slot_state == 1)[0]
        return {
            "key_words": self.key_words,
            "keys": self._keys[live].copy(),
            "registers": self.registers[live].copy(),
            "generation": self.generation,
        }

    def restore(self, snap: dict) -> None:
        """Rebuild the table to hold exactly a :meth:`snapshot`'s flows
        with their register rows bit-exact (slot numbers may differ — the
        contract is the key→registers mapping, not the layout).  Always
        bumps the generation past both the current and the snapshot's
        value: a restore is a relocation event, and any slots handed out
        before it are fenced off exactly like a flush's."""
        if int(snap["key_words"]) != self.key_words:
            raise ValueError(
                f"snapshot packs keys into {snap['key_words']} words; "
                f"this table uses {self.key_words}")
        keys = np.ascontiguousarray(snap["keys"], np.uint64)
        regs = np.ascontiguousarray(snap["registers"], np.int32)
        if keys.shape[0] != regs.shape[0]:
            raise ValueError("snapshot keys/registers row counts differ")
        if keys.shape[0] > self._cap * self._load_limit:
            raise ValueError(
                f"snapshot holds {keys.shape[0]} live flows > this "
                f"table's {int(self._cap * self._load_limit)}-flow load "
                "limit — restore into a table with capacity_pow2 raised")
        self._slot_state[:] = 0
        self.registers[:] = 0
        self._count = 0
        self._tombstones = 0
        self.generation = max(self.generation,
                              int(snap["generation"])) + 1
        if keys.shape[0]:
            self._insert_new(keys, hash_words(keys), regs)

    def adopt(self, words: np.ndarray, hashes: np.ndarray,
              regs: np.ndarray) -> int:
        """Merge foreign live flows into this table (shard failover: a dead
        shard's checkpointed flows migrate onto a survivor).  Register rows
        land bit-exact; keys already present are overwritten with the
        migrated state (with disjoint RSS key spaces this never happens —
        the overwrite is the safe resolution if it ever does).  Makes room
        like the lookup path (compact, then wholesale eviction of
        residents — migrants carry live state, residents can restart).
        Returns the number of flows adopted."""
        words = np.ascontiguousarray(words, np.uint64)
        regs = np.ascontiguousarray(regs, np.int32)
        n = words.shape[0]
        if n == 0:
            return 0
        if self._count + n > self._cap * self._load_limit:
            if self._tombstones:
                self._compact()
            if self._count + n > self._cap * self._load_limit:
                self._flush()
            if n > self._cap * self._load_limit:
                raise ValueError(
                    f"adopting {n} flows exceeds this table's "
                    f"{int(self._cap * self._load_limit)}-flow load limit")
        for _ in range(4):
            gen0 = self.generation
            match, _ = self._probe(words, hashes)
            miss = match < 0
            if miss.any():
                self._insert_new(words[miss], hashes[miss], regs[miss])
            if self.generation == gen0:
                hit = ~miss
                if hit.any():
                    self.registers[match[hit]] = regs[hit]
                self.stats["flow_adopted_total"] += n
                return n
        # unreachable with the capacity check above; degrade rather than
        # raise mid-failover — unsettled flows restart on their next packet
        return 0

    # -- convenience -------------------------------------------------------

    @staticmethod
    def pack_keys(key_bytes: np.ndarray, key_words: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack raw key bytes ``(B, K)`` into uint64 words + their hashes
        (the same primitives the ingress cache uses)."""
        words = pack_rows(key_bytes, key_words)
        return words, hash_words(words)
