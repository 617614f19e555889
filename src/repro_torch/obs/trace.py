"""Sampled packet-lifecycle tracer: submit → stage → dispatch → device-done
→ retire spans on the monotonic clock.

Sampling is **deterministic 1-in-N by ticket id** (``ticket % every == 0``),
so two runs over the same traffic trace the same packets — the property
``tests/test_obs.py`` asserts.  The tracer is off by default
(``trace_every=0`` on the servers); when on, the hot-path cost per chunk is
one vectorized modulo to find sampled tickets plus a handful of dict
stamps, and one clock read per hook call (all rows of a batch share the
same host event, so they share a timestamp).

A closed span decomposes end-to-end latency into the four segments the SLO
scheduler needs:

    queue_s    submit → stage      (waiting to enter an open batch)
    batch_s    stage → dispatch    (waiting for the batch to close)
    device_s   dispatch → device_done   (device compute + transfer)
    drain_s    device_done → retire     (egress decode + result hand-off)

Cache-hit / coalesced packets short-circuit the device: their spans carry
only submit/retire and are flagged ``short_circuit``.

The tracer reuses the injectable ``clock=`` plumbing: pass the
same fake clock as the pipeline's to make spans deterministic in tests.
On the card the pipeline stamps a batch's dispatch and device_done from
the batch's own timing events (see ``IngressPipeline._retire_oldest``), so
``device_s`` is the device's time for the batch.

:class:`StageClock` is the always-on companion: self-time counters of the
host stages every submit and drain passes through (``STAGES``), one
``<stage>_seconds_total`` registry counter each.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .metrics import Counter

__all__ = ["PacketTracer", "TRACE_STAGES", "StageClock", "STAGES"]

TRACE_STAGES = ("submit", "stage", "dispatch", "device_done", "retire")

_SUBMIT, _STAGE, _DISPATCH, _DEVICE, _RETIRE = range(5)

# The host stages of the serving path, in :class:`StageClock`'s index order
# (the module constants below name the indices).  Together they partition
# every call to ``PacketServer.submit_packets``, ``submit_raw`` and
# ``drain_packets``:
#
#   server_call      the entry points' own work no stage below covers
#                    (ticket allocation, chunk-level checks)
#   flow_parse       raw-row validation and ``parse_raw_headers``
#   flow_table       key packing, ``FlowTable.lookup_or_insert``, sketch cells
#   flow_state       ``FlowFrontend._update`` (on the card: the register
#                    file's round trip and the flow kernel)
#   flow_gather      the FeatureSpec gather
#   ingress_key      wire rows: pad, feature-count check or encode, packing
#                    and hashing
#   ingress_lookup   result-cache lookup and hit fill, dedup, pending window
#   ingress_stage    fresh-row parse, admission, chunk records, pending
#                    insert, staging copies
#   engine_dispatch  ``run_features`` under the retry policy, and salvage
#   ingress_wait     the host blocked on a batch's completion
#   ingress_retire   egress encode, result writes, cache insert, chunk
#                    resolution
#   ingress_drain    the drain's result assembly and ticket reset
STAGES = ("server_call", "flow_parse", "flow_table", "flow_state",
          "flow_gather", "ingress_key", "ingress_lookup", "ingress_stage",
          "engine_dispatch", "ingress_wait", "ingress_retire",
          "ingress_drain")
(SERVER_CALL, FLOW_PARSE, FLOW_TABLE, FLOW_STATE, FLOW_GATHER, INGRESS_KEY,
 INGRESS_LOOKUP, INGRESS_STAGE, ENGINE_DISPATCH, INGRESS_WAIT,
 INGRESS_RETIRE, INGRESS_DRAIN) = range(len(STAGES))


class StageClock:
    """Self-time counters of nested host stages.

    A stack of open stages; every boundary (:meth:`push`, :meth:`swap`,
    :meth:`pop`, :meth:`leave`) reads the clock once and charges the time
    since the previous boundary to the innermost open stage, so a nested
    stage's time is never counted in its parent too.  Time while no stage
    is open is charged to none.  ``last`` is the latest boundary's reading.

    The cells are ``<stage>_seconds_total`` counters of ``registry`` under
    ``labels`` (plain cells when ``registry`` is None).  An entry point
    opens ``server_call`` with :meth:`enter` and closes with :meth:`leave`
    in a ``finally``, which also unwinds whatever an exception left open.
    """

    __slots__ = ("_clock", "cells", "_stack", "last")

    def __init__(self, registry=None, clock=None, **labels) -> None:
        self._clock = clock if clock is not None else time.perf_counter
        self.cells = [
            Counter() if registry is None else registry.counter(
                f"{name}_seconds_total",
                f"host seconds in the {name} stage, nested stages excluded",
                **labels)
            for name in STAGES]
        self._stack: List[int] = []
        self.last = 0.0

    @property
    def depth(self) -> int:
        return len(self._stack)

    def push(self, stage: int) -> int:
        """Open ``stage`` inside the innermost; returns the depth before."""
        now = self._clock()
        stack = self._stack
        d = len(stack)
        if d:
            self.cells[stack[-1]].value += now - self.last
        stack.append(stage)
        self.last = now
        return d

    def swap(self, stage: int) -> None:
        """Close the innermost stage and open ``stage`` in its place."""
        now = self._clock()
        stack = self._stack
        self.cells[stack[-1]].value += now - self.last
        stack[-1] = stage
        self.last = now

    def pop(self) -> None:
        now = self._clock()
        self.cells[self._stack.pop()].value += now - self.last
        self.last = now

    def enter(self) -> int:
        """Open ``server_call`` when no stage is open; returns the depth
        to :meth:`leave` at."""
        d = len(self._stack)
        if not d:
            self.push(SERVER_CALL)
        return d

    def leave(self, depth: int) -> None:
        """Close every stage above ``depth`` (one clock read)."""
        stack = self._stack
        if len(stack) > depth:
            now = self._clock()
            self.cells[stack[-1]].value += now - self.last
            del stack[depth:]
            self.last = now

    def seconds(self) -> Dict[str, float]:
        """Each stage's seconds so far."""
        return {name: float(c.value) for name, c in zip(STAGES, self.cells)}


class PacketTracer:
    """Deterministic 1-in-N ticket-sampled lifecycle tracer."""

    def __init__(self, every: int = 64, clock=None,
                 max_spans: int = 4096, shard: int = 0) -> None:
        if every < 1:
            raise ValueError("every must be >= 1")
        self.every = int(every)
        self.shard = int(shard)
        self.max_spans = int(max_spans)
        self._clock = clock if clock is not None else time.perf_counter
        # A whole chunk's sampled tickets share the submit timestamp, so
        # an all-short-circuit chunk (all of steady state) lives as ONE
        # run record from submit to retire: (start, stop, step) -> t_sub.
        # The moment any ticket of a run diverges (staged, partial
        # retire), the run demotes to per-ticket _open entries.
        self._runs: Dict[tuple, float] = {}
        # ticket -> t_submit (float) until staged, then
        # [t_submit, t_stage, t_dispatch, t_device, t_retire]
        self._open: Dict[int, object] = {}
        # miss row index -> traced ticket riding that device row
        self._miss: Dict[int, int] = {}
        # closed records: (ticket, span) singles or ("run", start, stop,
        # step, t_sub, t_ret) whole-chunk short-circuit runs; _nspans
        # counts spans (not records) so the max_spans bound stays honest
        self._done: deque = deque()
        self._nspans = 0
        self.sampled = 0

    def wants(self, ticket: int) -> bool:
        return int(ticket) % self.every == 0

    def _sampled(self, tickets):
        """Sampled tickets as a plain-int iterable.  Chunks carry
        contiguous ascending tickets, so the common case is arithmetic
        (two scalar reads, no vector scan); subsets (e.g. the cache-hit
        rows of a chunk) fall back to one vectorized modulo."""
        tickets = np.asarray(tickets)
        n = tickets.size
        if n == 0:
            return ()
        lo, hi = int(tickets[0]), int(tickets[-1])
        if hi - lo == n - 1:
            e = self.every
            return range(-(-lo // e) * e, hi + 1, e)
        return tickets[tickets % self.every == 0].tolist()

    def _demote(self) -> None:
        """Spill open runs into per-ticket entries (paths diverged)."""
        opn = self._open
        for (start, stop, step), t_sub in self._runs.items():
            for t in range(start, stop, step):
                opn.setdefault(t, t_sub)
        self._runs.clear()

    # -- lifecycle hooks (called by IngressPipeline) ---------------------
    def on_submit(self, tickets: np.ndarray) -> None:
        # An open span is a bare float (submit time) until a stage stamp
        # arrives: the short-circuit path — all of steady state — never
        # pays for the 5-slot list, and a contiguous chunk costs one dict
        # insert total (the run record).
        hit = self._sampled(tickets)
        if not hit:
            return
        now = self._clock()
        if isinstance(hit, range):
            self._runs[(hit.start, hit.stop, hit.step)] = now
        else:
            opn = self._open
            for t in hit:
                opn[t] = now
        self.sampled += len(hit)

    def on_stage(self, tickets: np.ndarray, miss_idx: np.ndarray) -> None:
        """Fresh rows only: ``tickets[i]`` was staged onto device row
        ``miss_idx[i]``."""
        tickets = np.asarray(tickets)
        sel = tickets % self.every == 0
        if not sel.any():
            return
        if self._runs:
            self._demote()
        now = self._clock()
        for t, m in zip(tickets[sel].tolist(),
                        np.asarray(miss_idx)[sel].tolist()):
            sub = self._open.get(t)
            if sub is not None and not isinstance(sub, list):
                self._open[t] = [sub, now, None, None, None]
                self._miss.setdefault(m, t)

    def _stamp_miss(self, miss_idx: np.ndarray, slot: int,
                    pop: bool = False, at: Optional[float] = None) -> None:
        # Work must stay O(#sampled), not O(batch): dispatched rows are a
        # contiguous index range, so membership is two scalar compares per
        # open sampled row; ragged callers fall back to a C-level isin.
        if not self._miss:
            return
        arr = np.asarray(miss_idx).ravel()
        if arr.size == 0:
            return
        lo, hi = int(arr[0]), int(arr[-1])
        if hi - lo == arr.size - 1:
            present = [m for m in self._miss if lo <= m <= hi]
        else:
            keys = np.fromiter(self._miss.keys(), dtype=np.int64,
                               count=len(self._miss))
            present = keys[np.isin(keys, arr)].tolist()
        if not present:
            return
        now = self._clock() if at is None else at
        for m in present:
            t = self._miss[m]
            span = self._open.get(t)
            if isinstance(span, list) and span[slot] is None:
                span[slot] = now
            if pop:
                del self._miss[m]

    def on_dispatch(self, miss_idx: np.ndarray,
                    at: Optional[float] = None) -> None:
        """Stamp the batch's dispatch, now or at ``at`` (same clock)."""
        self._stamp_miss(miss_idx, _DISPATCH, at=at)

    def on_device_done(self, miss_idx: np.ndarray,
                       at: Optional[float] = None) -> None:
        """Stamp the batch's device completion, now or at ``at``: on the
        card the pipeline passes the dispatch stamp plus the batch's time
        between its own device events."""
        # device_done is the last per-row hook; pop the row mapping so a
        # reused staging row index can never stamp a stale span.
        self._stamp_miss(miss_idx, _DEVICE, pop=True, at=at)

    def on_retire(self, tickets: np.ndarray) -> None:
        hit = self._sampled(tickets)
        if not hit:
            return
        now = self._clock()
        if isinstance(hit, range):
            key = (hit.start, hit.stop, hit.step)
            t_sub = self._runs.pop(key, None)
            if t_sub is not None:
                # whole-chunk short-circuit: close all spans in O(1)
                self._done.append(("run", key[0], key[1], key[2],
                                   t_sub, now))
                self._nspans += len(hit)
                self._trim()
                return
        if self._runs:
            self._demote()
        done = self._done
        for t in hit:
            span = self._open.pop(t, None)
            if span is None:
                continue
            # hot path ends here: materializing the span dict is deferred
            # to spans() so a closed span costs one tuple append
            if isinstance(span, list):
                span[_RETIRE] = now
                done.append((t, span))
            else:  # short-circuit: only submit/retire were ever stamped
                done.append((t, (span, now)))
            self._nspans += 1
        self._trim()

    def _trim(self) -> None:
        while self._nspans > self.max_spans and self._done:
            rec = self._done.popleft()
            self._nspans -= (len(range(rec[1], rec[2], rec[3]))
                             if rec[0] == "run" else 1)

    @staticmethod
    def _materialize(ticket: int, span, shard: int) -> dict:
        if len(span) == 2:
            sub, ret = span
            return {"ticket": int(ticket), "shard": shard,
                    "submit": sub, "retire": ret,
                    "total_s": ret - sub, "short_circuit": True}
        sub, stage, disp, dev, ret = span
        rec = {"ticket": int(ticket), "shard": shard,
               "submit": sub, "retire": ret,
               "total_s": ret - sub,
               "short_circuit": stage is None}
        if stage is not None:
            rec["stage"] = stage
            rec["queue_s"] = stage - sub
            if disp is not None:
                rec["dispatch"] = disp
                rec["batch_s"] = disp - stage
                if dev is not None:
                    rec["device_done"] = dev
                    rec["device_s"] = dev - disp
                    rec["drain_s"] = ret - dev
        return rec

    # -- reads -----------------------------------------------------------
    def spans(self) -> List[dict]:
        """Closed spans, oldest first (bounded by ``max_spans``)."""
        out = []
        shard = self.shard
        for rec in self._done:
            if rec[0] == "run":
                _, start, stop, step, t_sub, t_ret = rec
                pair = (t_sub, t_ret)
                out.extend(self._materialize(t, pair, shard)
                           for t in range(start, stop, step))
            else:
                out.append(self._materialize(rec[0], rec[1], shard))
        return out

    @property
    def open_spans(self) -> int:
        return len(self._open) + sum(
            len(range(k[0], k[1], k[2])) for k in self._runs)

    def clear_open(self) -> None:
        """Drop open (unretired) state — closed spans keep.  Called when
        the pipeline's ticket namespace restarts so stale tickets can
        never alias new ones."""
        self._open.clear()
        self._miss.clear()
        self._runs.clear()

    def reset(self) -> None:
        self.clear_open()
        self._done.clear()
        self._nspans = 0
        self.sampled = 0
