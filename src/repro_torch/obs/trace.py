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
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

__all__ = ["PacketTracer", "TRACE_STAGES"]

TRACE_STAGES = ("submit", "stage", "dispatch", "device_done", "retire")

_SUBMIT, _STAGE, _DISPATCH, _DEVICE, _RETIRE = range(5)


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
                    pop: bool = False) -> None:
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
        now = self._clock()
        for m in present:
            t = self._miss[m]
            span = self._open.get(t)
            if isinstance(span, list) and span[slot] is None:
                span[slot] = now
            if pop:
                del self._miss[m]

    def on_dispatch(self, miss_idx: np.ndarray) -> None:
        self._stamp_miss(miss_idx, _DISPATCH)

    def on_device_done(self, miss_idx: np.ndarray) -> None:
        # device_done is the last per-row hook; pop the row mapping so a
        # reused staging row index can never stamp a stale span.
        self._stamp_miss(miss_idx, _DEVICE, pop=True)

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
