"""Structured event log: a bounded ring buffer of typed serving events.

Counters say *how much*; the event log says *what happened, in what
order*.  Every record carries a monotonically increasing sequence number,
a monotonic-clock timestamp, the shard and control-plane generation it was
observed under, and a kind-specific detail dict — enough to reconstruct a
failover post-hoc (install → fault firings → watchdog strikes → shard kill
→ flow migrations) from the log alone, which ``tests/test_obs.py`` does.

Event kinds emitted by the serving fabric:

    ``install`` / ``install_forest`` / ``install_feature_spec`` /
    ``install_slo`` / ``install_reflex`` /
    ``remove``            control-plane table swaps (generation bumps)
    ``fault_injected``    a ``FaultPlan`` spec fired (site, event index)
    ``watchdog_strike``   fabric supervisor strike against a shard
    ``shard_killed``      shard declared dead (reason, flows at death)
    ``flow_migration``    snapshot re-homed onto a survivor shard
    ``gate_open`` / ``gate_closed``   cold-traffic admission gate flips
    ``window_degraded``   a drain window returned partial results
    ``drift_alert``       a model's windowed drift score crossed threshold
    ``slo_burn``          p99 latency exceeded a model/fabric SLO budget
    ``shadow_divergence`` shadow-model disagreement crossed threshold
    ``alert_cleared``     an open health alert re-armed (hysteresis close)
    ``deadline_shed``     packets past hard queue capacity answered with
                          typed ``PacketError(DEADLINE_SHED)`` slots
    ``reflex_served``     packets past the high watermark answered by the
                          reflex lane (host-side rule program)
    ``drain_timeout``     a bounded drain expired; unresolved tickets were
                          backfilled as ``PacketError(DRAIN_TIMEOUT)``

The log is thread-safe (fabric watchdog and caller threads both emit) and
bounded: the ring keeps the most recent ``capacity`` records; ``dropped``
counts what scrolled off.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["Event", "EventLog", "EVENT_KINDS"]

EVENT_KINDS = (
    "install",
    "install_forest",
    "install_feature_spec",
    "install_slo",
    "install_reflex",
    "remove",
    "fault_injected",
    "watchdog_strike",
    "shard_killed",
    "flow_migration",
    "gate_open",
    "gate_closed",
    "window_degraded",
    "drift_alert",
    "slo_burn",
    "shadow_divergence",
    "alert_cleared",
    "deadline_shed",
    "reflex_served",
    "drain_timeout",
)


@dataclass(frozen=True)
class Event:
    seq: int
    ts: float                 # monotonic clock (same clock as the tracer)
    kind: str
    shard: int = -1           # -1: not shard-specific (control plane, fabric)
    generation: int = -1      # control-plane version when observed, if known
    detail: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"seq": self.seq, "ts": self.ts, "kind": self.kind,
                "shard": self.shard, "generation": self.generation,
                **self.detail}


class EventLog:
    """Bounded, thread-safe, ordered record of serving events."""

    def __init__(self, capacity: int = 2048, clock=None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock if clock is not None else time.perf_counter
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._emitted = 0
        self._lock = threading.Lock()

    def emit(self, kind: str, shard: int = -1, generation: int = -1,
             **detail) -> Event:
        ts = self._clock()
        with self._lock:
            ev = Event(seq=self._seq, ts=ts, kind=kind, shard=shard,
                       generation=generation, detail=detail)
            self._seq += 1
            self._emitted += 1
            self._ring.append(ev)
        return ev

    # -- reads -----------------------------------------------------------
    def records(self, kind: Optional[str] = None,
                shard: Optional[int] = None) -> List[Event]:
        """Events still in the ring, oldest first, optionally filtered."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if shard is not None:
            evs = [e for e in evs if e.shard == shard]
        return evs

    def last(self, kind: Optional[str] = None) -> Optional[Event]:
        evs = self.records(kind=kind)
        return evs[-1] if evs else None

    def counts(self) -> dict:
        out: dict = {}
        for e in self.records():
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    @property
    def dropped(self) -> int:
        """Records emitted but no longer in the ring."""
        with self._lock:
            return self._emitted - len(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        evs = self.records()
        if limit is not None:
            evs = evs[-limit:]
        return [e.as_dict() for e in evs]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
