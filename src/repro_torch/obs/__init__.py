"""Fabric-wide observability: metrics registry + event log + tracer.

One :class:`Observability` object is created per server
(``PacketServer`` / ``ShardedPacketServer``) and threaded through every
subsystem it owns: shard pipelines bind their counters into the shared
registry under per-shard labels, the control plane and fault supervisor
emit into the shared event log, and (when ``trace_every > 0``) each shard
pipeline gets its own :class:`~repro_torch.obs.trace.PacketTracer` (tickets and
staging-row indices are per-pipeline namespaces, so tracers cannot be
shared across shards).  Every shard pipeline also gets an always-on
:class:`~repro_torch.obs.trace.StageClock`: the self-time counters of its
host stages, ``<stage>_seconds_total`` under its ``shard`` label.

Everything is host-side numpy/Python and never adds a serving
configuration; the one device read is each batch's pair of timing events
on the card (``engine_batch_device_seconds_total``).

    obs = Observability(trace_every=64)
    srv = ShardedPacketServer(n_shards=4, obs=obs)
    ... serve ...
    obs.snapshot()             # plain dict: metrics + recent events
    obs.to_prometheus_text()   # exposition format
    obs.spans()                # traced packet lifecycles, all shards
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .drift import DriftMonitor, ShadowScorer, drift_scores
from .events import EVENT_KINDS, Event, EventLog
from .health import AlertRule, HealthMonitor
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      StatsAdapter)
from .trace import STAGES, TRACE_STAGES, PacketTracer, StageClock

__all__ = [
    "Observability",
    "MetricsRegistry",
    "StatsAdapter",
    "Counter",
    "Gauge",
    "Histogram",
    "EventLog",
    "Event",
    "EVENT_KINDS",
    "PacketTracer",
    "TRACE_STAGES",
    "StageClock",
    "STAGES",
    "DriftMonitor",
    "ShadowScorer",
    "drift_scores",
    "AlertRule",
    "HealthMonitor",
]


class Observability:
    """Bundle of registry + event log + tracer config for one server."""

    def __init__(self, clock=None, trace_every: int = 0,
                 event_capacity: int = 2048) -> None:
        self.clock = clock
        self.trace_every = int(trace_every)
        self.registry = MetricsRegistry()
        self.events = EventLog(capacity=event_capacity, clock=clock)
        self.tracers: List[PacketTracer] = []
        # model-quality plane: off until enable_drift() — the
        # pipeline taps guard on ``obs.drift is not None``
        self.drift: Optional[DriftMonitor] = None
        self.health: Optional[HealthMonitor] = None

    def enable_drift(self, *, window: int = 4096, n_lanes: int = 8,
                     pred_lanes: int = 4, psi_threshold: float = 0.25,
                     categorical_lanes=(), cat_cap: int = 64) -> DriftMonitor:
        """Turn on the model-quality plane: a :class:`HealthMonitor` for
        alert rules plus a :class:`DriftMonitor` whose taps the pipelines
        pick up on their next batch.  Idempotent (returns the existing
        monitor on repeat calls)."""
        if self.health is None:
            self.health = HealthMonitor(self.registry, self.events)
        if self.drift is None:
            self.drift = DriftMonitor(
                self.registry, self.events, window=window, n_lanes=n_lanes,
                pred_lanes=pred_lanes, psi_threshold=psi_threshold,
                categorical_lanes=categorical_lanes, cat_cap=cat_cap,
                health=self.health)
        return self.drift

    def enable_quality_plane(self, control_plane, pipelines, *,
                             drift_window: int, drift_lanes: int,
                             psi_threshold: float,
                             shadow_model: Optional[int], shadow_every: int,
                             slo_budget: Optional[float], slo_rule: str,
                             submit_p99: Callable[[], Optional[float]]
                             ) -> None:
        """A server's model-quality plane, built when any of
        ``drift_window``, ``shadow_model`` or ``slo_budget`` is set: drift
        taps whose reference window freezes at every committed install, a
        shadow lane on each of ``pipelines``, and the ``slo_rule`` health
        rule, which burns ``submit_p99()`` (the submit latency's p99 in
        seconds, ``None`` before the first sample) over ``slo_budget``."""
        if not (drift_window or shadow_model is not None
                or slo_budget is not None):
            return
        if slo_budget is not None and slo_budget <= 0:
            raise ValueError("slo_budget must be positive (or None)")
        mon = self.enable_drift(window=drift_window or 4096,
                                n_lanes=drift_lanes,
                                psi_threshold=psi_threshold)
        control_plane.install_listeners.append(mon.on_install)
        if shadow_model is not None:
            for pipeline in pipelines:
                mon.attach_shadow(pipeline, shadow_model, every=shadow_every)
        if slo_budget is not None:
            def _burn() -> float:
                p99 = submit_p99()
                return float("nan") if p99 is None else p99 / slo_budget

            self.health.add_rule(slo_rule, "slo_burn", _burn, 1.0,
                                 budget_s=slo_budget)

    def make_tracer(self, shard: int = 0, clock=None) -> Optional[PacketTracer]:
        """Per-pipeline tracer (or ``None`` when tracing is off)."""
        if self.trace_every <= 0:
            return None
        tracer = PacketTracer(every=self.trace_every,
                              clock=clock if clock is not None else self.clock,
                              shard=shard)
        self.tracers.append(tracer)
        return tracer

    def spans(self) -> List[dict]:
        """Closed spans from every shard tracer, in timestamp order."""
        out: List[dict] = []
        for t in self.tracers:
            out.extend(t.spans())
        out.sort(key=lambda r: r["submit"])
        return out

    def snapshot(self, event_limit: Optional[int] = 256) -> dict:
        out = {
            "metrics": self.registry.snapshot(),
            "events": self.events.snapshot(limit=event_limit),
            "trace": {
                "every": self.trace_every,
                "sampled": sum(t.sampled for t in self.tracers),
                "spans": len(self.spans()),
            },
        }
        if self.drift is not None:
            out["model_quality"] = {
                "drift": self.drift.snapshot(),
                "health": (self.health.state()
                           if self.health is not None else {}),
                "shadow": [s.snapshot() for s in self.drift.shadows],
            }
        return out

    def to_prometheus_text(self) -> str:
        return self.registry.to_prometheus_text()
