"""Declarative health/alert rules with hysteresis over model-quality signals.

An :class:`AlertRule` is a named threshold over any ``() -> float`` signal
(drift PSI, SLO burn rate, shadow disagreement).  Rules step through the
same open/close hysteresis shape as the cold-traffic admission gate:
a closed rule **opens** (fires) when the signal reaches ``threshold`` and
emits exactly one typed event (``drift_alert`` / ``slo_burn`` /
``shadow_divergence``); an open rule re-arms only after the signal falls
below ``threshold * close_ratio`` (emitting ``alert_cleared``).  A signal
sitting above threshold therefore never flaps — one alert per excursion.

Signals returning NaN are treated as "no data yet" and skipped, so rules
can be declared before their first measurement window completes.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

__all__ = ["AlertRule", "HealthMonitor"]


class AlertRule:
    """One named hysteresis threshold over a scalar signal."""

    __slots__ = ("name", "kind", "value", "threshold", "close_ratio",
                 "detail", "open", "fired", "last_value")

    def __init__(self, name: str, kind: str,
                 value: Callable[[], float], threshold: float, *,
                 close_ratio: float = 0.5, **detail) -> None:
        if not 0.0 <= close_ratio <= 1.0:
            raise ValueError("close_ratio must be in [0, 1]")
        self.name = str(name)
        self.kind = str(kind)
        self.value = value
        self.threshold = float(threshold)
        self.close_ratio = float(close_ratio)
        self.detail = detail
        self.open = False
        self.fired = 0
        self.last_value: Optional[float] = None


class HealthMonitor:
    """Registry of alert rules, evaluated on the caller's cadence.

    ``evaluate()`` is cheap (one signal read + two compares per rule) and
    is driven by the drift monitor's window roll and the servers' drain —
    never from the per-packet hot path.
    """

    def __init__(self, registry, events) -> None:
        self.registry = registry
        self.events = events
        self.rules: Dict[str, AlertRule] = {}
        self._counters: Dict[str, object] = {}
        self._gauges: Dict[str, object] = {}

    def add_rule(self, name: str, kind: str, value: Callable[[], float],
                 threshold: float, *, close_ratio: float = 0.5,
                 **detail) -> AlertRule:
        rule = AlertRule(name, kind, value, threshold,
                         close_ratio=close_ratio, **detail)
        self.rules[rule.name] = rule
        self._counters[rule.name] = self.registry.counter(
            "health_alerts_total", "alert-rule openings", rule=rule.name)
        g = self.registry.gauge("health_alert_open", rule=rule.name)
        g.set(0.0)
        self._gauges[rule.name] = g
        return rule

    def remove_rule(self, name: str) -> None:
        self.rules.pop(name, None)

    def reset_rule(self, name: str) -> None:
        """Re-arm a rule (e.g. after a model reinstall replaced the
        reference its signal was measured against)."""
        rule = self.rules.get(name)
        if rule is not None:
            rule.open = False
            rule.last_value = None
            self._gauges[name].set(0.0)

    def evaluate(self) -> None:
        for rule in list(self.rules.values()):
            try:
                v = float(rule.value())
            except Exception:  # noqa: BLE001 — a dead signal never
                continue       # poisons the whole rule table
            if math.isnan(v):
                continue
            rule.last_value = v
            if not rule.open and v >= rule.threshold:
                rule.open = True
                rule.fired += 1
                self._counters[rule.name].inc()
                self._gauges[rule.name].set(1.0)
                self.events.emit(rule.kind, rule=rule.name,
                                 value=round(v, 6),
                                 threshold=rule.threshold, **rule.detail)
            elif rule.open and v < rule.threshold * rule.close_ratio:
                rule.open = False
                self._gauges[rule.name].set(0.0)
                self.events.emit("alert_cleared", rule=rule.name,
                                 value=round(v, 6), **rule.detail)

    def state(self) -> dict:
        return {
            name: {
                "kind": rule.kind,
                "open": rule.open,
                "fired": rule.fired,
                "threshold": rule.threshold,
                "last_value": rule.last_value,
                **rule.detail,
            }
            for name, rule in self.rules.items()
        }
