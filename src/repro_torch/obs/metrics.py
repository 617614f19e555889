"""Metrics registry: counters, gauges, log-bucket latency histograms.

The registry is the single store for every serving-side statistic.  Design
constraints:

* **Host-side only.**  Nothing here touches the device — instrumentation
  can never add a serving configuration.
* **Allocation-free hot path.**  A counter cell is one Python int
  (``cell.inc(n)`` is an attribute add); a histogram observe is one
  ``searchsorted`` into a fixed numpy bucket array.  No per-packet objects.
* **Fixed log-scale buckets, exact-rank percentile readout.**  Buckets are
  geometric with ratio ``10**(1/buckets_per_decade)``; ``percentile(q)``
  returns the upper edge of the bucket holding the inverted-CDF order
  statistic (clamped to the observed max), so the readout is within one
  bucket ratio of ``np.percentile(..., method="inverted_cdf")``.
* **Label axes.**  Instruments are cells keyed by label values (e.g.
  ``shard=2``, ``model=7``); a family groups the cells of one metric name
  for export.  Hot paths hold direct references to their own cells.

Naming scheme (the documented convention — see README "Observability"):

    <subsystem>_<noun>_total      monotonic counters
    <subsystem>_<noun>            gauges (point-in-time level)
    <subsystem>_<noun>_seconds    latency histograms

:class:`StatsAdapter` speaks canonical names only.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsAdapter",
]


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """Prometheus HELP-text escaping: backslash and newline only."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _label_text(key: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)


class Counter:
    """A monotonic counter cell.  ``inc`` is one int add — hot-path safe."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v: int) -> None:
        # Needed by StatsAdapter write-through (``stats["k"] += n`` performs
        # a read-modify-write) and by legacy reset paths.
        self.value = int(v)


class Gauge:
    """A point-in-time level (occupancy, open/closed state, ratio)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n


class Histogram:
    """Fixed log-scale-bucket histogram over positive values (latencies).

    ``observe``/``observe_many`` increment a fixed ``int64`` bucket array —
    no allocation, no resizing.  ``percentile(q)`` reads the inverted-CDF
    order statistic off the cumulative bucket counts: the returned value is
    the upper edge of the order statistic's bucket (clamped to the exact
    observed max), guaranteeing

        readout / true_percentile  <=  10**(1/buckets_per_decade)

    which ``tests/test_obs.py`` checks against ``np.percentile`` directly.
    """

    __slots__ = ("_edges", "_counts", "_n", "_sum", "_min", "_max")

    def __init__(self, lo: float = 1e-6, hi: float = 100.0,
                 buckets_per_decade: int = 60) -> None:
        if not (lo > 0 and hi > lo):
            raise ValueError("histogram needs 0 < lo < hi")
        decades = math.log10(hi / lo)
        n = int(math.ceil(decades * buckets_per_decade)) + 1
        # _edges[i] is the (inclusive) upper bound of bucket i; the final
        # bucket _counts[n] is the overflow bucket for values > hi.
        self._edges = lo * np.power(
            10.0, np.arange(n, dtype=np.float64) / buckets_per_decade)
        self._counts = np.zeros(n + 1, dtype=np.int64)
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def edges(self) -> np.ndarray:
        return self._edges

    @property
    def bucket_counts(self) -> np.ndarray:
        return self._counts

    def observe(self, v: float) -> None:
        self._counts[int(np.searchsorted(self._edges, v))] += 1
        self._n += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def observe_many(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64).ravel()
        if values.size == 0:
            return
        idx = np.searchsorted(self._edges, values)
        np.add.at(self._counts, idx, 1)
        self._n += int(values.size)
        self._sum += float(values.sum())
        self._min = min(self._min, float(values.min()))
        self._max = max(self._max, float(values.max()))

    def percentile(self, q: float) -> float:
        """Inverted-CDF percentile readout (``q`` in [0, 100])."""
        if self._n == 0:
            return float("nan")
        rank = max(1, int(math.ceil(q / 100.0 * self._n)))
        cum = np.cumsum(self._counts)
        b = int(np.searchsorted(cum, rank))
        if b >= self._edges.size:      # overflow bucket: only the max is known
            return self._max
        # Upper edge of the order statistic's bucket, clamped to the exact
        # extremes so single-bucket/tail readouts are exact.
        return float(min(max(self._edges[b], self._min), self._max))

    def summary(self) -> dict:
        if self._n == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self._n,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50.0),
            "p90": self.percentile(90.0),
            "p99": self.percentile(99.0),
        }

    def reset(self) -> None:
        self._counts[:] = 0
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf


class _Family:
    """All cells of one metric name, keyed by label values."""

    __slots__ = ("name", "kind", "help", "cells")

    def __init__(self, name: str, kind: str, help: str) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.cells: Dict[Tuple[Tuple[str, str], ...], object] = {}


class MetricsRegistry:
    """Named counters/gauges/histograms with label axes + export.

    ``counter()/gauge()/histogram()`` return the (possibly pre-existing)
    cell for the given label values — hot paths call them once at
    construction and keep the reference.  ``attach()`` grafts an
    instrument created elsewhere (e.g. a standalone ``FlowTable``'s
    counters) into a family so it exports alongside everything else.
    ``register_collector(fn)`` adds a pull hook run before every export —
    used for gauges derived from live structures (table occupancy,
    engine packet totals, serving-configuration counts).
    """

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- instrument creation / adoption ---------------------------------
    def _family(self, name: str, kind: str, help: str) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}")
        if help and not fam.help:
            fam.help = help
        return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        with self._lock:
            fam = self._family(name, "counter", help)
            key = _label_key(labels)
            cell = fam.cells.get(key)
            if cell is None:
                cell = Counter()
                fam.cells[key] = cell
            return cell  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        with self._lock:
            fam = self._family(name, "gauge", help)
            key = _label_key(labels)
            cell = fam.cells.get(key)
            if cell is None:
                cell = Gauge()
                fam.cells[key] = cell
            return cell  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "", lo: float = 1e-6,
                  hi: float = 100.0, buckets_per_decade: int = 60,
                  **labels) -> Histogram:
        with self._lock:
            fam = self._family(name, "histogram", help)
            key = _label_key(labels)
            cell = fam.cells.get(key)
            if cell is None:
                cell = Histogram(lo=lo, hi=hi,
                                 buckets_per_decade=buckets_per_decade)
                fam.cells[key] = cell
            return cell  # type: ignore[return-value]

    def attach(self, name: str, cell, help: str = "", **labels) -> None:
        """Adopt an existing instrument cell under ``name`` + labels."""
        if isinstance(cell, Counter):
            kind = "counter"
        elif isinstance(cell, Gauge):
            kind = "gauge"
        elif isinstance(cell, Histogram):
            kind = "histogram"
        else:
            raise TypeError(f"cannot attach {type(cell).__name__}")
        with self._lock:
            fam = self._family(name, kind, help)
            fam.cells[_label_key(labels)] = cell

    def register_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    # -- export ----------------------------------------------------------
    def _run_collectors(self) -> None:
        for fn in list(self._collectors):
            fn()

    def snapshot(self) -> dict:
        """Plain-dict export: ``{name: value}`` for unlabeled instruments,
        ``{name: {'shard="0"': value, ...}}`` for labeled ones; histograms
        export their summary dict."""
        self._run_collectors()
        out: dict = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            cells = list(fam.cells.items())
            if not cells:
                continue
            def _value(cell):
                if isinstance(cell, Histogram):
                    return cell.summary()
                return cell.value
            if len(cells) == 1 and cells[0][0] == ():
                out[fam.name] = _value(cells[0][1])
            else:
                out[fam.name] = {_label_text(k) or "": _value(c)
                                 for k, c in sorted(cells)}
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4 format)."""
        self._run_collectors()
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for fam in families:
            if not fam.cells:
                continue
            # HELP is always present (scrapers treat a missing HELP as an
            # untyped family); families registered without help text fall
            # back to a name-derived description
            help_text = fam.help or fam.name.replace("_", " ")
            lines.append(f"# HELP {fam.name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, cell in sorted(fam.cells.items()):
                lt = _label_text(key)
                if isinstance(cell, Histogram):
                    cum = 0
                    counts = cell.bucket_counts
                    for i, edge in enumerate(cell.edges):
                        cum += int(counts[i])
                        le = f'le="{float(edge)!r}"'
                        sep = "," if lt else ""
                        lines.append(
                            f"{fam.name}_bucket{{{lt}{sep}{le}}} {cum}")
                    sep = "," if lt else ""
                    lines.append(
                        f'{fam.name}_bucket{{{lt}{sep}le="+Inf"}} '
                        f"{cell.count}")
                    suffix = f"{{{lt}}}" if lt else ""
                    lines.append(f"{fam.name}_sum{suffix} {cell.sum!r}")
                    lines.append(f"{fam.name}_count{suffix} {cell.count}")
                else:
                    suffix = f"{{{lt}}}" if lt else ""
                    v = cell.value
                    vs = str(int(v)) if float(v).is_integer() else repr(v)
                    lines.append(f"{fam.name}{suffix} {vs}")
        return "\n".join(lines) + "\n"


class StatsAdapter:
    """Dict-like view over registry counter cells.

    Subsystems expose a ``stats`` mapping; this
    adapter keeps that surface — reads *and* the ``stats["k"] += n`` write
    pattern — working unchanged, while the underlying store is registry
    cells under the canonical ``<subsystem>_<noun>_total`` names
    (canonical names only).
    """

    __slots__ = ("_cells", "_nested", "_extras")

    def __init__(self) -> None:
        self._cells: Dict[str, Counter] = {}
        self._nested: Dict[str, "StatsAdapter"] = {}
        self._extras: Dict[str, object] = {}

    def bind(self, canonical: str, cell: Counter) -> Counter:
        self._cells[canonical] = cell
        return cell

    def bind_nested(self, key: str, sub: "StatsAdapter") -> "StatsAdapter":
        self._nested[key] = sub
        return sub

    def bind_value(self, key: str, value) -> None:
        """Attach a non-counter value (e.g. a list of death records) so the
        legacy dict surface stays complete."""
        self._extras[key] = value

    def cells(self):
        """(canonical name, Counter) pairs — for grafting standalone cells
        into a shared registry via ``MetricsRegistry.attach``."""
        return list(self._cells.items())

    # -- mapping surface -------------------------------------------------
    def __getitem__(self, key: str):
        if key in self._nested:
            return self._nested[key]
        if key in self._extras:
            return self._extras[key]
        return self._cells[key].value

    def __setitem__(self, key: str, value) -> None:
        if key in self._extras:
            self._extras[key] = value
            return
        self._cells[key].set(value)

    def __contains__(self, key: str) -> bool:
        return (key in self._nested or key in self._cells
                or key in self._extras)

    def __iter__(self):
        yield from self._cells
        yield from self._nested
        yield from self._extras

    def __len__(self) -> int:
        return len(self._cells) + len(self._nested) + len(self._extras)

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self) -> Iterable[str]:
        return list(self)

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]

    def as_dict(self) -> dict:
        out = {k: c.value for k, c in self._cells.items()}
        for k, sub in self._nested.items():
            out[k] = sub.as_dict()
        out.update(self._extras)
        return out

    def __repr__(self) -> str:  # debugging / test output
        return repr(self.as_dict())
