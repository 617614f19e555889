"""Deterministic fault injection for the serving fabric.

A SmartNIC that stalls or drops state on the data path is worse than no
NIC at all, so every recovery path in this repo — dispatch retry,
shard failover with live flow migration, batch bisection, crash-safe
installs — must be *tested*, not hoped for.  This module is the test
harness's hand on the failure lever: a seeded :class:`FaultPlan` is
installed on a pipeline / control plane / whole fabric and fires at
named **sites** with fully deterministic timing (per-site event
counters, no wall clock, no global RNG), so a failing chaos run replays
bit-identically from its seed.

Sites (the code under test calls ``fire``/``corrupt_egress`` at these
points; an uninstalled plan costs one attribute check):

* ``"dispatch"`` — raises :class:`InjectedFault` in
  ``IngressPipeline._dispatch`` *before* the device call (the
  device-program-crash analogue).  ``match_model_id`` scopes the fault
  to batches carrying a poison Model ID — how the bisection tests make
  a *row* toxic rather than a whole shard.
* ``"stall"`` — sleeps ``latency`` seconds at the dispatch site (the
  wedged-DMA analogue the fabric watchdog must catch).
* ``"egress"`` — corrupts retired egress rows (seeded byte flips in the
  Model-ID echo, which the pipeline's egress verification checks).
* ``"install"`` — raises :class:`InjectedFault` inside
  ``ControlPlane.install()/install_forest()/install_feature_spec()``
  between table preparation and the commit point, proving the swap is
  all-or-nothing (no torn tables, version unchanged, no new serving
  configuration).
* ``"drift"`` — shifts one feature lane's distribution on fresh staged
  rows (saturating left-shift by ``shift`` octaves of lane ``lane``),
  the traffic-went-weird analogue: the shifted codes flow through real
  serving *and* the drift tap, so the chaos lane can assert the
  model-quality plane raises exactly one ``drift_alert``.
* ``"overload"`` — multiplies one shard's dispatch latency by
  ``slowdown`` (a deterministic slow-device stall, scaled from the
  pipeline's own measured dispatch cost): the sustained-overload
  analogue the watermark controller must answer with shard-local
  backpressure — reflex serves and sheds on the slow shard only, while
  survivor shards keep their submit p99 inside budget.

Chaos mode: ``REPRO_CHAOS=1`` in the environment arms a low-rate
transient dispatch fault on every pipeline (one hiccup every
``REPRO_CHAOS_EVERY`` dispatches, default 97; always swallowed by the
retry path), so the entire tier-1 suite doubles as a recovery-
transparency proof — results must stay bit-exact *through* the faults.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["InjectedFault", "FaultSpec", "FaultPlan", "chaos_plan_from_env",
           "FAULT_SITES"]

FAULT_SITES = ("dispatch", "stall", "egress", "install", "drift",
               "overload")

_FOREVER = 1 << 62


class InjectedFault(RuntimeError):
    """The exception a :class:`FaultPlan` raises at a firing site.

    Deliberately a ``RuntimeError`` subclass: recovery code must treat it
    like any real device/control-plane failure (no special-casing), while
    tests can still assert *this* failure was the injected one.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: where, when, and what.

    ``site``            one of :data:`FAULT_SITES`.
    ``shard``           restrict to one shard id (``None`` = every shard;
                        the control plane fires with shard ``-1``).
    ``start``           first site event (0-based, per ``(site, shard)``
                        counter) eligible to fire.
    ``count``           how many times this spec fires in total.
    ``every``           fire on every ``every``-th eligible event — the
                        transient-fault knob (``every=97`` hiccups ~1% of
                        dispatches; the immediate retry is event +1 and
                        passes).
    ``latency``         seconds to sleep (``"stall"`` site only).
    ``match_model_id``  only fire when the dispatched batch carries this
                        Model ID (``"dispatch"``/``"stall"`` sites) — the
                        poison-row knob for bisection tests.
    ``corrupt_frac``    fraction of rows corrupted per firing
                        (``"egress"`` site), at least one.
    ``lane`` / ``shift``  feature lane to shift and by how many octaves
                        (``"drift"`` site): codes become
                        ``clip(x << shift)`` — a pure distribution shift
                        the drift sketches must detect.
    ``slowdown``        dispatch-latency multiplier (``"overload"``
                        site): each firing stalls the dispatch for
                        ``(slowdown - 1) ×`` the pipeline's measured
                        dispatch cost, i.e. the device looks
                        ``slowdown``× slower.
    """

    site: str
    shard: Optional[int] = None
    start: int = 0
    count: int = 1
    every: int = 1
    latency: float = 0.0
    match_model_id: Optional[int] = None
    corrupt_frac: float = 0.25
    lane: int = 0
    shift: int = 4
    slowdown: float = 8.0

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r} — "
                             f"sites are {FAULT_SITES}")
        if self.every < 1:
            raise ValueError("every must be >= 1")
        if self.count < 0 or self.start < 0:
            raise ValueError("count/start must be >= 0")
        if self.lane < 0 or not 0 <= self.shift <= 31:
            raise ValueError("lane must be >= 0 and shift in [0, 31]")
        if self.slowdown <= 0:
            raise ValueError("slowdown must be > 0")


class FaultPlan:
    """A seeded, installable schedule of :class:`FaultSpec` firings.

    Event counters are per ``(site, shard)`` and bump on every *eligible*
    check (a spec with ``match_model_id`` only counts batches carrying
    the poison id), so firing times depend only on the sequence of site
    visits — deterministic under replay.  ``fired`` logs every firing as
    ``(site, shard, event_index)`` for assertions.
    """

    def __init__(self, specs, seed: int = 0):
        specs = list(specs)
        for s in specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"FaultPlan wants FaultSpec, got {type(s)}")
        self.specs = specs
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._events: Dict[Tuple[str, int, int], int] = {}
        self._fired_per_spec: Dict[int, int] = {}
        self.fired: List[Tuple[str, int, int]] = []
        self._sites = frozenset(s.site for s in specs)
        # Optional obs EventLog: every firing is mirrored as a
        # ``fault_injected`` event (wired by install(); the chaos-mode
        # self-install wires it to the pipeline's own log).
        self.events = None

    # -- firing ------------------------------------------------------------

    def _armed(self, site: str, shard: int,
               mids: Optional[np.ndarray]) -> Optional[FaultSpec]:
        hit = None
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if spec.shard is not None and spec.shard != shard:
                continue
            if spec.match_model_id is not None:
                if mids is None or not np.any(
                        np.asarray(mids) == spec.match_model_id):
                    continue
            key = (site, shard, i)
            e = self._events.get(key, 0)
            self._events[key] = e + 1
            if e < spec.start or (e - spec.start) % spec.every != 0:
                continue
            if self._fired_per_spec.get(i, 0) >= spec.count:
                continue
            self._fired_per_spec[i] = self._fired_per_spec.get(i, 0) + 1
            self.fired.append((site, shard, e))
            if self.events is not None:
                self.events.emit("fault_injected", shard=shard,
                                 site=site, event_index=e, spec=i)
            hit = spec if hit is None else hit
        return hit

    def fire(self, site: str, shard: int = 0,
             mids: Optional[np.ndarray] = None) -> None:
        """Check the site's schedule; raise :class:`InjectedFault` (for
        ``dispatch``/``install``) or sleep (for ``stall``) when armed."""
        spec = self._armed(site, shard, mids)
        if spec is None:
            return
        if site == "stall":
            time.sleep(spec.latency)
            return
        raise InjectedFault(
            f"injected {site} fault (shard {shard}, "
            f"firing #{len(self.fired)})")

    def corrupt_egress(self, rows: np.ndarray, shard: int = 0) -> np.ndarray:
        """Seeded corruption of retired egress rows: flips the Model-ID
        echo bytes of a deterministic row subset (what a DMA/bit-flip
        fault would do to the wire; the pipeline's echo verification is
        the CRC stand-in that must catch it).  Returns ``rows`` untouched
        when the site is not armed."""
        spec = self._armed("egress", shard, None)
        if spec is None or rows.shape[0] == 0:
            return rows
        n = rows.shape[0]
        k = max(1, int(round(n * spec.corrupt_frac)))
        sel = self._rng.choice(n, size=min(k, n), replace=False)
        rows = rows.copy()
        rows[sel, 0] ^= 0xA5  # Model-ID high byte — echo check trips
        rows[sel, 1] ^= 0x5A
        return rows

    def has_site(self, site: str) -> bool:
        """Cheap pre-check so hot paths skip sites no spec targets."""
        return site in self._sites

    def overload_factor(self, shard: int = 0,
                        mids: Optional[np.ndarray] = None) -> float:
        """Slow-device site: the dispatch-latency multiplier for this
        event (1.0 when not armed).  The pipeline turns the factor into a
        stall scaled from its own measured dispatch cost, so "8× slower"
        means the same thing on any host."""
        spec = self._armed("overload", shard, mids)
        return float(spec.slowdown) if spec is not None else 1.0

    def shift_features(self, x0: np.ndarray, shard: int = 0) -> np.ndarray:
        """Drift-injection site: when armed, return a copy of the fresh
        staged feature block with one lane's codes saturating-left-shifted
        by ``shift`` octaves — a pure, deterministic distribution shift
        that rides through real serving and the drift tap alike.  Returns
        ``x0`` untouched when not armed."""
        spec = self._armed("drift", shard, None)
        if spec is None or x0.shape[0] == 0 or spec.lane >= x0.shape[1]:
            return x0
        x0 = x0.copy()
        col = x0[:, spec.lane].astype(np.int64) << spec.shift
        np.clip(col, np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                out=col)
        x0[:, spec.lane] = col.astype(np.int32)
        return x0

    # -- installation ------------------------------------------------------

    def install(self, target) -> None:
        """Attach this plan to a pipeline, control plane, engine wrapper or
        whole sharded fabric (anything exposing the ``fault_plan``
        attribute contract).  A fabric install fans out to every shard
        pipeline *and* the shared control plane."""
        def _adopt_events(obj) -> None:
            obs = getattr(obj, "obs", None)
            if self.events is None and obs is not None:
                self.events = obs.events

        shards = getattr(target, "shards", None)
        if shards is not None:  # a ShardedPacketServer-shaped fabric
            _adopt_events(target)
            for sh in shards:
                sh.pipeline.fault_plan = self
            target.control_plane.fault_plan = self
            target.fault_plan = self
            return
        ingress = getattr(target, "ingress", None)
        if ingress is not None:  # a PacketServer-shaped wrapper
            _adopt_events(target)
            _adopt_events(ingress)
            ingress.fault_plan = self
            target.control_plane.fault_plan = self
            return
        if hasattr(target, "fault_plan"):
            _adopt_events(target)
            target.fault_plan = self
            return
        raise TypeError(
            f"don't know how to install a FaultPlan on "
            f"{type(target).__name__}")


def chaos_plan_from_env() -> Optional[FaultPlan]:
    """The CI chaos lane's hook: with ``REPRO_CHAOS=1``, every pipeline
    self-installs a fresh low-rate transient-dispatch plan (independent
    counters per pipeline) whose every firing is swallowed by the retry
    path — the whole tier-1 suite then proves recovery transparency.
    Returns ``None`` when chaos mode is off."""
    if os.environ.get("REPRO_CHAOS", "") not in ("1", "true", "yes"):
        return None
    every = int(os.environ.get("REPRO_CHAOS_EVERY", "97"))
    seed = int(os.environ.get("REPRO_CHAOS_SEED", "0"))
    return FaultPlan(
        [FaultSpec(site="dispatch", start=0, count=_FOREVER,
                   every=max(1, every))],
        seed=seed)
