"""Model-quality telemetry: streaming feature/prediction drift + shadow lane.

The retraining loop the ROADMAP wants (pForest-style phase retraining,
Automating-INML-style automatic redeployment) needs *signals* before any
supervisor can act: is the live feature distribution still the one the
installed model was trained on, are its predictions drifting, and would a
candidate replacement agree with it on live traffic?  This module produces
exactly those three signals, host-side, with no new serving configuration:

:class:`DriftMonitor`
    Per-model per-feature-lane distribution sketches over the already-parsed
    int32 feature codes, fed from one vectorized tap in
    ``IngressPipeline._ingest`` (fresh staged rows — the rows that actually
    reach the device; byte-identical repeats short-circuit earlier and carry
    no new distribution information) plus a per-model prediction-code sketch
    tapped at egress in ``_retire_oldest``.  The sketch is the
    log-bucket histogram design vectorized across models and lanes: one
    sign-aware base-2 geometric bucket per magnitude octave (the bucket
    index is read straight out of the float32 exponent field, so a whole
    ``(batch, lanes)`` block bins in a handful of SIMD ops and lands in the
    count tensor with a single ``np.bincount``).  Low-cardinality lanes can
    additionally opt into a small **exact-counting sketch**
    (``categorical_lanes=``, capped at ``cat_cap`` distinct values) whose
    per-value counts replace the octave bins when scoring.

    At ``ControlPlane.install()`` (via the install-listener hook) the
    current window freezes as the **reference**; every ``window`` observed
    rows thereafter the monitor scores the completed window against it —
    PSI, KL and max-bucket-deviation per lane (:func:`drift_scores`, the
    pure-numpy oracle the property tests pin) — on that deterministic
    row-count cadence, exports the per-model maxima as gauges, and asks the
    attached :class:`~repro_torch.obs.health.HealthMonitor` to step its alert
    rules.

:class:`ShadowScorer`
    Opt-in lane replaying a deterministic 1-in-N ticket sample (the
    PacketTracer's contiguous-run sampling arithmetic) of staged rows
    through a designated shadow model, recording agreement/confusion
    counters so a candidate retrain is evaluated on live traffic before
    promotion.  Shadow batches reuse the pipeline's fixed ``(batch_size,
    width)`` dispatch shape (Model-ID-0 padding) so they add **no new
    serving configuration**, and every shadow dispatch self-cancels its engine accounting
    (the same negative-credit pattern as the bisection probes) so shadow
    traffic never inflates serving throughput stats.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

__all__ = ["drift_scores", "DriftMonitor", "ShadowScorer", "N_BINS"]

# Sketch bin layout per (model, lane): [0] exact zero, [1..32] positive
# magnitudes by octave (bucket k holds 2^(k-1) <= |x| < 2^k), [33..64] the
# same octaves for negative values.  65 sign-aware geometric buckets cover
# the whole int32 code range — the log-bucket histogram scheme of
# obs.metrics.Histogram at base 2, laid out flat so binning vectorizes
# across models and lanes.
N_BINS = 65


def _bin_codes(a: np.ndarray) -> np.ndarray:
    """Vectorized sign-aware octave binning of int feature codes.

    The octave (floor(log2|x|) + 1) is read from the float32 exponent
    field: elementwise ops only, no searchsorted, no per-lane loop.
    Mantissa rounding at octave boundaries is deterministic (same input,
    same bucket), which is all a drift sketch needs.
    """
    bits = np.asarray(a).astype(np.float32).view(np.int32)
    k = (bits >> 23) & 0xFF                        # biased exponent (sign-
    k -= 126                                       # independent): octave
    np.maximum(k, 0, out=k)                        # 0 for 0, 1..32 else
    k += (bits >> 31) & 32                         # +32 for negative values
    return k


def drift_scores(cur, ref, eps: float = 1e-6) -> Dict[str, float]:
    """PSI / KL / max-bucket-deviation between two count vectors.

    Both inputs are raw (unnormalized) bucket counts over the same bin
    layout.  Each is eps-smoothed then normalized to a distribution; the
    scores are

        psi     = sum((p - q) * ln(p / q))      (symmetric-ish, standard
                                                 population-stability form)
        kl      = sum(p * ln(p / q))            (current || reference)
        max_dev = max|p - q|                    (worst single bucket)

    This function **is** the oracle: the hypothesis tests re-derive the
    same arithmetic independently and require exact agreement.
    """
    p = np.asarray(cur, np.float64) + eps
    p = p / p.sum()
    q = np.asarray(ref, np.float64) + eps
    q = q / q.sum()
    lr = np.log(p / q)
    return {
        "psi": float(((p - q) * lr).sum()),
        "kl": float((p * lr).sum()),
        "max_dev": float(np.abs(p - q).max()),
    }


class DriftMonitor:
    """Streaming per-model distribution sketches + windowed drift scoring.

    ``observe_features`` / ``observe_predictions`` are the hot-path taps:
    O(batch) numpy, no Python per row, never touching the device.  Scoring happens every
    ``window`` observed feature rows per model (deterministic cadence) and
    costs one :func:`drift_scores` pass per active lane.
    """

    def __init__(self, registry, events, *, window: int = 4096,
                 n_lanes: int = 8, pred_lanes: int = 4,
                 psi_threshold: float = 0.25,
                 categorical_lanes=(), cat_cap: int = 64,
                 max_model_slots: int = 64, health=None) -> None:
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self.n_lanes = int(n_lanes)
        self.pred_lanes = int(pred_lanes)
        self.psi_threshold = float(psi_threshold)
        self.cat_lanes = tuple(int(c) for c in categorical_lanes)
        self.cat_cap = int(cat_cap)
        self.registry = registry
        self.events = events
        self.health = health
        self.shadows: List["ShadowScorer"] = []

        S = int(max_model_slots)
        self._slots = S
        self._lut = np.full(65536, -1, np.int32)     # model id -> slot
        self._mids: List[int] = []                   # slot -> model id
        self._lane_off = np.arange(self.n_lanes, dtype=np.int32) * N_BINS
        self._pred_off = np.arange(self.pred_lanes, dtype=np.int32) * N_BINS
        # current-window counts, flat so one bincount lands the whole batch
        self._feat = np.zeros(S * self.n_lanes * N_BINS, np.int64)
        self._pred = np.zeros(S * self.pred_lanes * N_BINS, np.int64)
        self._seen = np.zeros(S, np.int64)           # feature rows in window
        # frozen references (None until an install/first window freezes one)
        self._ref_feat: List[Optional[np.ndarray]] = [None] * S
        self._ref_pred: List[Optional[np.ndarray]] = [None] * S
        self._ref_cat: List[Optional[dict]] = [None] * S
        # exact-counting sketches: slot -> lane -> {value: count} | None
        # (None marks an overflowed lane for this window)
        self._cat: List[Dict[int, Optional[dict]]] = [dict() for _ in range(S)]
        self.last_scores: Dict[int, dict] = {}       # model id -> score dict

        self._c_windows = registry.counter(
            "drift_windows_total", "drift windows scored")
        self._h_score = registry.histogram(
            "drift_score_seconds", "drift scoring pass latency")
        self._gauges: Dict[int, dict] = {}

    # -- model slots -------------------------------------------------------

    def _register(self, mids: np.ndarray) -> None:
        for m in np.unique(mids).tolist():
            m = int(m) & 0xFFFF
            if self._lut[m] >= 0 or len(self._mids) >= self._slots:
                continue
            s = len(self._mids)
            self._lut[m] = s
            self._mids.append(m)
            reg = self.registry
            self._gauges[m] = {
                "psi": reg.gauge("drift_psi", "max-lane PSI, last window",
                                 model=m),
                "kl": reg.gauge("drift_kl", model=m),
                "max_dev": reg.gauge("drift_max_dev", model=m),
                "pred_psi": reg.gauge("drift_pred_psi", model=m),
            }
            if self.health is not None:
                self.health.add_rule(
                    f"drift:{m}", "drift_alert",
                    (lambda mid=m: self.max_psi(mid)),
                    self.psi_threshold, model_id=m)

    def _slot_of(self, model_id: int) -> int:
        m = int(model_id) & 0xFFFF
        if self._lut[m] < 0:
            self._register(np.asarray([m]))
        return int(self._lut[m])

    # -- hot-path taps -----------------------------------------------------

    def observe_features(self, mid, x0: np.ndarray) -> None:
        """Tap one staged batch of parsed feature codes (vectorized).
        ``mid`` is per-row Model IDs, or a scalar applied to every row."""
        x0 = np.asarray(x0)
        mid = np.asarray(mid)
        if mid.ndim == 0:
            mid = np.broadcast_to(mid, (x0.shape[0],))
        if mid.size == 0:
            return
        slot = self._lut[mid & 0xFFFF]
        if (slot < 0).any():
            self._register(mid[slot < 0])
            slot = self._lut[mid & 0xFFFF]
            ok = slot >= 0                  # slot table full: drop the rest
            if not ok.all():
                mid, x0, slot = mid[ok], x0[ok], slot[ok]
                if mid.size == 0:
                    return
        L = min(self.n_lanes, x0.shape[1])
        if L == 0:
            return
        C = self.n_lanes * N_BINS
        b = _bin_codes(x0[:, :L])
        b += slot[:, None] * C
        b += self._lane_off[:L]
        hi = (int(slot.max()) + 1) * C
        counts = np.bincount(b.ravel(), minlength=hi)
        self._feat[:hi] += counts
        # every row lands exactly one count in its slot's lane-0 block, so
        # the per-slot row totals fall out of the feature counts for free
        rows = counts.reshape(-1, C)[:, :N_BINS].sum(axis=1)
        self._seen[:rows.size] += rows
        if self.cat_lanes:
            self._observe_cat(slot, x0)
        self._maybe_score(np.nonzero(rows)[0])

    def _observe_cat(self, slot: np.ndarray, x0: np.ndarray) -> None:
        for lane in self.cat_lanes:
            if lane >= x0.shape[1]:
                continue
            col = x0[:, lane]
            for s in np.unique(slot).tolist():
                lanes = self._cat[s]
                d = lanes.get(lane, {})
                if d is None:               # overflowed this window
                    continue
                vals, cts = np.unique(col[slot == s], return_counts=True)
                for v, c in zip(vals.tolist(), cts.tolist()):
                    d[v] = d.get(v, 0) + c
                lanes[lane] = None if len(d) > self.cat_cap else d

    def observe_predictions(self, mid, out: np.ndarray) -> None:
        """Tap one retired batch's int32 output codes (egress side)."""
        out = np.asarray(out)
        mid = np.asarray(mid)
        if mid.ndim == 0:
            mid = np.broadcast_to(mid, (out.shape[0],))
        if mid.size == 0:
            return
        slot = self._lut[mid & 0xFFFF]
        ok = slot >= 0
        if not ok.all():
            mid, out, slot = mid[ok], out[ok], slot[ok]
            if mid.size == 0:
                return
        P = min(self.pred_lanes, out.shape[1])
        if P == 0:
            return
        b = _bin_codes(out[:, :P])
        b += slot[:, None] * (self.pred_lanes * N_BINS)
        b += self._pred_off[:P]
        hi = (int(slot.max()) + 1) * self.pred_lanes * N_BINS
        self._pred[:hi] += np.bincount(b.ravel(), minlength=hi)

    # -- reference / scoring ----------------------------------------------

    def on_install(self, kind: str, model_id: int) -> None:
        """ControlPlane install listener: freeze the current window as the
        new reference for this model (or arm a pending freeze if the window
        is empty) and re-arm its drift alert."""
        if kind not in ("install", "install_forest"):
            return
        s = self._slot_of(model_id)
        if self._seen[s] > 0:
            self._freeze(s)
        else:
            self._ref_feat[s] = None        # next full window becomes ref
            self._ref_pred[s] = None
            self._ref_cat[s] = None
        self.last_scores.pop(int(model_id) & 0xFFFF, None)
        if self.health is not None:
            self.health.reset_rule(f"drift:{int(model_id) & 0xFFFF}")

    def _feat_win(self, s: int) -> np.ndarray:
        base = s * self.n_lanes * N_BINS
        return self._feat[base: base + self.n_lanes * N_BINS].reshape(
            self.n_lanes, N_BINS)

    def _pred_win(self, s: int) -> np.ndarray:
        base = s * self.pred_lanes * N_BINS
        return self._pred[base: base + self.pred_lanes * N_BINS].reshape(
            self.pred_lanes, N_BINS)

    def _freeze(self, s: int) -> None:
        self._ref_feat[s] = self._feat_win(s).copy()
        self._ref_pred[s] = self._pred_win(s).copy()
        self._ref_cat[s] = {
            lane: (dict(d) if d is not None else None)
            for lane, d in self._cat[s].items()}
        self._roll(s)

    def _roll(self, s: int) -> None:
        self._feat_win(s)[:] = 0
        self._pred_win(s)[:] = 0
        self._seen[s] = 0
        self._cat[s] = {}

    def _score_slot(self, s: int) -> Optional[dict]:
        """Scores of the current (possibly partial) window vs the frozen
        reference, or None when no reference exists yet."""
        ref = self._ref_feat[s]
        if ref is None:
            return None
        win = self._feat_win(s)
        feats = {}
        ref_cat = self._ref_cat[s] or {}
        for lane in range(self.n_lanes):
            cur_d = self._cat[s].get(lane)
            ref_d = ref_cat.get(lane)
            if cur_d is not None and ref_d is not None and lane in \
                    self._cat[s] and lane in ref_cat:
                keys = sorted(set(cur_d) | set(ref_d))
                cur_v = np.asarray([cur_d.get(k, 0) for k in keys], np.int64)
                ref_v = np.asarray([ref_d.get(k, 0) for k in keys], np.int64)
                feats[lane] = drift_scores(cur_v, ref_v)
            else:
                feats[lane] = drift_scores(win[lane], ref[lane])
        out = {
            "features": feats,
            "psi": max(f["psi"] for f in feats.values()),
            "kl": max(f["kl"] for f in feats.values()),
            "max_dev": max(f["max_dev"] for f in feats.values()),
        }
        ref_p = self._ref_pred[s]
        if ref_p is not None and ref_p.sum() > 0:
            pw = self._pred_win(s)
            preds = {lane: drift_scores(pw[lane], ref_p[lane])
                     for lane in range(self.pred_lanes)}
            out["predictions"] = preds
            out["pred_psi"] = max(p["psi"] for p in preds.values())
        else:
            out["pred_psi"] = float("nan")
        return out

    def _maybe_score(self, slots: np.ndarray) -> None:
        for s in slots.tolist():
            if self._seen[s] < self.window:
                continue
            if self._ref_feat[s] is None:
                # install saw an empty window (or model predates the
                # monitor): the first completed window is the reference
                self._freeze(s)
                continue
            ref_p = self._ref_pred[s]
            pw = self._pred_win(s)
            if (ref_p is None or ref_p.sum() == 0) and pw.sum() > 0:
                # late adoption: egress taps lag feature taps by the
                # in-flight window, so a freeze can see zero predictions —
                # the first window with prediction mass becomes the
                # prediction reference
                self._ref_pred[s] = pw.copy()
            t0 = time.perf_counter()
            scores = self._score_slot(s)
            self._h_score.observe(time.perf_counter() - t0)
            m = self._mids[s]
            scores["window_rows"] = int(self._seen[s])
            self.last_scores[m] = scores
            g = self._gauges[m]
            g["psi"].set(scores["psi"])
            g["kl"].set(scores["kl"])
            g["max_dev"].set(scores["max_dev"])
            if scores["pred_psi"] == scores["pred_psi"]:  # not NaN
                g["pred_psi"].set(scores["pred_psi"])
            self._c_windows.inc()
            self._roll(s)
            if self.health is not None:
                self.health.evaluate()

    # -- reads -------------------------------------------------------------

    def max_psi(self, model_id: int) -> float:
        """Max-lane feature PSI of the model's last scored window (NaN
        until one full window has been scored) — the health-rule signal."""
        sc = self.last_scores.get(int(model_id) & 0xFFFF)
        return sc["psi"] if sc is not None else float("nan")

    def score_now(self, model_id: int) -> Optional[dict]:
        """Score the current partial window against the reference without
        rolling it (bench / diagnostics)."""
        m = int(model_id) & 0xFFFF
        if self._lut[m] < 0:
            return None
        return self._score_slot(int(self._lut[m]))

    def attach_shadow(self, pipeline, shadow_model_id: int, *,
                      every: int = 8,
                      divergence_threshold: float = 0.25) -> "ShadowScorer":
        """Attach a shadow lane to one pipeline and (when a health monitor
        is wired) arm a ``shadow_divergence`` alert on its disagreement
        fraction."""
        sc = ShadowScorer(pipeline, shadow_model_id, every=every)
        self.shadows.append(sc)
        if self.health is not None:
            sid = int(getattr(pipeline, "shard_id", 0) or 0)
            name = f"shadow:{int(shadow_model_id)}" + \
                (f":s{sid}" if sid else "")
            self.health.add_rule(
                name, "shadow_divergence", sc.disagreement,
                divergence_threshold, shadow_model=int(shadow_model_id))
        return sc

    def snapshot(self) -> dict:
        models = {}
        for s, m in enumerate(self._mids):
            models[m] = {
                "window_rows": int(self._seen[s]),
                "has_reference": self._ref_feat[s] is not None,
                "last": self.last_scores.get(m),
            }
        return {
            "window": self.window,
            "n_lanes": self.n_lanes,
            "windows_scored": int(self._c_windows.value),
            "models": models,
        }


class ShadowScorer:
    """Deterministic 1-in-N shadow-model evaluation on live traffic.

    Attached to one pipeline; ``observe`` buffers the sampled rows and
    ``flush`` replays a full fixed-shape batch through both the primary
    Model IDs and the shadow model (self-cancelling engine credits, shared
    dispatch shapes), then folds agreement and the label confusion matrix into
    the registry.
    """

    def __init__(self, pipeline, shadow_model_id: int, *, every: int = 8,
                 max_tickets: int = 4096) -> None:
        if every < 1:
            raise ValueError("every must be >= 1")
        self.pipeline = pipeline
        self.engine = pipeline.engine
        self.shadow_mid = int(shadow_model_id)
        self.every = int(every)
        self.batch = int(pipeline.batch_size)
        self.width = int(pipeline.width)
        self.out_feats = int(pipeline.out_feats)
        self.n_classes = max(2, self.out_feats)
        self._in_row = int(pipeline.wire_bytes)
        self._out_row = int(pipeline.out_bytes)
        self._buf_x0 = np.zeros((self.batch, self.width), np.int32)
        self._buf_mid = np.zeros(self.batch, np.int32)
        self._fill = 0
        self.sampled_tickets: deque = deque(maxlen=int(max_tickets))
        self.confusion = np.zeros((self.n_classes, self.n_classes), np.int64)
        self.by_model: Dict[int, List[int]] = {}   # mid -> [agree, pairs]
        reg = pipeline.obs.registry
        self._c_pairs = reg.counter("shadow_pairs_total",
                                    "shadow-scored rows", model=self.shadow_mid)
        self._c_agree = reg.counter("shadow_agree_total",
                                    model=self.shadow_mid)
        pipeline.shadow = self

    # -- sampling (PacketTracer's contiguous-run arithmetic) ---------------

    def _sampled_idx(self, tickets: np.ndarray) -> np.ndarray:
        n = tickets.size
        lo, hi = int(tickets[0]), int(tickets[-1])
        e = self.every
        if hi - lo == n - 1:               # contiguous ascending run
            start = -(-lo // e) * e
            if start > hi:
                return np.empty(0, np.int64)
            return np.arange(start - lo, n, e, dtype=np.int64)
        return np.nonzero(tickets % e == 0)[0]

    def observe(self, tickets, x0: np.ndarray, mid: np.ndarray) -> None:
        tickets = np.asarray(tickets)
        if tickets.size == 0:
            return
        sel = self._sampled_idx(tickets)
        if sel.size == 0:
            return
        self.sampled_tickets.extend(
            int(t) for t in tickets[sel].tolist())
        pos = 0
        while pos < sel.size:
            take = min(self.batch - self._fill, sel.size - pos)
            s = sel[pos: pos + take]
            lo, hi = self._fill, self._fill + take
            self._buf_x0[lo:hi] = x0[s]
            self._buf_mid[lo:hi] = mid[s]
            self._fill += take
            pos += take
            if self._fill == self.batch:
                self.flush()

    # -- replay ------------------------------------------------------------

    def _run(self, x: np.ndarray, m: np.ndarray) -> np.ndarray:
        lanes = "both" if self.pipeline.cp.forest_active else "mlp"
        fut = self.engine.run_features(x, m, block=False, lanes=lanes)
        try:
            return np.asarray(fut)
        finally:
            # shadow traffic is bookkeeping, not serving: cancel the
            # engine's per-dispatch accounting (same pattern as the
            # bisection probes) so throughput stats stay honest
            self.engine.credit_packets(-self.batch)
            self.engine.credit_bytes(-self.batch * self._in_row,
                                     -self.batch * self._out_row)

    def _labels(self, out: np.ndarray, k: int) -> np.ndarray:
        if self.out_feats > 1:
            return np.argmax(out[:k, : self.out_feats], axis=1)
        thr = 1 << (int(self.engine.frac) - 1)     # fixed-point 0.5
        return (out[:k, 0] >= thr).astype(np.int64)

    def flush(self) -> None:
        """Replay the buffered sample through primary + shadow models."""
        k = self._fill
        if k == 0:
            return
        if k < self.batch:                 # Model-ID-0 dead padding keeps
            self._buf_x0[k:] = 0           # the dispatch shape fixed
            self._buf_mid[k:] = 0
        prim = self._run(self._buf_x0, self._buf_mid)
        sm = np.full(self.batch, self.shadow_mid, np.int32)
        if k < self.batch:
            sm[k:] = 0
        shad = self._run(self._buf_x0, sm)
        pl = self._labels(prim, k)
        sl = self._labels(shad, k)
        agree = pl == sl
        np.add.at(self.confusion, (pl, sl), 1)
        self._c_pairs.inc(k)
        self._c_agree.inc(int(agree.sum()))
        mids = self._buf_mid[:k]
        for m in np.unique(mids).tolist():
            sel = mids == m
            rec = self.by_model.setdefault(int(m), [0, 0])
            rec[0] += int(agree[sel].sum())
            rec[1] += int(sel.sum())
        self._fill = 0

    # -- reads -------------------------------------------------------------

    @property
    def pairs(self) -> int:
        return int(self._c_pairs.value)

    def disagreement(self, min_pairs: int = 64) -> float:
        """Fraction of shadow-scored rows whose labels disagreed (NaN until
        ``min_pairs`` rows have been scored) — the health-rule signal."""
        n = int(self._c_pairs.value)
        if n < min_pairs:
            return float("nan")
        return 1.0 - int(self._c_agree.value) / n

    def snapshot(self) -> dict:
        n = int(self._c_pairs.value)
        agree = int(self._c_agree.value)
        return {
            "shadow_model": self.shadow_mid,
            "every": self.every,
            "pairs": n,
            "agreement": (agree / n) if n else None,
            "confusion": self.confusion.tolist(),
            "by_model": {m: {"agree": a, "pairs": p}
                         for m, (a, p) in sorted(self.by_model.items())},
        }
