"""Synthetic flow datasets, feature-packet streams and raw 5-tuple header
traces.

Counterpart of ``repro.data.packets`` (``PacketGenConfig`` and
``packet_stream``, the endless stream of mixed-tenant feature packets;
``flow_features``,
``anomaly_dataset``, ``qos_dataset`` for the tree-ensemble lane; the raw
header codec ``encode_raw_headers``/``parse_raw_headers``,
``validate_raw_rows`` and the trace generator ``raw_trace`` for the flow
engine): numpy only and bit-identical to the reference on the same
``numpy.random.Generator`` (``raw_trace`` draws from ``rng`` in exactly the
reference's order).  Every generator takes an explicit ``rng`` and never
touches global RNG state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from ..core.packet import encode_packets_np

__all__ = ["PacketGenConfig", "packet_stream", "flow_features", "anomaly_dataset", "qos_dataset",
           "RAW_HEADER_BYTES", "RAW_KEY_BYTES", "RawHeaderBatch",
           "encode_raw_headers", "parse_raw_headers", "validate_raw_rows",
           "raw_trace"]


@dataclasses.dataclass(frozen=True)
class PacketGenConfig:
    n_features: int = 8
    batch: int = 1024
    frac_bits: int = 8
    model_ids: Tuple[int, ...] = (1,)
    seed: int = 0


def flow_features(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """Synthetic flow statistics: pkt sizes, inter-arrival, rates, flags —
    normalized to ~N(0, 0.5) like the QoS training data."""
    base = rng.normal(size=(n, d)) * 0.5
    base[:, 0] = np.abs(base[:, 0])  # packet size ≥ 0
    return base.astype(np.float32)


def anomaly_dataset(rng: np.random.Generator, n: int, d: int = 8, *,
                    drift: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled anomaly-detection flows (the tree-ensemble training task):
    bursty size×rate regions and a flag-pattern trigger, both axis-aligned.
    ``drift`` shifts the burst region to emulate traffic drift.

    Returns ``(X float32 (n, d), y int64 in {0, 1})``.
    """
    X = flow_features(rng, n, d)
    burst = (X[:, 0] > 0.55 + drift) & (X[:, 1 % d] < -0.1 + drift)
    flagged = (X[:, 2 % d] > 0.6) & (X[:, 3 % d] > 0.2)
    y = (burst | flagged).astype(np.int64)
    return X, y


def qos_dataset(rng: np.random.Generator, n: int, d: int = 8
                ) -> Tuple[np.ndarray, np.ndarray]:
    """QoS latency-regression flows: piecewise queueing-delay target (step
    congestion regimes + load slope) for the regression-forest family.

    Returns ``(X float32 (n, d), y float32 (n,))``.
    """
    X = flow_features(rng, n, d)
    congested = (X[:, 0] > 0.5).astype(np.float32)
    y = (0.2 + 0.6 * congested + 0.3 * np.maximum(X[:, 1 % d], 0)
         + 0.1 * (X[:, 2 % d] > 0.3))
    return X, y.astype(np.float32)


# ---------------------------------------------------------------------------
# Raw 5-tuple header traces (the flow-engine ingress format)
# ---------------------------------------------------------------------------

# Raw header wire layout (network byte order) — what a P4 parser extracts
# from the outer IPv4/L4 headers before any NN encapsulation exists:
#
#     src_ip(4) dst_ip(4) src_port(2) dst_port(2) proto(1)   ← 13-byte flow key
#     model_id(2)  ts(4, ticks)  length(2, wire bytes)       ← metadata
#
# ``model_id`` stands in for the NIC's traffic classifier (which tenant
# model this packet's flow is steered to); ``ts`` is the ingress timestamp
# in abstract ticks (int32, monotone per trace).
RAW_KEY_BYTES = 13
RAW_HEADER_BYTES = RAW_KEY_BYTES + 8


@dataclasses.dataclass
class RawHeaderBatch:
    """Parsed raw-header fields, all host numpy arrays."""

    key_bytes: np.ndarray  # (B, RAW_KEY_BYTES) uint8 — the 5-tuple flow key
    model_id: np.ndarray   # (B,) int32
    ts: np.ndarray         # (B,) int32 arrival ticks
    length: np.ndarray     # (B,) int32 wire bytes


def encode_raw_headers(src_ip, dst_ip, src_port, dst_port, proto, model_id,
                       ts, length) -> np.ndarray:
    """Pack raw header fields into ``(B, RAW_HEADER_BYTES)`` uint8 rows
    (big-endian fields, numpy host-side — this is trace generation, not the
    data plane)."""
    src_ip = np.asarray(src_ip, np.int64)
    b = src_ip.shape[0]
    out = np.empty((b, RAW_HEADER_BYTES), np.uint8)

    def be(col, val, nbytes):
        val = np.broadcast_to(np.asarray(val, np.int64), (b,))
        for i in range(nbytes):
            out[:, col + i] = (val >> (8 * (nbytes - 1 - i))) & 0xFF
    be(0, src_ip, 4)
    be(4, dst_ip, 4)
    be(8, src_port, 2)
    be(10, dst_port, 2)
    be(12, proto, 1)
    be(13, model_id, 2)
    be(15, ts, 4)
    be(19, length, 2)
    return out


def parse_raw_headers(raw: np.ndarray) -> RawHeaderBatch:
    """Vectorized host parse of ``(B, RAW_HEADER_BYTES)`` uint8 rows."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.ndim != 2 or raw.shape[1] != RAW_HEADER_BYTES:
        raise ValueError(
            f"raw header batch must be (n, {RAW_HEADER_BYTES}) uint8, "
            f"got {raw.shape}")

    def be(col, nbytes):
        v = np.zeros(raw.shape[0], np.int64)
        for i in range(nbytes):
            v = (v << 8) | raw[:, col + i]
        return v.astype(np.int32)
    return RawHeaderBatch(
        key_bytes=raw[:, :RAW_KEY_BYTES],
        model_id=be(13, 2),
        ts=be(15, 4),
        length=be(19, 2),
    )


def validate_raw_rows(raw, known_model_ids=None):
    """Best-effort admission of a raw header batch.

    Returns ``(rows, bad_mask, reasons)``: ``rows`` is a clean
    ``(n, RAW_HEADER_BYTES)`` uint8 array safe to hand to
    :func:`parse_raw_headers` (rejected rows zeroed), ``bad_mask`` marks
    rows that must resolve as per-packet errors instead of parsing garbage
    (``None`` when every row is clean — the fast path allocates nothing),
    and ``reasons`` is a per-row object array of rejection strings
    (``None`` when ``bad_mask`` is).

    Accepts the well-formed 2-D uint8 batch (one ``shape`` check), a batch
    of the wrong width (every row rejected — the caller keeps serving), or
    a ragged sequence of per-packet byte rows, where truncated/oversized
    rows are rejected individually and the rest parse normally.  With
    ``known_model_ids`` (any container supporting ``in``), rows whose
    Model ID field is outside the known set are rejected too — the
    serving surface's guard against a misclassified flow silently riding
    an uninstalled (zero-egress) model.
    """
    try:
        arr = np.asarray(raw)
    except ValueError:  # ragged sequence: numpy refuses the coercion
        arr = np.empty(0, object)
    if arr.ndim == 2 and arr.dtype != object:
        n = arr.shape[0]
        if arr.shape[1] == RAW_HEADER_BYTES:
            rows = np.ascontiguousarray(arr, np.uint8)
            bad = None
            reasons = None
        else:
            rows = np.zeros((n, RAW_HEADER_BYTES), np.uint8)
            bad = np.ones(n, bool)
            reasons = np.full(
                n, f"malformed raw header: {arr.shape[1]} bytes != "
                   f"{RAW_HEADER_BYTES}", object)
    else:
        # ragged ingress: per-row length triage
        items = list(raw)
        n = len(items)
        rows = np.zeros((n, RAW_HEADER_BYTES), np.uint8)
        bad = np.zeros(n, bool)
        reasons = np.full(n, None, object)
        for i, r in enumerate(items):
            b = np.asarray(r)
            if b.ndim != 1 or b.shape[0] != RAW_HEADER_BYTES:
                got = b.shape[0] if b.ndim == 1 else f"shape {b.shape}"
                bad[i] = True
                reasons[i] = (f"malformed raw header: {got} bytes != "
                              f"{RAW_HEADER_BYTES}")
            else:
                rows[i] = b.astype(np.uint8)
    if known_model_ids is not None and n:
        mids = ((rows[:, 13].astype(np.int64) << 8) | rows[:, 14])
        unknown = np.asarray(
            [m not in known_model_ids for m in mids.tolist()], bool)
        if bad is not None:
            unknown &= ~bad
        if unknown.any():
            if bad is None:
                bad = np.zeros(n, bool)
                reasons = np.full(n, None, object)
                rows = rows.copy()
            for i in np.nonzero(unknown)[0]:
                reasons[i] = f"unknown model id {int(mids[i])}"
            bad |= unknown
            rows[unknown] = 0
    return rows, bad, reasons


def raw_trace(rng: np.random.Generator, n_packets: int, *,
              n_flows: int = 256, model_ids: Sequence[int] = (1,),
              pattern: str = "mixed", base_period: int = 1024,
              jitter: int = 0, burst_len: int = 8,
              burst_gap: int = 16384, intra_gap: int = 16,
              fixed_length: bool = True) -> np.ndarray:
    """Deterministic raw 5-tuple trace with bursty and/or periodic flows —
    the workload the paper's QoS/anomaly models actually see before any
    feature vector exists.

    Each of ``n_flows`` flows gets a random (but rng-deterministic) 5-tuple
    and a model id (cyclic over ``model_ids`` — the classifier steering
    that flow's packets to one tenant model), then emits arrivals:

      * ``"periodic"`` — fixed inter-arrival ``base_period`` (per-flow phase
        offset, optional ±``jitter`` ticks): the telemetry/heartbeat regime
        whose flow features converge — exactly the traffic where per-flow
        state, not FLOPs, decides in-network throughput.
      * ``"bursty"``   — packet trains: ~``burst_len`` packets ``intra_gap``
        ticks apart, trains separated by ~``burst_gap`` ticks (geometric
        sizes / exponential gaps) — the heavy-hitter / anomaly regime.
      * ``"mixed"``    — even flows periodic, odd flows bursty.

    ``fixed_length`` gives every periodic flow one constant packet length
    (telemetry-like); bursty flows always draw per-packet lengths.  Returns
    ``(n_packets, RAW_HEADER_BYTES)`` uint8 rows sorted by arrival tick
    (stable, so per-flow order is generation order).
    """
    if pattern not in ("periodic", "bursty", "mixed"):
        raise ValueError(f"unknown trace pattern: {pattern!r}")
    if n_flows <= 0 or n_packets <= 0:
        raise ValueError("n_flows and n_packets must be positive")
    per_flow = -(-n_packets // n_flows) + 2  # ceil + margin before the sort
    mids = np.asarray(model_ids, np.int64)

    flow_src = rng.integers(0, 2 ** 32, n_flows, np.uint32).astype(np.int64)
    flow_dst = rng.integers(0, 2 ** 32, n_flows, np.uint32).astype(np.int64)
    flow_sp = rng.integers(1024, 65536, n_flows).astype(np.int64)
    flow_dp = rng.integers(1, 1024, n_flows).astype(np.int64)
    flow_proto = rng.choice(np.asarray([6, 17], np.int64), n_flows)
    flow_mid = mids[np.arange(n_flows) % mids.size]
    flow_len = rng.integers(64, 1500, n_flows).astype(np.int64)

    all_ts, all_flow = [], []
    for i in range(n_flows):
        periodic = pattern == "periodic" or (pattern == "mixed"
                                             and i % 2 == 0)
        if periodic:
            phase = int(rng.integers(0, base_period))
            ts = phase + np.arange(per_flow, dtype=np.int64) * base_period
            if jitter:
                ts = ts + rng.integers(-jitter, jitter + 1, per_flow)
        else:
            iats = np.where(
                rng.random(per_flow) < 1.0 / max(burst_len, 1),
                rng.exponential(burst_gap, per_flow),
                float(intra_gap)).astype(np.int64)
            iats[0] = rng.integers(0, burst_gap)
            ts = np.cumsum(iats)
        all_ts.append(ts)
        all_flow.append(np.full(per_flow, i, np.int64))
    ts = np.concatenate(all_ts)
    flow = np.concatenate(all_flow)
    order = np.argsort(ts, kind="stable")[:n_packets]
    ts, flow = ts[order], flow[order]
    ts = np.minimum(ts, 2 ** 31 - 1)

    if fixed_length:
        length = flow_len[flow]
        bursty_pkt = np.zeros(flow.shape[0], bool)
        if pattern == "bursty":
            bursty_pkt[:] = True
        elif pattern == "mixed":
            bursty_pkt = flow % 2 == 1
        if bursty_pkt.any():
            length = length.copy()
            length[bursty_pkt] = rng.integers(
                64, 1500, int(bursty_pkt.sum()))
    else:
        length = rng.integers(64, 1500, flow.shape[0]).astype(np.int64)

    return encode_raw_headers(flow_src[flow], flow_dst[flow], flow_sp[flow],
                              flow_dp[flow], flow_proto[flow],
                              flow_mid[flow], ts, length)


def packet_stream(cfg: PacketGenConfig) -> Iterator[Dict]:
    """Yields {'packets': uint8 (B, L), 'features': float32 (B, F),
    'model_id': int32 (B,)} forever: flow features, then each packet's Model
    ID drawn from ``cfg.model_ids``, then the codes
    ``round(features · 2**frac_bits)`` — the reference's draws in its order,
    so the packets are byte-identical to its stream for the same seed."""
    rng = np.random.default_rng(cfg.seed)
    while True:
        feats = flow_features(rng, cfg.batch, cfg.n_features)
        mids = rng.choice(cfg.model_ids, size=cfg.batch).astype(np.int32)
        codes = np.round(feats * (1 << cfg.frac_bits)).astype(np.int32)
        pkts = encode_packets_np(mids, cfg.frac_bits, codes)
        yield {"packets": pkts, "features": feats, "model_id": mids}
