"""The one traffic generator.  A mix is a data file,
``portbench/traffic/<name>.json``, of parameters this module reads:

* ``rows``: ``"features"`` (Table-1 feature packets for
  ``submit_packets``) or ``"raw"`` (21-byte 5-tuple headers for
  ``submit_raw``);
* ``loop``: ``"closed"`` (one client sends chunks back to back from a pool,
  draining every ``drain_every_chunks``) or ``"open"`` (chunks arrive as a
  Poisson process at ``rate_pps`` packets/s, drained every
  ``drain_period_ms``);
* ``chunk``: the inclusive range of chunk sizes, drawn uniformly;
* for feature rows: ``zipf_s`` over the configuration's installed ids in
  the order it lists them, ``unknown_share`` of ``unknown_ids``,
  ``dup_share`` exact duplicates of a row among the previous
  ``dup_window`` unique rows;
* for raw rows: ``n_flows``, ``pattern`` and ``extra_ids`` (Model IDs
  beyond the installed ones, cyclic over the flows with them);
* ``warmup_chunks``: chunks of the same stream sent in set-up.

Everything is drawn from the seed before the window opens.  Raw traffic
keeps its timestamps monotone: a pool that runs out replays with its
ticks shifted past the pool's span.
"""

from __future__ import annotations

import json

import numpy as np

from portbench.deploy import ROOT, WIDTH, installed_ids

FRAC = 8
HEADER_BYTES = 7
RAW_HEADER_BYTES = 21


def load_traffic(name: str) -> dict:
    path = ROOT / "traffic" / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    if mix.get("name") != name:
        raise ValueError(f"{path} names itself {mix.get('name')!r}")
    return mix


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def encode_features(mid: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Feature packets: Model ID, feature count, output count 0, scale
    ``FRAC``, flags 0, then the int32 codes big-endian."""
    n, w = x.shape
    out = np.zeros((n, HEADER_BYTES + 4 * w), np.uint8)
    out[:, 0] = (mid >> 8) & 0xFF
    out[:, 1] = mid & 0xFF
    out[:, 2] = w
    out[:, 5] = FRAC
    out[:, HEADER_BYTES:] = np.ascontiguousarray(
        x.astype(">i4")).view(np.uint8).reshape(n, 4 * w)
    return out


def zipf_ids(rng, n: int, ids, s: float, unknown_share: float,
             unknown_ids) -> np.ndarray:
    p = 1.0 / np.arange(1, len(ids) + 1) ** s
    mid = np.asarray(ids, np.int64)[rng.choice(len(ids), n, p=p / p.sum())]
    unk = rng.random(n) < unknown_share
    mid[unk] = np.asarray(unknown_ids, np.int64)[
        rng.integers(0, len(unknown_ids), int(unk.sum()))]
    return mid


def feature_rows(rng, n: int, mix: dict, ids) -> np.ndarray:
    """``n`` feature packets: unique rows of N(0, 1) features on the code
    grid under Zipf Model IDs, with ``dup_share`` of them exact repeats of
    a recent unique row."""
    dup = rng.random(n) < mix.get("dup_share", 0.0)
    dup[0] = False
    n_uniq = int((~dup).sum())
    x = np.round(rng.standard_normal((n_uniq, WIDTH), np.float32)
                 * np.float32(1 << FRAC)).astype(np.int32)
    mid = zipf_ids(rng, n_uniq, ids, mix["zipf_s"], mix["unknown_share"],
                   mix["unknown_ids"])
    uniq = encode_features(mid, x)
    last = np.cumsum(~dup) - 1          # latest unique row at or before i
    reach = np.minimum(last + 1, mix.get("dup_window", 1))
    pick = np.where(dup, last - np.floor(rng.random(n) * reach).astype(
        np.int64), last)
    return uniq[pick]


def encode_raw(src, dst, sport, dport, proto, mid, ts, length) -> np.ndarray:
    b = src.shape[0]
    out = np.empty((b, RAW_HEADER_BYTES), np.uint8)

    def be(col, val, nbytes):
        val = np.broadcast_to(np.asarray(val, np.int64), (b,))
        for i in range(nbytes):
            out[:, col + i] = (val >> (8 * (nbytes - 1 - i))) & 0xFF
    be(0, src, 4)
    be(4, dst, 4)
    be(8, sport, 2)
    be(10, dport, 2)
    be(12, proto, 1)
    be(13, mid, 2)
    be(15, ts, 4)
    be(19, length, 2)
    return out


def raw_trace(rng, n_packets: int, *, n_flows: int, model_ids,
              pattern: str = "mixed", base_period: int = 1024,
              burst_len: int = 8, burst_gap: int = 16384,
              intra_gap: int = 16) -> np.ndarray:
    """Raw 5-tuple trace: even flows periodic (one packet every
    ``base_period`` ticks from a random phase, one length per flow), odd
    flows bursty (trains of about ``burst_len`` packets ``intra_gap``
    apart, trains about ``burst_gap`` apart, lengths per packet); Model
    IDs cyclic over the flows; rows sorted by tick, stably."""
    per_flow = -(-n_packets // n_flows) + 2
    mids = np.asarray(model_ids, np.int64)
    src = rng.integers(0, 2 ** 32, n_flows, np.uint32).astype(np.int64)
    dst = rng.integers(0, 2 ** 32, n_flows, np.uint32).astype(np.int64)
    sport = rng.integers(1024, 65536, n_flows).astype(np.int64)
    dport = rng.integers(1, 1024, n_flows).astype(np.int64)
    proto = rng.choice(np.asarray([6, 17], np.int64), n_flows)
    fmid = mids[np.arange(n_flows) % mids.size]
    flen = rng.integers(64, 1500, n_flows).astype(np.int64)
    periodic = np.zeros(n_flows, bool)
    if pattern in ("periodic", "mixed"):
        periodic[::1 if pattern == "periodic" else 2] = True
    n_per = int(periodic.sum())
    n_bur = n_flows - n_per
    ts = np.empty((n_flows, per_flow), np.int64)
    phase = rng.integers(0, base_period, n_per)
    ts[periodic] = phase[:, None] + np.arange(per_flow) * base_period
    if n_bur:
        new_train = rng.random((n_bur, per_flow)) < 1.0 / max(burst_len, 1)
        gaps = rng.exponential(burst_gap, (n_bur, per_flow))
        iats = np.where(new_train, gaps, float(intra_gap)).astype(np.int64)
        iats[:, 0] = rng.integers(0, burst_gap, n_bur)
        ts[~periodic] = np.cumsum(iats, axis=1)
    flow = np.repeat(np.arange(n_flows), per_flow)
    ts = ts.reshape(-1)
    order = np.argsort(ts, kind="stable")[:n_packets]
    ts, flow = np.minimum(ts[order], 2 ** 31 - 1), flow[order]
    length = flen[flow]
    bursty = ~periodic[flow]
    length[bursty] = rng.integers(64, 1500, int(bursty.sum()))
    return encode_raw(src[flow], dst[flow], sport[flow], dport[flow],
                      proto[flow], fmid[flow], ts, length)


def raw_ts(rows: np.ndarray) -> np.ndarray:
    v = np.zeros(rows.shape[0], np.int64)
    for i in range(4):
        v = (v << 8) | rows[:, 15 + i]
    return v


def shift_ts(rows: np.ndarray, shift: int) -> np.ndarray:
    out = rows.copy()
    ts = raw_ts(rows) + shift
    for i in range(4):
        out[:, 15 + i] = (ts >> (8 * (3 - i))) & 0xFF
    return out


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


def chunk_sizes(rng, total: int, lo: int, hi: int) -> np.ndarray:
    """Chunk sizes in [lo, hi] covering ``total`` rows exactly."""
    sizes = rng.integers(lo, hi + 1, total // lo + 1)
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, total))
    sizes = sizes[: k + 1].copy()
    sizes[-1] -= ends[k] - total
    return sizes[sizes > 0]


class Stream:
    """The cell's traffic as an indexed sequence of chunks.

    ``rows`` holds the pool, ``bounds`` each chunk's start and end in it.
    A closed-loop stream replays the pool past its end (raw ticks shifted
    by the pool's span on each pass); an open-loop stream has exactly the
    chunks its schedule needs, ``due`` holding each window chunk's send
    time in seconds from the window's start."""

    def __init__(self, rows, bounds, warmup: int, due=None, shift: int = 0):
        self.rows, self.bounds, self.warmup = rows, bounds, warmup
        self.due, self.shift = due, shift
        self.n_pool = bounds.shape[0] - 1

    def chunk(self, i: int) -> np.ndarray:
        k, j = divmod(i, self.n_pool)
        rows = self.rows[self.bounds[j]: self.bounds[j + 1]]
        if k and self.shift:
            rows = shift_ts(rows, k * self.shift)
        return rows

    def served(self, n_chunks: int) -> np.ndarray:
        """The rows of chunks ``[0, n_chunks)`` in sending order."""
        return np.concatenate([self.chunk(i) for i in range(n_chunks)])


def make_rows(rng, n: int, mix: dict, cfg: dict) -> np.ndarray:
    if mix["rows"] == "features":
        return feature_rows(rng, n, mix, installed_ids(cfg))
    ids = installed_ids(cfg) + list(mix.get("extra_ids", []))
    return raw_trace(rng, n, n_flows=mix["n_flows"], model_ids=ids,
                     pattern=mix["pattern"])


def make_stream(mix: dict, cfg: dict, rng, seconds: float) -> Stream:
    """Build the cell's stream for a window of ``seconds``."""
    lo, hi = mix["chunk"]
    warm = int(mix["warmup_chunks"])
    if mix["loop"] == "closed":
        n = int(mix["pool_packets"])
        sizes = chunk_sizes(rng, n, lo, hi)
        rows = make_rows(rng, n, mix, cfg)
        shift = 0
        if mix["rows"] == "raw":
            ts = raw_ts(rows)
            shift = int(ts.max() - ts.min()) + 1
        bounds = np.r_[0, np.cumsum(sizes)]
        return Stream(rows, bounds, warm, shift=shift)
    rate = float(mix["rate_pps"])
    mean = (lo + hi) / 2.0
    n_arrivals = int(rate / mean * seconds * 1.5) + 64
    gaps = rng.exponential(mean / rate, n_arrivals)
    due = np.cumsum(gaps) - gaps[0]
    due = due[due < seconds]
    sizes = rng.integers(lo, hi + 1, warm + due.shape[0])
    bounds = np.r_[0, np.cumsum(sizes)]
    rows = make_rows(rng, int(bounds[-1]), mix, cfg)
    return Stream(rows, bounds, warm, due=due)
