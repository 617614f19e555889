"""The window's arithmetic: a rate over all the work and all the time of
the window, a percentile over every packet, and latency from each chunk's
scheduled time to the return of the drain that answers it."""

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from portbench import bench, traffic  # noqa: E402


def test_percentile_nearest_rank_over_all_values():
    v = np.arange(1, 201, dtype=float)          # 1..200
    assert bench.percentile(v, 99) == 198.0
    assert bench.percentile(v, 50) == 100.0
    assert bench.percentile(v[::-1], 100) == 200.0
    assert bench.percentile([5.0], 99) == 5.0


class _StubServer:
    """Answers every packet at the next drain, which takes ``drain_s``."""

    def __init__(self, drain_s: float):
        self.drain_s = drain_s
        self.pending = 0

    def submit(self, chunk):
        self.pending += chunk.shape[0]

    def drain_packets(self):
        time.sleep(self.drain_s)
        out = [np.zeros(1, np.uint8)] * self.pending
        self.pending = 0
        return out


def _cell(stream, mix, srv):
    cell = bench.Cell.__new__(bench.Cell)
    cell.stream, cell.mix, cell.srv = stream, mix, srv
    cell.submit, cell.outs, cell.device = srv.submit, [], "cpu"
    cell.n_chunks = stream.warmup
    return cell


def test_open_loop_latency_runs_from_due_time():
    due = np.asarray([0.0, 0.002, 0.004, 0.0041, 0.02])
    sizes = np.asarray([3, 1, 2, 5, 4])
    st = traffic.Stream(np.zeros((sizes.sum(), 1), np.uint8),
                        np.r_[0, np.cumsum(sizes)], 0, due=due)
    srv = _StubServer(0.003)
    win = _cell(st, {"drain_period_ms": 1.0}, srv).open_loop(0.03)
    assert win["sent"] == sizes.sum() and win["lat_s"].size == sizes.sum()
    # each packet waits at least for a drain after its due time, never less
    assert (win["lat_s"] >= 0.003).all()
    # the late chunk at 4.1 ms waits behind the drain started at ~4 ms
    per_chunk = win["lat_s"][np.cumsum(sizes) - 1]
    assert per_chunk[3] > per_chunk[0]
    # every packet's latency counted, weighted by its chunk
    assert win["lat_s"].size == 15
    assert (win["late_s"] >= 0).all()


def test_closed_loop_rate_counts_all_work_and_time():
    sizes = np.full(50, 10)
    st = traffic.Stream(np.zeros((500, 1), np.uint8),
                        np.r_[0, np.cumsum(sizes)], 2)
    srv = _StubServer(0.001)
    win = _cell(st, {"drain_every_chunks": 4}, srv).closed_loop(0.05)
    dt = win["t1"] - win["t0"]
    assert dt >= 0.05
    assert win["sent"] == 10 * win["chunks"]
    assert srv.pending == 0                     # the last drain is inside


def test_stream_replays_raw_with_ticks_past_the_pool():
    rng = np.random.default_rng(1)
    rows = traffic.raw_trace(rng, 1000, n_flows=16, model_ids=[1, 2])
    ts = traffic.raw_ts(rows)
    assert (np.diff(ts) >= 0).all()
    span = int(ts.max() - ts.min()) + 1
    st = traffic.Stream(rows, np.asarray([0, 400, 1000]), 0, shift=span)
    again = traffic.raw_ts(st.chunk(2))
    assert again[0] > ts.max() and (np.diff(again) >= 0).all()
    assert np.array_equal(st.chunk(2)[:, :15], rows[:400, :15])


def test_feature_duplicates_repeat_recent_rows():
    cfg = {"mlps": [{"id": i} for i in (1, 2, 3)], "forests": []}
    mix = {"zipf_s": 1.0, "unknown_share": 0.0, "unknown_ids": [9],
           "dup_share": 0.3, "dup_window": 64}
    rows = traffic.feature_rows(np.random.default_rng(2), 4000, mix,
                                [1, 2, 3])
    _, first, inv = np.unique(rows, axis=0, return_index=True,
                              return_inverse=True)
    inv = inv.reshape(-1)
    dup = first[inv] != np.arange(rows.shape[0])
    assert 0.25 < dup.mean() < 0.35
    uniq_before = np.cumsum(~dup)
    # a duplicate repeats one of the last 64 unique rows
    back = uniq_before[np.nonzero(dup)[0]] - np.searchsorted(
        np.nonzero(~dup)[0], first[inv[dup]])
    assert back.max() <= 64
    mid = (rows[:, 0].astype(int) << 8) | rows[:, 1]
    assert np.mean(mid == 1) > np.mean(mid == 3)


def test_readers_arithmetic():
    """The host-side readers on a hand-made record: shares of the window,
    per-packet host time, counter ratios, the median latency and the idle
    share of a trace; a reader with nothing to read returns None."""
    from portbench.profile import Spans

    spans = Spans()
    spans.totals.update(extract=2.0, engine=1.0)
    spans.counts.update(extract=10, engine=5)
    lat = np.arange(1, 101) * 1e-6
    rec = bench.Record(
        window_s=10.0, win={"sent": 1000, "lat_s": lat}, spans=spans,
        counters={"cache_hits_total": 30.0, "cache_misses_total": 70.0,
                  "engine_packets_total": 300.0,
                  "ingress_lane_batches_total": 6.0},
        trace={"events": 5, "busy_s": 0.5, "window_s": 10.0})
    read = bench.load_reader
    assert read("extract_share.sat")(rec) == 20.0
    assert read("engine_share.open")(rec) == 10.0
    assert read("ingress_us_per_pkt.sat")(rec) == 7000.0
    assert read("cache_hit_share.sat")(rec) == 30.0
    assert read("batch_rows.open")(rec) == 50.0
    assert abs(read("lat_p50_us.open")(rec) - 50.0) < 1e-9
    assert abs(read("idle_share.sat")(rec) - 95.0) < 1e-9
    empty = bench.Record(window_s=1.0, win={"sent": 0}, spans=Spans(),
                         counters={}, trace=None)
    for name in ("extract_share.sat", "engine_share.sat", "idle_share.sat",
                 "cache_hit_share.sat", "batch_rows.open", "lat_p50_us.open",
                 "ingress_us_per_pkt.sat"):
        assert read(name)(empty) is None
