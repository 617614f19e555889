"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity only (CUPTI's activity records; no host op is recorded), read
into device intervals, per-kernel times and the idle gaps.

Host spans are the harness's own (``Spans``), taken on
``time.perf_counter_ns``.  The first device operation after the profiler
starts is a one-element fill launched right after a synchronisation; its
start on the device clock against the host time of its launch aligns the
two clocks to within the launch latency (microseconds), which is enough to
say what the host was doing in an idle gap of a millisecond.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np


class Spans:
    """Host spans of the window: (label, start ns, end ns), nested by time.
    ``totals`` sums each label's seconds (outer spans include inner)."""

    def __init__(self):
        self.items = []
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def wrap(self, fn, label: str):
        items, totals, counts = self.items, self.totals, self.counts
        clock = time.perf_counter_ns

        def call(*a, **kw):
            t0 = clock()
            try:
                return fn(*a, **kw)
            finally:
                t1 = clock()
                items.append((label, t0, t1))
                totals[label] += (t1 - t0) * 1e-9
                counts[label] += 1
        return call


class DeviceTrace:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marker = torch.zeros(1, device="cuda")

    def start(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter_ns()
        self.marker.fill_(1.0)
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def device_events(self) -> list:
        """(name, start ns, end ns) of every device operation, in the
        device clock, sorted by start."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            out.append((e.name(), e.start_ns(), e.end_ns()))
        out.sort(key=lambda r: r[1])
        return out


def merge(intervals: np.ndarray) -> np.ndarray:
    """Union of (start, end) rows, sorted and disjoint."""
    if intervals.shape[0] == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    start, end = iv[:, 0], np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, start[1:] > end[:-1]]
    s = start[new]
    e = np.r_[end[np.nonzero(new)[0][1:] - 1], end[-1]]
    return np.stack([s, e], 1)


def host_segments(spans: list, lo: int, hi: int) -> tuple:
    """Cut [lo, hi) into segments labelled by the innermost host spans
    active there ("a>b" for b inside a; "client" where none is)."""
    ev = []
    for k, (label, t0, t1) in enumerate(spans):
        ev.append((t0, 1, -(t1 - t0), k, label))
        ev.append((t1, 0, 0, k, label))
    ev.sort()
    bounds, labels, stack = [lo], [], []
    cur = "client"
    for t, kind, _, k, label in ev:
        t = min(max(t, lo), hi)
        if t > bounds[-1]:
            bounds.append(t)
            labels.append(cur)
        if kind:
            stack.append((k, label))
        else:
            stack = [s for s in stack if s[0] != k]
        cur = ">".join(s[1] for s in stack) if stack else "client"
    if hi > bounds[-1]:
        bounds.append(hi)
        labels.append(cur)
    return np.asarray(bounds, np.int64), labels


def summarize(trace: DeviceTrace, spans: list, kernels: dict) -> dict:
    """Busy and idle over the traced window, device time and record count
    per kernel (``kernels``: key → (launch keys, names counted, names only
    timed)), the ten device
    operations that took most time, and idle time by host activity."""
    ev = trace.device_events()
    if not ev:
        return dict(events=0)
    offset = ev[0][1] - trace.t_mark            # device clock - host clock
    lo, hi = trace.t0 + offset, trace.t1 + offset
    names = [e[0] for e in ev]
    iv = np.asarray([(max(e[1], lo), min(e[2], hi)) for e in ev
                     if e[2] > lo and e[1] < hi], np.int64).reshape(-1, 2)
    busy = merge(iv)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if busy.size else 0
    by_name = defaultdict(float)
    for n, s, e in ev:
        if e > lo and s < hi:
            by_name[n] += (min(e, hi) - max(s, lo)) * 1e-9
    per_kernel = {}
    for key, (_, counted, timed) in kernels.items():
        sel = [(n, s, e) for n, s, e in ev
               if any(x in n for x in counted + timed) and e > lo and s < hi]
        per_kernel[key] = dict(
            records=sum(any(x in n for x in counted) for n, _, _ in sel),
            seconds=sum((e - s) * 1e-9 for _, s, e in sel))
    # idle gaps between busy intervals, cut by what the host was doing
    edges = np.r_[lo, busy.reshape(-1), hi].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]] - offset   # host clock
    bounds, labels = host_segments(spans, trace.t0, trace.t1)
    idle = defaultdict(float)
    seg_lo, seg_hi = bounds[:-1], bounds[1:]
    for a, b in gaps:
        i0 = max(int(np.searchsorted(seg_hi, a, "right")), 0)
        i1 = int(np.searchsorted(seg_lo, b, "left"))
        for i in range(i0, min(i1, len(labels))):
            ov = min(b, seg_hi[i]) - max(a, seg_lo[i])
            if ov > 0:
                idle[labels[i]] += ov * 1e-9
    top = sorted(by_name.items(), key=lambda r: -r[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda r: -r[1])[:10]
    return dict(events=len(names), marker=ev[0][0], busy_s=busy_ns * 1e-9,
                window_s=(trace.t1 - trace.t0) * 1e-9, per_kernel=per_kernel,
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in gaps_top])
