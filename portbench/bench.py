"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

The window drives the program through the entry points a user calls:
``PacketServer.submit_packets``/``drain_packets`` for a ``packets``
configuration and ``PacketServer.submit_raw``/``drain_packets`` for a
``raw`` one.  A closed-loop mix sends chunks back to back until the window's
seconds have passed, then drains; an open-loop mix sends each chunk at its
scheduled time and drains on a fixed cadence, and every packet's latency
runs from its chunk's scheduled time to the return of the drain that hands
back its row.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from portbench import deploy, traffic
from portbench.deploy import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE = 65536          # egress rows compared with the reference per run
KERNELS = {             # kernel → (launch-counter keys, device kernel
    "mlp": (("int16", "int8"), ("fixedpoint_mlp_kernel",), ()),  # names
    "forest": (("range", "chase"),                      # counted, names
               ("forest_range_kernel", "forest_chase_kernel"), ()),  # also
    "flow": (("flow_update",), ("flow_apply_kernel",),  # timed)
             ("flow_links_kernel",)),
}


def load_benchmark(root: Path = ROOT.parent) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def percentile(values: np.ndarray, q: float) -> float:
    """The ``q``-th percentile of all values (nearest rank)."""
    v = np.sort(np.asarray(values, np.float64))
    k = max(int(np.ceil(q / 100.0 * v.size)) - 1, 0)
    return float(v[k])


def launches() -> dict:
    """The program's per-kernel launch counters."""
    out = {}
    for m in ("fixedpoint_mlp", "flow_update", "forest_traversal"):
        out.update(importlib.import_module(
            f"repro_torch.kernels.{m}").launches)
    return out


def per_second(t: np.ndarray, n: np.ndarray) -> list:
    """Packets per whole second of the window (``n[i]`` packets at
    ``t[i]`` seconds from its start)."""
    return np.bincount(t.astype(np.int64), weights=n).astype(
        np.int64).tolist()


def registry(srv) -> dict:
    """The program's counters, summed over label sets."""
    snap = srv.obs.registry.snapshot()
    out = {}
    for name, v in snap.items():
        if isinstance(v, dict) and all(isinstance(x, (int, float))
                                       for x in v.values()):
            out[name] = float(sum(v.values()))
        elif isinstance(v, (int, float)):
            out[name] = float(v)
    return out


class Cell:
    """A cell made ready to serve: configuration, mix, the program's
    server with its models, and the stream, all from the seed."""

    def __init__(self, workload: dict, seed: int, seconds: float, *,
                 device: str = "cuda", mix_override=None,
                 server_override=None):
        self.workload = workload
        self.cfg = deploy.load_config(workload["config"])
        self.mix = dict(traffic.load_traffic(workload["traffic"]),
                        **(mix_override or {}))
        want = {"packets": "features", "raw": "raw"}[self.cfg["surface"]]
        if self.mix["rows"] != want:
            raise ValueError(f"{workload['name']}: mix rows "
                             f"{self.mix['rows']!r} do not fit surface "
                             f"{self.cfg['surface']!r}")
        clock = time.perf_counter
        t = [clock()]
        g = deploy.streams(seed, 4)
        self.rng_sample = g[3]
        self.mlps = deploy.make_mlps(self.cfg, g[0])
        self.forests = deploy.make_forests(self.cfg, g[1])
        t.append(clock())
        self.srv = deploy.build_server(self.cfg, self.mlps, self.forests,
                                       device, **(server_override or {}))
        t.append(clock())
        self.device = device
        self.stream = traffic.make_stream(self.mix, self.cfg, g[2], seconds)
        t.append(clock())
        self.phases = dict(zip(("models_s", "server_s", "traffic_s"),
                               np.diff(t).tolist()))
        self.submit = (self.srv.submit_packets
                       if self.cfg["surface"] == "packets"
                       else self.srv.submit_raw)
        self.outs = []          # drain results in order
        self.n_chunks = 0       # chunks sent so far

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def warm(self) -> None:
        """Every dispatch shape of the cell once (the engine's dead-batch
        warm-up, every lane program the cell's models use), then the
        stream's warm-up chunks through the same entry points."""
        srv = self.srv
        t0 = time.perf_counter()
        lanes = ("mlp", "forest", "both") if self.forests else ("mlp",)
        srv.engine.warm(srv.ingress.batch_size, 7 + 4 * deploy.WIDTH,
                        lanes=lanes)
        self.sync()
        t1 = time.perf_counter()
        every = int(self.mix.get("warmup_drain_every",
                                 self.mix.get("drain_every_chunks", 1)))
        for i in range(self.stream.warmup):
            self.submit(self.stream.chunk(i))
            if (i + 1) % every == 0:
                self.outs.append(srv.drain_packets())
        self.outs.append(srv.drain_packets())
        self.n_chunks = self.stream.warmup
        self.n_warm = sum(len(o) for o in self.outs)
        self.sync()
        self.phases.update(engine_warm_s=t1 - t0,
                           warmup_chunks_s=time.perf_counter() - t1)

    # -- the window ---------------------------------------------------------

    def closed_loop(self, seconds: float) -> dict:
        srv, st = self.srv, self.stream
        every = int(self.mix["drain_every_chunks"])
        i, sent, k = self.n_chunks, 0, 0
        clock = time.perf_counter
        marks = []
        t0 = clock()
        deadline = t0 + seconds
        while True:
            c = st.chunk(i)
            self.submit(c)
            i += 1
            k += 1
            sent += c.shape[0]
            if k % every == 0:
                self.outs.append(srv.drain_packets())
            now = clock()
            marks.append((now, sent))
            if now >= deadline:
                break
        self.outs.append(srv.drain_packets())
        self.sync()
        t1 = clock()
        self.n_chunks = i
        t, n = np.asarray(marks).T
        return dict(t0=t0, t1=t1, sent=sent, chunks=k,
                    series=per_second(t - t0, np.diff(np.r_[0, n])))

    def open_loop(self, seconds: float) -> dict:
        srv, st = self.srv, self.stream
        period = float(self.mix["drain_period_ms"]) * 1e-3
        due = st.due
        n = due.shape[0]
        base = self.n_chunks
        sizes = np.diff(st.bounds)[base: base + n]
        sent_at = np.empty(n)
        done_at = np.empty(n)
        clock = time.perf_counter
        sleep = time.sleep
        t0 = clock()
        due_abs = t0 + due
        next_drain = t0 + period
        k = drained = 0
        while drained < n:
            now = clock()
            if now >= next_drain:
                if k > drained:
                    self.outs.append(srv.drain_packets())
                    done_at[drained:k] = clock()
                    drained = k
                next_drain += period
                if next_drain <= now:
                    next_drain = now + period
                continue
            if k < n and due_abs[k] <= now:
                self.submit(st.chunk(base + k))
                sent_at[k] = clock()
                k += 1
                continue
            wake = min(due_abs[k] if k < n else next_drain, next_drain)
            if wake - now > 2e-4:
                sleep((wake - now) * 0.5)
        self.sync()
        t1 = clock()
        self.n_chunks = base + n
        lat = np.repeat(done_at - due_abs, sizes)
        late = sent_at - due_abs
        return dict(t0=t0, t1=t1, sent=int(sizes.sum()), chunks=n,
                    lat_s=lat, late_s=late,
                    series=per_second(done_at - t0, sizes))

    # -- after the window ---------------------------------------------------

    def results(self) -> list:
        out = []
        for o in self.outs:
            out.extend(o)
        return out


def compare(cell: Cell, n_window: int) -> tuple:
    """The program's answers against the reference's: every packet's kind
    (egress row or error slot), the bytes of a seed-drawn sample of the
    window's rows, and for a raw configuration the final registers, sketch
    and flow-table counters.  Returns (checks, failed)."""
    from portbench.reference import dataplane as ref

    got = cell.results()
    rows = cell.stream.served(cell.n_chunks)
    if len(got) != rows.shape[0]:
        raise RuntimeError(f"{len(got)} answers for {rows.shape[0]} packets")
    is_row = np.fromiter((isinstance(o, np.ndarray) for o in got), bool,
                         len(got))
    mlps_q, forests_q = deploy.reference_tables(cell.mlps, cell.forests)
    n = rows.shape[0]
    lo = n - n_window
    pick = np.sort(cell.rng_sample.choice(
        n_window, min(SAMPLE, n_window), replace=False)) + lo
    checks = {}
    if cell.cfg["surface"] == "packets":
        want_row = np.ones(n, bool)
        want = ref.feature_egress(rows[pick], mlps_q, forests_q)
    else:
        ids = deploy.installed_ids(cell.cfg)
        fl = ref.flow_features(rows, ids)
        want_row = fl["ok"]
        specs = {int(k): v for k, v in cell.cfg["feature_specs"].items()}
        pos = np.cumsum(want_row) - 1           # index among served rows
        sel = pick[want_row[pick]]
        p = pos[sel]
        x = ref.spec_inputs(fl["feats"][p], fl["mid"][p], specs)
        want = np.zeros((pick.size, ref.HEADER_BYTES + 4 * ref.WIDTH),
                        np.uint8)
        want[want_row[pick]] = ref.egress(
            fl["mid"][p], np.zeros(p.size, np.int64),
            ref.answer(fl["mid"][p], x, mlps_q, forests_q))
    checks["kind_mismatches"] = int((is_row != want_row).sum())
    bad = 0
    for j, i in enumerate(pick.tolist()):
        if want_row[i]:
            o = got[i]
            if not isinstance(o, np.ndarray) or not np.array_equal(o, want[j]):
                bad += 1
    checks["sample_mismatches"] = bad
    if cell.cfg["surface"] == "raw":
        snap = cell.srv.flow.table.snapshot()
        keys = np.ascontiguousarray(snap["keys"]).view(np.uint8).reshape(
            -1, 8 * snap["keys"].shape[1])[:, : ref.RAW_KEY_BYTES]
        regs = {bytes(k): r for k, r in zip(keys, snap["registers"])}
        miss = sum(not np.array_equal(regs.get(bytes(k), -1), r)
                   for k, r in zip(fl["keys"], fl["registers"]))
        checks["register_mismatches"] = int(miss + abs(len(regs)
                                                       - fl["n_flows"]))
        checks["sketch_mismatches"] = int(
            (np.asarray(cell.srv.flow.cms, np.int64) != fl["cms"]).sum())
        st = cell.srv.flow.table.stats
        checks["table_counter_mismatches"] = int(
            abs(st["flow_created_total"] - fl["n_flows"])
            + st["flow_expiries_total"] + st["flow_evictions_total"]
            + st["flow_rejects_total"])
        cell.ref_flow = fl
    failed = int((~is_row[lo:] & want_row[lo:]).sum())
    cell.ref_pick, cell.ref_rows = pick, rows
    return checks, failed


def load_reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, else
    ``metrics/<name up to its first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = ROOT / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {name!r}")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Record:
    """What a per-layer reader reads: the window, the host spans, the
    program's counters and launch counts over the window, the device
    trace's summary, the latencies and the work the kernels' functions
    needed."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run(workload: dict, bench: dict, *, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t_start: float = None,
        mix_override=None, server_override=None, marks=None) -> dict:
    """Run one cell and return the result object (without printing)."""
    if t_start is None:
        t_start = time.perf_counter()
    surface = deploy.load_config(workload["config"])["surface"]
    if surface not in ("packets", "raw"):
        return importlib.import_module(f"portbench.surfaces.{surface}").run(
            workload, bench, seed=seed, seconds=seconds, trace=trace,
            device=device, t_start=t_start, marks=marks,
            mix_override=mix_override, server_override=server_override)
    name = workload["name"]
    t_run = time.perf_counter()
    cell = Cell(workload, seed, seconds, device=device,
                mix_override=mix_override, server_override=server_override)
    cell.warm()
    srv = cell.srv
    spans = dev_trace = None
    batches, extracts = [], []
    if trace:
        from portbench.profile import Spans
        spans = Spans()
        cell.submit = spans.wrap(cell.submit, "submit")
        srv.drain_packets = spans.wrap(srv.drain_packets, "drain")
        eng = srv.engine.run_features

        def run_features(x0, mid, **kw):
            before = launches()
            out = eng(x0, mid, **kw)
            after = launches()
            fired = {k for k in after if after[k] != before.get(k, 0)}
            m = np.array(mid, np.int64, copy=True)
            fx = None
            if cell.forests and fired & {"range", "chase"}:
                fsel = np.isin(m, list(cell.forests))
                fx = (np.array(x0, np.int32)[fsel], m[fsel])
            batches.append((fired, m, fx))
            return out
        srv.engine.run_features = spans.wrap(run_features, "engine")
        if cell.cfg["surface"] == "raw":
            ext = srv.flow.extract

            def extract(raw, **kw):
                extracts.append(raw)
                return ext(raw, **kw)
            srv.flow.extract = spans.wrap(extract, "extract")
        if device != "cpu":
            from portbench.profile import DeviceTrace
            dev_trace = DeviceTrace()
    c0, l0 = registry(srv), launches()
    cell.sync()
    setup_s = time.perf_counter() - t_start
    if dev_trace is not None:
        dev_trace.start()
    loop = (cell.closed_loop if cell.mix["loop"] == "closed"
            else cell.open_loop)
    win = loop(seconds)
    if dev_trace is not None:
        dev_trace.stop()
    c1, l1 = registry(srv), launches()
    window_s = win["t1"] - win["t0"]
    device_info = device_block(device)
    checks, failed = compare(cell, win["sent"])
    counters = {k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in c1}
    fired = {k: l1[k] - l0.get(k, 0) for k in l1}
    result = dict(correct=all(v == 0 for v in checks.values()),
                  attempted=int(win["sent"]), failed=failed)
    metrics, breakdown = {}, None
    if not trace:
        pps = win["sent"] / window_s
        for m in bench["end_to_end"]:
            if not applies(m, name):
                continue
            v = {"pps": pps, "setup_s": setup_s}.get(m["name"])
            if m["name"] == "lat_p99_us":
                v = percentile(win["lat_s"], 99) * 1e6
            if v is None:
                raise KeyError(f"no measurement for {m['name']}")
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        summary = None
        if dev_trace is not None:
            from portbench.profile import summarize
            summary = summarize(dev_trace, spans.items, KERNELS)
            lost = {}
            for k, v in summary.get("per_kernel", {}).items():
                n = sum(fired.get(c, 0) for c in KERNELS[k][0])
                if v["records"] != n:
                    lost[k] = (v["records"], n)
            if lost:
                raise RuntimeError(
                    f"device trace records differ from the launch counters "
                    f"(records, launches): {lost}")
            device_info.update(busy_s=summary["busy_s"],
                               window_s=summary["window_s"])
            breakdown = dict(device_ops=[[n[:120], s] for n, s in
                                         summary["device_ops"]],
                             idle_gaps=summary["idle_gaps"])
        rec = Record(cell=cell, workload=name, window_s=window_s, win=win,
                     spans=spans, counters=counters, launches=fired,
                     trace=summary, batches=batches, extracts=extracts)
        for m in bench["per_layer"]:
            if not applies(m, name):
                continue
            v = load_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    result.update(metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["client"] = client_block(win, window_s, cell)
    result["client"]["setup_phases"] = dict(
        before_run_s=t_run - t_start, **(marks or {}), **cell.phases)
    result["checks"] = {k: dict(value=v, limit=0) for k, v in checks.items()}
    return result


def device_block(device: str) -> dict:
    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    import torch
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=1, memory_peak_bytes=int(
                    torch.cuda.max_memory_allocated()))


def client_block(win: dict, window_s: float, cell: Cell) -> dict:
    out = dict(window_s=window_s, chunks=int(win["chunks"]),
               warmup_packets=int(cell.n_warm),
               packets_per_second=win["series"])
    if "late_s" in win:
        late = win["late_s"]
        out.update(offered_pps=win["sent"] / float(cell.stream.due[-1] + 1e-9)
                   if len(cell.stream.due) else 0.0,
                   late_p50_us=percentile(late, 50) * 1e6,
                   late_p99_us=percentile(late, 99) * 1e6,
                   late_max_us=float(late.max()) * 1e6,
                   late_last_us=float(late[-1]) * 1e6)
    return out
