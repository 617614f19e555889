"""The port's host stage counters (``repro_torch.obs.StageClock``), on the
CPU with a clock that advances 1 us on every read:

  * self time under nesting, swaps and an exception raised inside a nested
    stage, exact to the read;
  * ``PacketServer(device="cpu")`` on a seeded feature trace and on a raw
    trace with strict Model IDs and error slots: for every call to
    ``submit_packets``, ``submit_raw`` and ``drain_packets`` the twelve
    stage counters sum to the clock's advance inside the call, and every
    stage whose path ran reads above zero; the same holds through the
    dispatch retry and salvage paths, which raise inside stages;
  * the counters are in ``obs.snapshot()`` and the Prometheus text under
    each pipeline's ``shard`` label, on a fabric too;
  * the answers are byte-identical to the JAX reference's: the counters
    change no output.
"""

import numpy as np
import pytest
import torch

from repro.core.packet import encode_packets_np
from repro.launch.serve import PacketServer as JServer
from repro_torch.core.ingress import PacketError
from repro_torch.data import packets as tdata
from repro_torch.launch.serve import PacketServer as TServer
from repro_torch.obs import STAGES, StageClock
from repro_torch.obs.trace import (ENGINE_DISPATCH, FLOW_PARSE,
                                   INGRESS_KEY, SERVER_CALL)
from repro_torch.serve import FaultPlan, FaultSpec, ShardedPacketServer

torch.set_num_threads(1)

US = 1e-6
WIDTH = 8
FLOW_STAGES = {"flow_parse", "flow_table", "flow_state", "flow_gather"}


class StepClock:
    """Advances 1 us on every read; counts the reads."""

    def __init__(self):
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return self.reads * US


def _us(seconds):
    return {k: round(v / US, 6) for k, v in seconds.items()}


# ---------------------------------------------------------------------------
# the clock itself
# ---------------------------------------------------------------------------


def test_self_time_under_nesting():
    clk = StepClock()
    sc = StageClock(clock=clk)
    sc.push(SERVER_CALL)             # read 1
    sc.push(INGRESS_KEY)             # read 2: server_call +1
    sc.push(ENGINE_DISPATCH)         # read 3: ingress_key +1
    clk()
    clk()                            # reads 4, 5 inside the dispatch
    sc.pop()                         # read 6: engine_dispatch +3
    sc.swap(FLOW_PARSE)              # read 7: ingress_key +1
    sc.pop()                         # read 8: flow_parse +1
    sc.pop()                         # read 9: server_call +1
    assert sc.depth == 0 and sc.last == 9 * US
    want = dict.fromkeys(STAGES, 0.0)
    want.update(server_call=2, ingress_key=2, engine_dispatch=3,
                flow_parse=1)
    assert _us(sc.seconds()) == want
    clk()                            # nothing open: charged to no stage
    sc.push(SERVER_CALL)
    sc.leave(0)
    assert _us(sc.seconds())["server_call"] == 3


def test_leave_unwinds_after_an_exception_in_a_nested_stage():
    clk = StepClock()
    sc = StageClock(clock=clk)

    def dispatch():
        sc.push(ENGINE_DISPATCH)     # read 3
        clk()                        # read 4
        raise RuntimeError("device lost")

    def call():
        d = sc.enter()               # read 1
        try:
            sc.push(INGRESS_KEY)     # read 2
            dispatch()
        finally:
            sc.leave(d)              # read 5: engine_dispatch +2

    with pytest.raises(RuntimeError):
        call()
    assert sc.depth == 0
    assert _us(sc.seconds()) == dict(dict.fromkeys(STAGES, 0.0),
                                     server_call=1, ingress_key=1,
                                     engine_dispatch=2)
    call_ok = sc.enter()             # read 6: the stack is clean again
    assert call_ok == 0 and sc.depth == 1
    assert sc.enter() == 1 and sc.depth == 1   # nested entry opens nothing
    sc.leave(1)                      # no read: nothing above depth 1
    sc.leave(0)                      # read 7
    assert clk.reads == 7 and _us(sc.seconds())["server_call"] == 2


def test_cells_are_registry_counters_under_the_labels():
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    clk = StepClock()
    sc = StageClock(reg, clock=clk, shard=3)
    sc.push(SERVER_CALL)
    sc.pop()
    snap = reg.snapshot()
    assert set(snap) == {f"{s}_seconds_total" for s in STAGES}
    assert snap["server_call_seconds_total"] == {'shard="3"': US}


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------


def _weights(rng, dims):
    return [(rng.normal(size=(a, b)).astype(np.float32) * 0.4,
             rng.normal(size=(b,)).astype(np.float32) * 0.1)
            for a, b in zip(dims[:-1], dims[1:])]


def _servers(clock, **kw):
    kw = dict(dict(max_models=4, max_layers=2, max_width=WIDTH,
                   ingress_batch=64, max_inflight=2), **kw)
    ts, js = TServer(device="cpu", clock=clock, **kw), JServer(**kw)
    rng = np.random.default_rng(5)
    for mid in (1, 2, 3):
        layers = _weights(rng, [WIDTH, WIDTH, 2])
        for s in (ts, js):
            s.install(mid, layers, ["relu"], final_activation="sigmoid")
            s.install_feature_spec(mid, (2, 3, 4, 5, 0, 1, 6, 7))
    return ts, js


def _feature_chunks(rng, n=900):
    n_uniq = n * 2 // 3
    feats = rng.integers(-600, 600, (n_uniq, WIDTH)).astype(np.int32)
    mids = rng.choice(np.asarray([1, 2, 3, 999], np.int32), n_uniq)
    fcnt = rng.integers(1, WIDTH + 4, n_uniq)   # some exceed max_features
    uniq = encode_packets_np(mids, 8, feats, feature_cnt=fcnt)
    rows = uniq[rng.permutation(np.concatenate(
        [np.arange(n_uniq), rng.integers(0, n_uniq, n - n_uniq)]))]
    cuts = np.unique(np.cumsum(rng.integers(1, 120, n // 10)))
    return np.split(rows, cuts[cuts < n])


def _raw_chunks(rng, n=1200):
    raw = tdata.raw_trace(rng, n, n_flows=30, model_ids=(1, 2, 3, 9),
                          pattern="mixed", burst_gap=2000)
    cuts = np.unique(np.cumsum(rng.integers(1, 200, n // 10)))
    chunks = np.split(raw, cuts[cuts < n])
    chunks.insert(2, chunks[2][:, :9])          # a truncated raw batch
    return chunks


def _serve_counted(srv, clk, submit, chunks, drain_every=4):
    """Serve ``chunks``, holding each call's counter sum to the clock's
    advance inside it; returns the answers and the per-call checks."""
    stages = srv.ingress.stages
    out, calls = [], []

    def counted(fn, *a):
        before = sum(stages.seconds().values())
        t0 = clk()
        r = fn(*a)
        t1 = clk()
        inside = (t1 - t0) / US - 2     # less the test's own two reads
        calls.append(((sum(stages.seconds().values()) - before) / US,
                      inside))
        assert stages.depth == 0
        return r

    for i, c in enumerate(chunks):
        counted(submit(srv), c)
        if (i + 1) % drain_every == 0:
            out.extend(counted(srv.drain_packets))
    out.extend(counted(srv.drain_packets))
    return out, calls


def _egress(out):
    return [o.reason if isinstance(o, PacketError) or hasattr(o, "reason")
            else np.asarray(o).tobytes() for o in out]


@pytest.mark.parametrize("surface", ["packets", "raw"])
def test_stages_partition_every_call_and_change_no_answer(surface):
    clk = StepClock()
    strict = surface == "raw"
    ts, js = _servers(clk, strict_model_ids=strict)
    rng = np.random.default_rng(23)
    chunks = (_feature_chunks(rng) if surface == "packets"
              else _raw_chunks(rng))

    def submit(s):
        return s.submit_packets if surface == "packets" else s.submit_raw

    t_out, calls = _serve_counted(ts, clk, submit, chunks)
    j_out = []
    for i, c in enumerate(chunks):
        submit(js)(c)
        if (i + 1) % 4 == 0:
            j_out.extend(js.drain_packets())
    j_out.extend(js.drain_packets())
    assert _egress(t_out) == _egress(j_out)
    assert any(isinstance(o, PacketError) for o in t_out)
    for got, want in calls:
        assert got == pytest.approx(want, abs=1e-6)
    sec = ts.ingress.stages.seconds()
    ran = set(STAGES) - (FLOW_STAGES if surface == "packets" else set())
    assert {k for k, v in sec.items() if v > 0} == ran
    assert ts.ingress.stats["ingress_errors_total"] > 0


def test_partition_holds_through_retries_and_salvage():
    """Every dispatch carrying model 2 fails at the dispatch site: the
    retries raise inside ``engine_dispatch`` and the salvage's probes
    bisect the batch; the counters still partition every call."""
    clk = StepClock()
    ts, _ = _servers(clk)
    FaultPlan([FaultSpec(site="dispatch", match_model_id=2,
                         count=1 << 30)]).install(ts.ingress)
    rng = np.random.default_rng(29)
    chunks = _feature_chunks(rng, 500)
    out, calls = _serve_counted(ts, clk, lambda s: s.submit_packets, chunks)
    for got, want in calls:
        assert got == pytest.approx(want, abs=1e-6)
    st = ts.ingress.stats
    assert st["ingress_dispatch_retries_total"] > 0
    assert st["ingress_quarantined_rows_total"] > 0
    reasons = {o.reason for o in out if isinstance(o, PacketError)}
    assert "device dispatch failed — row quarantined" in reasons


def test_counters_exported_under_the_shard_label():
    clk = StepClock()
    ts, _ = _servers(clk)
    for c in _feature_chunks(np.random.default_rng(3), 200):
        ts.submit_packets(c)
    ts.drain_packets()
    snap = ts.obs.snapshot()["metrics"]
    text = ts.obs.to_prometheus_text()
    for s in STAGES:
        name = f"{s}_seconds_total"
        assert set(snap[name]) == {'shard="0"'}
        assert f"# TYPE {name} counter" in text
        assert f'{name}{{shard="0"}}' in text
    # no device, no device time
    assert "engine_batch_device_seconds_total" not in snap


def test_fabric_shards_carry_their_own_cells():
    fab = ShardedPacketServer(n_shards=2, device="cpu", max_models=4,
                              max_layers=2, max_width=WIDTH,
                              ingress_batch=64)
    rng = np.random.default_rng(4)
    fab.install(1, _weights(rng, [WIDTH, 2]), [], final_activation="sigmoid")
    for c in _feature_chunks(np.random.default_rng(6), 300):
        fab.submit_packets(c)
    fab.drain_packets()
    snap = fab.obs.snapshot()["metrics"]
    for name in ("ingress_key_seconds_total", "ingress_drain_seconds_total"):
        cells = snap[name]
        assert set(cells) == {'shard="0"', 'shard="1"'}
        assert all(v > 0 for v in cells.values())
    for sh in fab.shards:
        assert sh.pipeline.stages.depth == 0
