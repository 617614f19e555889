"""The port's sharded serving fabric against the JAX reference, on the CPU
at small sizes, with exact equality (integer codes and bytes, zero
tolerance):

  * ``rss_shard``, ``_mix64`` and the rendezvous re-homing give the
    reference's values on seeded hashes; ``shard_devices`` places shards on
    the CPU and raises for the card where there is none;
  * ``ShardedPacketServer(device="cpu")`` at 1, 2 and 3 shards serves a
    mixed raw trace (MLP + forest ids, strict Model IDs, ragged and
    malformed rows) interleaved with encapsulated chunks byte-identically
    to the reference's single-engine ``PacketServer``, with every flow's
    register row (over the union of the shards) and the fabric's count-min
    sketch equal to the reference server's;
  * the cross-shard install fence: install, respec and remove mid-window
    equal the reference's single engine, with no new serving configuration
    on any shard, and one snapshot upload per device and generation;
  * the failover drills equal the reference's ``ShardedPacketServer`` on
    the same calls (egress, error slots, migrated registers and
    ``fault_stats``): kill one of four, cascading deaths, persistent
    dispatch faults, the watchdog's stall, round robin past dead shards and
    malformed rows at admission; transient dispatch faults leave the drain
    equal to an unfaulted run.
"""

import threading

import numpy as np
import pytest
import torch

from repro.forest import compile as jcompile
from repro.launch.serve import PacketServer as JServer
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import FaultSpec as JFaultSpec
from repro.serve import ShardedPacketServer as JFabric
from repro.serve import fabric as jfabric
from repro_torch.core.ingress import PacketError
from repro_torch.core.packet import encode_packets_np
from repro_torch.data import packets as tdata
from repro_torch.flow import FlowTable
from repro_torch.forest import compile as tcompile
from repro_torch.launch.mesh import shard_devices
from repro_torch.launch.serve import PacketServer as TServer
from repro_torch.serve import FaultPlan, FaultSpec, ShardedPacketServer
from repro_torch.serve import fabric as tfabric

torch.set_num_threads(1)

FRAC = 8
WIDTH = 16
FOREVER = 1 << 60
KEY_WORDS = (tdata.RAW_KEY_BYTES + 7) // 8
SERVER_KW = dict(max_models=4, max_layers=2, max_width=WIDTH, frac_bits=FRAC,
                 ingress_batch=64, max_inflight=2, max_forests=2,
                 max_trees=3, max_nodes=31, max_tree_depth=4)


def _forest_pair(seed=25):
    X, y = tdata.anomaly_dataset(np.random.default_rng(seed), 400, WIDTH)
    kw = dict(task="classify", n_trees=3, max_depth=4, max_nodes=31,
              seed=seed + 1)
    return (tcompile.train_forest(X, y, **kw),
            jcompile.train_forest(X, y, **kw))


def _install(srv, forest=None, seed=7):
    """MLPs 1 and 2 (and forest 5 when given), each with a FeatureSpec."""
    rng = np.random.default_rng(seed)
    for mid in (1, 2):
        srv.install(mid, [
            (rng.normal(size=(WIDTH, WIDTH)).astype(np.float32) * 0.3,
             np.zeros(WIDTH, np.float32)),
            (rng.normal(size=(WIDTH, 2)).astype(np.float32) * 0.3,
             np.zeros(2, np.float32))], ["relu"], final_activation="sigmoid")
    srv.install_feature_spec(1, tuple(range(8)) * (WIDTH // 8))
    srv.install_feature_spec(2, (2, 3, 4, 5) * (WIDTH // 4))
    if forest is not None:
        srv.install_forest(5, forest)
        srv.install_feature_spec(5, (4, 5, 2, 3) * (WIDTH // 4))
    return srv


def _port_fabric(n, forest=None, **kw):
    return _install(ShardedPacketServer(n_shards=n, device="cpu",
                                        **{**SERVER_KW, **kw}), forest)


def _ref_fabric(n, forest=None, **kw):
    return _install(JFabric(n_shards=n, **{**SERVER_KW, **kw}), forest)


def _ref_plain(forest=None, **kw):
    return _install(JServer(**{**SERVER_KW, **kw}), forest)


def _port_plain(forest=None, **kw):
    return _install(TServer(device="cpu", **{**SERVER_KW, **kw}), forest)


def _trace(n, seed, n_flows=40, mids=(1,)):
    return tdata.raw_trace(np.random.default_rng(seed), n, n_flows=n_flows,
                           model_ids=mids)


def _wire(rng, n, mids=(1, 2)):
    codes = rng.integers(-2000, 2000, (n, WIDTH)).astype(np.int32)
    return encode_packets_np(rng.choice(np.asarray(mids, np.int32), n),
                             FRAC, codes)


def _egress(out):
    """Egress rows as bytes and error slots as their reasons, in order."""
    return [o.reason if hasattr(o, "reason") else np.asarray(o).tobytes()
            for o in out]


def _flow_rows(tables):
    """key bytes → register row over the union of ``tables`` (each flow
    must live in exactly one)."""
    rows = {}
    for t in tables:
        snap = t.snapshot()
        for k, r in zip(snap["keys"], snap["registers"]):
            key = np.asarray(k).tobytes()
            assert key not in rows, "a flow lives on two shards"
            rows[key] = np.asarray(r).tolist()
    return rows


def _shard_tables(fab):
    return [sh.flow.table for sh in fab.shards if sh._flow is not None]


# ---------------------------------------------------------------------------
# dispatch functions and placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_rss_shard_and_mix64_match_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    h = rng.integers(0, 2 ** 63, 4096, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 4096, dtype=np.uint64)
    h[:4] = [0, 1, 2 ** 64 - 1, 2 ** 63]
    np.testing.assert_array_equal(tfabric.rss_shard(h, n_shards),
                                  jfabric.rss_shard(h, n_shards))
    assert tfabric.rss_shard(h, n_shards).dtype == np.int64
    np.testing.assert_array_equal(tfabric._mix64(h), jfabric._mix64(h))
    with pytest.raises(ValueError):
        tfabric.rss_shard(h, 0)


@pytest.mark.parametrize("dead", [(), (1,), (0, 2), (1, 2, 3)])
def test_rendezvous_rehoming_matches_reference(dead):
    """Both fabrics re-home the same hashes onto the same survivors (their
    HRW seeds agree), and a dead shard's flows never route to it."""
    tf = ShardedPacketServer(n_shards=4, device="cpu", **SERVER_KW)
    jf = JFabric(n_shards=4, **SERVER_KW)
    np.testing.assert_array_equal(tf._hrw_seeds, jf._hrw_seeds)
    for s in dead:
        tf._alive[s] = jf._alive[s] = False
    h = np.random.default_rng(3).integers(0, 2 ** 63, 2048, dtype=np.uint64)
    got = tf._route(h.copy())
    np.testing.assert_array_equal(got, jf._route(h.copy()))
    np.testing.assert_array_equal(tf._rendezvous(h), jf._rendezvous(h))
    assert not np.isin(got, list(dead)).any()


def test_shard_devices_on_the_cpu():
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        shard_devices(0, "cpu")
    fab = ShardedPacketServer(n_shards=2, device="cpu", **SERVER_KW)
    assert all(sh.device == torch.device("cpu")
               and sh.engine.device == torch.device("cpu")
               for sh in fab.shards)


def test_shard_devices_and_fabric_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        shard_devices(2)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedPacketServer(n_shards=2)


def test_dispatch_and_flow_affinity_match_reference():
    """``dispatch_shards`` equals the reference's, every packet of a flow
    routes to one shard, and after serving each shard's table holds exactly
    its routed flows."""
    raw = _trace(1500, 1, n_flows=48)
    tf, jf = _port_fabric(4), _ref_fabric(4)
    d = tf.dispatch_shards(raw)
    np.testing.assert_array_equal(d, jf.dispatch_shards(raw))
    keys = [bytes(k) for k in tdata.parse_raw_headers(raw).key_bytes]
    per = [set() for _ in range(4)]
    for k, s in zip(keys, d.tolist()):
        per[s].add(k)
    assert sum(len(p) for p in per) == 48
    tf.submit_raw(raw)
    tf.drain_packets()
    for sh, flows in zip(tf.shards, per):
        assert len(sh.flow.table) == len(flows)


# ---------------------------------------------------------------------------
# egress against the reference's single engine
# ---------------------------------------------------------------------------


def _mixed_run(srv, chunks, wires):
    """Raw chunks with an encapsulated wire chunk after every third."""
    for i, chunk in enumerate(chunks):
        srv.submit_raw(chunk)
        if i % 3 == 2 and wires:
            srv.submit_packets(wires.pop(0))
    return srv.drain_packets()


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_fabric_egress_matches_reference_single_engine(n_shards):
    """Mixed MLP + forest raw trace, strict Model IDs (flows steered to the
    uninstalled id 9), ragged chunks and one malformed row, interleaved with
    wire chunks: egress and error slots equal the reference's single-engine
    ``PacketServer``; so do every flow's registers and the sketch."""
    tforest, jforest = _forest_pair()
    tf = _port_fabric(n_shards, tforest, strict_model_ids=True)
    js = _ref_plain(jforest, strict_model_ids=True)
    rng = np.random.default_rng(30)
    raw = tdata.raw_trace(rng, 1600, n_flows=48, model_ids=(1, 5, 2, 9),
                          pattern="mixed", burst_gap=2000)
    cuts = np.unique(np.cumsum(rng.integers(1, 300, 12)))
    chunks = np.split(raw, cuts[cuts < raw.shape[0]])
    chunks.insert(2, [raw[0], raw[1][:9], raw[2]])  # a ragged raw batch
    wires = [_wire(rng, n, (1, 2, 5)) for n in (40, 70, 25)]
    got = _mixed_run(tf, chunks, list(wires))
    want = _mixed_run(js, chunks, list(wires))
    assert _egress(got) == _egress(want)
    n_err = sum(isinstance(o, PacketError) for o in got)
    assert 0 < n_err < len(got)
    assert _flow_rows(_shard_tables(tf)) == _flow_rows([js.flow.table])
    np.testing.assert_array_equal(tf.cms, js.flow.cms)
    lanes = [sh.pipeline.stats["lane_batches"] for sh in tf.shards]
    assert sum(lb["forest"] for lb in lanes) > 0
    assert sum(lb["mlp"] for lb in lanes) > 0


def test_shard_sketches_stay_their_own():
    """Each shard's flow kernel updates its own sketch; only the feature
    lane takes the fabric's estimates.  The fabric's sketch is the single
    engine's, and the shards' sketches sum to it cell for cell (the
    increments commute and nothing saturates here)."""
    tf = _port_fabric(3)
    tp = _port_plain()
    raw = _trace(1200, 31, n_flows=40)
    for srv in (tf, tp):
        srv.submit_raw(raw)
    assert _egress(tf.drain_packets()) == _egress(tp.drain_packets())
    np.testing.assert_array_equal(tf.cms, tp.flow.cms)
    shard_cms = [sh.flow.cms for sh in tf.shards]
    assert not any(np.array_equal(c, tf.cms) for c in shard_cms)
    np.testing.assert_array_equal(sum(c.astype(np.int64)
                                      for c in shard_cms), tf.cms)


# ---------------------------------------------------------------------------
# the cross-shard install fence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4])
def test_install_remove_respec_fence_no_new_configuration(n_shards):
    """Weight reinstall, FeatureSpec remap and remove() between arrival
    batches: every packet's egress equals the reference's single engine
    running the same sequence, and no shard adds a serving
    configuration after its warm-up."""
    phases = [_trace(250, 50 + i, n_flows=20) for i in range(4)]
    wrng = np.random.default_rng(11)
    swap = [(wrng.normal(size=(WIDTH, WIDTH)).astype(np.float32) * 0.25,
             np.zeros(WIDTH, np.float32)),
            (wrng.normal(size=(WIDTH, 2)).astype(np.float32) * 0.25,
             np.zeros(2, np.float32))]
    respec = [7 - i % 8 for i in range(WIDTH)]

    def run(srv, flush, engines):
        srv.submit_raw(_trace(200, 9, n_flows=20))  # warm-up window
        srv.drain_packets()
        tc0 = [e.trace_count for e in engines]
        srv.submit_raw(phases[0])
        flush()
        srv.install(1, swap, ["relu"], final_activation="sigmoid")
        srv.submit_raw(phases[1])
        flush()
        srv.install_feature_spec(1, respec)
        srv.submit_raw(phases[2])
        flush()
        srv.remove(1)
        srv.submit_raw(phases[3])
        out = srv.drain_packets()
        return out, tc0, [e.trace_count for e in engines]

    js = _ref_plain()
    want, _, _ = run(js, js.ingress.flush, [js.engine])
    tf = _port_fabric(n_shards)

    def flush():
        for sh in tf.shards:
            sh.pipeline.flush()

    got, tc0, tc1 = run(tf, flush, [sh.engine for sh in tf.shards])
    assert tc1 == tc0
    assert _egress(got) == _egress(want)


def test_one_generation_one_snapshot_per_device():
    """One shared control plane: an install bumps the one version every
    shard reads, and shards on one device share one snapshot per table
    generation."""
    tf = _port_fabric(4)
    cp = tf.control_plane
    assert all(sh.pipeline.cp is cp and sh.engine.cp is cp
               for sh in tf.shards)
    tf.submit_raw(_trace(600, 12, n_flows=32))
    tf.drain_packets()
    assert set(cp._snapshot) == {torch.device("cpu")}
    v0, tables0 = cp.version, cp.tables("cpu")
    rng = np.random.default_rng(6)
    tf.install(3, [(rng.normal(size=(WIDTH, 2)).astype(np.float32),
                    np.zeros(2, np.float32))], [])
    assert cp.version == v0 + 1
    tf.submit_raw(_trace(600, 13, n_flows=32))
    tf.drain_packets()
    assert set(cp._snapshot) == {torch.device("cpu")}
    assert cp.tables("cpu") is not tables0


# ---------------------------------------------------------------------------
# failover drills against the reference's fabric
# ---------------------------------------------------------------------------


def _fault_dict(fab):
    return fab.fault_stats.as_dict()


def _assert_per_shard_tables_equal(tf, jf):
    for ts, js in zip(tf.shards, jf.shards):
        assert (ts._flow is None) == (js._flow is None)
        if ts._flow is None:
            continue
        tsnap, jsnap = ts.flow.table.snapshot(), js.flow.table.snapshot()
        np.testing.assert_array_equal(tsnap["keys"], jsnap["keys"])
        np.testing.assert_array_equal(tsnap["registers"],
                                      jsnap["registers"])
        assert tsnap["generation"] == jsnap["generation"]


def test_kill_one_of_four_matches_reference_fabric():
    """4 shards, kill shard 1 mid-window: every ticket resolves, egress,
    migrated registers and ``fault_stats`` equal the reference fabric's,
    and the survivors add no serving configuration."""
    tf, jf = _port_fabric(4), _ref_fabric(4)
    oracle = _port_plain()
    raws = [_trace(300, s) for s in range(5)]
    for srv in (tf, jf, oracle):
        srv.submit_raw(raws[0])
    warm = [_egress(s.drain_packets()) for s in (tf, jf, oracle)]
    assert warm[0] == warm[1] == warm[2]
    tc0 = [sh.engine.trace_count for sh in tf.shards]
    before = None
    for srv in (tf, jf, oracle):
        for i, r in enumerate(raws[1:], 1):
            srv.submit_raw(r)
            if i == 2 and srv is not oracle:
                if srv is tf:
                    before = _flow_rows([tf.shards[1].flow.table])
                assert srv.kill_shard(1, "drill") is True
    got, jgot, want = (s.drain_packets() for s in (tf, jf, oracle))
    assert len(got) == 1200
    assert _egress(got) == _egress(jgot) == _egress(want)
    assert not any(isinstance(o, PacketError) for o in got)
    assert _fault_dict(tf) == _fault_dict(jf)
    assert _fault_dict(tf)["fabric_migrated_flows_total"] == len(before) > 0
    assert tf.alive_shards == jf.alive_shards == [0, 2, 3]
    _assert_per_shard_tables_equal(tf, jf)
    assert [sh.engine.trace_count for sh in tf.shards] == tc0
    # the next window (every flow re-homed) still matches the oracle
    r2 = _trace(300, 99)
    for srv in (tf, oracle):
        srv.submit_raw(r2)
    assert _egress(tf.drain_packets()) == _egress(oracle.drain_packets())


def test_migrated_rows_equal_the_dead_shards_registers():
    """The rows a survivor adopts are the dead shard's registers as its
    last ``submit_raw`` left them, including flows that batch touched."""
    tf = _port_fabric(4)
    raws = [_trace(400, 70 + s, n_flows=32) for s in range(2)]
    tf.submit_raw(raws[0])
    tf.submit_raw(raws[1])  # the batch just before the kill
    dead = _flow_rows([tf.shards[2].flow.table])
    touched = {bytes(k) for k, s in zip(
        tdata.parse_raw_headers(raws[1]).key_bytes,
        tf.dispatch_shards(raws[1]).tolist()) if s == 2}
    assert touched
    survivors = {s: _flow_rows([tf.shards[s].flow.table])
                 for s in (0, 1, 3)}
    assert tf.kill_shard(2) is True
    after = _flow_rows([tf.shards[s].flow.table for s in (0, 1, 3)])
    for key, row in dead.items():
        assert after[key] == row
    for rows in survivors.values():
        for key, row in rows.items():
            assert after[key] == row
    words, hashes = FlowTable.pack_keys(
        np.frombuffer(b"".join(touched), np.uint8).reshape(
            -1, tdata.RAW_KEY_BYTES), KEY_WORDS)
    dest = tf._rendezvous(hashes)
    for w, s in zip(words, dest.tolist()):
        assert tf.shards[s].flow.table.snapshot()["keys"].tolist().count(
            w.tolist()) == 1
    tf.drain_packets()


def test_cascading_deaths_down_to_the_last_shard():
    tf, jf = _port_fabric(4), _ref_fabric(4)
    oracle = _port_plain()
    r, r2 = _trace(200, 42), _trace(200, 43)
    for srv in (tf, jf, oracle):
        srv.submit_raw(r)
    outs = [_egress(s.drain_packets()) for s in (tf, jf, oracle)]
    assert outs[0] == outs[1] == outs[2]
    for fab in (tf, jf):
        assert fab.kill_shard(0) and fab.kill_shard(2) and fab.kill_shard(3)
        assert fab.kill_shard(1) is False  # the last shard refuses to die
        assert fab.alive_shards == [1]
    for srv in (tf, jf, oracle):
        srv.submit_raw(r2)
    outs = [_egress(s.drain_packets()) for s in (tf, jf, oracle)]
    assert outs[0] == outs[1] == outs[2]
    assert _fault_dict(tf) == _fault_dict(jf)


def test_persistent_dispatch_faults_kill_the_shard():
    """A shard whose batches all fail is killed by the supervisor; its
    error slots, the survivors' rows and ``fault_stats`` equal the
    reference fabric's, and the next window is clean."""
    outs = []
    for fab, plan in ((_port_fabric(2, max_consecutive_failures=2),
                       FaultPlan([FaultSpec(site="dispatch", shard=0,
                                            count=FOREVER)])),
                      (_ref_fabric(2, max_consecutive_failures=2),
                       JFaultPlan([JFaultSpec(site="dispatch", shard=0,
                                              count=FOREVER)]))):
        plan.install(fab)
        for s in range(6):
            fab.submit_raw(_trace(200, 50 + s, n_flows=16))
        out = fab.drain_packets()
        fab.submit_raw(_trace(200, 77, n_flows=16))
        outs.append((_egress(out), _egress(fab.drain_packets()),
                     _fault_dict(fab), fab.alive_shards))
    assert outs[0] == outs[1]
    first, nxt, faults, alive = outs[0]
    assert len(first) == 1200 and alive == [1]
    assert faults["fabric_deaths_total"] == 1
    n_err = sum(isinstance(o, str) for o in first)
    assert 0 < n_err < 1200
    assert not any(isinstance(o, str) for o in nxt)


def test_watchdog_stall_kills_the_shard():
    """The watchdog times each shard's host submit: the ``"stall"`` site
    sleeps inside it, so strikes accumulate and the shard dies."""
    fab = _port_fabric(2, watchdog_timeout=0.01, max_consecutive_failures=2,
                       ingress_batch=32)
    FaultPlan([FaultSpec(site="stall", shard=0, latency=0.05,
                         count=FOREVER)]).install(fab)
    for s in range(8):
        fab.submit_raw(_trace(120, 60 + s, n_flows=8))
    out = fab.drain_packets()
    assert len(out) == 960
    assert fab.fault_stats["fabric_watchdog_strikes_total"] >= 2
    assert fab.fault_stats["fabric_deaths_total"] == 1
    assert fab.alive_shards == [1]
    assert fab.obs.events.records(kind="shard_killed")


def test_round_robin_skips_dead_shards():
    tf = _port_fabric(3)
    rng = np.random.default_rng(6)
    tf.kill_shard(1)
    wires = [_wire(rng, 8) for _ in range(6)]
    for w in wires:
        tf.submit_packets(w)
    out = tf.drain_packets()
    assert len(out) == 48
    assert not any(isinstance(o, PacketError) for o in out)
    assert tf.shards[1].pipeline.stats["ingress_packets_total"] == 0
    oracle = _port_plain()
    for w in wires:
        oracle.submit_packets(w)
    assert _egress(out) == _egress(oracle.drain_packets())


def test_fabric_admission_rejects_malformed_rows():
    tf, jf = _port_fabric(2), _ref_fabric(2)
    raw = _trace(50, 5)
    rag = [row for row in raw]
    rag[7] = rag[7][:10]
    outs = []
    for fab in (tf, jf):
        fab.submit_raw(rag)
        outs.append(_egress(fab.drain_packets()))
    assert outs[0] == outs[1]
    assert "malformed raw header" in outs[0][7]
    assert sum(isinstance(o, str) for o in outs[0]) == 1
    assert tf.fault_stats["fabric_rejected_rows_total"] == 1


def test_transient_dispatch_faults_are_invisible():
    """Every fifth dispatch fails once and is retried: the drain equals an
    unfaulted fabric's and every shard retried."""
    clean, faulted = _port_fabric(4), _port_fabric(4)
    FaultPlan([FaultSpec(site="dispatch", every=5, count=FOREVER)],
              seed=3).install(faulted)
    raws = [_trace(400, 80 + s, n_flows=48) for s in range(4)]
    outs = []
    for fab in (clean, faulted):
        for r in raws:
            fab.submit_raw(r)
        outs.append(_egress(fab.drain_packets()))
    assert outs[0] == outs[1]
    assert not any(isinstance(o, str) for o in outs[1])
    assert all(sh.pipeline.stats["ingress_dispatch_retries_total"] > 0
               for sh in faulted.shards)


def test_stats_shape_and_lock_free_read():
    tf = _port_fabric(2)
    tf.submit_raw(_trace(300, 3))
    tf.submit_packets(_wire(np.random.default_rng(1), 20))
    tf.drain_packets()
    st = tf.stats()
    assert st["n_shards"] == 2 and st["alive_shards"] == [0, 1]
    assert st["flows"] == sum(d.get("flows", 0) for d in st["shards"])
    assert sum(d["packets"] for d in st["shards"]) == 320
    assert st["faults"]["fabric_deaths_total"] == 0
    with tf._lock:  # another thread holding the fence cannot stall stats()
        res = []
        t = threading.Thread(target=lambda: res.append(tf.stats()))
        t.start()
        t.join(5.0)
        assert res and not t.is_alive()
