"""The port's raw-packet flow engine against the JAX reference, on the CPU at
small sizes, with exact equality (integer codes, zero tolerance):

  * the flow update: the port's oracle, its numpy rank-round lowering
    (``flow_update_gather``, ``ops.flow_update(backend="auto")``) and its
    plain PyTorch version ``ref.flow_update_ref`` are equal to
    ``repro.kernels.ref.flow_update_numpy`` and ``repro.kernels.
    flow_update.flow_update_gather`` (the reference's Pallas kernel does not
    run on the installed JAX, ROADMAP R1, so it is never called);
  * the raw header codec and ``raw_trace`` give the reference's bytes;
  * ``FlowTable`` gives the reference's slots, ``is_new``, ranks, stats and
    register files on the same key stream, through expiry, eviction and
    overflow rejection, and snapshots move between the two packages;
  * the FeatureSpec family behaves as the reference's;
  * ``PacketServer(device="cpu").submit_raw`` egress (rows and error slots)
    is byte-identical to the reference's on ragged MLP + forest traces with
    strict Model IDs, a mid-trace spec reinstall and a flow-table overflow;
    ``serve_raw_fused`` equals the reference's staged path; a frontend
    restored from a reference snapshot continues identically.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.control_plane import ControlPlane as JCP
from repro.data import packets as jdata
from repro.flow import FlowParams as JParams
from repro.flow import FlowTable as JTable
from repro.flow import reference_features as j_reference_features
from repro.forest import compile as jcompile
from repro.kernels import fused_serve as jfs
from repro.kernels import ref as jref
from repro.kernels.flow_update import (_rank_within_groups as j_rank,
                                       cms_estimate_update as j_cms_update,
                                       flow_update_gather as j_gather)
from repro.launch.serve import PacketServer as JServer
from repro_torch.core.control_plane import ControlPlane as TCP
from repro_torch.core.control_plane import FeatureSpec
from repro_torch.core.ingress import PacketError
from repro_torch.core.packet import HEADER_BYTES
from repro_torch.data import packets as tdata
from repro_torch.flow import FlowFrontend, FlowParams, FlowTable
from repro_torch.flow import reference_features
from repro_torch.forest import compile as tcompile
from repro_torch.kernels import flow_update as tfu
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_serve import spec_take
from repro_torch.launch.serve import PacketServer as TServer

torch.set_num_threads(1)

FRAC = 8
KW = dict(frac=FRAC, ewma_shift=3, byte_shift=6, dur_shift=10)
WIDTH = 8
FMAX = tref.FLOW_CODE_MAX


# ---------------------------------------------------------------------------
# the flow update: oracle, numpy lowering, plain PyTorch version
# ---------------------------------------------------------------------------


def _random_batch(rng, n, n_slots, cms_shape=(2, 64), monotone_ts=True):
    """The reference tests' recipe: a partially pre-populated state."""
    state = np.zeros((n_slots, tref.N_FLOW_REGISTERS), np.int32)
    pre = rng.integers(0, n_slots + 1)
    if pre:
        state[:pre] = rng.integers(0, 5000, (pre, tref.N_FLOW_REGISTERS))
        state[:pre, tref.REG_PKT_COUNT] = rng.integers(0, 5, pre)
    cms = rng.integers(0, 100, cms_shape).astype(np.int32)
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    cells = rng.integers(0, cms_shape[1], (n, cms_shape[0])).astype(np.int32)
    if monotone_ts:
        ts = np.cumsum(rng.integers(0, 100, n)).astype(np.int32)
    else:
        ts = rng.integers(0, 10 ** 6, n).astype(np.int32)
    length = rng.integers(0, 2000, n).astype(np.int32)
    live = (rng.random(n) > 0.15).astype(np.int32)
    return state, cms, slots, cells, ts, length, live


def _saturation_batch():
    """The reference's ``test_saturation_never_wraps`` inputs."""
    state = np.zeros((1, tref.N_FLOW_REGISTERS), np.int32)
    state[0] = [FMAX - 1, FMAX - 1, 0, 0, FMAX, FMAX, 1, FMAX >> FRAC]
    cms = np.full((1, 4), FMAX, np.int32)
    return (state, cms, np.zeros(3, np.int32), np.zeros((3, 1), np.int32),
            np.full(3, 2 ** 31 - 1, np.int32), np.full(3, 65535, np.int32),
            np.ones(3, np.int32))


def _assert_all_equal(args):
    """Every realization of the port against the reference's oracle and
    its numpy lowering, on the same inputs."""
    want = jref.flow_update_numpy(*args, **KW)
    got = {
        "ref gather": j_gather(*args, **KW),
        "oracle": tref.flow_update_numpy(*args, **KW),
        "gather": tfu.flow_update_gather(*args, **KW),
        "ops auto": tops.flow_update(*args, backend="auto", **KW),
        "ops ref": tops.flow_update(*args, backend="ref", **KW),
        "torch": tref.flow_update_ref(
            *(torch.as_tensor(a) for a in args), **KW),
        "wrapper (CPU tensors)": tfu.flow_update_kernel(
            *(torch.as_tensor(a) for a in args), **KW),
    }
    for name, out in got.items():
        for field, a, b in zip(("state", "cms", "features"), want, out):
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            assert b.dtype == np.int32, (name, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: {field}")


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6),
       n_slots=st.integers(min_value=1, max_value=40),
       monotone=st.sampled_from([True, False]))
def test_flow_update_property_all_realizations_equal(seed, n_slots, monotone):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 150))
    _assert_all_equal(_random_batch(rng, n, n_slots, monotone_ts=monotone))


@pytest.mark.parametrize("case", ["fixed", "heavy_duplication", "dead_rows",
                                  "one_flow", "distinct_flows", "saturation",
                                  "deep_sketch"])
def test_flow_update_fixed_cases(case):
    rng = np.random.default_rng(0)
    if case == "fixed":
        args = _random_batch(rng, 300, 24)
    elif case == "heavy_duplication":  # chains in batch order
        args = _random_batch(rng, 200, 3)
    elif case == "dead_rows":
        args = list(_random_batch(rng, 50, 8))
        args[6][:] = 0
    elif case == "one_flow":
        args = list(_random_batch(rng, 257, 16, monotone_ts=False))
        args[2][:] = 5
    elif case == "distinct_flows":
        args = list(_random_batch(rng, 64, 64))
        args[2] = rng.permutation(64).astype(np.int32)
    elif case == "deep_sketch":
        args = _random_batch(rng, 120, 10, cms_shape=(8, 16))
    else:
        args = _saturation_batch()
    _assert_all_equal(tuple(args))
    if case == "dead_rows":
        s2, c2, f2 = tops.flow_update(*args, **KW)
        np.testing.assert_array_equal(s2, args[0])
        np.testing.assert_array_equal(c2, args[1])
        assert not f2.any()


def test_flow_update_empty_batch_and_in_place():
    state = np.arange(64, dtype=np.int32).reshape(8, 8)
    cms = np.zeros((2, 16), np.int32)
    z = np.zeros(0, np.int32)
    args = (state, cms, z, np.zeros((0, 2), np.int32), z, z, z)
    for backend in ("auto", "ref"):
        s2, c2, f2 = tops.flow_update(*args, backend=backend, **KW)
        np.testing.assert_array_equal(s2, state)
        np.testing.assert_array_equal(c2, cms)
        assert f2.shape == (0, tref.N_FLOW_FEATURES)
    s2, c2, f2 = tfu.flow_update_kernel(*(torch.as_tensor(a) for a in args),
                                        **KW)
    assert torch.equal(s2, torch.as_tensor(state)) and f2.shape == (0, 8)
    # copy=False updates the caller's register file in place, as the
    # reference's lowering does
    rng = np.random.default_rng(4)
    args = _random_batch(rng, 40, 6)
    want = jref.flow_update_numpy(*args, **KW)
    st_, cm_ = args[0].copy(), args[1].copy()
    out = tops.flow_update(st_, cm_, *args[2:], copy=False, **KW)
    assert out[0] is st_ and out[1] is cm_
    np.testing.assert_array_equal(st_, want[0])
    np.testing.assert_array_equal(cm_, want[1])


def test_flow_update_kernel_backend_needs_the_card():
    args = _random_batch(np.random.default_rng(5), 10, 4)
    with pytest.raises(ValueError, match="card"):
        tops.flow_update(*args, backend="kernel", **KW)
    with pytest.raises(ValueError, match="card"):
        tops.flow_update(*(torch.as_tensor(a) for a in args),
                         backend="kernel", **KW)
    with pytest.raises(ValueError, match="backend"):
        tops.flow_update(*args, backend="pallas", **KW)


def test_cms_closed_form_and_ranks_match_reference():
    rng = np.random.default_rng(6)
    cms = rng.integers(0, FMAX, (3, 32)).astype(np.int32)
    cms[0, :4] = FMAX - 2
    cells = rng.integers(0, 32, (500, 3)).astype(np.int32)
    a, b = cms.copy(), cms.copy()
    np.testing.assert_array_equal(tfu.cms_estimate_update(a, cells),
                                  j_cms_update(b, cells))
    np.testing.assert_array_equal(a, b)
    keys = rng.integers(0, 7, 300)
    np.testing.assert_array_equal(tfu._rank_within_groups(keys, 7),
                                  j_rank(keys, 7))


@pytest.mark.parametrize("shift", [0, 1, 3, 30])
def test_rounding_shift_and_sat_shl_match_reference(shift):
    x = np.asarray([-FMAX, -5, -4, -3, -1, 0, 1, 3, 4, 5, FMAX], np.int64)
    np.testing.assert_array_equal(tref.rounding_rshift_np(x, shift),
                                  jref.rounding_rshift_np(x, shift))
    np.testing.assert_array_equal(
        tref.rounding_rshift(torch.as_tensor(x, dtype=torch.int32),
                             shift).numpy(),
        jref.rounding_rshift_np(x, shift))
    v = np.asarray([-7, 0, 1, FMAX >> shift, (FMAX >> shift) + 1, FMAX],
                   np.int64)
    np.testing.assert_array_equal(tref.sat_shl_np(v, shift),
                                  jref.sat_shl_np(v, shift))
    assert tref.FLOW_FEATURE_NAMES == jref.FLOW_FEATURE_NAMES
    assert tref.FLOW_CODE_MAX == jref.FLOW_CODE_MAX


# ---------------------------------------------------------------------------
# raw header codec and traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_flows=16, model_ids=(1, 2), pattern="mixed"),
    dict(n_flows=7, model_ids=(3,), pattern="periodic", jitter=5),
    dict(n_flows=33, model_ids=(1, 2, 9), pattern="bursty",
         fixed_length=False),
    dict(n_flows=64, model_ids=tuple(range(1, 17)) + (999,),
         pattern="mixed", burst_len=4, burst_gap=3000),
])
def test_raw_trace_and_codec_match_reference(kw):
    raw = tdata.raw_trace(np.random.default_rng(7), 900, **kw)
    np.testing.assert_array_equal(
        raw, jdata.raw_trace(np.random.default_rng(7), 900, **kw))
    tf, jf = tdata.parse_raw_headers(raw), jdata.parse_raw_headers(raw)
    for name in ("key_bytes", "model_id", "ts", "length"):
        a, b = getattr(tf, name), getattr(jf, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        reference_features(raw, FlowParams(frac=FRAC)),
        j_reference_features(raw, JParams(frac=FRAC)))


def test_encode_and_validate_raw_rows_match_reference():
    rng = np.random.default_rng(8)
    n = 60
    f = dict(src_ip=rng.integers(0, 2 ** 32, n),
             dst_ip=rng.integers(0, 2 ** 32, n),
             src_port=rng.integers(0, 2 ** 16, n),
             dst_port=rng.integers(0, 2 ** 16, n),
             proto=rng.integers(0, 256, n),
             model_id=rng.integers(0, 5, n),
             ts=rng.integers(0, 2 ** 31, n),
             length=rng.integers(0, 2 ** 16, n))
    raw = tdata.encode_raw_headers(**f)
    np.testing.assert_array_equal(raw, jdata.encode_raw_headers(**f))
    ragged = [raw[0], raw[1][:10], raw[2], np.zeros(30, np.uint8),
              raw[3], raw[4]]
    cases = [(raw, None), (raw, {1, 2}), (raw[:, :20], None),
             (ragged, None), (ragged, {0, 1, 2, 3})]
    for rows, known in cases:
        got = tdata.validate_raw_rows(rows, known_model_ids=known)
        want = jdata.validate_raw_rows(rows, known_model_ids=known)
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.tolist() == b.tolist()
    with pytest.raises(ValueError, match="raw header"):
        tdata.parse_raw_headers(np.zeros((2, 22), np.uint8))


# ---------------------------------------------------------------------------
# FlowTable
# ---------------------------------------------------------------------------


def _table_stats(t):
    return {k: t.stats[k] for k in (
        "flow_lookups_total", "flow_hits_total", "flow_created_total",
        "flow_expiries_total", "flow_evictions_total", "flow_flushes_total",
        "flow_compactions_total", "flow_rejects_total", "flow_adopted_total")}


def _assert_same_table(tt, jt):
    assert len(tt) == len(jt) and tt.generation == jt.generation
    np.testing.assert_array_equal(tt.registers, jt.registers)
    np.testing.assert_array_equal(tt._keys, jt._keys)
    np.testing.assert_array_equal(tt._slot_state, jt._slot_state)
    assert _table_stats(tt) == _table_stats(jt)


@pytest.mark.parametrize("kw", [
    dict(capacity_pow2=6, idle_timeout=500),
    dict(capacity_pow2=6, load_limit=0.5),
    dict(capacity_pow2=5, idle_timeout=2000, tombstone_limit=0.1),
])
def test_flow_table_matches_reference_on_one_key_stream(kw):
    """Hits, in-batch duplicates, expiry (sweep and in place), compaction,
    wholesale eviction and per-flow overflow rejection, batch by batch."""
    rng = np.random.default_rng(9)
    tt, jt = FlowTable(2, **kw), JTable(2, **kw)
    pool = rng.integers(0, 256, (90, 13)).astype(np.uint8)
    now = 0
    for b in range(30):
        n = int(rng.integers(1, 60)) if b != 7 else 80  # b=7 overflows
        pick = rng.integers(0, pool.shape[0], n)
        now += int(rng.integers(1, 1500))
        ts = now + rng.integers(0, 50, n)
        w, h = FlowTable.pack_keys(pool[pick], 2)
        jw, jh = JTable.pack_keys(pool[pick], 2)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(h, jh)
        got = tt.lookup_or_insert(w, h, ts, want_rank=True)
        want = jt.lookup_or_insert(jw, jh, ts, want_rank=True)
        for a, c in zip(got, want):
            np.testing.assert_array_equal(a, c)
        # the kernel's part: every served flow now has state
        for t in (tt, jt):
            served = got[0][got[0] >= 0]
            t.registers[served, tref.REG_PKT_COUNT] += 1
            t.registers[served, tref.REG_LAST_TS] = now
        if b % 10 == 9:
            assert tt.expire(now + 700) == jt.expire(now + 700)
        _assert_same_table(tt, jt)
    stats = _table_stats(tt)
    assert stats["flow_rejects_total"] > 0
    assert stats["flow_flushes_total"] + stats["flow_expiries_total"] > 0


def test_flow_table_snapshots_cross_packages():
    rng = np.random.default_rng(10)
    pool = rng.integers(0, 256, (40, 13)).astype(np.uint8)
    tt, jt = FlowTable(2, capacity_pow2=7), JTable(2, capacity_pow2=7)
    w, h = FlowTable.pack_keys(pool, 2)
    for t in (tt, jt):
        slots, _ = t.lookup_or_insert(w, h, np.zeros(40))
        t.registers[slots] = rng.integers(0, 1000, (40, 8))
    # reference → port and port → reference
    t2, j2 = FlowTable(2, capacity_pow2=7), JTable(2, capacity_pow2=7)
    t2.restore(jt.snapshot())
    j2.restore(tt.snapshot())
    for t in (t2, j2):
        slots, is_new = t.lookup_or_insert(w, h, np.ones(40))
        assert not is_new.any()
    s_t, _ = t2.lookup_or_insert(w, h, np.ones(40))
    s_j, _ = jt.lookup_or_insert(w, h, np.ones(40))
    np.testing.assert_array_equal(t2.registers[s_t], jt.registers[s_j])
    s_j2, _ = j2.lookup_or_insert(w, h, np.ones(40))
    s_tt, _ = tt.lookup_or_insert(w, h, np.ones(40))
    np.testing.assert_array_equal(j2.registers[s_j2], tt.registers[s_tt])
    # adopt lands foreign rows bit-exact in both
    t3, j3 = FlowTable(2, capacity_pow2=7), JTable(2, capacity_pow2=7)
    regs = rng.integers(0, 99, (40, 8)).astype(np.int32)
    assert t3.adopt(w, h, regs) == j3.adopt(w, h, regs) == 40
    _assert_same_table(t3, j3)
    with pytest.raises(ValueError, match="words"):
        FlowTable(3).restore(jt.snapshot())


# ---------------------------------------------------------------------------
# FeatureSpec control-plane family
# ---------------------------------------------------------------------------


def test_feature_spec_family_matches_reference():
    kw = dict(max_models=4, max_layers=2, max_width=8, frac_bits=FRAC)
    tcp, jcp = TCP(**kw), JCP(**kw)
    for bad, match in (((), "at least one column"),
                       ((0, tref.N_FLOW_FEATURES), "feature lanes"),
                       (tuple(range(8)) + (0,), "input lanes")):
        for cp in (tcp, jcp):
            with pytest.raises(ValueError, match=match):
                cp.install_feature_spec(1, bad)
    with pytest.raises(ValueError, match="16-bit"):
        tcp.install_feature_spec(70000, (1,))
    mids = np.asarray([3, 2, 9, 1, 2], np.int64)

    def same(width=8):
        a, b = tcp.feature_spec_rows(mids, width), \
            jcp.feature_spec_rows(mids, width)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert tcp.version == jcp.version

    same()  # identity rows for ids without a spec
    rng = np.random.default_rng(11)
    w = rng.normal(size=(8, 2)).astype(np.float32)
    for cp in (tcp, jcp):
        cp.install_feature_spec(2, (7, 0, 3))
        cp.install_feature_spec(9, (1,) * 8)
        cp.install(1, [(w, np.zeros(2, np.float32))], [])
        cp.install_feature_spec(1, (4, 5))
    same()
    same(width=12)
    same(width=3)
    for cp in (tcp, jcp):
        cp.install_feature_spec(2, (1, 1))   # hot swap
        cp.remove(1)                         # the spec outlives the model
        cp.remove_feature_spec(9)            # back to the identity row
        cp.remove_feature_spec(5)            # no-op
    same()
    assert tcp.feature_spec(1) == FeatureSpec(columns=(4, 5))
    assert tcp.feature_spec(9) is None
    assert tcp.feature_spec(2).columns == jcp.feature_spec(2).columns


def test_spec_take_matches_reference():
    rng = np.random.default_rng(12)
    feats = rng.integers(0, FMAX, (50, tref.N_FLOW_FEATURES)).astype(np.int32)
    cols = rng.integers(-1, tref.N_FLOW_FEATURES, (50, WIDTH)).astype(
        np.int32)
    want = np.asarray(jfs.spec_take(jnp.asarray(feats), jnp.asarray(cols)))
    got = spec_take(torch.as_tensor(feats), torch.as_tensor(cols)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the whole slice: PacketServer.submit_raw against the reference's
# ---------------------------------------------------------------------------


def _forest_pair(seed, task="classify"):
    data = tdata.anomaly_dataset if task == "classify" else tdata.qos_dataset
    X, y = data(np.random.default_rng(seed), 400, WIDTH)
    kw = dict(task=task, n_trees=3, max_depth=4, max_nodes=31, seed=seed + 1)
    return (tcompile.train_forest(X, y, **kw),
            jcompile.train_forest(X, y, **kw))


def _servers(forests=True, **extra):
    kw = dict(max_models=4, max_layers=2, max_width=WIDTH, frac_bits=FRAC,
              ingress_batch=64, max_forests=2, max_trees=3, max_nodes=31,
              max_tree_depth=4, **extra)
    servers = [TServer(device="cpu", **kw), JServer(**kw)]
    rng = np.random.default_rng(13)
    for mid in (1, 2):
        layers = [(rng.normal(size=(WIDTH, WIDTH)).astype(np.float32) * 0.3,
                   np.zeros(WIDTH, np.float32)),
                  (rng.normal(size=(WIDTH, 2)).astype(np.float32) * 0.3,
                   np.zeros(2, np.float32))]
        for s in servers:
            s.install(mid, layers, ["relu"], final_activation="sigmoid")
    if forests:
        for mid, task in ((5, "classify"), (6, "regress")):
            pair = _forest_pair(20 + mid, task)
            servers[0].install_forest(mid, pair[0])
            servers[1].install_forest(mid, pair[1])
    for s in servers:
        s.install_feature_spec(1, (2, 3, 4, 5))
        s.install_feature_spec(2, (0, 7, 1, 6, 2, 3, 4, 5))
        if forests:
            s.install_feature_spec(5, (4, 5, 2, 3) * 2)
            s.install_feature_spec(6, (0, 7, 1))
    return servers


def _ragged(raw, rng, hi=300):
    cuts = np.unique(np.cumsum(rng.integers(1, hi, raw.shape[0] // 8)))
    return np.split(raw, cuts[cuts < raw.shape[0]])


def _egress(out):
    """Egress rows and error slots in submission order, as comparable
    values (the reason strings included)."""
    return [o.reason if isinstance(o, PacketError) or hasattr(o, "reason")
            else np.asarray(o).tobytes() for o in out]


def _assert_same_flow_state(tsrv, jsrv):
    np.testing.assert_array_equal(tsrv.flow.table.registers,
                                  jsrv.flow.table.registers)
    np.testing.assert_array_equal(tsrv.flow.cms, jsrv.flow.cms)
    assert _table_stats(tsrv.flow.table) == _table_stats(jsrv.flow.table)


def test_submit_raw_matches_reference_mixed_strict_with_spec_swap():
    """MLP and forest ids over one shared flow table, strict admission
    (one flow in five steered to the uninstalled id 9), ragged chunks,
    malformed rows, and a mid-trace FeatureSpec reinstall and forest
    reinstall with flat serving configurations."""
    servers = _servers(strict_model_ids=True)
    for s in servers:
        s.engine.warm(64, HEADER_BYTES + 4 * WIDTH,
                      lanes=("mlp", "forest", "both"))
    rng = np.random.default_rng(14)
    raw = tdata.raw_trace(rng, 1800, n_flows=40, model_ids=(1, 5, 2, 6, 9),
                          pattern="mixed", burst_gap=2000)
    chunks = _ragged(raw, rng)
    chunks.insert(3, [raw[0], raw[1][:9], raw[2]])  # a ragged raw batch
    retrained = _forest_pair(40)
    outs, rcs = [], []
    for i, s in enumerate(servers):
        for c, chunk in enumerate(chunks):
            if c == len(chunks) // 2:
                rc = s.stats()["recompiles"]
                s.install_feature_spec(1, (7, 6, 5))
                s.install_forest(5, retrained[i])
            s.submit_raw(chunk)
        outs.append(s.drain_packets())
        rcs.append((rc, s.stats()["recompiles"]))
    assert _egress(outs[0]) == _egress(outs[1])
    n_err = sum(isinstance(o, PacketError) for o in outs[0])
    assert 0 < n_err < len(outs[0])
    assert rcs[0] == rcs[1] and rcs[0][0] == rcs[0][1]
    _assert_same_flow_state(*servers)
    lanes = servers[0].ingress.stats["lane_batches"]
    assert lanes["mlp"] > 0 and lanes["forest"] > 0
    snap = servers[0].obs.registry.snapshot()
    assert "flow_occupancy" in str(snap)


def test_submit_raw_overflow_matches_reference():
    """A table far below the trace's flow count with an idle timeout the
    bursty flows' gaps cross: expiry, eviction and per-flow overflow
    rejection all happen, with the reference's egress and error slots."""
    servers = _servers(forests=False, flow_capacity_pow2=5,
                       flow_idle_timeout=1500)
    rng = np.random.default_rng(15)
    raw = tdata.raw_trace(rng, 1500, n_flows=60, model_ids=(1, 2),
                          pattern="mixed", burst_gap=4000)
    chunks = _ragged(raw, rng, hi=120)
    outs = []
    for s in servers:
        for chunk in chunks:
            s.submit_raw(chunk)
        outs.append(s.drain_packets())
    assert _egress(outs[0]) == _egress(outs[1])
    _assert_same_flow_state(*servers)
    st_ = _table_stats(servers[0].flow.table)
    assert st_["flow_rejects_total"] > 0 and st_["flow_evictions_total"] > 0
    assert st_["flow_expiries_total"] > 0


def test_serve_raw_fused_matches_reference_staged_path():
    """The port's one-dispatch program on the CPU equals the reference's
    staged path (submit_raw + drain) on the same arrivals, batch after
    batch."""
    tsrv, jsrv = _servers()
    fused = _servers()[0]
    rng = np.random.default_rng(16)
    for b, pattern in enumerate(("mixed", "periodic")):
        raw = tdata.raw_trace(rng, 300, n_flows=16, model_ids=(1, 5, 2, 6),
                              pattern=pattern)
        jsrv.submit_raw(raw)
        want = np.stack(jsrv.drain_packets())
        tsrv.submit_raw(raw)
        staged = np.stack(tsrv.drain_packets())
        got = fused.flow.serve_raw_fused(raw)
        assert got.shape == (300, HEADER_BYTES + 4 * WIDTH)
        np.testing.assert_array_equal(got[:, : want.shape[1]], want)
        np.testing.assert_array_equal(staged, want)
    np.testing.assert_array_equal(fused.flow.table.registers,
                                  jsrv.flow.table.registers)
    np.testing.assert_array_equal(fused.flow.cms, jsrv.flow.cms)
    empty = np.zeros((0, tdata.RAW_HEADER_BYTES), np.uint8)
    assert fused.flow.serve_raw_fused(empty).shape == (
        0, HEADER_BYTES + 4 * WIDTH)


def test_restore_reference_snapshot_continues_identically():
    """A reference frontend checkpointed mid-trace, restored into the port:
    both go on with identical features, egress and state."""
    tsrv, jsrv = _servers(forests=False)
    raw = tdata.raw_trace(np.random.default_rng(17), 1000, n_flows=24,
                          model_ids=(1, 2), pattern="mixed")
    jsrv.submit_raw(raw[:500])
    jsrv.drain_packets()
    tsrv.flow.restore(jsrv.flow.snapshot())
    np.testing.assert_array_equal(
        tsrv.flow.extract(raw[500:600])[0], jsrv.flow.extract(
            raw[500:600])[0])
    for s in (tsrv, jsrv):
        s.submit_raw(raw[600:])
    assert _egress(tsrv.drain_packets()) == _egress(jsrv.drain_packets())
    np.testing.assert_array_equal(tsrv.flow.table.registers[
        tsrv.flow.table._slot_state == 1].sum(0),
        jsrv.flow.table.registers[jsrv.flow.table._slot_state == 1].sum(0))
    np.testing.assert_array_equal(tsrv.flow.cms, jsrv.flow.cms)
    with pytest.raises(ValueError, match="geometry"):
        tsrv.flow.restore({"table": jsrv.flow.table.snapshot(),
                           "cms": np.zeros((3, 8), np.int32)})


def test_frontend_backends_on_cpu():
    srv = _servers(forests=False)[0]
    with pytest.raises(ValueError, match="card"):
        FlowFrontend(srv.ingress, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        FlowFrontend(srv.ingress, backend="pallas")
    raw = tdata.raw_trace(np.random.default_rng(18), 200, n_flows=9,
                          model_ids=(1, 2))
    auto = FlowFrontend(srv.ingress)
    oracle = FlowFrontend(srv.ingress, backend="ref")
    for a, b in zip(auto.extract(raw), oracle.extract(raw)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(auto.table.registers,
                                  oracle.table.registers)
    np.testing.assert_array_equal(auto.cms, oracle.cms)
