"""The port's hard-latency layer against the JAX reference, on the CPU at
small sizes, with exact equality (integer codes and bytes, zero
tolerance):

  * the SLO and reflex control-plane families: after the same install
    sequence the port's and the reference's ``ControlPlane`` give equal
    ``slo_budget_rows``, ``reflex_mask`` and ``reflex_evaluate`` over
    seeded programs and seeded int32 features, the int32 edges included;
    installs are prepare-then-commit and crash-safe at the ``install``
    fault site, and invalid programs raise on both sides;
  * the watermark controller stages, answers on the reflex lane and sheds
    in submission order, byte-identically to the reference's pipeline;
  * deadline-aware batch closing is exact at the boundary on an injected
    clock and reuses the ladder's dispatch shapes;
  * bounded drains return with ``PacketError(DRAIN_TIMEOUT)`` slots — on a
    wedged pipeline, on a fabric with one wedged shard, and (the port's
    own path) on a batch whose completion event never fires in the window
    or that the ``"overload"`` site holds past it; on that last input the
    reference's drain sleeps out the hold instead (reference fault R7,
    both outcomes pinned);
  * the ``"overload"`` site keeps shedding local to its shard;
  * ``ReflexConfirmer`` agreement equals the reference's, and confirmation
    is credit-neutral.
"""

import numpy as np
import pytest
import torch

from repro.core.control_plane import ControlPlane as JCP
from repro.core.inference import DataPlaneEngine as JEngine
from repro.core.ingress import IngressPipeline as JPipeline
from repro.launch.serve import PacketServer as JServer
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import FaultSpec as JFaultSpec
from repro.serve import ReflexProgram as JProgram
from repro.serve import ShardedPacketServer as JFabric
from repro.serve import reflex_oracle as j_reflex_oracle
from repro_torch.core import packet as pk
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.inference import DataPlaneEngine
from repro_torch.core.ingress import (DEADLINE_SHED, DRAIN_TIMEOUT,
                                      IngressPipeline, PacketError)
from repro_torch.launch.serve import PacketServer
from repro_torch.serve import (FaultPlan, FaultSpec, InjectedFault,
                               ReflexConfirmer, ReflexProgram,
                               ShardedPacketServer, reflex_oracle)

torch.set_num_threads(1)

FRAC = 8
WIDTH = 16
FOREVER = 1 << 60
I32 = np.iinfo(np.int32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _layers(rng):
    w1 = rng.normal(size=(WIDTH, WIDTH)).astype(np.float32) * 0.3
    w2 = rng.normal(size=(WIDTH, 2)).astype(np.float32) * 0.3
    return [(w1, np.zeros(WIDTH, np.float32)), (w2, np.zeros(2, np.float32))]


def _cp(cls=ControlPlane, mids=(10, 11), seed=0):
    cp = cls(max_models=16, max_layers=2, max_width=WIDTH, frac_bits=FRAC)
    rng = np.random.default_rng(seed)
    for mid in mids:
        cp.install(mid, _layers(rng), ["relu"], final_activation="sigmoid")
    return cp


def _pipelines(mids=(10, 11), **kw):
    """The port's pipeline (CPU) and the reference's, on equal planes."""
    kw.setdefault("batch_size", 16)
    kw.setdefault("use_cache", False)
    tcp, jcp = _cp(ControlPlane, mids), _cp(JCP, mids)
    tp = IngressPipeline(DataPlaneEngine(tcp, max_features=WIDTH,
                                         device="cpu"), **kw)
    jp = JPipeline(JEngine(jcp, max_features=WIDTH), **kw)
    return (tcp, tp), (jcp, jp)


def _wire(rng, n, mid=10):
    codes = rng.integers(-2000, 2000, (n, WIDTH)).astype(np.int32)
    return pk.encode_packets_np(np.full(n, mid, np.int32), FRAC, codes), codes


def _prog(cls=ReflexProgram, on_true=(256, 0), on_false=(0, 256), lane=0,
          thr=0):
    return cls.threshold(lane, thr, on_true=on_true, on_false=on_false)


def _egress(out):
    return [o.reason if hasattr(o, "reason") else np.asarray(o).tobytes()
            for o in out]


def _fabric(n, mids=(1,), **kw):
    for k, v in dict(max_width=WIDTH, frac_bits=FRAC, ingress_batch=16,
                     max_inflight=2).items():
        kw.setdefault(k, v)
    fab = ShardedPacketServer(n_shards=n, device="cpu", **kw)
    rng = np.random.default_rng(7)
    for mid in mids:
        fab.install(mid, _layers(rng), ["relu"], final_activation="sigmoid")
        fab.install_feature_spec(mid, tuple(range(8)) * (WIDTH // 8))
    return fab


# ---------------------------------------------------------------------------
# control-plane families against the reference's
# ---------------------------------------------------------------------------


def _random_program(rng, cls, k):
    return cls(lanes=tuple(rng.integers(0, WIDTH, k).tolist()),
               thresholds=tuple(rng.integers(-2000, 2001, k).tolist()),
               weights=tuple(rng.integers(-3, 4, k).tolist()),
               bias=int(rng.integers(-3, 4)),
               on_true=tuple(rng.integers(-500, 501, 2).tolist()),
               on_false=tuple(rng.integers(-500, 501, 2).tolist()))


def _edge_program(cls):
    """Thresholds, weights and output codes at the int32 edges: the votes
    need int64, as in the reference."""
    return cls(lanes=(0, 1, 2, 3, WIDTH - 1),
               thresholds=(I32.min, I32.max, 0, -1, I32.max),
               weights=(I32.max, I32.max, I32.min, 1, -1),
               bias=-(2 ** 33),
               on_true=(I32.max, I32.min, 0),
               on_false=(I32.min, I32.max, -1))


@pytest.mark.parametrize("seed", range(8))
def test_families_match_reference_control_plane(seed):
    """The same seeded sequence of budget and reflex installs, reinstalls
    and removals on both planes: versions, budget rows, masks and reflex
    evaluations equal after every step."""
    rng = np.random.default_rng(seed)
    tcp, jcp = _cp(ControlPlane, ()), _cp(JCP, ())
    mids = np.asarray([0, 3, 5, 9, 40, 65535], np.int32)
    x = rng.integers(-2500, 2500, (64, WIDTH)).astype(np.int32)
    x[:8] = I32.max
    x[8:16] = I32.min
    x[16:24, :4] = [[I32.min, I32.max, 0, -1]]
    probe = rng.choice(mids, 64).astype(np.int32)
    for step in range(10):
        op = int(rng.integers(0, 5))
        mid = int(rng.choice(mids))
        if op == 0:
            budget = float(rng.uniform(1.0, 1e4))
            tcp.install_slo_budget(mid, budget)
            jcp.install_slo_budget(mid, budget)
        elif op == 1:
            tcp.remove_slo_budget(mid)
            jcp.remove_slo_budget(mid)
        elif op == 2 and step % 3 == 0:
            tcp.install_reflex(mid, _edge_program(ReflexProgram))
            jcp.install_reflex(mid, _edge_program(JProgram))
        elif op in (2, 3):
            k = int(rng.integers(1, 6))
            state = rng.bit_generator.state
            tcp.install_reflex(mid, _random_program(rng, ReflexProgram, k))
            rng.bit_generator.state = state
            jcp.install_reflex(mid, _random_program(rng, JProgram, k))
        else:
            tcp.remove_reflex(mid)
            jcp.remove_reflex(mid)
        assert tcp.version == jcp.version
        assert tcp.slo_active == jcp.slo_active
        assert tcp.reflex_active == jcp.reflex_active
        np.testing.assert_array_equal(tcp.slo_budget_rows(probe),
                                      jcp.slo_budget_rows(probe))
        assert [tcp.slo_budget(int(m)) for m in mids] == \
            [jcp.slo_budget(int(m)) for m in mids]
        np.testing.assert_array_equal(tcp.reflex_mask(probe),
                                      jcp.reflex_mask(probe))
        tmask, tout = tcp.reflex_evaluate(probe, x)
        jmask, jout = jcp.reflex_evaluate(probe, x)
        np.testing.assert_array_equal(tmask, jmask)
        assert tout.dtype == jout.dtype == np.int32
        np.testing.assert_array_equal(tout, jout)
        # a narrower serving width clamps lanes as the reference does
        np.testing.assert_array_equal(tcp.reflex_evaluate(probe, x[:, :5])[1],
                                      jcp.reflex_evaluate(probe, x[:, :5])[1])


@pytest.mark.parametrize("seed", range(6))
def test_packed_evaluate_matches_both_oracles(seed):
    rng = np.random.default_rng(100 + seed)
    k = int(rng.integers(1, 5))
    prog = _random_program(rng, ReflexProgram, k)
    cp = _cp(mids=())
    cp.install_reflex(5, prog)
    x = rng.integers(-2500, 2500, (12, WIDTH)).astype(np.int32)
    _, out = cp.reflex_evaluate(np.full(12, 5, np.int32), x)
    jprog = JProgram(**{f: getattr(prog, f) for f in (
        "lanes", "thresholds", "weights", "on_true", "on_false", "bias")})
    for i in range(12):
        want = reflex_oracle(prog, x[i])
        assert want == j_reflex_oracle(jprog, x[i])
        assert out[i, :prog.out_dim].tolist() == want


def test_budget_install_remove_and_validation():
    cp = _cp()
    assert not cp.slo_active
    v0 = cp.version
    cp.install_slo_budget(10, 250.0)
    assert cp.version == v0 + 1 and cp.slo_active
    assert cp.slo_budget(10) == 250.0 and np.isinf(cp.slo_budget(11))
    rows = cp.slo_budget_rows(np.array([10, 11, 10], np.int32))
    assert rows.dtype == np.float64 and rows[0] == 250.0
    cp.remove_slo_budget(10)
    assert np.isinf(cp.slo_budget(10)) and cp.slo_active  # monotone latch
    for bad in (0.0, -5.0, float("inf"), float("nan")):
        with pytest.raises(ValueError):
            cp.install_slo_budget(10, bad)
    with pytest.raises(ValueError):
        cp.install_slo_budget(70000, 5.0)


def test_install_kwargs_set_budgets_in_the_same_swap():
    from repro_torch.data.packets import anomaly_dataset
    from repro_torch.forest import train_forest
    cp = ControlPlane(max_models=4, max_layers=2, max_width=WIDTH,
                      frac_bits=FRAC, max_forests=2, max_trees=3,
                      max_nodes=31, max_tree_depth=4)
    v0 = cp.version
    cp.install(3, _layers(np.random.default_rng(1)), ["relu"],
               final_activation="sigmoid", slo_budget_us=500.0)
    assert cp.version == v0 + 1 and cp.slo_budget(3) == 500.0
    X, y = anomaly_dataset(np.random.default_rng(2), 200, WIDTH)
    forest = train_forest(X, y, n_trees=2, max_depth=3, max_nodes=15)
    cp.install_forest(4, forest, slo_budget_us=80.0)
    assert cp.version == v0 + 2 and cp.slo_budget(4) == 80.0
    with pytest.raises(ValueError):  # nothing half-installed
        cp.install(5, _layers(np.random.default_rng(1)), ["relu"],
                   slo_budget_us=-1.0)
    assert cp.version == v0 + 2 and 5 not in cp.installed_ids()


@pytest.mark.parametrize("family", ["reflex", "slo", "mlp_with_budget"])
def test_installs_are_crash_safe(family):
    cp = _cp()
    cp.fault_plan = FaultPlan([FaultSpec(site="install", count=1)])
    v0, rows0 = cp.version, cp.slo_budget_rows(np.arange(16))

    def install():
        if family == "reflex":
            cp.install_reflex(10, _prog())
        elif family == "slo":
            cp.install_slo_budget(10, 100.0)
        else:
            cp.install(12, _layers(np.random.default_rng(3)), ["relu"],
                       slo_budget_us=100.0)

    with pytest.raises(InjectedFault):
        install()
    assert cp.version == v0 and not cp.reflex_active and not cp.slo_active
    np.testing.assert_array_equal(cp.slo_budget_rows(np.arange(16)), rows0)
    assert not cp.reflex_mask(np.array([10]))[0]
    install()  # a clean retry lands
    assert cp.version == v0 + 1


def test_reflex_install_round_trip_and_validation():
    cp, jcp = _cp(), _cp(JCP)
    p = _prog()
    slot = cp.install_reflex(10, p)
    assert slot == jcp.install_reflex(10, _prog(JProgram)) == 0
    assert cp.reflex_program(10) == p and cp.reflex_active
    cp.remove_reflex(10)
    assert cp.reflex_program(10) is None and cp.reflex_active
    assert not cp.reflex_mask(np.array([10], np.int32))[0]
    bad_programs = [
        dict(lanes=(WIDTH,), thresholds=(0,), weights=(1,), on_true=(1,),
             on_false=(0,)),
        dict(lanes=(0,), thresholds=(2 ** 31,), weights=(1,), on_true=(1,),
             on_false=(0,)),
        dict(lanes=(0,), thresholds=(0,), weights=(1,),
             on_true=(1,) * (WIDTH + 1), on_false=(0,) * (WIDTH + 1)),
        dict(lanes=tuple(range(WIDTH)) + (0,), thresholds=(0,) * (WIDTH + 1),
             weights=(1,) * (WIDTH + 1), on_true=(1,), on_false=(0,)),
    ]
    for kw in bad_programs:
        for plane, cls in ((cp, ReflexProgram), (jcp, JProgram)):
            with pytest.raises(ValueError):
                plane.install_reflex(11, cls(**kw))
    for kw in (dict(lanes=(), thresholds=(), weights=(), on_true=(1,),
                    on_false=(0,)),
               dict(lanes=(0, 1), thresholds=(5,), weights=(1, 1),
                    on_true=(1,), on_false=(0,)),
               dict(lanes=(0,), thresholds=(5,), weights=(1,),
                    on_true=(1, 2), on_false=(0,)),
               dict(lanes=(-1,), thresholds=(5,), weights=(1,),
                    on_true=(1,), on_false=(0,))):
        for cls in (ReflexProgram, JProgram):
            with pytest.raises(ValueError):
                cls(**kw)


# ---------------------------------------------------------------------------
# watermark admission: stage / reflex / shed in submission order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,mid,reflex", [
    (dict(queue_capacity=64, queue_high_watermark=16), 10, True),
    (dict(queue_capacity=32), 11, False),
    (dict(queue_high_watermark=8), 10, True),
    (dict(queue_capacity=8), 11, False),
])
def test_watermark_admission_matches_reference(kw, mid, reflex):
    (tcp, tp), (jcp, jp) = _pipelines(**kw)
    if reflex:
        tcp.install_reflex(10, _prog())
        jcp.install_reflex(10, _prog(JProgram))
    rng = np.random.default_rng(3)
    wire, _ = _wire(rng, 80, mid=mid)
    dup = np.vstack([wire, wire[:4]])   # trailing duplicates
    outs = []
    for p in (tp, jp):
        p.submit(dup)
        outs.append(_egress(p.drain()))
    assert outs[0] == outs[1]
    for key in ("ingress_reflex_served_total", "ingress_shed_total"):
        assert tp.stats[key] == jp.stats[key]


def test_reflex_rows_follow_the_oracle_in_submission_order():
    (cp, pipe), _ = _pipelines(queue_capacity=64, queue_high_watermark=16)
    prog = _prog()
    cp.install_reflex(10, prog)
    wire, codes = _wire(np.random.default_rng(3), 80)
    pipe.submit(wire)
    out = pipe.drain()
    reflexed = [i for i, r in enumerate(out)
                if not isinstance(r, PacketError)
                and (int(r[6]) & pk.FLAG_REFLEX)]
    assert reflexed == list(range(16, 80))
    for i in reflexed:
        want = np.zeros(pipe.out_feats, np.int32)
        want[:prog.out_dim] = reflex_oracle(prog, codes[i])
        row = pk.emit_results_np(np.array([10], np.int32),
                                 np.array([int(out[i][6])]), want[None],
                                 FRAC)[0]
        assert np.array_equal(out[i], row)
    ev = pipe.obs.events.records(kind="reflex_served")
    assert ev and sum(e.detail["count"] for e in ev) == 64


def test_shed_slots_are_typed_and_counted():
    (_, pipe), _ = _pipelines(queue_capacity=32)
    pipe.submit(_wire(np.random.default_rng(3), 80, mid=11)[0])
    out = pipe.drain()
    shed = [i for i, r in enumerate(out) if isinstance(r, PacketError)]
    assert shed == list(range(32, 80))
    assert all(out[i].reason == DEADLINE_SHED for i in shed)
    assert pipe.obs.events.records(kind="deadline_shed")


def test_depth_reaps_completed_futures():
    (_, pipe), _ = _pipelines(queue_capacity=64)
    pipe.submit(_wire(np.random.default_rng(9), 16, mid=11)[0])
    pipe.drain()
    assert pipe.queue_depth() == 0


# ---------------------------------------------------------------------------
# deadline-aware batch closing on an injected clock
# ---------------------------------------------------------------------------


def _deadline_pipe():
    clk = FakeClock()
    (cp, pipe), _ = _pipelines(clock=clk)
    cp.install_slo_budget(10, 500.0)
    pipe.dispatch_cost_ewma = 100e-6
    return clk, cp, pipe


def test_boundary_minus_epsilon_ships_plus_epsilon_waits():
    clk, cp, pipe = _deadline_pipe()
    pipe.submit(_wire(np.random.default_rng(1), 4)[0])  # deadline t+500us
    clk.t = 399e-6                     # remaining 101us > 100us cost
    assert pipe.poll() is False and pipe._open
    clk.t = 400e-6                     # remaining == cost: ship now
    assert pipe.poll() is True and not pipe._open
    out = pipe.drain()
    assert len(out) == 4 and not any(isinstance(r, PacketError) for r in out)


def test_models_without_budget_never_deadline_close():
    clk, cp, pipe = _deadline_pipe()
    pipe.submit(_wire(np.random.default_rng(1), 4, mid=11)[0])
    clk.t = 10.0
    assert pipe.poll() is False and pipe._open


def test_deadline_close_adds_no_configuration():
    clk, cp, pipe = _deadline_pipe()
    rng = np.random.default_rng(1)
    pipe.submit(_wire(rng, 3)[0])      # warm the padded rung once
    pipe.drain()
    traces = pipe.engine.trace_count
    for fill in (1, 5, 9):
        pipe.submit(_wire(rng, fill)[0])
        clk.t += 1.0                   # way past every deadline
        assert pipe.poll() is True
        pipe.drain()
    assert pipe.engine.trace_count == traces


@pytest.mark.parametrize("seed", range(4))
def test_no_open_batch_ever_past_its_ship_by_point(seed):
    ev = np.random.default_rng(seed)
    events = [(int(ev.integers(1, 11)), int(ev.choice([10, 11])))
              for _ in range(int(ev.integers(1, 26)))]
    clk = FakeClock()
    (cp, pipe), _ = _pipelines(clock=clk)
    cp.install_slo_budget(10, 500.0)
    cp.install_slo_budget(11, 300.0)
    pipe.dispatch_cost_ewma = 100e-6
    pipe._COST_ALPHA = 0.0             # pin the cost on the fake clock
    rng = np.random.default_rng(0)
    pipe.submit(_wire(rng, 3)[0])      # warm the padded rung once
    clk.advance(1.0)
    pipe.poll()
    pipe.drain()
    traces = pipe.engine.trace_count
    for gap, mid in events:
        clk.advance(gap * 10e-6)
        pipe.submit(_wire(rng, 1, mid=mid)[0])
        pipe.poll()
        for o in pipe._open.values():
            assert o.deadline - clk.t > pipe.dispatch_cost_ewma
    out = pipe.drain()
    assert len(out) == len(events)
    assert not any(isinstance(r, PacketError) for r in out)
    assert pipe.engine.trace_count == traces


# ---------------------------------------------------------------------------
# bounded drains
# ---------------------------------------------------------------------------


def test_wedged_pipeline_drain_returns_with_typed_slots():
    (_, pipe), _ = _pipelines()
    pipe.fault_plan = FaultPlan([FaultSpec(site="stall", latency=0.25,
                                           count=1)])
    wire, _ = _wire(np.random.default_rng(2), 4)
    pipe.submit(wire)                  # partial: dispatched by the drain,
    out = pipe.drain(timeout_us=1000.0)  # where it stalls
    assert [o.reason for o in out] == [DRAIN_TIMEOUT] * 4
    assert pipe.stats["ingress_drain_timeouts_total"] == 1
    pipe.submit(wire)                  # the next window serves normally
    assert not any(isinstance(r, PacketError) for r in pipe.drain())


class _NeverReady:
    """A batch result whose completion event has not fired (as a result
    queued behind a busy device): ``is_ready`` polls False."""

    def __init__(self, inner):
        self.inner = inner
        self.polls = 0

    def is_ready(self):
        self.polls += 1
        return False

    def block_until_ready(self):
        return self

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.inner)


def test_bounded_drain_polls_completion_events():
    """A bounded drain polls each batch's completion event against its
    window and never waits on it: the batch's tickets come back as
    ``DRAIN_TIMEOUT`` slots, while an unbounded drain retires it."""
    (_, pipe), _ = _pipelines()
    run = pipe.engine.run_features
    held = []

    def slow(*a, **kw):
        held.append(_NeverReady(run(*a, **kw)))
        return held[-1]

    pipe.engine.run_features = slow
    wire, _ = _wire(np.random.default_rng(2), 20)
    pipe.submit(wire)                  # one full batch, one partial
    out = pipe.drain(timeout_us=2000.0)
    assert [o.reason for o in out] == [DRAIN_TIMEOUT] * 20
    assert held and held[0].polls > 1
    pipe.submit(wire)
    out2 = pipe.drain()
    pipe.engine.run_features = run
    pipe.submit(wire)
    assert _egress(out2) == _egress(pipe.drain())
    assert not any(isinstance(r, PacketError) for r in out2)


def test_fabric_drain_bounds_a_wedged_shard():
    fab = _fabric(2)
    FaultPlan([FaultSpec(site="stall", shard=0, latency=0.3,
                         count=1)]).install(fab)
    rng = np.random.default_rng(4)
    fab.submit_packets(_wire(rng, 8, mid=1)[0])    # shard 0: partial batch
    fab.submit_packets(_wire(rng, 16, mid=1)[0])   # shard 1: full batch
    fab.shards[1].pipeline.flush()
    out = fab.drain_packets(timeout_us=50_000.0)
    assert len(out) == 24
    assert all(out[i].reason == DRAIN_TIMEOUT for i in range(8))
    assert not any(isinstance(out[i], PacketError) for i in range(8, 24))
    assert fab.shards[0].pipeline.stats["ingress_drain_timeouts_total"] == 1


def test_fabric_drain_bounds_an_overloaded_shard():
    """A batch that the ``"overload"`` site holds past the drain's window
    counts as not ready: shard 0's tickets come back as ``DRAIN_TIMEOUT``
    slots instead of the drain sleeping out the hold, and shard 1 serves."""
    fab = _fabric(2)
    for sh in fab.shards:              # hold = 199 x 2 ms, capped at 0.5 s
        sh.pipeline.dispatch_cost_ewma = 2e-3
    FaultPlan([FaultSpec(site="overload", shard=0, slowdown=200.0,
                         count=FOREVER)]).install(fab)
    rng = np.random.default_rng(5)
    fab.submit_packets(_wire(rng, 16, mid=1)[0])   # shard 0: full batch
    fab.submit_packets(_wire(rng, 16, mid=1)[0])   # shard 1: full batch
    assert fab.shards[0].pipeline._inflight[0].hold_until > 0
    out = fab.drain_packets(timeout_us=20_000.0)
    assert len(out) == 32
    assert all(out[i].reason == DRAIN_TIMEOUT for i in range(16))
    assert not any(isinstance(out[i], PacketError) for i in range(16, 32))
    assert fab.shards[0].pipeline.stats["ingress_drain_timeouts_total"] == 1
    assert fab.shards[1].pipeline.stats["ingress_drain_timeouts_total"] == 0


def test_overloaded_shard_drain_differs_from_reference_r7():
    """Reference fault R7, pinned on both packages with the input of
    ``test_fabric_drain_bounds_an_overloaded_shard``: 2 shards, the
    ``"overload"`` site at ``slowdown=200`` on shard 0 over an EWMA of 2 ms
    (a 0.398 s hold), 16 packets per shard, ``timeout_us=20_000``.  The
    reference's drain is "best-effort by one step": it sleeps out the hold
    and serves shard 0's packets late, past its window, and the healthy
    shard 1, left no window, comes back as ``DRAIN_TIMEOUT`` slots.  The
    port returns shard 0's packets as ``DRAIN_TIMEOUT`` slots within the
    window and serves shard 1.  Both fabrics serve one batch per shard
    first, so that no compile time (the reference's jit) runs down the
    hold."""
    import time

    from repro.core.ingress import PacketError as JPacketError
    fab = _fabric(2)
    jfab = JFabric(n_shards=2, max_width=WIDTH, frac_bits=FRAC,
                   ingress_batch=16, max_inflight=2)
    rng = np.random.default_rng(7)
    jfab.install(1, _layers(rng), ["relu"], final_activation="sigmoid")
    jfab.install_feature_spec(1, tuple(range(8)) * (WIDTH // 8))
    outs, secs = [], []
    for f, plan in ((fab, FaultPlan([FaultSpec(
            site="overload", shard=0, slowdown=200.0, count=FOREVER)])),
                    (jfab, JFaultPlan([JFaultSpec(
                        site="overload", shard=0, slowdown=200.0,
                        count=FOREVER)]))):
        warm = np.random.default_rng(4)
        for _ in range(2):
            f.submit_packets(_wire(warm, 16, mid=1)[0])
        assert len(f.drain_packets()) == 32
        for sh in f.shards:
            sh.pipeline.dispatch_cost_ewma = 2e-3
        plan.install(f)
        rng = np.random.default_rng(5)
        f.submit_packets(_wire(rng, 16, mid=1)[0])   # shard 0
        f.submit_packets(_wire(rng, 16, mid=1)[0])   # shard 1
        t0 = time.perf_counter()
        outs.append(f.drain_packets(timeout_us=20_000.0))
        secs.append(time.perf_counter() - t0)
    out, jout = outs
    assert len(out) == len(jout) == 32
    # the port: shard 0's slots time out inside the window, shard 1 serves
    assert all(out[i].reason == DRAIN_TIMEOUT for i in range(16))
    assert not any(isinstance(o, PacketError) for o in out[16:])
    assert secs[0] < 0.3
    # the reference: shard 0 served after the 0.398 s hold, shard 1 not
    assert not any(isinstance(o, JPacketError) for o in jout[:16])
    assert all(isinstance(o, JPacketError) and o.reason == DRAIN_TIMEOUT
               for o in jout[16:])
    assert secs[1] >= 0.39
    assert [sh.pipeline.stats["ingress_drain_timeouts_total"]
            for f in (fab, jfab) for sh in f.shards] == [1, 0, 0, 1]


# ---------------------------------------------------------------------------
# overload chaos and the SLO health rules
# ---------------------------------------------------------------------------


def test_overload_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec(site="overload", slowdown=0.0)
    plan = FaultPlan([FaultSpec(site="overload", shard=1, slowdown=4.0,
                                count=FOREVER)])
    assert plan.overload_factor(1) == 4.0 and plan.overload_factor(0) == 1.0


def test_shed_stays_local_to_the_overloaded_shard():
    fab = _fabric(2, queue_capacity=40)
    rng = np.random.default_rng(3)
    for _ in range(4):                 # warm both shards, seed EWMAs
        fab.submit_packets(_wire(rng, 16, mid=1)[0])
    fab.drain_packets()
    for sh in fab.shards:              # pin the measured cost
        sh.pipeline.dispatch_cost_ewma = 2e-3
    FaultPlan([FaultSpec(site="overload", shard=0, slowdown=50.0,
                         count=FOREVER)]).install(fab)
    for _ in range(12):                # burst: chunks round-robin
        fab.submit_packets(_wire(rng, 16, mid=1)[0])
    shed_per = [sh.pipeline.stats["ingress_shed_total"] for sh in fab.shards]
    assert shed_per[0] > 0 and shed_per[1] == 0
    out = fab.drain_packets(timeout_us=5e6)
    assert len(out) == 12 * 16
    shed = [i for i, r in enumerate(out) if isinstance(r, PacketError)]
    assert len(shed) == shed_per[0]
    assert all(out[i].reason == DEADLINE_SHED for i in shed)
    assert all((i // 16) % 2 == 0 for i in shed)  # shard-0 chunks only


def test_slo_health_rules_follow_the_reference():
    """``slo_budget`` adds ``slo:submit_p99`` to a server and
    ``slo:fabric_submit_p99`` to a fabric, with the reference's names."""
    kw = dict(max_width=WIDTH, ingress_batch=16, slo_budget=0.5)
    srv, jsrv = PacketServer(device="cpu", **kw), JServer(**kw)
    fab = ShardedPacketServer(n_shards=2, device="cpu", **kw)
    jfab = JFabric(n_shards=2, **kw)
    names = [sorted(s.obs.health.rules)
             for s in (srv, jsrv, fab, jfab)]
    assert names[0] == names[1] and "slo:submit_p99" in names[0]
    assert names[2] == names[3] and "slo:fabric_submit_p99" in names[2]
    with pytest.raises(ValueError):
        PacketServer(device="cpu", slo_budget=0.0)


# ---------------------------------------------------------------------------
# reflex confirmation (async model-lane agreement)
# ---------------------------------------------------------------------------


def _reflex_servers():
    kw = dict(max_width=WIDTH, frac_bits=FRAC, ingress_batch=16,
              max_inflight=2, queue_high_watermark=8, use_cache=False)
    out = []
    for srv, cls in ((PacketServer(device="cpu", **kw), ReflexProgram),
                     (JServer(**kw), JProgram)):
        srv.install(1, _layers(np.random.default_rng(7)), ["relu"],
                    final_activation="sigmoid")
        srv.install_reflex(1, _prog(cls))
        out.append(srv)
    return out


def test_reflex_confirmer_agreement_matches_reference():
    srv, jsrv = _reflex_servers()
    assert isinstance(srv.ingress.reflex_confirm, ReflexConfirmer)
    wire, _ = _wire(np.random.default_rng(3), 64, mid=1)
    outs = []
    for s in (srv, jsrv):
        s.submit_packets(wire)
        outs.append(_egress(s.drain_packets()))
    assert outs[0] == outs[1]
    served = srv.ingress.stats["ingress_reflex_served_total"]
    assert served == 64 - 8
    conf, jconf = srv.ingress.reflex_confirm, jsrv.ingress.reflex_confirm
    assert conf.pairs == jconf.pairs == served
    assert conf.snapshot() == jconf.snapshot()
    assert 0.0 <= conf.agreement() <= 1.0
    srv.remove_reflex(1)
    assert srv.control_plane.reflex_program(1) is None


def test_confirmation_is_credit_neutral():
    srv, _ = _reflex_servers()
    srv.submit_packets(_wire(np.random.default_rng(3), 64, mid=1)[0])
    srv.drain_packets()
    assert srv.engine.stats["packets"] == 64


def test_fabric_install_reflex_attaches_a_confirmer_per_shard():
    fab = _fabric(2, queue_high_watermark=8, use_cache=False)
    fab.install_reflex(1, _prog())
    assert all(isinstance(sh.pipeline.reflex_confirm, ReflexConfirmer)
               for sh in fab.shards)
    rng = np.random.default_rng(5)
    for _ in range(4):
        fab.submit_packets(_wire(rng, 32, mid=1)[0])
    out = fab.drain_packets()
    assert not any(isinstance(r, PacketError) for r in out)
    served = sum(sh.pipeline.stats["ingress_reflex_served_total"]
                 for sh in fab.shards)
    assert served > 0
    assert sum(sh.pipeline.reflex_confirm.pairs for sh in fab.shards) == \
        served
    fab.install_slo_budget(1, 300.0)
    assert fab.control_plane.slo_budget(1) == 300.0
    fab.remove_reflex(1)
    assert not fab.control_plane.reflex_mask(np.array([1]))[0]
