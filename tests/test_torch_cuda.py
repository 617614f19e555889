"""The hand-written CUDA kernels against their plain versions on the card,
and the port's serving paths on the card against the port on the CPU.
Every test here needs an NVIDIA GPU with nvcc (``-m cuda``) and skips
without one.  On a machine with a card (``--noconftest``: ``tests/conftest.py``
imports the JAX package, which this file does not need):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import importlib
import math

import numpy as np
import pytest
import torch

from repro_torch.core import fixedpoint as fp
from repro_torch.core import quantize as tq
from repro_torch.core.packet import HEADER_BYTES, encode_packets_np
from repro_torch.core.taylor import scaled_constants
from repro_torch.data.packets import anomaly_dataset, qos_dataset, raw_trace
from repro_torch.forest import train_forest
from repro_torch.forest.synthetic import (random_forest_tables,
                                          rejected_tables, stack_ranges)
from repro_torch.kernels import fixedpoint_mlp as fmlp
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import flow_update as fuk
from repro_torch.kernels import forest_traversal as ftk
from repro_torch.kernels import ops
from repro_torch.kernels import row_quantize as rqk
from repro_torch.kernels import ssd_scan as ssk
from repro_torch.kernels.ref import (FLOW_CODE_MAX, flow_update_ref,
                                     forest_range_gather_ref,
                                     forest_traverse_gather_ref,
                                     fused_mlp_gather_ref, fused_mlp_warp_ref)
from repro_torch.launch.serve import PacketServer
from repro_torch.models import flash as FL
from repro_torch.models import ssm
from repro_torch.models import zamba2 as Z

# the kernel modules (``repro_torch.kernels`` exports their wrappers, which
# share the modules' names)
fmm = importlib.import_module("repro_torch.kernels.fixedpoint_matmul")
tak = importlib.import_module("repro_torch.kernels.taylor_activation")
wk = importlib.import_module("repro_torch.kernels.wkv_scan")

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

FRAC = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _case(seed, dev, n_batch, n_models, n_layers, width, variant):
    rng = np.random.default_rng(seed)
    w_dtype = np.int8 if variant == "int8" else np.int16
    info = np.iinfo(w_dtype)
    w = rng.integers(info.min, info.max, (n_models, n_layers, width, width),
                     endpoint=True).astype(w_dtype)
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, (n_models, n_layers, width))
    x = rng.integers(-2 ** 30, 2 ** 30, (n_batch, width))
    act = rng.choice([0, 1, 2, 3, 4, 9], (n_models, n_layers))
    on = (rng.random((n_models, n_layers)) < 0.75)
    slot = rng.integers(0, n_models, n_batch)

    def t(a, dt=np.int32):
        return torch.as_tensor(np.asarray(a, dt), device=dev)

    return dict(x_q=t(x), slot=t(slot), w=t(w, w_dtype), b=t(b), act=t(act),
                layer_on=t(on))


def _kw(order=3):
    return dict(frac=FRAC, leaky_alpha_q=3, sig_coeffs=tuple(
        int(c) for c in scaled_constants("sigmoid", order, FRAC)))


@pytest.mark.parametrize("variant", ["int16", "int8"])
@pytest.mark.parametrize("n_batch,width,order", [(1, 32, 3), (255, 32, 5),
                                                 (2048, 32, 3), (4099, 32, 1),
                                                 (300, 8, 3), (300, 48, 3)])
def test_kernel_equals_plain_version(card, variant, n_batch, width, order):
    c = _case(n_batch + width, card, n_batch, 16, 4, width, variant)
    kw = _kw(order)
    before = fmlp.launches[variant]
    got = fmlp.fixedpoint_mlp(**c, **kw, variant=variant)
    assert fmlp.launches[variant] == before + 1
    want = fused_mlp_gather_ref(**c, **kw,
                                lane_bits=8 if variant == "int8" else None)
    masked = ops.fused_mlp(c["x_q"], c["slot"], c["w"], c["b"], c["act"],
                           c["layer_on"], backend="ref", variant=variant, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, masked)


@pytest.mark.parametrize("variant", ["int16", "int8"])
@pytest.mark.parametrize("width", [1, 31, 32, 33, 128])
def test_kernel_edge_widths_opcodes_and_slots(card, variant, width):
    """Widths around the kernel's W = 32 specialisation and its 128 limit,
    every opcode in every model, middle layers off, and slots outside
    [0, M), which return the lane-clamped input."""
    c = _case(width, card, 301, 6, 6, width, variant)
    c["act"] = torch.as_tensor(np.stack([np.roll([0, 1, 2, 3, 4, 9], m)
                                         for m in range(6)]).astype(np.int32),
                               device=card)
    on = np.ones((6, 6), np.int32)
    on[::2, 1:-1] = 0
    c["layer_on"] = torch.as_tensor(on, device=card)
    c["slot"][:5] = torch.as_tensor([6, -1, 999, -2 ** 31, 2 ** 31 - 1],
                                    dtype=torch.int32, device=card)
    kw = _kw(5)
    lane = 8 if variant == "int8" else None
    got = fmlp.fixedpoint_mlp(**c, **kw, variant=variant)
    want = fused_mlp_warp_ref(**c, **kw, lane_bits=lane)
    masked = ops.fused_mlp(c["x_q"], c["slot"], c["w"], c["b"], c["act"],
                           c["layer_on"], backend="ref", variant=variant, **kw)
    gather = fused_mlp_gather_ref(
        c["x_q"][5:], c["slot"][5:], c["w"], c["b"], c["act"], c["layer_on"],
        **kw, lane_bits=lane)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, masked)
    assert torch.equal(got[5:], gather)


def test_kernel_rejects_bad_arguments(card):
    c = _case(0, card, 8, 2, 2, 8, "int16")
    kw = _kw()
    with pytest.raises(TypeError):
        fmlp.fixedpoint_mlp(**c, **kw, variant="int8")  # int16 weights
    with pytest.raises(ValueError):
        fmlp.fixedpoint_mlp(**dict(c, x_q=c["x_q"].t().contiguous().t()),
                            **kw)  # not contiguous
    with pytest.raises(ValueError):
        fmlp.fixedpoint_mlp(**dict(c, slot=c["slot"].cpu()), **kw)


@pytest.mark.parametrize("variant,weight_bits", [("int16", 16), ("int8", 8)])
def test_packet_server_on_card_matches_cpu_port(card, variant, weight_bits):
    rng = np.random.default_rng(1)
    kw = dict(max_models=4, max_layers=3, max_width=16, ingress_batch=128,
              weight_bits=weight_bits, kernel_variant=variant)
    servers = [PacketServer(device=card, **kw), PacketServer(device="cpu", **kw)]
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        for s in servers:
            s.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                      final_activation="hard_sigmoid")
    feats = rng.integers(-500, 500, (1000, 16)).astype(np.int32)
    mids = rng.integers(0, 6, 1000).astype(np.int32)
    rows = encode_packets_np(mids, FRAC, feats)
    outs = []
    for s in servers:
        for i in range(0, 1000, 77):
            s.submit_packets(rows[i: i + 77])
        outs.append(np.stack(s.drain_packets()))
        np.testing.assert_array_equal(np.asarray(s.process(rows[:100])),
                                      np.asarray(servers[1].process(rows[:100])))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_batch_device_time_from_its_own_events(card):
    """Each batch's time between its own timing events (summed into
    ``engine_batch_device_seconds_total``) is above zero and at most the
    host's dispatch→retire interval; the tracer's ``device_s`` is that
    device time, at most the same interval, and its device_done stamp
    never follows the retire."""
    rng = np.random.default_rng(2)
    srv = PacketServer(device=card, max_models=4, max_layers=3,
                       max_width=16, ingress_batch=128, trace_every=1)
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        srv.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                    final_activation="hard_sigmoid")
    pipe = srv.ingress
    retire = pipe._retire_oldest
    batches = []

    def timed_retire():
        rec = pipe._inflight[0]
        before = pipe._c_device.value
        retire()
        batches.append((pipe._c_device.value - before,
                        pipe.stages.last - rec.t_issue))

    pipe._retire_oldest = timed_retire
    feats = rng.integers(-500, 500, (2000, 16)).astype(np.int32)
    rows = encode_packets_np(rng.integers(1, 5, 2000).astype(np.int32),
                             FRAC, feats)
    for i in range(0, 2000, 111):
        srv.submit_packets(rows[i: i + 111])
    assert len(srv.drain_packets()) == 2000
    assert len(batches) == pipe.stats["ingress_batches_total"] > 1
    for dev, host in batches:
        assert 0.0 < dev <= host
    snap = srv.obs.registry.snapshot()
    assert snap["engine_batch_device_seconds_total"]['shard="0"'] == \
        pytest.approx(sum(d for d, _ in batches))
    spans = [s for s in srv.obs.spans() if "device_s" in s]
    assert spans
    longest = max(h for _, h in batches)
    for s in spans:
        assert 0.0 < s["device_s"] <= s["retire"] - s["dispatch"]
        assert s["device_s"] <= longest and s["drain_s"] >= 0.0
        assert any(abs(s["device_s"] - d) <= 1e-9 for d, _ in batches)


def test_result_cache_native_on_card_matches_cpu_port(card, monkeypatch):
    """On the card's host the result cache probes natively
    (``cache_native`` 1); its egress on a trace of repeats, drained
    mid-trace so later repeats hit the cache, is byte-identical to a CPU
    server's that runs the plain sweeps."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(5)
    kw = dict(max_models=4, max_layers=3, max_width=16, ingress_batch=128)
    servers = [PacketServer(device=card, **kw)]
    monkeypatch.setattr(_build, "_cxx", lambda: None)
    monkeypatch.setattr(_build, "_libs", {})
    servers.append(PacketServer(device="cpu", **kw))
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        for s in servers:
            s.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                      final_activation="hard_sigmoid")
    uniq = encode_packets_np(rng.integers(0, 6, 400).astype(np.int32), FRAC,
                             rng.integers(-500, 500, (400, 16)
                                          ).astype(np.int32))
    rows = uniq[rng.integers(0, 400, 3000)]
    outs = []
    for s in servers:
        out = []
        for i in range(0, 3000, 101):
            s.submit_packets(rows[i: i + 101])
            if i % 505 == 0:
                out += s.drain_packets()
        outs.append(np.stack(out + s.drain_packets()))
    snaps = [s.obs.registry.snapshot() for s in servers]
    assert [s["cache_native"]['shard="0"'] for s in snaps] == [1.0, 0.0]
    assert servers[0].ingress.cache.hits > 0
    np.testing.assert_array_equal(outs[0], outs[1])


def test_quickstart_example_runs_on_card(card):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "pt_quickstart.py"
    spec = importlib.util.spec_from_file_location("pt_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main("cuda")
    assert res["recompiles"] == 1 and res["nmse"] < 0.15


@pytest.mark.parametrize("n_batch", [1, 127, 2048, 4099])
@pytest.mark.parametrize("extent", [(8, 16, 64, 32, 6, 31, 32),
                                    (3, 5, 16, 8, 4, 7, 8)])
def test_forest_kernels_equal_plain_versions(card, n_batch, extent):
    """Both forest kernels against the gather and masked plain versions at
    the serving extents (F=8, T=16, N=64, W=32, depth 6, NI=31, L=32) and a
    small one, with mixed modes, ragged tree_on and full-range codes."""
    n_forests, n_trees, n_nodes, width, depth, ni, nl = extent
    rng = np.random.default_rng(n_batch + width)
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    ranges = stack_ranges(nodes, tree_on, depth, n_entries=ni, n_leaves=nl)
    x = rng.integers(-1000, 1000, (n_batch, width)).astype(np.int32)
    x[rng.random(n_batch) < 0.1] = np.iinfo(np.int32).max
    slot = rng.integers(0, n_forests, n_batch).astype(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=card)

    x, slot, nodes, tree_on, mode = map(t, (x, slot, nodes, tree_on, mode))
    ranges = [t(a) for a in ranges]
    before = dict(ftk.launches)
    chase = ftk.forest_traverse(x, slot, nodes, tree_on, mode,
                                max_depth=depth, frac=FRAC)
    rng_out = ftk.forest_range(x, slot, *ranges, tree_on, mode, frac=FRAC)
    assert ftk.launches == {"chase": before["chase"] + 1,
                            "range": before["range"] + 1}
    kw = dict(max_depth=depth, frac=FRAC, backend="ref", ranges=ranges)
    want_chase = [forest_traverse_gather_ref(x, slot, nodes, tree_on, mode,
                                             max_depth=depth, frac=FRAC),
                  ops.forest_traverse(x, slot, nodes, tree_on, mode, **kw)]
    want_range = [forest_range_gather_ref(x, slot, *ranges, tree_on, mode,
                                          frac=FRAC),
                  ops.forest_traverse(x, slot, nodes, tree_on, mode, **kw,
                                      variant="range")]
    torch.cuda.synchronize()
    for w in want_chase:
        assert torch.equal(chase, w)
    for w in want_range:
        assert torch.equal(rng_out, w)


def _forest_tables(rng, extent):
    """Random tables at ``extent``; range tables of shallower trees where
    the chase's trees have more leaves than the 32-bit leaf mask holds."""
    n_forests, n_trees, n_nodes, width, depth, ni, nl = extent
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    try:
        ranges = stack_ranges(nodes, tree_on, depth, n_entries=ni,
                              n_leaves=nl)
    except ValueError:
        shallow, on2, _ = random_forest_tables(
            rng, n_forests, width, 5, n_trees=n_trees, n_nodes=n_nodes)
        ranges = stack_ranges(shallow, on2, 5, n_entries=ni, n_leaves=nl)
    return nodes, tree_on, mode, ranges


def _forest_run(card, x, slot, nodes, tree_on, mode, ranges, depth, *,
                gather=True):
    """Both kernels on the card, one launch each, against the masked plain
    versions (and the gather ones when ``gather``); the inputs must come
    back unmodified."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=card)

    args = [t(a) for a in (x, slot, nodes, tree_on, mode)]
    rng_t = [t(a) for a in ranges]
    before_in = [a.clone() for a in args + rng_t]
    before = dict(ftk.launches)
    got = {"chase": ftk.forest_traverse(*args, max_depth=depth, frac=FRAC),
           "range": ftk.forest_range(*args[:2], *rng_t, *args[3:],
                                     frac=FRAC)}
    assert ftk.launches == {v: before[v] + 1 for v in ftk.FOREST_VARIANTS}
    kw = dict(max_depth=depth, frac=FRAC, backend="ref", ranges=rng_t)
    want = {v: [ops.forest_traverse(*args, **kw, variant=v)]
            for v in ("chase", "range")}
    if gather:
        want["chase"].append(forest_traverse_gather_ref(
            *args, max_depth=depth, frac=FRAC))
        want["range"].append(forest_range_gather_ref(
            *args[:2], *rng_t, *args[3:], frac=FRAC))
    torch.cuda.synchronize()
    for v in got:
        for w in want[v]:
            assert torch.equal(got[v], w), v
    for a, b in zip(args + rng_t, before_in):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("slots", ["uniform", "one_forest"])
@pytest.mark.parametrize("extent", [
    (4, 1, 16, 32, 4, 7, 8), (4, 15, 16, 32, 5, 31, 32),
    (4, 16, 16, 32, 5, 31, 32), (4, 17, 16, 32, 5, 31, 32),
    (3, 32, 16, 32, 4, 7, 8), (3, 33, 16, 32, 4, 7, 8),
    (2, 64, 16, 32, 4, 1, 8), (8, 16, 64, 32, 6, 31, 32),
    (2, 16, 64, 128, 6, 31, 32), (2, 16, 64, 33, 6, 7, 8)])
def test_forest_kernels_at_lane_edges(card, extent, slots):
    """The range lane split changes at T = 16 and T = 32 (the chase's trees
    go in steps of 32); NI = 31 and depth 6 are compiled in, the others run
    the run-time loops; W = 33 and 128 take more than one output column per
    lane."""
    n_forests, n_trees, n_nodes, width, depth, ni, nl = extent
    rng = np.random.default_rng(n_trees * 1000 + width + len(slots))
    nodes, tree_on, mode, ranges = _forest_tables(rng, extent)
    assert ftk.plan(2049, n_trees, ranges[0].shape[-1], nl, 132).staged
    for n_batch in (1, 2049):
        x = rng.integers(-1000, 1000, (n_batch, width)).astype(np.int32)
        slot = (rng.integers(0, n_forests, n_batch) if slots == "uniform"
                else np.full(n_batch, n_forests - 1)).astype(np.int32)
        _forest_run(card, x, slot, nodes, tree_on, mode, ranges, depth)


@pytest.mark.parametrize("extent", [(2, 64, 256, 32, 8, 31, 32),
                                    (2, 128, 64, 32, 6, 31, 32)])
def test_forest_kernels_tables_beyond_shared_memory(card, extent):
    """Range tables past the staging limit (T = 128) take the global-memory
    path of the same kernel, the plan says so from the sizes alone; the
    chase at N = 256 and depth 8 (run-time depth)."""
    n_forests, n_trees, n_nodes, width, depth, ni, nl = extent
    rng = np.random.default_rng(n_trees + n_nodes)
    nodes, tree_on, mode, ranges = _forest_tables(rng, extent)
    staged = ftk.plan(2048, n_trees, ranges[0].shape[-1], nl, 132).staged
    assert staged == (n_trees <= 64)
    for n_batch, slots in ((2048, "uniform"), (300, "one_forest")):
        x = rng.integers(-1000, 1000, (n_batch, width)).astype(np.int32)
        slot = (rng.integers(0, n_forests, n_batch) if slots == "uniform"
                else np.zeros(n_batch)).astype(np.int32)
        _forest_run(card, x, slot, nodes, tree_on, mode, ranges, depth)


def test_forest_kernels_large_batch(card):
    """B = 50000: the range plan's chunk past 256 packets a block (16 warps
    serving each chunk in turns), slots uniform and on one forest."""
    rng = np.random.default_rng(9)
    extent = (8, 16, 64, 32, 6, 31, 32)
    nodes, tree_on, mode, ranges = _forest_tables(rng, extent)
    assert ftk.plan(50_000, 16, ranges[0].shape[-1], 32, 132).chunk == 512
    x = rng.integers(-1000, 1000, (50_000, 32)).astype(np.int32)
    for slot in (rng.integers(0, 8, 50_000), np.full(50_000, 3)):
        _forest_run(card, x, slot.astype(np.int32), nodes, tree_on, mode,
                    ranges, 6)


@pytest.mark.parametrize("n_trees", [1, 16, 17, 33])
def test_forest_kernels_on_rejected_tables_and_slots(card, n_trees):
    """Tables install_forest rejects, and slots outside [0, F) (zero rows),
    against the masked forms, which define them."""
    rng = np.random.default_rng(40 + n_trees)
    n_forests, width, depth, n_nodes = 5, 32, 5, 32
    nodes, tree_on, mode, ranges = rejected_tables(
        rng, n_forests, n_trees, n_nodes, width, depth, 15, 16)
    for n_batch in (7, 2048, 4099):
        x = rng.integers(-800, 800, (n_batch, width)).astype(np.int32)
        slot = rng.integers(-3, n_forests + 3, n_batch).astype(np.int32)
        slot[:2] = [-(2 ** 31), 2 ** 31 - 1]
        got = _forest_run(card, x, slot, nodes, tree_on, mode, ranges,
                          depth, gather=False)
        outside = torch.as_tensor((slot < 0) | (slot >= n_forests),
                                  device=card)
        for v in got:
            assert not got[v][outside].any()


def test_forest_kernels_all_slots_outside(card):
    """A batch whose every slot lies outside [0, F): one launch each, all
    rows zero."""
    rng = np.random.default_rng(3)
    extent = (3, 16, 16, 32, 4, 7, 8)
    nodes, tree_on, mode, ranges = _forest_tables(rng, extent)
    x = rng.integers(-800, 800, (500, 32)).astype(np.int32)
    slot = np.full(500, 3, np.int32)
    got = _forest_run(card, x, slot, nodes, tree_on, mode, ranges, 4,
                      gather=False)
    for v in got:
        assert not got[v].any()


def test_forest_library_constants_match_wrapper(card):
    lib = ftk.load_library()
    assert lib.forest_max_width() == ftk.MAX_WIDTH
    assert lib.forest_stage_limit() == ftk.STAGE_LIMIT


def test_forest_kernels_reject_bad_arguments(card):
    nodes = torch.zeros((2, 3, 5, 5), dtype=torch.int32, device=card)
    on = torch.ones((2, 3), dtype=torch.int32, device=card)
    mode = torch.zeros(2, dtype=torch.int32, device=card)
    x = torch.zeros((4, 8), dtype=torch.int32, device=card)
    slot = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        ftk.forest_traverse(x, slot.long(), nodes, on, mode, max_depth=2,
                            frac=FRAC)
    with pytest.raises(ValueError):
        ftk.forest_traverse(x, slot, nodes.cpu(), on, mode, max_depth=2,
                            frac=FRAC)
    big = torch.zeros((2, 3, 33), dtype=torch.int32, device=card)
    feat = torch.zeros((2, 3, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="32"):
        ftk.forest_range(x, slot, feat, feat, feat, big, on, mode, frac=FRAC)


def _forests(width=16):
    out = {}
    for k in range(3):
        rng = np.random.default_rng(100 + k)
        data, task = ((anomaly_dataset, "classify") if k % 2 == 0
                      else (qos_dataset, "regress"))
        X, y = data(rng, 600, width)
        out[5 + k] = train_forest(X, y, task=task, n_trees=4, max_depth=4,
                                  max_nodes=31, seed=200 + k)
    return out


@pytest.mark.parametrize("variant", ["range", "chase"])
def test_mixed_packet_server_on_card_matches_cpu_port(card, variant):
    rng = np.random.default_rng(2)
    kw = dict(max_models=4, max_layers=3, max_width=16, ingress_batch=128,
              max_forests=4, max_trees=4, max_nodes=31, max_tree_depth=4,
              forest_variant=variant)
    servers = [PacketServer(device=card, **kw),
               PacketServer(device="cpu", **kw)]
    forests = _forests()
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        for s in servers:
            s.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                      final_activation="hard_sigmoid")
    for s in servers:
        for mid, f in forests.items():
            s.install_forest(mid, f)
        s.engine.warm(128, HEADER_BYTES + 4 * 16,
                      lanes=("mlp", "forest", "both"))
    feats = rng.integers(-500, 500, (3000, 16)).astype(np.int32)
    mids = rng.integers(0, 9, 3000).astype(np.int32)
    rows = encode_packets_np(mids, FRAC, feats)
    outs, before = [], dict(ftk.launches)
    for s in servers:
        rc = None
        for i in range(0, 3000, 77):
            if i == 1540:
                rc = s.stats()["recompiles"]
                s.install_forest(5, forests[7])
            s.submit_packets(rows[i: i + 77])
        outs.append(np.stack(s.drain_packets()))
        assert s.stats()["recompiles"] == rc
        lanes = s.ingress.stats["lane_batches"]
        assert lanes["mlp"] > 0 and lanes["forest"] > 0
    assert ftk.launches[variant] > before[variant]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_forest_example_runs_on_card(card):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "pt_forest_anomaly.py"
    spec = importlib.util.spec_from_file_location("pt_forest_anomaly", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main("cuda")
    assert res["recompiles"] == 1 and res["acc"] > 0.9


FLOW_KW = dict(frac=FRAC, ewma_shift=3, byte_shift=6, dur_shift=10)


def _flow_case(rng, n, n_slots, cms_shape, case):
    """The flow kernel's phase-3 cases (``chip_smoke.py``) at small sizes."""
    state = np.zeros((n_slots, 8), np.int32)
    pre = int(rng.integers(0, n_slots + 1))
    state[:pre] = rng.integers(0, 5000, (pre, 8))
    state[:pre, 0] = rng.integers(0, 5, pre)
    cms = rng.integers(0, 100, cms_shape).astype(np.int32)
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    cells = rng.integers(0, cms_shape[1], (n, cms_shape[0])).astype(np.int32)
    ts = np.cumsum(rng.integers(0, 100, n)).astype(np.int32)
    length = rng.integers(0, 2000, n).astype(np.int32)
    live = np.ones(n, np.int32)
    if case == "one_flow":
        slots[:] = n_slots // 2
    elif case == "distinct":
        slots = rng.permutation(n_slots)[:n].astype(np.int32)
    elif case == "dead":
        live = (rng.random(n) > 0.15).astype(np.int32)
    elif case == "dead_interleaved":
        live[1::2] = 0
    elif case == "one_cell":
        cells[:] = cells[0]
    elif case == "non_monotone":
        ts = rng.integers(0, 10 ** 6, n).astype(np.int32)
    elif case == "saturation":
        state[:] = [FLOW_CODE_MAX - 1, FLOW_CODE_MAX - 1, 0, 0, FLOW_CODE_MAX,
                    FLOW_CODE_MAX, 1, FLOW_CODE_MAX >> FRAC]
        cms[:] = FLOW_CODE_MAX - 1
        ts[:] = 2 ** 31 - 1
        length[:] = 65535
    return state, cms, slots, cells, ts, length, live


# batches of one packet, of sizes that are no multiple of the links kernel's
# 8 packets or the update kernel's 32, and of 8193 packets
@pytest.mark.parametrize("case", ["random", "one_flow", "distinct", "dead",
                                  "dead_interleaved", "one_cell",
                                  "non_monotone", "saturation"])
@pytest.mark.parametrize("n,n_slots,cms_shape", [(1, 64, (2, 4096)),
                                                 (127, 256, (3, 64)),
                                                 (60, 16384, (2, 4096)),
                                                 (300, 512, (3, 64)),
                                                 (1001, 2048, (8, 16)),
                                                 (8193, 16384, (2, 4096))])
def test_flow_kernel_equals_plain_version(card, case, n, n_slots, cms_shape):
    rng = np.random.default_rng(n + n_slots)
    host = _flow_case(rng, n, n_slots, cms_shape, case)
    args = [torch.as_tensor(a, device=card) for a in host]
    before = fuk.launches["flow_update"]
    got = fuk.flow_update_kernel(*args, **FLOW_KW)
    assert fuk.launches["flow_update"] == before + 1
    want = flow_update_ref(*args, **FLOW_KW)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, t in zip(host, args):  # the inputs are not modified
        np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_flow_kernel_empty_batch_and_bad_arguments(card):
    state = torch.zeros((8, 8), dtype=torch.int32, device=card)
    cms = torch.zeros((2, 16), dtype=torch.int32, device=card)
    z = torch.zeros(0, dtype=torch.int32, device=card)
    before = fuk.launches["flow_update"]
    s2, c2, f2 = fuk.flow_update_kernel(state, cms, z, z.reshape(0, 2), z, z,
                                        z, **FLOW_KW)
    assert fuk.launches["flow_update"] == before
    assert torch.equal(s2, state) and f2.shape == (0, 8)
    one = torch.ones(4, dtype=torch.int32, device=card)
    cells = torch.zeros((4, 2), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="slot"):
        fuk.flow_update_kernel(state, cms, one * 8, cells, one, one, one,
                               **FLOW_KW)
    with pytest.raises(ValueError, match="cell"):
        fuk.flow_update_kernel(state, cms, one, cells + 16, one, one, one,
                               **FLOW_KW)
    # both ran and skipped the packets they refused
    assert fuk.launches["flow_update"] == before + 2
    with pytest.raises(TypeError):
        fuk.flow_update_kernel(state, cms, one.long(), cells, one, one, one,
                               **FLOW_KW)
    with pytest.raises(ValueError, match="card"):
        ops.flow_update(*(t.cpu() for t in (state, cms, one, cells, one,
                                             one, one)),
                        backend="kernel", **FLOW_KW)
    assert fuk.launches["flow_update"] == before + 2


def _flow_servers(card, **extra):
    kw = dict(max_models=4, max_layers=3, max_width=16, ingress_batch=128,
              max_forests=4, max_trees=4, max_nodes=31, max_tree_depth=4,
              **extra)
    servers = [PacketServer(device=card, **kw),
               PacketServer(device="cpu", **kw)]
    rng = np.random.default_rng(3)
    forests = _forests()
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        for s in servers:
            s.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                      final_activation="hard_sigmoid")
    for s in servers:
        for mid, f in forests.items():
            s.install_forest(mid, f)
        for mid in (1, 2, 3, 4):
            s.install_feature_spec(mid, (2, 3, 4, 5) * 4)
        for mid in forests:
            s.install_feature_spec(mid, (4, 5, 2, 3, 0, 7, 1, 6))
    return servers


def test_submit_raw_on_card_matches_cpu_port(card):
    servers = _flow_servers(card, strict_model_ids=True)
    raw = raw_trace(np.random.default_rng(4), 3000, n_flows=200,
                    model_ids=(1, 5, 2, 6, 3, 7, 4, 999), pattern="mixed")
    before = fuk.launches["flow_update"]
    outs = []
    for s in servers:
        for i in range(0, 3000, 233):
            s.submit_raw(raw[i: i + 233])
        outs.append([o.tobytes() if isinstance(o, np.ndarray) else o.reason
                     for o in s.drain_packets()])
    assert fuk.launches["flow_update"] > before
    assert outs[0] == outs[1]
    np.testing.assert_array_equal(servers[0].flow.table.registers,
                                  servers[1].flow.table.registers)
    np.testing.assert_array_equal(servers[0].flow.cms, servers[1].flow.cms)


def test_serve_raw_fused_on_card_matches_staged_path(card):
    fused, staged = (_flow_servers(card)[0], _flow_servers(card)[0])
    rng = np.random.default_rng(5)
    for _ in range(3):
        raw = raw_trace(rng, 500, n_flows=64, model_ids=(1, 5, 2, 6),
                        pattern="mixed")
        staged.submit_raw(raw)
        want = np.stack(staged.drain_packets())
        got = fused.flow.serve_raw_fused(raw)
        np.testing.assert_array_equal(got[:, : want.shape[1]], want)
    np.testing.assert_array_equal(fused.flow.table.registers,
                                  staged.flow.table.registers)


# ---------------------------------------------------------------------------
# the W8A8 GEMM and the Taylor activation (C1/C2)
# ---------------------------------------------------------------------------


def _gemm_case(rng, m, k, n, dev):
    if k == 0:  # nothing to take an absmax over: zero-depth codes, unit scales
        return (torch.zeros((m, 0), dtype=torch.int8, device=dev),
                torch.zeros((0, n), dtype=torch.int8, device=dev),
                torch.ones((m, 1), device=dev), torch.ones((1, n), device=dev))
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    xc, xs = tq.absmax_quantize(x, axis=-1)
    wc, ws = tq.absmax_quantize(w, axis=0)
    return xc, wc, xs, ws


@pytest.mark.parametrize("m,k,n", [(1, 1536, 1536), (17, 1536, 256),
                                   (255, 1536, 8960), (2048, 8960, 1536),
                                   (100, 300, 50), (257, 513, 129),
                                   (1, 512, 7), (0, 64, 32), (5, 0, 7),
                                   (3, 16, 0)])
def test_fixedpoint_matmul_kernel_equals_plain_version(card, m, k, n):
    xc, wc, xs, ws = _gemm_case(np.random.default_rng(m + k + n), m, k, n,
                                card)
    before = fmm.launches["fixedpoint_matmul"]
    got = fmm.fixedpoint_matmul(xc, wc, xs, ws)
    launched = m > 0 and n > 0
    assert fmm.launches["fixedpoint_matmul"] == before + launched
    want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
    torch.cuda.synchronize()
    assert got.shape == (m, n) and torch.equal(got, want)


@pytest.mark.parametrize("k", [512, 1536, 8960])
def test_fixedpoint_matmul_int32_accumulator_exact(card, k):
    """Raw codes over the whole int8 range at unit scales: the output is
    the int32 accumulator rounded to float32, equal to the int64 product's."""
    rng = np.random.default_rng(k)
    xc = rng.integers(-128, 128, (255, k)).astype(np.int8)
    wc = rng.integers(-128, 128, (k, 129)).astype(np.int8)
    xc[0] = -128
    wc[:, 0] = -128
    exact = torch.as_tensor(xc.astype(np.int64) @ wc.astype(np.int64))
    got = fmm.fixedpoint_matmul(
        torch.as_tensor(xc, device=card), torch.as_tensor(wc, device=card),
        torch.ones((255, 1), device=card), torch.ones((1, 129), device=card))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), exact.to(torch.float32))


def test_w8a8_layer_path_on_card_matches_cpu_port(card):
    rng = np.random.default_rng(7)
    params = {"attn": {"wq": {"w": rng.normal(size=(96, 64)).astype(np.float32),
                              "b": np.zeros(64, np.float32)}},
              "mlp": [{"w": rng.normal(size=(96, 40)).astype(np.float32)}],
              "norm": {"scale": np.ones(96, np.float32)}}
    x = rng.normal(size=(3, 17, 96)).astype(np.float32)
    outs = []
    for dev in (card, torch.device("cpu")):
        tree = _to(params, dev)
        q = tq.quantize_tree(tree)
        assert q["norm"]["scale"].is_floating_point()
        xt = torch.as_tensor(x, device=dev)
        before = fmm.launches["fixedpoint_matmul"]
        copies = fmm.relayouts["fixedpoint_matmul"]
        ys = [tq.matmul(xt, q["attn"]["wq"]["w"], "w8a8_int"),
              tq.matmul(xt.to(torch.bfloat16), q["mlp"][0]["w"], "w8a8_int"),
              tq.QuantizedLinear(tree["mlp"][0]["w"], device=dev)(xt)]
        assert fmm.launches["fixedpoint_matmul"] == before + 3 * (dev == card)
        assert fmm.relayouts["fixedpoint_matmul"] == copies  # K-major codes
        outs.append([y.cpu() for y in ys])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return torch.as_tensor(tree, device=dev)


def test_fixedpoint_matmul_rejects_bad_arguments(card):
    xc, wc, xs, ws = _gemm_case(np.random.default_rng(0), 4, 32, 8, card)
    before = fmm.launches["fixedpoint_matmul"]
    with pytest.raises(TypeError):
        fmm.fixedpoint_matmul(xc.to(torch.int16), wc, xs, ws)
    with pytest.raises(ValueError):
        fmm.fixedpoint_matmul(xc, wc.cpu(), xs, ws)
    with pytest.raises(ValueError):
        fmm.fixedpoint_matmul(xc, wc[:16], xs, ws)
    with pytest.raises(ValueError, match="K-major"):  # neither layout
        fmm.fixedpoint_matmul(xc, torch.cat([wc, wc], 1)[:, :8], xs, ws)
    with pytest.raises(ValueError, match="split"):  # 1 K step: no split
        fmm.run_split(xc, wc, xs, ws, 2)
    with pytest.raises(ValueError, match="card"):
        ops.fixedpoint_matmul(xc.cpu(), wc.cpu(), xs.cpu(), ws.cpu(),
                              backend="kernel")
    assert fmm.launches["fixedpoint_matmul"] == before
    # a K-major w (strides (1, K), as quantize_tree stores codes) is taken
    # as it is, and gives the same bits
    km = wc.t().contiguous().t()
    copies = fmm.relayouts["fixedpoint_matmul"]
    got = fmm.fixedpoint_matmul(xc, km, xs, ws)
    assert fmm.relayouts["fixedpoint_matmul"] == copies
    assert torch.equal(got, ops.fixedpoint_matmul(xc, wc, xs, ws,
                                                  backend="ref"))


# M around the 64-row wgmma slab and the 128-row tile, N tails, decode-sized
# M at the long K (split-K), and K % 16 != 0 (zero codes appended to K)
@pytest.mark.parametrize("m,k,n", [(1, 1536, 8960), (16, 1536, 1536),
                                   (17, 8960, 1536), (63, 1536, 129),
                                   (64, 8960, 1536), (65, 1536, 7),
                                   (2048, 1536, 8960), (1, 8960, 1536),
                                   (33, 200, 64), (128, 1552, 136)])
@pytest.mark.parametrize("layout", ["k_major", "row_major"])
def test_fixedpoint_matmul_dispatch_and_layouts(card, m, k, n, layout):
    xc, wc, xs, ws = _gemm_case(np.random.default_rng(m * k + n), m, k, n,
                                card)
    w = tq.k_major(wc) if layout == "k_major" else wc
    split = fmm.plan(m, n, k, card_sms(card))
    before = (fmm.launches["fixedpoint_matmul"],
              fmm.relayouts["fixedpoint_matmul"])
    got = fmm.fixedpoint_matmul(xc, w, xs, ws)
    want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert fmm.launches["fixedpoint_matmul"] == before[0] + 1
    # copies: x and w padded where K % 16 != 0, else a row-major w only
    copied = 2 if k % 16 else int(layout == "row_major")
    assert fmm.relayouts["fixedpoint_matmul"] == before[1] + copied
    if m <= 64 and k == 8960:
        assert split > 1  # decode-sized M at the long K: split-K


def test_fixedpoint_matmul_unaligned_operands(card):
    """Codes that do not start on a 16-byte boundary (TMA's) are copied to
    ones that do, and give the same bits."""
    xc, wc, xs, ws = _gemm_case(np.random.default_rng(9), 33, 1536, 129,
                                card)
    store = torch.empty(xc.numel() + 1, dtype=torch.int8, device=card)
    x_off = store[1:].view_as(xc)
    x_off.copy_(xc)
    wstore = torch.empty(wc.numel() + 1, dtype=torch.int8, device=card)
    w_off = wstore[1:].view(wc.shape[1], wc.shape[0]).t()  # K-major, offset
    w_off.copy_(wc)
    assert x_off.data_ptr() % 16 and w_off.data_ptr() % 16
    copies = fmm.relayouts["fixedpoint_matmul"]
    got = fmm.fixedpoint_matmul(x_off, w_off, xs, ws)
    want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert fmm.relayouts["fixedpoint_matmul"] == copies + 2


def card_sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("split", [1, 2, 5, 10, 35])
def test_fixedpoint_matmul_split_k_exact(card, split):
    """K = 8960 (70 K steps) on raw codes over the whole int8 range at unit
    scales, cut into ``split`` slices: every split gives the int64 product."""
    rng = np.random.default_rng(split)
    m, k, n = 255, 8960, 129
    xc = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wc = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xc[0] = -128
    wc[:, 0] = -128
    exact = torch.as_tensor(xc.astype(np.int64) @ wc.astype(np.int64))
    w = tq.k_major(torch.as_tensor(wc, device=card))
    got = fmm.run_split(torch.as_tensor(xc, device=card), w,
                        torch.ones((m, 1), device=card),
                        torch.ones((1, n), device=card), split)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), exact.to(torch.float32))


@pytest.mark.parametrize("order", [1, 3, 5, 7])
@pytest.mark.parametrize("x_frac", [0, 8, 12, 16])
@pytest.mark.parametrize("size", [1, 17, 2048 * 8960 + 3])
def test_taylor_kernel_equals_plain_version(card, order, x_frac, size):
    rng = np.random.default_rng(order * 100 + x_frac + size % 97)
    coeffs = scaled_constants("sigmoid", order, 16)
    x = torch.as_tensor(rng.integers(-2 ** 15, 2 ** 15, size).astype(np.int32),
                        device=card)  # straddles the ±(2**14 - 1) clamp
    before = tak.launches["taylor_activation"]
    got = tak.taylor_activation(x, coeffs, x_frac)
    assert tak.launches["taylor_activation"] == before + 1
    want = ops.taylor_activation(x, coeffs, x_frac, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_taylor_kernel_wraps_and_takes_any_layout(card):
    """exp constants at s=16 on x at 8 fractional bits: the Horner products
    wrap int32 (the int64 chain differs); offsets make the tensor unaligned
    for 16-byte loads, so the scalar path runs too."""
    coeffs = scaled_constants("exp", 5, 16)
    x = torch.arange(-20000, 20001, dtype=torch.int32, device=card)
    for t in (x, x[1:], x[3:-2]):
        got = tak.taylor_activation(t, coeffs, 8)
        want = ops.taylor_activation(t, coeffs, 8, backend="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    xc = torch.clamp(x.cpu(), -tak.CLAMP, tak.CLAMP).long()
    wide = torch.full_like(xc, int(coeffs[-1]))
    for c in coeffs[-2::-1]:
        p = wide * xc
        wide = ((p + torch.where(p >= 0, 128, 127)) >> 8) + int(c)
    assert not torch.equal(wide, tak.taylor_activation(x, coeffs, 8).cpu()
                           .long())


def test_taylor_kernel_empty_and_bad_arguments(card):
    coeffs = scaled_constants("sigmoid", 3, 12)
    before = tak.launches["taylor_activation"]
    out = tak.taylor_activation(torch.zeros((0, 5), dtype=torch.int32,
                                            device=card), coeffs, 12)
    assert out.shape == (0, 5) and tak.launches["taylor_activation"] == before
    x = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        tak.taylor_activation(x.long(), coeffs, 12)
    with pytest.raises(OverflowError):
        tak.taylor_activation(x, [1, 2 ** 31], 12)
    with pytest.raises(ValueError):
        tak.taylor_activation(x, coeffs, 32)
    with pytest.raises(ValueError, match="card"):
        ops.taylor_activation(x.cpu(), coeffs, 12, backend="kernel")
    assert tak.launches["taylor_activation"] == before


def test_float_helpers_on_card_match_cpu(card):
    """The elementwise float code of the C1/C2 modules gives the CPU's bits
    on the card (a Python-scalar divisor there would be multiplied by its
    reciprocal instead)."""
    from repro_torch.core import losses as tl
    from repro_torch.core import taylor as tt
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4096, 301)).astype(np.float32) * 3
    for dtype in (torch.float32, torch.bfloat16):
        for axis in (-1, 0):
            got = tq.absmax_quantize(torch.as_tensor(x, device=card).to(dtype),
                                     axis=axis)
            want = tq.absmax_quantize(torch.as_tensor(x).to(dtype), axis=axis)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
    p = torch.as_tensor(rng.random(100_000).astype(np.float32))
    assert torch.equal(tl.log_taylor3(p.to(card)).cpu(), tl.log_taylor3(p))
    v = torch.as_tensor(x[:64, :8])
    for g, w in zip(tt.taylor_attention_kernel(v.to(card), v.to(card)),
                    tt.taylor_attention_kernel(v, v)):
        assert torch.equal(g.cpu(), w)
    s = torch.as_tensor(x[0] * 4)
    assert torch.equal(tt.segmented_taylor(s.to(card), "sigmoid", 3).cpu(),
                       tt.segmented_taylor(s, "sigmoid", 3))
    # the w8a8_sim fake quant: a power-of-two step from log2, on random
    # data and on every absmax / 127 within 6 ulps of a power of two in
    # [2^-40, 2^20) (one value per row, axis=-1), where a log2 that is off
    # in the last bit changes the step (ROADMAP §3, R6)
    xs = torch.as_tensor(x)
    for axis in (None, 0, -1):
        assert torch.equal(tq._calibrated_fake_quant(xs.to(card), 8, axis).cpu(),
                           tq._calibrated_fake_quant(xs, 8, axis))
    bits = np.array([np.float32(127 * 2.0 ** k).view(np.int32)
                     for k in range(-40, 20)])
    near = (bits[:, None] + np.arange(-6, 7)[None, :]).astype(
        np.int32).view(np.float32)
    near = torch.as_tensor(near.reshape(-1, 1))
    assert torch.equal(tq._calibrated_fake_quant(near.to(card), 8, -1).cpu(),
                       tq._calibrated_fake_quant(near, 8, -1))
    for frac, total in ((6, 8), (12, 16), (16, 32)):
        assert torch.equal(fp.fake_quant(xs.to(card), frac, total).cpu(),
                           fp.fake_quant(xs, frac, total))
    for fmt, axis in ((fp.INT8, 0), (fp.INT8, 1), (fp.INT16, -1),
                      (fp.INT32, None)):
        got = fp.quantize(xs.to(card), fmt, channel_axis=axis)
        want = fp.quantize(xs, fmt, channel_axis=axis)
        assert torch.equal(got.q.cpu(), want.q)
        if axis is not None:
            assert torch.equal(got.channel_scale.cpu(), want.channel_scale)


# ---------------------------------------------------------------------------
# the WKV chunk scan (RWKV-6 prefill)
# ---------------------------------------------------------------------------


def _wkv_operands(seed, dev, bh, nc, c, d):
    """As the reference's tests make them (tests/test_wkv_kernel.py:13-19):
    tot in [0.2, 0.95], so that scaling S's columns instead of its rows
    shows."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return (t(rng.normal(size=(bh, nc, c, d)) * 0.4),
            t(rng.normal(size=(bh, nc, c, d)) * 0.4),
            t(rng.normal(size=(bh, nc, c, d))),
            t(rng.uniform(0.2, 0.95, size=(bh, nc, 1, d))),
            t(rng.normal(size=(bh, nc, c, 1)) * 0.2))


@pytest.mark.parametrize("bh,nc,c,d", [
    (2, 4, 64, 64), (1, 8, 128, 64), (4, 2, 64, 32),  # the reference's
    (160, 32, 64, 64),   # rwkv6-3b prefill, B=4 T=2048
    (3, 3, 16, 64), (2, 2, 256, 64), (1, 1, 64, 64),
    (2, 3, 37, 48), (1, 2, 1, 64), (5, 2, 200, 17),
])
def test_wkv_kernel_equals_plain_version(card, bh, nc, c, d):
    ops_ = _wkv_operands(bh * 100 + c + d, card, bh, nc, c, d)
    before = wk.launches["wkv_scan"]
    got = wk.wkv_scan(*ops_)
    torch.cuda.synchronize()
    assert wk.launches["wkv_scan"] == before + 1
    want = ops.wkv_scan(*ops_, backend="ref")
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [17, 48, 64])
@pytest.mark.parametrize("c", [1, 37, 256])
def test_wkv_kernel_designs_at_block_and_slice_edges(card, c, d):
    """Head dims at the state kernel's 16-column slices (17: a one-column
    last slice; 48, 64: whole slices) and chunks at the 64-row blocks (1,
    37: one partial block; 256: four)."""
    ops_ = _wkv_operands(c * 100 + d, card, 3, 3, c, d)
    want = ops.wkv_scan(*ops_, backend="ref")
    before = wk.launches["wkv_scan"]
    got = wk.wkv_scan(*ops_)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    assert wk.launches["wkv_scan"] == before + 1


def test_wkv_kernel_carries_state_across_chunks(card):
    a, b, v, tot, diag = _wkv_operands(7, card, 1, 3, 64, 32)
    base = wk.wkv_scan(a, b, v, tot, diag)
    b2 = b.clone()
    b2[:, 0] = 0.0  # chunk 0's keys no longer reach the state
    alt = wk.wkv_scan(a, b2, v, tot, diag)
    assert float((base[:, 1:] - alt[:, 1:]).abs().max()) > 1e-4


def test_wkv_kernel_empty_and_bad_arguments(card):
    before = wk.launches["wkv_scan"]
    empty = _wkv_operands(1, card, 0, 2, 64, 64)
    assert wk.wkv_scan(*empty).shape == (0, 2, 64, 64)
    a, b, v, tot, diag = _wkv_operands(2, card, 1, 2, 16, 32)
    with pytest.raises(TypeError):
        wk.wkv_scan(a.double(), b, v, tot, diag)
    with pytest.raises(ValueError, match="contiguous"):
        wk.wkv_scan(a, b.transpose(2, 3).contiguous().transpose(2, 3), v,
                    tot, diag)
    with pytest.raises(ValueError, match="shape"):
        wk.wkv_scan(a, b, v, tot[:, :, :, :16], diag)
    for bad in (_wkv_operands(3, card, 1, 1, 8, 65),
                _wkv_operands(3, card, 1, 1, 257, 8)):
        with pytest.raises(ValueError, match="head dim"):
            wk.wkv_scan(*bad)
    with pytest.raises(ValueError, match="card"):
        ops.wkv_scan(a.cpu(), b.cpu(), v.cpu(), tot.cpu(), diag.cpu(),
                     backend="kernel")
    assert wk.launches["wkv_scan"] == before


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    return tree.to(dev)


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("wkv", ["scan", "chunked"])
def test_rwkv6_prefill_on_card_matches_cpu_port(card, wkv):
    """A reduced float32 rwkv6 (2 layers, T=37 over chunks of 16, the last
    padded) on the card against the CPU port with the same parameters:
    1e-4 relative through the kernel (float32 throughout, summation order
    only), 1e-3 through the bf16 chunked form (an operand may round to
    the neighbouring bf16 value).  One WKV launch per layer on "scan"."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, rwkv6
    cfg = reduced(get_config("rwkv6-3b")).replace(dtype="float32",
                                                  rwkv_chunk=16)
    params = rwkv6.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 37)))
    on_card = _tree_to(params, card)
    before = wk.launches["wkv_scan"]
    got = build_model(cfg, wkv=wkv, device=card).prefill(on_card,
                                                         tokens=tok.to(card))
    torch.cuda.synchronize()
    assert wk.launches["wkv_scan"] - before == (
        cfg.n_layers if wkv == "scan" else 0)
    want = build_model(cfg, wkv=wkv, device="cpu").prefill(params, tokens=tok)
    tol = 1e-4 if wkv == "scan" else 1e-3
    assert _rel(got, want) < tol
    got_f, _ = rwkv6.forward(on_card, tok.to(card), cfg, wkv)
    want_f, _ = rwkv6.forward(params, tok, cfg, wkv)
    assert _rel(got_f, want_f) < tol


def test_lm_server_on_card_matches_cpu_port(card):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import rwkv6
    cfg = reduced(get_config("rwkv6-3b")).replace(dtype="float32")
    params = rwkv6.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6))
    srv = LMServer(cfg, batch=2, max_seq=16)  # the card by default
    srv.install("m", _tree_to(params, card))
    cpu = LMServer(cfg, batch=2, max_seq=16, device="cpu")
    cpu.install("m", params)
    np.testing.assert_array_equal(srv.generate("m", prompt, 5),
                                  cpu.generate("m", prompt, 5))
    other = rwkv6.init(torch.Generator(device=card).manual_seed(2), cfg,
                       device=card)
    srv.install("m", other)
    srv.generate("m", prompt, 3)
    assert srv.trace_count == 1


# ---------------------------------------------------------------------------
# the sharded serving fabric on the card
# ---------------------------------------------------------------------------


def _fabric_pair(card, n_shards, **extra):
    """A fabric on the card and the same fabric on the CPU, with the MLPs,
    forests and FeatureSpecs of ``_flow_servers``."""
    from repro_torch.serve import ShardedPacketServer
    kw = dict(dict(max_models=4, max_layers=3, max_width=16,
                   ingress_batch=128, max_forests=4, max_trees=4,
                   max_nodes=31, max_tree_depth=4, strict_model_ids=True),
              **extra)
    fabs = [ShardedPacketServer(n_shards=n_shards, device=card, **kw),
            ShardedPacketServer(n_shards=n_shards, device="cpu", **kw)]
    rng = np.random.default_rng(3)
    forests = _forests()
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        for f in fabs:
            f.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                      final_activation="hard_sigmoid")
    for f in fabs:
        for mid, forest in forests.items():
            f.install_forest(mid, forest)
        for mid in (1, 2, 3, 4):
            f.install_feature_spec(mid, (2, 3, 4, 5) * 4)
        for mid in forests:
            f.install_feature_spec(mid, (4, 5, 2, 3, 0, 7, 1, 6))
    return fabs


def _fabric_egress(fab):
    return [o.tobytes() if isinstance(o, np.ndarray) else o.reason
            for o in fab.drain_packets()]


def _flow_rows(fab):
    rows = {}
    for sh in fab.shards:
        if sh._flow is not None:
            snap = sh.flow.table.snapshot()
            for k, r in zip(snap["keys"], snap["registers"]):
                rows[k.tobytes()] = r.tolist()
    return rows


def test_fabric_on_card_matches_cpu_port(card):
    """2 shards on the one card against the same fabric on the CPU, 4096
    raw packets with a forest reinstall and a kill midway: egress and error
    slots, every flow's registers and the fabric's sketch equal; the flow,
    MLP and forest kernels launched; recompiles flat."""
    from repro_torch.launch.mesh import shard_devices
    assert shard_devices(3) == [torch.device("cuda", i % torch.cuda.
                                             device_count())
                                for i in range(3)]
    fabs = _fabric_pair(card, 2)
    assert all(sh.engine.device.type == "cuda" for sh in fabs[0].shards)
    raw = raw_trace(np.random.default_rng(4), 4096, n_flows=256,
                    model_ids=(1, 5, 2, 6, 3, 7, 4, 999), pattern="mixed")
    retrained = _forests()[5]
    for f in fabs:
        for sh in f.shards:
            sh.engine.warm(128, HEADER_BYTES + 4 * 16,
                           lanes=("mlp", "forest", "both"))
    rc0 = [sh.engine.trace_count for sh in fabs[0].shards]
    before = {k: dict(m.launches) for k, m in (("flow", fuk), ("mlp", fmlp),
                                                ("forest", ftk))}
    outs = []
    for f in fabs:
        for i in range(0, 4096, 300):
            if i == 2100:  # the reference's fence: flush, then install
                for sh in f.shards:
                    sh.pipeline.flush()
                f.install_forest(5, retrained)
            f.submit_raw(raw[i: i + 300])
        outs.append(_fabric_egress(f))
    assert outs[0] == outs[1]
    assert sum(isinstance(o, str) for o in outs[0]) > 0
    assert _flow_rows(fabs[0]) == _flow_rows(fabs[1])
    np.testing.assert_array_equal(fabs[0].cms, fabs[1].cms)
    assert fuk.launches["flow_update"] > before["flow"]["flow_update"]
    assert fmlp.launches["int16"] > before["mlp"]["int16"]
    assert ftk.launches["range"] > before["forest"]["range"]
    assert [sh.engine.trace_count for sh in fabs[0].shards] == rc0
    # failover on the card: the migrated flows continue as on the CPU
    for f in fabs:
        assert f.kill_shard(0, "drill") is True
        f.submit_raw(raw[:1000])
    assert _fabric_egress(fabs[0]) == _fabric_egress(fabs[1])
    assert _flow_rows(fabs[0]) == _flow_rows(fabs[1])


def test_fabric_bounded_drain_with_a_stalled_shard_on_card(card):
    """A bounded fabric drain polls shard 0's in-flight batch's completion
    event and retires it within the window, then shard 1's dispatch stalls
    past the window: its tickets come back as DRAIN_TIMEOUT slots, and the
    drain returns after the one stalled step."""
    import time
    from repro_torch.core.ingress import DRAIN_TIMEOUT, PacketError
    from repro_torch.serve import FaultPlan, FaultSpec
    fab = _fabric_pair(card, 2, ingress_batch=16)[0]
    FaultPlan([FaultSpec(site="stall", shard=1, latency=0.3,
                         count=1)]).install(fab)
    rng = np.random.default_rng(4)

    def wire(n):
        codes = rng.integers(-2000, 2000, (n, 16)).astype(np.int32)
        return encode_packets_np(np.ones(n, np.int32), FRAC, codes)

    fab.submit_packets(wire(16))    # shard 0: a full batch, in flight
    fab.submit_packets(wire(8))     # shard 1: a partial batch
    t0 = time.perf_counter()
    out = fab.drain_packets(timeout_us=50_000.0)
    assert time.perf_counter() - t0 < 1.0
    assert len(out) == 24
    assert not any(isinstance(o, PacketError) for o in out[:16])
    assert all(isinstance(o, PacketError) and o.reason == DRAIN_TIMEOUT
               for o in out[16:])
    fab.submit_packets(wire(8))     # the next window serves normally
    assert not any(isinstance(o, PacketError) for o in fab.drain_packets())


def test_reflex_confirmer_rescores_on_the_mlp_kernel(card):
    from repro_torch.serve import ReflexProgram
    servers = [PacketServer(device=d, max_width=16, ingress_batch=16,
                            max_inflight=2, queue_high_watermark=8,
                            use_cache=False) for d in (card, "cpu")]
    rng = np.random.default_rng(7)
    layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.3,
               np.zeros(16, np.float32)),
              (rng.normal(size=(16, 2)).astype(np.float32) * 0.3,
               np.zeros(2, np.float32))]
    codes = rng.integers(-2000, 2000, (64, 16)).astype(np.int32)
    wire = encode_packets_np(np.ones(64, np.int32), FRAC, codes)
    outs = []
    for s in servers:
        s.install(1, layers, ["relu"], final_activation="sigmoid")
        s.install_reflex(1, ReflexProgram.threshold(
            0, 0, on_true=(256, 0), on_false=(0, 256)))
        before = fmlp.launches["int16"]
        s.submit_packets(wire)
        outs.append([o.tobytes() for o in s.drain_packets()])
        if s.device.type == "cuda":
            assert fmlp.launches["int16"] > before
    assert outs[0] == outs[1]
    conf = [s.ingress.reflex_confirm.snapshot() for s in servers]
    assert conf[0] == conf[1] and conf[0]["pairs"] == 56


def test_serve_cli_on_card(card, tmp_path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    names = []
    for dev in ("cuda", "cpu"):
        path = tmp_path / f"{dev}.json"
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--packets",
             "2048", "--shards", "2", "--device", dev, "--metrics-json",
             str(path)], cwd=root, env=env, capture_output=True, text=True,
            timeout=300)
        assert r.returncode == 0, r.stderr
        names.append(sorted(json.loads(path.read_text())["metrics"]))
    # the card adds the one counter that needs device events
    assert names[0] == sorted(names[1] + ["engine_batch_device_seconds_total"])


# ---------------------------------------------------------------------------
# the transformer families on the card
# ---------------------------------------------------------------------------


def test_qwen2_two_layers_full_width_on_card_matches_cpu_port(card):
    """qwen2-1.5b at full width (d_model 1536, 12 × 128 heads, 2 KV heads,
    d_ff 8960, vocab 151936), 2 layers, float32: forward and prefill on
    the card against the CPU port on the same parameters, 1e-3 relative
    (summation order only), at T=64 and at T=640 (the padded flash
    route)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("qwen2-1.5b").replace(n_layers=2, dtype="float32")
    params = transformer.init(torch.Generator(device=card).manual_seed(0),
                              cfg, device=card)
    on_cpu = _tree_to(params, "cpu")
    rng = np.random.default_rng(0)
    for t in (64, 640):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, t)))
        got, _ = transformer.forward(params, tok.to(card), cfg)
        want, _ = transformer.forward(on_cpu, tok, cfg)
        assert _rel(got, want) < 1e-3
        assert _rel(transformer.prefill(params, tok.to(card), cfg),
                    transformer.prefill(on_cpu, tok, cfg)) < 1e-3


def test_quantized_transformer_prefill_launches_equal_plain(card):
    """A reduced qwen2 quantized by quantize_tree: 7 W8A8 launches per
    layer on the card, no layout copy, each output equal to the plain
    version on the operands the path gave it; logits within 2e-2 of the
    CPU port (an activation may round to the neighbouring int8 code)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, transformer
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    params = transformer.init(torch.Generator().manual_seed(1), cfg,
                              device="cpu")
    q = tq.quantize_tree(params)
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 37)))
    wrapper, calls = fmm.fixedpoint_matmul, []

    def recorded(xc, wc, xs, ws):
        out = wrapper(xc, wc, xs, ws)
        calls.append(torch.equal(out, ops.fixedpoint_matmul(
            xc, wc, xs, ws, backend="ref")))
        return out

    fmm.reset_launches()
    fmm.fixedpoint_matmul = recorded
    try:
        got = build_model(cfg, device=card).prefill(_tree_to(q, card),
                                                    tokens=tok.to(card))
    finally:
        fmm.fixedpoint_matmul = wrapper
    torch.cuda.synchronize()
    assert fmm.launches["fixedpoint_matmul"] == 7 * cfg.n_layers
    assert fmm.relayouts["fixedpoint_matmul"] == 0
    assert len(calls) == 7 * cfg.n_layers and all(calls)
    want = build_model(cfg, device="cpu").prefill(q, tokens=tok)
    assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_transformer_lm_server_on_card_matches_cpu_port(card, arch):
    """Greedy tokens on the card equal the CPU port's (float32, reduced);
    a same-structure install keeps trace_count at 1."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import transformer
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    params = transformer.init(torch.Generator().manual_seed(2), cfg,
                              device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6))
    srv = LMServer(cfg, batch=2, max_seq=16)  # the card by default
    srv.install("m", _tree_to(params, card))
    cpu = LMServer(cfg, batch=2, max_seq=16, device="cpu")
    cpu.install("m", params)
    np.testing.assert_array_equal(srv.generate("m", prompt, 5),
                                  cpu.generate("m", prompt, 5))
    srv.install("m", transformer.init(
        torch.Generator(device=card).manual_seed(3), cfg, device=card))
    srv.generate("m", prompt, 3)
    assert srv.trace_count == 1


def test_mla_absorbed_matches_expanded_on_card(card):
    """deepseek-v2's MLA (reduced, float32) on the card: the absorbed
    decode equals the expanded form within the reference's 2e-3, and both
    equal the CPU port's within 1e-4."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import mla
    cfg = reduced(get_config("deepseek-v2-236b")).replace(dtype="float32")
    p = mla.init_mla(torch.Generator().manual_seed(4), cfg)
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(2, 6, cfg.d_model)).astype(np.float32)) * 0.3
    pc = _tree_to(p, card)
    full, _ = mla.mla_attention(pc, x.to(card), cfg)
    assert _rel(full, mla.mla_attention(p, x, cfg)[0]) < 1e-4
    cache = mla.init_mla_cache(cfg, 2, 6, torch.float32, device=card)
    outs = []
    for t in range(6):
        o, cache = mla.mla_attention(pc, x[:, t:t + 1].to(card), cfg,
                                     pos=torch.full((2,), t, device=card),
                                     cache=cache)
        outs.append(o[:, 0])
    assert _rel(torch.stack(outs, 1), full) < 2e-3


def test_int8_kv_cache_decode_on_card_matches_cpu_port(card):
    """chatglm3 (reduced, float32) with the int8 KV cache: 8 decode steps
    on the card and on the CPU port; logits within 1e-4, greedy tokens
    and the cached codes equal."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer
    cfg = reduced(get_config("chatglm3-6b")).replace(dtype="float32",
                                                     kv_cache_bits=8)
    params = transformer.init(torch.Generator().manual_seed(5), cfg,
                              device="cpu")
    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)))
    runs = []
    for dev, p in ((card, _tree_to(params, card)), ("cpu", params)):
        caches = transformer.init_caches(cfg, 2, 8, device=dev)
        steps = []
        for t in range(8):
            logits, caches = transformer.decode_step(
                p, caches, tok[:, t:t + 1].to(dev),
                torch.full((2,), t, device=dev), cfg)
            steps.append(logits[:, 0].cpu())
        runs.append((torch.stack(steps, 1), caches))
    (got, gc), (want, wc) = runs
    assert _rel(got, want) < 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert torch.equal(gc["k"]["codes"].cpu(), wc["k"]["codes"])


# ---------------------------------------------------------------------------
# LM slice C on the card: the Zamba2 hybrid and the Whisper encoder–decoder
# ---------------------------------------------------------------------------


def _slice_c_model(arch, card):
    """``arch`` at full width, 2 layers (zamba2: one group of 2 Mamba-2
    layers and the shared block; whisper: 2 + 2 layers, 1500 frames),
    float32, seeded parameters on the card and a copy on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, ssm
    cfg = get_config(arch).replace(n_layers=2, dtype="float32")
    if cfg.family == "hybrid":
        cfg, mod = cfg.replace(hybrid_attn_every=2), ssm
    else:
        cfg, mod = cfg.replace(n_encoder_layers=2), encdec
    params = mod.init(torch.Generator(device=card).manual_seed(0), cfg,
                      device=card)
    return cfg, mod, params, _tree_to(params, "cpu")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-base"])
def test_slice_c_two_layers_full_width_on_card_matches_cpu_port(card, arch):
    """Forward and prefill (zamba2 at T = 100: two SSD chunks, the last one
    padded; whisper with 1500 frames) and 6 decode steps (whisper after
    ``precompute_cross``) on the card against the CPU port on the same
    parameters, 1e-3 relative (summation order only)."""
    cfg, mod, params, on_cpu = _slice_c_model(arch, card)
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 100)))
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.as_tensor(rng.normal(size=(
            2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))

    def on(dev):
        return {k: v.to(dev) for k, v in kw.items()}

    got, _ = mod.forward(params, tok.to(card), cfg, **on(card))
    want, _ = mod.forward(on_cpu, tok, cfg, **kw)
    assert _rel(got, want) < 1e-3
    assert _rel(mod.prefill(params, tok.to(card), cfg, **on(card)),
                mod.prefill(on_cpu, tok, cfg, **kw)) < 1e-3
    runs = []
    for dev, p in ((card, params), ("cpu", on_cpu)):
        caches = mod.init_caches(cfg, 2, 6, device=dev)
        if kw:
            caches = mod.precompute_cross(p, kw["frames"].to(dev), cfg,
                                          caches)
        steps = []
        for t in range(6):
            logits, caches = mod.decode_step(
                p, caches, tok[:, t:t + 1].to(dev),
                torch.full((2,), t, dtype=torch.int32, device=dev), cfg)
            steps.append(logits.cpu())
        runs.append(torch.cat(steps, 1))
    assert _rel(*runs) < 1e-3


@pytest.mark.parametrize("m", [1, 8, 8192])
@pytest.mark.parametrize("k,n", [(2560, 80), (2560, 128), (10240, 2560)])
def test_fixedpoint_matmul_slice_c_shapes_equal_plain_version(card, m, k, n):
    """zamba2's in_dt (N = 80, narrower than one 128-wide tile), in_bc
    (N = 128) and the shared MLP's down projection (K = 10240: split-K at
    decode-sized M): one launch each, equal to the plain version."""
    xc, wc, xs, ws = _gemm_case(np.random.default_rng(m + k + n), m, k, n,
                                card)
    wc = tq.k_major(wc)
    if k == 10240 and m <= 8:
        assert fmm.plan(m, n, k, 132) > 1
    before = fmm.launches["fixedpoint_matmul"]
    got = fmm.fixedpoint_matmul(xc, wc, xs, ws)
    assert fmm.launches["fixedpoint_matmul"] == before + 1
    want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
    torch.cuda.synchronize()
    assert got.shape == (m, n) and torch.equal(got, want)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-base"])
def test_quantized_slice_c_prefill_launches_equal_plain(card, arch):
    """The reduced hybrid (4 Mamba-2 layers × 5 projections + 2 shared-block
    applications × 6) and encoder–decoder (2 × 6 + 2 × 10) quantized by
    quantize_tree: 32 W8A8 launches each on the card, no layout copy, each
    output equal to the plain version on the operands the path gave it;
    logits within 2e-2 of the CPU port."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    q = tq.quantize_tree(model.init(torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 37)))
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.as_tensor(rng.normal(size=(
            2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    wrapper, calls = fmm.fixedpoint_matmul, []

    def recorded(xc, wc, xs, ws):
        out = wrapper(xc, wc, xs, ws)
        calls.append(torch.equal(out, ops.fixedpoint_matmul(
            xc, wc, xs, ws, backend="ref")))
        return out

    fmm.reset_launches()
    fmm.fixedpoint_matmul = recorded
    try:
        got = build_model(cfg, device=card).prefill(
            _tree_to(q, card), tokens=tok.to(card),
            **{k: v.to(card) for k, v in kw.items()})
    finally:
        fmm.fixedpoint_matmul = wrapper
    torch.cuda.synchronize()
    assert fmm.launches["fixedpoint_matmul"] == 32
    assert fmm.relayouts["fixedpoint_matmul"] == 0
    assert len(calls) == 32 and all(calls)
    assert _rel(got, model.prefill(q, tokens=tok, **kw)) < 2e-2


def test_zamba2_lm_server_on_card_matches_cpu_port(card):
    """Greedy tokens of the reduced hybrid (float32) on the card equal the
    CPU port's; a same-structure install keeps trace_count at 1."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import ssm
    cfg = reduced(get_config("zamba2-2.7b")).replace(dtype="float32")
    params = ssm.init(torch.Generator().manual_seed(2), cfg, device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6))
    srv = LMServer(cfg, batch=2, max_seq=16)  # the card by default
    srv.install("m", _tree_to(params, card))
    cpu = LMServer(cfg, batch=2, max_seq=16, device="cpu")
    cpu.install("m", params)
    np.testing.assert_array_equal(srv.generate("m", prompt, 5),
                                  cpu.generate("m", prompt, 5))
    srv.install("m", ssm.init(torch.Generator(device=card).manual_seed(3),
                              cfg, device=card))
    srv.generate("m", prompt, 3)
    assert srv.trace_count == 1


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

#: card vs CPU gradients, per leaf, over the leaf's largest |g|: float32
#: summation order.  RWKV-6: its chunk operands' cotangents are rounded to
#: bf16, as the reference's, so a last-bit difference upstream moves an
#: element by a bf16 step (2^-8), and the decay LoRA sums such elements
#: over the sequence (measured 2.4e-2 at full width, 2 layers)
GRAD_CARD_VS_CPU = {"rwkv6": 3e-2}
GRAD_CARD_VS_CPU_DEFAULT = 1e-3
#: MoE: the CPU replays the card's expert choices (top-k is discontinuous);
#: a token the CPU would route otherwise must be a near tie
ROUTING_TIE = 1e-6


def _loss_grads(model, params, batch):
    from repro_torch.core import tree as T
    live = T.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss_fn(live, batch)
    return loss.detach(), torch.autograd.grad(loss, T.leaves(live))


def _train_cfg(arch):
    """Full width, float32: 2 layers, zamba2 one group, whisper whole."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(dtype="float32")
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=cfg.hybrid_attn_every)
    if cfg.family == "encdec":
        return cfg
    return cfg.replace(n_layers=2)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "zamba2-2.7b", "whisper-base"])
def test_loss_gradients_full_width_on_card_match_cpu_port(card, arch):
    """``build_model(cfg).loss_fn``'s gradients on the card against the CPU
    port on the same parameters and batch, every leaf (P4: rwkv6 trains
    through its chunked form, not the kernel; MoE with the card's expert
    choices replayed on the CPU).  520 tokens where the family
    has causal attention (the flash route's backward over 2 blocks), 64
    for rwkv6 and whisper's decoder (1500 encoder frames)."""
    from repro_torch.core import tree as T
    from repro_torch.models import build_model
    cfg = _train_cfg(arch)
    model = build_model(cfg, device=card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    s = 64 if cfg.family in ("rwkv6", "encdec") else 520
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, s)),
             "labels": rng.integers(0, cfg.vocab_size, (1, s))}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    from repro_torch.models import layers as L
    own, routes, gaps = L._top_k, [], []

    def replay(x, k):  # the card's expert choices, on the CPU
        vals, idx = own(x, k)
        forced = routes.pop(0)
        differ = (idx != forced).any(-1)
        gaps.extend((vals.sum(-1) - torch.gather(x, -1, forced).sum(-1))[
            differ].tolist())
        return torch.gather(x, -1, forced), forced

    def record(x, k):
        vals, idx = own(x, k)
        routes.append(idx.cpu())
        return vals, idx

    try:
        L._top_k = record
        loss, got = _loss_grads(model, params,
                                {k: v.to(card) for k, v in batch.items()})
        L._top_k = replay
        want_loss, want = _loss_grads(build_model(cfg, device="cpu"),
                                      _tree_to(params, "cpu"), batch)
    finally:
        L._top_k = own
    assert not routes and all(g < ROUTING_TIE for g in gaps), gaps
    assert abs(float(loss) - float(want_loss)) / float(want_loss) < 1e-5
    tol = GRAD_CARD_VS_CPU.get(cfg.family, GRAD_CARD_VS_CPU_DEFAULT)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    errs = {p: _rel(g, w) for p, g, w in zip(paths, got, want)}
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(errs.values()) < tol, errs


def test_wkv_scan_refuses_autograd_on_card(card):
    """P4: on the card the WKV wrapper raises under autograd (it used to
    hand back a tensor with no grad_fn, and every time-mix projection got
    no gradient) and launches nothing; rwkv6's loss trains through the
    chunked form and reaches the time-mix projections."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import tree as T
    from repro_torch.models import build_model
    rng = np.random.default_rng(0)
    args = [torch.tensor(rng.normal(size=shape).astype(np.float32),
                         device=card)
            for shape in ((2, 2, 4, 8),) * 3 + ((2, 2, 1, 8), (2, 2, 4, 1))]
    args[1].requires_grad_()
    wk.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv_scan(*args)
    assert wk.launches["wkv_scan"] == 0
    cfg = reduced(get_config("rwkv6-3b")).replace(dtype="float32")
    model = build_model(cfg, device=card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)),
                          device=card)
    _, grads = _loss_grads(model, params, {"tokens": tok, "labels": tok})
    named = dict(zip((p for p, _ in T.leaves_with_paths(params)), grads))
    for m in ("wr", "wk", "wv", "wg"):
        assert float(named[f"['blocks']['time_mix']['{m}']['w']"].abs()
                     .max()) > 0
    assert wk.launches["wkv_scan"] == 0


@pytest.mark.parametrize("bits", [32, 8])
def test_train_steps_on_card_match_cpu_port(card, bits):
    """Five ``TrainLoop`` steps (reduced qwen2, float32, AdamW with float32
    or int8 moments) on the card and on the CPU from the same parameters
    and stream: losses within 1e-4 at step 1, 1e-3 at step 5."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import adamw
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32",
                                                     opt_state_bits=bits)
    kw = dict(lr=3e-3, warmup=2, total_steps=30, global_batch=4, seq_len=32)
    loops = {d: TrainLoop(cfg, device=d, **kw) for d in (card, "cpu")}
    p_cpu = loops["cpu"].init_state(0)["params"]
    losses = {}
    for d, loop in loops.items():
        params = _tree_to(p_cpu, d)
        opt = adamw.init(params, loop.opt_cfg)
        out = []
        for i in range(5):
            batch = {k: torch.as_tensor(v, device=d)
                     for k, v in loop.stream.batch_at(i).items()}
            params, opt, m = loop._step(params, opt, batch,
                                        torch.tensor(i, dtype=torch.int32,
                                                     device=d))
            out.append(float(m["loss"]))
        losses[str(d)] = out
    got, want = losses[str(card)], losses["cpu"]
    assert abs(got[0] - want[0]) / want[0] < 1e-4, losses
    assert abs(got[4] - want[4]) / want[4] < 1e-3, losses


def test_checkpoint_roundtrip_on_card(card, tmp_path):
    """Card tensors (float32, bfloat16, int8) saved and restored onto the
    card, bit for bit; ``save_async`` snapshots before the next update."""
    from repro_torch.checkpoint import store
    tree = {"w": torch.randn((8, 4), device=card),
            "h": torch.randn((5,), device=card).to(torch.bfloat16),
            "q": {"codes": torch.ones((3, 2), dtype=torch.int8, device=card)}}
    want = _tree_to(tree, "cpu")
    store.save_async(str(tmp_path), 2, tree)
    tree["w"].add_(1.0)
    store.wait_for_async()
    back = store.restore(str(tmp_path), 2, tree)
    assert back["w"].device == tree["w"].device
    for k, a in (("w", back["w"]), ("h", back["h"]),
                 ("q", back["q"]["codes"])):
        b = want[k] if k != "q" else want["q"]["codes"]
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_train_cli_on_card(card, capsys):
    """``python -m repro_torch.launch.train`` at its default device, the
    card: a reduced qwen2 for 3 steps, a finite final loss."""
    import json

    from repro_torch.launch.train import main
    assert main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
                 "--batch", "2", "--seq", "32"]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["steps"] == 3 and np.isfinite(last["final_loss"])


# -- LM slice E: the sharded paths on a 1 × 1 NCCL mesh ----------------------


@pytest.fixture
def nccl_mesh(card):
    """A 1-rank NCCL process group and its (1, 1) ("data", "model") mesh
    for the length of the test."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0, device_id=card)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def _sharded_prefill(model, params, tokens, mesh, cfg):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.constrain import activation_mesh
    from repro_torch.distributed.sharding import (logical_batch_sharding,
                                                  make_plan)
    dp = make_plan(params, cfg, mesh).distribute(params)
    pl = logical_batch_sharding(mesh, {"t": tokens}, tokens.shape[0])["t"]
    tok = distribute_tensor(tokens, mesh, pl, src_data_rank=None)
    with torch.no_grad(), activation_mesh(mesh), implicit_replication():
        return model.prefill(dp, tokens=tok).full_tensor()


def test_sharded_train_on_1x1_mesh_equals_unsharded(card, nccl_mesh):
    """``TrainLoop(mesh=...)`` on the card's 1 × 1 NCCL mesh: reduced
    qwen2 (flash route, T = 600), 3 steps, every loss within 1e-6 relative
    of the unsharded loop's; the parameters are DTensors on the card."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import TrainLoop
    cfg = reduced(get_config("qwen2-1.5b"))
    kw = dict(global_batch=2, seq_len=600, device=card)
    _, want = TrainLoop(cfg, **kw).run(max_steps=3, log_every=1)
    state, got = TrainLoop(cfg, mesh=nccl_mesh, **kw).run(max_steps=3,
                                                          log_every=1)
    assert isinstance(state["params"]["embed"], DTensor)
    assert state["params"]["embed"].device.type == "cuda"
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"])


def test_sharded_prefills_on_1x1_mesh_launch_kernels(card, nccl_mesh):
    """The sharded prefills on the card: reduced rwkv6 (one WKV launch a
    layer) and reduced quantized qwen2 (7 W8A8 launches a layer), logits
    ``torch.equal`` to the unsharded prefill's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    for arch, quant, kernel, per_layer in (
            ("rwkv6-3b", False, "wkv_scan", 1),
            ("qwen2-1.5b", True, "fixedpoint_matmul", 7)):
        cfg = reduced(get_config(arch))
        model = build_model(cfg, device=card)
        g = torch.Generator(device=card).manual_seed(0)
        params = model.init(g)
        if quant:
            params = tq.quantize_tree(params)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                               device=card)
        with torch.no_grad():
            want = model.prefill(params, tokens=tokens)
        mod = wk if kernel == "wkv_scan" else fmm
        mod.reset_launches()
        got = _sharded_prefill(model, params, tokens, nccl_mesh, cfg)
        torch.cuda.synchronize()
        assert mod.launches[kernel] == per_layer * cfg.n_layers, arch
        assert torch.equal(got, want), arch


def test_kernel_custom_ops_launch_and_match_plain(card):
    """``torch.ops.repro_torch.wkv_scan`` / ``.fixedpoint_matmul`` on card
    tensors launch the CUDA kernels (one count each) and equal the plain
    versions (WKV within 2e-5, the GEMM exactly)."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=card).manual_seed(1)
    bh, nc, c, d = 6, 3, 32, 64
    a, b, v = (torch.randn(bh, nc, c, d, generator=g, device=card) * 0.3
               for _ in range(3))
    tot = torch.rand(bh, nc, 1, d, generator=g, device=card)
    diag = torch.randn(bh, nc, c, 1, generator=g, device=card)
    wk.reset_launches()
    got = torch.ops.repro_torch.wkv_scan(a, b, v, tot, diag)
    assert wk.launches["wkv_scan"] == 1
    want = ref.wkv_scan_ref(a, b, v, tot, diag)
    assert float((got - want).abs().max()) < 2e-5
    m, k, n = 96, 256, 80
    xc = torch.randint(-128, 128, (m, k), generator=g, device=card,
                       dtype=torch.int8)
    wc = tq.k_major(torch.randint(-128, 128, (k, n), generator=g,
                                  device=card, dtype=torch.int8))
    xs = torch.rand(m, 1, generator=g, device=card)
    ws = torch.rand(1, n, generator=g, device=card)
    fmm.reset_launches()
    out = torch.ops.repro_torch.fixedpoint_matmul(xc, wc, xs, ws)
    assert fmm.launches["fixedpoint_matmul"] == 1
    assert torch.equal(out, ref.fixedpoint_matmul_ref(xc, wc, xs, ws))


# ---------------------------------------------------------------------------
# flash attention's forward (csrc/flash_attention.cu) against the plain form
# ---------------------------------------------------------------------------

# The kernel and the plain form (models/flash.py::_flash_fwd, 512-key blocks)
# round the same float32 quantities to the input type at the same points, but
# sum in other orders and rescale at other running maxima (128-key tiles), so
# a logit or a probability may land one unit in the last place apart: out is
# held within 4 units of the input type at 1 (bf16 2^-5, fp16 2^-8; measured
# 2^-6 and 2^-9), and no farther from float64 attention than the plain form
# (×1.05); lse, a float32 sum, within 1e-5 (measured ≤ 1e-6).
_FLASH_ATOL = {torch.bfloat16: 2.0 ** -5, torch.float16: 2.0 ** -8}


def _flash_inputs(dev, b, h, hkv, s, dqk, dv, dtype=torch.bfloat16, seed=0):
    """q (pre-scaled), k, v as the model hands them over: (B, S, H, D)
    tensors transposed to (B, H, S, D)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, dqk, generator=g, device=dev) / dqk ** 0.5
    k = torch.randn(b, s, hkv, dqk, generator=g, device=dev)
    v = torch.randn(b, s, hkv, dv, generator=g, device=dev)
    return tuple(t.to(dtype).transpose(1, 2) for t in (q, k, v))


def _exact_attention(q, k, v):
    s = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double())
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return torch.softmax(logits.masked_fill(~keep, float("-inf")), -1) \
        @ v.double()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [1, 77, 513, 1000, 2048])
@pytest.mark.parametrize("ratio", [1, 6])
@pytest.mark.parametrize("dqk,dv", fak.HEAD_DIMS)
def test_flash_kernel_matches_plain(card, dqk, dv, ratio, s, dtype):
    q, k, v = _flash_inputs(card, 2, 6, 6 // ratio, s, dqk, dv, dtype)
    fak.reset_launches()
    out, lse = fak.flash_attention_fwd(q, k, v)
    assert fak.launches["flash_attention"] == 1
    kr, vr = FL._repeat_heads(k, ratio), FL._repeat_heads(v, ratio)
    want, want_lse = FL._flash_fwd(q, kr, vr, True, 512)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == want.shape
    assert float((out.float() - want.float()).abs().max()) <= \
        _FLASH_ATOL[dtype]
    assert float((lse - want_lse).abs().max()) <= 1e-5
    exact = _exact_attention(q, kr, vr)

    def err(x):
        return float((x.double() - exact).norm() / exact.norm())

    assert err(out) <= 1.05 * err(want)


def test_flash_kernel_matches_plain_across_ragged_row_chunks(card):
    """Blocks walk the B·H (batch, head) rows in chunks of ``chunk_rows``:
    here 13 rows a chunk over 256, so the last chunk holds 9, with a ragged
    S.  Every row of out and lse (both from ``torch.empty``) is held to the
    plain form."""
    b, h, s, dqk, dv = 2, 128, 2000, 192, 128
    rows = fak.chunk_rows(b, h, h, s, dqk, dv)
    assert rows < b * h and (b * h) % rows
    q, k, v = _flash_inputs(card, b, h, h, s, dqk, dv, seed=5)
    out, lse = fak.flash_attention_fwd(q, k, v)
    want, want_lse = FL._flash_fwd(q, k, v, True, 512)
    torch.cuda.synchronize()
    d_out = (out.float() - want.float()).abs().amax(dim=(2, 3))
    d_lse = (lse - want_lse).abs().amax(dim=2)
    assert d_out.shape == d_lse.shape == (b, h)
    assert bool((d_out <= _FLASH_ATOL[torch.bfloat16]).all()), d_out.max()
    assert bool((d_lse <= 1e-5).all()), d_lse.max()


def test_flash_kernel_repeats_bit_for_bit(card):
    q, k, v = _flash_inputs(card, 2, 12, 2, 2048, 128, 128)
    out, lse = fak.flash_attention_fwd(q, k, v)
    out2, lse2 = fak.flash_attention_fwd(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dqk,dv,ratio", [(128, 128, 6), (192, 128, 1)])
def test_flash_kernel_gradients_match_plain_forward(card, dqk, dv, ratio):
    """The kernel path (its out and lse into the plain backward, the grouped
    K/V's gradients summed per group) against the plain forward's path on
    repeated K/V: every gradient within 1 % in relative L2 (the backward
    recomputes p from lse and reads delta = rowsum(dO·O) from out, both at
    the forward's bf16 level)."""
    q, k, v = _flash_inputs(card, 1, 6, 6 // ratio, 1000, dqk, dv)
    dout = torch.randn(q.shape[:3] + (dv,), device=card,
                       generator=torch.Generator(device=card).manual_seed(3)
                       ).to(q.dtype)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    FL.flash_stats.reset()
    out = FL.flash_attention(*leaves, True, 512)
    assert (FL.flash_stats.kernel, FL.flash_stats.plain) == (1, 0)
    got = torch.autograd.grad(out, leaves, dout)
    leaves2 = [t.detach().requires_grad_(True) for t in (q, k, v)]
    kr, vr = (FL._repeat_heads(t, ratio) for t in leaves2[1:])
    out2 = FL._FlashAttention.apply(leaves2[0], kr, vr, True, 512, False)
    want = torch.autograd.grad(out2, leaves2, dout)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel < 1e-2, (name, rel)


def test_flash_attention_takes_the_kernel_in_the_model(card):
    """``layers._sdpa_causal_chunked`` hands the grouped K/V over as they are:
    one kernel launch, no plain call, and the plain path's values."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("qwen2-1.5b")
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn(2, 1024, n, 128, generator=g, device=card
                           ).to(torch.bfloat16) for n in (12, 2, 2))
    FL.flash_stats.reset()
    fak.reset_launches()
    got = L._sdpa_causal_chunked(q, k, v, cfg)
    assert (FL.flash_stats.kernel, FL.flash_stats.plain) == (1, 0)
    assert fak.launches["flash_attention"] == 1
    scale = torch.full((), 128 ** -0.5, dtype=q.dtype, device=card)
    kr, vr = (L._repeat_kv(t, 6).transpose(1, 2) for t in (k, v))
    want = FL._flash_fwd((q * scale).transpose(1, 2), kr, vr, True, 512)[0]
    torch.cuda.synchronize()
    assert float((got.transpose(1, 2).float() - want.float()).abs().max()) \
        <= _FLASH_ATOL[torch.bfloat16]


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, k, v = _flash_inputs(card, 1, 4, 2, 256, 128, 128)
    bad = {
        "float32": (TypeError, (q.float(), k.float(), v.float())),
        "mixed dtypes": (TypeError, (q, k.half(), v)),
        "head dims": (ValueError, (q[..., :64], k[..., :64], v[..., :64])),
        "heads": (ValueError, (q[:, :3], k, v)),
        "lengths": (ValueError, (q, k[:, :, :128], v[:, :, :128])),
        "3-d": (ValueError, (q[0], k[0], v[0])),
        "strided D": (ValueError, (q.transpose(2, 3).contiguous()
                                   .transpose(2, 3), k, v)),
        "misaligned": (ValueError, (
            torch.zeros(1, 4, 256, 136, dtype=q.dtype,
                        device=card)[..., 1:129], k, v)),
        "cpu": (ValueError, (q.cpu(), k.cpu(), v.cpu())),
    }
    for name, (err, args) in bad.items():
        with pytest.raises(err):
            fak.flash_attention_fwd(*args)


# ---------------------------------------------------------------------------
# the W8A8 linear's activation quantize (the row kernel)
# ---------------------------------------------------------------------------


def _plain_quantize(monkeypatch, x, bits=8, axis=-1):
    """``absmax_quantize`` on the plain chain, the row kernel bypassed."""
    with monkeypatch.context() as mp:
        mp.setattr(tq, "row_kernel_applies", lambda *a: False)
        return tq.absmax_quantize(x, bits=bits, axis=axis)


def _bits(t):
    """The raw bits of a float tensor (NaN compares equal to itself)."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _rq_rows(m, k, dtype, seed):
    """Normal rows, each at its own power-of-two scale within ``dtype``'s
    range."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = (-8, 10) if dtype == torch.float16 else (-40, 40)
    e = torch.randint(lo, hi, (m, 1), generator=g).float()
    return (torch.randn(m, k, generator=g) * torch.exp2(e)).to(dtype)


def _rq_check(monkeypatch, x, bits, cpu_rows=None):
    """The kernel path once (one launch, counted as a kernel call), equal to
    the plain chain on the card bit for bit and, on ``cpu_rows`` (all rows
    by default) whose quotients hold no NaN, to the CPU's (a NaN code is
    the device's own float-to-int8 conversion)."""
    tq.quantize_stats.reset()
    before = rqk.launches["row_quantize"]
    codes, scale = tq.absmax_quantize(x, bits=bits)
    assert (tq.quantize_stats.kernel, tq.quantize_stats.plain) == (1, 0)
    assert rqk.launches["row_quantize"] == before + (x.numel() > 0)
    want_c, want_s = _plain_quantize(monkeypatch, x, bits)
    torch.cuda.synchronize()
    assert codes.shape == want_c.shape and scale.shape == want_s.shape
    assert torch.equal(codes, want_c)
    assert torch.equal(_bits(scale), _bits(want_s))
    out = codes, scale
    if x.dim() > 1:
        x, codes, scale = (t.reshape(-1, t.shape[-1]) for t in (x, codes, scale))
        if cpu_rows is not None:
            x, codes, scale = x[cpu_rows], codes[cpu_rows], scale[cpu_rows]
        keep = ~torch.isnan(x.float() / scale.float()).any(-1)
        x, codes, scale = x[keep], codes[keep], scale[keep]
    cpu_c, cpu_s = tq.absmax_quantize(x.cpu(), bits=bits)
    assert torch.equal(codes.cpu(), cpu_c) and torch.equal(scale.cpu(), cpu_s)
    return out


@pytest.mark.parametrize("bits", [4, 7, 8])
@pytest.mark.parametrize("m", [1, 3, 8192])
@pytest.mark.parametrize("k", [1, 7, 8, 1536, 8960, 8961, 12288])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_row_quantize_kernel_equals_plain_chain(card, monkeypatch, dtype, k,
                                                m, bits):
    """Codes and scales of the row kernel bit for bit against the plain
    chain on the card, and on every 64th row and the last against the
    CPU's."""
    x = _rq_rows(m, k, dtype, m * 7 + k + bits).to(card)
    rows = sorted(set(range(0, m, 64)) | {m - 1})
    _rq_check(monkeypatch, x, bits, rows)


def _edge_rows(k, dtype):
    """Rows at the edges of the chain: all zeros (scale T(1e-8)/qmax),
    magnitudes under 1e-8, quotients on k + 0.5 at scale 1 and 3 (a tie
    rint takes to the even side), codes at the ±127.5 saturation edge, a
    NaN, +inf and -inf, and a random row."""
    j = torch.arange(k, dtype=torch.float32)
    ties = (j % 255) - 127 + 0.5
    ties[0] = 127.0
    sat = torch.where(j % 2 == 0, 1.0, -1.0) * (100.0 - (j % 7) * 2 ** -6)
    sat[0] = -100.0
    nan = torch.randn(k, generator=torch.Generator().manual_seed(k))
    pinf, ninf = nan.clone(), nan.clone()
    nan[k // 2] = float("nan")
    pinf[k // 3] = float("inf")
    ninf[(2 * k) // 3] = -float("inf")
    rows = [torch.zeros(k), torch.linspace(-9e-9, 9e-9, k), ties, 3 * ties,
            sat, -sat, ties / 127 * 7, nan, pinf, ninf,
            torch.randn(k, generator=torch.Generator().manual_seed(k + 1))]
    return torch.stack(rows).to(dtype)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k", [8, 1536, 8961])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_row_quantize_kernel_edge_rows(card, monkeypatch, dtype, k, bits):
    """The edge rows on the card bit for bit against the plain chain there
    (a NaN row's scale and codes as the card's plain path gives them), the
    finite rows against the CPU too."""
    x = _edge_rows(k, dtype).to(card)
    codes, scale = _rq_check(monkeypatch, x, bits)
    floor = torch.tensor(1e-8, dtype=dtype)
    assert torch.equal(scale[0].cpu(), fp.true_divide(
        floor, 2.0 ** (bits - 1) - 1).reshape(1))
    assert torch.isnan(scale[7]).item() and torch.isinf(scale[8]).item()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_row_quantize_kernel_every_value_under_every_absmax(card, monkeypatch,
                                                            dtype, bits):
    """Every pair (x, absmax) of finite bf16 or fp16 values with
    |x| <= absmax, of either sign: a row per absmax holding every
    non-negative finite value (those above it cut to it), and its negation.
    The kernel's codes and scales equal the plain chain's on the card."""
    top = 0x7F80 if dtype == torch.bfloat16 else 0x7C00  # +inf's bits
    vals = torch.arange(top, dtype=torch.int32, device=card).to(
        torch.int16).view(dtype)
    for sign in (1, -1):
        for first in range(1, top, 4096):
            c = vals[first:first + 4096, None]
            x = sign * torch.where(vals[None, :] <= c, vals[None, :], c)
            tq.quantize_stats.reset()
            codes, scale = tq.absmax_quantize(x, bits=bits)
            assert tq.quantize_stats.kernel == 1
            want_c, want_s = _plain_quantize(monkeypatch, x, bits)
            assert torch.equal(codes, want_c), (sign, first)
            assert torch.equal(_bits(scale), _bits(want_s)), (sign, first)


@pytest.mark.parametrize("view", ["padded", "every_other_row", "odd_k",
                                  "unaligned_start", "3d_copy", "1d",
                                  "empty"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_quantize_kernel_on_strided_views(card, monkeypatch, dtype, view):
    """Row-strided views run in place (the vector form where every row
    starts 16-byte aligned, the scalar form elsewhere), leading dims that
    do not flatten to one stride through one exact copy, a 1-D row, and
    no rows at all (no launch)."""
    base = _rq_rows(24, 1552, dtype, 5).to(card)
    x = {"padded": base[:, :1536],
         "every_other_row": base[::2, :1536],
         "odd_k": base[:, :1537],
         "unaligned_start": base[:, 1:1537],
         "3d_copy": base[:, :1536].reshape(4, 6, 1536)[:, :4],
         "1d": base[5, :1536],
         "empty": base[:0, :1536]}[view]
    assert x.stride(-1) == 1
    _rq_check(monkeypatch, x, 8)


def test_row_quantize_kernel_longest_rows_and_refusals(card, monkeypatch):
    """K = MAX_K in both forms; what the kernel does not take goes to the
    plain chain from ``absmax_quantize`` and raises from the wrapper."""
    for dtype in (torch.bfloat16, torch.float32):
        x = _rq_rows(3, rqk.MAX_K + 1, dtype, 9).to(card)
        _rq_check(monkeypatch, x[:, :rqk.MAX_K].contiguous(), 8)  # vectors
        _rq_check(monkeypatch, x[:, 1:], 8)  # unaligned rows: scalar form
    x = _rq_rows(4, 64, torch.bfloat16, 1).to(card)
    bad = {"cpu": (x.cpu(), 8), "float64": (x.double(), 8),
           "bits": (x, 12), "strided last dim": (x[:, ::2], 8),
           "no columns": (x[:, :0], 8),
           "too long": (torch.zeros(1, rqk.MAX_K + 1, device=card), 8)}
    before = rqk.launches["row_quantize"]
    for name, (arg, bits) in bad.items():
        with pytest.raises(ValueError):
            rqk.row_quantize(arg, bits)
    for name in ("float64", "bits", "strided last dim", "too long"):
        arg, bits = bad[name]
        tq.quantize_stats.reset()
        got = tq.absmax_quantize(arg, bits=bits)
        assert (tq.quantize_stats.kernel, tq.quantize_stats.plain) == (0, 1)
        for g, w in zip(got, _plain_quantize(monkeypatch, arg, bits)):
            assert torch.equal(g, w)
    assert rqk.launches["row_quantize"] == before


@pytest.mark.parametrize("k,n", [(1536, 1536), (1536, 256), (1536, 8960),
                                 (8960, 1536)])
def test_w8a8_matmul_int_row_kernel_equals_bypassed(card, monkeypatch, k, n):
    """At the qwen2 cell's shapes (M = 4 · 2048, bf16 activations) the W8A8
    linear through the row kernel equals the same call on the plain
    chain."""
    g = torch.Generator(device=card).manual_seed(k + n)
    x = torch.randn(4, 2048, k, generator=g, device=card).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device=card) / k ** 0.5
    wc, ws = tq.quantize_tree({"w": w})["w"]
    tq.quantize_stats.reset()
    got = tq.w8a8_matmul_int(x, wc, ws)
    assert (tq.quantize_stats.kernel, tq.quantize_stats.plain) == (1, 0)
    with monkeypatch.context() as mp:
        mp.setattr(tq, "row_kernel_applies", lambda *a: False)
        want = tq.w8a8_matmul_int(x, wc, ws)
    torch.cuda.synchronize()
    assert got.shape == (4, 2048, n) and torch.equal(got, want)


def test_quantized_qwen2_prefill_quantizes_on_the_row_kernel(card,
                                                             monkeypatch):
    """qwen2-1.5b at full width, 2 layers, W8A8 weights: each of the 14
    activation quantizes of the prefill is a kernel call, and the logits
    equal those of the same prefill on the plain chain."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    cfg = get_config("qwen2-1.5b").replace(n_layers=2)
    params = transformer.init(torch.Generator(device=card).manual_seed(2),
                              cfg, device=card)
    q = tq.quantize_tree(params)
    del params
    tok = torch.randint(0, cfg.vocab_size, (2, 256), device=card,
                        generator=torch.Generator(device=card).manual_seed(3))
    model = build_model(cfg, device=card)
    tq.quantize_stats.reset()
    rqk.reset_launches()
    got = model.prefill(q, tokens=tok)
    assert (tq.quantize_stats.kernel, tq.quantize_stats.plain) == (14, 0)
    assert rqk.launches["row_quantize"] == 14
    with monkeypatch.context() as mp:
        mp.setattr(tq, "row_kernel_applies", lambda *a: False)
        want = model.prefill(q, tokens=tok)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# every card in one process
# ---------------------------------------------------------------------------


def test_gemm_wkv_and_flash_on_every_card_in_one_process(card):
    """One process launches the GEMM, the WKV scan and flash on each card in
    turn, with card 0 current throughout: each launch raises its kernel's
    shared-memory limit on its own card, and each result equals its plain
    version there."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip(f"needs two or more cards, found {n_cards}")
    for i in range(n_cards):
        dev = torch.device("cuda", i)
        xc, wc, xs, ws = _gemm_case(np.random.default_rng(i), 255, 1536, 512,
                                    dev)
        got = fmm.fixedpoint_matmul(xc, wc, xs, ws)
        want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
        scan = _wkv_operands(i, dev, 4, 2, 64, 64)
        got_o = wk.wkv_scan(*scan)
        want_o = ops.wkv_scan(*scan, backend="ref")
        q, k, v = _flash_inputs(dev, 1, 6, 1, 513, 128, 128, seed=i)
        out, lse = fak.flash_attention_fwd(q, k, v)
        kr, vr = FL._repeat_heads(k, 6), FL._repeat_heads(v, 6)
        want_out, want_lse = FL._flash_fwd(q, kr, vr, True, 512)
        torch.cuda.synchronize(dev)
        assert got.device == got_o.device == out.device == dev
        assert torch.equal(got, want)
        np.testing.assert_allclose(got_o.cpu().numpy(), want_o.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert float((out.float() - want_out.float()).abs().max()) <= \
            _FLASH_ATOL[torch.bfloat16]
        assert float((lse - want_lse).abs().max()) <= 1e-5
    assert torch.cuda.current_device() == 0


# ---------------------------------------------------------------------------
# the Mamba-2 SSD scan (csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------

#: relative L2 of the kernel's y and final state against the plain float32
#: ``ssm.ssd_grouped``: sums in another order read about 1e-6 (measured up to
#: 8.4e-6 with strong decays); plain TF32 products read about 1e-3, so this
#: bound is the kernel's float32 precision rule
SSD_TOL = 1e-4


def _ssd_operands(dev, b, t, h, g, p=64, n=64, dtype=torch.bfloat16,
                  strong=False, expand=False, seed=0):
    """x, B, C normal in ``dtype``; A = −1 … −H as Zamba2 initialises it;
    dt log-uniform over [1e-3, 0.1] as its dt_bias gives it, or with
    ``strong`` uniform over [0, 2] (decays down to e^-224 a step); with
    ``expand`` B and C are group 0's, expanded (stride 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
    bm = torch.randn(b, t, g, n, generator=gen, device=dev).to(dtype)
    cm = torch.randn(b, t, g, n, generator=gen, device=dev).to(dtype)
    u = torch.rand(b, t, h, generator=gen, device=dev)
    dt = 2 * u if strong else torch.exp(u * math.log(100.0) + math.log(1e-3))
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    if expand:
        bm, cm = (m[:, :, :1].expand_as(m) for m in (bm, cm))
    return x, bm, cm, dt, a


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _ssd_check(ops):
    ssk.reset_launches()
    y, state = ssk.ssd_scan(*ops)
    x, bm, cm, dt, a = ops
    want_y, want_s = ssm.ssd_grouped(x.float(), bm.float(), cm.float(), dt, a,
                                     64)
    torch.cuda.synchronize()
    assert ssk.launches["ssd_scan"] == 1
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == want_y.shape and state.shape == want_s.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    assert _rel_l2(y, want_y) <= SSD_TOL
    assert _rel_l2(state, want_s) <= SSD_TOL


@pytest.mark.parametrize("b,t,h,g", [(4, 4096, 112, 2), (1, 1, 112, 2),
                                     (4, 63, 112, 2), (1, 64, 112, 1),
                                     (4, 65, 8, 2), (1, 4097, 16, 2)])
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("expand", [False, True])
def test_ssd_kernel_matches_plain_float32(card, b, t, h, g, strong, expand):
    """The Zamba2-7B cell's per-layer shape (4 × 4096, 112 heads of 64 in 2
    groups, state 64), one position, ragged and whole chunks, one group,
    strong decays, B and C of group 0 expanded: y and the final state
    within ``SSD_TOL`` of the plain float32 form, one launch."""
    _ssd_check(_ssd_operands(card, b, t, h, g, strong=strong, expand=expand,
                             seed=t + h))


@pytest.mark.parametrize("dtype,p,n", [(torch.float32, 64, 64),
                                       (torch.float16, 64, 64),
                                       (torch.bfloat16, 40, 24),
                                       (torch.float32, 33, 17)])
def test_ssd_kernel_types_and_widths(card, dtype, p, n):
    """fp32 and fp16 operands; head dims and state sizes below 64, and ones
    that are no multiple of a 16-byte vector (the element-wise loads)."""
    _ssd_check(_ssd_operands(card, 2, 130, 6, 3, p=p, n=n, dtype=dtype,
                             strong=True, seed=p))


def test_ssd_kernel_takes_the_mixers_views_and_repeats(card):
    """x, B and C as views into one projection (the mixer's split), and the
    same call twice: bit for bit (no atomics)."""
    x, bm, cm, dt, a = _ssd_operands(card, 2, 200, 16, 2)
    b, t, h, p = x.shape
    cat = torch.cat([x.reshape(b, t, -1), bm.reshape(b, t, -1),
                     cm.reshape(b, t, -1), torch.zeros(b, t, 16, device=card,
                                                       dtype=x.dtype)], -1)
    xv, bv, cv, _ = torch.split(cat, [h * p, 128, 128, 16], -1)
    ops = (xv.reshape(x.shape), bv.reshape(bm.shape), cv.reshape(cm.shape),
           dt, a)
    assert not ops[0].is_contiguous()
    _ssd_check(ops)
    y1, s1 = ssk.ssd_scan(*ops)
    y2, s2 = ssk.ssd_scan(*ops)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, bm, cm, dt, a = _ssd_operands(card, 1, 70, 4, 2)
    bad = {"dt bf16": (x, bm, cm, dt.bfloat16(), a),
           "x and B in two types": (x.float(), bm, cm, dt, a),
           "P = 65": (torch.zeros(1, 70, 4, 65, device=card,
                                  dtype=x.dtype), bm, cm, dt, a),
           "a on the CPU": (x, bm, cm, dt, a.cpu())}
    ssk.reset_launches()
    for args in bad.values():
        with pytest.raises(ValueError):
            ssk.ssd_scan(*args)
    assert ssk.launches["ssd_scan"] == 0


def _zamba2_two_layers(card):
    """Zamba2-7B at its published widths, 2 Mamba layers and one shared
    application, float32 (so that the kernel and the plain form are held
    at the SSD's float32 tolerance)."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-7b").replace(
        n_layers=2, hybrid_layer_ids=(1,), dtype="float32",
        param_dtype="float32")
    params = Z.init(torch.Generator(device=card).manual_seed(5), cfg,
                    device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=card,
                           generator=torch.Generator(device=card
                                                     ).manual_seed(6))
    return cfg, params, tokens


@contextlib.contextmanager
def _plain_ssd():
    rule = Z.ssd_kernel_applies
    Z.ssd_kernel_applies = lambda *a: False
    try:
        yield
    finally:
        Z.ssd_kernel_applies = rule


def test_zamba2_prefill_takes_the_ssd_kernel(card):
    """Two layers at Zamba2-7B's widths: each prefill SSD on the kernel
    (2 kernel, 0 plain, 2 launches), the logits within the SSD's tolerance
    of the plain form's."""
    cfg, params, tokens = _zamba2_two_layers(card)
    Z.zamba2_stats.reset()
    ssk.reset_launches()
    with torch.no_grad():
        got = Z.prefill(params, tokens, cfg)
    assert (Z.zamba2_stats.ssd_kernel, Z.zamba2_stats.ssd_plain) == (2, 0)
    assert ssk.launches["ssd_scan"] == 2
    with torch.no_grad(), _plain_ssd():
        want = Z.prefill(params, tokens, cfg)
    assert (Z.zamba2_stats.ssd_kernel, Z.zamba2_stats.ssd_plain) == (2, 2)
    torch.cuda.synchronize()
    assert _rel_l2(got, want) <= SSD_TOL


@pytest.mark.parametrize("change", ["float64", "P = 80"])
def test_zamba2_ssd_raises_on_the_card_for_what_the_kernel_refuses(card,
                                                                   change):
    """On the card a prefill SSD the kernel does not take raises: no plain
    form behind it, nothing counted, nothing launched."""
    x, bm, cm, dt, a = _ssd_operands(card, 1, 70, 4, 2, dtype=torch.float32)
    if change == "float64":
        x, bm, cm = x.double(), bm.double(), cm.double()
    else:
        x = torch.zeros(1, 70, 4, 80, device=card)
    Z.zamba2_stats.reset()
    ssk.reset_launches()
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        Z.ssd(x, bm, cm, dt, a, Z.SSD_CHUNK)
    assert (Z.zamba2_stats.ssd_kernel, Z.zamba2_stats.ssd_plain) == (0, 0)
    assert ssk.launches["ssd_scan"] == 0


def test_zamba2_decode_continues_from_the_kernels_state(card):
    """A prefill into fresh caches on the kernel, then a decode step: the
    SSD states and the step's logits as the plain form's, and the step as
    the last position of a prefill one token longer."""
    cfg, params, tokens = _zamba2_two_layers(card)
    s = tokens.shape[1] - 1

    def run():
        caches = Z.init_caches(cfg, 2, s + 4, device=card)
        _, caches = Z.prefill(params, tokens[:, :s], cfg, caches=caches)
        step, _ = Z.decode_step(params, caches, tokens[:, s:],
                                torch.full((2,), s, device=card), cfg)
        return caches["mamba"]["s"], step

    Z.zamba2_stats.reset()
    with torch.no_grad():
        states, step = run()
        full = Z.forward(params, tokens, cfg)[0][:, -1:]
        with _plain_ssd():
            want_states, want_step = run()
    assert Z.zamba2_stats.ssd_kernel == 2 + 2
    torch.cuda.synchronize()
    assert _rel_l2(states, want_states) <= SSD_TOL
    assert _rel_l2(step, want_step) <= SSD_TOL
    assert _rel_l2(step, full) <= SSD_TOL
