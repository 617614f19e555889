"""The whole serving slice, port against reference: one seeded trace of
ragged chunks with duplicates, unknown Model IDs and a mid-trace hot-swap
install through ``repro.launch.serve.PacketServer`` and
``repro_torch.launch.serve.PacketServer(device="cpu")`` gives byte-identical
egress in submission order, with the serving-configuration count flat
across the install.  Also the wire path (``process``), the batch API and
the engine's accounting."""

import numpy as np
import pytest
import torch

from repro.core.ingress import BatchError as JBatchError
from repro.core.packet import encode_packets_np
from repro.launch.serve import PacketServer as JServer
from repro_torch.core.ingress import BatchError, PacketError
from repro_torch.launch.serve import PacketServer as TServer

torch.set_num_threads(1)

ACTS = ["relu", "sigmoid", "leaky_relu", "hard_sigmoid", "none"]


def _model(rng, dims, scale=0.6):
    return [(rng.normal(size=(a, b)).astype(np.float32) * scale,
             rng.normal(size=(b,)).astype(np.float32) * 0.2)
            for a, b in zip(dims[:-1], dims[1:])]


def _servers(**kw):
    return TServer(device="cpu", **kw), JServer(**kw)


def _install_zoo(servers, rng, width, n_models, max_layers):
    ids = []
    for m in range(n_models):
        depth = 1 + m % max_layers
        dims = [width] * depth + [1 + (3 * m) % width]
        layers = _model(rng, dims)
        hidden = [ACTS[(m + j) % 5] for j in range(depth - 1)]
        for s in servers:
            s.install(10 + m, layers, hidden, final_activation=ACTS[m % 5])
        ids.append(10 + m)
    return ids


def _trace(rng, n, ids, width, frac=8):
    n_uniq = int(n * 0.7)
    feats = rng.integers(-700, 700, (n_uniq, width)).astype(np.int32)
    mids = rng.choice(np.asarray(ids + [3, 999], np.int32), n_uniq)
    fcnt = rng.integers(1, width + 1, n_uniq)
    uniq = encode_packets_np(mids, frac, feats, feature_cnt=fcnt)
    pick = np.concatenate([np.arange(n_uniq),
                           rng.integers(0, n_uniq, n - n_uniq)])
    rows = uniq[rng.permutation(pick)]
    cuts = np.unique(np.cumsum(rng.integers(1, 90, n // 8)))
    return rows, np.split(rows, cuts[cuts < n])


def _serve(srv, chunks, swap_at, swap):
    rc = None
    for i, chunk in enumerate(chunks):
        if i == swap_at:
            rc = srv.stats()["recompiles"]
            srv.install(*swap[0], **swap[1])
        srv.submit_packets(chunk)
    out = srv.drain_packets()
    return out, rc, srv.stats()["recompiles"]


def _as_rows(out):
    assert all(isinstance(o, np.ndarray) for o in out)
    return np.stack(out)


@pytest.mark.parametrize("variant,weight_bits,width,batch", [
    ("int16", 16, 8, 64), ("int16", 16, 12, 48), ("int8", 8, 8, 64)])
def test_stream_egress_byte_identical_to_reference(variant, weight_bits,
                                                   width, batch):
    kw = dict(max_models=4, max_layers=3, max_width=width,
              weight_bits=weight_bits, kernel_variant=variant,
              ingress_batch=batch, max_inflight=2)
    ts, js = _servers(**kw)
    rng = np.random.default_rng(width + weight_bits)
    ids = _install_zoo((ts, js), rng, width, 3, 3)
    _, chunks = _trace(rng, 300, ids, width)
    swap = ((ids[1], _model(rng, [width, width, 2]), ["sigmoid"]),
            dict(final_activation="leaky_relu"))
    t_out, t_rc0, t_rc1 = _serve(ts, chunks, len(chunks) // 2, swap)
    j_out, j_rc0, j_rc1 = _serve(js, chunks, len(chunks) // 2, swap)
    np.testing.assert_array_equal(_as_rows(t_out), _as_rows(j_out))
    assert t_rc0 == t_rc1 >= 1 and j_rc0 == j_rc1
    st = ts.stats()
    assert st["table_generation"] == js.stats()["table_generation"]
    assert st["cache_hit_rate"] == pytest.approx(js.stats()["cache_hit_rate"])


class _Clock:
    """A deterministic clock, advanced by hand between chunks."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("opts", [
    dict(adaptive_batch=True, flush_after=0.004),
    dict(flush_after=0.0),
    dict(queue_capacity=40),
    dict(trace_every=3),
])
def test_pipeline_options_match_reference(opts):
    """Adaptive batch sizing, age-based flushing, hard-capacity shedding
    and packet tracing behave as the reference's on one trace (same fake
    clock sequence on both sides), error slots included."""
    width = 8
    kw = dict(max_models=3, max_layers=2, max_width=width, ingress_batch=256,
              max_inflight=2, **opts)
    clocks = (_Clock(), _Clock())
    ts = TServer(device="cpu", clock=clocks[0], **kw)
    js = JServer(clock=clocks[1], **kw)
    rng = np.random.default_rng(31)
    ids = _install_zoo((ts, js), rng, width, 3, 2)
    _, chunks = _trace(rng, 400, ids, width)
    gaps = rng.random(len(chunks)) * 0.003
    outs = []
    for s, clock in zip((ts, js), clocks):
        for gap, c in zip(gaps, chunks):
            clock.t += gap
            s.submit_packets(c)
        outs.append(s.drain_packets())
    assert len(outs[0]) == len(outs[1]) == 400
    for a, b in zip(*outs):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert isinstance(a, PacketError) and a.reason == b.reason
    tst, jst = ts.ingress.stats, js.ingress.stats
    for k in ("ingress_batches_total", "ingress_padded_rows_total",
              "ingress_shed_total", "ingress_cache_hits_total"):
        assert tst[k] == jst[k], k
    assert ts.ingress.batch_sizes == js.ingress.batch_sizes
    assert len(ts.obs.spans()) == len(js.obs.spans())


def test_stream_errors_remove_and_second_window_match_reference():
    """Malformed chunks and oversized feature counts take error slots in
    submission order; remove() mid-stream; a second drain window reuses
    the cache; all identical to the reference."""
    width = 8
    kw = dict(max_models=3, max_layers=2, max_width=width, ingress_batch=32,
              max_inflight=1)
    ts, js = _servers(**kw)
    rng = np.random.default_rng(7)
    ids = _install_zoo((ts, js), rng, width, 3, 2)
    rows, chunks = _trace(rng, 200, ids, width)
    bad_cnt = rows[:5].copy()
    bad_cnt[:, 2] = width + 3
    results = []
    for s in (ts, js):
        s.submit_packets(chunks[0])
        s.submit_packets(np.zeros((3, 4), np.uint8))  # shorter than a header
        s.submit_packets(bad_cnt)
        for c in chunks[1:4]:
            s.submit_packets(c)
        s.remove(ids[0])
        for c in chunks[4:]:
            s.submit_packets(c)
        first = s.drain_packets()
        for c in chunks:
            s.submit_packets(c)
        results.append((first, s.drain_packets(), s.stats()))
    (t1, t2, tst), (j1, j2, jst) = results
    for a, b in ((t1, j1), (t2, j2)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert isinstance(x, PacketError) and x.reason == y.reason
    assert tst["cache_hit_rate"] == pytest.approx(jst["cache_hit_rate"])
    assert tst["cache_entries"] == jst["cache_entries"]


@pytest.mark.parametrize("width", [8, 12])
def test_process_wire_path_matches_reference(width):
    kw = dict(max_models=4, max_layers=3, max_width=width, ingress_batch=32)
    ts, js = _servers(**kw)
    rng = np.random.default_rng(width)
    ids = _install_zoo((ts, js), rng, width, 4, 3)
    rows, _ = _trace(rng, 120, ids, width)
    t = np.asarray(ts.process(rows))
    j = np.asarray(js.process(rows))
    np.testing.assert_array_equal(t, j)
    # shorter wire rows (fewer feature words than max_features)
    short = rows[:, : 7 + 4 * (width // 2)]
    np.testing.assert_array_equal(np.asarray(ts.process(short)),
                                  np.asarray(js.process(short)))
    assert ts.stats()["recompiles"] == 2


def test_batch_api_matches_reference_and_rejects_in_place():
    width = 8
    kw = dict(max_models=2, max_layers=2, max_width=width, max_inflight=2)
    ts, js = _servers(**kw)
    rng = np.random.default_rng(3)
    ids = _install_zoo((ts, js), rng, width, 2, 2)
    rows, _ = _trace(rng, 90, ids, width)
    batches = [rows[:30], np.zeros((4, 3), np.uint8), rows[30:60],
               rows[60:].astype(np.int64), np.full((2, 40), 300, np.int64),
               rows[:20].astype(np.float32)]
    t_sub = [ts.submit_async(b) for b in batches]
    j_sub = [js.submit_async(b) for b in batches]
    # a torch tensor batch serves like the same bytes as numpy
    t_sub.append(ts.submit_async(torch.as_tensor(rows[:25])))
    j_sub.append(js.submit_async(rows[:25]))
    t_out, j_out = ts.drain(), js.drain()
    assert len(t_out) == len(j_out)
    for a, b in zip(t_sub, j_sub):
        if isinstance(b, JBatchError):
            assert isinstance(a, BatchError) and a.n_packets == b.n_packets
            assert a.reason == b.reason
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ts.stats()["recompiles"] == js.stats()["recompiles"]


def test_engine_accounting_and_warm():
    """Served-packet and byte counters credit cache hits and coalesced
    duplicates and drop padding, as the reference's do; warm() leaves the
    counters untouched; installs never add a serving configuration."""
    width = 8
    kw = dict(max_models=2, max_layers=2, max_width=width, ingress_batch=32)
    ts, js = _servers(**kw)
    rng = np.random.default_rng(9)
    ids = _install_zoo((ts, js), rng, width, 2, 2)
    ts.engine.warm(32, 7 + 4 * width)
    assert ts.engine.stats["packets"] == 0 and ts.stats()["recompiles"] == 2
    rows, chunks = _trace(rng, 150, ids, width)
    for s in (ts, js):
        for c in chunks:
            s.submit_packets(c)
        s.drain_packets()
    for k in ("packets", "bytes_in", "bytes_out"):
        assert ts.engine.stats[k] == js.engine.stats[k], k
    before = ts.stats()["recompiles"]
    for m in range(5):
        ts.install(ids[m % 2], _model(rng, [width, 3]), [])
    for c in chunks:
        ts.submit_packets(c)
    ts.drain_packets()
    assert ts.stats()["recompiles"] == before
    assert ts.engine.packets_per_second() > 0


def test_dispatch_fault_is_retried_transparently():
    """A transient injected dispatch fault goes through the pipeline's
    retry path: egress stays identical to an unfaulted run."""
    from repro_torch.serve.faults import FaultPlan, FaultSpec
    width = 8
    kw = dict(max_models=2, max_layers=2, max_width=width, ingress_batch=16)
    plain, faulty = TServer(device="cpu", **kw), TServer(device="cpu", **kw)
    rng = np.random.default_rng(12)
    ids = _install_zoo((plain, faulty), rng, width, 2, 2)
    plan = FaultPlan([FaultSpec(site="dispatch", every=3, count=4)])
    plan.install(faulty)
    _, chunks = _trace(rng, 120, ids, width)
    outs = []
    for s in (plain, faulty):
        for c in chunks:
            s.submit_packets(c)
        outs.append(_as_rows(s.drain_packets()))
    np.testing.assert_array_equal(outs[0], outs[1])
    retries = faulty.ingress.stats["ingress_dispatch_retries_total"]
    assert retries == len(plan.fired) >= 2


def test_quickstart_example_runs_on_cpu():
    """examples/pt_quickstart.py (train → install → packets → hot swap)
    runs to OK on the CPU, within the paper's NMSE budget, with one serving
    configuration across the hot swap."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "pt_quickstart.py"
    spec = importlib.util.spec_from_file_location("pt_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main("cpu")
    assert res["recompiles"] == 1 and res["table_generation"] == 2
    assert res["nmse"] < 0.15


def _example(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inline_qos_serving_example_matches_reference_on_cpu(capsys):
    """examples/pt_inline_qos_serving.py (three tenants, one serving
    configuration, a mixed packet_stream) runs to OK on the CPU, and its
    per-tenant lines — packet counts and prediction means of the last
    batch — equal those of the reference's examples/inline_qos_serving.py."""
    res = _example("pt_inline_qos_serving").main("cpu")
    got = capsys.readouterr().out.splitlines()
    _example("inline_qos_serving").main()
    want = capsys.readouterr().out.splitlines()
    assert got[-1] == want[-1] == "OK"
    assert res["recompiles"] == 1 and res["table_generation"] == 3
    tenants = [line for line in got if line.startswith("  tenant")]
    assert len(tenants) == 3
    assert tenants == [line for line in want if line.startswith("  tenant")]
    assert res["egress"].dtype == np.uint8 and res["egress"].shape[0] == 2048


def test_serve_lm_quantized_example_matches_reference_on_cpu(capsys):
    """examples/pt_serve_lm_quantized.py, on the reference's own parameters
    (its ``init`` at keys 0 and 1, carried across), runs to OK on the CPU
    beside the reference's examples/serve_lm_quantized.py: the same float
    greedy tokens and the same hot-swap line.  Its W8A8 and int8-KV tokens
    are not compared: the example serves in bfloat16, where XLA keeps
    excess precision and a near-tied argmax can flip (in float32 the three
    runs are equal token for token, tests/test_torch_transformer.py)."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.launch.serve import LMServer as JLMServer
    from repro.models import build_model as jbuild_model
    from repro_torch.models import params_from_numpy

    jcfg = jreduced(jget_config("qwen2-1.5b"), d_model=256, n_layers=4,
                    d_ff=512).replace(remat=False)
    jmodel = jbuild_model(jcfg)

    def init(seed):
        return params_from_numpy(jax.tree.map(
            np.asarray, jmodel.init(jax.random.key(seed))), "cpu")

    res = _example("pt_serve_lm_quantized").main("cpu", init)
    got = capsys.readouterr().out.splitlines()
    _example("serve_lm_quantized").main()
    want = capsys.readouterr().out.splitlines()
    assert got[-1] == want[-1] == "OK"
    swap = [line for line in got if line.startswith("hot-swap")]
    assert swap == [line for line in want if line.startswith("hot-swap")]
    jsrv = JLMServer(jcfg, batch=2, max_seq=64)
    jsrv.install("prod", jmodel.init(jax.random.key(0)))
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
    want_fp = np.asarray(jsrv.generate("prod", prompt, 12))
    np.testing.assert_array_equal(res["float"], want_fp)
    for k in ("w8a8", "int8_kv"):
        assert res[k].dtype == np.int32 and res[k].shape == (2, 12)
    assert res["trace_count"] == 1
