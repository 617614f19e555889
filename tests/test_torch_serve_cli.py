"""The port's serving CLI and ``PacketServer``'s model-quality options
against the JAX reference, on the CPU at small sizes:

  * ``repro_torch.launch.serve.main([..., "--device", "cpu"])`` at 1 and 2
    shards writes a telemetry snapshot with the reference ``main``'s metric
    names and label sets, and equal counter values (every counter that is
    not a time);
  * the drift monitor, the shadow lane and the ``slo:submit_p99`` rule,
    turned on through ``PacketServer(drift_window=, shadow_model=,
    slo_budget=)``, raise and clear the reference's alerts on the same
    traffic (the reference's ``tests/test_drift.py`` server cases), score
    the same shadow sample and leave the serving configurations and the
    engine's accounting as the reference's do.
"""

import json

import numpy as np
import pytest
import torch

from repro.data.packets import raw_trace as j_raw_trace
from repro.launch import serve as jserve
from repro_torch.data.packets import raw_trace
from repro_torch.launch import serve as tserve
from repro_torch.obs import STAGES

torch.set_num_threads(1)

FRAC = 8
WIDTH = 16
WINDOW = 256
# the port's host stage counters and its result cache's probe counters and
# native-sweep gauge, which the reference does not have, and the
# reference's dispatch→retire histogram, which the stages replace in the port
PORT_ONLY = {f"{s}_seconds_total" for s in STAGES} | {
    "cache_probe_slots_total", "cache_probe_keys_total", "cache_native"}
REFERENCE_ONLY = {"ingress_dispatch_seconds"}


def _metrics(path):
    with open(path) as f:
        return json.load(f)


def _cells(value):
    """A metric's cells by label set (an unlabelled metric is one cell)."""
    return value if isinstance(value, dict) else {"": value}


def _counters(metrics):
    """Counter values by (name, labels), times left out."""
    return {(name, lab): v for name, cells in metrics.items()
            if name.endswith("_total") and "seconds" not in name
            for lab, v in _cells(cells).items()}


@pytest.mark.parametrize("argv", [
    ["--shards", "1"],
    ["--shards", "2"],
    ["--shards", "2", "--drift-window", "128", "--shadow-model", "3",
     "--flows", "24", "--chunk", "200"],
])
def test_cli_snapshot_matches_reference(tmp_path, argv, capsys):
    argv = argv + ["--packets", "1536"]
    t_path, j_path = tmp_path / "t.json", tmp_path / "j.json"
    assert tserve.main(argv + ["--device", "cpu", "--metrics-json",
                               str(t_path)]) == 0
    assert "served 1536 packets" in capsys.readouterr().out
    assert jserve.main(argv + ["--metrics-json", str(j_path)]) == 0
    t, j = _metrics(t_path), _metrics(j_path)
    assert PORT_ONLY <= set(t["metrics"])
    assert sorted(set(t["metrics"]) - PORT_ONLY) == \
        sorted(set(j["metrics"]) - REFERENCE_ONLY)
    for name in set(t["metrics"]) - PORT_ONLY:
        assert sorted(_cells(t["metrics"][name])) == \
            sorted(_cells(j["metrics"][name])), name
    assert _counters({k: v for k, v in t["metrics"].items()
                      if k not in PORT_ONLY}) == _counters(j["metrics"])
    assert t["run"]["errors"] == j["run"]["errors"] == 0
    assert t["run"]["device"] == "cpu"
    assert sorted(t) == sorted(j)
    assert [e["kind"] for e in t["events"]] == [e["kind"]
                                                for e in j["events"]]
    if "--shadow-model" in argv:
        tm, jm = t["model_quality"], j["model_quality"]
        assert [s["pairs"] for s in tm["shadow"]] == \
            [s["pairs"] for s in jm["shadow"]]


def test_cli_prometheus_text(capsys):
    assert tserve.main(["--packets", "512", "--device", "cpu",
                        "--prometheus"]) == 0
    text = capsys.readouterr().out
    assert "# TYPE engine_packets_total counter" in text


# ---------------------------------------------------------------------------
# PacketServer's drift, shadow and SLO options, port against reference
# ---------------------------------------------------------------------------


def _weights(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(WIDTH, WIDTH)).astype(np.float32) * 0.3,
             np.zeros(WIDTH, np.float32)),
            (rng.normal(size=(WIDTH, 2)).astype(np.float32) * 0.3,
             np.zeros(2, np.float32))]


def _pair(**kw):
    """The port's server (CPU) and the reference's, both with model 1."""
    kw = dict(dict(max_models=4, max_width=WIDTH, frac_bits=FRAC,
                   ingress_batch=64, max_inflight=2, use_cache=False,
                   drift_window=WINDOW), **kw)
    out = [tserve.PacketServer(device="cpu", **kw), jserve.PacketServer(**kw)]
    for srv in out:
        srv.install(1, _weights(7), ["relu"], final_activation="sigmoid")
    return out


def _round(shift=0):
    """One drift window of unique feature rows with a fixed per-lane
    distribution; ``shift`` left-shifts lane 0."""
    i = np.arange(WINDOW)
    x = np.zeros((WINDOW, WIDTH), np.int32)
    x[:, 0] = (1 + (i % 64)) << shift
    x[:, 1] = -(5 + (i % 32))
    x[:, 2] = 300 + (i % 16)
    x[:, 3] = (i % 3) - 1
    x[:, 7] = 1000 + i
    return x


def _feed(srv, rounds, shift=0):
    out = []
    for _ in range(rounds):
        srv.ingress.submit_features(_round(shift),
                                    np.full(WINDOW, 1, np.int32))
        out = srv.drain_packets()
    return out


_KEEP = ("kind", "rule", "model_id", "value", "threshold", "shadow_model",
         "generation")


def _alerts(srv):
    """The alert events (kind, rule, values) without times or sequence."""
    return [{k: e[k] for k in _KEEP if k in e}
            for e in srv.obs.events.snapshot(limit=None)
            if e["kind"] in ("drift_alert", "alert_cleared", "slo_burn",
                             "shadow_divergence")]


def _reinstall(srv):
    srv.install(1, _weights(7), ["relu"], final_activation="sigmoid")


def _swap_weights(srv):
    srv.install(1, _weights(99), ["relu"], final_activation="sigmoid")


_SCENARIOS = {
    "stable": [(4, 0)],
    "shift fires once": [(3, 0), (3, 6), (3, 6)],
    "clears and re-arms": [(2, 0), (2, 6), (3, 0), (2, 6)],
    "reinstall refreezes": [(2, 0), (2, 6), _reinstall, (3, 6)],
    "prediction drift": [(4, 0), _swap_weights, (3, 0)],
}


@pytest.mark.parametrize("name", list(_SCENARIOS))
def test_drift_monitor_matches_reference(name):
    servers = _pair()
    for srv in servers:
        for step in _SCENARIOS[name]:
            if callable(step):
                step(srv)
            else:
                _feed(srv, step[0], shift=step[1])
    t, j = servers
    assert _alerts(t) == _alerts(j)
    assert t.obs.drift.last_scores == j.obs.drift.last_scores
    assert t.obs.health.state() == j.obs.health.state()
    assert sorted(t.obs.health.rules) == sorted(j.obs.health.rules)
    if name == "shift fires once":
        assert [a["kind"] for a in _alerts(t)] == ["drift_alert"]
    if name == "clears and re-arms":
        assert [a["kind"] for a in _alerts(t)].count("drift_alert") == 2


@pytest.mark.parametrize("shadow_seed", [7, 1234])
def test_shadow_lane_matches_reference(shadow_seed):
    servers = _pair(shadow_model=2, shadow_every=4)
    for srv in servers:
        srv.install(2, _weights(shadow_seed), ["relu"],
                    final_activation="sigmoid")
        _feed(srv, 2)
    t, j = servers
    before = t.engine.trace_count
    for srv in servers:
        _feed(srv, 2)
        _feed(srv, 1, shift=6)
    assert t.engine.trace_count == before
    ts, js = t.obs.drift.shadows[0], j.obs.drift.shadows[0]
    assert list(ts.sampled_tickets) == list(js.sampled_tickets)
    assert ts.snapshot() == js.snapshot()
    assert _alerts(t) == _alerts(j)
    # shadow traffic never inflates the engine's accounting
    assert t.engine.stats["packets"] == j.engine.stats["packets"] \
        == 5 * WINDOW
    assert t.engine.stats["bytes_in"] == j.engine.stats["bytes_in"]
    if shadow_seed == 7:
        assert ts.snapshot()["agreement"] == 1.0


def test_shadow_partial_flush_pads_with_model_zero():
    t, j = _pair(shadow_model=2, shadow_every=4)
    for srv in (t, j):
        srv.install(2, _weights(7), ["relu"], final_activation="sigmoid")
        srv.ingress.submit_features(_round()[:40], np.full(40, 1, np.int32))
        srv.drain_packets()
    assert t.obs.drift.shadows[0].pairs == j.obs.drift.shadows[0].pairs == 10


@pytest.mark.parametrize("budget,fires", [(1e-12, True), (1e6, False)])
def test_server_slo_burn_matches_reference(budget, fires):
    servers = _pair(slo_budget=budget)
    traces = [f(np.random.default_rng(3), 128, n_flows=8, model_ids=(1,))
              for f in (raw_trace, j_raw_trace)]
    for srv, raw in zip(servers, traces):
        srv.install_feature_spec(1, tuple(range(8)) * 2)
        srv.submit_raw(raw)
        srv.drain_packets()
        srv.submit_raw(raw[:64])
        srv.drain_packets()
    t, j = servers
    burns = [a for a in _alerts(t) if a["kind"] == "slo_burn"]
    jburns = [a for a in _alerts(j) if a["kind"] == "slo_burn"]
    assert len(burns) == len(jburns) == (1 if fires else 0)
    if fires:
        assert burns[0]["rule"] == "slo:submit_p99"
        assert t.obs.health.rules["slo:submit_p99"].open


def test_fabric_slo_burn_fires_once():
    fab = tserve.ShardedPacketServer(
        n_shards=2, max_width=WIDTH, frac_bits=FRAC, ingress_batch=64,
        max_inflight=2, slo_budget=1e-12, device="cpu")
    fab.install(1, _weights(7), ["relu"], final_activation="sigmoid")
    fab.install_feature_spec(1, tuple(range(8)) * 2)
    fab.submit_raw(raw_trace(np.random.default_rng(5), 256, n_flows=16,
                             model_ids=(1,)))
    fab.drain_packets()
    burns = [a for a in _alerts(fab) if a["kind"] == "slo_burn"]
    assert len(burns) == 1 and burns[0]["rule"] == "slo:fabric_submit_p99"
