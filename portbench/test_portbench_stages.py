"""The readers of the program's host stage counters, on a traced run of
each configuration on the CPU at a small size: every reader of a stage
share returns a number in the cells it names, the twelve stage counters
account for the harness's ``submit`` and ``drain`` spans to within 2%, and
the per-batch device time has nothing to read where there is no card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench  # noqa: E402
from portbench.test_portbench_reference import SMALL  # noqa: E402

STAGES = ("server_call", "flow_parse", "flow_table", "flow_state",
          "flow_gather", "ingress_key", "ingress_lookup", "ingress_stage",
          "engine_dispatch", "ingress_wait", "ingress_retire",
          "ingress_drain")
READERS = ("flow_state_share.sat", "flow_host_share.sat",
           "ingress_key_share.sat", "ingress_lookup_share.sat",
           "ingress_stage_share.sat", "dispatch_share.sat",
           "retire_share.sat", "drain_share.sat", "host_wait_share.sat",
           "device_us_per_batch.sat")


def traced_small_run(name: str, monkeypatch, seed: int = 5):
    """A traced CPU run of cell ``name``; returns its result and the
    record its readers read."""
    torch.set_num_threads(1)
    records = []

    class Record(bench.Record):
        def __init__(self, **kw):
            super().__init__(**kw)
            records.append(self)

    monkeypatch.setattr(bench, "Record", Record)
    spec = bench.load_benchmark()
    r = bench.run(bench.find_workload(spec, name), spec, seed=seed,
                  seconds=0.25, trace=True, device="cpu",
                  mix_override=SMALL["sat"])
    return r, records[0]


@pytest.mark.parametrize("name", ["flow16.sat_mixed8k", "feat16.sat_dup30"])
def test_stage_readers_account_for_the_host_spans(name, monkeypatch):
    r, rec = traced_small_run(name, monkeypatch)
    assert r["correct"] is True, r["checks"]
    mine = [m for m in bench.load_benchmark()["per_layer"]
            if m["name"] in READERS and bench.applies(m, name)]
    assert len(mine) == (10 if name.startswith("flow16") else 8)
    for m in mine:
        v = r["metrics"].get(m["name"], {}).get("value")
        if m["name"] == "device_us_per_batch.sat":
            assert v is None                # no device events on the CPU
        else:
            assert v is not None and 0.0 <= v <= 100.0, m["name"]
    stages = sum(rec.counters[f"{s}_seconds_total"] for s in STAGES)
    spans = rec.spans.totals["submit"] + rec.spans.totals["drain"]
    assert abs(stages - spans) <= 0.02 * spans, (stages, spans)
    flow = sum(rec.counters[f"{s}_seconds_total"] for s in STAGES[1:5])
    assert (flow > 0) == name.startswith("flow16")
