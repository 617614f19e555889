"""The benchmark's files: every cell, configuration, mix and per-layer
metric named in ``BENCHMARK.json`` resolves to its file, and a new one is
found by its name alone, with no edit to a file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def surface_rows(surface: str) -> str:
    """The mix rows a surface takes: the packet path's two, or what the
    surface's own module states."""
    import importlib

    rows = {"packets": "features", "raw": "raw"}.get(surface)
    if rows is None:
        rows = importlib.import_module(f"portbench.surfaces.{surface}").ROWS
    return rows


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    sys.path[:0] = [str(ROOT)]
    from portbench import bench, deploy, traffic

    cfg = deploy.load_config(w["config"])
    mix = traffic.load_traffic(w["traffic"])
    entry = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert (ROOT / entry["file"]).exists()
    assert mix["rows"] == surface_rows(cfg["surface"])
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if bench.applies(m, w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in BENCH["per_layer"] if bench.applies(m, w["name"])]
    assert per
    for m in per:
        assert callable(bench.load_reader(m["name"]))
        moved = [x for x in BENCH["end_to_end"] if x["name"] == m["moves"]][0]
        assert bench.applies(moved, w["name"])


_DUMMY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from portbench import bench
spec = bench.load_benchmark()
r = bench.run(bench.find_workload(spec, "tiny.burst"), spec, seed=7,
              seconds=0.2, trace=True, device="cpu")
print(json.dumps(r))
"""


def test_new_cell_found_by_name(tmp_path):
    """A configuration, a mix and a per-layer metric added as files of
    their own plus entries in a copy of BENCHMARK.json run with no other
    edit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/feat16.json").read_text())
    cfg["name"] = "tiny"
    cfg["mlps"] = cfg["mlps"][:2]
    (tmp_path / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench/traffic/sat_dup30.json").read_text())
    mix.update(name="burst", pool_packets=4096, chunk=[1, 256],
               warmup_chunks=2)
    (tmp_path / "portbench/traffic/burst.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/chunks_sent.py").write_text(
        "def read(rec):\n    return float(rec.win['chunks'])\n")
    spec["configs"].append(dict(spec["configs"][0], name="tiny",
                                file="portbench/configs/tiny.json"))
    spec["workloads"].append(dict(name="tiny.burst", config="tiny",
                                  traffic="burst", chips=1, why="test"))
    for m in spec["end_to_end"]:
        if m["name"] == "pps":
            m["workloads"].append("tiny.burst")
    spec["per_layer"].append(dict(name="chunks_sent", unit="chunks",
                                  better="higher", source="host_clock",
                                  layer="client", moves="pps",
                                  workloads=["tiny.burst"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = _DUMMY.format(root=str(tmp_path), src=str(ROOT / "src"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["chunks_sent"]["value"] >= 1


_LM_COPY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from portbench import bench, deploy, traffic
from portbench.test_portbench_layout import surface_rows
spec = bench.load_benchmark()
w = bench.find_workload(spec, "lm_copy.prefill_copy")
assert traffic.load_traffic("prefill_copy")["rows"] == surface_rows(
    deploy.load_config("lm_copy")["surface"])
for m in spec["per_layer"]:
    if bench.applies(m, w["name"]):
        bench.load_reader(m["name"])
r = bench.run(w, spec, seed=2 ** 31 + 3, seconds=0.3, trace=False,
              device="cpu", mix_override=dict(batch=2, seq=64),
              server_override=dict(num_hidden_layers=2, hidden_size=128,
                                   num_attention_heads=4,
                                   num_key_value_heads=1,
                                   intermediate_size=256, vocab_size=512))
print(json.dumps(r))
"""


def test_copied_lm_cell_found_by_name(tmp_path):
    """An LM configuration and mix copied under new names, with entries
    in a copy of BENCHMARK.json, resolve and run with no edit to a file
    that is there."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    lm = [w for w in spec["workloads"]
          if surface_rows(json.loads((ROOT / "portbench/configs" / (
              w["config"] + ".json")).read_text())["surface"]) == "tokens"][0]
    cfg = json.loads((ROOT / f"portbench/configs/{lm['config']}.json")
                     .read_text())
    cfg["name"] = "lm_copy"
    (tmp_path / "portbench/configs/lm_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / f"portbench/traffic/{lm['traffic']}.json")
                     .read_text())
    mix["name"] = "prefill_copy"
    (tmp_path / "portbench/traffic/prefill_copy.json").write_text(
        json.dumps(mix))
    spec["configs"].append(dict(
        [c for c in spec["configs"] if c["name"] == lm["config"]][0],
        name="lm_copy", file="portbench/configs/lm_copy.json"))
    spec["workloads"].append(dict(lm, name="lm_copy.prefill_copy",
                                  config="lm_copy", traffic="prefill_copy"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if lm["name"] in m.get("workloads", []):
            m["workloads"].append("lm_copy.prefill_copy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = _LM_COPY.format(root=str(tmp_path), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"tokens_per_s", "setup_s"}
