"""The reference agrees with the program on the CPU at a small size: a
whole run of every cell through the harness, on ``device="cpu"``, comes
out correct on every number it compares (every packet's kind, a sample of
egress rows, and for ``flow16`` the final registers, sketch and flow-table
counters)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, deploy  # noqa: E402
from portbench.reference import dataplane as ref  # noqa: E402

SMALL = {"sat": {"pool_packets": 12000, "warmup_chunks": 2,
                 "chunk": [1, 2048]},
         "open": {"rate_pps": 4000, "warmup_chunks": 16}}
# every configuration under every mix of its surface, whether or not
# BENCHMARK.json holds the pair as a cell
CELLS = ["feat16.sat_dup30", "flow16.sat_mixed8k", "feat16.open_unique",
         "flow16.open_mixed8k"]


def small_run(name: str, seed: int = 11, **kw):
    torch.set_num_threads(1)
    spec = bench.load_benchmark()
    config, mix = name.split(".")
    workload = dict(name=name, config=config, traffic=mix, chips=1)
    return bench.run(workload, spec, seed=seed, seconds=0.25, trace=False,
                     device="cpu", mix_override=SMALL[mix.split("_")[0]],
                     **kw)


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(name):
    r = small_run(name)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["correct"] is True, r["checks"]
    assert all(v["value"] == 0 for v in r["checks"].values())


def test_quantization_matches_the_control_plane():
    from repro_torch.core.control_plane import ControlPlane

    cfg = deploy.load_config("feat16")
    mlps = deploy.make_mlps(cfg, np.random.default_rng(3))
    cp = ControlPlane(max_width=32)
    for mid, (layers, acts, final) in mlps.items():
        cp.install(mid, layers, acts, final_activation=final)
    tables = cp.tables(torch.device("cpu"))
    for mid, (layers, acts, final) in mlps.items():
        q = ref.quantize_mlp(layers, acts, final)
        slot = int(tables.id_map[mid])
        n = len(layers)
        assert np.array_equal(tables.w[slot, :n].numpy().astype(np.int64),
                              q["w"])
        assert np.array_equal(tables.b[slot, :n].numpy().astype(np.int64),
                              q["b"])
        assert int(tables.out_dim[slot]) == q["out_dim"]


def test_rounding_shift_ties_away_from_zero():
    x = np.asarray([384, -384, 383, -383, 128, -128, 2 ** 31 - 1])
    assert ref.rshift_round(x, 8).tolist() == [2, -2, 1, -1, 1, -1, -2 ** 23]
