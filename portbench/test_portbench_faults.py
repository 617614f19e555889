"""The comparison that decides ``correct`` fails what it must: the control
(the program's own int8 lane in place of the stated int16 one) and the
faults a cell can have, planted in the program underneath a whole run on
the CPU: an answer altered where it is produced, and a flow update that
returns its state unchanged."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.test_portbench_reference import CELLS, small_run  # noqa: E402


@pytest.mark.parametrize("name", CELLS)
def test_control_int8_lane_is_not_correct(name):
    r = small_run(name, server_override=dict(weight_bits=8,
                                             kernel_variant="int8"))
    assert r["correct"] is False
    assert r["checks"]["sample_mismatches"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, monkeypatch):
    import repro_torch.core.inference as inference

    lanes = inference.serve_lanes

    def altered(*a, **kw):
        out = lanes(*a, **kw).clone()
        out[0, 0] += 1
        return out
    monkeypatch.setattr(inference, "serve_lanes", altered)
    r = small_run(name)
    assert r["correct"] is False
    assert r["checks"]["sample_mismatches"]["value"] > 0


@pytest.mark.parametrize("name", ["flow16.sat_mixed8k",
                                  "flow16.open_mixed8k"])
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    import repro_torch.flow.frontend as frontend

    update = frontend.flow_update

    def unchanged(state, cms, *a, **kw):
        s0, c0 = np.array(state, copy=True), np.array(cms, copy=True)
        _, _, feats = update(state, cms, *a, **kw)
        state[...] = s0
        cms[...] = c0
        return state, cms, feats
    monkeypatch.setattr(frontend, "flow_update", unchanged)
    r = small_run(name)
    assert r["correct"] is False
    assert r["checks"]["register_mismatches"]["value"] > 0
