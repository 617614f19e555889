"""The yardstick's peaks and the work each kernel's function needs.

Peaks of one NVIDIA H100 SXM at its full 700 W power limit:

* ``HBM_BYTES_PER_S``: 3.35 TB/s (NVIDIA's data sheet).
* ``INT32_INSTR_PER_S``: 64 INT32 lanes per SM (Hopper architecture white
  paper) x 132 SMs x 1.98 GHz boost clock = 16.7e12 int32 instructions/s.
  An IMAD is one instruction: 33.4e12 operations/s with the multiply and
  the add counted apart.  Every integer kernel here is priced at it.

The counts are of the function, whatever implements it: the MLP's
multiply-adds of each real packet's own model, a forest's compare and
select per internal node on each tree's path and the vote's add, and the
flow stage's register rows and sketch cells these packets touch, read and
written once.  Padding rows and unused table slots are not work.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 64 * 132 * 1.98e9
WIDTH = 32
# the register update, two sketch rows and the estimate
FLOW_INSTR_PER_PACKET = 59 + 4 * 2 + 3
FLOW_INPUT_BYTES = 4 + 2 * 4 + 4 + 4 + 4  # slot, cells, tick, len, live
FLOW_REGISTER_BYTES = 8 * 4
NODE_BYTES = 5 * 4              # feature, threshold, left, right, leaf


def bound_s(n_bytes: float, instr: float) -> float:
    """The least time: the larger of bytes over HBM bandwidth and int32
    instructions over the int32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, instr / INT32_INSTR_PER_S)


def mlp_dims(cfg: dict) -> dict:
    """Model ID → its layers' (in, out) widths."""
    return {int(m["id"]): list(zip(m["dims"][:-1], m["dims"][1:]))
            for m in cfg["mlps"]}


def mlp_instr(dims) -> int:
    """Multiply-adds of one packet through one model."""
    return sum(i * o for i, o in dims)


def mlp_launch(mid: np.ndarray, dims: dict) -> tuple:
    """(bytes, instructions) the MLP function needs for one batch: each
    row of an installed MLP read and answered once, its model's weights and
    biases read once."""
    ids, counts = np.unique(mid, return_counts=True)
    n = instr = table = 0
    for m, c in zip(ids.tolist(), counts.tolist()):
        d = dims.get(m)
        if d is None:
            continue
        n += c
        instr += c * mlp_instr(d)
        table += sum(i * o * 2 + o * 4 for i, o in d)
    return n * (WIDTH * 4 + 4 + WIDTH * 4) + table, instr


def forest_path_instr(x: np.ndarray, forest_q: dict) -> np.ndarray:
    """Per row: a compare and a select per internal node on each tree's
    path, and one add per tree for the vote."""
    from portbench.reference.dataplane import tree_leaves

    total = np.zeros(x.shape[0], np.int64)
    for tree in forest_q["trees"]:
        total += 2 * tree_leaves(x, tree)[1] + 1
    return total


def forest_launch(x: np.ndarray, mid: np.ndarray, forests_q: dict) -> tuple:
    """(bytes, instructions) the forest function needs for one batch."""
    n = instr = table = 0
    for m, fq in forests_q.items():
        sel = mid == m
        if not sel.any():
            continue
        n += int(sel.sum())
        instr += int(forest_path_instr(x[sel].astype(np.int64), fq).sum())
        table += sum(t["left"].shape[0] * NODE_BYTES for t in fq["trees"])
    return n * (WIDTH * 4 + 4 + WIDTH * 4) + table, instr


def flow_launch(raw: np.ndarray) -> tuple:
    """(bytes, instructions) of one flow update over live raw rows: the
    flows' register rows and the sketch cells they touch, each read and
    written once, the per-packet inputs read and the eight features
    written once."""
    from portbench.reference.dataplane import (CMS_DEPTH, CMS_WIDTH_POW2,
                                               _CMS_MULTS, key_hash)

    n = raw.shape[0]
    h = key_hash(np.ascontiguousarray(raw[:, :13]))
    cells = (h[:, None] * _CMS_MULTS[None, :CMS_DEPTH]) >> np.uint64(
        64 - CMS_WIDTH_POW2)
    n_cells = sum(np.unique(cells[:, d]).size for d in range(CMS_DEPTH))
    n_flows = np.unique(h).size
    n_bytes = (2 * (n_flows * FLOW_REGISTER_BYTES + n_cells * 4)
               + n * (FLOW_INPUT_BYTES + 8 * 4))
    return n_bytes, n * FLOW_INSTR_PER_PACKET
