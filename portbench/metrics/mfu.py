"""The models' useful integer work for every packet answered in the window
(cache hits included) over the window's seconds, as a share of the card's
int32 rate (``work.INT32_INSTR_PER_S``; an IMAD is one instruction), in %.

MLP work per packet is its model's multiply-adds; a forest packet's is the
mean, over the reference's sample of that forest's packets, of a compare
and a select per internal node on each tree's path plus the vote's add."""

import numpy as np

from portbench import deploy, work
from portbench.reference import dataplane as ref


def read(rec):
    cell = rec.cell
    rows = cell.ref_rows[-rec.win["sent"]:]
    if cell.cfg["surface"] == "packets":
        mid = (rows[:, 0].astype(np.int64) << 8) | rows[:, 1]
    else:
        mid = (rows[:, 13].astype(np.int64) << 8) | rows[:, 14]
    dims = work.mlp_dims(cell.cfg)
    instr = sum(work.mlp_instr(d) * int((mid == m).sum())
                for m, d in dims.items())
    if cell.forests:
        fl = cell.ref_flow
        _, forests_q = deploy.reference_tables({}, cell.forests)
        specs = {int(k): v for k, v in cell.cfg["feature_specs"].items()}
        pos = np.cumsum(fl["ok"]) - 1
        pick = cell.ref_pick[fl["ok"][cell.ref_pick]]
        p = pos[pick]
        x = ref.spec_inputs(fl["feats"][p], fl["mid"][p], specs)
        for m, fq in forests_q.items():
            sel = fl["mid"][p] == m
            if sel.any():
                per = work.forest_path_instr(x[sel], fq).mean()
                instr += per * int((mid == m).sum())
    return 100.0 * instr / rec.window_s / work.INT32_INSTR_PER_S
