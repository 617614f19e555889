"""Fused per-flow register update + feature emit (the stateful stage a P4
SmartNIC computes in register externs before the ML stage).

Counterpart of ``repro.kernels.flow_update``.  The flow engine
(``repro_torch.flow``) resolves each raw packet's 5-tuple to a flow-table
slot on the host; this stage then performs, for a batch of parsed headers,
the whole **stateful** update:

    for each packet p (batch order):
        row        = registers[slot[p]]          # dynamic row gather
        row'       = update(row, ts[p], len[p])  # counters, EWMAs, min/max
        registers[slot[p]] = row'                # dynamic row scatter
        cms[d, cell[p,d]] += 1  (∀d)             # count-min heavy-hitter lane
        features[p] = emit(row', cms)            # post-update codes at frac

Batch order matters: two packets of one flow in the same batch chain their
EWMAs, exactly like back-to-back packets through a hardware register ALU.
Three realizations, all bit-exact against the pure-Python per-packet oracle
``ref.flow_update_numpy``:

  * :func:`flow_update_kernel` — the hand-written CUDA kernel
    (``csrc/flow_update.cu``) for tensors on the card, in two device
    kernels: the links (one warp per packet finds whether it heads its
    flow, its rank and last-ness in each sketch cell, and its place in a
    layout where each flow's packets form one run in batch order), then
    the update (each flow's first live packet walks its run; the count-min
    lane takes its closed form); see the source's note and its plain
    mirror ``ref.flow_update_two_phase_ref``.
    For CPU tensors it runs the plain version ``ref.flow_update_ref``.
    Every call that launches adds one to ``launches["flow_update"]``.
  * :func:`flow_update_gather` — the production CPU lowering (numpy): rank
    rounds, where round ``r`` updates every flow's rank-``r`` packet at
    once, so the sequential chain costs rounds = max packets per flow per
    batch, not B.
  * :func:`cms_estimate_update` — the count-min closed form
    ``min(prior + rank_in_cell + 1, FLOW_CODE_MAX)`` the other two share.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import _build
from .ref import (FLOW_CODE_MAX, N_FLOW_FEATURES, N_FLOW_REGISTERS,
                  REG_BYTE_COUNT, REG_EWMA_IAT, REG_EWMA_LEN, REG_FIRST_TS,
                  REG_LAST_TS, REG_MAX_LEN, REG_MIN_LEN, REG_PKT_COUNT,
                  flow_update_ref, rounding_rshift_np, sat_shl_np)

__all__ = ["flow_update_kernel", "launch", "flow_update_gather",
           "rank_from_order", "cms_estimate_update", "launches",
           "reset_launches", "load_library", "MAX_DEPTH"]

MAX_DEPTH = 8  # kMaxDepth in the CUDA source: count-min sketch rows

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"flow_update": 0}


def reset_launches() -> None:
    launches["flow_update"] = 0


# ---------------------------------------------------------------------------
# Vectorized CPU lowering (rank rounds)
# ---------------------------------------------------------------------------


def rank_from_order(order: np.ndarray, newg: np.ndarray) -> np.ndarray:
    """Per-group occurrence rank (original order) from a stable sort's
    ``order`` permutation and its group-start mask ``newg`` — THE rank
    definition, shared with ``core.ingress._dedup_rows(want_rank=True)``
    so the flow table's dedup by-product and the lowering's own fallback
    can never drift apart."""
    n = order.shape[0]
    ar = np.arange(n)
    gstart = np.maximum.accumulate(np.where(newg, ar, 0))
    rank = np.empty(n, np.int64)
    rank[order] = ar - gstart
    return rank


def _rank_within_groups(keys: np.ndarray, key_bound: int = 1 << 62):
    """Stable per-key rank: the k-th occurrence of a key (in array order)
    gets rank k.  One scalar argsort over the keys downcast to the
    narrowest int that holds ``key_bound`` (a lossless downcast keeps the
    grouping, and numpy's stable sort radixes by key bytes)."""
    n = keys.shape[0]
    if key_bound <= 1 << 15:
        sort_keys = keys.astype(np.int16, copy=False)
    else:
        sort_keys = keys.astype(np.int32, copy=False)
    order = np.argsort(sort_keys, kind="stable")
    sk = keys[order]
    newg = np.empty(n, bool)
    newg[0] = True
    newg[1:] = sk[1:] != sk[:-1]
    return rank_from_order(order, newg)


def cms_estimate_update(cms: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Count-min lane closed form: increments commute, so the post-update
    estimate each packet observes is ``min(prior + rank_in_cell + 1,
    FLOW_CODE_MAX)`` — no sequential rounds — and the cell totals fold in
    as one saturating bincount per sketch row.  Updates ``cms`` **in
    place** (int32 ``(D, Wc)``) and returns the per-packet estimates (int32
    ``(B,)``, pre-quantization)."""
    cl = np.asarray(cells, np.int64).reshape(cells.shape[0], -1)
    code_max = np.int32(FLOW_CODE_MAX)
    est = np.full(cl.shape[0], FLOW_CODE_MAX, np.int32)
    if cl.shape[0] == 0:
        return est
    for d in range(cms.shape[0]):
        cd = cl[:, d]
        prior = cms[d, cd]
        est_d = np.minimum(prior + (_rank_within_groups(cd, cms.shape[1])
                                    + 1).astype(np.int32), code_max)
        est = np.minimum(est, est_d)
        counts = np.bincount(cd, minlength=cms.shape[1])
        np.minimum(cms[d] + counts.astype(np.int32), code_max,
                   out=cms[d])
    return est


def flow_update_gather(state: np.ndarray, cms: np.ndarray, slots: np.ndarray,
                       cells: np.ndarray, ts: np.ndarray, length: np.ndarray,
                       live: np.ndarray, *, frac: int, ewma_shift: int,
                       byte_shift: int, dur_shift: int, copy: bool = True,
                       rank: "np.ndarray | None" = None):
    """Bit-identical CPU realization: rank-round vectorized scatter.

    Packets are ranked within their flow (stable batch order); round ``r``
    updates every flow's rank-``r`` packet at once — all distinct slots, so
    the scatter is race-free and the EWMA chains stay in exact batch order.

    ``copy=False`` updates ``state``/``cms`` in place (the serving hot
    path: the flow table's register file is megabytes).  ``rank`` is each
    packet's within-flow occurrence order when the caller already has it
    (the flow table computes it as a dedup by-product).

    All arithmetic is int32: exact as long as the inputs respect the wire's
    field ranges — ``ts`` non-negative int32 and every register/length
    within ``[0, FLOW_CODE_MAX]`` (lengths are clamped on entry; the update
    itself can then never leave the range).
    """
    state = np.array(state, np.int32, copy=True) if copy \
        else np.asarray(state)
    cms = np.array(cms, np.int32, copy=True) if copy else np.asarray(cms)
    slots = np.asarray(slots, np.int64).reshape(-1)
    ts = np.asarray(ts, np.int32).reshape(-1)
    length = np.minimum(
        np.maximum(np.asarray(length, np.int32).reshape(-1), 0),
        FLOW_CODE_MAX)
    n = slots.shape[0]
    code_max = np.int32(FLOW_CODE_MAX)
    feats = np.zeros((n, N_FLOW_FEATURES), np.int32)
    live = np.asarray(live).reshape(-1).astype(bool)
    idx = None if live.all() else np.nonzero(live)[0]
    if n == 0 or (idx is not None and idx.size == 0):
        return state, cms, feats
    lslots = slots if idx is None else slots[idx]

    len_q_all = sat_shl_np(length, frac)  # hoisted: round-invariant
    if rank is None:  # callers holding a flow-table rank pass it through
        rank = _rank_within_groups(lslots, state.shape[0])
    else:
        rank = np.asarray(rank).reshape(-1)
        if idx is not None:
            rank = rank[idx]
    rounds = int(rank.max()) + 1
    for r in range(rounds):
        lsel = np.nonzero(rank == r)[0] if rounds > 1 \
            else np.arange(lslots.shape[0])
        sel = lsel if idx is None else idx[lsel]
        s = slots[sel]  # one packet per flow → race-free scatter
        t = ts[sel]
        ln = length[sel]
        row = state[s]
        cnt = row[:, REG_PKT_COUNT]
        len_q = len_q_all[sel]
        iat_q = sat_shl_np(np.maximum(t - row[:, REG_LAST_TS], 0), frac)
        blend_iat = row[:, REG_EWMA_IAT] + rounding_rshift_np(
            iat_q - row[:, REG_EWMA_IAT], ewma_shift)
        blend_len = row[:, REG_EWMA_LEN] + rounding_rshift_np(
            len_q - row[:, REG_EWMA_LEN], ewma_shift)
        if (cnt > 1).all():
            # steady fast path: every flow mid-stream — the branch selects
            # below collapse to their blend/accumulate arms
            iat_e = blend_iat
            len_e = blend_len
            mn = np.minimum(row[:, REG_MIN_LEN], ln)
            mx = np.maximum(row[:, REG_MAX_LEN], ln)
            byte = np.minimum(row[:, REG_BYTE_COUNT] + ln, code_max)
            cnt2 = np.minimum(cnt + 1, code_max)
            first = row[:, REG_FIRST_TS]
        else:
            fresh = cnt == 0
            iat_e = np.where(fresh, 0,
                             np.where(cnt == 1, iat_q, blend_iat))
            len_e = np.where(fresh, len_q, blend_len)
            mn = np.where(fresh, ln, np.minimum(row[:, REG_MIN_LEN], ln))
            mx = np.where(fresh, ln, np.maximum(row[:, REG_MAX_LEN], ln))
            byte = np.where(fresh, np.minimum(ln, code_max),
                            np.minimum(row[:, REG_BYTE_COUNT] + ln,
                                       code_max))
            cnt2 = np.where(fresh, np.int32(1),
                            np.minimum(cnt + 1, code_max))
            first = np.where(fresh, t, row[:, REG_FIRST_TS])
        new_row = np.empty((s.shape[0], N_FLOW_REGISTERS), np.int32)
        for col, v in ((REG_PKT_COUNT, cnt2), (REG_BYTE_COUNT, byte),
                       (REG_LAST_TS, t), (REG_FIRST_TS, first),
                       (REG_EWMA_IAT, iat_e), (REG_EWMA_LEN, len_e),
                       (REG_MIN_LEN, mn), (REG_MAX_LEN, mx)):
            new_row[:, col] = v
        state[s] = new_row
        block = np.empty((s.shape[0], N_FLOW_FEATURES - 1), np.int32)
        block[:, 0] = sat_shl_np(cnt2, frac)
        block[:, 1] = sat_shl_np(byte >> byte_shift, frac)
        block[:, 2] = iat_e
        block[:, 3] = len_e
        block[:, 4] = sat_shl_np(mn, frac)
        block[:, 5] = sat_shl_np(mx, frac)
        block[:, 6] = sat_shl_np(
            np.maximum(t - first, 0) >> dur_shift, frac)
        feats[sel, : N_FLOW_FEATURES - 1] = block

    # count-min lane: the shared closed form (see cms_estimate_update)
    cl = np.asarray(cells, np.int64).reshape(n, -1)
    if idx is not None:
        cl = cl[idx]
    est = cms_estimate_update(cms, cl)
    cms_q = sat_shl_np(est, frac)
    if idx is None:
        feats[:, N_FLOW_FEATURES - 1] = cms_q
    else:
        feats[idx, N_FLOW_FEATURES - 1] = cms_q
    return state, cms, feats


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"flow_update_launch": [_P] * 12 + [_I] * 8 + [_P]}


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    return _build.bind("flow_update", _SYMBOLS)


def launch(state: torch.Tensor, cms: torch.Tensor, slots: torch.Tensor,
           cells: torch.Tensor, ts: torch.Tensor, length: torch.Tensor,
           live: torch.Tensor, *, frac: int, ewma_shift: int,
           byte_shift: int, dur_shift: int):
    """Launch the kernel on checked card tensors of a non-empty batch, with
    no synchronisation: returns ``(new_state, new_cms, features, err)``,
    all views into one fresh int32 allocation, ``err`` the kernel's error
    word (see :func:`flow_update_kernel`), still to be read."""
    n_slots = state.shape[0]
    depth, width_c = cms.shape
    n = slots.shape[0]
    dev = state.device
    # one allocation: the outputs, the kernels' (4 + D)·B workspace and the
    # error word
    sizes = (n_slots * N_FLOW_REGISTERS, depth * width_c,
             n * N_FLOW_FEATURES, (4 + depth) * n, 1)
    parts = torch.empty(sum(sizes), dtype=torch.int32,
                        device=dev).split(sizes)
    ctx, stream = _build.device_stream(dev)
    with ctx:
        rc = load_library().flow_update_launch(
            state.data_ptr(), cms.data_ptr(), slots.data_ptr(),
            cells.data_ptr(), ts.data_ptr(), length.data_ptr(),
            live.data_ptr(), *(t.data_ptr() for t in parts), n, n_slots,
            depth, width_c, int(frac), int(ewma_shift), int(byte_shift),
            int(dur_shift), stream)
    _build.count_launch(rc, "flow_update", launches, "flow_update")
    return (parts[0].view(n_slots, N_FLOW_REGISTERS),
            parts[1].view(depth, width_c),
            parts[2].view(n, N_FLOW_FEATURES), parts[4])


def flow_update_kernel(state: torch.Tensor, cms: torch.Tensor,
                       slots: torch.Tensor, cells: torch.Tensor,
                       ts: torch.Tensor, length: torch.Tensor,
                       live: torch.Tensor, *, frac: int, ewma_shift: int,
                       byte_shift: int, dur_shift: int):
    """Sequential scatter-update of the flow register file (the port of
    ``repro.kernels.flow_update.flow_update_pallas``, with its argument
    list): state (S, 8) int32 · cms (D, Wc) int32 · slots/ts/length/live
    (B,) int32 · cells (B, D) int32 → fresh ``(new_state, new_cms,
    features (B, 8))``; see ``ref.flow_update_numpy`` for the per-packet
    semantics.  The inputs are not modified.

    On the card it raises on a live packet whose slot lies outside
    ``[0, S)`` or whose cell lies outside ``[0, Wc)``: the kernel skips such
    a packet rather than read past the tables and sets an error word, which
    the wrapper reads once the kernel has run (one synchronisation, which
    the caller's copy-back would wait for anyway).  An empty batch launches
    nothing.
    """
    kw = dict(frac=frac, ewma_shift=ewma_shift, byte_shift=byte_shift,
              dur_shift=dur_shift)
    if state.device.type == "cpu":
        return flow_update_ref(state, cms, slots, cells, ts, length, live,
                               **kw)
    if state.device.type != "cuda":
        raise ValueError(f"no flow_update kernel for device {state.device}")
    dev = state.device
    n_slots = state.shape[0]
    depth, width_c = cms.shape
    n = slots.shape[0]
    _build.check("state", state, torch.int32, (n_slots, N_FLOW_REGISTERS), dev)
    _build.check("cms", cms, torch.int32, (depth, width_c), dev)
    _build.check("cells", cells, torch.int32, (n, depth), dev)
    for name, t in (("slots", slots), ("ts", ts), ("length", length),
                    ("live", live)):
        _build.check(name, t, torch.int32, (n,), dev)
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"sketch depth {depth} outside the kernel's "
                         f"[1, {MAX_DEPTH}]")
    if not 0 <= frac <= 30:
        raise ValueError(f"frac={frac} outside the kernel's [0, 30]")
    for name, v in (("ewma_shift", ewma_shift), ("byte_shift", byte_shift),
                    ("dur_shift", dur_shift)):
        if not 0 <= v <= 30:
            raise ValueError(f"{name}={v} outside the kernel's [0, 30]")
    if n == 0:
        return (state.clone(), cms.clone(),
                torch.empty((0, N_FLOW_FEATURES), dtype=torch.int32,
                            device=dev))
    new_state, new_cms, feats, err = launch(state, cms, slots, cells, ts,
                                            length, live, **kw)
    bad = int(err.item())
    if bad & 1:
        raise ValueError(f"flow_update: a live packet's slot lies outside "
                         f"[0, {n_slots})")
    if bad & 2:
        raise ValueError(f"flow_update: a live packet's count-min cell lies "
                         f"outside [0, {width_c})")
    return new_state, new_cms, feats
