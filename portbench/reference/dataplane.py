"""The paper's packet data plane in plain NumPy: the reference that decides
``correct`` for the ``feat16`` and ``flow16`` configurations.

What it states, from the float weights, the trees and the traffic alone:

* Control-plane quantization (paper Table 2): a weight is
  ``round(w * 2**frac)`` (half away from zero, in float32) saturated to the
  16-bit lane, a bias ``round(b * 2**(2*frac))`` saturated to int32; forest
  thresholds and regression leaves (pre-divided by the tree count) on the
  wire's code grid, int32.
* The MLP lane: per layer ``acc = sum_i x_i * w_ij + b_j`` in wrapping int32,
  the rounding right shift by ``frac`` (ties away from zero), the opcode's
  activation (relu, the order-3 Taylor sigmoid by Horner over the input
  clipped to +-2**14, leaky relu with slope code 3, hard sigmoid), and the
  model's output lanes kept (the rest zero).  An uninstalled Model ID
  answers a zero row.
* The forest lane: each tree walked from its root, left when the feature
  code is at most the threshold code; a classifier adds ``2**frac`` to its
  leaf's class lane, a regressor adds its leaf code to lane 0.
* The flow stage: per 5-tuple, packet by packet in arrival order, the eight
  registers (count, saturating bytes, last and first tick, the two
  rounding-shift EWMAs, min and max length) and the count-min sketch
  (two rows of 4096 cells), and the eight feature codes each packet sees
  after its own update; a packet whose Model ID is not installed is an
  error slot and touches no state.
* Egress: the 7-byte header (Model ID, feature count 32, output count 32,
  scale ``frac``, flags | RESULT) and the 32 output codes, big-endian.

The hash that places a flow in the sketch, and the sigmoid's Taylor
constants, are frozen copies of the integer semantics the configuration
states; nothing else is shared with the program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

FRAC = 8
WIDTH = 32
HEADER_BYTES = 7
FLAG_RESULT = 0x02
LEAKY_Q = 3                          # round(0.01 * 2**FRAC)
SIGMOID_Q = (128, 64, 0, -5)         # int(c * 2**FRAC) of 1/2, 1/4, 0, -1/48
ACT = {"none": 0, "relu": 1, "sigmoid": 2, "leaky_relu": 3,
       "hard_sigmoid": 4}
FLOW_CODE_MAX = (1 << 30) - 1
EWMA_SHIFT, BYTE_SHIFT, DUR_SHIFT = 3, 6, 10
CMS_DEPTH, CMS_WIDTH_POW2 = 2, 12
RAW_KEY_BYTES = 13

# the 64-bit key hash and the sketch rows' odd multipliers
_KEY_MULTS = ((np.random.default_rng(0xC0FFEE).integers(
    0, 2 ** 63, 64, np.uint64) << np.uint64(1)) | np.uint64(1))
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_CMS_MULTS = ((np.random.default_rng(0x51E7C4).integers(
    0, 2 ** 63, 8, np.uint64) << np.uint64(1)) | np.uint64(1))


def wrap32(x: np.ndarray) -> np.ndarray:
    """int64 values → the int64 holding the int32 with the same low bits."""
    return ((np.asarray(x, np.int64) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def rshift_round(x: np.ndarray, shift: int) -> np.ndarray:
    """Arithmetic right shift, round to nearest, ties away from zero, with
    the rounding add wrapping in int32 (int64 in, int64 out)."""
    rounding = (1 << (shift - 1)) - 1 + (x >= 0)
    return wrap32(x + rounding) >> shift


def encode(a, frac: int, bits: int) -> np.ndarray:
    """``round(a * 2**frac)``, half away from zero in float32, saturated to
    a signed ``bits``-wide code (int64)."""
    s = np.asarray(a, np.float32) * np.float32(2.0 ** frac)
    r = np.sign(s) * np.floor(np.abs(s) + np.float32(0.5))
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    r = np.clip(r, np.float32(lo), np.float32(hi))
    return np.clip(np.nan_to_num(r).astype(np.int64), lo, hi)


# ---------------------------------------------------------------------------
# MLP lane
# ---------------------------------------------------------------------------


def quantize_mlp(layers: Sequence, acts: Sequence[str], final: str) -> dict:
    """One model's tables: weights (L, W, W), biases (L, W), opcodes (L,),
    and its output width."""
    names = (list(acts) + [final])[: len(layers)]
    w = np.zeros((len(layers), WIDTH, WIDTH), np.int64)
    b = np.zeros((len(layers), WIDTH), np.int64)
    for k, (wk, bk) in enumerate(layers):
        din, dout = np.shape(wk)
        w[k, :din, :dout] = encode(wk, FRAC, 16)
        b[k, :dout] = encode(bk, 2 * FRAC, 32)
    return dict(w=w, b=b, act=[ACT[a] for a in names],
                out_dim=int(np.shape(layers[-1][0])[1]))


def activation(y: np.ndarray, opcode: int) -> np.ndarray:
    if opcode == 1:
        return np.maximum(y, 0)
    if opcode == 2:
        xc = np.clip(y, -(1 << 14), 1 << 14)
        sig = np.full_like(y, SIGMOID_Q[-1])
        for c in SIGMOID_Q[-2::-1]:
            sig = wrap32(rshift_round(wrap32(sig * xc), FRAC) + c)
        return sig
    if opcode == 3:
        return np.where(y > 0, y, rshift_round(wrap32(y * LEAKY_Q), FRAC))
    if opcode == 4:
        return np.clip(rshift_round(y, 2) + (1 << (FRAC - 1)), 0, 1 << FRAC)
    return y


def mlp_forward(x: np.ndarray, model: dict) -> np.ndarray:
    """(n, W) int codes → (n, W) int64 output codes of one model."""
    x = np.asarray(x, np.int64)
    for k in range(model["w"].shape[0]):
        acc = wrap32(x @ model["w"][k] + model["b"][k][None, :])
        x = activation(rshift_round(acc, FRAC), model["act"][k])
    out = np.zeros_like(x)
    out[:, : model["out_dim"]] = x[:, : model["out_dim"]]
    return out


# ---------------------------------------------------------------------------
# forest lane
# ---------------------------------------------------------------------------


def quantize_forest(forest: dict) -> dict:
    """Thresholds and leaves on the code grid; classifier leaves are class
    indices, regressor leaves ``encode(value / n_trees)``."""
    n = len(forest["trees"])
    trees = []
    for t in forest["trees"]:
        leaf = np.asarray(t["left"]) < 0
        if forest["task"] == "classify":
            leaf_q = np.asarray(t["value"], np.float32).astype(np.int64)
        else:
            leaf_q = encode(np.asarray(t["value"], np.float32)
                            / np.float32(n), FRAC, 32)
        trees.append(dict(feature=np.asarray(t["feature"], np.int64),
                          thresh=encode(t["threshold"], FRAC, 32),
                          left=np.asarray(t["left"], np.int64),
                          right=np.asarray(t["right"], np.int64),
                          leaf=np.where(leaf, leaf_q, 0), is_leaf=leaf))
    return dict(trees=trees, task=forest["task"],
                out_dim=(forest["n_classes"] if forest["task"] == "classify"
                         else 1))


def tree_leaves(x: np.ndarray, tree: dict) -> tuple:
    """Walk one tree for every row: returns (leaf node, internal nodes on
    the path)."""
    node = np.zeros(x.shape[0], np.int64)
    steps = np.zeros(x.shape[0], np.int64)
    rows = np.arange(x.shape[0])
    while True:
        inner = ~tree["is_leaf"][node]
        if not inner.any():
            return node, steps
        xv = x[rows, tree["feature"][node]]
        nxt = np.where(xv <= tree["thresh"][node], tree["left"][node],
                       tree["right"][node])
        node = np.where(inner, nxt, node)
        steps += inner


def forest_forward(x: np.ndarray, forest: dict) -> np.ndarray:
    x = np.asarray(x, np.int64)
    acc = np.zeros((x.shape[0], WIDTH), np.int64)
    rows = np.arange(x.shape[0])
    for tree in forest["trees"]:
        leaf = tree["leaf"][tree_leaves(x, tree)[0]]
        if forest["task"] == "classify":
            ok = (leaf >= 0) & (leaf < WIDTH)
            np.add.at(acc, (rows[ok], leaf[ok]), 1 << FRAC)
        else:
            acc[:, 0] = wrap32(acc[:, 0] + leaf)
    out = np.zeros_like(acc)
    out[:, : forest["out_dim"]] = acc[:, : forest["out_dim"]]
    return out


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def parse_features(rows: np.ndarray) -> tuple:
    """Feature packets (n, 7 + 4W) → (Model IDs, flags, (n, W) int64 codes
    with features past each packet's declared count zeroed)."""
    rows = np.asarray(rows, np.uint8)
    mid = (rows[:, 0].astype(np.int64) << 8) | rows[:, 1]
    cnt = rows[:, 2].astype(np.int64)
    flags = rows[:, 6].astype(np.int64)
    x = rows[:, HEADER_BYTES: HEADER_BYTES + 4 * WIDTH].copy().view(
        ">i4").astype(np.int64)
    x[np.arange(WIDTH)[None, :] >= cnt[:, None]] = 0
    return mid, flags, x


def egress(mid: np.ndarray, flags: np.ndarray, out: np.ndarray
           ) -> np.ndarray:
    n = out.shape[0]
    row = np.zeros((n, HEADER_BYTES + 4 * WIDTH), np.uint8)
    row[:, 0] = (mid >> 8) & 0xFF
    row[:, 1] = mid & 0xFF
    row[:, 2] = WIDTH
    row[:, 3] = WIDTH
    row[:, 5] = FRAC
    row[:, 6] = (flags | FLAG_RESULT) & 0xFF
    row[:, HEADER_BYTES:] = (out & 0xFFFFFFFF).astype(">u4").view(
        np.uint8).reshape(n, 4 * WIDTH)
    return row


def answer(mid: np.ndarray, x: np.ndarray, mlps: Dict[int, dict],
           forests: Dict[int, dict]) -> np.ndarray:
    """Output codes (n, W) for parsed Model IDs and input codes."""
    out = np.zeros((x.shape[0], WIDTH), np.int64)
    for m, model in mlps.items():
        sel = np.nonzero(mid == m)[0]
        if sel.size:
            out[sel] = mlp_forward(x[sel], model)
    for m, forest in forests.items():
        sel = np.nonzero(mid == m)[0]
        if sel.size:
            out[sel] = forest_forward(x[sel], forest)
    return out


def feature_egress(rows: np.ndarray, mlps: Dict[int, dict],
                   forests: Dict[int, dict]) -> np.ndarray:
    """Egress rows for feature packets (every packet answers; an
    uninstalled Model ID answers zeros)."""
    mid, flags, x = parse_features(rows)
    return egress(mid, flags, answer(mid, x, mlps, forests))


# ---------------------------------------------------------------------------
# flow stage
# ---------------------------------------------------------------------------


def key_hash(keys: np.ndarray) -> np.ndarray:
    """64-bit hash of 13-byte flow keys (two little-endian words)."""
    buf = np.zeros((keys.shape[0], 16), np.uint8)
    buf[:, : keys.shape[1]] = keys
    words = buf.view(np.uint64)
    h = words[:, 0] * _KEY_MULTS[0] + words[:, 1] * _KEY_MULTS[1]
    h ^= h >> np.uint64(30)
    h *= _MIX1
    h ^= h >> np.uint64(27)
    h *= _MIX2
    h ^= h >> np.uint64(31)
    return h


def parse_raw(raw: np.ndarray) -> dict:
    raw = np.asarray(raw, np.uint8)

    def be(col, nbytes):
        v = np.zeros(raw.shape[0], np.int64)
        for i in range(nbytes):
            v = (v << 8) | raw[:, col + i]
        return v
    return dict(keys=raw[:, :RAW_KEY_BYTES], mid=be(13, 2), ts=be(15, 4),
                length=be(19, 2))


def _sat_shl(v: np.ndarray) -> np.ndarray:
    return np.clip(v, 0, FLOW_CODE_MAX >> FRAC) << FRAC


def flow_features(raw: np.ndarray, installed: Sequence[int]) -> dict:
    """Run the flow stage over a whole stream in arrival order.

    Returns ``ok`` (packets whose Model ID is installed), their features
    (n_ok, 8), the final registers per flow with the flows' keys, the
    sketch, and the number of flows created."""
    f = parse_raw(raw)
    ok = np.isin(f["mid"], np.asarray(sorted(installed), np.int64))
    keys = np.ascontiguousarray(f["keys"][ok])
    ts, ln = f["ts"][ok], np.maximum(f["length"][ok], 0)
    n = keys.shape[0]
    h = key_hash(keys)
    # flows by hash, then every packet's key checked against its flow's
    _, first, flow = np.unique(h, return_index=True, return_inverse=True)
    flow = flow.reshape(-1)
    if not np.array_equal(keys, keys[first[flow]]):
        raise ValueError("two flow keys share a 64-bit hash")
    n_flows = first.shape[0]
    # the count-min sketch: each packet's cell count after its own
    # increment is one plus the earlier packets in that cell
    cells = ((h[:, None] * _CMS_MULTS[None, :CMS_DEPTH])
             >> np.uint64(64 - CMS_WIDTH_POW2)).astype(np.int64)
    cms = np.zeros((CMS_DEPTH, 1 << CMS_WIDTH_POW2), np.int64)
    est = np.full(n, FLOW_CODE_MAX, np.int64)
    for d in range(CMS_DEPTH):
        c = cells[:, d]
        est = np.minimum(est, np.minimum(_rank_in_group(c) + 1,
                                         FLOW_CODE_MAX))
        cms[d] = np.minimum(np.bincount(c, minlength=cms.shape[1]),
                            FLOW_CODE_MAX)
    # registers: round r advances every flow's r-th packet at once
    rank = _rank_in_group(flow)
    order = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[order], np.arange(rank.max() + 2))
    reg = np.zeros((n_flows, 8), np.int64)   # the eight registers
    feats = np.zeros((n, 8), np.int64)
    len_q_all = _sat_shl(ln)
    for r in range(rank.max() + 1):
        p = order[bounds[r]: bounds[r + 1]]
        s = flow[p]
        t, length, len_q = ts[p], ln[p], len_q_all[p]
        if r == 0:
            row = np.stack([np.ones_like(t), np.minimum(length,
                            FLOW_CODE_MAX), t, t, np.zeros_like(t), len_q,
                            length, length], 1)
        else:
            old = reg[s]
            cnt = old[:, 0]
            iat_q = _sat_shl(np.maximum(t - old[:, 2], 0))
            iat_e = np.where(cnt == 1, iat_q, old[:, 4] + _rs_round(
                iat_q - old[:, 4], EWMA_SHIFT))
            len_e = old[:, 5] + _rs_round(len_q - old[:, 5], EWMA_SHIFT)
            row = np.stack([np.minimum(cnt + 1, FLOW_CODE_MAX),
                            np.minimum(old[:, 1] + length, FLOW_CODE_MAX),
                            t, old[:, 3], iat_e, len_e,
                            np.minimum(old[:, 6], length),
                            np.maximum(old[:, 7], length)], 1)
        reg[s] = row
        feats[p, 0] = _sat_shl(row[:, 0])
        feats[p, 1] = _sat_shl(row[:, 1] >> BYTE_SHIFT)
        feats[p, 2] = row[:, 4]
        feats[p, 3] = row[:, 5]
        feats[p, 4] = _sat_shl(row[:, 6])
        feats[p, 5] = _sat_shl(row[:, 7])
        feats[p, 6] = _sat_shl(np.maximum(t - row[:, 3], 0) >> DUR_SHIFT)
    feats[:, 7] = _sat_shl(est)
    return dict(ok=ok, mid=f["mid"][ok], feats=feats,
                keys=keys[first],
                registers=reg, cms=cms, n_flows=n_flows)


def _rs_round(x: np.ndarray, shift: int) -> np.ndarray:
    """The flow EWMA's rounding shift (no wrap: its operands are bounded)."""
    return (x + np.where(x >= 0, 1 << (shift - 1),
                         (1 << (shift - 1)) - 1)) >> shift


def _rank_in_group(g: np.ndarray) -> np.ndarray:
    """k for the k-th occurrence (from 0) of each value, in array order."""
    order = np.argsort(g, kind="stable")
    sg = g[order]
    start = np.r_[True, sg[1:] != sg[:-1]]
    idx = np.arange(g.shape[0])
    first = np.maximum.accumulate(np.where(start, idx, 0))
    rank = np.empty(g.shape[0], np.int64)
    rank[order] = idx - first
    return rank


def spec_inputs(feats: np.ndarray, mid: np.ndarray,
                specs: Dict[int, Sequence[int]]) -> np.ndarray:
    """Each packet's model inputs: its model's FeatureSpec columns of its
    flow features."""
    x = np.zeros((feats.shape[0], WIDTH), np.int64)
    for m, cols in specs.items():
        sel = np.nonzero(mid == m)[0]
        if sel.size:
            x[sel] = feats[sel][:, np.asarray(cols)]
    return x
