"""Plain PyTorch versions of the serving kernels — the integer semantics the
hand-written kernels must reproduce bit for bit, and the path a wrapper
takes for tensors on the CPU.

Counterparts of ``repro.kernels.ref``: ``rounding_rshift``, ``lane_clamp``,
``_select_activation_ref``, ``fused_mlp_ref``, ``fused_mlp_gather_ref`` for
the MLP lane, with ``fused_mlp_warp_ref``, the MLP kernel's decomposition;
``forest_traverse_ref``, ``forest_traverse_gather_ref``,
``forest_range_ref``, ``forest_range_gather_ref`` and ``_forest_vote`` for
the tree-ensemble lane, with ``forest_range_grouped_ref``, the range
kernel's decomposition (packets grouped by forest in ``forest_blocks``),
and the flow engine's register-file constants,
``rounding_rshift_np``, ``sat_shl_np`` and the pure-Python per-packet
oracle ``flow_update_numpy`` (numpy, copied verbatim) beside its plain
PyTorch version ``flow_update_ref`` and ``flow_update_two_phase_ref``, the
flow kernel's decomposition of it; and the paper's two standalone
primitives, ``fixedpoint_matmul_ref`` (the W8A8 GEMM, C1) and
``taylor_activation_ref`` (the integer Horner chain, C2), with
``int32_matmul``, the exact wrapped int32 accumulator they and
``core.fixedpoint.qmatmul`` share; and ``wkv_scan_ref``, the RWKV-6 WKV
chunk scan in float32 (the one float kernel: its kernel is held to it
with a tolerance, not bit for bit), with ``wkv_scan_two_phase_ref``, the
kernel's decomposition of it (which the tests hold to it); and, in numpy,
the ingress result cache's probe sweeps ``result_cache_lookup_ref`` and
``result_cache_insert_ref``, the plain versions of the host routine
``csrc/result_cache.cpp`` and the path ``core.ingress.ResultCache`` takes
where no C++ compiler is found.  Every integer product and sum is int32 with
two's-complement wraparound, as in the reference: products are int32
tensor multiplies, and reductions use ``sum(..., dtype=torch.int32)`` so
the accumulator wraps to int32 *before* the rounding shift (a plain
``sum`` would promote to int64 and shift the unwrapped value).  No integer
matrix product is used, so the same code runs on the card, where PyTorch
has no int32 ``matmul``.

The range lane's leaf masks travel as int32 bit patterns (PyTorch has no
``uint32`` arithmetic on the CPU): ``&``, ``~``, ``+``, ``-`` and
``(x >> k) & 1`` for ``k < 32`` give the same bits as on ``uint32``, and
the lowest set bit's index is counted with the masked form's bit-test sum
(there is no popcount op).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["rounding_rshift", "lane_clamp", "fused_mlp_ref",
           "fused_mlp_gather_ref", "fused_mlp_warp_ref", "forest_traverse_ref",
           "forest_traverse_gather_ref", "forest_range_ref",
           "forest_range_gather_ref", "forest_blocks",
           "forest_range_grouped_ref",
           "FOREST_REGRESS", "FOREST_CLASSIFY",
           "REG_PKT_COUNT", "REG_BYTE_COUNT", "REG_LAST_TS", "REG_FIRST_TS",
           "REG_EWMA_IAT", "REG_EWMA_LEN", "REG_MIN_LEN", "REG_MAX_LEN",
           "N_FLOW_REGISTERS", "FLOW_FEATURE_NAMES", "N_FLOW_FEATURES",
           "FLOW_CODE_MAX", "rounding_rshift_np", "sat_shl_np",
           "flow_update_numpy", "flow_update_ref",
           "flow_update_two_phase_ref", "int32_matmul",
           "fixedpoint_matmul_ref", "taylor_activation_ref", "int32_coeffs",
           "wkv_scan_ref", "wkv_scan_two_phase_ref",
           "result_cache_lookup_ref", "result_cache_insert_ref"]


def rounding_rshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Arithmetic right shift, round-to-nearest, ties away from zero (the
    requantization primitive).  The rounding add wraps in int32."""
    if shift <= 0:
        return x
    rounding = torch.full_like(x, (1 << (shift - 1)) - 1) + (x >= 0).to(x.dtype)
    return torch.bitwise_right_shift(x + rounding, shift)


def lane_clamp(x: torch.Tensor, lane_bits: Optional[int]) -> torch.Tensor:
    """Saturate codes into a ``lane_bits``-wide signed lane (the int8
    weight-lane's requantize boundary); identity when ``None``."""
    if lane_bits is None:
        return x
    hi = (1 << (lane_bits - 1)) - 1
    return torch.clamp(x, -hi - 1, hi)


def _select_activation_ref(y: torch.Tensor, opcode: torch.Tensor, *,
                           frac: int, sig_coeffs: Sequence[int],
                           leaky_alpha_q: int) -> torch.Tensor:
    """Opcode-gated integer activation: 1 relu, 2 Taylor sigmoid (Horner
    over ``clip(y, ±2**14)``), 3 leaky relu, 4 hard sigmoid; any other
    opcode is the identity.  ``opcode`` broadcasts against ``y``."""
    relu = torch.clamp_min(y, 0)
    leaky = torch.where(y > 0, y, rounding_rshift(y * int(leaky_alpha_q), frac))
    xc = torch.clamp(y, -(1 << 14), 1 << 14)
    coeffs = [int(c) for c in sig_coeffs]
    sig = torch.full_like(y, coeffs[-1])
    for c in coeffs[-2::-1]:
        sig = rounding_rshift(sig * xc, frac) + c
    hsig = torch.clamp(rounding_rshift(y, 2) + (1 << (frac - 1)), 0, 1 << frac)
    out = y
    out = torch.where(opcode == 1, relu, out)
    out = torch.where(opcode == 2, sig, out)
    out = torch.where(opcode == 3, leaky, out)
    out = torch.where(opcode == 4, hsig, out)
    return out


def fused_mlp_ref(x_q: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, act: torch.Tensor, layer_on: torch.Tensor,
                  *, frac: int, sig_coeffs, leaky_alpha_q: int,
                  lane_bits: Optional[int] = None) -> torch.Tensor:
    """The masked-GEMM form of the fused multi-model MLP (the literal
    formulation of the TPU kernel).  Layer-major operands: x_q (B, W) int32;
    slot (B, 1) int32; w (L, M·W, W); b (L, M, W) int32; act/layer_on
    (L, M, 1) int32.  A slot outside ``[0, M)`` selects no model: every
    layer is off and the row returns its (lane-clamped) input."""
    n_batch, width = x_q.shape
    n_layers, mw, _ = w.shape
    n_models = mw // width
    m_iota = torch.arange(n_models, dtype=torch.int32, device=x_q.device)
    onehot = (slot == m_iota[None, :]).to(torch.int32)  # (B, M)
    x = lane_clamp(x_q, lane_bits)
    for l in range(n_layers):
        z = (onehot[:, :, None] * x[:, None, :]).reshape(n_batch, mw)
        acc = (z[:, :, None] * w[l].to(torch.int32)[None]).sum(
            1, dtype=torch.int32)
        acc = acc + (onehot[:, :, None] * b[l][None]).sum(1, dtype=torch.int32)
        y = rounding_rshift(acc, frac)
        opcode = (onehot * act[l][:, 0][None]).sum(1, dtype=torch.int32)
        y = _select_activation_ref(y, opcode[:, None], frac=frac,
                                   sig_coeffs=sig_coeffs,
                                   leaky_alpha_q=leaky_alpha_q)
        y = lane_clamp(y, lane_bits)
        on = (onehot * layer_on[l][:, 0][None]).sum(1, dtype=torch.int32) > 0
        x = torch.where(on[:, None], y, x)
    return x


def fused_mlp_gather_ref(x_q: torch.Tensor, slot: torch.Tensor,
                         w: torch.Tensor, b: torch.Tensor, act: torch.Tensor,
                         layer_on: torch.Tensor, *, frac: int, sig_coeffs,
                         leaky_alpha_q: int,
                         lane_bits: Optional[int] = None) -> torch.Tensor:
    """The gather form, on the control plane's own layout: each packet's
    layer is gathered by slot and applied as an int32 batched matvec.
    x_q (B, W) int32 · slot (B,) in ``[0, M)`` · w (M, L, W, W) · b (M, L, W)
    · act/layer_on (M, L) → (B, W) int32.  Bit-identical to
    :func:`fused_mlp_ref` for valid slots."""
    slot = slot.to(torch.int64)
    n_layers = w.shape[1]
    x = lane_clamp(x_q, lane_bits)
    for l in range(n_layers):
        wl = w[slot, l].to(torch.int32)  # (B, W, W)
        acc = (x[:, :, None] * wl).sum(1, dtype=torch.int32) + b[slot, l]
        y = rounding_rshift(acc, frac)
        y = _select_activation_ref(y, act[slot, l][:, None], frac=frac,
                                   sig_coeffs=sig_coeffs,
                                   leaky_alpha_q=leaky_alpha_q)
        y = lane_clamp(y, lane_bits)
        x = torch.where(layer_on[slot, l][:, None] > 0, y, x)
    return x


def fused_mlp_warp_ref(x_q: torch.Tensor, slot: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor, act: torch.Tensor,
                       layer_on: torch.Tensor, *, frac: int, sig_coeffs,
                       leaky_alpha_q: int,
                       lane_bits: Optional[int] = None) -> torch.Tensor:
    """The MLP kernel's decomposition of the fused MLP, in plain PyTorch
    (the tests hold it to the reference's gather form and Pallas kernel),
    on the control plane's own layout as the kernel reads it: x_q (B, W)
    int32 · slot (B,) · w (M, L, W, W) · b (M, L, W) · act/layer_on (M, L)
    → (B, W) int32.

    One packet per warp, lane j owning output column j: a packet whose
    slot lies in ``[0, M)`` gathers its model; per layer the column sums
    start at the bias and add ``x_i · w[i, :]`` for i ascending, in
    wrapping int32; then the rounding shift, the opcode's activation, the
    lane clamp and ``layer_on``.  A slot outside ``[0, M)`` runs no layer
    and returns its lane-clamped input, as the masked form does."""
    n_models, n_layers = act.shape
    slot = slot.to(torch.int64)
    ok = (slot >= 0) & (slot < n_models)
    x = lane_clamp(x_q, lane_bits)
    s, xs = slot[ok], x[ok]
    for l in range(n_layers):
        wl = w[s, l].to(torch.int32)
        acc = b[s, l].to(torch.int32)
        for i in range(wl.shape[1]):
            acc = acc + xs[:, i: i + 1] * wl[:, i, :]
        y = _select_activation_ref(rounding_rshift(acc, frac),
                                   act[s, l][:, None], frac=frac,
                                   sig_coeffs=sig_coeffs,
                                   leaky_alpha_q=leaky_alpha_q)
        xs = torch.where(layer_on[s, l][:, None] > 0, lane_clamp(y, lane_bits),
                         xs)
    out = x.clone()
    out[ok] = xs
    return out


# ---------------------------------------------------------------------------
# Tree-ensemble traversal — the pointer chase and the range-table form
# ---------------------------------------------------------------------------

# Forest vote modes, stored per forest slot in the control-plane tables.
FOREST_REGRESS = 0   # output lane 0 = Σ_t leaf codes (pre-divided by n_trees)
FOREST_CLASSIFY = 1  # output lane c = (1 << frac) per tree voting class c

# Node-table field order inside the packed (…, 5) axis:
#   0 feature index · 1 quantized threshold · 2 left child · 3 right child ·
#   4 leaf payload (class index / pre-divided value code).
# Leaves self-loop (left == right == self), so a level-bounded traversal of
# ``max_depth`` steps always lands on a leaf without a per-step leaf test.


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _onehot_dot(onehot: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, F) one-hot · (F, K) int32 → (B, K) int32, as an int32 product
    summed in int32 (the TPU kernel's MXU dot; at most one term is
    non-zero)."""
    return (onehot[:, :, None] * table[None]).sum(1, dtype=torch.int32)


def _vote_step(acc, leaf, on, mode_p, w_iota, one_q):
    """One tree's vote into ``acc`` (masked form): classify forests add
    ``one_q`` to lane ``leaf``, regress forests add ``leaf`` to lane 0;
    dead trees add nothing."""
    zero = torch.zeros_like(acc)
    vote_cls = torch.where(w_iota == leaf, one_q, zero)
    vote_reg = torch.where(w_iota == 0, leaf, zero)
    contrib = torch.where(mode_p == FOREST_CLASSIFY, vote_cls, vote_reg)
    return acc + torch.where(on, contrib, zero)


def forest_traverse_ref(x_q: torch.Tensor, slot: torch.Tensor,
                        nodes_t: torch.Tensor, tree_on_t: torch.Tensor,
                        mode: torch.Tensor, *, max_depth: int,
                        frac: int) -> torch.Tensor:
    """Masked (one-hot) form of the pointer chase — the TPU kernel's
    literal formulation, operand for operand.

    Kernel layout: x_q (B, W) int32 · slot (B, 1) int32 · nodes_t
    (T, F, 5·N) int32 tree-major with field-major columns
    (``nodes_t[t, f, field·N + n]``) · tree_on_t (T, F, 1) · mode (F, 1).
    Returns (B, W) int32.  A slot outside ``[0, F)`` selects nothing (all
    zero row); a node index outside ``[0, N)`` reads an all-zero record; a
    feature outside ``[0, W)`` reads ``x = 0``; a classify leaf outside
    ``[0, W)`` votes nowhere.
    """
    n_batch, width = x_q.shape
    n_trees, n_forests, ncols = nodes_t.shape
    n_nodes = ncols // 5
    dev = x_q.device
    f_iota = torch.arange(n_forests, dtype=torch.int32, device=dev)[None, :]
    onehot_f = (slot == f_iota).to(torch.int32)  # (B, F)
    mode_p = _onehot_dot(onehot_f, mode)  # (B, 1)
    n_iota = torch.arange(n_nodes, dtype=torch.int32, device=dev)[None, :]
    w_iota = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    one_q = _i32(1 << frac, dev)
    zero_x = torch.zeros_like(x_q)
    acc = torch.zeros((n_batch, width), dtype=torch.int32, device=dev)
    for t in range(n_trees):
        tbl = _onehot_dot(onehot_f, nodes_t[t])  # (B, 5·N)
        feat_t, th_t, left_t, right_t, leaf_t = (
            tbl[:, k * n_nodes: (k + 1) * n_nodes] for k in range(5))
        on = _onehot_dot(onehot_f, tree_on_t[t]) > 0
        cur = torch.zeros((n_batch, 1), dtype=torch.int32, device=dev)
        for _ in range(max_depth):
            sel = (n_iota == cur).to(torch.int32)  # (B, N)
            feat = (sel * feat_t).sum(1, keepdim=True, dtype=torch.int32)
            th = (sel * th_t).sum(1, keepdim=True, dtype=torch.int32)
            lf = (sel * left_t).sum(1, keepdim=True, dtype=torch.int32)
            rt = (sel * right_t).sum(1, keepdim=True, dtype=torch.int32)
            xv = torch.where(w_iota == feat, x_q, zero_x).sum(
                1, keepdim=True, dtype=torch.int32)
            cur = torch.where(xv <= th, lf, rt)
        sel = (n_iota == cur).to(torch.int32)
        leaf = (sel * leaf_t).sum(1, keepdim=True, dtype=torch.int32)
        acc = _vote_step(acc, leaf, on, mode_p, w_iota, one_q)
    return acc


def forest_range_ref(x_q: torch.Tensor, slot: torch.Tensor,
                     rng_t: torch.Tensor, tree_on_t: torch.Tensor,
                     mode: torch.Tensor, *, n_entries: int, n_leaves: int,
                     frac: int) -> torch.Tensor:
    """Masked (one-hot) form of the range-table traversal — the TPU range
    kernel's literal formulation.

    Kernel layout: rng_t (T, F, 3·NI + L) int32, tree-major with
    field-major columns ``feat | thresh | leaf mask (int32 bit pattern) |
    payload``; tree_on_t (T, F, 1); mode (F, 1); slot (B, 1).  Returns
    (B, W) int32.  Per tree: ``word`` = AND of the failed entries' masks,
    ``leaf_idx`` = the number of set bits among the low ``L`` bits of
    ``(word & -word) - 1`` (``L`` when ``word == 0``), and the leaf is
    ``payload[leaf_idx]``, or 0 when ``leaf_idx == L``.  ``L <= 32``.
    """
    if not 1 <= n_leaves <= 32:
        raise ValueError(f"n_leaves={n_leaves} outside the 32-bit leaf "
                         "mask's [1, 32]")
    n_batch, width = x_q.shape
    n_trees, n_forests, _ = rng_t.shape
    dev = x_q.device
    ni = n_entries
    f_iota = torch.arange(n_forests, dtype=torch.int32, device=dev)[None, :]
    onehot_f = (slot == f_iota).to(torch.int32)  # (B, F)
    mode_p = _onehot_dot(onehot_f, mode)
    w_iota = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    l_iota = torch.arange(n_leaves, dtype=torch.int32, device=dev)[None, :]
    one_q = _i32(1 << frac, dev)
    all_ones = _i32(-1, dev)
    zero_x = torch.zeros_like(x_q)
    acc = torch.zeros((n_batch, width), dtype=torch.int32, device=dev)
    for t in range(n_trees):
        tbl = _onehot_dot(onehot_f, rng_t[t])
        feat_t = tbl[:, 0: ni]
        th_t = tbl[:, ni: 2 * ni]
        mask_t = tbl[:, 2 * ni: 3 * ni]
        pay_t = tbl[:, 3 * ni: 3 * ni + n_leaves]
        on = _onehot_dot(onehot_f, tree_on_t[t]) > 0
        word = torch.full((n_batch, 1), -1, dtype=torch.int32, device=dev)
        for i in range(ni):
            xv = torch.where(w_iota == feat_t[:, i: i + 1], x_q, zero_x).sum(
                1, keepdim=True, dtype=torch.int32)
            cond = xv <= th_t[:, i: i + 1]
            word = word & torch.where(cond, all_ones, mask_t[:, i: i + 1])
        iso = word & (~word + 1)               # lowest set bit
        below = iso - 1                        # ones strictly below it
        bits = (below >> l_iota) & 1           # (B, L) bit tests
        leaf_idx = bits.sum(1, keepdim=True, dtype=torch.int32)
        leaf = torch.where(l_iota == leaf_idx, pay_t,
                           torch.zeros_like(pay_t)).sum(
            1, keepdim=True, dtype=torch.int32)
        acc = _vote_step(acc, leaf, on, mode_p, w_iota, one_q)
    return acc


def _forest_vote(leaf: torch.Tensor, on: torch.Tensor, md: torch.Tensor,
                 width: int, frac: int) -> torch.Tensor:
    """Vote accumulation over per-tree exit leaves (gather forms): classify
    forests add ``1 << frac`` to their leaf's class lane per live tree,
    regress forests sum leaf codes into lane 0.  ``leaf``/``on`` are
    (B, T); ``md`` is (B, 1)."""
    dev = leaf.device
    lane = torch.arange(width, dtype=torch.int32, device=dev)[None, None, :]
    hit = (leaf[:, :, None] == lane) & on[:, :, None]
    votes = hit.to(torch.int32).sum(1, dtype=torch.int32) * (1 << frac)
    reg = torch.where(on, leaf, torch.zeros_like(leaf)).sum(
        1, dtype=torch.int32)                                 # (B,)
    reg_out = torch.where(lane[0] == 0, reg[:, None], torch.zeros_like(votes))
    return torch.where(md == FOREST_CLASSIFY, votes, reg_out)


def forest_traverse_gather_ref(x_q: torch.Tensor, slot: torch.Tensor,
                               nodes: torch.Tensor, tree_on: torch.Tensor,
                               mode: torch.Tensor, *, max_depth: int,
                               frac: int) -> torch.Tensor:
    """Gather form of the pointer chase, on the control plane's layout:
    each step gathers only the (B, T) node records actually visited.

    x_q (B, W) int32 · slot (B,) in ``[0, F)`` · nodes (F, T, N, 5) int32 ·
    tree_on (F, T) · mode (F,) → (B, W) int32.  Bit-identical to
    :func:`forest_traverse_ref` on valid tables (every index in range)."""
    n_batch, width = x_q.shape
    _, n_trees, n_nodes, _ = nodes.shape
    s = slot.to(torch.int64)
    tr = torch.arange(n_trees, device=x_q.device)[None, :]
    base = (s[:, None] * n_trees + tr) * n_nodes   # (B, T) first record
    flat = nodes.reshape(-1, 5)
    cur = torch.zeros((n_batch, n_trees), dtype=torch.int64,
                      device=x_q.device)
    for _ in range(max_depth):
        rec = flat[base + cur]                     # (B, T, 5)
        xv = x_q.gather(1, rec[..., 0].to(torch.int64))
        cur = torch.where(xv <= rec[..., 1], rec[..., 2],
                          rec[..., 3]).to(torch.int64)
    leaf = flat[base + cur][..., 4]                # (B, T)
    on = tree_on[s] > 0
    md = mode[s][:, None]
    return _forest_vote(leaf, on, md, width, frac)


def forest_range_gather_ref(x_q: torch.Tensor, slot: torch.Tensor,
                            feat: torch.Tensor, thresh: torch.Tensor,
                            lmask: torch.Tensor, payload: torch.Tensor,
                            tree_on: torch.Tensor, mode: torch.Tensor, *,
                            frac: int) -> torch.Tensor:
    """Gather form of the range-table traversal, on the control plane's
    layout: every entry's ``x[feat] <= thresh`` at once, the failed
    entries' masks AND-reduced, the exit leaf at the lowest set bit.

    feat/thresh/lmask (F, T, NI) int32 (lmask as bit patterns) · payload
    (F, T, L) int32 · tree_on (F, T) · mode (F,) · slot (B,) in ``[0, F)``
    → (B, W) int32.  Bit-identical to :func:`forest_range_ref` on valid
    feature indices."""
    n_batch, width = x_q.shape
    n_leaves = payload.shape[-1]
    if not 1 <= n_leaves <= 32:
        raise ValueError(f"{n_leaves} leaves outside the 32-bit leaf "
                         "mask's [1, 32]")
    s = slot.to(torch.int64)
    fg = feat[s]                                   # (B, T, NI)
    n_trees, ni = fg.shape[1], fg.shape[2]
    xv = x_q.gather(1, fg.reshape(n_batch, n_trees * ni).to(torch.int64)
                    ).reshape(fg.shape)
    terms = torch.where(xv <= thresh[s], _i32(-1, x_q.device), lmask[s])
    word = terms[:, :, 0]
    for i in range(1, ni):
        word = word & terms[:, :, i]
    below = (word & (~word + 1)) - 1               # (B, T)
    l_iota = torch.arange(n_leaves, dtype=torch.int32, device=x_q.device)
    leaf_idx = ((below[:, :, None] >> l_iota) & 1).sum(-1, dtype=torch.int32)
    pay = payload[s]                               # (B, T, L)
    leaf = pay.gather(2, leaf_idx.clamp(max=n_leaves - 1)
                      .to(torch.int64)[:, :, None])[..., 0]
    leaf = torch.where(leaf_idx < n_leaves, leaf, torch.zeros_like(leaf))
    on = tree_on[s] > 0
    md = mode[s][:, None]
    return _forest_vote(leaf, on, md, width, frac)


def forest_blocks(slot: torch.Tensor, n_forests: int, chunk: int) -> list:
    """The range kernel's grouping (``csrc/forest_traversal.cu``): each
    packet's bin is its slot, or ``n_forests`` for a slot outside
    ``[0, F)``; each bin's packets, in index order, are cut into chunks of
    ``chunk``; the blocks take the chunks in (bin, chunk) order.  Returns one
    ``(bin, packet indices)`` per busy block.  The grid has
    ``ceil(B / chunk) + min(F + 1, B)`` blocks, never fewer than the
    chunks."""
    n_batch = slot.shape[0]
    s = slot.to(torch.int64)
    bins = torch.where((s >= 0) & (s < n_forests), s,
                       torch.full_like(s, n_forests))
    blocks = []
    for b in range(n_forests + 1):
        idx = torch.nonzero(bins == b).flatten()
        blocks += [(b, idx[lo: lo + chunk]) for lo in range(0, len(idx),
                                                              chunk)]
    if len(blocks) > -(-n_batch // chunk) + min(n_forests + 1, n_batch):
        raise RuntimeError("more chunks than blocks in the grid")
    return blocks


def _in_range(i: torch.Tensor, n: int) -> torch.Tensor:
    """``i`` where it lies in ``[0, n)``, else ``n`` (the index of an
    all-zero column appended to the codes)."""
    return torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))


def forest_range_grouped_ref(x_q: torch.Tensor, slot: torch.Tensor,
                             feat: torch.Tensor, thresh: torch.Tensor,
                             lmask: torch.Tensor, payload: torch.Tensor,
                             tree_on: torch.Tensor, mode: torch.Tensor, *,
                             frac: int, chunk: int = 16) -> torch.Tensor:
    """The range kernel's decomposition of the range-table traversal, in
    plain PyTorch (the tests hold it to the reference's oracle, its Pallas
    kernel and the port's gather and masked forms): packets grouped by
    forest (:func:`forest_blocks`), every row written exactly once, the
    rows of slots outside ``[0, F)`` with zeros; per block the forest's
    entries staged entry-major as {feat, thresh, lmask} records; one packet
    per warp; at T <= 16 two lanes per tree, the lane of half h ANDing the
    failed masks of entries h, h + 2, …, and the two halves' words joined by
    AND (the kernel's ``__shfl_xor_sync(…, 16)``); at T > 16 one lane per
    tree, all entries.  A feature outside ``[0, W)`` reads x = 0;
    ``word == 0`` gives leaf 0.  Same layouts as
    :func:`forest_range_gather_ref`."""
    n_batch, width = x_q.shape
    n_forests, n_trees, ni = feat.shape
    n_leaves = payload.shape[-1]
    if not 1 <= n_leaves <= 32:
        raise ValueError(f"{n_leaves} leaves outside the 32-bit leaf "
                         "mask's [1, 32]")
    halves = 2 if n_trees <= 16 else 1
    step = 32 // halves
    dev = x_q.device
    l_iota = torch.arange(n_leaves, dtype=torch.int32, device=dev)
    out = torch.empty_like(x_q)
    written = torch.zeros(n_batch, dtype=torch.int64, device=dev)
    # column W reads as 0: a feature index outside [0, W)
    xz = torch.cat([x_q, x_q.new_zeros((n_batch, 1))], 1)
    for f, idx in forest_blocks(slot, n_forests, chunk):
        written[idx] += 1
        if f == n_forests:
            out[idx] = 0
            continue
        xs = xz[idx]
        rec = torch.stack([feat[f], thresh[f], lmask[f]], -1).transpose(0, 1)
        leaf = torch.zeros((len(idx), n_trees), dtype=torch.int32,
                           device=dev)
        for t0 in range(0, n_trees, step):
            t = torch.arange(t0, min(t0 + step, n_trees), device=dev)
            word = torch.full((len(idx), len(t)), -1, dtype=torch.int32,
                              device=dev)
            for h in range(halves):
                half = torch.full_like(word, -1)
                for i in range(h, ni, halves):
                    r = rec[i, t]                          # (t, 3)
                    xv = xs[:, _in_range(r[:, 0].to(torch.int64), width)]
                    half = half & torch.where(xv <= r[:, 1], -1, r[:, 2])
                word = word & half
            below = (word & (~word + 1)) - 1
            li = ((below[..., None] >> l_iota) & 1).sum(-1, dtype=torch.int32)
            pay = payload[f, t].expand(len(idx), -1, -1)
            got = pay.gather(2, li.clamp(max=n_leaves - 1).to(torch.int64)
                             [..., None])[..., 0]
            leaf[:, t0: t0 + len(t)] = torch.where(li < n_leaves, got,
                                                   torch.zeros_like(got))
        live = (tree_on[f] > 0).expand(len(idx), n_trees)
        out[idx] = _forest_vote(leaf, live, mode[f].expand(len(idx), 1),
                                width, frac)
    if not bool((written == 1).all()):
        raise RuntimeError("an output row was not written exactly once")
    return out


# ---------------------------------------------------------------------------
# Stateful flow engine (repro_torch.flow) — per-flow register update + feature
# emit
# ---------------------------------------------------------------------------

# Register-file columns, one row per flow-table slot.  All registers are
# int32; counters/lengths/timestamps are raw integer quantities, the EWMA
# registers are fixed-point codes at the wire's ``frac`` fractional bits
# (the same grid ``core.fixedpoint.encode`` writes).
REG_PKT_COUNT = 0   # packets seen (0 ⇒ slot holds no flow state yet)
REG_BYTE_COUNT = 1  # saturating byte total
REG_LAST_TS = 2     # tick of the last packet (drives inter-arrival + expiry)
REG_FIRST_TS = 3    # tick of the first packet (drives the duration feature)
REG_EWMA_IAT = 4    # EWMA of inter-arrival ticks, code at ``frac``
REG_EWMA_LEN = 5    # EWMA of packet length, code at ``frac``
REG_MIN_LEN = 6     # smallest packet length seen
REG_MAX_LEN = 7     # largest packet length seen
N_FLOW_REGISTERS = 8

# Emitted per-packet feature lanes (post-update flow state, every lane a
# fixed-point code at ``frac`` — directly encodable into the wire's feature
# block).  ``FeatureSpec`` columns index into this order.
FLOW_FEATURE_NAMES = ("pkt_count", "byte_count", "iat_ewma", "len_ewma",
                      "len_min", "len_max", "duration", "cms_count")
N_FLOW_FEATURES = len(FLOW_FEATURE_NAMES)

# Every register/feature value lives in [0, FLOW_CODE_MAX] (EWMA deltas then
# fit int32 with headroom), so the update arithmetic can never wrap — the
# saturation bound is part of the bit-exact contract, not a soft limit.
FLOW_CODE_MAX = (1 << 30) - 1


def rounding_rshift_np(x, shift: int):
    """Numpy twin of :func:`rounding_rshift` (arithmetic right shift,
    round-to-nearest, ties away from zero)."""
    if shift <= 0:
        return x
    x = np.asarray(x)
    rounding = np.where(x >= 0, 1 << (shift - 1), (1 << (shift - 1)) - 1)
    return (x + rounding.astype(x.dtype)) >> shift


def sat_shl_np(v, shift: int):
    """Saturating left shift of a non-negative quantity onto the ``shift``
    fractional-bit code grid: values beyond ``FLOW_CODE_MAX >> shift``
    saturate instead of wrapping."""
    v = np.minimum(np.maximum(v, 0), FLOW_CODE_MAX >> shift)
    return v << shift


def flow_update_numpy(state: np.ndarray, cms: np.ndarray, slots: np.ndarray,
                      cells: np.ndarray, ts: np.ndarray, length: np.ndarray,
                      live: np.ndarray, *, frac: int, ewma_shift: int,
                      byte_shift: int, dur_shift: int):
    """THE flow-update oracle: a pure-Python per-packet walk of the register
    file, in batch order.

    Deliberately scalar (the hardware analogue is one packet at a time
    through the stateful ALU) so nothing about the vectorized formulations
    can leak into the reference semantics; the CUDA kernel, the rank-round
    CPU lowering (``kernels.flow_update``) and :func:`flow_update_ref` must
    reproduce it bit for bit — including the saturation bounds and the
    rounding-shift EWMA.

    state  (S, N_FLOW_REGISTERS) int32 — per-slot register rows
    cms    (D, Wc) int32 — count-min sketch counters
    slots  (B,) int32 — flow-table slot per packet (resolved by FlowTable)
    cells  (B, D) int32 — count-min cell per packet per sketch row
    ts     (B,) int32 — arrival tick; length (B,) int32 — wire bytes
    live   (B,) bool/int — 0 rows are padding: no state touch, zero features

    Returns ``(new_state, new_cms, features)`` with ``features`` of shape
    ``(B, N_FLOW_FEATURES)`` int32 codes at ``frac`` — the **post-update**
    flow state as each packet observed it, which is what a per-packet
    stateful P4 pipeline exports to its ML stage.
    """
    state = np.array(state, np.int32, copy=True)
    cms = np.array(cms, np.int32, copy=True)
    slots = np.asarray(slots).reshape(-1)
    n = slots.shape[0]
    depth = cms.shape[0]
    feats = np.zeros((n, N_FLOW_FEATURES), np.int32)

    def _shl(v, s=frac):
        return int(sat_shl_np(int(v), s))

    for p in range(n):
        if not live[p]:
            continue
        s = int(slots[p])
        t = int(ts[p])
        ln = max(int(length[p]), 0)
        row = state[s]
        cnt = int(row[REG_PKT_COUNT])
        len_q = _shl(ln)
        if cnt == 0:  # fresh slot: this packet opens the flow
            first = t
            iat_e = 0
            len_e = len_q
            mn = mx = ln
            byte = min(ln, FLOW_CODE_MAX)
            cnt2 = 1
        else:
            iat_q = _shl(max(t - int(row[REG_LAST_TS]), 0))
            if cnt == 1:  # first inter-arrival sample seeds the EWMA
                iat_e = iat_q
            else:
                iat_e = int(row[REG_EWMA_IAT]) + int(rounding_rshift_np(
                    np.int64(iat_q - int(row[REG_EWMA_IAT])), ewma_shift))
            len_e = int(row[REG_EWMA_LEN]) + int(rounding_rshift_np(
                np.int64(len_q - int(row[REG_EWMA_LEN])), ewma_shift))
            mn = min(int(row[REG_MIN_LEN]), ln)
            mx = max(int(row[REG_MAX_LEN]), ln)
            byte = min(int(row[REG_BYTE_COUNT]) + ln, FLOW_CODE_MAX)
            cnt2 = min(cnt + 1, FLOW_CODE_MAX)
            first = int(row[REG_FIRST_TS])
        state[s] = (cnt2, byte, t, first, iat_e, len_e, mn, mx)
        est = FLOW_CODE_MAX
        for d in range(depth):
            c = int(cells[p, d])
            cms[d, c] = min(int(cms[d, c]) + 1, FLOW_CODE_MAX)
            est = min(est, int(cms[d, c]))
        feats[p] = (_shl(cnt2), _shl(byte >> byte_shift), iat_e, len_e,
                    _shl(mn), _shl(mx), _shl(max(t - first, 0) >> dur_shift),
                    _shl(est))
    return state, cms, feats


def _sat_shl(v: torch.Tensor, shift: int) -> torch.Tensor:
    """torch twin of :func:`sat_shl_np` (saturating shift onto the code
    grid, int32)."""
    return torch.clamp(v, 0, FLOW_CODE_MAX >> shift) << shift


def _group_rank(keys: torch.Tensor) -> torch.Tensor:
    """Stable per-key occurrence rank: the k-th occurrence of a key (in
    array order) gets rank k (int64)."""
    n = keys.shape[0]
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    newg = torch.ones(n, dtype=torch.bool, device=keys.device)
    newg[1:] = sk[1:] != sk[:-1]
    ar = torch.arange(n, device=keys.device)
    gstart = torch.cummax(torch.where(newg, ar, torch.zeros_like(ar)),
                          0).values
    rank = torch.empty(n, dtype=torch.int64, device=keys.device)
    rank[order] = ar - gstart
    return rank


def _flow_step(row: torch.Tensor, t: torch.Tensor, ln: torch.Tensor, *,
               frac: int, ewma_shift: int, byte_shift: int, dur_shift: int):
    """One packet through each of a set of distinct flows' rows (int32
    (k, N_FLOW_REGISTERS), ``ln`` clamped to [0, FLOW_CODE_MAX]): returns
    the updated rows and the packets' seven register features (k, 7)."""
    code_max = torch.tensor(FLOW_CODE_MAX, dtype=torch.int32, device=row.device)
    cnt = row[:, REG_PKT_COUNT]
    fresh = cnt == 0
    len_q = _sat_shl(ln, frac)
    iat_q = _sat_shl(torch.clamp_min(t - row[:, REG_LAST_TS], 0), frac)
    blend_iat = row[:, REG_EWMA_IAT] + rounding_rshift(
        iat_q - row[:, REG_EWMA_IAT], ewma_shift)
    blend_len = row[:, REG_EWMA_LEN] + rounding_rshift(
        len_q - row[:, REG_EWMA_LEN], ewma_shift)
    zero = torch.zeros_like(cnt)
    iat_e = torch.where(fresh, zero, torch.where(cnt == 1, iat_q, blend_iat))
    len_e = torch.where(fresh, len_q, blend_len)
    mn = torch.where(fresh, ln, torch.minimum(row[:, REG_MIN_LEN], ln))
    mx = torch.where(fresh, ln, torch.maximum(row[:, REG_MAX_LEN], ln))
    byte = torch.where(fresh, torch.minimum(ln, code_max),
                       torch.minimum(row[:, REG_BYTE_COUNT] + ln, code_max))
    cnt2 = torch.where(fresh, torch.ones_like(cnt),
                       torch.minimum(cnt + 1, code_max))
    first = torch.where(fresh, t, row[:, REG_FIRST_TS])
    new_row = torch.stack([cnt2, byte, t, first, iat_e, len_e, mn, mx], dim=1)
    feats = torch.stack([
        _sat_shl(cnt2, frac), _sat_shl(byte >> byte_shift, frac), iat_e,
        len_e, _sat_shl(mn, frac), _sat_shl(mx, frac),
        _sat_shl(torch.clamp_min(t - first, 0) >> dur_shift, frac)], dim=1)
    return new_row, feats


def flow_update_ref(state: torch.Tensor, cms: torch.Tensor,
                    slots: torch.Tensor, cells: torch.Tensor,
                    ts: torch.Tensor, length: torch.Tensor,
                    live: torch.Tensor, *, frac: int, ewma_shift: int,
                    byte_shift: int, dur_shift: int):
    """Plain PyTorch version of the flow update, on any device: the
    rank-round form (round ``r`` updates every flow's rank-``r`` live packet
    at once, so the EWMA chains stay in batch order and each round's
    scatter touches distinct rows), int32 throughout, and the count-min
    lane in its closed form — packet p's estimate in row d is
    ``min(prior + rank_in_cell + 1, FLOW_CODE_MAX)`` and every cell adds
    its live count, saturating.

    Same arguments and results as :func:`flow_update_numpy` (int32 tensors;
    ``state``/``cms`` are not modified, fresh tensors come back).  Exact
    on the contract of ``kernels.flow_update.flow_update_gather``: ``ts``
    non-negative int32, registers and lengths in ``[0, FLOW_CODE_MAX]``,
    slots in ``[0, S)`` and cells in ``[0, Wc)``.
    """
    dev = state.device
    i32 = torch.int32
    kw = dict(frac=frac, ewma_shift=ewma_shift, byte_shift=byte_shift,
              dur_shift=dur_shift)
    state = state.to(i32).clone()
    cms = cms.to(i32).clone()
    slots = slots.reshape(-1).to(torch.int64)
    n = slots.shape[0]
    feats = torch.zeros((n, N_FLOW_FEATURES), dtype=i32, device=dev)
    if n == 0:
        return state, cms, feats
    idx = torch.nonzero(live.reshape(-1) != 0).reshape(-1)
    if idx.numel() == 0:
        return state, cms, feats
    ts = ts.reshape(-1).to(i32)
    length = torch.clamp(length.reshape(-1).to(i32), 0, FLOW_CODE_MAX)
    lslots = slots[idx]
    rank = _group_rank(lslots)
    for r in range(int(rank.max()) + 1):
        sel = idx[rank == r]       # one packet per flow: distinct rows
        s = slots[sel]
        state[s], feats[sel, : N_FLOW_FEATURES - 1] = _flow_step(
            state[s], ts[sel], length[sel], **kw)
    # count-min lane: increments commute, so each estimate is closed-form
    cl = cells.reshape(n, -1).to(torch.int64)[idx]
    est = torch.full((idx.numel(),), FLOW_CODE_MAX, dtype=torch.int64,
                     device=dev)
    for d in range(cms.shape[0]):
        cd = cl[:, d]
        prior = cms[d, cd].to(torch.int64)
        est = torch.minimum(est, torch.clamp_max(
            prior + _group_rank(cd) + 1, FLOW_CODE_MAX))
        counts = torch.bincount(cd, minlength=cms.shape[1])
        cms[d] = torch.clamp_max(cms[d].to(torch.int64) + counts,
                                 FLOW_CODE_MAX).to(i32)
    feats[idx, N_FLOW_FEATURES - 1] = _sat_shl(est.to(i32), frac)
    return state, cms, feats


def flow_update_two_phase_ref(state: torch.Tensor, cms: torch.Tensor,
                              slots: torch.Tensor, cells: torch.Tensor,
                              ts: torch.Tensor, length: torch.Tensor,
                              live: torch.Tensor, *, frac: int,
                              ewma_shift: int, byte_shift: int,
                              dur_shift: int):
    """The flow kernel's decomposition of :func:`flow_update_ref`, in plain
    PyTorch (the tests hold it to the numpy oracle and to
    :func:`flow_update_ref`):

      links (kernel 1), every live packet i at once, from its comparisons
      with every other packet j of the batch:
          less[i]   = the live packets whose slot is smaller than i's
          before[i] = the live packets of i's slot earlier than i (0: i
                      heads its flow), after[i] = those later than i
          order[less[i] + before[i]] = i: the live packets sorted by
                      (slot, batch index), each flow one run in batch order
          rank_d[i] = the earlier live packets in i's cell of sketch row d
          last_d[i] = no later live packet in that cell
      update (kernel 2): each head takes its row from the input register
          file and walks its run order[less, less + before + after + 1)
          (here one step of every run per round), writing each packet's
          seven register features, then the row; every live packet's
          estimate is min over d of min(prior + rank_d + 1,
          FLOW_CODE_MAX), with prior from the input sketch, and a cell's
          last packet writes its row d's value into the output sketch.

    Same arguments, results and contract as :func:`flow_update_ref`; it
    holds (B, B) comparison matrices, so it is for small batches.
    """
    dev = state.device
    i32 = torch.int32
    kw = dict(frac=frac, ewma_shift=ewma_shift, byte_shift=byte_shift,
              dur_shift=dur_shift)
    state_in, cms_in = state.to(i32), cms.to(i32)
    new_state, new_cms = state_in.clone(), cms_in.clone()
    slots = slots.reshape(-1).to(torch.int64)
    n = slots.shape[0]
    feats = torch.zeros((n, N_FLOW_FEATURES), dtype=i32, device=dev)
    alive = live.reshape(-1) != 0
    if not bool(alive.any()):
        return new_state, new_cms, feats
    ts = ts.reshape(-1).to(i32)
    length = torch.clamp(length.reshape(-1).to(i32), 0, FLOW_CODE_MAX)
    cl = cells.reshape(n, -1).to(torch.int64)
    # kernel 1: [i, j] comparisons, j earlier / later than i
    pos = torch.arange(n, device=dev)
    earlier = pos[None, :] < pos[:, None]
    later = pos[None, :] > pos[:, None]
    pair = alive[:, None] & alive[None, :]
    same = pair & (slots[None, :] == slots[:, None])
    less = (pair & (slots[None, :] < slots[:, None])).sum(1)
    before = (same & earlier).sum(1)
    after = (same & later).sum(1)
    order = torch.empty(int(alive.sum()), dtype=torch.int64, device=dev)
    order[(less + before)[alive]] = pos[alive]
    in_cell = [pair & (cl[None, :, d] == cl[:, None, d])
               for d in range(cms.shape[0])]
    rank = [(eq & earlier).sum(1) for eq in in_cell]
    last = [~(eq & later).any(1) for eq in in_cell]
    # kernel 2: each head's run, one step of every run per round
    heads = pos[alive & (before == 0)]
    start, run = less[heads], after[heads] + 1
    rows = state_in[slots[heads]]
    for r in range(int(run.max())):
        on = run > r
        cur = order[start[on] + r]
        rows[on], feats[cur, : N_FLOW_FEATURES - 1] = _flow_step(
            rows[on], ts[cur], length[cur], **kw)
    new_state[slots[heads]] = rows
    p = pos[alive]
    est = torch.full((p.numel(),), FLOW_CODE_MAX, dtype=torch.int64,
                     device=dev)
    for d in range(cms.shape[0]):
        c = cl[p, d]
        e = torch.clamp_max(cms_in[d, c].to(torch.int64) + rank[d][p] + 1,
                            FLOW_CODE_MAX)
        est = torch.minimum(est, e)
        writer = last[d][p]
        new_cms[d, c[writer]] = e[writer].to(i32)
    feats[p, N_FLOW_FEATURES - 1] = _sat_shl(est.to(i32), frac)
    return new_state, new_cms, feats


# ---------------------------------------------------------------------------
# The paper's standalone primitives: the W8A8 GEMM (C1) and the integer
# Taylor activation (C2)
# ---------------------------------------------------------------------------

_F64_EXACT = 1 << 53  # every integer below this is exact in float64


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wraparound (explicitly, rather
    than trusting the cast)."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _f64_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def int32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (..., K) · b (K, N)`` on integer codes → ``(..., N)`` int32: the
    accumulator of the reference's ``dot_general(...,
    preferred_element_type=int32)``, which wraps in int32.

    PyTorch has no integer ``matmul`` on the card, so the products are summed
    in float64, which is exact while every partial sum stays below 2**53:
    directly for codes of up to 16 bits, and for wider codes (int32) after
    splitting each operand into 16-bit halves, of which only the terms that
    survive modulo 2**32 are formed.  The same code runs on the CPU and on
    the card."""
    if a.is_floating_point() or b.is_floating_point():
        raise TypeError(f"integer codes expected, got {a.dtype} and {b.dtype}")
    k = a.shape[-1]
    bits = max(torch.iinfo(a.dtype).bits, torch.iinfo(b.dtype).bits)
    if bits <= 16 and k * (1 << 30) < _F64_EXACT:
        return _wrap_i32(_f64_matmul(a, b))
    if bits > 32 or k * (1 << 33) >= _F64_EXACT:
        raise ValueError(f"K={k} of {a.dtype} · {b.dtype} codes is beyond "
                         "the exact int32 accumulator")
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    a_lo, a_hi = a64 & 0xFFFF, a64 >> 16
    b_lo, b_hi = b64 & 0xFFFF, b64 >> 16
    low = _f64_matmul(a_lo, b_lo) & 0xFFFFFFFF
    cross = (_f64_matmul(a_hi, b_lo) + _f64_matmul(a_lo, b_hi)) & 0xFFFF
    return _wrap_i32(low + (cross << 16))


def fixedpoint_matmul_ref(x_codes: torch.Tensor, w_codes: torch.Tensor,
                          x_scale: torch.Tensor, w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """W8A8 GEMM: int8 × int8 → int32 accumulate → float rescale.

    x_codes (M, K) int8 with per-row scale (M, 1) float32; w_codes (K, N)
    int8 with per-column scale (1, N) float32.  Returns float32 (M, N):
    ``acc * x_scale * w_scale (+ bias)``, in that order."""
    acc = int32_matmul(x_codes, w_codes)
    out = acc.to(torch.float32) * x_scale * w_scale
    if bias is not None:
        out = out + bias
    return out


def int32_coeffs(coeffs_q) -> list:
    """Taylor constants as Python ints; raises ``OverflowError`` on one
    outside int32, as the reference's ``jnp.int32(c)`` does (a PyTorch
    int32 add would wrap it silently)."""
    coeffs = [int(c) for c in np.asarray(coeffs_q).reshape(-1).tolist()]
    if not coeffs:
        raise ValueError("at least one Taylor constant is needed")
    for c in coeffs:
        if not -(1 << 31) <= c < (1 << 31):
            raise OverflowError(f"Taylor constant {c} outside int32")
    return coeffs


def taylor_activation_ref(x_q: torch.Tensor, coeffs_q,
                          x_frac: int) -> torch.Tensor:
    """Integer Horner (paper Table 3 × Table 4): ``acc = c_n``, then
    ``acc = rounding_rshift(acc · x, x_frac) + c_k`` for each lower constant,
    in int32 with wraparound.  ``x_q`` carries ``x_frac`` fractional bits
    (the caller clamps it); ``coeffs_q`` are ascending int codes at the
    coefficient scale, which the result carries.  ``x_frac <= 0`` shifts
    nothing."""
    x = x_q.to(torch.int32)
    coeffs = int32_coeffs(coeffs_q)
    acc = torch.full_like(x, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = rounding_rshift(acc * x, x_frac) + c
    return acc


def wkv_scan_ref(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                 tot: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """Plain version of the WKV chunk-scan kernel: the chunks of each (B·H)
    row in order, the (D, D) state starting at zero, in the inputs' dtype
    (float32 on the model's path; a check may pass float64):

        scores = strict_tril(a·bᵀ)
        o      = scores·v + diag ⊙ v + a·S
        S      ← S ⊙ totᵀ + (b ⊙ tot)ᵀ·v     (row d of S scaled by tot[d])

    a/b/v: (BH, NC, C, D); tot: (BH, NC, 1, D); diag: (BH, NC, C, 1).
    Returns o: (BH, NC, C, D).  The rows run side by side (a batched
    product per chunk), which is the reference's vmap over rows."""
    bh, nc, c, d = a.shape
    tri = torch.tril(torch.ones((c, c), dtype=a.dtype, device=a.device),
                     diagonal=-1)
    s = torch.zeros((bh, d, d), dtype=a.dtype, device=a.device)
    outs = []
    for i in range(nc):
        a_c, b_c, v_c = a[:, i], b[:, i], v[:, i]
        tot_c, diag_c = tot[:, i], diag[:, i]  # (BH, 1, D), (BH, C, 1)
        scores = (a_c @ b_c.transpose(1, 2)) * tri
        outs.append(scores @ v_c + diag_c * v_c + a_c @ s)
        s = s * tot_c.transpose(1, 2) + (b_c * tot_c).transpose(1, 2) @ v_c
    if not outs:
        return torch.zeros_like(a)
    return torch.stack(outs, dim=1)


def wkv_scan_two_phase_ref(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor,
                           tot: torch.Tensor, diag: torch.Tensor
                           ) -> torch.Tensor:
    """The WKV card kernel's two-phase decomposition of ``wkv_scan_ref``, in
    plain PyTorch (the tests hold it to ``wkv_scan_ref``):

        phase 1, every chunk at once:  o_n  = strict_tril(a_n·b_nᵀ)·v_n
                                              + diag_n ⊙ v_n
                                       ΔS_n = (b_n ⊙ tot_n)ᵀ·v_n
        phase 2, chunks in order:      o_n += a_n·S_n
                                       S_{n+1} = S_n ⊙ tot_nᵀ + ΔS_n

    with S_0 = 0; the same products as ``wkv_scan_ref``, summed in the
    kernel's order."""
    bh, nc, c, d = a.shape
    tri = torch.tril(torch.ones((c, c), dtype=a.dtype, device=a.device),
                     diagonal=-1)
    o = (a @ b.transpose(-1, -2)) * tri @ v + diag * v
    dstate = (b * tot).transpose(-1, -2) @ v          # (BH, NC, D, D)
    s = torch.zeros((bh, d, d), dtype=a.dtype, device=a.device)
    outs = []
    for i in range(nc):
        outs.append(o[:, i] + a[:, i] @ s)
        s = s * tot[:, i].transpose(1, 2) + dstate[:, i]
    if not outs:
        return torch.zeros_like(a)
    return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# The ingress result cache's probe sweeps (numpy), the plain versions of
# csrc/result_cache.cpp: one round of vectorized probes per chain step.
# ---------------------------------------------------------------------------


def _chain(hashes: np.ndarray, mask: np.int64):
    """Home slots and odd steps of the cache's double hashing."""
    slot = (hashes & np.uint64(mask)).astype(np.int64)
    # odd step → full-cycle double hashing over the power-of-two table
    step = ((((hashes >> np.uint64(32)) << np.uint64(1)) | np.uint64(1))
            .astype(np.int64)) & mask
    return slot, step


def result_cache_lookup_ref(keys: np.ndarray, vals: np.ndarray,
                            state: np.ndarray, max_probe: int,
                            words: np.ndarray, hashes: np.ndarray,
                            hit_slot: np.ndarray, hit_vals: np.ndarray):
    """Probe ``words`` (``(N, key_words)`` uint64, their ``hashes``) in the
    table ``keys``/``vals``/``state``.  Writes each row's hit slot or -1
    into ``hit_slot`` and the hit rows' values, in row order, into the
    first rows of ``hit_vals``.  Returns ``(hits, slots visited)``."""
    mask = np.int64(keys.shape[0] - 1)
    slot, _ = _chain(hashes, mask)
    # fast first round, no indirection: with load < load_limit almost
    # every probe resolves at its home slot
    st = state[slot]
    match = (keys[slot] == words).all(axis=1) & (st == 1)
    hit_slot[:] = np.where(match, slot, np.int64(-1))
    visited = slot.size
    # keep probing through tombstones and colliding keys; an empty slot
    # terminates the probe chain → definitive miss
    pending = np.nonzero(~match & (st != 0))[0]
    if pending.size:
        _, step = _chain(hashes[pending], mask)
        cur = (slot[pending] + step) & mask
        active = np.arange(pending.size)
        for _ in range(max_probe - 1):
            if active.size == 0:
                break
            visited += active.size
            s = cur[active]
            rows = pending[active]
            st = state[s]
            m = (keys[s] == words[rows]).all(axis=1) & (st == 1)
            hit_slot[rows[m]] = s[m]
            keep = ~m & (st != 0)
            active = active[keep]
            cur[active] = (cur[active] + step[active]) & mask
    hits = hit_slot >= 0
    n_hit = int(hits.sum())
    hit_vals[:n_hit] = vals[hit_slot[hits]]
    return n_hit, visited


def result_cache_insert_ref(keys: np.ndarray, vals: np.ndarray,
                            state: np.ndarray, model: np.ndarray,
                            claim: np.ndarray, max_probe: int,
                            words: np.ndarray, new_vals: np.ndarray,
                            model_ids: np.ndarray, hashes: np.ndarray):
    """Insert rows ``words → new_vals`` (model ``model_ids``) into the
    table in probe rounds: a row on a full slot holding its key refreshes
    the value; rows on slots that are not full claim them, arbitrated by
    **scatter** into the ``claim`` scratch (the last writer wins, losers
    re-probe); a loser whose slot its own key just claimed refreshes in
    place instead of claiming a second slot.  Rows still unplaced after
    ``max_probe`` rounds are dropped.  Returns ``(admitted, tombstones
    reclaimed, slots visited)``."""
    n = words.shape[0]
    mask = np.int64(keys.shape[0] - 1)
    slot, step = _chain(hashes, mask)
    admitted = reclaimed = visited = 0

    def _settle(rows: np.ndarray, s: np.ndarray):
        """One probe round for rows (indices into the chunk) at slots
        ``s``: refresh matches, claim empties/tombstones, return the
        boolean keep-probing mask over ``rows``."""
        nonlocal admitted, reclaimed, visited
        visited += rows.size
        st = state[s]
        full = st == 1
        match = (keys[s] == words[rows]).all(axis=1) & full
        if match.any():
            vals[s[match]] = new_vals[rows[match]]
        need = ~full
        if need.any():
            ci = np.nonzero(need)[0]
            cs = s[ci]
            # scatter arbitration: duplicate slots keep the last writer
            # (deterministic in numpy fancy assignment); losers see a
            # foreign row index on read-back and probe on
            claim[cs] = ci
            win = claim[cs] == ci
            wi = ci[win]
            ws = s[wi]
            rw = rows[wi]
            reclaimed += int((st[wi] == 2).sum())
            keys[ws] = words[rw]
            vals[ws] = new_vals[rw]
            model[ws] = model_ids[rw]
            state[ws] = 1
            admitted += ws.size
            unresolved = ~match
            unresolved[wi] = False
            # an arbitration loser whose slot was claimed by its OWN
            # key this round (duplicate keys in one call) must refresh
            # in place, not claim a second slot downstream
            li = ci[~win]
            if li.size:
                ls = s[li]
                lm = (keys[ls] == words[rows[li]]).all(axis=1) \
                    & (state[ls] == 1)
                if lm.any():
                    sel = li[lm]
                    vals[s[sel]] = new_vals[rows[sel]]
                    unresolved[sel] = False
            return unresolved
        return ~match

    keep = _settle(np.arange(n), slot)  # fast home-slot round
    if keep.any():
        pending = np.nonzero(keep)[0]
        stepp = step[pending]
        cur = (slot[pending] + stepp) & mask
        for _ in range(max_probe - 1):
            if pending.size == 0:
                break
            keep = _settle(pending, cur)
            pending = pending[keep]
            stepp = stepp[keep]
            cur = (cur[keep] + stepp) & mask
    return admitted, reclaimed, visited
