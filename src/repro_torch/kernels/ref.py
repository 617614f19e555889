"""Plain PyTorch versions of the serving kernels — the integer semantics the
hand-written kernels must reproduce bit for bit, and the path a wrapper
takes for tensors on the CPU.

Counterparts of ``repro.kernels.ref``: ``rounding_rshift``, ``lane_clamp``,
``_select_activation_ref``, ``fused_mlp_ref``, ``fused_mlp_gather_ref`` for
the MLP lane, and ``forest_traverse_ref``, ``forest_traverse_gather_ref``,
``forest_range_ref``, ``forest_range_gather_ref`` and ``_forest_vote`` for
the tree-ensemble lane.  Every product and sum is int32 with
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

import torch

__all__ = ["rounding_rshift", "lane_clamp", "fused_mlp_ref",
           "fused_mlp_gather_ref", "forest_traverse_ref",
           "forest_traverse_gather_ref", "forest_range_ref",
           "forest_range_gather_ref", "FOREST_REGRESS", "FOREST_CLASSIFY"]


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
