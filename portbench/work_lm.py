"""The work a decoder-only LM prefill needs, from the published sizes, and
the card's peaks it is priced at.

Peaks of one NVIDIA H100 SXM at its full 700 W power limit (NVIDIA's data
sheet, dense rates): 1979e12 int8 operations/s on the tensor cores,
989.4e12 bf16 FLOP/s, 3.35e12 bytes/s of HBM.

A projection ``(M, K) @ (K, N)`` on the W8A8 datapath needs ``2·M·N·K``
operations and reads its int8 codes (``M·K + K·N`` bytes) and float32
scales (``4·(M + N)``) once and writes its float32 output (``4·M·N``)
once.  Causal attention needs ``2·2·Dh`` FLOP per (query, key) pair on or
below the diagonal and per head: the scores and the weighted sum.  The
last position's unembedding is one bf16 ``(B, d) @ (d, V)``.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12
BF16_FLOP_PER_S = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def projections(sizes: dict) -> list:
    """(K, N) of one layer's projections: q, k, v, o, gate, up, down."""
    d, f = sizes["hidden_size"], sizes["intermediate_size"]
    kv = sizes["num_key_value_heads"] * (d // sizes["num_attention_heads"])
    return [(d, d), (d, kv), (d, kv), (d, d), (d, f), (d, f), (f, d)]


def gemm_bound_s(m: int, k: int, n: int) -> float:
    """The least time of one W8A8 GEMM: the larger of its operations over
    the int8 rate and its bytes over HBM bandwidth."""
    n_bytes = m * k + k * n + 4 * (m + n) + 4 * m * n
    return max(2 * m * n * k / INT8_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)


def gemms(sizes: dict, batch: int, seq: int) -> list:
    """(M, K, N) of every W8A8 GEMM of one prefill call, layer by layer."""
    m = batch * seq
    return [(m, k, n) for _ in range(sizes["num_hidden_layers"])
            for k, n in projections(sizes)]


def attention_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one prefill call's causal attention, all layers."""
    h = sizes["num_attention_heads"]
    dh = sizes["hidden_size"] // h
    pairs = seq * (seq + 1) / 2
    return 4.0 * dh * pairs * h * batch * sizes["num_hidden_layers"]


def ideal_call_s(sizes: dict, batch: int, seq: int) -> float:
    """The model's operations of one prefill call at the card's peaks: the
    W8A8 GEMMs at the int8 rate, attention and the unembedding at the bf16
    rate."""
    gemm_ops = sum(2 * m * k * n for m, k, n in gemms(sizes, batch, seq))
    head = 2.0 * batch * sizes["hidden_size"] * sizes["vocab_size"]
    return (gemm_ops / INT8_OPS_PER_S
            + (attention_flop(sizes, batch, seq) + head) / BF16_FLOP_PER_S)
