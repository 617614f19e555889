"""The work a DeepSeek-V2 (MLA + MoE) prefill needs, from the
``config.json`` sizes, at the card's bf16 peaks (``work_lm``: 989.4e12
FLOP/s, 3.35e12 bytes/s of HBM; NVIDIA's data sheet, H100 SXM, dense).

A projection ``(M, K) @ (K, N)`` needs ``2·M·K·N`` FLOP.  A layer's MLA
runs six projections (``W_qa``, ``W_qb``, ``W_kva``, ``W_kb``, ``W_vb``,
``W_o``) and causal attention, ``2·(dn + dr) + 2·dv`` FLOP per head and
(query, key) pair on or below the diagonal.  A dense layer's FFN is a
SwiGLU of width ``intermediate_size``; an MoE layer's the router, the
routed experts (three projections of width ``moe_intermediate_size`` per
routed slot, ``num_experts_per_tok`` slots a token) and the shared SwiGLU
of width ``n_shared_experts·moe_intermediate_size``.  The last position's
head is one ``(B, d) @ (d, V)``.
"""

from __future__ import annotations

from portbench.work_lm import BF16_FLOP_PER_S, HBM_BYTES_PER_S

BF16_BYTES = 2


def mla_projections(sizes: dict) -> list:
    """(K, N) of one layer's MLA projections."""
    d, h = sizes["hidden_size"], sizes["num_attention_heads"]
    dn, dr = sizes["qk_nope_head_dim"], sizes["qk_rope_head_dim"]
    dv, lq = sizes["v_head_dim"], sizes["q_lora_rank"]
    lkv = sizes["kv_lora_rank"]
    return [(d, lq), (lq, h * (dn + dr)), (d, lkv + dr), (lkv, h * dn),
            (lkv, h * dv), (h * dv, d)]


def attention_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one layer's causal attention over ``batch`` prompts."""
    pairs = seq * (seq + 1) / 2
    per_pair = 2 * (sizes["qk_nope_head_dim"] + sizes["qk_rope_head_dim"]) \
        + 2 * sizes["v_head_dim"]
    return per_pair * pairs * sizes["num_attention_heads"] * batch


def expert_flop(sizes: dict, slots: int) -> float:
    """FLOP of the routed experts' three projections over ``slots`` rows."""
    return 6.0 * slots * sizes["hidden_size"] * sizes["moe_intermediate_size"]


def expert_bytes(sizes: dict, slots: int) -> float:
    """Bytes the routed experts of one layer must move: every expert's
    three bf16 matrices read once, the slots' input rows read once and
    their output rows written once."""
    d, fe = sizes["hidden_size"], sizes["moe_intermediate_size"]
    weights = 3 * sizes["n_routed_experts"] * d * fe
    return BF16_BYTES * (weights + 2 * slots * d)


def expert_bound_s(sizes: dict, slots: int) -> float:
    """The least time of one layer's routed experts: FLOP at the bf16
    rate or bytes at HBM bandwidth, whichever is longer."""
    return max(expert_flop(sizes, slots) / BF16_FLOP_PER_S,
               expert_bytes(sizes, slots) / HBM_BYTES_PER_S)


def call_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one prefill call over every layer, and the head."""
    m = batch * seq
    d = sizes["hidden_size"]
    n, k = sizes["num_hidden_layers"], sizes["first_k_dense_replace"]
    per_layer = sum(2.0 * m * a * c for a, c in mla_projections(sizes)) \
        + attention_flop(sizes, batch, seq)
    dense = 6.0 * m * d * sizes["intermediate_size"]
    moe = (2.0 * m * d * sizes["n_routed_experts"]
           + expert_flop(sizes, m * sizes["num_experts_per_tok"])
           + 6.0 * m * d * sizes["moe_intermediate_size"]
           * sizes["n_shared_experts"])
    head = 2.0 * batch * d * sizes["vocab_size"]
    return n * per_layer + k * dense + (n - k) * moe + head
