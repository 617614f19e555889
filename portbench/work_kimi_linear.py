"""The work a Kimi Linear (KDA + MLA + MoE) prefill needs, from the
``config.json`` sizes, at the card's bf16 peaks (``work_lm``: 989.4e12
FLOP/s, 3.35e12 bytes/s of HBM; NVIDIA's data sheet, H100 SXM, dense).

A projection ``(M, K) @ (K, N)`` needs ``2·M·K·N`` FLOP.  A KDA layer
runs W_qkv (``hidden → 3·H·D``), the decay's and the output gate's two
factors (``hidden → D → H·D`` each), W_b (``hidden → H``) and W_o
(``H·D → hidden``), and the chunked recurrence.  An MLA layer runs W_q,
W_kva, W_kb, W_vb and W_o (no q LoRA) and causal attention
(``work_mla_moe.attention_flop``).  A dense layer's FFN is a SwiGLU of
width ``intermediate_size``; an MoE layer's the router, the routed
experts (``num_experts_per_token`` slots a token) and the shared SwiGLU
of width ``num_shared_experts·moe_intermediate_size``.  The last
position's head is one ``(B, d) @ (d, V)``.

KDA's recurrence is priced in its chunked form at chunk ``KDA_CHUNK``
(C) whatever form runs it, per chunk and head (D the head dim): the
decayed products q·k and k·k inside the chunk, ``2·C²·D``; the
triangular transform of the pseudo-values and keys, ``2·C²·D``; the
output's intra-chunk part, ``C²·D``; and against the state, the
pseudo-values' correction, the output and the state's update,
``3·2·C·D²``.  Its bytes: q, k, v in and o out once in bf16, the decays
g (``H·D`` a token) and β (``H``) once in float32.
"""

from __future__ import annotations

from portbench import work_mla_moe
from portbench.work_lm import BF16_FLOP_PER_S, HBM_BYTES_PER_S

BF16_BYTES = 2
F32_BYTES = 4
KDA_CHUNK = 64


def _kda(sizes: dict) -> tuple:
    la = sizes["linear_attn_config"]
    return la["num_heads"], la["head_dim"]


def kda_projections(sizes: dict) -> list:
    """(K, N) of one KDA layer's projections."""
    d = sizes["hidden_size"]
    h, dh = _kda(sizes)
    hd = h * dh
    return [(d, 3 * hd), (d, dh), (dh, hd), (d, h), (d, dh), (dh, hd),
            (hd, d)]


def mla_projections(sizes: dict) -> list:
    """(K, N) of one MLA layer's projections (no q LoRA)."""
    d, h = sizes["hidden_size"], sizes["num_attention_heads"]
    dn, dr = sizes["qk_nope_head_dim"], sizes["qk_rope_head_dim"]
    dv, lkv = sizes["v_head_dim"], sizes["kv_lora_rank"]
    return [(d, h * (dn + dr)), (d, lkv + dr), (lkv, h * dn), (lkv, h * dv),
            (h * dv, d)]


def kda_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one layer's KDA recurrence in its chunked form."""
    h, d = _kda(sizes)
    c = KDA_CHUNK
    chunks = batch * -(-seq // c) * h
    return chunks * (5.0 * c * c * d + 6.0 * c * d * d)


def kda_bytes(sizes: dict, batch: int, seq: int) -> float:
    """Bytes one layer's KDA recurrence must move: q, k, v, o in bf16, g
    and β in float32, each once."""
    h, d = _kda(sizes)
    tokens = batch * seq
    return float(tokens * (4 * BF16_BYTES * h * d
                           + F32_BYTES * (h * d + h)))


def kda_bound_s(sizes: dict, batch: int, seq: int) -> float:
    """The least time of one layer's KDA recurrence: FLOP at the bf16 rate
    or bytes at HBM bandwidth, whichever is longer."""
    return max(kda_flop(sizes, batch, seq) / BF16_FLOP_PER_S,
               kda_bytes(sizes, batch, seq) / HBM_BYTES_PER_S)


def _moe_sizes(sizes: dict) -> dict:
    """The MoE's sizes under ``work_mla_moe``'s (DeepSeek's) key names."""
    return dict(hidden_size=sizes["hidden_size"],
                moe_intermediate_size=sizes["moe_intermediate_size"],
                n_routed_experts=sizes["num_experts"])


def expert_bound_s(sizes: dict, slots: int) -> float:
    """The least time of one layer's routed experts over ``slots`` rows
    (``work_mla_moe.expert_bound_s``)."""
    return work_mla_moe.expert_bound_s(_moe_sizes(sizes), slots)


def layer_counts(sizes: dict) -> dict:
    """KDA, MLA, dense and MoE layers among the ``num_hidden_layers``."""
    n = sizes["num_hidden_layers"]
    kda = sum(1 for i in sizes["linear_attn_config"]["kda_layers"] if i <= n)
    k = sizes["first_k_dense_replace"]
    return dict(kda=kda, mla=n - kda, dense=k, moe=n - k)


def call_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one prefill call over every layer, and the head."""
    m = batch * seq
    d = sizes["hidden_size"]
    n = layer_counts(sizes)
    kda = sum(2.0 * m * a * c for a, c in kda_projections(sizes)) \
        + kda_flop(sizes, batch, seq)
    mla = sum(2.0 * m * a * c for a, c in mla_projections(sizes)) \
        + work_mla_moe.attention_flop(sizes, batch, seq)
    dense = 6.0 * m * d * sizes["intermediate_size"]
    moe = (2.0 * m * d * sizes["num_experts"]
           + work_mla_moe.expert_flop(_moe_sizes(sizes),
                                      m * sizes["num_experts_per_token"])
           + 6.0 * m * d * sizes["moe_intermediate_size"]
           * sizes["num_shared_experts"])
    head = 2.0 * batch * d * sizes["vocab_size"]
    return (n["kda"] * kda + n["mla"] * mla + n["dense"] * dense
            + n["moe"] * moe + head)
