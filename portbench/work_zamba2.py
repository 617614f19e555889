"""The work a Zamba2 (Mamba-2 + shared attention) prefill needs, from the
``config.json`` sizes and the published SSD chunk (``chunk_size``), at the
card's peaks (``work_lm``: 989.4e12 bf16 FLOP/s, 3.35e12 bytes/s of HBM;
NVIDIA's data sheet, H100 SXM, dense).

A projection ``(M, K) @ (K, N)`` needs ``2·M·K·N`` FLOP.  A Mamba layer
runs the in-projection (``hidden → 2·d_inner + 2·G·N + H``) and the
out-projection (``d_inner → hidden``).  A shared application runs q, k, v
(``2·hidden → H_a·D`` each), ``W_o``, the gate and up projection
(``hidden → 2·ffn``), its adapter (``hidden → r → 2·ffn``), the down
projection and its ``linear`` (``hidden → hidden``), and causal attention:
``2·2·D`` FLOP per head and (query, key) pair on or below the diagonal.
The last position's tied head is one ``(B, hidden) @ (hidden, V)``.

The SSD of one layer at chunk ``Q`` (``chunk_size``), per token: for each
head the intra-chunk product ``2·Q·P`` (scores against x), the chunk's
state ``2·N·P`` and the output from the state entering the chunk
``2·N·P``; for each group ``2·Q·N`` (C against B).  Its bytes: x
(``d_inner``), B and C (``2·G·N``) and dt (``H``) read once in bf16, y
(``d_inner``) written once in bf16, and the float32 state at the end of
every chunk (``H·P·N`` per row and chunk) written once and read once.
These come from the published widths and chunk whatever chunk the program
runs, so that every SSD is judged on the same work.
"""

from __future__ import annotations

from portbench.work_lm import BF16_FLOP_PER_S, HBM_BYTES_PER_S

BF16_BYTES = 2


def mamba_projections(sizes: dict) -> list:
    """(K, N) of one Mamba layer's projections."""
    d = sizes["hidden_size"]
    d_in = sizes["mamba_expand"] * d
    gn = sizes["mamba_ngroups"] * sizes["mamba_d_state"]
    return [(d, 2 * d_in + 2 * gn + sizes["n_mamba_heads"]), (d_in, d)]


def shared_projections(sizes: dict) -> list:
    """(K, N) of one shared application's projections, its adapter and
    its ``linear`` included."""
    d, f = sizes["hidden_size"], sizes["intermediate_size"]
    ha = sizes["num_attention_heads"] * sizes["attention_head_dim"]
    out = [(2 * d, ha)] * 3 + [(ha, d), (d, 2 * f), (f, d), (d, d)]
    if sizes["use_shared_mlp_adapter"]:
        r = sizes["adapter_rank"]
        out += [(d, r), (r, 2 * f)]
    return out


def attention_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one application's causal attention over ``batch`` prompts."""
    pairs = seq * (seq + 1) / 2
    return 4.0 * sizes["attention_head_dim"] * pairs \
        * sizes["num_attention_heads"] * batch


def _chunks(sizes: dict, seq: int) -> int:
    return -(-seq // sizes["chunk_size"])


def ssd_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one layer's SSD at the published chunk."""
    q, n = sizes["chunk_size"], sizes["mamba_d_state"]
    p, h = sizes["mamba_headdim"], sizes["n_mamba_heads"]
    tokens = batch * _chunks(sizes, seq) * q
    return tokens * (h * (2.0 * q * p + 4.0 * n * p)
                     + sizes["mamba_ngroups"] * 2.0 * q * n)


def ssd_bytes(sizes: dict, batch: int, seq: int) -> float:
    """Bytes one layer's SSD must move at the published chunk."""
    d_in = sizes["mamba_expand"] * sizes["hidden_size"]
    h, n = sizes["n_mamba_heads"], sizes["mamba_d_state"]
    gn = sizes["mamba_ngroups"] * n
    io = BF16_BYTES * batch * seq * (2 * d_in + 2 * gn + h)
    states = 4 * 2 * batch * _chunks(sizes, seq) * h \
        * sizes["mamba_headdim"] * n
    return float(io + states)


def ssd_bound_s(sizes: dict, batch: int, seq: int) -> float:
    """The least time of one layer's SSD: FLOP at the bf16 rate or bytes
    at HBM bandwidth, whichever is longer."""
    return max(ssd_flop(sizes, batch, seq) / BF16_FLOP_PER_S,
               ssd_bytes(sizes, batch, seq) / HBM_BYTES_PER_S)


def call_flop(sizes: dict, batch: int, seq: int) -> float:
    """FLOP of one prefill call: every layer, every application, the SSDs
    and the head."""
    m = batch * seq
    mamba = sum(2.0 * m * a * c for a, c in mamba_projections(sizes)) \
        + ssd_flop(sizes, batch, seq)
    shared = sum(2.0 * m * a * c for a, c in shared_projections(sizes)) \
        + attention_flop(sizes, batch, seq)
    head = 2.0 * batch * sizes["hidden_size"] * sizes["vocab_size"]
    return sizes["num_hidden_layers"] * mamba \
        + len(sizes["hybrid_layer_ids"]) * shared + head
