"""deepseek-v2 [moe] — DeepSeek-V2 as published: arXiv:2405.04434 and
https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json.

60 layers, d_model 5120, 128 heads of MLA (q_lora 1536, kv_lora 512,
qk_nope 128, qk_rope 64, v_head 128), RMSNorm eps 1e-6, no attention
bias, vocabulary 102400 with an untied head.  Layer 0 is a dense SwiGLU
of width 12288 (``first_k_dense_replace``); layers 1–59 are MoE: 160
routed experts of width 1536, top-6, plus 2 shared (a SwiGLU of width
3072).  Routing is ``group_limited_greedy``: softmax scores, 8 groups of
20 experts, the top 6 taken among the experts of the best 3 groups,
gates ``16·p`` with no renormalisation, every slot computed (dropless).
RoPE is YaRN (factor 40 over 4096 original positions, β_fast 32, β_slow
1, θ 1e4, mscale = mscale_all_dim = 0.707), which also scales the
softmax by mscale².

One departure: the published code de-interleaves the rope channels
before its rotate-half; the port rotates halves as laid out.  With
weights drawn at random that is a fixed permutation of the rope columns
of ``wq_b`` and ``wkv_a``.
"""

from .base import DeepSeekConfig

ROPE_SCALING = {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                "mscale": 0.707, "mscale_all_dim": 0.707,
                "original_max_position_embeddings": 4096, "type": "yarn"}

CONFIG = DeepSeekConfig(
    name="deepseek-v2",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,  # qk_nope + qk_rope
    d_ff=12288,
    moe_d_ff=1536,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    vocab_size=102_400,
    activation="silu",
    norm_eps=1e-6,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    first_k_dense_replace=1,
    n_group=8,
    topk_group=3,
    routed_scaling_factor=16.0,
    norm_topk_prob=False,
    moe_dropless=True,
    rope_scaling=tuple(sorted(ROPE_SCALING.items())),
)
