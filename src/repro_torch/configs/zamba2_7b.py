"""zamba2-7b [zamba2] — Zamba2-7B-Instruct as published: arXiv:2411.15242
and https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json.

81 Mamba-2 layers of width 3584 (expand 2: 112 heads of 64, state 64,
2 groups of heads sharing B and C, a depthwise conv of width 4 with
bias, the gated RMSNorm over each group's 3584 channels after the SiLU
gate).  Before the 13 layers of ``hybrid_layer_ids`` one of 2 shared
blocks runs, alternating (application ``j`` on block ``j % 2``): RMSNorm
over the hidden state concatenated with the embedding (7168), attention
with 32 heads of 224 (no GQA, RoPE θ 1e4 over all 224 dims, softmax
scale (224/2)^-½), RMSNorm, a gated GELU MLP of width 14336 whose gate
and up projection take a rank-128 LoRA adapter of the application's own,
and the application's own ``linear`` (3584 → 3584).  Its output is added
to the next Mamba layer's input only, not to the residual stream.
RMSNorm eps 1e-5, vocabulary 32000, the head tied to the embedding
(``Zamba2Config``'s default: the published file omits the key).  dt is
``softplus(dt + dt_bias)`` unclamped (``time_step_limit`` null), as the
published CUDA path computes it.  bf16 weights and activations: 7.35e9
parameters, 14.7 GB.
"""

from .base import Zamba2Config

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = Zamba2Config(
    name="zamba2-7b",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,  # attention_head_dim: 2·d_model / n_heads
    d_ff=14336,
    vocab_size=32_000,
    activation="gelu",
    norm_eps=1e-5,
    tie_embeddings=True,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    dtype="bfloat16",
    param_dtype="bfloat16",
    hybrid_layer_ids=HYBRID_LAYER_IDS,
    num_mem_blocks=2,
    attention_hidden_size=7168,
    attention_head_dim=224,
    adapter_rank=128,
    use_shared_mlp_adapter=True,
    use_shared_attention_adapter=False,
    mamba_ngroups=2,
    use_mem_rope=True,
    chunk_size=256,
)
