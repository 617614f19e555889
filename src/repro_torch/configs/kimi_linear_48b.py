"""kimi-linear-48b [kimi_linear] — Kimi-Linear-48B-A3B-Instruct as
published: arXiv:2510.26692 and
https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct/blob/main/config.json.

27 layers of width 2304, RMSNorm eps 1e-5, no position encoding anywhere,
vocabulary 163840 with an untied head.  Mixers in a 3 : 1 pattern: the 20
layers of ``kda_layers`` run Kimi Delta Attention (32 heads of key and
value width 128, a causal depthwise conv of width 4 on q, k and v), the
7 of ``full_attn_layers`` MLA without rotary parts (``mla_use_nope``; 32
heads, no q LoRA, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128, the
softmax scale 1/√192).  Layer 1's FFN is a dense SwiGLU of width 9216;
layers 2–27 are MoE: 256 experts of width 1024, top 8, one shared expert,
sigmoid scores with a selection bias, one expert group (so no group
limit), the picked scores renormalised and times 2.446, every slot
computed.  bf16 weights and activations: 49.1e9 parameters, 98 GB.
"""

from .base import KimiLinearConfig

KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
              23, 25, 26)
FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)

CONFIG = KimiLinearConfig(
    name="kimi-linear-48b",
    family="kimi_linear",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,
    head_dim=192,  # qk_nope + qk_rope
    d_ff=9216,
    moe_d_ff=1024,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    vocab_size=163_840,
    activation="silu",
    norm_eps=1e-5,
    mla=True,
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    first_k_dense_replace=1,
    n_group=1,
    topk_group=1,
    routed_scaling_factor=2.446,
    norm_topk_prob=True,
    moe_dropless=True,
    kda_layers=KDA_LAYERS,
    full_attn_layers=FULL_ATTN_LAYERS,
    kda_num_heads=32,
    kda_head_dim=128,
    short_conv_kernel_size=4,
    mla_use_nope=True,
    moe_router_activation_func="sigmoid",
)
