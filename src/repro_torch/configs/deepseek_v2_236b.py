"""deepseek-v2-236b [moe] — arXiv:2405.04434 (hf-verified).

60L, d_model=5120, 128 heads with MLA (kv_lora=512, rope_dim=64,
nope_dim=128, v_head=128), per-expert d_ff=1536, 160 routed experts top-6 +
2 shared, vocab 102400.  236B total / ~21B active parameters.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,  # qk_nope + qk_rope
    d_ff=1536,
    moe_d_ff=1536,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    vocab_size=102_400,
    activation="silu",
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    # 236B on a 256-chip v5e pod needs microbatching: global 256 → 4×64
    accum_steps=4,
)
