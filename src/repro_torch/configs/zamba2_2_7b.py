"""zamba2-2.7b [hybrid] — arXiv:2411.15242 (hf-verified).

54 Mamba2 layers (d_model=2560, ssm_state=64) with a SHARED attention block
(32 heads, GQA kv=32, d_ff=10240) applied every 6 SSM layers — the weights of
the attention block are shared across all applications (Zamba's signature).
Hybrid ⇒ runs `long_500k`; its attention block uses the Taylor-softmax
linear form at 500k (attention_impl is a per-run override).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,  # attention block head dim: 2560/32
    d_ff=10240,
    vocab_size=32_000,
    activation="gelu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    hybrid_attn_every=6,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
