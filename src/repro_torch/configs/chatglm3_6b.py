"""chatglm3-6b [dense] — arXiv:2406.12793 (hf-verified).

28L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696 SwiGLU, vocab 65024.
"RoPE 2d": rotary applied to half of each head's dims (rope_fraction=0.5).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65_024,
    activation="silu",
    qkv_bias=True,  # chatglm applies bias on QKV only
    rope_fraction=0.5,
    rope_theta=10_000.0,
    accum_steps=2,
)
