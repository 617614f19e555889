"""qwen2-1.5b [dense] — arXiv:2407.10671 (hf-verified).

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960 SwiGLU, vocab 151936,
QKV bias.  12 heads % 16-way TP ≠ 0 ⇒ the sharding rule engine's fallback
path is exercised (attention replicated on `model`, MLP TP'd).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    activation="silu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
