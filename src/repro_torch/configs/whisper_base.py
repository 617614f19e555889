"""whisper-base [audio] — arXiv:2212.04356 (unverified tier).

Encoder–decoder backbone: 6 enc + 6 dec layers, d_model=512, 8 heads,
d_ff=2048 GELU, vocab 51865, LayerNorm, learned positions (no RoPE).
The conv audio frontend is a STUB — the model takes precomputed
frame embeddings (B, 1500, 512).  Decode shapes exercise the decoder with
self-attn KV cache + fixed cross-attn memory.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_encoder_layers=6,
    encoder_seq=1500,
    encoder_d_model=512,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    activation="gelu",
    norm="layernorm",
    use_rope=False,
    tie_embeddings=True,
)
