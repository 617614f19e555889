"""pixtral-12b [vlm] — hf:mistralai/Pixtral-12B-2409 (unverified tier).

Backbone only (per brief): mistral-nemo-style decoder, 40L, d_model=5120,
32 heads (GQA kv=8), d_ff=14336, vocab 131072.  The pixtral-ViT frontend is
a STUB — the model takes precomputed patch embeddings
(B, n_patches, d_model) that are concatenated ahead of the token embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    activation="silu",
    n_patches=256,
    rope_theta=1_000_000.0,
    accum_steps=2,
)
