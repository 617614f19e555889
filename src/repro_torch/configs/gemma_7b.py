"""gemma-7b [dense] — arXiv:2403.08295 (hf-verified).

28L, d_model=3072, 16 heads (GQA kv=16 ⇒ effectively MHA on 7b),
head_dim=256, d_ff=24576 GeGLU, vocab 256000.  Gemma style: RMSNorm (1+w)
scale and √d embedding scaling.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    activation="geglu",
    norm="rmsnorm",
    gemma_style=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    accum_steps=2,
)
