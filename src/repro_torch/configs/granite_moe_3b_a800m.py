"""granite-moe-3b-a800m [moe] — hf:ibm-granite (hf-verified tier).

32L, d_model=1536, 24 heads (GQA kv=8), per-expert d_ff=512, vocab 49155,
MoE 40 experts top-8.  40 % 16 ≠ 0 and 49155 % 16 ≠ 0 ⇒ exercises both the
expert-parallel fallback (expert-TP on d_ff=512=16·32) and the vocab-shard
fallback (embedding sharded on d_model).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    n_experts=40,
    top_k=8,
    vocab_size=49_155,
    activation="silu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
