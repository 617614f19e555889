"""granite-20b [dense] — arXiv:2405.04324 (hf-verified), code model.

52L, d_model=6144, 48 heads (MQA: kv=1), d_ff=24576, vocab 49152.
llama-style trunk; MQA stresses the KV-head sharding fallback (kv heads
replicated across TP, Q heads sharded 48 = 16·3).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    activation="gelu",  # granite-20b-code uses gpt-style MLP (non-gated)
    norm="layernorm",
    rope_theta=10_000.0,
    accum_steps=4,
)
