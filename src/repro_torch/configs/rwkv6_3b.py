"""rwkv6-3b "Finch" [ssm] — arXiv:2404.05892 (hf-verified).

32L, d_model=2560, attention-free token-mix with data-dependent decay,
d_ff=8960 channel-mix, vocab 65536.  Sub-quadratic ⇒ runs `long_500k`.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # 2560 / 64
    n_kv_heads=40,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    activation="relu",  # channel-mix uses relu² internally
    use_rope=False,
    accum_steps=2,
)
