"""zamba2-2.7b [hybrid] — the JAX reference's preset after arXiv:2411.15242.

54 Mamba2 layers (d_model=2560, ssm_state=64) with a SHARED attention block
(32 heads, GQA kv=32, d_ff=10240) applied every 6 SSM layers — the weights of
the attention block are shared across all applications (Zamba's signature).
Hybrid ⇒ runs `long_500k`; its attention block uses the Taylor-softmax
linear form at 500k (attention_impl is a per-run override).

It simplifies the published Zamba2 block (``configs/zamba2_7b.py``,
family ``zamba2``, is the published form); it stays field for field the
reference's for the parity tests.  Left out or changed:

* one shared block, not two alternating;
* a plain pre-norm transformer block with its own residual, where the
  published block takes [hidden ‖ embedding] (``2·d_model``) in, with
  head dim ``2·d_model / heads`` and the softmax scaled by
  ``(head_dim/2)^-½``, and feeds its output through a per-layer
  ``linear`` into the next Mamba layer's input only;
* attention over ``d_model`` with head dim 80;
* no per-application LoRA adapters;
* B and C shared by all heads (one group; the 7B has 2);
* the gated out-norm normalises first and gates second (the published
  order is the reverse, over each group's channels).
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
