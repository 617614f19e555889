"""Config system: architecture + input-shape + numerics.

Counterpart of ``repro.configs.base``.  Every assigned architecture is a
:class:`ModelConfig` in its own module (``repro_torch/configs/<id>.py``);
shapes are the four assigned input-shape sets.  :func:`get_config` resolves
an architecture id.

The numerics block is where the paper's techniques plug in as first-class
switches: ``quant_mode`` (fixed-point datapath, C1), ``taylor_order``
(polynomial activations, C2), ``attention_impl='taylor_linear'`` (the
sub-quadratic Taylor-softmax path), ``kv_cache_bits`` (fixed-point KV cache).
The fields are the reference's, defaults included, so a configuration
means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["ModelConfig", "DeepSeekConfig", "ShapeConfig", "SHAPES",
           "reduced", "active_params", "param_count", "remat_group_size",
           "n_heads_ssm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | moe | rwkv6 | hybrid | encdec | vlm

    # trunk ------------------------------------------------------------------
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    activation: str = "silu"  # silu | geglu | gelu (non-gated)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = False
    gemma_style: bool = False  # (1+w) RMSNorm scale, sqrt(d) embed scaling

    # rotary -----------------------------------------------------------------
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # chatglm3 "RoPE 2d": rotary on half the dims
    use_rope: bool = True  # whisper: learned positions instead

    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden width
    moe_capacity_factor: float = 1.25  # per-group expert capacity (GShard)

    # MLA (deepseek-v2) --------------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM / RWKV ---------------------------------------------------------------
    ssm_state: int = 0  # mamba2 state dim per head
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64  # chunked-WKV block length (perf knob, §Perf)
    hybrid_attn_every: int = 0  # zamba2: shared attn block every N ssm layers

    # encoder–decoder (whisper) -------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed frame embeddings (conv frontend stubbed)
    encoder_d_model: int = 0

    # VLM (pixtral) ---------------------------------------------------------------
    n_patches: int = 0  # precomputed patch embeddings (ViT frontend stubbed)

    # numerics (the paper's knobs) -----------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    quant_mode: str = "fp"  # fp | w8a8_sim | w8a8_int
    taylor_order: int = 0  # 0 = exact activations; 1/3/5 = paper Table 3
    taylor_segmented: bool = False  # range-match segmented Taylor tables
    attention_impl: str = "full"  # full | taylor_linear
    kv_cache_bits: int = 0  # 0 = bf16 cache; 8 = fixed-point int8 cache

    # training ----------------------------------------------------------------
    remat: bool = True
    remat_group: int = 0  # hierarchical remat: 0 = auto (≈√L), 1 = flat scan
    scan_layers: bool = True
    accum_steps: int = 1  # microbatch gradient accumulation (activations ÷ k)
    optimizer: str = "adamw"
    opt_state_bits: int = 32  # 8 → fixed-point quantized Adam moments
    grad_compress_bits: int = 0  # 8 → int8 all-reduce gradient compression

    # derived -----------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def n_heads_ssm(self) -> int:
        """Mamba2 heads: the expanded width over the SSM head dim."""
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # DeepSeek-V2's published knobs (``DeepSeekConfig`` makes them fields),
    # at the values that leave every other model as it is: no leading
    # dense layers, one routing group, renormalised unscaled gates, GShard
    # capacity, plain RoPE
    first_k_dense_replace = 0
    n_group = 1
    topk_group = 1
    routed_scaling_factor = 1.0
    norm_topk_prob = True
    moe_dropless = False
    rope_scaling = ()


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig(ModelConfig):
    """A :class:`ModelConfig` with DeepSeek-V2's published routing, layer
    pattern and YaRN keys as fields, named as in its ``config.json``.  The
    reference's ``ModelConfig`` has none of them; on a plain
    ``ModelConfig`` they read the class defaults above.

    * ``first_k_dense_replace``: the leading layers whose FFN is the dense
      SwiGLU of width ``d_ff``; the rest are MoE of width ``moe_d_ff``.
    * ``n_group``/``topk_group``: group-limited greedy routing, the experts
      in ``n_group`` equal groups, a token's top-k taken among the experts
      of its ``topk_group`` best groups (a group scores its best expert).
    * ``routed_scaling_factor``, ``norm_topk_prob``: the gates are the
      chosen probabilities times the factor, renormalised or not.
    * ``moe_dropless``: every routed slot is computed (no capacity).
    * ``rope_scaling``: the ``config.json`` block as sorted (key, value)
      pairs; ``type`` ``"yarn"`` selects YaRN frequencies and the softmax
      scale's ``mscale``.
    """

    first_k_dense_replace: int = 0
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    moe_dropless: bool = False
    rope_scaling: Tuple[Tuple[str, object], ...] = ()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


#: The four assigned input-shape sets (LM transformer shapes).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def remat_group_size(cfg: ModelConfig) -> int:
    """Resolve the hierarchical-remat group: largest divisor of n_layers
    closest to √L (minimizes saved-carry stack L/G + transient G)."""
    L = cfg.n_layers
    if cfg.remat_group:
        return cfg.remat_group if L % cfg.remat_group == 0 else 1
    target = max(1, int(np.sqrt(L)))
    divisors = [d for d in range(1, L + 1) if L % d == 0]
    return min(divisors, key=lambda d: abs(d - target))


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to CPU-smoke-test scale, preserving its family and
    every structural feature (GQA ratio, MoE, MLA, hybrid period...)."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, round(4 * cfg.n_kv_heads / max(cfg.n_heads, 1))) if cfg.n_kv_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                  moe_d_ff=64, n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.mla:
        kw.update(q_lora_rank=min(cfg.q_lora_rank, 64) or 0,
                  kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32)
    if cfg.hybrid_attn_every:
        kw.update(n_layers=4, hybrid_attn_every=2)
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2, encoder_seq=16,
                  encoder_d_model=128)
    if cfg.n_patches:
        kw.update(n_patches=8)
    kw.update(overrides)
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# Parameter accounting (for roofline MODEL_FLOPS = 6·N·D)
# ---------------------------------------------------------------------------


def _dense_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla:
        q = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads
             * (cfg.qk_nope_dim + cfg.qk_rope_dim)) if cfg.q_lora_rank else (
                 d * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim))
        kv = (d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
              + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim))
        o = cfg.n_heads * cfg.v_head_dim * d
        attn = q + kv + o
    else:
        attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    return attn


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    gated = cfg.activation in ("silu", "geglu")
    return cfg.d_model * d_ff * (3 if gated else 2)


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (approximate to ~1%: norms/bias omitted)."""
    d, L = cfg.d_model, cfg.n_layers
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "rwkv6":
        per_layer = 4 * d * d + _ffn_params(cfg, cfg.d_ff)  # r,k,v,o/g mats + ffn
        return embed + L * per_layer
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        # in_proj → [z, x, B, C, dt] (B/C shared across heads) + out_proj
        per_ssm = d * (2 * d_in + 2 * cfg.ssm_state + cfg.n_heads_ssm()) + d_in * d
        shared_attn = _dense_layer_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        n_shared = 1  # zamba: weights shared across applications
        return embed + L * per_ssm + n_shared * shared_attn
    per_layer = _dense_layer_params(cfg)
    k = cfg.first_k_dense_replace if cfg.n_experts else 0
    dense = k * (per_layer + _ffn_params(cfg, cfg.d_ff))
    if cfg.n_experts:
        per_layer += cfg.n_experts * _ffn_params(cfg, cfg.moe_d_ff)
        per_layer += cfg.n_shared_experts * _ffn_params(cfg, cfg.moe_d_ff)
        per_layer += cfg.d_model * cfg.n_experts  # router
    else:
        per_layer += _ffn_params(cfg, cfg.d_ff)
    total = embed + dense + (L - k) * per_layer
    if cfg.n_encoder_layers:
        total += cfg.n_encoder_layers * (_dense_layer_params(cfg) + _ffn_params(cfg, cfg.d_ff))
    return total


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only top-k + shared experts)."""
    if not cfg.n_experts:
        return param_count(cfg)
    d, L = cfg.d_model, cfg.n_layers
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer = _dense_layer_params(cfg)
    k = cfg.first_k_dense_replace
    dense = k * (per_layer + _ffn_params(cfg, cfg.d_ff))
    per_layer += (cfg.top_k + cfg.n_shared_experts) * _ffn_params(cfg, cfg.moe_d_ff)
    per_layer += cfg.d_model * cfg.n_experts
    return embed + dense + (L - k) * per_layer


def n_heads_ssm(cfg: ModelConfig) -> int:
    return cfg.n_heads_ssm()
