"""Decoder-only LM trunk covering the dense / moe / vlm families.

Counterpart of ``repro.models.transformer``.  Entry points:

  * ``init(generator, cfg, device)``                → params
  * ``forward(params, tokens, cfg, ...)``           → logits, aux (MoE loss)
  * ``loss_fn(params, batch, cfg)``                 → scalar loss, metrics
  * ``prefill(params, tokens, cfg, patch_embeds)``  → last-position logits
  * ``decode_step(params, caches, tokens, pos, cfg)`` → logits, caches

The trunk is a loop over layers.  With ``cfg.scan_layers`` (the default)
``params["blocks"]`` and the caches carry a leading layer axis, as the
reference's vmapped init and scanned decode give them; otherwise they are
lists with one tree per layer.  Both layouts are read as they are, so a
tree converted leaf by leaf from the reference
(``models.api.params_from_numpy``), or quantized by
``core.quantize.quantize_tree``, runs unchanged.  The stacked layer axis
is read once per pass (``layers.unstack_layers``).  Under ``cfg.remat``
each layer, and each group of ``remat_group_size(cfg)`` layers, is
recomputed in the backward (``layers.scan_layers``), as the reference's
checkpointed, grouped scan; values do not change.  ``loss_fn`` returns the
reference's value and differentiates with autograd (flash attention
through its hand-written backward).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, remat_group_size
from ..core.inference import resolve_device
from ..core.losses import chunked_cross_entropy
from ..distributed.constrain import constrain_batch, tp_matmul
from . import layers as L
from . import mla as MLA
from .layers import scan_layers, stack_layers, unstack_layers

__all__ = ["init_block", "block_fwd", "init", "forward", "loss_fn",
           "init_caches", "prefill", "decode_step"]

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg: ModelConfig, *,
               device="cpu", lead: tuple = ()) -> Params:
    kw = dict(device=device, lead=lead)
    p: Params = {"ln1": L.init_norm(cfg, **kw), "ln2": L.init_norm(cfg, **kw)}
    if cfg.mla:
        p["attn"] = MLA.init_mla(generator, cfg, **kw)
    else:
        p["attn"] = L.init_attention(generator, cfg, **kw)
    if cfg.n_experts:
        p["moe"] = L.init_moe(generator, cfg, **kw)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, **kw)
    return p


def block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              pos: Optional[torch.Tensor] = None,
              cache: Optional[Params] = None,
              ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    h = L.norm(p["ln1"], x, cfg)
    if cfg.mla:
        attn_out, new_cache = MLA.mla_attention(p["attn"], h, cfg, pos=pos,
                                                cache=cache)
    else:
        attn_out, new_cache = L.attention(p["attn"], h, cfg, pos=pos,
                                          cache=cache)
    x = x + attn_out
    h = L.norm(p["ln2"], x, cfg)
    if cfg.n_experts:
        b, s, d = h.shape
        ffn_out, aux = L.moe_ffn(p["moe"], h.reshape(b * s, d), cfg)
        ffn_out = ffn_out.reshape(b, s, d)
    else:
        ffn_out = L.mlp(p["mlp"], h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn_out, new_cache, aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> Params:
    """Seeded parameters with the reference's tree, shapes, dtypes (float32)
    and distributions.  ``generator`` must live on ``device``; the bits
    cannot match ``jax.random``."""
    dev = resolve_device(device)
    g = generator
    p: Params = {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                             device=dev).mul_(0.02),
        "final_norm": L.init_norm(cfg, device=dev),
    }
    if cfg.scan_layers:
        p["blocks"] = init_block(g, cfg, device=dev, lead=(cfg.n_layers,))
    else:
        p["blocks"] = [init_block(g, cfg, device=dev)
                       for _ in range(cfg.n_layers)]
    if not cfg.tie_embeddings:
        p["head"] = torch.randn((cfg.d_model, cfg.vocab_size), generator=g,
                                device=dev).mul_(1.0 / math.sqrt(cfg.d_model))
    return p


def _embed(params: Params, tokens, cfg: ModelConfig,
           patch_embeds=None) -> torch.Tensor:
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_rows(params["embed"], tokens, dtype)
    if cfg.gemma_style:  # √d_model rounded to the activation dtype first
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dtype,
                           device=x.device)
    if patch_embeds is not None:  # VLM: precomputed patch embeds prepended
        pe = torch.as_tensor(patch_embeds, device=x.device).to(dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _unembed_w(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["head"]


def _unembed(params: Params, x: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    x = L.norm(params["final_norm"], x, cfg)
    return tp_matmul(x, _unembed_w(params, cfg))


def _layers(blocks, cfg: ModelConfig):
    """The per-layer parameter trees of either layout."""
    if cfg.scan_layers:
        return unstack_layers(blocks, cfg.n_layers)
    return list(blocks)


def _scan_blocks(params: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill pass over all blocks; the MoE aux losses summed.
    Hierarchical remat as the reference's: with the stacked layout, groups
    of ``remat_group_size(cfg)`` checkpointed layers, each group
    checkpointed; with per-layer lists, each layer."""
    def body(carry, bp):
        y, aux = carry
        y, _, a = block_fwd(bp, constrain_batch(y), cfg)
        return y, aux + a

    g = remat_group_size(cfg) if cfg.remat and cfg.scan_layers else 1
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return scan_layers(body, (x, aux), _layers(params["blocks"], cfg), cfg,
                       g)


def forward(params: Params, tokens, cfg: ModelConfig, *,
            patch_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _embed(params, tokens, cfg, patch_embeds)
    x, aux = _scan_blocks(params, x, cfg)
    return _unembed(params, x, cfg), aux


def loss_fn(params: Params, batch: Dict[str, Any], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    patches = batch.get("patch_embeds")
    x = _embed(params, batch["tokens"], cfg, patches)
    x, aux = _scan_blocks(params, x, cfg)
    x = L.norm(params["final_norm"], x, cfg)
    if cfg.n_patches and patches is not None:
        x = x[:, cfg.n_patches:]  # text positions only
    labels = torch.as_tensor(batch["labels"], device=x.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=x.device)
    # chunked CE: the (B,S,V) logits never materialize
    ce = chunked_cross_entropy(x, _unembed_w(params, cfg), labels, mask)
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                device="cuda") -> Params:
    """Zeroed KV caches (MLA latents for deepseek-v2) in ``cfg.dtype``
    (int8 codes and float32 scales with ``kv_cache_bits=8``): one stacked
    tree with a leading layer axis, or a list of per-layer trees."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def one():
        if cfg.mla:
            return MLA.init_mla_cache(cfg, batch, max_seq, dtype, device=dev)
        return L.init_kv_cache(cfg, batch, max_seq, dtype, device=dev)

    if cfg.scan_layers:
        return stack_layers([one() for _ in range(cfg.n_layers)])
    return [one() for _ in range(cfg.n_layers)]


def prefill(params: Params, tokens, cfg: ModelConfig, *,
            patch_embeds=None) -> torch.Tensor:
    """Full-sequence forward returning LAST-position logits only: the
    hidden state is sliced before the unembed, so the (B,S,V) logits never
    materialize."""
    x = _embed(params, tokens, cfg, patch_embeds)
    x, _ = _scan_blocks(params, x, cfg)
    return _unembed(params, x[:, -1:], cfg)


def decode_step(params: Params, caches: Params, tokens, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One new token against a KV cache of length max_seq. tokens: (B, 1);
    returns the logits (B, 1, V) and new caches in the same layout."""
    x = _embed(params, tokens, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    new_caches = []
    for bp, c in zip(_layers(params["blocks"], cfg), _layers(caches, cfg)):
        x, nc, _ = block_fwd(bp, constrain_batch(x), cfg, pos=pos, cache=c)
        new_caches.append(nc)
    if cfg.scan_layers:
        new_caches = stack_layers(new_caches)
    return _unembed(params, x, cfg), new_caches
