"""Whisper-style encoder–decoder backbone (arXiv:2212.04356).

Counterpart of ``repro.models.encdec``.  The conv audio frontend is a stub,
as in the reference: the model takes precomputed mel-frame embeddings
(B, encoder_seq, d_model).  The encoder adds sinusoidal positions and runs
bidirectional (materialized) self-attention; the decoder adds learned
positions (no RoPE), runs causal self-attention with a KV cache at decode
time, and cross-attention whose K/V are computed once from the encoder
output (``precompute_cross``) and carried in the cache.  The reference
computes all of it in plain ``jax.numpy``, and so does the port in plain
PyTorch, with the reference's casts: attention logits in the activation
dtype, then float32; the softmax in float32, its probabilities cast back
before the PV product.

``enc_blocks`` and ``dec_blocks`` carry a leading layer axis (the
reference's vmapped init), so a tree converted leaf by leaf from the
reference (``models.api.params_from_numpy``), or quantized by
``core.quantize.quantize_tree`` (6 W8A8 projections per encoder layer, 10
per decoder layer), runs as is.  ``loss_fn`` returns the reference's value
and differentiates with autograd; under ``cfg.remat`` each encoder and
decoder layer is recomputed in the backward, as in the reference's
checkpointed scans.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.inference import resolve_device
from ..distributed.constrain import constrain_batch
from . import layers as L
from .layers import (embed_tokens, layer_params, scan_layers, stack_layers,
                     tied_unembed, unstack_layers)

__all__ = ["init_cross_attention", "cross_kv", "cross_attention",
           "init_encoder_block", "encoder_block_fwd", "init_decoder_block",
           "decoder_block_fwd", "init", "encode", "forward", "loss_fn",
           "init_caches", "precompute_cross", "decode_step", "prefill"]

Params = Dict[str, Any]

_MAX_DEC_POS = 65_536  # learned decoder positions (generalized from 448)


def _sinusoid(seq: int, d: int) -> np.ndarray:
    """The encoder's positions, computed in float64 and rounded to float32
    as the reference computes them."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def _bidirectional(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Unmasked attention. q: (B,Sq,H,D); k, v: (B,Sk,H_kv,D) → (B,Sq,H·D)
    (on each rank's (batch, head) rows under a mesh)."""
    b, s = q.shape[:2]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def attend(q, k, v):
        n_rep = q.shape[2] // k.shape[2]
        k, v = L._repeat_kv(k, n_rep), L._repeat_kv(v, n_rep)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(
            torch.float32) * scale
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    out = L.head_rows(attend, q, k, v, why="attention: per (batch, head) "
                      "rows")
    return out.reshape(b, s, cfg.q_dim)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_cross_attention(generator: torch.Generator, cfg: ModelConfig, *,
                         device="cpu", lead: tuple = ()) -> Params:
    kw = dict(device=device, lead=lead)
    return {
        "wq": L.init_linear(generator, cfg.d_model, cfg.q_dim, bias=True,
                            **kw),
        "wk": L.init_linear(generator, cfg.d_model, cfg.kv_dim, **kw),
        "wv": L.init_linear(generator, cfg.d_model, cfg.kv_dim, bias=True,
                            **kw),
        "wo": L.init_linear(generator, cfg.q_dim, cfg.d_model, **kw),
    }


def cross_kv(p: Params, memory: torch.Tensor, cfg: ModelConfig):
    b, s, _ = memory.shape
    k = L.split_heads(L.linear(p["wk"], memory, cfg), cfg.n_kv_heads,
        cfg.head_dim)
    v = L.split_heads(L.linear(p["wv"], memory, cfg), cfg.n_kv_heads,
        cfg.head_dim)
    return k, v


def cross_attention(p: Params, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    q = L.split_heads(L.linear(p["wq"], x, cfg), cfg.n_heads,
        cfg.head_dim)
    return L.linear(p["wo"], _bidirectional(q, k, v, cfg), cfg)


def init_encoder_block(generator: torch.Generator, cfg: ModelConfig, *,
                       device="cpu", lead: tuple = ()) -> Params:
    kw = dict(device=device, lead=lead)
    return {"ln1": L.init_norm(cfg, **kw),
            "attn": L.init_attention(generator, cfg, **kw),
            "ln2": L.init_norm(cfg, **kw),
            "mlp": L.init_mlp(generator, cfg, **kw)}


def encoder_block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    # bidirectional self-attention (no mask)
    h = L.norm(p["ln1"], x, cfg)
    b, s, _ = h.shape
    q = L.split_heads(L.linear(p["attn"]["wq"], h, cfg), cfg.n_heads,
        cfg.head_dim)
    k = L.split_heads(L.linear(p["attn"]["wk"], h, cfg), cfg.n_kv_heads,
        cfg.head_dim)
    v = L.split_heads(L.linear(p["attn"]["wv"], h, cfg), cfg.n_kv_heads,
        cfg.head_dim)
    x = x + L.linear(p["attn"]["wo"], _bidirectional(q, k, v, cfg), cfg)
    x = x + L.mlp(p["mlp"], L.norm(p["ln2"], x, cfg), cfg)
    return x


def init_decoder_block(generator: torch.Generator, cfg: ModelConfig, *,
                       device="cpu", lead: tuple = ()) -> Params:
    kw = dict(device=device, lead=lead)
    return {"ln1": L.init_norm(cfg, **kw),
            "self_attn": L.init_attention(generator, cfg, **kw),
            "ln_x": L.init_norm(cfg, **kw),
            "cross_attn": init_cross_attention(generator, cfg, **kw),
            "ln2": L.init_norm(cfg, **kw),
            "mlp": L.init_mlp(generator, cfg, **kw)}


def decoder_block_fwd(p: Params, x: torch.Tensor, xk: torch.Tensor,
                      xv: torch.Tensor, cfg: ModelConfig, *, pos=None,
                      cache=None):
    h = L.norm(p["ln1"], x, cfg)
    att, new_cache = L.attention(p["self_attn"], h, cfg, pos=pos, cache=cache)
    x = x + att
    x = x + cross_attention(p["cross_attn"], L.norm(p["ln_x"], x, cfg), xk,
                            xv, cfg)
    x = x + L.mlp(p["mlp"], L.norm(p["ln2"], x, cfg), cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> Params:
    """Seeded parameters with the reference's tree, shapes, dtypes (float32)
    and distributions.  ``generator`` must live on ``device``; the bits
    cannot match ``jax.random``."""
    dev = resolve_device(device)
    g = generator
    return {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                             device=dev).mul_(0.02),
        "pos_dec": torch.randn((_MAX_DEC_POS, cfg.d_model), generator=g,
                               device=dev).mul_(0.01),
        "enc_blocks": init_encoder_block(g, cfg, device=dev,
                                         lead=(cfg.n_encoder_layers,)),
        "enc_norm": L.init_norm(cfg, device=dev),
        "dec_blocks": init_decoder_block(g, cfg, device=dev,
                                         lead=(cfg.n_layers,)),
        "final_norm": L.init_norm(cfg, device=dev),
    }


def encode(params: Params, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, encoder_seq, d_model) — precomputed (stub frontend)."""
    dtype = getattr(torch, cfg.dtype)
    dev = params["embed"].device
    frames = torch.as_tensor(frames, device=dev)
    pos = torch.as_tensor(_sinusoid(frames.shape[1], cfg.d_model),
                          device=dev).to(dtype)
    x = frames.to(dtype) + pos[None]

    def body(carry, bp):
        return encoder_block_fwd(bp, constrain_batch(carry), cfg)

    x = scan_layers(body, x, unstack_layers(params["enc_blocks"],
                                            cfg.n_encoder_layers), cfg)
    return L.norm(params["enc_norm"], x, cfg)


def _trunk(params: Params, tokens, cfg: ModelConfig, frames) -> torch.Tensor:
    memory = encode(params, frames, cfg)
    dtype = getattr(torch, cfg.dtype)
    x = embed_tokens(params, tokens, cfg)
    x = x + params["pos_dec"][:x.shape[1]].to(dtype)[None]

    def body(carry, bp):
        xk, xv = cross_kv(bp["cross_attn"], memory, cfg)
        y, _ = decoder_block_fwd(bp, constrain_batch(carry), xk, xv, cfg)
        return y

    x = scan_layers(body, x, unstack_layers(params["dec_blocks"],
                                            cfg.n_layers), cfg)
    return L.norm(params["final_norm"], x, cfg)


def forward(params: Params, tokens, cfg: ModelConfig, *,
            frames) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _trunk(params, tokens, cfg, frames)
    return tied_unembed(params, x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)


def loss_fn(params: Params, batch, cfg: ModelConfig):
    x = _trunk(params, batch["tokens"], cfg, batch["frames"])
    ce = L.tied_lm_loss(params, x, batch)
    return ce, {"loss": ce, "ce": ce}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                device="cuda") -> Params:
    """Per decoder layer (a leading layer axis): the self-attention KV
    cache, and the cross-attention K/V, zero until ``precompute_cross``
    fills them."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    cross_shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                   cfg.head_dim)
    return {"self": stack_layers([L.init_kv_cache(cfg, batch, max_seq, dtype,
                                                  device=dev)
                                  for _ in range(cfg.n_layers)]),
            "cross_k": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "cross_v": torch.zeros(cross_shape, dtype=dtype, device=dev)}


def precompute_cross(params: Params, frames, cfg: ModelConfig,
                     caches: Params) -> Params:
    """Encode ``frames`` once and put every decoder layer's cross K/V into
    (a copy of) ``caches``."""
    memory = encode(params, frames, cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params["dec_blocks"], i)
        k, v = cross_kv(bp["cross_attn"], memory, cfg)
        ks.append(k)
        vs.append(v)
    return {**caches, "cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def decode_step(params: Params, caches: Params, tokens, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One token per row at positions ``pos`` (B,): the learned position
    ``pos_dec[pos]`` per row, self-attention against the KV cache, cross-
    attention against the carried K/V.  Returns logits (B, 1, V) and new
    caches in the same layout."""
    dtype = getattr(torch, cfg.dtype)
    x = embed_tokens(params, tokens, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    x = x + params["pos_dec"][pos.long()][:, None].to(dtype)
    new_self = []
    for i in range(cfg.n_layers):
        x, c = decoder_block_fwd(layer_params(params["dec_blocks"], i), x,
                                 caches["cross_k"][i], caches["cross_v"][i],
                                 cfg, pos=pos,
                                 cache=layer_params(caches["self"], i))
        new_self.append(c)
    x = L.norm(params["final_norm"], x, cfg)
    return tied_unembed(params, x), {**caches,
                                     "self": stack_layers(new_self)}


def prefill(params: Params, tokens, cfg: ModelConfig, *,
            frames) -> torch.Tensor:
    """Last-position logits (B, 1, V) of the prompt, after encoding
    ``frames``."""
    x = _trunk(params, tokens, cfg, frames)
    return tied_unembed(params, x[:, -1:])
