"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Counterpart of ``repro.models.mla``.  KV state is compressed into a
``kv_lora_rank``-dim latent ``c_kv`` plus a shared ``qk_rope_dim`` rotary
key, so the cache stores ``kv_lora + rope_dim`` values per token instead of
``2·H·head_dim``.

Two execution forms, as in the reference:

  * **expanded** (train/prefill): latents up-projected to per-head K/V,
    then causal attention (the flash form past 512 tokens, where the value
    width may differ from the key width);
  * **absorbed** (decode): ``W_uk`` is folded into the query and ``W_uv``
    into the output so attention runs in latent space.  The absorbed form
    reads ``wk_b``/``wv_b`` as float matrices; the reference has no integer
    form of it, so a quantized ``(codes, scale)`` pair there raises.

With ``cfg.rope_scaling`` (YaRN, DeepSeek-V2 as published) the rotary
parts take YaRN's frequencies and the softmax scale is
``mscale²/√(dn + dr)`` (:func:`softmax_scale`).  With
``cfg.mla_use_nope`` (Kimi Linear) nothing is rotated: the
``qk_rope_dim`` parts of q and of the shared key enter the scores as
projected, at the scale 1/√(dn + dr).  Profiler ranges ``mla.project``
(the projections, norms and rotary parts, and the output projection) and
``mla.attend`` (the attention itself) mark the stages.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from ..configs.base import ModelConfig
from ..distributed.constrain import local_rows
from .layers import (_NEG, Params, _cache_write, init_linear, init_norm,
                     split_heads,
                     linear, norm, rope, rope_inv_freq, yarn_mscale)

__all__ = ["init_mla", "init_mla_cache", "mla_attention", "softmax_scale"]


def init_mla(generator: torch.Generator, cfg: ModelConfig, *, device="cpu",
             lead: tuple = ()) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lq, lkv = cfg.q_lora_rank, cfg.kv_lora_rank
    g = generator
    kw = dict(device=device, lead=lead)
    p: Params = {}
    if lq:
        p["wq_a"] = init_linear(g, d, lq, **kw)
        p["q_norm"] = init_norm(cfg, lq, **kw)
        p["wq_b"] = init_linear(g, lq, h * (dn + dr), **kw)
    else:
        p["wq"] = init_linear(g, d, h * (dn + dr), **kw)
    p["wkv_a"] = init_linear(g, d, lkv + dr, **kw)
    p["kv_norm"] = init_norm(cfg, lkv, **kw)
    p["wk_b"] = init_linear(g, lkv, h * dn, **kw)
    p["wv_b"] = init_linear(g, lkv, h * dv, **kw)
    p["wo"] = init_linear(g, h * dv, d, **kw)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, *,
                   device="cpu") -> Params:
    return {
        "ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_seq, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
    }


def _nope(cfg: ModelConfig) -> bool:
    """Whether nothing is rotated (``KimiLinearConfig.mla_use_nope``);
    every other configuration's MLA is rotary."""
    return getattr(cfg, "mla_use_nope", False)


def _queries(p: Params, x: torch.Tensor, cfg: ModelConfig,
             pos_arr: torch.Tensor):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = linear(p["wq_b"], norm(p["q_norm"], linear(p["wq_a"], x, cfg),
                                   cfg), cfg)
    else:
        q = linear(p["wq"], x, cfg)
    q = split_heads(q, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    if _nope(cfg):
        return q_nope, q_rope
    return q_nope, rope(q_rope, pos_arr, cfg.rope_theta,
                        inv_freq=rope_inv_freq(cfg, dr, x.device))


def _latents(p: Params, x: torch.Tensor, cfg: ModelConfig,
             pos_arr: torch.Tensor):
    lkv = cfg.kv_lora_rank
    kv = linear(p["wkv_a"], x, cfg)
    ckv, k_rope = kv[..., :lkv], kv[..., lkv:]
    ckv = norm(p["kv_norm"], ckv, cfg)
    if _nope(cfg):
        return ckv, k_rope
    k_rope = rope(k_rope[:, :, None, :], pos_arr, cfg.rope_theta,
                  inv_freq=rope_inv_freq(cfg, cfg.qk_rope_dim, x.device)
                  )[:, :, 0, :]
    return ckv, k_rope


def softmax_scale(cfg: ModelConfig) -> float:
    """``1/√(dn + dr)``, times YaRN's ``mscale(factor, mscale_all_dim)²``
    under ``cfg.rope_scaling``."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if cfg.rope_scaling:
        sc = dict(cfg.rope_scaling)
        m = yarn_mscale(float(sc["factor"]), sc["mscale_all_dim"])
        scale *= m * m
    return scale


def _float_matrix(p: Params, name: str, dtype) -> torch.Tensor:
    w = p[name]["w"]
    if isinstance(w, tuple):
        raise ValueError(
            f"mla_attention: the absorbed decode reads [{name!r}]['w'] as a "
            "float matrix, and it is a quantized (codes, scale) pair; the "
            "reference has no integer absorbed form (it fails on the pair), "
            "so keep wk_b and wv_b float (quantize_tree's skip)")
    return w.to(dtype)


def _expanded_attention(q, k, v, scale: float, dtype) -> torch.Tensor:
    """Causal attention of the expanded form, q/k (B, S, H, dn + dr),
    v (B, S, H, dv) → (B, S, H, dv): flash past 512 tokens."""
    s = q.shape[1]
    if s > 512:
        from .flash import flash_attention
        qs = q * torch.full((), scale, dtype=q.dtype, device=q.device)
        return local_rows(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, True, 512),
            [qs.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)],
            [(0, 1)] * 3, [(0, 1)],
            "flash attention: per (batch, head) rows").transpose(1, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    ar = torch.arange(s, device=q.device)
    logits = logits.masked_fill(~(ar[:, None] >= ar[None, :]), _NEG)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  pos: Optional[torch.Tensor] = None,
                  cache: Optional[Params] = None,
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv, lkv = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                       cfg.kv_lora_rank)
    scale = softmax_scale(cfg)

    if cache is None:
        with record_function("mla.project"):
            pos_arr = torch.arange(s, device=x.device)[None].expand(b, s)
            q_nope, q_rope = _queries(p, x, cfg, pos_arr)
            ckv, k_rope = _latents(p, x, cfg, pos_arr)
            # expanded K/V
            k_nope = split_heads(linear(p["wk_b"], ckv, cfg), h, dn)
            v = split_heads(linear(p["wv_b"], ckv, cfg), h, dv)
            k = torch.cat([k_nope,
                           k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
        with record_function("mla.attend"):
            out = _expanded_attention(q, k, v, scale, x.dtype)
        with record_function("mla.project"):
            return linear(p["wo"], out.reshape(b, s, h * dv), cfg), None

    # ---- absorbed decode ----------------------------------------------------
    wk_b = _float_matrix(p, "wk_b", x.dtype).reshape(lkv, h, dn)
    wv_b = _float_matrix(p, "wv_b", x.dtype).reshape(lkv, h, dv)
    pos = torch.as_tensor(pos, device=x.device)
    pos_arr = pos[:, None]
    q_nope, q_rope = _queries(p, x, cfg, pos_arr)  # (B,1,H,dn),(B,1,H,dr)
    ckv_new, krope_new = _latents(p, x, cfg, pos_arr)  # (B,1,lkv),(B,1,dr)
    cache = {"ckv": _cache_write(cache["ckv"], ckv_new, pos),
             "krope": _cache_write(cache["krope"], krope_new, pos)}
    ckv_all = cache["ckv"].to(x.dtype)  # (B,S,lkv)
    krope_all = cache["krope"].to(x.dtype)  # (B,S,dr)

    # absorb W_uk into q: (B,1,H,dn)×(lkv,H,dn) → (B,1,H,lkv)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, wk_b)
    scores = (torch.einsum("bqhl,bkl->bhqk", q_lat, ckv_all)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, krope_all))
    scores = scores.to(torch.float32) * scale
    valid = (torch.arange(ckv_all.shape[1], device=x.device)[None, :]
             <= pos[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhqk,bkl->bqhl", probs, ckv_all)  # (B,1,H,lkv)
    out = torch.einsum("bqhl,lhd->bqhd", ctx_lat, wv_b).reshape(b, s, h * dv)
    return linear(p["wo"], out, cfg), cache
