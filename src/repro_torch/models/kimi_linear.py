"""Kimi Linear as published (arXiv:2510.26692; moonshotai's
Kimi-Linear-48B-A3B-Instruct ``config.json``, ``configs/kimi_linear_48b.py``):
Kimi Delta Attention layers (``models/kda.py``) and MLA layers without
rotary parts in a 3 : 1 pattern, a leading dense SwiGLU and MoE layers of
sigmoid-routed experts with a selection bias and a shared expert.

``h`` is the residual stream; nothing scales the embedding.  Layer ℓ
(numbered from 1, as ``cfg.kda_layers`` and ``cfg.full_attn_layers`` are)::

    h ← h + Mixer_ℓ(RMSNorm(h))      KDA if ℓ ∈ kda_layers, else MLA
    h ← h + FFN_ℓ(RMSNorm(h))        the dense SwiGLU of width d_ff for
                                      ℓ ≤ first_k_dense_replace, else MoE

MLA runs ``mla.mla_attention`` with ``cfg.mla_use_nope`` (no rotary parts,
the softmax scale 1/√(dn + dr)); the MoE ``layers.moe_ffn``'s dropless
path with the sigmoid router (``layers._route``: the top k of the scores
plus the selection bias, the gates the picked scores renormalised and
scaled).  The head is the final RMSNorm and the untied ``head``.  A
configuration cut in depth (a pipeline stage) keeps the layers up to
``n_layers``; list entries past it are the absent stages'.

Parameters: ``embed`` (V, d), ``final_norm``, ``head`` (d, V) and
``layers``, a list of per-layer trees: ``ln1``, ``ln2``, the mixer's
``kda`` (``kda.init_kda``) or ``attn`` (``mla.init_mla``), and the FFN's
``mlp`` or ``moe`` (``router`` with its float32 ``bias``).  Projections,
experts and the embedding are in ``cfg.param_dtype``; norm scales,
``a_log``, ``dt_bias`` and the router's bias in float32.  ``init`` draws
them layer by layer on its device.

``prefill`` with ``caches`` (``init_caches``: per KDA layer its conv tail
and float32 state, per MLA layer its latent ``ckv``/``krope`` cache, side
by side) fills them for ``decode_step``.  Profiler ranges: the KDA
mixer's ``kda.project`` and ``kda.scan``, MLA's ``mla.project`` and
``mla.attend``, the MoE's ``moe.*``.  ``kimi_stats`` counts on the host;
``models/taps.py`` receives ``embed``, one ``block`` a layer and
``head``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.inference import resolve_device
from ..core.losses import chunked_cross_entropy
from . import kda as K
from . import layers as L
from . import mla as MLA
from . import taps
from .layers import embed_tokens, layer_params, stack_layers

__all__ = ["init", "forward", "loss_fn", "prefill", "init_caches",
           "decode_step", "layer_fwd", "is_kda", "kimi_stats", "KimiStats"]

Params = Dict[str, Any]

# leaves kept in float32 whatever the parameter dtype
_FLOAT32_LEAVES = ("scale", "bias", "a_log", "dt_bias")


class KimiStats:
    """Counters of the Kimi Linear passes since the last :meth:`reset`:
    tokens (rows × positions of each pass), KDA and MLA layer calls, and
    KDA chunks (rows × chunks of each chunked layer call).  Host integers
    from the shapes (no device read); the MoE layers count in
    ``layers.moe_stats``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.tokens = self.kda_layers = self.mla_layers = 0
        self.kda_chunks = 0


#: the Kimi Linear passes' counters (``kimi_stats.reset()`` to start)
kimi_stats = KimiStats()


def is_kda(cfg: ModelConfig, i: int) -> bool:
    """Whether layer ``i`` (from 0) mixes with KDA (else MLA)."""
    return i + 1 in cfg.kda_layers


def _check(cfg: ModelConfig) -> None:
    for layer in range(1, cfg.n_layers + 1):
        if (layer in cfg.kda_layers) == (layer in cfg.full_attn_layers):
            raise ValueError(f"kimi_linear: layer {layer} must be in exactly "
                             "one of kda_layers and full_attn_layers")
    if not (cfg.mla and cfg.moe_dropless):
        raise ValueError("kimi_linear: MLA layers and the dropless MoE")


def _cast(tree, dtype):
    """``tree`` with its projections in ``dtype`` (the float32 leaves
    kept)."""
    if isinstance(tree, dict):
        return {k: (v if k in _FLOAT32_LEAVES else _cast(v, dtype))
                for k, v in tree.items()}
    return tree.to(dtype)


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> Params:
    """Seeded parameters, drawn in float32 layer by layer and kept in
    ``cfg.param_dtype`` (``generator`` lives on ``device``; ``"meta"``
    with ``generator=None`` draws nothing)."""
    _check(cfg)
    dev = resolve_device(device)
    pdt = getattr(torch, cfg.param_dtype)
    g = generator
    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {
        "embed": torch.randn((v, d), generator=g, device=dev).mul_(0.02)
        .to(pdt),
        "final_norm": L.init_norm(cfg, device=dev),
        "layers": []}
    for i in range(cfg.n_layers):
        p: Params = {"ln1": L.init_norm(cfg, device=dev),
                     "ln2": L.init_norm(cfg, device=dev)}
        if is_kda(cfg, i):
            p["kda"] = _cast(K.init_kda(g, cfg, device=dev), pdt)
        else:
            p["attn"] = _cast(MLA.init_mla(g, cfg, device=dev), pdt)
        if i < cfg.first_k_dense_replace:
            p["mlp"] = _cast(L.init_mlp(g, cfg, device=dev), pdt)
        else:
            p["moe"] = _cast(L.init_moe(g, cfg, device=dev), pdt)
        params["layers"].append(p)
    params["head"] = torch.randn((d, v), generator=g, device=dev).mul_(
        1.0 / math.sqrt(d)).to(pdt)
    return params


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def _mla(p: Params, x: torch.Tensor, cfg: ModelConfig, pos, cache,
         fill: bool):
    """MLA on x: the expanded form over the sequence (``fill``: also
    writing its latents at positions 0..S−1 of ``cache``), or one
    absorbed decode step at ``pos``."""
    if pos is not None:
        return MLA.mla_attention(p, x, cfg, pos=pos, cache=cache)
    out, _ = MLA.mla_attention(p, x, cfg)
    if not fill:
        return out, None
    b, s, _ = x.shape
    ckv, krope = MLA._latents(
        p, x, cfg, torch.arange(s, device=x.device)[None].expand(b, s))
    return out, {key: torch.cat([new.to(cache[key].dtype),
                                 cache[key][:, s:]], dim=1)
                 for key, new in (("ckv", ckv), ("krope", krope))}


def layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              pos: Optional[torch.Tensor] = None,
              cache: Optional[Params] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One layer: ``x + Mixer(RMSNorm(x))``, then ``+ FFN(RMSNorm(·))``.
    With ``pos`` one decode step on ``cache``; without it a pass over the
    sequence that, given a (fresh) ``cache``, returns the cache it
    leaves.  Returns (y, cache or None)."""
    b, s, d = x.shape
    h1 = L.norm(p["ln1"], x, cfg)
    if "kda" in p:
        mix, new = K.kda_attention(
            p["kda"], h1, cfg, state=cache if pos is not None else None,
            keep_state=cache is not None)
        kimi_stats.kda_layers += 1
        if pos is None:
            kimi_stats.kda_chunks += b * -(-s // K.CHUNK)
    else:
        mix, new = _mla(p["attn"], h1, cfg, pos, cache, cache is not None)
        kimi_stats.mla_layers += 1
    x2 = x + mix
    h2 = L.norm(p["ln2"], x2, cfg)
    if "moe" in p:
        ffn = L.moe_ffn(p["moe"], h2.reshape(b * s, d), cfg)[0].reshape(
            b, s, d)
    else:
        ffn = L.mlp(p["mlp"], h2, cfg)
    y = x2 + ffn
    taps.tap("block", x, h1, mix, h2, ffn, y)
    return y, new


def _trunk(params: Params, tokens, cfg: ModelConfig, *,
           caches: Optional[Params] = None,
           pos: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The hidden states after the last layer, before the final norm.
    With ``caches``: a prefill from position 0 that fills them (``pos``
    None) or one decode step at ``pos``; returns the new caches."""
    _check(cfg)
    x = embed_tokens(params, tokens, cfg)
    kimi_stats.tokens += x.shape[0] * x.shape[1]
    taps.tap("embed", x)
    new: Dict[str, list] = {"kda": [], "mla": []}
    for i, p in enumerate(params["layers"]):
        kind = "kda" if is_kda(cfg, i) else "mla"
        c = (None if caches is None
             else layer_params(caches[kind], len(new[kind])))
        x, nc = layer_fwd(p, x, cfg, pos=pos, cache=c)
        new[kind].append(nc)
    if caches is None:
        return x, None
    return x, {k: stack_layers(v) for k, v in new.items()}


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.norm(params["final_norm"], x, cfg)
    return x @ params["head"].to(x.dtype)


def forward(params: Params, tokens, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits at every position (B, S, V) and a zero auxiliary loss (the
    selection bias balances the experts; no loss term does)."""
    h, _ = _trunk(params, tokens, cfg)
    return _head(params, h, cfg), torch.zeros((), dtype=torch.float32,
                                              device=h.device)


def loss_fn(params: Params, batch, cfg: ModelConfig):
    h, _ = _trunk(params, batch["tokens"], cfg)
    labels = torch.as_tensor(batch["labels"], device=h.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=h.device)
    ce = chunked_cross_entropy(L.norm(params["final_norm"], h, cfg),
                               params["head"], labels, mask)
    return ce, {"loss": ce, "ce": ce}


def prefill(params: Params, tokens, cfg: ModelConfig, *,
            caches: Optional[Params] = None):
    """Last-position logits (B, 1, V) of the whole prompt; with fresh
    ``caches`` (``init_caches``) also the caches it leaves for
    ``decode_step`` at position S."""
    h, new = _trunk(params, tokens, cfg, caches=caches)
    x = h[:, -1:]
    logits = _head(params, x, cfg)
    taps.tap("head", x, logits)
    return logits if caches is None else (logits, new)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                device="cuda") -> Params:
    """Per KDA layer its conv tail (``conv``, the activation dtype) and
    state (``s``, float32), stacked under ``kda``; per MLA layer its
    latent cache of ``max_seq`` positions, stacked under ``mla``."""
    _check(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    n_kda = sum(is_kda(cfg, i) for i in range(cfg.n_layers))
    h, dh = cfg.kda_num_heads, cfg.kda_head_dim
    kda = {"conv": torch.zeros((n_kda, batch, cfg.short_conv_kernel_size - 1,
                                3 * h * dh), dtype=dtype, device=dev),
           "s": torch.zeros((n_kda, batch, h, dh, dh), device=dev)}
    mla = stack_layers([MLA.init_mla_cache(cfg, batch, max_seq, dtype,
                                           device=dev)
                        for _ in range(cfg.n_layers - n_kda)])
    return {"kda": kda, "mla": mla}


def decode_step(params: Params, caches: Params, tokens, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One token per row: tokens (B, 1) at positions ``pos`` (B,) →
    logits (B, 1, V) and new caches (the inputs stay)."""
    pos = torch.as_tensor(pos, device=params["embed"].device)
    h, new = _trunk(params, tokens, cfg, caches=caches, pos=pos)
    return _head(params, h, cfg), new
