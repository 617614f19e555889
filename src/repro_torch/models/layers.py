"""Shared model building blocks: linear layers in the paper's numeric modes,
norms, RoPE, activations, attention (MHA/GQA/MQA, full and Taylor-linear,
with a float or int8 KV cache), MLPs (gated/plain, Taylor-approximated) and
the grouped-dispatch MoE.

Counterpart of ``repro.models.layers``.  Parameters are plain dicts of
tensors with the reference's leaf names, so ``core.quantize.quantize_tree``
finds the same weight leaves.  The paper's numerics plug in through
``cfg.quant_mode`` (fixed-point GEMMs, C1), ``cfg.taylor_order``
(polynomial activations, C2) and ``cfg.attention_impl='taylor_linear'``
(Taylor-softmax linear attention); a ``(codes, scale)`` weight leaf
installed by ``quantize_tree`` runs the integer datapath, which on the card
is the hand-written W8A8 kernel.

The reference computes attention, its chunked (flash) form and the MoE
dispatch in plain ``jax.numpy``, outside any Pallas kernel, so the port
follows the same math in plain PyTorch, with the reference's casts in the
reference's order: QK logits in the activation dtype, then float32; masks
filled with ``finfo(float32).min``; the softmax in float32 and its
probabilities cast back before the PV product.

The ``init_*`` functions draw from a ``torch.Generator`` that lives on
``device``; ``lead`` prepends axes to every leaf (a stacked layer axis).
Their bits cannot match ``jax.random``: the tests carry the reference's own
init across with ``models.api.params_from_numpy``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core import quantize as qz
from ..core import taylor as ty
from ..core.fixedpoint import true_divide
from ..core.losses import chunked_cross_entropy
from ..distributed import cost
from ..distributed.constrain import (is_dtensor, constrain, constrain_batch,
                                     current_mesh, gather_data, local_lookup,
                                     local_rows, mesh_axis_size, tp_matmul)

__all__ = ["init_linear", "linear", "init_norm", "norm", "rope",
           "rope_inv_freq", "yarn_mscale", "act_fn", "moe_stats",
           "softmax_fn", "init_mlp", "mlp", "init_attention", "attention",
           "maybe_quantize_kv", "dequantize_kv", "init_kv_cache",
           "taylor_linear_attention", "init_taylor_linear_cache",
           "taylor_linear_decode", "init_moe", "moe_ffn", "layer_params",
           "stack_layers", "unstack_layers", "scan_layers", "split_heads",
           "embed_rows",
           "embed_tokens", "tied_unembed", "tied_lm_loss"]

Params = Dict[str, Any]
_NEG = torch.finfo(torch.float32).min


# ---------------------------------------------------------------------------
# the layer axis
# ---------------------------------------------------------------------------


def layer_params(tree, i: int):
    """Layer ``i`` of a tree whose tensors carry a leading layer axis;
    ``(codes, scale)`` pairs stay pairs."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(layer_params(v, i) for v in tree)
    return tree[i]


def unstack_layers(tree, n: int) -> List:
    """The first ``n`` per-layer trees of a tree whose tensors carry a
    leading layer axis, each stacked leaf read once (``torch.unbind``):
    under autograd the backward of the whole read is one ``stack``, where
    ``n`` reads of :func:`layer_params` would each accumulate into a zero
    tensor of the whole stacked leaf.  Values are those of
    ``[layer_params(tree, i) for i in range(n)]``."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [unstack_layers(v, n) for v in tree]
        return [type(tree)(p[i] for p in per) for i in range(n)]
    layers = torch.unbind(tree)
    if len(layers) < n:
        raise ValueError(f"leaf of {len(layers)} layers, expected {n}")
    return list(layers[:n])


def scan_layers(body, carry, trees: List, cfg: ModelConfig, group: int = 1):
    """``carry = body(carry, tree)`` for each per-layer tree in order: the
    reference's ``lax.scan`` over the layer axis.  Under ``cfg.remat`` (and
    grad mode) every layer is checkpointed (``torch.utils.checkpoint``:
    its activations recomputed in the backward, as under the reference's
    ``jax.checkpoint``), and with ``group > 1`` every run of ``group``
    layers is checkpointed too (the reference's hierarchical remat:
    L/G + G saved carries instead of L).  Values are unchanged."""
    def remat(fn, *args):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def run(c, ts):
        return cost.fold_loop(lambda c_, t: remat(body, c_, t), c, ts)

    if group <= 1:
        return run(carry, trees)
    groups = [trees[i:i + group] for i in range(0, len(trees), group)]
    return cost.fold_loop(lambda c_, ts: remat(run, c_, ts), carry, groups)


def stack_layers(trees: List):
    """The inverse of :func:`layer_params`: stack per-layer trees along a
    new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_layers([t[j] for t in trees])
                           for j in range(len(first)))
    return torch.stack(trees)


def split_heads(y: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(…, h·dh) → (…, h, dh).  Under a mesh the last dim is first pinned
    to whole heads per rank: sharded on ``model`` when ``h`` divides it,
    else replicated there (a DTensor cannot split a dim whose shards cut
    heads); the leading dim stays on the data axes."""
    m = mesh_axis_size("model")
    spec = ["batch"] + [None] * (y.dim() - 2) + [
        "model" if m > 1 and h % m == 0 else None]
    y = constrain(y, spec, "heads: whole heads per rank", force=True)
    return y.reshape(*y.shape[:-1], h, dh)


# ---------------------------------------------------------------------------
# the tied embedding (RWKV-6, the hybrid, the encoder–decoder)
# ---------------------------------------------------------------------------


def embed_tokens(params: Params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """Rows of ``params["embed"]`` for ``tokens``, in the activation dtype."""
    return embed_rows(params["embed"], tokens, getattr(torch, cfg.dtype))


def embed_rows(emb: torch.Tensor, tokens, dtype) -> torch.Tensor:
    """``emb[tokens]`` in ``dtype``.  Under a mesh each rank looks up its
    own rows of tokens in the whole table (gathered), giving rows on the
    data axes, replicated on ``model``; the table's gradient is a partial
    sum over the data axes."""
    idx = torch.as_tensor(tokens, device=emb.device).long()
    return local_lookup(lambda e, i: e[i].to(dtype), emb, idx,
                        why="embedding: each rank's rows in the whole table")


def tied_unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits through the tied embedding, in ``x``'s dtype."""
    return x @ params["embed"].t().to(x.dtype)


def tied_lm_loss(params: Params, x: torch.Tensor, batch) -> torch.Tensor:
    """Cross-entropy of the final hidden states ``x`` against
    ``batch["labels"]`` (under its optional ``mask``) through the tied
    embedding, chunked so the (B, S, V) logits never materialize."""
    labels = torch.as_tensor(batch["labels"], device=x.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=x.device)
    return chunked_cross_entropy(x, params["embed"].t(), labels, mask)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _dense_init(generator: torch.Generator, din: int, dout: int, *,
                dtype=torch.float32, scale: Optional[float] = None,
                device="cpu", lead: tuple = ()) -> torch.Tensor:
    """N(0, 1) · ``scale`` (default 1/√din) of shape (*lead, din, dout)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(din)
    return torch.randn((*lead, din, dout), generator=generator, dtype=dtype,
                       device=device).mul_(scale)


def init_linear(generator: torch.Generator, din: int, dout: int, *,
                bias: bool = False, dtype=torch.float32,
                device="cpu", lead: tuple = ()) -> Params:
    """``w`` ~ N(0, 1/din) of shape (din, dout), drawn from ``generator``
    (which must live on ``device``); a zero bias when asked."""
    p = {"w": _dense_init(generator, din, dout, dtype=dtype, device=device,
                          lead=lead)}
    if bias:
        p["b"] = torch.zeros((*lead, dout), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x @ w`` in the config's numeric mode (+ bias).  Under a mesh it
    runs on each rank's shards in the weight's tensor-parallel layout
    (``distributed.constrain.tp_matmul``: column-, row-parallel or
    replicated on ``model``, the weight gathered on the data axes)."""
    w = p["w"]
    if isinstance(w, tuple):  # control-plane-installed quantized table
        y = qz.matmul(x, w, "w8a8_int")
    elif cfg.quant_mode == "fp":
        y = tp_matmul(x, w)
    elif cfg.quant_mode == "w8a8_sim":
        y = tp_matmul(x, w, lambda a, b: qz.w8a8_matmul_sim(a, b.to(a.dtype)))
    else:  # w8a8_int on float weights: quantize on the fly (tests/smoke)
        codes, scale = qz.absmax_quantize(w, bits=8, axis=0)
        y = qz.w8a8_matmul_int(x, codes, scale).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, d: Optional[int] = None,
              device="cpu", lead: tuple = ()) -> Params:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((*lead, d), device=device),
                "bias": torch.zeros((*lead, d), device=device)}
    init = torch.zeros if cfg.gemma_style else torch.ones
    return {"scale": init((*lead, d), device=device)}


def norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        scale = (1.0 + p["scale"]) if cfg.gemma_style else p["scale"]
        y = y * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         fraction: float = 1.0,
         inv_freq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of each head's dims.

    x: (B, S, H, Dh); pos: (B, S) absolute positions.  The frequencies and
    angles are float32; the rotation acts on the two halves of the rotated
    dims (not on interleaved pairs).  ``fraction=0.5`` is chatglm3's
    2D-RoPE (half the dims stay unrotated).  ``inv_freq`` (float32, one
    per rotated pair) replaces ``theta``'s frequencies (YaRN:
    :func:`rope_inv_freq`)."""
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    half = d_rot // 2
    f32 = torch.float32
    if inv_freq is not None:
        freqs = inv_freq
    else:
        expo = true_divide(-torch.arange(0, half, dtype=f32,
                                         device=x.device), half)
        freqs = torch.pow(torch.full((), theta, dtype=f32, device=x.device),
                          expo)
    ang = pos[:, :, None, None].to(f32) * freqs[None, None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                        dim=-1).to(x.dtype)
    return torch.cat([rotated, xp], dim=-1) if d_rot < d else rotated


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: ``0.1·mscale·ln(factor) + 1`` (1 for
    ``factor`` ≤ 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def rope_inv_freq(cfg: ModelConfig, dim: int, device
                  ) -> Optional[torch.Tensor]:
    """The rotary frequencies of ``cfg.rope_scaling`` for ``dim`` rotated
    dims (float32 on ``device``), or None for plain RoPE.

    YaRN (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``): for pair ``j``,
    ``extra = θ^(−2j/dim)``, ``inter = extra / factor``, and a ramp from
    the correction dims of ``beta_fast`` (floor) to ``beta_slow`` (ceil),
    ``dim·ln(L₀/(2π·β)) / (2·ln θ)`` over the original ``L₀`` positions:
    ``inv_freq = inter·ramp + extra·(1 − ramp)``.  Cos and sin keep unit
    scale (``mscale / mscale_all_dim`` is 1 for DeepSeek-V2; any other
    ratio is refused)."""
    if not cfg.rope_scaling:
        return None
    return _yarn_inv_freq(cfg.rope_scaling, cfg.rope_theta, dim,
                          str(device)).to(device)


@functools.lru_cache(maxsize=16)
def _yarn_inv_freq(scaling: tuple, theta: float, dim: int, device: str
                   ) -> torch.Tensor:
    sc = dict(scaling)
    if sc.get("type") != "yarn":
        raise ValueError(f"rope_scaling type {sc.get('type')!r}: only "
                         "'yarn' is implemented")
    factor = float(sc["factor"])
    if yarn_mscale(factor, sc["mscale"]) != yarn_mscale(
            factor, sc["mscale_all_dim"]):
        raise ValueError("YaRN with mscale != mscale_all_dim scales cos "
                         "and sin; not implemented")
    l0 = sc["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(l0 / (rot * 2 * math.pi)) / (
            2 * math.log(theta))

    lo = max(math.floor(corr(sc["beta_fast"])), 0)
    hi = min(math.ceil(corr(sc["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    j = torch.arange(dim // 2, dtype=torch.float64)
    extra = theta ** (-2.0 * j / dim)
    inter = extra / factor
    ramp = ((j - lo) / (hi - lo)).clamp(0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    return inv.to(torch.float32).to(device)


# ---------------------------------------------------------------------------
# activations (exact ↔ Taylor per config — contribution C2)
# ---------------------------------------------------------------------------


def act_fn(x: torch.Tensor, cfg: ModelConfig,
           kind: Optional[str] = None) -> torch.Tensor:
    """Exact or Taylor activation per config (contribution C2).  GELU is
    the tanh form, as ``jax.nn.gelu`` computes it by default."""
    kind = kind or cfg.activation
    base = {"silu": "silu", "geglu": "gelu", "gelu": "gelu", "relu": "relu"}[kind]
    if base == "relu":
        return ty.relu(x)
    if cfg.taylor_order <= 0:
        return F.silu(x) if base == "silu" else F.gelu(x, approximate="tanh")
    if cfg.taylor_segmented:
        sig_in = x if base == "silu" else 1.702 * x
        sig = ty.segmented_taylor(sig_in, "sigmoid", cfg.taylor_order)
        return x * sig.to(x.dtype)
    if base == "silu":
        return ty.silu_taylor(x, cfg.taylor_order)
    return ty.gelu_taylor(x, cfg.taylor_order)


def softmax_fn(x: torch.Tensor, cfg: ModelConfig, axis: int = -1
               ) -> torch.Tensor:
    if cfg.attention_impl == "taylor_linear":
        return ty.taylor_softmax(x, order=2, axis=axis)
    return torch.softmax(x, dim=axis)


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, *, device="cpu",
             lead: tuple = ()) -> Params:
    d_ff = d_ff or cfg.d_ff
    kw = dict(device=device, lead=lead)
    p = {"up": init_linear(generator, cfg.d_model, d_ff, **kw)}
    if cfg.activation in ("silu", "geglu"):
        p["gate"] = init_linear(generator, cfg.d_model, d_ff, **kw)
    p["down"] = init_linear(generator, d_ff, cfg.d_model, **kw)
    return p


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = linear(p["up"], x, cfg)
    if "gate" in p:
        h = act_fn(linear(p["gate"], x, cfg), cfg) * up
    else:
        h = act_fn(up, cfg)
    return linear(p["down"], h, cfg)


# ---------------------------------------------------------------------------
# Attention — GQA/MQA full + decode + Taylor-linear
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ModelConfig, *,
                   device="cpu", lead: tuple = ()) -> Params:
    kw = dict(device=device, lead=lead)
    return {
        "wq": init_linear(generator, cfg.d_model, cfg.q_dim,
                          bias=cfg.qkv_bias, **kw),
        "wk": init_linear(generator, cfg.d_model, cfg.kv_dim,
                          bias=cfg.qkv_bias, **kw),
        "wv": init_linear(generator, cfg.d_model, cfg.kv_dim,
                          bias=cfg.qkv_bias, **kw),
        "wo": init_linear(generator, cfg.q_dim, cfg.d_model, **kw),
    }


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, H_kv, D) → (B, S, H_kv·n_rep, D): query head ``i`` reads KV
    head ``i // n_rep`` (each KV head repeated in place, not tiled)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


_ATTN_CHUNK = 512  # flash-style block size


def head_rows(fn, q, k, v, *extra, why: str):
    """``fn(q, k, v, *extra)`` for attention over (B, S, H, D) tensors, on
    each rank's local (batch, head) rows under a mesh
    (``distributed.constrain.local_rows``): heads stay sharded only when
    the KV heads divide the ``model`` axis (each rank then holds whole GQA
    groups); ``extra`` are (B, …) tensors sharded with the batch."""
    heads = k.shape[2] % mesh_axis_size("model") == 0
    qkv = (0, 2) if heads else (0,)
    rest = (0, None) if heads else (0,)
    return local_rows(fn, [q, k, v, *extra],
                      [qkv] * 3 + [rest] * len(extra), [qkv], why)


def _sdpa_causal(q, k, v, cfg: ModelConfig, q_pos0: int = 0) -> torch.Tensor:
    if q.shape[1] > _ATTN_CHUNK and q.shape[1] == k.shape[1]:
        return _sdpa_causal_chunked(q, k, v, cfg)
    return head_rows(lambda q_, k_, v_: _sdpa_causal_full(q_, k_, v_, q_pos0),
                     q, k, v, why="attention: per (batch, head) rows")


def _sdpa_causal_full(q, k, v, q_pos0: int = 0) -> torch.Tensor:
    """Causal attention. q: (B,Sq,H,D), k/v: (B,Sk,H_kv,D).

    Short sequences use the exact materialized form; sequences longer than
    one 512-block (with as many keys as queries) use the flash/online-softmax
    chunked form (`_sdpa_causal_chunked`), so the S×S probability matrix
    never exists."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    sq, sk = q.shape[1], k.shape[1]
    qi = torch.arange(sq, device=q.device)[:, None] + q_pos0
    ki = torch.arange(sk, device=q.device)[None, :]
    logits = logits.masked_fill(~(qi >= ki)[None, None], _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa_causal_chunked(q, k, v, cfg: ModelConfig,
                         chunk: int = _ATTN_CHUNK) -> torch.Tensor:
    """Flash attention (online softmax, ``models/flash.py``): the peak
    attention temporary is one (B, H, chunk, chunk) tile.  ``q`` is scaled
    by 1/√d rounded to its dtype; the grouped K/V heads go in as they are
    (``flash_attention`` reads them by index)."""
    from .flash import flash_attention

    def attend(q, k, v):
        scale = torch.full((), 1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype,
                           device=q.device)
        out = flash_attention((q * scale).transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), True, chunk)
        return out.transpose(1, 2)

    return head_rows(attend, q, k, v,
                     why="flash attention: per (batch, head) rows")


def _sdpa_decode(q, k_cache, v_cache, pos, cfg: ModelConfig) -> torch.Tensor:
    """One-token attention against a KV cache. q: (B,1,H,D); caches
    (B,S_max,H_kv,D); ``pos``: (B,) current position (tokens < pos valid,
    plus the current token already written at ``pos``)."""
    return head_rows(_sdpa_decode_local, q, k_cache, v_cache,
                     torch.as_tensor(pos), why="decode attention: per "
                     "(batch, head) rows")


def _sdpa_decode_local(q, k_cache, v_cache, pos) -> torch.Tensor:
    n_rep = q.shape[2] // k_cache.shape[2]
    k = _repeat_kv(k_cache, n_rep)
    v = _repeat_kv(v_cache, n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             <= pos.to(q.device)[:, None])  # (B, S)
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---- fixed-point KV cache (paper C1 applied to the decode bottleneck) ------


def maybe_quantize_kv(x: torch.Tensor, cfg: ModelConfig):
    """Return cache-resident representation of new K/V entries."""
    if cfg.kv_cache_bits == 0:
        return x
    codes, scale = qz.absmax_quantize(x, bits=cfg.kv_cache_bits, axis=-1)
    return {"codes": codes, "scale": scale.to(torch.float32)}


def dequantize_kv(c, dtype):
    if isinstance(c, dict):
        return (c["codes"].to(torch.float32) * c["scale"]).to(dtype)
    return c


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, *,
                  device="cpu") -> Params:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_bits:
        def leaf():
            return {"codes": torch.zeros(shape, dtype=torch.int8,
                                         device=device),
                    "scale": torch.zeros((*shape[:-1], 1),
                                         dtype=torch.float32, device=device)}
        return {"k": leaf(), "v": leaf()}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache_leaf, new, pos):
    """Write (B,1,...) ``new`` at time ``pos`` into a copy of the (B,S,...)
    cache, placing the start as the reference's ``dynamic_update_slice``
    does: a negative position counts from the end once, then the start is
    clamped into [0, S-1] (a position past the end writes the last slot)."""
    def write(buf, val, p):
        out = buf.clone()
        s = buf.shape[1]
        p = p.to(device=buf.device, dtype=torch.long)
        p = torch.where(p < 0, p + s, p).clamp(0, s - 1)
        out[torch.arange(buf.shape[0], device=buf.device), p] = val[:, 0].to(
            buf.dtype)
        return out

    def upd(buf, val):
        # each (row, trailing index) is written on its own: under a mesh
        # the write runs on every rank's shards (rows, heads, latents)
        rows = (0, *range(2, buf.dim()))
        return local_rows(write, [buf, val, torch.as_tensor(pos)],
                          [rows, rows, (0,) + (None,) * (len(rows) - 1)],
                          [rows], "cache write: per (row, head) slots")
    if isinstance(cache_leaf, dict):
        return {k: upd(cache_leaf[k], new[k]) for k in cache_leaf}
    return upd(cache_leaf, new)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              pos: Optional[torch.Tensor] = None,
              cache: Optional[Params] = None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Unified attention: train/prefill (cache=None → full causal) or decode
    (cache given, x is (B,1,D), pos (B,))."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(linear(p["wq"], x, cfg), h, dh)
    k = split_heads(linear(p["wk"], x, cfg), hkv, dh)
    v = split_heads(linear(p["wv"], x, cfg), hkv, dh)
    if pos is not None:
        pos = torch.as_tensor(pos, device=x.device)
    if cfg.use_rope:
        if pos is None:
            pos_arr = torch.arange(s, device=x.device)[None].expand(b, s)
        else:
            pos_arr = pos[:, None] if pos.dim() == 1 else pos
        q = rope(q, pos_arr, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, pos_arr, cfg.rope_theta, cfg.rope_fraction)

    if cache is None:
        if cfg.attention_impl == "taylor_linear":
            out = head_rows(taylor_linear_attention, q, k, v,
                            why="attention: per (batch, head) rows")
        else:
            out = _sdpa_causal(q, k, v, cfg)
        new_cache = None
    else:
        kq = maybe_quantize_kv(k, cfg)
        vq = maybe_quantize_kv(v, cfg)
        cache = {"k": _cache_write(cache["k"], kq, pos),
                 "v": _cache_write(cache["v"], vq, pos)}
        k_full = dequantize_kv(cache["k"], x.dtype)
        v_full = dequantize_kv(cache["v"], x.dtype)
        out = _sdpa_decode(q, k_full, v_full, pos, cfg)
        new_cache = cache
    out = out.reshape(b, s, h * dh)
    return linear(p["wo"], out, cfg), new_cache


# ---------------------------------------------------------------------------
# Taylor-softmax linear attention (C2 → sub-quadratic)
# ---------------------------------------------------------------------------


def taylor_linear_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, chunk: int = 256
                            ) -> torch.Tensor:
    """Causal linear attention with the order-2 Taylor-exp feature map.

    φ(x) = [1, x, vec(x⊗x)/√2] ⇒ φ(q)·φ(k) = 1 + q·k + (q·k)²/2 ≥ 0, so
    softmax's exp is replaced by its quadratic Taylor polynomial and the
    attention matrix never materializes.  q,k,v: (B,S,H,D); a chunked scan
    over S carries the state (B,H,f,D) in ``q``'s dtype."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q = (q * scale).transpose(1, 2)  # (B,H,S,D)
    k = (k * scale).transpose(1, 2)
    v = v.transpose(1, 2)

    fq, fk = ty.taylor_attention_kernel(q, k)  # (B,H,S,F)
    f = fq.shape[-1]
    pad = (-s) % chunk
    if pad:
        fq, fk, v = (F.pad(t, (0, 0, 0, pad)) for t in (fq, fk, v))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=q.dtype,
                                device=q.device))
    s_kv = torch.zeros((b, h, f, d), dtype=q.dtype, device=q.device)
    s_k = torch.zeros((b, h, f), dtype=q.dtype, device=q.device)
    outs = []
    for i in range(0, fq.shape[2], chunk):
        fq_c, fk_c, v_c = (t[:, :, i:i + chunk] for t in (fq, fk, v))
        qk = torch.einsum("bhqf,bhkf->bhqk", fq_c, fk_c) * tri
        num = torch.einsum("bhqk,bhkd->bhqd", qk, v_c) + torch.einsum(
            "bhqf,bhfd->bhqd", fq_c, s_kv)
        den = qk.sum(-1) + torch.einsum("bhqf,bhf->bhq", fq_c, s_k)
        outs.append(num / torch.clamp_min(den, 1e-6)[..., None])
        s_kv = s_kv + torch.einsum("bhkf,bhkd->bhfd", fk_c, v_c)
        s_k = s_k + fk_c.sum(2)
    out = torch.cat(outs, dim=2)
    return out[:, :, :s].transpose(1, 2)  # (B,S,H,D)


def init_taylor_linear_cache(cfg: ModelConfig, batch: int, dtype=None, *,
                             device="cpu") -> Params:
    """The Taylor feature-map state, float32 whatever ``dtype`` (kept for
    the reference's signature)."""
    d = cfg.head_dim
    f = 1 + d + d * d
    return {"s_kv": torch.zeros((batch, cfg.n_heads, f, d), device=device),
            "s_k": torch.zeros((batch, cfg.n_heads, f), device=device)}


def taylor_linear_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                         cache: Params, pos: torch.Tensor,
                         ) -> Tuple[torch.Tensor, Params]:
    """O(1)-per-token decode with the Taylor feature-map state."""
    b, s, _ = x.shape  # s == 1
    h, dh = cfg.n_heads, cfg.head_dim
    q = split_heads(linear(p["wq"], x, cfg), h, dh)
    k = split_heads(linear(p["wk"], x, cfg), cfg.n_kv_heads, dh)
    v = split_heads(linear(p["wv"], x, cfg), cfg.n_kv_heads, dh)
    if cfg.use_rope:
        pos_arr = torch.as_tensor(pos, device=x.device)[:, None]
        q = rope(q, pos_arr, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, pos_arr, cfg.rope_theta, cfg.rope_fraction)
    n_rep = h // cfg.n_kv_heads
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(dh)
    f32 = torch.float32
    fq, fk = ty.taylor_attention_kernel((q[:, 0] * scale).to(f32),
                                        (k[:, 0] * scale).to(f32))
    s_kv = cache["s_kv"] + torch.einsum("bhf,bhd->bhfd", fk,
                                        v[:, 0].to(f32))
    s_k = cache["s_k"] + fk
    num = torch.einsum("bhf,bhfd->bhd", fq, s_kv)
    den = torch.clamp_min(torch.einsum("bhf,bhf->bh", fq, s_k), 1e-6)
    out = (num / den[..., None]).to(x.dtype).reshape(b, 1, h * dh)
    return linear(p["wo"], out, cfg), {"s_kv": s_kv, "s_k": s_k}


# ---------------------------------------------------------------------------
# MoE — GShard-style grouped dense dispatch
# ---------------------------------------------------------------------------

_MOE_GROUP = 512  # tokens per dispatch group (bounds dispatch-tensor size)


def init_moe(generator: torch.Generator, cfg: ModelConfig, *, device="cpu",
             lead: tuple = ()) -> Params:
    e, d, dff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    g = generator

    def stack(din, dout, scale):
        return torch.randn((*lead, e, din, dout), generator=g,
                           device=device).mul_(scale)

    p = {
        "router": {"w": _dense_init(g, d, e, device=device, lead=lead)},
        "w_gate": stack(d, dff, 1.0 / math.sqrt(d)),
        "w_up": stack(d, dff, 1.0 / math.sqrt(d)),
        "w_down": stack(dff, d, 1.0 / math.sqrt(dff)),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(g, cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
                               device=device, lead=lead)
    if _sigmoid_router(cfg):  # its selection bias, zero as published
        p["router"]["bias"] = torch.zeros((*lead, e), device=device)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot over the last axis; an index outside [0, n) gives a zero row,
    as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties toward
    the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


_MOE_LEAVES = (("router", "w"), ("w_gate",), ("w_up",), ("w_down",))


def _refuse_quantized_moe(p: Params) -> None:
    for path in _MOE_LEAVES:
        leaf = p
        for key in path:
            leaf = leaf[key]
        if isinstance(leaf, tuple):
            name = "".join(f"[{key!r}]" for key in path)
            raise ValueError(
                f"moe_ffn: the MoE leaf {name} is a quantized (codes, scale) "
                "pair; the reference has no integer MoE path (its einsum "
                "fails on the pair), so keep the router and expert stacks "
                "float (quantize_tree's skip)")


def _expert_slice(mesh, e: int):
    """This rank's experts under expert parallelism: the ``model`` axis
    holds ``e / n`` consecutive experts per rank."""
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    r = mesh.get_local_rank("model")
    return slice(r * (e // n), (r + 1) * (e // n))


def _moe_dispatch(dispatch, xg, ep: bool):
    """``einsum("gsec,gsd->egcd")``: each group's tokens into its experts'
    capacity slots.  Under a mesh on each rank's groups (and, under expert
    parallelism, its own experts: no communication)."""
    def local(disp, x, experts=slice(None)):
        return torch.einsum("gsec,gsd->egcd", disp[:, :, experts], x)
    if current_mesh() is None or not is_dtensor(xg):
        return local(dispatch, xg)
    if not ep:
        return local_rows(local, [dispatch, xg], [(0,), (0,)], [(1,)],
                          "MoE dispatch: per group rows")
    return _ep_dispatch(lambda d, x: local(d, x, _expert_slice(
        xg.device_mesh, dispatch.shape[2])), dispatch, xg)


def _moe_combine(eout, combine):
    """``einsum("egcd,gsec->gsd")``: each token's expert outputs weighted
    back.  Under a mesh on each rank's groups, with every expert's output
    (gathered on ``model`` under expert parallelism): the sum over
    experts runs in one einsum, in the unsharded order."""
    def local(eo, comb):
        return torch.einsum("egcd,gsec->gsd", eo, comb)
    return local_rows(local, [eout, combine], [(1,), (0,)], [(0,)],
                      "MoE combine: per group rows")


def _ep_dispatch(fn, dispatch, xg):
    """``fn`` on local shards under expert parallelism: groups on the
    data axes where ``xg`` has them, the output's experts on ``model``
    (each rank fills only its own experts' slots, so ``xg``'s gradient is
    a partial sum over ``model``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xg.device_mesh
    pd, px, pg, po = [], [], [], []
    for name, p in zip(mesh.mesh_dim_names, xg.placements):
        if name == "model":
            pd.append(Replicate())
            px.append(Replicate())
            pg.append(Partial())
            po.append(Shard(0))
            continue
        rows = Shard(0) if isinstance(p, Shard) and p.dim == 0 \
            else Replicate()
        pd.append(rows)
        px.append(rows)
        pg.append(rows)
        po.append(Shard(1) if isinstance(rows, Shard) else Replicate())
    return local_map(fn, out_placements=po, in_placements=(pd, px),
                     in_grad_placements=(pd, pg), device_mesh=mesh,
                     redistribute_inputs=True)(dispatch, xg)


class MoEStats:
    """Counters of the MoE layers since the last :meth:`reset`: tokens,
    routed slots (tokens × top-k) and layer calls, host integers from the
    shapes (no device read).  The dropless path drops no slot by
    construction: every one of its T·k slots is a row of the expert
    GEMMs."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.tokens = self.slots = self.layer_calls = 0

    def count(self, tokens: int, k: int) -> None:
        self.tokens += tokens
        self.slots += tokens * k
        self.layer_calls += 1


#: the MoE layers' counters (``moe_stats.reset()`` to start a count)
moe_stats = MoEStats()


def _sigmoid_router(cfg: ModelConfig) -> bool:
    """Whether the router scores with sigmoids and picks with a selection
    bias (``KimiLinearConfig.moe_router_activation_func``); every other
    configuration's router is the softmax."""
    return getattr(cfg, "moe_router_activation_func", "softmax") == "sigmoid"


def _router_scores(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The router's scores (…, E) of its float32 logits: the softmax (in
    the Taylor mode, C2) or, for a sigmoid router, each expert's
    sigmoid."""
    if _sigmoid_router(cfg):
        return torch.sigmoid(logits)
    return softmax_fn(logits, cfg, axis=-1)


def _route(probs: torch.Tensor, cfg: ModelConfig,
           bias: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gates and expert ids (…, k) of the router's scores (…, E).

    Softmax scores: with ``cfg.n_group > 1``, group-limited greedy: group
    ``g`` holds experts ``g·E/G … (g+1)·E/G − 1`` and scores its best
    expert; the top ``topk_group`` groups are kept and the top k taken
    among their experts (the others masked to 0).  Ties go to the lower
    index, groups and experts alike.  Gates renormalised with
    ``norm_topk_prob``, else times ``routed_scaling_factor`` (as
    DeepSeek-V2's code applies it).

    Sigmoid scores (DeepSeek-V3's and Kimi's router, one group): the top k
    of the scores plus the selection ``bias`` (E,) where there is one,
    ties to the lower index; the gates are the picked scores without the
    bias, renormalised with ``norm_topk_prob``, then times
    ``routed_scaling_factor``."""
    k = cfg.top_k
    if _sigmoid_router(cfg):
        if cfg.n_group > 1:
            raise NotImplementedError("sigmoid routing in expert groups")
        _, idx = _top_k(probs if bias is None else probs + bias, k)
        gates = torch.gather(probs, -1, idx)
        if cfg.norm_topk_prob:
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        return gates * cfg.routed_scaling_factor, idx
    if cfg.n_group > 1:
        e = probs.shape[-1]
        grouped = probs.reshape(*probs.shape[:-1], cfg.n_group,
                                e // cfg.n_group)
        _, best = _top_k(grouped.amax(-1), cfg.topk_group)
        keep = torch.zeros(grouped.shape[:-1], dtype=torch.bool,
                           device=probs.device).scatter_(-1, best, True)
        probs = grouped.masked_fill(~keep[..., None], 0.0).reshape(
            probs.shape)
    gates, idx = _top_k(probs, k)
    if cfg.norm_topk_prob:
        return gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                       1e-9), idx
    return gates * cfg.routed_scaling_factor, idx


def _grouped_mm(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                counts: Optional[List[int]] = None) -> torch.Tensor:
    """``xs`` (R, K), rows grouped by expert (``offs``: the int32 ends of
    each expert's rows), times that expert's ``w[e]`` (E, K, N) → (R, N).
    ``torch._grouped_mm`` (one launch, no host read of ``offs``);
    ``counts`` (each expert's rows, on the host) runs a loop of matmuls
    instead, for dtypes the grouped kernel does not take."""
    if counts is None:
        return torch._grouped_mm(xs, w, offs=offs)
    return torch.cat([a @ w[i] for i, a in enumerate(xs.split(counts))
                      if a.shape[0]] or [xs.new_zeros((0, w.shape[-1]))])


def _moe_dropless(p: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless token-choice MoE: every routed slot is computed.

    The T·k slots are sorted by expert (stable, so each expert's rows stay
    in token order), each expert's GEMMs run over only the rows it
    received (:func:`_grouped_mm`), and the rows go back to token order
    by the inverse permutation, a gather; each token's k rows are summed
    with their gates in float32 in slot order.  No atomics: a call
    repeats bit for bit.  Profiler ranges ``moe.route``,
    ``moe.dispatch``, ``moe.experts``, ``moe.combine`` and ``moe.shared``
    mark the stages."""
    from torch.profiler import record_function

    if current_mesh() is not None:
        raise ValueError("moe_ffn: the dropless dispatch runs on one "
                         "device; it has no sharded form")
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    f32 = torch.float32
    moe_stats.count(t, k)
    with record_function("moe.route"):
        logits = x.to(f32) @ p["router"]["w"].to(f32)
        probs = _router_scores(logits, cfg)
        gates, idx = _route(probs, cfg, p["router"].get("bias"))  # (T,k)
        density = _one_hot(idx[:, 0], e, f32).mean(0)
        aux = e * torch.sum(density * probs.mean(0))
    with record_function("moe.dispatch"):
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=e)
        offs = torch.cumsum(counts, 0).to(torch.int32)
        xs = x[order // k]  # (T·k, D), grouped by expert
    host = None
    if dt != torch.bfloat16 and x.is_cuda:
        host = counts.tolist()  # the grouped kernel takes bf16 only
    with record_function("moe.experts"):
        h = act_fn(_grouped_mm(xs, p["w_gate"].to(dt), offs, host), cfg,
                   "silu") * _grouped_mm(xs, p["w_up"].to(dt), offs, host)
        ys = _grouped_mm(h, p["w_down"].to(dt), offs, host)
    with record_function("moe.combine"):
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=x.device))
        y = ys[inv].view(t, k, d)
        out = y[:, 0].to(f32) * gates[:, :1]
        for j in range(1, k):
            out = out + y[:, j].to(f32) * gates[:, j:j + 1]
        out = out.to(dt)
    if "shared" in p:
        with record_function("moe.shared"):
            out = out + mlp(p["shared"], x, cfg)
    return out, aux


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with grouped dense dispatch (the GShard
    formulation: every step is a batched GEMM), or with
    ``cfg.moe_dropless`` the sorted dispatch of :func:`_moe_dropless`.

    x: (T, D) flattened tokens → (out, aux_loss).  Tokens go in groups of
    ≤512 (right-padded) with per-group expert capacity
    C = min(S, max(4, ⌈S·k·cf/E⌉)); overflow tokens are dropped (the
    residual path carries them).  The combine weights accumulate slot by
    slot in ``x``'s dtype and a token is dispatched where its weight is
    > 0.  The router's softmax obeys the Taylor mode (C2); the gates come
    from :func:`_route`."""
    _refuse_quantized_moe(p)
    if cfg.moe_dropless:
        return _moe_dropless(p, x, cfg)
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    moe_stats.count(t, k)
    sg = min(_MOE_GROUP, t)
    pad = (-t) % sg
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    g = x.shape[0] // sg
    if g % math.prod(mesh_axis_size(a) for a in ("pod", "data")):
        # whole groups per rank, or none: a row-sharded x whose shards cut
        # a group is gathered first (the groups are then replicated)
        x = constrain(x, [None, None], "MoE: groups cut by the row shards",
                      force=True)
    xg = constrain_batch(x.reshape(g, sg, d))  # groups shard over data
    cap = max(4, int(math.ceil(sg * k * cfg.moe_capacity_factor / e)))
    cap = min(cap, sg)
    dt = xg.dtype
    f32 = torch.float32

    # a bf16 router (serving weights) promotes to float32, as in the
    # reference's einsum
    logits = torch.einsum("gsd,de->gse", xg.to(f32),
                          gather_data(p["router"]["w"]).to(f32))
    probs = _router_scores(logits, cfg)
    gates, idx = _route(probs, cfg, p["router"].get("bias"))  # (G,S,k)

    # load-balancing auxiliary loss (Switch-style), on slot 0's choice
    density = _one_hot(idx[..., 0], e, f32).mean((0, 1))
    aux = e * torch.sum(density * probs.mean((0, 1)))

    # position of each (token, slot) in its expert's capacity buffer
    flat = _one_hot(idx, e, torch.int32).reshape(g, sg * k, e)
    pos_all = torch.cumsum(flat, dim=1) - 1  # (G,S*k,E)
    keep_all = ((pos_all < cap) & (flat > 0)).reshape(g, sg, k, e)
    pos_all = pos_all.reshape(g, sg, k, e)
    # accumulate combine weights slot by slot: one (G,S,E,C) tensor
    combine = torch.zeros((g, sg, e, cap), dtype=dt, device=x.device)
    for j in range(k):
        e_j = idx[..., j:j + 1]  # (G,S,1)
        pos_j = torch.gather(pos_all[:, :, j], -1, e_j)[..., 0]
        keep_j = torch.gather(keep_all[:, :, j], -1, e_j)[..., 0]
        w_j = gates[..., j] * keep_j.to(gates.dtype)  # (G,S)
        eoh = _one_hot(e_j[..., 0], e, dt)
        coh = _one_hot(pos_j, cap, dt)
        combine = combine + torch.einsum(
            "gse,gsc->gsec", eoh * w_j[..., None].to(dt), coh)
    combine = constrain(combine, ["batch", None, None, None])
    dispatch = (combine > 0).to(dt)

    # dispatch → batched expert GEMMs → combine (expert parallelism when E
    # divides the model axis; one device here)
    ep = mesh_axis_size("model") > 1 and e % mesh_axis_size("model") == 0
    spec4 = (["model", "batch", None, None] if ep
             else [None, "all", None, None])
    row_spec = ["model", "batch", None] if ep else [None, "all", None]
    xin = constrain(_moe_dispatch(dispatch, xg, ep), spec4)
    xin = constrain(xin.reshape(e, g * cap, d), row_spec)
    gate_h = constrain(torch.einsum("ecd,edf->ecf", xin,
                                    gather_data(p["w_gate"]).to(dt)),
                       row_spec)
    up_h = torch.einsum("ecd,edf->ecf", xin, gather_data(p["w_up"]).to(dt))
    h = act_fn(gate_h, cfg, "silu") * up_h
    eout = torch.einsum("ecf,efd->ecd", h, gather_data(p["w_down"]).to(dt))
    eout = constrain(constrain(eout, row_spec).reshape(e, g, cap, d), spec4)
    out = _moe_combine(eout, combine)

    out = constrain_batch(out).reshape(-1, d)[:t]
    if "shared" in p:
        out = out + mlp(p["shared"], x[:t], cfg)
    return out, aux
