"""The plain reference of a quantized decoder-only LM prefill: Qwen2 as
published (arXiv:2407.10671; the ``Qwen/Qwen2-1.5B`` ``config.json``),
in float32 ``torch`` with TF32 off, every projection on the W8A8 integer
datapath that the configuration states, written out step by step.

A block is pre-norm: RMSNorm, then grouped-query attention with biases on
the query, key and value projections, rotary embeddings (rotate-half, base
``rope_theta``) on queries and keys and a causal softmax; the residual;
RMSNorm, then the SwiGLU MLP ``down(silu(gate(h)) * up(h))``; the residual.
The final RMSNorm and the tied embedding give the logits, at the last
position only (as a prefill returns them).

Each projection ``x @ w`` runs as the configuration states it:

1. the activations get per-row absmax int8 codes, ``s_x = max|x| / 127``,
   ``q_x = round(x / s_x)``;
2. the weights get per-output-column absmax int8 codes over the input axis;
3. the codes' product accumulates exactly in float64 (every partial sum is
   an integer below 2**53);
4. a float32 rescale, ``(float32(acc) * s_x) * s_w``.

The weights are a tree of float tensors keyed as ``weights_tree`` lays them
out; nothing else is taken from the program under test.  Sizes are the
published ``config.json`` keys.  This module imports neither JAX, the JAX
package nor the port.
"""

from __future__ import annotations

import math

import torch

QMAX = 127.0


def plain_precision() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def absmax_codes(x: torch.Tensor, dim: int) -> tuple:
    """Symmetric int8 codes of float32 ``x`` (as float64 integers) and the
    float32 scale, reduced over ``dim``."""
    scale = torch.clamp_min(x.abs().amax(dim, keepdim=True), 1e-8) / QMAX
    codes = torch.clamp(torch.round(x / scale), -QMAX - 1, QMAX)
    return codes.to(torch.float64), scale


def quantized_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` on the W8A8 datapath, float32 out."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    qx, sx = absmax_codes(x2, -1)
    qw, sw = absmax_codes(w.to(torch.float32), 0)
    acc = qx @ qw                                   # exact integers
    return ((acc.to(torch.float32) * sx) * sw).reshape(*lead, w.shape[1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (B, S, H, D) at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).to(torch.float32).to(x.device)[None, :, None, :]
    sin = torch.sin(ang).to(torch.float32).to(x.device)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_attention(q, k, v) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, Hkv, D): softmax(q k^T / sqrt(D)) v under
    the causal mask, query head i reading key head i // (H / Hkv); one
    batch row at a time."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for i in range(b):
        qi = q[i].transpose(0, 1)                               # (H, S, D)
        ki = k[i].transpose(0, 1).repeat_interleave(rep, 0)
        vi = v[i].transpose(0, 1).repeat_interleave(rep, 0)
        logits = (qi @ ki.transpose(1, 2)) / math.sqrt(d)
        p = torch.softmax(logits.masked_fill(~mask, -math.inf), -1)
        out[i] = (p @ vi).transpose(0, 1)
    return out


def block(x: torch.Tensor, p: dict, sizes: dict, linear) -> torch.Tensor:
    """One Qwen2 decoder layer on the residual stream ``x`` (B, S, d)."""
    b, s, _ = x.shape
    h, hkv = sizes["num_attention_heads"], sizes["num_key_value_heads"]
    dh = sizes["hidden_size"] // h
    eps, theta = sizes["rms_norm_eps"], sizes["rope_theta"]
    a = p["attn"]
    y = rms_norm(x, p["ln1"]["scale"], eps)
    q = (linear(y, a["wq"]["w"]) + a["wq"]["b"]).reshape(b, s, h, dh)
    k = (linear(y, a["wk"]["w"]) + a["wk"]["b"]).reshape(b, s, hkv, dh)
    v = (linear(y, a["wv"]["w"]) + a["wv"]["b"]).reshape(b, s, hkv, dh)
    o = causal_attention(rotary(q, theta), rotary(k, theta), v)
    x = x + linear(o.reshape(b, s, h * dh), a["wo"]["w"])
    m = p["mlp"]
    y = rms_norm(x, p["ln2"]["scale"], eps)
    g = linear(y, m["gate"]["w"])
    return x + linear(g * torch.sigmoid(g) * linear(y, m["up"]["w"]),
                      m["down"]["w"])


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i`` of a tree of stacked (leading layer axis) leaves."""
    if isinstance(blocks, dict):
        return {k: layer(v, i) for k, v in blocks.items()}
    return blocks[i].to(torch.float32)


def last_logits(weights: dict, tokens: torch.Tensor, sizes: dict,
                linear=quantized_linear) -> torch.Tensor:
    """Last-position logits (B, V) in float32 of the prompts ``tokens``
    (B, S), layer by layer.  ``linear`` is the projection (the W8A8 one
    unless a caller asks for another)."""
    plain_precision()
    emb = weights["embed"].to(torch.float32)
    x = emb[tokens.long()]
    for i in range(sizes["num_hidden_layers"]):
        x = block(x, layer(weights["blocks"], i), sizes, linear)
    h = rms_norm(x[:, -1], weights["final_norm"]["scale"].to(torch.float32),
                 sizes["rms_norm_eps"])
    return h @ emb.t()


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row: ||got - want|| / ||want|| (float64)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
