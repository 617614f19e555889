"""Mamba-2 (SSD) blocks and the Zamba2 hybrid (arXiv:2411.15242).

Counterpart of ``repro.models.ssm``.  Mamba-2's state-space recurrence per
head (state S ∈ R^{dh×N}, scalar per-head decay):

    S_t = exp(dt_t·a)·S_{t-1} + dt_t·(x_t ⊗ B_t)
    y_t = S_t·C_t + D·x_t

Prefill, forward and loss run the chunked SSD form (scalar cumulative
log-decays → a chunk-local attention-like product and a carried state);
decode is the O(dh·N) recurrent step.  The reference computes both in plain
``jax.numpy``, outside any Pallas kernel, and so does the port in plain
PyTorch: the chunk-local terms of every chunk at once, and only the
(B, H, dh, N) state carry as a loop over chunks.

Zamba2 is a stack of Mamba-2 layers with ONE shared transformer block
(attention + MLP, ``transformer.block_fwd``) applied after every
``hybrid_attn_every`` of them; its weights serve every application, and each
application keeps its own attention cache.  With
``cfg.attention_impl == "taylor_linear"`` (the ``long_500k`` shape) the
shared block runs Taylor-softmax linear attention, so decode state is O(1)
in the sequence length.

``params["mamba"]`` carries two leading axes ``(groups, per, …)``, as the
reference's nested ``vmap`` init gives them; read one layer with
``layers.layer_params`` twice.  A tree converted leaf by leaf from the
reference (``models.api.params_from_numpy``), or quantized by
``core.quantize.quantize_tree`` (the five projections of every Mamba layer
and the shared block's six run the W8A8 kernel), runs as is.  ``loss_fn``
returns the reference's value and differentiates with autograd; under
``cfg.remat`` each Mamba layer, and each group with its shared block, is
recomputed in the backward, as in the reference's nested checkpoints.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.inference import resolve_device
from ..distributed.constrain import constrain_batch, local_rows
from . import layers as L
from . import transformer as TF
from .layers import (embed_tokens, layer_params, scan_layers, stack_layers,
                     tied_unembed, unstack_layers)

__all__ = ["init_mamba_block", "mamba_block_fwd", "init", "forward",
           "loss_fn", "init_caches", "decode_step", "prefill", "ssd_grouped",
           "ssd_step_grouped"]

Params = Dict[str, Any]

_CHUNK = 64


def _n_heads(cfg: ModelConfig) -> int:
    return (cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    per = cfg.hybrid_attn_every
    return cfg.n_layers // per, per


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig, *,
                     device="cpu", lead: tuple = ()) -> Params:
    """Seeded Mamba-2 layer parameters with the reference's tree, shapes and
    distributions; ``lead`` prepends axes to every leaf."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = _n_heads(cfg)

    def randn(shape, scale):
        return torch.randn((*lead, *shape), generator=generator,
                           device=device).mul_(scale)

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=device)

    s = 1.0 / math.sqrt(d)
    a_log = torch.log(torch.linspace(1.0, 8.0, h, dtype=torch.float32,
                                     device=device))
    return {
        "ln": L.init_norm(cfg, device=device, lead=lead),
        "in_z": {"w": randn((d, d_in), s)},
        "in_x": {"w": randn((d, d_in), s)},
        "in_bc": {"w": randn((d, 2 * n), s)},
        "in_dt": {"w": randn((d, h), s)},
        "conv_x": randn((cfg.conv_width, d_in), 0.2),
        "conv_bc": randn((cfg.conv_width, 2 * n), 0.2),
        "conv_b": full((d_in + 2 * n,), 0.0),
        "a_log": a_log.expand(*lead, h).clone(),
        "dt_bias": full((h,), -2.0),  # softplus⁻¹-ish small dt
        "d_skip": full((h,), 1.0),
        "out_norm": full((d_in,), 1.0),
        "out_proj": {"w": randn((d_in, d), 1.0 / math.sqrt(d_in))},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor],
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,T,C); w: (K,C); b: (C,) or None (no
    bias).  The taps are summed one at a time in ``x``'s dtype, as the
    reference's Python ``sum``.  Returns (y, new_state): the last K−1
    inputs, the decode state."""
    k = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, k - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = sum(ctx[:, i:i + t] * w[i].to(x.dtype) for i in range(k))
    new_state = (ctx[:, -(k - 1):] if k > 1
                 else x.new_zeros((x.shape[0], 0, x.shape[2])))
    return (y if b is None else y + b.to(x.dtype)), new_state


def _ssd_chunked(xh, bmat, cmat, dt, a, chunk: int = _CHUNK,
                 floor: Optional[float] = -30.0, with_state: bool = False):
    """Chunked SSD. xh: (B,T,H,dh); bmat/cmat: (B,T,N); dt: (B,T,H); a: (H,)<0.

    Per head: logdec_t = dt_t·a; cum = cumsum inside a chunk, clamped at
    ``floor`` (the reference's −30; ``None``: not clamped);
    scores(t,i) = exp(cum_t−cum_i)·(C_t·B_i)·dt_i for i≤t, the exponent
    masked to −inf above the diagonal before the exp;
    y = scores @ x + exp(cum_t)·(S0 C_t), S0 the state at the chunk's start.
    The chunk-local terms are computed for every chunk at once; only the
    state carry S' = exp(cum_T)·S0 + Σ_i exp(cum_T−cum_i)·dt_i·(x_i ⊗ B_i)
    loops over the chunks.  ``with_state`` also returns the state after
    the last position (B,H,dh,N): padded positions have dt = 0 and leave
    it as it is.
    """
    b, t, h, dh = xh.shape
    n = bmat.shape[-1]
    pad = (-t) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bmat, cmat = (F.pad(m, (0, 0, 0, pad)) for m in (bmat, cmat))
        dt = F.pad(dt, (0, 0, 0, pad))
    tt = xh.shape[1]
    nc = tt // chunk

    x = xh.reshape(b, nc, chunk, h, dh).permute(1, 0, 3, 2, 4)  # (nc,B,H,T,dh)
    bm = bmat.reshape(b, nc, chunk, n).transpose(0, 1)  # (nc,B,T,N)
    cm = cmat.reshape(b, nc, chunk, n).transpose(0, 1)
    dtc = dt.reshape(b, nc, chunk, h).permute(1, 0, 3, 2)  # (nc,B,H,T)

    logdec = dtc * a[None, None, :, None]  # ≤ 0
    cum = torch.cumsum(logdec, dim=-1)
    if floor is not None:
        cum = torch.clamp_min(cum, floor)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xh.device).tril()  # inclusive

    # intra-chunk: G(t,i) = exp(cum_t − cum_i), masked causal-inclusive
    g = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~tri, -math.inf))
    cb = torch.einsum("cbtn,cbsn->cbts", cm, bm)  # (nc,B,T,S)
    scores = cb[:, :, None] * g * dtc[..., None, :]  # (nc,B,H,T,S)
    y = torch.einsum("cbhts,cbhsd->cbhtd", scores, x)

    # each chunk's own contribution to the state at its end, then the carry
    decay_to_end = torch.exp(cum[..., -1:] - cum) * dtc  # (nc,B,H,T)
    inc = torch.einsum("cbhsd,cbsn->cbhdn", decay_to_end[..., None] * x, bm)
    tot = torch.exp(cum[..., -1])[..., None, None]  # (nc,B,H,1,1)
    s = torch.zeros((b, h, dh, n), dtype=xh.dtype, device=xh.device)
    starts = []
    for i in range(nc):
        starts.append(s)
        s = s * tot[i] + inc[i]
    s0 = torch.stack(starts)  # (nc,B,H,dh,N): the state entering each chunk

    # inter-chunk: y += exp(cum_t)·(C_t · S0ᵀ)
    y = y + torch.exp(cum)[..., None] * torch.einsum("cbtn,cbhdn->cbhtd",
                                                     cm, s0)
    y = y.permute(1, 0, 3, 2, 4).reshape(b, tt, h, dh)
    return (y[:, :t], s) if with_state else y[:, :t]


def ssd_grouped(xh, bmat, cmat, dt, a, chunk: int):
    """The chunked SSD with B and C in groups of heads, unclamped.
    xh: (B,T,H,dh); bmat/cmat: (B,T,G,N), head h reading group
    h // (H/G); dt: (B,T,H); a: (H,)<0.  Each group's heads run
    :func:`_ssd_chunked` with ``floor=None``.  Returns y (B,T,H,dh) and
    the state after the last position (B,H,dh,N)."""
    g = bmat.shape[2]
    per = xh.shape[2] // g
    out = [_ssd_chunked(xh[:, :, i * per:(i + 1) * per], bmat[:, :, i],
                        cmat[:, :, i], dt[:, :, i * per:(i + 1) * per],
                        a[i * per:(i + 1) * per], chunk, floor=None,
                        with_state=True) for i in range(g)]
    return (torch.cat([y for y, _ in out], dim=2),
            torch.cat([st for _, st in out], dim=1))


def _ssd_step(state, xh, bvec, cvec, dt, a):
    """state: (B,H,dh,N); xh: (B,H,dh); bvec/cvec: (B,N); dt: (B,H); a: (H,)."""
    dec = torch.exp(dt * a[None, :])  # (B,H)
    upd = torch.einsum("bhd,bn->bhdn", xh * dt[..., None], bvec)
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bhdn,bn->bhd", new_state, cvec)
    return y, new_state


def ssd_step_grouped(state, xh, bvec, cvec, dt, a):
    """One recurrent step with B and C in groups of heads: state
    (B,H,dh,N); xh: (B,H,dh); bvec/cvec: (B,G,N), head h reading group
    h // (H/G); dt: (B,H); a: (H,)."""
    per = xh.shape[1] // bvec.shape[1]
    bh = bvec.repeat_interleave(per, dim=1)  # (B,H,N)
    ch = cvec.repeat_interleave(per, dim=1)
    dec = torch.exp(dt * a[None, :])
    upd = torch.einsum("bhd,bhn->bhdn", xh * dt[..., None], bh)
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bhdn,bhn->bhd", new_state, ch)
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself past its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    state: Optional[Params] = None
                    ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One Mamba-2 layer with its residual.  Without ``state`` the chunked
    SSD over the whole sequence; with ``state`` ({"conv", "s"}) one decode
    step, returning the new state."""
    b, t, d = x.shape
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = _n_heads(cfg)
    dh = cfg.ssm_head_dim
    f32 = torch.float32

    u = L.norm(p["ln"], x, cfg)
    z = L.linear(p["in_z"], u, cfg)
    xc = L.linear(p["in_x"], u, cfg)
    bc = L.linear(p["in_bc"], u, cfg)
    dt = L.linear(p["in_dt"], u, cfg)

    conv_state = state["conv"] if state is not None else None
    conv_in = torch.cat([xc, bc], dim=-1)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    conv_out, conv_new = _causal_conv(conv_in, conv_w, p["conv_b"],
                                      conv_state)
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)

    dt = _softplus(dt.to(f32) + p["dt_bias"])  # (B,T,H)
    a = -torch.exp(p["a_log"])  # (H,) < 0
    xh = L.split_heads(xc, h, dh)

    if state is None:
        y = local_rows(_ssd_chunked, [xh.to(f32), bmat.to(f32),
                                      cmat.to(f32), dt, a],
                       [(0, 2), (0, None), (0, None), (0, 2), (None, 0)],
                       [(0, 2)], "SSD: per (batch, head) rows").to(x.dtype)
        ssm_new = None
    else:
        y, ssm_new = _ssd_step(state["s"], xh[:, 0].to(f32),
                               bmat[:, 0].to(f32), cmat[:, 0].to(f32),
                               dt[:, 0], a)
        y = y[:, None].to(x.dtype)

    y = y + xh * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, t, d_in)
    # gated RMS out-norm (mamba2 style)
    yf = y.to(f32)
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-5)
    y = (yf * p["out_norm"]).to(x.dtype) * F.silu(z)
    out = L.linear(p["out_proj"], y, cfg)
    new_state = ({"conv": conv_new, "s": ssm_new} if state is not None
                 else None)
    return x + out, new_state


# ---------------------------------------------------------------------------
# Zamba2 hybrid model
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> Params:
    """Seeded parameters with the reference's tree, shapes, dtypes (float32)
    and distributions: ``mamba`` stacked (groups, per, …), ONE ``shared``
    transformer block.  ``generator`` must live on ``device``; the bits
    cannot match ``jax.random``."""
    dev = resolve_device(device)
    g = generator
    return {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                             device=dev).mul_(0.02),
        "mamba": init_mamba_block(g, cfg, device=dev, lead=_groups(cfg)),
        "shared": TF.init_block(g, cfg, device=dev),
        "final_norm": L.init_norm(cfg, device=dev),
    }


def _trunk(params: Params, tokens, cfg: ModelConfig) -> torch.Tensor:
    x = embed_tokens(params, tokens, cfg)
    shared = params["shared"]
    groups, per = _groups(cfg)

    def inner(carry, bp):
        y, _ = mamba_block_fwd(bp, constrain_batch(carry), cfg)
        return y

    def group_body(carry, group_p):
        y = constrain_batch(carry)
        y = scan_layers(inner, y, unstack_layers(group_p, per), cfg)
        y, _, _ = TF.block_fwd(shared, y, cfg)  # shared-weight attention block
        return y

    x = scan_layers(group_body, x, unstack_layers(params["mamba"], groups),
                    cfg)
    return L.norm(params["final_norm"], x, cfg)


def forward(params: Params, tokens, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _trunk(params, tokens, cfg)
    return tied_unembed(params, x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)


def loss_fn(params: Params, batch, cfg: ModelConfig):
    x = _trunk(params, batch["tokens"], cfg)
    ce = L.tied_lm_loss(params, x, batch)
    return ce, {"loss": ce, "ce": ce}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                device="cuda") -> Params:
    """Mamba states, O(1) per layer (``mamba``: (groups, per, …)), and one
    attention cache per application of the shared block (``attn``:
    (groups, …)): a KV cache of ``max_seq`` positions, or with
    ``taylor_linear`` the feature-map state, float32 and position-free."""
    dev = resolve_device(device)
    d_in = cfg.ssm_expand * cfg.d_model
    n, h, dh = cfg.ssm_state, _n_heads(cfg), cfg.ssm_head_dim
    groups, per = _groups(cfg)
    dtype = getattr(torch, cfg.dtype)
    mamba = {
        "conv": torch.zeros((groups, per, batch, cfg.conv_width - 1,
                             d_in + 2 * n), dtype=dtype, device=dev),
        "s": torch.zeros((groups, per, batch, h, dh, n), device=dev),
    }

    def one():
        if cfg.attention_impl == "taylor_linear":
            return L.init_taylor_linear_cache(cfg, batch, dtype, device=dev)
        return L.init_kv_cache(cfg, batch, max_seq, dtype, device=dev)

    return {"mamba": mamba, "attn": stack_layers([one()
                                                  for _ in range(groups)])}


def decode_step(params: Params, caches: Params, tokens, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One token per row: tokens (B, 1) → logits (B, 1, V) and new caches
    in the same layout (the caches are functional: the inputs stay)."""
    x = embed_tokens(params, tokens, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    shared = params["shared"]
    groups, per = _groups(cfg)
    m_new, a_new = [], []
    for gi in range(groups):
        group_p = layer_params(params["mamba"], gi)
        m_cache = layer_params(caches["mamba"], gi)
        a_cache = layer_params(caches["attn"], gi)
        states = []
        for i in range(per):
            x, st = mamba_block_fwd(layer_params(group_p, i), x, cfg,
                                    state=layer_params(m_cache, i))
            states.append(st)
        m_new.append(stack_layers(states))
        if cfg.attention_impl == "taylor_linear":
            hh = L.norm(shared["ln1"], x, cfg)
            att, a_next = L.taylor_linear_decode(shared["attn"], hh, cfg,
                                                 cache=a_cache, pos=pos)
            x = x + att
            x = x + L.mlp(shared["mlp"], L.norm(shared["ln2"], x, cfg), cfg)
        else:
            x, a_next, _ = TF.block_fwd(shared, x, cfg, pos=pos,
                                        cache=a_cache)
        a_new.append(a_next)
    x = L.norm(params["final_norm"], x, cfg)
    return tied_unembed(params, x), {"mamba": stack_layers(m_new),
                                 "attn": stack_layers(a_new)}


def prefill(params: Params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """Last-position logits (B, 1, V) of the whole prompt."""
    x = _trunk(params, tokens, cfg)
    return tied_unembed(params, x[:, -1:])
