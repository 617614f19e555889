"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token mixing with
data-dependent per-channel decay.

Counterpart of ``repro.models.rwkv6``.  The recurrence per head (state
S ∈ R^{dk×dv}):

    S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ
    o_t = r_tᵀ·(S_{t-1} + diag(u)·k_t v_tᵀ)

with w_t = exp(−exp(d_t)) produced per token by a LoRA (the "Finch"
data-dependent decay).  Prefill, forward and loss run a chunked parallel
form; decode is the O(d²) recurrent step.  The chunked form has two routes
(``wkv=``), both already in the reference:

  * ``"scan"`` (default) — the operands are prepped elementwise in float32
    (cumulative log-decays inside a chunk) and handed to
    ``kernels.ops.wkv_scan``: on the card the hand-written CUDA chunk-scan
    kernel (the port of ``wkv_scan_pallas``), on the CPU its plain version.
    This is the formulation of the reference's kernel test
    (``tests/test_wkv_kernel.py``); per WKV call it agrees with
    ``"chunked"`` within that form's bf16 rounding (rtol + atol 3e-2
    there), and a deep model with random weights amplifies the difference
    layer by layer.
  * ``"chunked"`` — ``_wkv_chunked``, the reference model's own form: the
    chunk-GEMM operands rounded to bf16, float32 accumulation and state.

Training goes through ``"chunked"``, as the reference's ``loss_fn`` does:
``loss_fn`` takes it unless asked otherwise.  The kernel (like the
reference's Pallas kernel) has no backward, and ``ops.wkv_scan`` raises
under autograd rather than return a result cut from the graph.  Under
``cfg.remat`` each layer, and each group of ``remat_group_size(cfg)``
layers, is recomputed in the backward, as in the reference's scan.

Parameters are a dict with the reference's paths; ``params["blocks"]``
carries a leading layer axis (the reference's vmapped init; read one layer
with ``layers.layer_params``), so a tree converted leaf by leaf from the
reference, or quantized by ``core.quantize.quantize_tree``
(``(codes, scale)`` pairs), runs as is.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, remat_group_size
from ..core.inference import resolve_device
from ..distributed.constrain import constrain_batch, local_rows, tp_matmul
from ..kernels import ops
from . import layers as L
from .layers import embed_tokens as _embed
from .layers import layer_params, scan_layers, stack_layers, unstack_layers
from .layers import tied_unembed as _unembed

__all__ = ["WKV_ROUTES", "check_wkv", "init", "forward", "loss_fn",
           "prefill", "init_caches", "decode_step", "time_mix",
           "channel_mix", "block_fwd", "layer_params", "stack_layers"]

Params = Dict[str, Any]

_LORA_RANK = 32
_CHUNK = 64
#: the two formulations of the chunked WKV (see the module docstring)
WKV_ROUTES = ("scan", "chunked")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _randn(g: torch.Generator, shape, scale: float, dev) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=dev).mul_(scale)


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> Params:
    """Seeded parameters with the reference's shapes, dtypes (float32) and
    distributions.  ``generator`` must live on ``device``; the bits cannot
    match ``jax.random`` (the tests convert the reference's own init with
    ``models.api.params_from_numpy``)."""
    dev = resolve_device(device)
    g = generator
    n, d, dff = cfg.n_layers, cfg.d_model, cfg.d_ff
    h = d // cfg.rwkv_head_dim
    s = 1.0 / math.sqrt(d)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def norm():
        p = L.init_norm(cfg, device=dev)
        return {k: v.expand(n, d).clone() for k, v in p.items()}

    time_mix = {
        # static token-shift lerp weights for r/k/v/g/w
        **{m: full((n, d), 0.5) for m in ("mu_r", "mu_k", "mu_v", "mu_g",
                                          "mu_w")},
        # data-dependent decay LoRA (the Finch signature)
        "w_base": full((n, d), -2.0),
        "w_lora_a": _randn(g, (n, d, _LORA_RANK), s, dev),
        "w_lora_b": _randn(g, (n, _LORA_RANK, d), 0.01, dev),
        **{m: {"w": _randn(g, (n, d, d), s, dev)}
           for m in ("wr", "wk", "wv", "wg", "wo")},
        "u": _randn(g, (n, h, cfg.rwkv_head_dim), 0.1, dev),
        "out_norm": full((n, d), 1.0),  # per-head group norm scale
    }
    channel_mix = {
        "mu_k": full((n, d), 0.5),
        "mu_r": full((n, d), 0.5),
        "wk": {"w": _randn(g, (n, d, dff), 1.0 / math.sqrt(d), dev)},
        "wv": {"w": _randn(g, (n, dff, d), 1.0 / math.sqrt(dff), dev)},
        "wr": {"w": _randn(g, (n, d, d), 1.0 / math.sqrt(d), dev)},
    }
    return {
        "embed": _randn(g, (cfg.vocab_size, d), 0.02, dev),
        "blocks": {"ln1": norm(), "ln2": norm(), "time_mix": time_mix,
                   "channel_mix": channel_mix},
        "final_norm": L.init_norm(cfg, device=dev),
    }


# ---------------------------------------------------------------------------
# chunked WKV: the reference's form and the kernel's
# ---------------------------------------------------------------------------


def _chunks(r, k, v, logw, chunk: int):
    """The prep both chunked forms share: right-pad T to a multiple of
    ``chunk``, split r, k, v into (B, H, NC, C, D) chunks, and the
    inclusive cumulative log-decay inside each chunk with its underflow
    guard (exp(−30) ≈ 1e-13) and its exclusive form ``cum_prev``."""
    b, h, t, d = r.shape
    pad = (-t) % chunk
    nc = (t + pad) // chunk

    def split(x):
        return F.pad(x, (0, 0, 0, pad)).reshape(b, h, nc, chunk, d)

    r_, k_, v_, lw = split(r), split(k), split(v), split(logw)
    cum = torch.clamp_min(torch.cumsum(lw, dim=-2), -30.0)
    return r_, k_, v_, cum, cum - lw


def _wkv_chunked(r, k, v, logw, u, chunk: int = _CHUNK):
    """r,k,v: (B,H,T,D); logw: (B,H,T,D) log-decays (≤0); u: (H,D) bonus.

    Returns o: (B,H,T,D).  Chunk math (per head, S ∈ R^{D×D}):
      A_t  = r_t ⊙ exp(cum_{t-1})        (queries against chunk-start state)
      B_i  = k_i ⊙ exp(−cum_i)           (keys propagated to chunk start)
      intra = strict_tril(A Bᵀ) + diag(r_t·(u⊙k_t))
      o_t  = intra @ V + A_t @ S0
      S'   = diag(exp(cum_T)) S0 + (B ⊙ exp(cum_T))ᵀ V
    The chunk-GEMM operands (A, B, V and the scores) are bf16 tensors as
    in the reference; products of bf16 values are exact in float32, the
    sums and the state carry are float32.  Each use converts its bf16
    operand to float32 on its own, so that under autograd each use's
    gradient is rounded to bf16 and the uses' gradients are summed in bf16,
    as the reference's cotangents of its bf16 operands are.
    """
    b, h, t, d = r.shape
    r_, k_, v_, cum, cum_prev = (x.permute(2, 0, 1, 3, 4)
                                 for x in _chunks(r, k, v, logw, chunk))
    cdt = torch.bfloat16
    f32 = torch.float32
    a = torch.unbind((r_ * torch.exp(cum_prev)).to(cdt))
    bk = torch.unbind((k_ * torch.exp(-cum)).to(cdt))
    vb = torch.unbind(v_.to(cdt))
    tot = torch.exp(cum[..., -1:, :])  # (nc,B,H,1,D) f32
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device),
                     diagonal=-1)
    diag_term = (r_ * (u[None, None, :, None, :] * k_)).sum(-1)  # (nc,B,H,T)

    s0 = torch.zeros((b, h, d, d), dtype=r.dtype, device=r.device)
    outs = []
    for i, (a_c, b_c, v_c) in enumerate(zip(a, bk, vb)):
        tot_c = tot[i]
        scores = (a_c.to(f32) @ b_c.to(f32).transpose(-1, -2)) * tri
        o = scores.to(cdt).to(f32) @ v_c.to(f32)
        o = o + diag_term[i][..., None] * v_c.to(f32)
        o = o + a_c.to(f32) @ s0
        s0 = s0 * tot_c[..., 0, :, None] + (
            b_c.to(f32) * tot_c).transpose(-1, -2) @ v_c.to(f32)
        outs.append(o)
    o = torch.stack(outs).permute(1, 2, 0, 3, 4).reshape(
        b, h, len(outs) * chunk, d)
    return o[:, :, :t]


def _wkv_scan(r, k, v, logw, u, chunk: int = _CHUNK):
    """The same recurrence through ``ops.wkv_scan``: the shared prep, the
    kernel's operands formed elementwise in float32, one kernel launch,
    the padding trimmed."""
    b, h, t, d = r.shape
    r_, k_, v_, cum, cum_prev = _chunks(r, k, v, logw, chunk)
    nc = r_.shape[2]

    def rows(x):  # (B, H, NC, ·, ·) → (B·H, NC, ·, ·), contiguous
        return x.reshape(b * h, nc, *x.shape[3:]).contiguous()

    diag = (r_ * (u[None, :, None, None, :] * k_)).sum(-1, keepdim=True)
    o = ops.wkv_scan(rows(r_ * torch.exp(cum_prev)),
                     rows(k_ * torch.exp(-cum)), rows(v_),
                     rows(torch.exp(cum[..., -1:, :])), rows(diag))
    return o.reshape(b, h, nc * chunk, d)[:, :, :t]


_WKV = {"scan": _wkv_scan, "chunked": _wkv_chunked}


def _wkv_recurrent_step(state, r, k, v, w, u):
    """state: (B,H,D,D); r,k,v,w: (B,H,D); u: (H,D) → (o, new_state)."""
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhd,bhde->bhe", r, state + u[None, :, :, None] * kv)
    new_state = state * w[..., None] + kv
    return o, new_state


# ---------------------------------------------------------------------------
# mixes
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} (zero/`last` at t=0). x: (B,T,D)."""
    last = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([last, x[:, :-1]], dim=1)


def _decays(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log-decay: logw = −exp(base + tanh(x A) B) ∈ (−∞, 0)."""
    dt = xw.dtype
    dd = tp_matmul(torch.tanh(tp_matmul(xw, p["w_lora_a"])),
                   p["w_lora_b"], lambda a, b: a @ b.to(dt))
    return -torch.exp(torch.clamp(p["w_base"].to(xw.dtype) + dd, -8.0, 4.0))


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
             state: Optional[Params] = None, wkv: str = "scan"
             ) -> Tuple[torch.Tensor, Optional[Params]]:
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    shifted = _token_shift(x, state["shift"] if state else None)

    def lerp(mu):
        return x + (shifted - x) * mu.to(x.dtype)

    xr, xk, xv, xg, xw = (lerp(p[m]) for m in ("mu_r", "mu_k", "mu_v",
                                               "mu_g", "mu_w"))

    def heads(y):  # (B,T,d) → (B,H,T,hd)
        return L.split_heads(y, h, hd).transpose(1, 2)

    r = heads(L.linear(p["wr"], xr, cfg))
    k = heads(L.linear(p["wk"], xk, cfg))
    v = heads(L.linear(p["wv"], xv, cfg))
    g = F.silu(L.linear(p["wg"], xg, cfg))
    logw = heads(_decays(p, xw))
    u = p["u"].to(x.dtype)
    f32 = torch.float32

    if state is None:
        o = local_rows(
            lambda *a: _WKV[wkv](*a, chunk=cfg.rwkv_chunk),
            [r.to(f32), k.to(f32), v.to(f32), logw.to(f32), u.to(f32)],
            [(0, 1)] * 4 + [(None, 0)], [(0, 1)],
            "WKV: per (batch, head) rows").to(x.dtype)
        new_state = None
    else:
        w = torch.exp(logw[:, :, 0].to(f32))  # (B,H,D)
        o, s_new = _wkv_recurrent_step(
            state["s"], r[:, :, 0].to(f32), k[:, :, 0].to(f32),
            v[:, :, 0].to(f32), w, u.to(f32))
        o = o[:, :, None].to(x.dtype)  # (B,H,1,D)
        new_state = {"s": s_new, "shift": x[:, -1]}

    o = o.transpose(1, 2).reshape(b, t, d)
    # per-head group norm (RWKV6 uses GroupNorm over heads; eps 1e-5, not
    # cfg.norm_eps)
    og = L.split_heads(o, h, hd).to(f32)
    og = og * torch.rsqrt((og * og).mean(-1, keepdim=True) + 1e-5)
    o = (og.reshape(b, t, d) * p["out_norm"]).to(x.dtype) * g
    return L.linear(p["wo"], o, cfg), new_state


def channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    shifted = _token_shift(x, state["shift"] if state else None)
    xk = x + (shifted - x) * p["mu_k"].to(x.dtype)
    xr = x + (shifted - x) * p["mu_r"].to(x.dtype)
    k = L.linear(p["wk"], xk, cfg)
    k = torch.square(L.act_fn(k, cfg, "relu"))  # relu² (RWKV channel mix)
    r = torch.sigmoid(L.linear(p["wr"], xr, cfg))
    out = r * L.linear(p["wv"], k, cfg)
    new_state = {"shift": x[:, -1]} if state is not None else None
    return out, new_state


def block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[Params] = None, wkv: str = "scan"
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    tm_state = state["tm"] if state else None
    cm_state = state["cm"] if state else None
    att, tm_new = time_mix(p["time_mix"], L.norm(p["ln1"], x, cfg), cfg,
                           state=tm_state, wkv=wkv)
    x = x + att
    ffn, cm_new = channel_mix(p["channel_mix"], L.norm(p["ln2"], x, cfg),
                              cfg, state=cm_state)
    x = x + ffn
    new_state = {"tm": tm_new, "cm": cm_new} if state is not None else None
    return x, new_state


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------


def check_wkv(wkv: str) -> None:
    if wkv not in _WKV:
        raise ValueError(f"unknown wkv route {wkv!r}; choose from {WKV_ROUTES}")


def _trunk(params: Params, tokens, cfg: ModelConfig, wkv: str
           ) -> torch.Tensor:
    check_wkv(wkv)
    x = _embed(params, tokens, cfg)

    def body(carry, bp):
        y, _ = block_fwd(bp, constrain_batch(carry), cfg, wkv=wkv)
        return y

    g = remat_group_size(cfg) if cfg.remat else 1
    x = scan_layers(body, x, unstack_layers(params["blocks"], cfg.n_layers),
                    cfg, g)
    return L.norm(params["final_norm"], x, cfg)


def forward(params: Params, tokens, cfg: ModelConfig, wkv: str = "scan"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _trunk(params, tokens, cfg, wkv)
    return _unembed(params, x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)


def loss_fn(params: Params, batch, cfg: ModelConfig, wkv: str = "chunked"):
    """The reference's loss; differentiable through the ``"chunked"``
    route (the default), not through the kernel's."""
    x = _trunk(params, batch["tokens"], cfg, wkv)
    ce = L.tied_lm_loss(params, x, batch)
    return ce, {"loss": ce, "ce": ce}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int = 0, *,
                device="cuda") -> Params:
    """Recurrent state, O(1) in sequence length, with a leading layer
    axis: per layer the WKV state (B, H, hd, hd) float32 and the two token
    shifts (B, d) in ``cfg.dtype``."""
    dev = resolve_device(device)
    n, d = cfg.n_layers, cfg.d_model
    h = d // cfg.rwkv_head_dim
    act = getattr(torch, cfg.dtype)
    return {
        "tm": {"s": torch.zeros((n, batch, h, cfg.rwkv_head_dim,
                                 cfg.rwkv_head_dim), device=dev),
               "shift": torch.zeros((n, batch, d), dtype=act, device=dev)},
        "cm": {"shift": torch.zeros((n, batch, d), dtype=act, device=dev)},
    }


def decode_step(params: Params, caches: Params, tokens, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One token per row: tokens (B, 1) → logits (B, 1, V) and the new
    caches, in the same stacked layout.  ``pos`` is unused (the state is
    position-free) and kept for the family-independent signature."""
    x = _embed(params, tokens, cfg)
    new = []
    for i in range(cfg.n_layers):
        x, st = block_fwd(layer_params(params["blocks"], i), x, cfg,
                          state=layer_params(caches, i))
        new.append(st)
    x = L.norm(params["final_norm"], x, cfg)
    return _unembed(params, x), stack_layers(new)


def prefill(params: Params, tokens, cfg: ModelConfig, wkv: str = "scan"
            ) -> torch.Tensor:
    """Last-position logits (B, 1, V) of the whole prompt."""
    x = _trunk(params, tokens, cfg, wkv)
    return _unembed(params, x[:, -1:])
