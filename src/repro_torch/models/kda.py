"""Kimi Delta Attention (KDA; Kimi Linear, arXiv:2510.26692): a gated
delta rule whose decay is per key channel.

On the norm's output x (B, T, d), with H heads of key and value width D::

    q, k, v = SiLU(conv(x·W_qkv))       causal depthwise, width K, no bias
    q ← q/‖q‖·D^-½,  k ← k/‖k‖         per head, eps 1e-6 under the root
    g = −exp(A_log[h])·softplus((x·W_fa)·W_fb + dt_bias)   (B,T,H,D) ≤ 0
    β = sigmoid(x·W_b)                   (B,T,H)
    per head, from S_0 = 0 (D × D, key × value), in float32:
        S' = Diag(exp g_t)·S_{t−1}
        S_t = S' + β_t·k_t (v_t − S'ᵀk_t)ᵀ
        o_t = S_tᵀ q_t
    y = RMSNorm_D(o) ⊙ w ⊙ sigmoid((x·W_ga)·W_gb)     per head
    out = y·W_o

A prefill runs the chunked form (:func:`chunk_scan`, chunks of
``CHUNK`` positions).  G is the cumulative log-decay inside a chunk
(Γ = exp G ≤ 1); with the state S_0 entering the chunk::

    A_ti = Σ_c k_t[c]·k_i[c]·exp(G_t[c] − G_i[c])   for i < t
    M_ti = Σ_c q_t[c]·k_i[c]·exp(G_t[c] − G_i[c])   for i ≤ t
    U = (I + diag(β)·A)⁻¹·diag(β)·(V − K̃·S_0),   K̃ = Γ ⊙ K
    O = Q̃·S_0 + M·U,                             Q̃ = Γ ⊙ Q
    S_C = Diag(Γ_C)·S_0 + K̂ᵀ·U,                  K̂_i = exp(G_C − G_i) ⊙ k_i

Only differences G_t − G_s with s ≤ t are exponentiated, so no factor
exceeds 1: the decays reach −10 and below a step at random weights, and a
factorised ``k ⊙ exp(−G)`` would overflow float32 within a chunk.  A and
M are built by halving (:func:`_pair_products`): for t in the upper half
of a block and i in its lower half, exp(G_t − G_i) = exp(G_t − G_r)·
exp(G_r − G_i) with r the lower half's last position, both exponents
≤ 0, so one matrix product gives the block; log2(C) levels cover every
pair.  Nothing is clamped: a factor that underflows to 0 stands for a
product below float32's range.  The inverse of the unit lower triangle is
the product (I − N)(I + N²)(I + N⁴)…(I + N^{C/2}) (N nilpotent).

Writing U = W_v − W_k·S_0 (:func:`_ut_transform`), the state's step is
affine, S_C = F·S_0 + H with F = Diag(Γ_C) − K̂ᵀW_k and H = K̂ᵀW_v: only
that step loops over the chunks, one batched matmul a chunk, and the
outputs O = (Q̃ − M·W_k)·S_0 + M·W_v are taken for every chunk of a span
at once.  A span holds as many chunks as keep F, H and the entering
states (chunks, B·H, D, D) within ``SPAN_BYTES`` each; the state passes
from span to span.  The state, the chunk sums and the decays are in the
decays' dtype (float32); q, k and v come in the activation dtype.  Decode
is the recurrent step (:func:`step`).

Profiler ranges: ``kda.project`` (the projections, conv, normalisation
inputs, gates, the gated norm and ``W_o``) and ``kda.scan`` (the
recurrence alone: :func:`scan`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..configs.base import ModelConfig
from . import layers as L
from . import ssm

__all__ = ["CHUNK", "SPAN_BYTES", "init_kda", "kda_attention", "scan",
           "chunk_scan", "step", "decay", "l2_normalize"]

Params = Dict[str, Any]

CHUNK = 64          # positions a chunk holds (a power of two)
SPAN_BYTES = 1 << 28    # a span's state-sized terms in chunk_scan, at most
L2_EPS = 1e-6       # the q/k normalisation's eps


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.kda_num_heads, cfg.kda_head_dim


def init_kda(generator: torch.Generator, cfg: ModelConfig, *,
             device="cpu") -> Params:
    """One KDA layer's float32 parameters: projections N(0, 1/fan_in), the
    conv U(±1/√K), ``a_log`` = log U(1, 16) per head, ``dt_bias`` the
    inverse softplus of dt log-uniform in [1e-3, 0.1] per channel, the
    output norm's scale 1."""
    d = cfg.d_model
    h, dh = _dims(cfg)
    hd, kw = h * dh, cfg.short_conv_kernel_size
    g = generator

    def lin(din, dout):
        return L.init_linear(g, din, dout, device=device)

    bound = 1.0 / math.sqrt(kw)
    dt = torch.exp(torch.rand(hd, generator=g, device=device)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "wqkv": lin(d, 3 * hd),
        "conv_w": torch.rand((kw, 3 * hd), generator=g, device=device)
        .mul_(2 * bound).sub_(bound),
        "f_a": lin(d, dh), "f_b": lin(dh, hd),
        "a_log": torch.log(torch.rand(h, generator=g, device=device)
                           .mul_(15.0).add_(1.0)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "b_proj": lin(d, h),
        "g_a": lin(d, dh), "g_b": lin(dh, hd),
        "o_norm": {"scale": torch.ones(dh, device=device)},
        "o_proj": lin(hd, d),
    }


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------


def l2_normalize(x: torch.Tensor, eps: float = L2_EPS) -> torch.Tensor:
    """x / √(Σ x² + eps) over the last axis."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _qk(q, k, dtype):
    """q and k normalised per head in ``dtype``, q times D^-½."""
    q, k = l2_normalize(q.to(dtype)), l2_normalize(k.to(dtype))
    return q * q.shape[-1] ** -0.5, k


def decay(f: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor
          ) -> torch.Tensor:
    """The log-decay g (B,T,H,D) ≤ 0 in float32 of the gate's projection
    f (B,T,H·D): −exp(A_log[h])·softplus(f + dt_bias)."""
    h = a_log.shape[0]
    f = F.softplus(f.to(torch.float32) + dt_bias)
    return -torch.exp(a_log)[:, None] * f.unflatten(-1, (h, -1))


def _pair_products(q, k, G):
    """A (…, C, C): Σ_c k_t[c]·k_i[c]·exp(G_t[c] − G_i[c]) for i < t, and
    M: Σ_c q_t[c]·k_i[c]·exp(G_t[c] − G_i[c]) for i ≤ t, zero elsewhere,
    of q, k, G (…, C, D) with G non-increasing along C.  Each level splits
    blocks of 2h positions at their middle and takes the products of the
    upper half's rows with the lower half's through the lower half's last
    position, so that each exponent is ≤ 0."""
    *lead, c, d = k.shape
    a = k.new_zeros(*lead, c, c)
    m = k.new_zeros(*lead, c, c)
    h = c // 2
    while h:
        nb = c // (2 * h)

        def halves(x):
            x = x.reshape(*lead, nb, 2, h, d)
            return x[..., 0, :, :], x[..., 1, :, :]
        g_lo, g_up = halves(G)
        r = g_lo[..., h - 1:, :]                          # (…, nb, 1, D)
        up = torch.exp(g_up - r)
        lo = (halves(k)[0] * torch.exp(r - g_lo)).transpose(-1, -2)
        for out, x in ((a, k), (m, q)):
            blk = (halves(x)[1] * up) @ lo                # (…, nb, h, h)
            view = out.view(*lead, nb, 2, h, nb, 2, h)
            torch.diagonal(view, dim1=-6, dim2=-3)[..., 1, :, 0, :, :].copy_(
                blk.movedim(-3, -1))
        h //= 2
    m.diagonal(dim1=-2, dim2=-1).copy_((q * k).sum(-1))
    return a, m


def _unit_lower_inverse(n: torch.Tensor) -> torch.Tensor:
    """(I + N)⁻¹ of strictly lower triangular N (…, C, C), C a power of
    two: (I − N)(I + N²)(I + N⁴)…(I + N^{C/2}), as N^C = 0."""
    c = n.shape[-1]
    inv = torch.eye(c, dtype=n.dtype, device=n.device) - n
    p, e = n, 2
    while e < c:
        p = p @ p
        inv = inv + inv @ p
        e *= 2
    return inv


def _ut_transform(a, beta, v, kt):
    """(W_v, W_k) = (I + diag(β)·A)⁻¹·diag(β)·[V, K̃]: the pseudo-values of a
    chunk are U = W_v − W_k·S_0."""
    tinv = _unit_lower_inverse(beta[..., None] * a)
    bv = beta[..., None]
    return tinv @ (bv * v), tinv @ (bv * kt)


def _to_chunks(x, chunk: int, dt):
    """(B, T, H, …) → (N, B·H, C, …) in ``dt``, the last chunk padded with
    zeros."""
    b, t, h = x.shape[:3]
    n = -(-t // chunk)
    x = x.to(dt)
    if n * chunk > t:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, n * chunk - t))
    x = x.reshape(b, n, chunk, h, *x.shape[3:]).transpose(2, 3)
    return x.transpose(0, 1).reshape(n, b * h, chunk, *x.shape[4:])


def _chunk_span(q, k, v, g, beta, s):
    """The chunked form over consecutive whole chunks (N, B·H, C, …) from
    the state ``s`` (B·H, D, D) entering the first: returns o (N, B·H, C,
    D) and the state after the last chunk."""
    G = g.cumsum(-2)
    a, m = _pair_products(q, k, G)
    gam = torch.exp(G)
    w_v, w_k = _ut_transform(a, beta, v, gam * k)
    kh = (torch.exp(G[..., -1:, :] - G) * k).transpose(-1, -2)  # K̂ᵀ
    f = torch.diag_embed(gam[..., -1, :]) - kh @ w_k             # (N,BH,D,D)
    hh = kh @ w_v
    states = torch.empty_like(f)
    for j in range(f.shape[0]):
        states[j] = s
        s = torch.baddbmm(hh[j], f[j], s)
    return (gam * q - m @ w_k) @ states + m @ w_v, s


def chunk_scan(q, k, v, g, beta, chunk: int = CHUNK):
    """The chunked form over whole sequences from a zero state: q, k, v
    (B,T,H,D) (q and k not yet normalised), g (B,T,H,D), beta (B,T,H).
    Computes in g's dtype; returns o (B,T,H,D) and the state after the
    last position (B,H,D,D).  T need not be a multiple of ``chunk``: the
    padded positions decay nothing and add nothing.  The sequence goes
    in spans of chunks whose (chunks, B·H, D, D) state-sized terms take
    at most :data:`SPAN_BYTES`, the state carried from span to span."""
    dt = g.dtype
    b, t, h, d = q.shape
    per_chunk = b * h * d * d * torch.finfo(dt).bits // 8
    span = chunk * max(1, SPAN_BYTES // per_chunk)   # positions a span
    o = torch.empty(b, t, h, d, dtype=dt, device=q.device)
    s = g.new_zeros(b * h, d, d)
    for lo in range(0, t, span):
        hi = min(lo + span, t)
        qs, ks = _qk(q[:, lo:hi], k[:, lo:hi], dt)
        parts = (qs, ks, v[:, lo:hi], g[:, lo:hi], beta[:, lo:hi])
        out, s = _chunk_span(*(_to_chunks(x, chunk, dt) for x in parts), s)
        n = out.shape[0]
        out = out.reshape(n, b, h, chunk, d).permute(1, 0, 3, 2, 4)
        o[:, lo:hi] = out.reshape(b, n * chunk, h, d)[:, :hi - lo]
    return o, s.reshape(b, h, d, d)


def step(q, k, v, g, beta, state):
    """One recurrent step from ``state`` (B,H,D,D): q, k, v, g (B,H,D)
    (q and k not yet normalised), beta (B,H), in the state's dtype.
    Returns o (B,H,D) and the new state."""
    dt = state.dtype
    q, k = _qk(q, k, dt)
    s = state * torch.exp(g.to(dt))[..., None]
    u = beta.to(dt)[..., None] * (v.to(dt)
                                  - torch.einsum("bhkv,bhk->bhv", s, k))
    s = s + k[..., None] * u[..., None, :]
    return torch.einsum("bhkv,bhk->bhv", s, q), s


def scan(q, k, v, g, beta, state=None):
    """The recurrence of one layer on q, k, v (B,T,H,D), g (B,T,H,D) and
    beta (B,T,H): without ``state`` :func:`chunk_scan` over the sequence
    from zero, else one :func:`step` from it (T = 1).  Returns o (B,T,H,D)
    in g's dtype and the state after the last position."""
    if state is None:
        return chunk_scan(q, k, v, g, beta)
    o, s = step(q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0], state)
    return o[:, None], s


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def kda_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Params] = None, keep_state: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One KDA mixer on the norm's output x (B,T,d).  With ``state``
    ({"conv": (B, K−1, 3·H·D), "s": (B,H,D,D) float32}) one decode step;
    ``keep_state`` returns the state a prefill leaves.  Returns (out,
    state or None)."""
    b, t, _ = x.shape
    h, dh = _dims(cfg)
    f32 = torch.float32
    with record_function("kda.project"):
        qkv, conv_new = ssm._causal_conv(
            L.linear(p["wqkv"], x, cfg), p["conv_w"], None,
            None if state is None else state["conv"])
        q, k, v = F.silu(qkv).unflatten(-1, (3, h, dh)).unbind(2)
        g = decay(L.linear(p["f_b"], L.linear(p["f_a"], x, cfg), cfg),
                  p["a_log"], p["dt_bias"])
        beta = torch.sigmoid(L.linear(p["b_proj"], x, cfg).to(f32))
    with record_function("kda.scan"):
        o, s_new = scan(q, k, v, g, beta,
                        None if state is None else state["s"])
    with record_function("kda.project"):
        gate = torch.sigmoid(L.linear(
            p["g_b"], L.linear(p["g_a"], x, cfg), cfg).to(f32))
        o = o * torch.rsqrt((o * o).mean(-1, keepdim=True) + cfg.norm_eps)
        y = (o * p["o_norm"]["scale"] * gate.unflatten(-1, (h, dh)))
        out = L.linear(p["o_proj"], y.to(x.dtype).reshape(b, t, h * dh),
                       cfg)
    if state is None and not keep_state:
        return out, None
    return out, {"conv": conv_new, "s": s_new}
