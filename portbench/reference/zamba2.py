"""The plain reference of a Zamba2 prefill (arXiv:2411.15242; Zyphra's
``Zamba2-7B-Instruct`` ``config.json``): Mamba-2 layers with B and C in
groups of heads, and two shared attention + MLP blocks on the hidden state
concatenated with the embedding, with a LoRA adapter and a ``linear`` of
each application's own, in float32 ``torch`` with TF32 off, written out
step by step.

``h`` is the residual stream, ``e`` the embedding rows.  Layer ℓ:
``h ← h + Mixer_ℓ(RMSNorm_ℓ(h + t))``, where ``t`` is 0 unless ℓ is the
``j``-th of ``hybrid_layer_ids``; then ``t`` is application ``j`` of
shared block ``j % num_mem_blocks``:

* ``c = RMSNorm([h ‖ e])`` (width ``2·hidden_size``);
  ``q, k, v = c W_q, c W_k, c W_v``, ``num_attention_heads`` heads of
  ``attention_head_dim`` (D), rotated (rotate-half, θ^(−2j/D) over all D
  dims, positions 0..S−1) where ``use_mem_rope``;
* ``a = softmax_causal(q kᵀ · (D/2)^-½) v W_o``, in blocks of query rows;
* ``m = RMSNorm(a)``; ``[g ‖ up] = m W_gu + (m A_j) B_j`` (the rank
  ``adapter_rank`` adapter of application ``j``);
  ``t = (GELU(g) ⊙ up) W_down W_linear,j``, GELU the exact (erf) form.

Mixer on ``u``: ``[z ‖ xBC ‖ dt] = u W_in``;
``xBC = SiLU(b + Σ_k w_k ⊙ xBC_{t−3+k})`` (causal depthwise, width
``mamba_d_conv``); ``x, B, C = split(xBC)`` with B, C of
``mamba_ngroups`` groups of ``mamba_d_state``, head ``i`` reading group
``i // (n_mamba_heads / mamba_ngroups)``; ``dt = softplus(dt + dt_bias)``;
``A = −exp(A_log)``; the SSD in its whole-sequence quadratic (dual) form,
per head

    y_t = Σ_{s ≤ t} exp(cum_t − cum_s)·dt_s·(C_t·B_s)·x_s + D·x_t,
    cum_t = Σ_{r ≤ t} dt_r·A,

the exponent masked to −inf above the diagonal before the exp, in blocks
of query rows; ``out = W_out·(w ⊙ GroupRMS(y ⊙ SiLU(z)))``, the RMS over
each group's ``mamba_expand·hidden_size / mamba_ngroups`` channels with
eps 1e-5.  The head: the final RMSNorm and the tied embedding, at the last
position only (as a prefill returns it).

Departures from the published code:

* ``dt`` is not clamped: the published CUDA path leaves it as is
  (``time_step_limit`` null); its plain-torch fallback clamps it below at
  ``time_step_min``;
* the SSD's cumulative log-decays are summed in float64 and taken
  relative to the first row of each block of ``T_BLOCK`` query rows
  before their float32 differences: over 4096 positions the float32
  differences of whole-sequence sums lose ≈1e-3 of the exponent;
* RMSNorm multiplies by its weight in float32 (the published code casts
  to the input dtype first; in float32 that is the same);
* no cache and no batching of requests: one prefill's last-position
  logits.

Weights come as float trees per Mamba layer (``mamba(i)``: ``ln``,
``in_proj``, ``conv_w`` (width, channels), ``conv_b``, ``a_log``,
``dt_bias``, ``d_skip``, ``out_norm``, ``out_proj``), per shared block
(``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``, ``gate_up``, ``down``)
and per application (``linear``, ``adapter_a``, ``adapter_b``), keyed as
the benchmark lays them out; nothing is taken from the program under
test.  ``mixer``, ``attention`` and ``shared_mlp`` also run alone, on a
piece's inputs.  Sizes are the ``config.json`` keys.  This module imports
neither JAX, the JAX package nor the port.
"""

from __future__ import annotations

import math

import torch

Q_BLOCK = 256          # query rows an attention score block holds
T_BLOCK = 256          # query rows an SSD block holds
GATED_EPS = 1e-5


def plain_precision() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """``w ⊙ GroupRMS(y ⊙ SiLU(z))`` over ``groups`` equal runs of the
    last axis."""
    g = (y * silu(z)).unflatten(-1, (groups, -1))
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + GATED_EPS)
    return g.flatten(-2) * w


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv of x (B, T, C) with w (K, C) and bias b:
    ``y_t = b + Σ_k w_k ⊙ x_{t−K+1+k}``."""
    k, t = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    y = b.expand_as(x).clone()
    for i in range(k):
        y = y + xp[:, i:i + t] * w[i]
    return y


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
    """The SSD's quadratic form: x (B,T,H,P), dt (B,T,H), a (H,),
    bmat/cmat (B,T,G,N) → y (B,T,H,P) without the D skip; in blocks of
    ``T_BLOCK`` query rows against the keys up to the block's end."""
    b, t, h, p = x.shape
    per = h // bmat.shape[2]
    y = torch.empty_like(x)
    later = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    for i in range(b):
        cum = torch.cumsum((dt[i] * a).double(), 0)             # (T, H)
        for q0 in range(0, t, T_BLOCK):
            q1 = min(q0 + T_BLOCK, t)
            # exponents relative to the block's first row, in float32
            rel = (cum[:q1] - cum[q0]).float().t()              # (H, q1)
            seg = rel[:, q0:q1, None] - rel[:, None, :]         # (H, n, q1)
            decay = torch.exp(seg.masked_fill(later[q0:q1, :q1], -math.inf))
            del seg
            cb = torch.einsum("tgn,sgn->gts", cmat[i, q0:q1], bmat[i, :q1])
            m = decay * cb.repeat_interleave(per, 0) \
                * dt[i, :q1].t()[:, None, :]
            del decay, cb
            y[i, q0:q1] = (m @ x[i, :q1].transpose(0, 1)).transpose(0, 1)
            del m
    return y


def _mamba_dims(sizes: dict) -> tuple:
    d_in = sizes["mamba_expand"] * sizes["hidden_size"]
    return (d_in, sizes["n_mamba_heads"], sizes["mamba_headdim"],
            sizes["mamba_ngroups"], sizes["mamba_d_state"])


def mixer(u: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    """The Mamba-2 mixer on u (B, T, hidden)."""
    b, t, _ = u.shape
    d_in, h, hp, g, n = _mamba_dims(sizes)
    zxbcdt = u @ p["in_proj"]["w"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * g * n]
    dt = zxbcdt[..., 2 * d_in + 2 * g * n:]
    xbc = silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    x = xbc[..., :d_in].reshape(b, t, h, hp)
    bmat = xbc[..., d_in:d_in + g * n].reshape(b, t, g, n)
    cmat = xbc[..., d_in + g * n:].reshape(b, t, g, n)
    dt = softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y = ssd(x, dt, a, bmat, cmat) + x * p["d_skip"][:, None]
    return gated_rms_norm(y.reshape(b, t, d_in), z, p["out_norm"], g) \
        @ p["out_proj"]["w"]


def mamba_layer(h: torch.Tensor, t, p: dict, sizes: dict) -> torch.Tensor:
    x = h if t is None else h + t
    return h + mixer(rms_norm(x, p["ln"]["scale"], sizes["rms_norm_eps"]),
                     p, sizes)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (B, S, H, D) at positions
    0..S−1 over all D dims."""
    s, d = x.shape[1], x.shape[-1]
    j = torch.arange(d // 2, dtype=torch.float64)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * \
        (float(theta) ** (-2.0 * j / d))[None, :]
    cos = torch.cos(ang).to(torch.float32).to(x.device)[None, :, None, :]
    sin = torch.sin(ang).to(torch.float32).to(x.device)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(hc: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    """A shared block's attention on hc = [h ‖ e] (B, S, 2·hidden),
    through its output projection."""
    b, s, _ = hc.shape
    nh, d = sizes["num_attention_heads"], sizes["attention_head_dim"]
    c = rms_norm(hc, p["ln1"]["scale"], sizes["rms_norm_eps"])
    q = (c @ p["wq"]["w"]).reshape(b, s, nh, d)
    k = (c @ p["wk"]["w"]).reshape(b, s, nh, d)
    v = (c @ p["wv"]["w"]).reshape(b, s, nh, d)
    if sizes["use_mem_rope"]:
        q, k = rotary(q, sizes["rope_theta"]), rotary(k, sizes["rope_theta"])
    scale = (d / 2) ** -0.5
    out = torch.empty(b, s, nh, d, device=hc.device)
    for i in range(b):
        ki, vi = k[i].transpose(0, 1), v[i].transpose(0, 1)    # (H, S, D)
        for a0 in range(0, s, Q_BLOCK):
            e0 = min(a0 + Q_BLOCK, s)
            scores = (q[i, a0:e0].transpose(0, 1) @ ki[:, :e0].transpose(1, 2)
                      ) * scale                                 # (H, n, e)
            qpos = torch.arange(a0, e0, device=hc.device)[:, None]
            kpos = torch.arange(e0, device=hc.device)[None, :]
            scores = scores.masked_fill(kpos > qpos, -math.inf)
            out[i, a0:e0] = (torch.softmax(scores, -1) @ vi[:, :e0]
                             ).transpose(0, 1)
    return out.reshape(b, s, nh * d) @ p["wo"]["w"]


def shared_mlp(a: torch.Tensor, p: dict, app: dict, sizes: dict
               ) -> torch.Tensor:
    """From the attention's output ``a`` to ``t``: the norm, the gated
    GELU MLP with application ``app``'s adapter, and its ``linear``."""
    m = rms_norm(a, p["ln2"]["scale"], sizes["rms_norm_eps"])
    gu = m @ p["gate_up"]["w"]
    if sizes["use_shared_mlp_adapter"]:
        gu = gu + (m @ app["adapter_a"]["w"]) @ app["adapter_b"]["w"]
    f = sizes["intermediate_size"]
    return ((gelu(gu[..., :f]) * gu[..., f:]) @ p["down"]["w"]) \
        @ app["linear"]["w"]


def final_logits(x: torch.Tensor, final_norm: torch.Tensor,
                 embed: torch.Tensor, sizes: dict) -> torch.Tensor:
    """The last position's logits (B, V) of the residual stream x,
    through the tied embedding."""
    h = rms_norm(x[:, -1], final_norm.to(torch.float32),
                 sizes["rms_norm_eps"])
    return h @ embed.to(torch.float32).t()


def last_logits(embed_rows: torch.Tensor, mamba, block, app,
                final_norm: torch.Tensor, embed: torch.Tensor, sizes: dict
                ) -> torch.Tensor:
    """Last-position logits (B, V) in float32 of the prompts whose
    embedding rows are ``embed_rows`` (B, S, hidden), layer by layer:
    ``mamba(i)``, ``block(b)`` and ``app(j)`` give the float32 weights of
    Mamba layer ``i``, shared block ``b`` and application ``j``."""
    plain_precision()
    e = embed_rows.to(torch.float32)
    apps = {layer: j for j, layer in enumerate(sizes["hybrid_layer_ids"])}
    x = e
    for i in range(sizes["num_hidden_layers"]):
        t = None
        j = apps.get(i)
        if j is not None:
            p = block(j % sizes["num_mem_blocks"])
            t = shared_mlp(attention(torch.cat([x, e], -1), p, sizes), p,
                           app(j), sizes)
        x = mamba_layer(x, t, mamba(i), sizes)
    return final_logits(x, final_norm, embed, sizes)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row: ||got - want|| / ||want|| (float64)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
