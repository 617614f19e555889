"""The plain reference of a DeepSeek-V2 prefill (arXiv:2405.04434; the
``deepseek-ai/DeepSeek-V2`` ``config.json``): multi-head latent attention
with YaRN rotary parts, a leading dense SwiGLU layer and group-limited,
dropless MoE layers, in float32 ``torch`` with TF32 off, written out step
by step.

A block is pre-norm: ``x += MLA(RMSNorm(x))``, then
``x += FFN(RMSNorm(x))``.  FFN is the dense SwiGLU
``down(silu(gate(h)) * up(h))`` of width ``intermediate_size`` in the
first ``first_k_dense_replace`` layers and the MoE in the others.  The
final RMSNorm and the untied head give the logits at the last position
only (as a prefill returns them).

MLA, expanded (as a prefill computes it):

* ``c_q = RMSNorm(x W_qa)``; ``q_h = c_q W_qb,h = [q_nope,h | q_rope,h]``;
* ``[c_kv | k_rope] = x W_kva``, ``c_kv = RMSNorm(c_kv)``;
  ``k_nope,h = c_kv W_kb,h``, ``v_h = c_kv W_vb,h``;
* ``q_rope,h`` and the one ``k_rope`` that every head shares are rotated
  at positions 0..S-1 with YaRN's frequencies;
* ``o_h = softmax_causal((q_nope,h·k_nope,h + q_rope,h·k_rope) · s) v_h``
  with ``s = mscale²/√(qk_nope + qk_rope)``,
  ``mscale = 0.1·mscale_all_dim·ln(factor) + 1``; the output is
  ``[o_1..o_H] W_o``.  Scores are computed in query blocks, so that the
  (H, S, S) matrix never exists.

YaRN: for pair ``j`` of the ``d`` rotary dims,
``extra_j = θ^(−2j/d)``, ``inter_j = extra_j / factor``,
``ramp_j = clamp((j − lo)/(hi − lo), 0, 1)`` with ``lo``/``hi`` the floor
and ceiling of the correction dims ``d·ln(L₀/(2π·β))/(2·ln θ)`` of
``beta_fast`` and ``beta_slow``; ``inv_freq_j = inter_j·ramp_j +
extra_j·(1 − ramp_j)``; cos and sin scaled by
``mscale(factor, mscale)/mscale(factor, mscale_all_dim)`` (1 here).

MoE: ``p = softmax(x W_r)`` over the ``n_routed_experts``; group ``g``
holds experts ``g·E/G .. (g+1)·E/G − 1`` and scores ``max p`` over them;
the ``topk_group`` best groups are kept (ties to the lower group) and the
top ``num_experts_per_tok`` of ``p`` among their experts taken (ties to
the lower expert); gates ``routed_scaling_factor·p_e`` with no
renormalisation (``norm_topk_prob`` false).  Every slot is computed
(dropless), expert by expert:
``y = Σ_e gate_e·(silu(x W_g,e) ⊙ x W_u,e) W_d,e + Shared(x)``, where
``Shared`` is the SwiGLU of width ``n_shared_experts·moe_intermediate_size``.

Departures from the published model:

* the rotary parts rotate halves as laid out; the published code first
  de-interleaves the rope channels.  With weights drawn at random that is
  a fixed permutation of the rope columns of ``W_qb`` and ``W_kva``;
* no cache and no batching of requests: one prefill's last-position
  logits.

Weights come as a float tree per layer (``layer(i)``), keyed as the
benchmark lays them out; nothing is taken from the program under test.
``mla``, ``moe`` and ``swiglu`` also run alone, on a sublayer's inputs.
Sizes are the ``config.json`` keys.  This module imports neither JAX, the
JAX package nor the port.
"""

from __future__ import annotations

import math

import torch

Q_BLOCK = 256          # query rows a score block holds


def plain_precision() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(sizes: dict) -> torch.Tensor:
    """YaRN's frequencies of the rotary dims (float64)."""
    sc = sizes["rope_scaling"]
    d, theta = sizes["qk_rope_head_dim"], float(sizes["rope_theta"])
    l0, factor = sc["original_max_position_embeddings"], float(sc["factor"])

    def corr(beta):
        return d * math.log(l0 / (beta * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(corr(sc["beta_fast"])), 0)
    hi = min(math.ceil(corr(sc["beta_slow"])), d - 1)
    j = torch.arange(d // 2, dtype=torch.float64)
    extra = theta ** (-2.0 * j / d)
    inter = extra / factor
    ramp = ((j - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(sizes: dict) -> float:
    sc = sizes["rope_scaling"]
    m = yarn_mscale(float(sc["factor"]), sc["mscale_all_dim"])
    return m * m / math.sqrt(sizes["qk_nope_head_dim"]
                             + sizes["qk_rope_head_dim"])


def rotary(x: torch.Tensor, sizes: dict) -> torch.Tensor:
    """Rotate-half rotary embedding with YaRN's frequencies of x
    (B, S, H, d) at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    sc = sizes["rope_scaling"]
    factor = float(sc["factor"])
    amp = yarn_mscale(factor, sc["mscale"]) / yarn_mscale(
        factor, sc["mscale_all_dim"])
    ang = torch.arange(s, dtype=torch.float64)[:, None] * \
        yarn_inv_freq(sizes)[None, :]
    cos = (torch.cos(ang) * amp).to(torch.float32).to(x.device)
    sin = (torch.sin(ang) * amp).to(torch.float32).to(x.device)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def mla(x: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    """Multi-head latent attention, expanded, causal, on x (B, S, d)."""
    b, s, _ = x.shape
    h = sizes["num_attention_heads"]
    dn, dr = sizes["qk_nope_head_dim"], sizes["qk_rope_head_dim"]
    dv, lkv = sizes["v_head_dim"], sizes["kv_lora_rank"]
    eps = sizes["rms_norm_eps"]
    cq = rms_norm(x @ p["wq_a"]["w"], p["q_norm"]["scale"], eps)
    q = (cq @ p["wq_b"]["w"]).reshape(b, s, h, dn + dr)
    kv = x @ p["wkv_a"]["w"]
    ckv = rms_norm(kv[..., :lkv], p["kv_norm"]["scale"], eps)
    k_nope = (ckv @ p["wk_b"]["w"]).reshape(b, s, h, dn)
    v = (ckv @ p["wv_b"]["w"]).reshape(b, s, h, dv)
    q_nope = q[..., :dn]
    q_rope = rotary(q[..., dn:], sizes)
    k_rope = rotary(kv[..., lkv:][:, :, None, :], sizes)[:, :, 0]  # (B,S,dr)
    scale = softmax_scale(sizes)
    out = torch.empty(b, s, h, dv, device=x.device)
    for i in range(b):
        kn = k_nope[i].transpose(0, 1)                    # (H, S, dn)
        vi = v[i].transpose(0, 1)                         # (H, S, dv)
        for a in range(0, s, Q_BLOCK):
            e = min(a + Q_BLOCK, s)
            qn = q_nope[i, a:e].transpose(0, 1)           # (H, n, dn)
            qr = q_rope[i, a:e].transpose(0, 1)           # (H, n, dr)
            scores = (qn @ kn[:, :e].transpose(1, 2)
                      + qr @ k_rope[i, :e].t()) * scale   # (H, n, e)
            qpos = torch.arange(a, e, device=x.device)[:, None]
            kpos = torch.arange(e, device=x.device)[None, :]
            scores = scores.masked_fill(kpos > qpos, -math.inf)
            out[i, a:e] = (torch.softmax(scores, -1) @ vi[:, :e]
                           ).transpose(0, 1)
    return out.reshape(b, s, h * dv) @ p["wo"]["w"]


def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    g = x @ p["gate"]["w"]
    return (g * torch.sigmoid(g) * (x @ p["up"]["w"])) @ p["down"]["w"]


def route(x: torch.Tensor, w_router: torch.Tensor, sizes: dict) -> tuple:
    """(gates, expert ids), each (T, k), of the tokens x (T, d):
    group-limited greedy, ties to the lower index."""
    e, g = sizes["n_routed_experts"], sizes["n_group"]
    k, kg = sizes["num_experts_per_tok"], sizes["topk_group"]
    probs = torch.softmax(x @ w_router, -1)                       # (T, E)
    group_score = probs.reshape(-1, g, e // g).amax(-1)           # (T, G)
    best = torch.sort(group_score, dim=-1, descending=True,
                      stable=True).indices[:, :kg]
    keep = torch.zeros_like(group_score, dtype=torch.bool)
    keep.scatter_(1, best, True)
    masked = torch.where(keep.repeat_interleave(e // g, 1), probs,
                         torch.zeros_like(probs))
    order = torch.sort(masked, dim=-1, descending=True, stable=True)
    idx = order.indices[:, :k]
    gates = torch.gather(probs, 1, idx)
    if sizes["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    else:
        gates = gates * sizes["routed_scaling_factor"]
    return gates, idx


def moe(x: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    """The dropless MoE on x (B, S, d): every routed slot computed,
    expert by expert, plus the shared experts."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    m = p["moe"]
    gates, idx = route(xt, m["router"]["w"], sizes)
    out = torch.zeros_like(xt)
    for e in range(sizes["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        g = xe @ m["w_gate"][e]
        ye = (g * torch.sigmoid(g) * (xe @ m["w_up"][e])) @ m["w_down"][e]
        out[tok] += gates[tok, slot, None] * ye    # a token once per expert
    return (out + swiglu(xt, m["shared"])).reshape(b, s, d)


def block(x: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    eps = sizes["rms_norm_eps"]
    x = x + mla(rms_norm(x, p["ln1"]["scale"], eps), p["attn"], sizes)
    h = rms_norm(x, p["ln2"]["scale"], eps)
    return x + (swiglu(h, p["mlp"]) if "mlp" in p else moe(h, p, sizes))


def final_logits(x: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor, sizes: dict) -> torch.Tensor:
    """The last position's logits (B, V) of the residual stream x."""
    h = rms_norm(x[:, -1], final_norm.to(torch.float32),
                 sizes["rms_norm_eps"])
    return h @ head.to(torch.float32)


def last_logits(embed_rows: torch.Tensor, layer, final_norm: torch.Tensor,
                head: torch.Tensor, sizes: dict) -> torch.Tensor:
    """Last-position logits (B, V) in float32 of the prompts whose
    embedding rows are ``embed_rows`` (B, S, d), layer by layer:
    ``layer(i)`` gives layer ``i``'s float32 weights (and may free the
    last layer's)."""
    plain_precision()
    x = embed_rows.to(torch.float32)
    for i in range(sizes["num_hidden_layers"]):
        x = block(x, layer(i), sizes)
    return final_logits(x, final_norm, head, sizes)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row: ||got - want|| / ||want|| (float64)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    return (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
