"""The plain reference of a Kimi Linear prefill (arXiv:2510.26692;
moonshotai's ``Kimi-Linear-48B-A3B-Instruct`` ``config.json``): Kimi Delta
Attention (KDA) and MLA without rotary parts in a 3 : 1 pattern, a
leading dense SwiGLU and MoE layers of sigmoid-routed experts with a
selection bias and a shared expert, in float32 ``torch`` with TF32 off,
written out step by step.

A layer is pre-norm: ``x += Mixer(RMSNorm(x))``, then
``x += FFN(RMSNorm(x))``.  The mixer is KDA for the layers of
``linear_attn_config.kda_layers`` and MLA for the others (layers are
numbered from 1); FFN is the dense SwiGLU of width ``intermediate_size``
in the first ``first_k_dense_replace`` layers and the MoE in the others.
The final RMSNorm and the untied head give the logits at the last
position only (as a prefill returns them).

KDA on x, H heads of width D (``linear_attn_config``'s ``num_heads``,
``head_dim``):

* ``q, k, v = SiLU(Σ_j w_j ⊙ (x W_qkv)_{t−K+1+j})``, a causal depthwise
  conv of width K with no bias, split into three runs of H·D channels;
* per head ``q ← q/√(Σq² + 1e-6)·D^-½``, ``k ← k/√(Σk² + 1e-6)``;
* ``g = −exp(A_log[h])·softplus((x W_fa) W_fb + dt_bias)``, one log-decay
  per key channel; ``β = sigmoid(x W_b)``, one per head;
* per head, position by position from ``S = 0`` (D × D, key × value):
  ``S ← Diag(exp g_t) S``, ``S ← S + β_t k_t (v_t − Sᵀk_t)ᵀ``,
  ``o_t = Sᵀ q_t``;
* ``y = RMSNorm_D(o) ⊙ w ⊙ sigmoid((x W_ga) W_gb)`` per head (eps
  ``rms_norm_eps``), and the output ``y W_o``.

MLA on x, without rotary parts (``mla_use_nope``), no q LoRA:
``[q_nope | q_pe] = x W_q`` per head; ``[c | k_pe] = x W_kva``,
``c = RMSNorm(c)``; ``[k_nope | v] = c [W_kb | W_vb]`` per head, the one
``k_pe`` shared by every head; ``o_h = softmax_causal((q_nope·k_nope +
q_pe·k_pe)/√(qk_nope + qk_rope)) v``, in blocks of query rows; the output
``[o_1..o_H] W_o``.

MoE on the tokens x: ``s = sigmoid(x W_r)`` over the ``num_experts``;
the ``num_experts_per_token`` experts of the largest ``s + b`` (``b`` the
selection bias, ties to the lower expert) are taken; their gates are
``s_e / Σ s · routed_scaling_factor`` (``moe_renormalize``); every slot
is computed, expert by expert, and the shared SwiGLU of width
``num_shared_experts·moe_intermediate_size`` added.

Departures from the published model:

* KDA is the token recurrence above, not a chunked form: it shares no
  algorithm with the program's;
* attention is computed in blocks of ``Q_BLOCK`` query rows, so that
  the (H, S, S) matrix never exists;
* RMSNorm multiplies by its weight in float32;
* no cache and no batching of requests: one prefill's last-position
  logits.

Weights come as a float tree per layer (``layer(i)``), keyed as the
benchmark lays them out; nothing is taken from the program under test.
``kda``, ``mla``, ``moe`` and ``swiglu`` also run alone, on a piece's
inputs.  Sizes are the ``config.json`` keys.  This module imports
neither JAX, the JAX package nor the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.mla_moe import (final_logits, plain_precision,
                                         rel_l2, rms_norm, swiglu)

__all__ = ["plain_precision", "rms_norm", "swiglu", "final_logits",
           "rel_l2", "kda", "mla", "route", "moe", "block", "last_logits"]

Q_BLOCK = 256          # query rows an attention score block holds
L2_EPS = 1e-6


def kda(x: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    """Kimi Delta Attention on x (B, T, d), position by position."""
    b, t, _ = x.shape
    la = sizes["linear_attn_config"]
    h, d = la["num_heads"], la["head_dim"]
    w = p["conv_w"]
    y = x @ p["wqkv"]["w"]
    yp = F.pad(y, (0, 0, w.shape[0] - 1, 0))
    y = sum(yp[:, j:j + t] * w[j] for j in range(w.shape[0]))
    q, k, v = (y * torch.sigmoid(y)).reshape(b, t, 3, h, d).unbind(2)
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + L2_EPS) / math.sqrt(d)
    k = k / torch.sqrt((k * k).sum(-1, keepdim=True) + L2_EPS)
    f = (x @ p["f_a"]["w"]) @ p["f_b"]["w"] + p["dt_bias"]
    g = (-torch.exp(p["a_log"])[:, None]
         * F.softplus(f).reshape(b, t, h, d))
    beta = torch.sigmoid(x @ p["b_proj"]["w"])

    def rows(z):  # (B, T, H, D) → (T, B·H, 1, D): position t's rows
        return z.transpose(0, 1).reshape(t, b * h, 1, d).contiguous()
    qs, ks, vs = rows(q), rows(k), rows(v)
    kb = rows(k * beta[..., None]).transpose(-1, -2)      # β_t·k_t, columns
    es = rows(torch.exp(g)).transpose(-1, -2)             # exp g_t, columns
    s = torch.zeros(b * h, d, d, device=x.device)
    o = torch.empty(t, b * h, 1, d, device=x.device)
    for i in range(t):
        s = s * es[i]                                     # Diag(exp g_t)·S
        u = torch.baddbmm(vs[i], ks[i], s, alpha=-1.0)    # v_t − Sᵀk_t
        s = torch.baddbmm(s, kb[i], u)                    # + β_t k_t uᵀ
        torch.bmm(qs[i], s, out=o[i])                     # o_t = Sᵀq_t
    o = o.reshape(t, b, h, d).transpose(0, 1)
    gate = torch.sigmoid((x @ p["g_a"]["w"]) @ p["g_b"]["w"])
    y = rms_norm(o, p["o_norm"]["scale"], sizes["rms_norm_eps"]) \
        * gate.reshape(b, t, h, d)
    return y.reshape(b, t, h * d) @ p["o_proj"]["w"]


def mla(x: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    """MLA without rotary parts, causal, on x (B, S, d)."""
    b, s, _ = x.shape
    h = sizes["num_attention_heads"]
    dn, dr = sizes["qk_nope_head_dim"], sizes["qk_rope_head_dim"]
    dv, lkv = sizes["v_head_dim"], sizes["kv_lora_rank"]
    q = (x @ p["wq"]["w"]).reshape(b, s, h, dn + dr)
    kv = x @ p["wkv_a"]["w"]
    c = rms_norm(kv[..., :lkv], p["kv_norm"]["scale"], sizes["rms_norm_eps"])
    k_pe = kv[..., lkv:]                                  # (B, S, dr)
    k_nope = (c @ p["wk_b"]["w"]).reshape(b, s, h, dn)
    v = (c @ p["wv_b"]["w"]).reshape(b, s, h, dv)
    scale = 1.0 / math.sqrt(dn + dr)
    out = torch.empty(b, s, h, dv, device=x.device)
    for i in range(b):
        kn = k_nope[i].transpose(0, 1)                    # (H, S, dn)
        vi = v[i].transpose(0, 1)                         # (H, S, dv)
        for a in range(0, s, Q_BLOCK):
            e = min(a + Q_BLOCK, s)
            qn = q[i, a:e, :, :dn].transpose(0, 1)        # (H, n, dn)
            qp = q[i, a:e, :, dn:].transpose(0, 1)        # (H, n, dr)
            scores = (qn @ kn[:, :e].transpose(1, 2)
                      + qp @ k_pe[i, :e].t()) * scale     # (H, n, e)
            qpos = torch.arange(a, e, device=x.device)[:, None]
            kpos = torch.arange(e, device=x.device)[None, :]
            scores = scores.masked_fill(kpos > qpos, -math.inf)
            out[i, a:e] = (torch.softmax(scores, -1) @ vi[:, :e]
                           ).transpose(0, 1)
    return out.reshape(b, s, h * dv) @ p["wo"]["w"]


def route(x: torch.Tensor, router: dict, sizes: dict) -> tuple:
    """(gates, expert ids), each (T, k), of the tokens x (T, d): the top
    k of the sigmoid scores plus the selection bias, ties to the lower
    expert; gates the chosen scores renormalised and scaled."""
    k = sizes["num_experts_per_token"]
    s = torch.sigmoid(x @ router["w"])                    # (T, E)
    idx = torch.sort(s + router["bias"], dim=-1, descending=True,
                     stable=True).indices[:, :k]
    gates = torch.gather(s, 1, idx)
    if sizes["moe_renormalize"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * sizes["routed_scaling_factor"], idx


def moe(x: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    """The dropless MoE on x (B, S, d): every routed slot computed,
    expert by expert, plus the shared expert."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, idx = route(xt, p["router"], sizes)
    out = torch.zeros_like(xt)
    for e in range(sizes["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        g = xe @ p["w_gate"][e]
        ye = (g * torch.sigmoid(g) * (xe @ p["w_up"][e])) @ p["w_down"][e]
        out[tok] += gates[tok, slot, None] * ye    # a token once per expert
    return (out + swiglu(xt, p["shared"])).reshape(b, s, d)


def block(x: torch.Tensor, p: dict, sizes: dict) -> torch.Tensor:
    eps = sizes["rms_norm_eps"]
    h = rms_norm(x, p["ln1"]["scale"], eps)
    x = x + (kda(h, p["kda"], sizes) if "kda" in p
             else mla(h, p["attn"], sizes))
    h = rms_norm(x, p["ln2"]["scale"], eps)
    return x + (swiglu(h, p["mlp"]) if "mlp" in p
                else moe(h, p["moe"], sizes))


def last_logits(embed_rows: torch.Tensor, layer, final_norm: torch.Tensor,
                head: torch.Tensor, sizes: dict) -> torch.Tensor:
    """Last-position logits (B, V) in float32 of the prompts whose
    embedding rows are ``embed_rows`` (B, S, d), layer by layer:
    ``layer(i)`` gives layer ``i``'s float32 weights."""
    plain_precision()
    x = embed_rows.to(torch.float32)
    for i in range(sizes["num_hidden_layers"]):
        x = block(x, layer(i), sizes)
    return final_logits(x, final_norm, head, sizes)
