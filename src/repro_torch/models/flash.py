"""Flash attention (online softmax) with a hand-written backward.

Counterpart of ``repro.models.flash``, which the reference writes in plain
``jax.numpy`` (no Pallas kernel) as a ``jax.custom_vjp``.  The forward
takes queries and keys in blocks of ``chunk``, with a running max ``m``,
normaliser ``l`` and float32 accumulator per query row, so the (S, S)
probability matrix never exists.  Each block's logits are formed in the
input dtype and then cast to float32; the probabilities are cast back to
the input dtype before the PV product, whose result accumulates in
float32; padded keys are masked by the true sequence length.

The backward is a ``torch.autograd.Function`` that saves q, k, v, the
output and the per-row log-sum-exp, all O(S·d), and recomputes P block by
block from them, with the reference's casts: ``delta = rowsum(dO·O)`` in
float32, P cast to the input dtype before the dV product, dS cast to the
input dtype before the dK and dQ products, every product accumulated in
float32.  dQ accumulates over key blocks in order, dK and dV over query
blocks in order, as the reference's scans add them.

Under the causal mask a key block that lies wholly after its query block
adds nothing (its probabilities are exactly 0, its correction exactly 1,
its gradient terms exactly 0), so both passes skip it: the results are the
reference's, in the same arithmetic.

Under the dry run's folding cost counter (``distributed.cost``) each loop
runs one block, its counts multiplied by the number of blocks (the causal
pairs by their mean per row, (n + 1) / 2).

K and V may have fewer heads than q (grouped-query attention): query head
``h`` reads KV head ``h // (H / H_kv)``.  On the card, for causal bf16 or
fp16 calls at the head dims it is built for, the forward is one
hand-written kernel (``kernels/flash_attention.py``, wgmma and TMA, its
own 128-key tiles whatever ``chunk``) that reads the grouped K/V by index
and returns the same pair (out, lse), taking q, k and v as they lie (an
operand TMA cannot read makes it raise; nothing is copied); the backward
stays the plain one
above, on K/V repeated per query head, with each group's gradients
summed.  Everywhere else (the CPU, float32, non-causal, other head dims,
under a dispatch mode such as the cost counter) the plain forward runs on
K/V repeated per query head.  ``flash_stats`` counts the calls by path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..distributed import cost
from ..kernels import flash_attention as fa
from .layers import _repeat_kv

__all__ = ["flash_attention", "flash_stats", "FlashStats"]

_NEG = torch.finfo(torch.float32).min


def _mask(qi: int, kj: int, chunk: int, causal: bool, s_true: int,
          device) -> torch.Tensor:
    """Valid-key mask of the (qi, kj) tile: padded key positions always
    excluded; causal on top."""
    kpos = kj * chunk + torch.arange(chunk, device=device)[None, :]
    valid = kpos < s_true
    if causal:
        qpos = qi * chunk + torch.arange(chunk, device=device)[:, None]
        return (qpos >= kpos) & valid
    return valid.expand(chunk, chunk)


class FlashStats:
    """Calls of :func:`flash_attention` since the last :meth:`reset`, by
    path: ``kernel`` (the hand-written forward) and ``plain``.  Host
    integers (no device read)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.kernel = self.plain = 0


#: the calls of :func:`flash_attention` by path (``flash_stats.reset()``)
flash_stats = FlashStats()


def _repeat_heads(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, H_kv, S, D) → (B, H_kv·n_rep, S, D): ``layers._repeat_kv`` on
    the (B, S, H_kv, D) layout the callers transposed from."""
    return _repeat_kv(x.transpose(1, 2), n_rep).transpose(1, 2)


def _mode_active() -> bool:
    """Whether a ``TorchDispatchMode`` (the dry run's cost counter, fake
    tensors) sees the ops: it must see the plain form's."""
    return _get_current_dispatch_mode() is not None


def _kernel_path(q, k, v, causal: bool) -> bool:
    return fa.kernel_applies(q.device.type, q.dtype, q.shape, k.shape,
                             v.shape, causal, _mode_active()) \
        and k.dtype == v.dtype == q.dtype \
        and k.device == v.device == q.device


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, chunk: int = 512) -> torch.Tensor:
    """q (B,H,S,D), k (B,H_kv,S,D), v (B,H_kv,S,Dv) with H % H_kv == 0 —
    q pre-scaled by 1/√d; query head h reads KV head h // (H / H_kv).
    Returns (B,H,S,Dv); differentiable in q, k and v through the
    hand-written backward."""
    h, hkv = q.shape[1], k.shape[1]
    if hkv == 0 or h % hkv or v.shape[1] != hkv:
        raise ValueError(f"{h} query heads do not group over K/V heads "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if _kernel_path(q, k, v, causal):
        flash_stats.kernel += 1
        return _FlashAttention.apply(q, k, v, causal, chunk, True)
    flash_stats.plain += 1
    n_rep = h // hkv
    return _FlashAttention.apply(q, _repeat_heads(k, n_rep),
                                 _repeat_heads(v, n_rep), causal, chunk,
                                 False)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int, kernel: bool):
        if kernel:
            out, lse = fa.flash_attention_fwd(q, k, v)
        else:
            out, lse = _flash_fwd(q, k, v, causal, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.chunk = causal, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        hkv = k.shape[1]
        n_rep = q.shape[1] // hkv
        dq, dk, dv = _flash_bwd(q, _repeat_heads(k, n_rep),
                                _repeat_heads(v, n_rep), out, lse, dout,
                                ctx.causal, ctx.chunk)
        if n_rep > 1:  # each KV head's gradient: the sum over its group
            dk = dk.unflatten(1, (hkv, n_rep)).sum(2)
            dv = dv.unflatten(1, (hkv, n_rep)).sum(2)
        return dq, dk, dv, None, None, None


def _flash_fwd(q, k, v, causal: bool, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The output and the per-row log-sum-exp (B,H,S) float32."""
    b, h, s, _ = q.shape
    dv = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    nc = q.shape[2] // chunk
    f32 = torch.float32
    outs, lses = [], []
    pairs = (nc + 1) / 2 if causal else None  # key blocks per query block
    for qi in cost.loop(nc):
        q_i = q[:, :, qi * chunk:(qi + 1) * chunk]
        m = torch.full((b, h, chunk), _NEG, dtype=f32, device=q.device)
        l = torch.zeros((b, h, chunk), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, chunk, dv), dtype=f32, device=q.device)
        for kj in cost.loop(qi + 1 if causal else nc, pairs):
            k_j = k[:, :, kj * chunk:(kj + 1) * chunk]
            v_j = v[:, :, kj * chunk:(kj + 1) * chunk]
            s_ij = torch.einsum("bhqd,bhkd->bhqk", q_i, k_j).to(f32)
            msk = _mask(qi, kj, chunk, causal, s, q.device)
            s_ij = s_ij.masked_fill(~msk, _NEG)
            m_new = torch.maximum(m, s_ij.amax(-1))
            p = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(q_i.dtype), v_j).to(f32)
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).to(q_i.dtype))
        lses.append(m + torch.log(l))
    out = torch.cat(cost.fill(outs, nc), dim=2)[:, :, :s]
    lse = torch.cat(cost.fill(lses, nc), dim=2)[:, :, :s]
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, causal: bool, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`flash_attention` from the forward's inputs, its
    output and log-sum-exp, and the output's gradient ``dout``."""
    b, h, s, d = q.shape
    pad = (-s) % chunk
    if pad:  # padded rows: zero dout, out and lse, as the reference pads
        q, k, v, out, dout = (F.pad(t, (0, 0, 0, pad))
                              for t in (q, k, v, out, dout))
        lse = F.pad(lse, (0, pad))
    nc = q.shape[2] // chunk
    f32, dt = torch.float32, q.dtype
    dout = dout.to(dt)
    delta = torch.sum(dout.to(f32) * out.to(f32), -1)  # rowsum(dO ∘ O)

    def blk(x, i):
        return x[:, :, i * chunk:(i + 1) * chunk]

    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dks, dvs = [], []
    pairs = (nc + 1) / 2 if causal else None  # query blocks per key block
    for kj in cost.loop(nc):
        k_j, v_j = blk(k, kj), blk(v, kj)
        dk_j = torch.zeros(k_j.shape, dtype=f32, device=q.device)
        dv_j = torch.zeros(v_j.shape, dtype=f32, device=q.device)
        start = kj if causal else 0
        for i in cost.loop(nc - start, pairs):
            qi = start + i
            q_i, do_i = blk(q, qi), blk(dout, qi)
            s_ij = torch.einsum("bhqd,bhkd->bhqk", q_i, k_j).to(f32)
            msk = _mask(qi, kj, chunk, causal, s, q.device)
            p = torch.exp(s_ij - blk(lse, qi)[..., None])
            p = torch.where(msk, p, torch.zeros((), dtype=f32,
                                                device=q.device))
            dv_j = dv_j + torch.einsum("bhqk,bhqd->bhkd", p.to(dt),
                                       do_i).to(f32)
            dp = torch.einsum("bhqd,bhkd->bhqk", do_i, v_j).to(f32)
            ds = (p * (dp - blk(delta, qi)[..., None])).to(dt)
            dk_j = dk_j + torch.einsum("bhqk,bhqd->bhkd", ds, q_i).to(f32)
            dq_i = blk(dq, qi)
            dq_i += torch.einsum("bhqk,bhkd->bhqd", ds, k_j).to(f32)
        dks.append(dk_j)
        dvs.append(dv_j)
    dk = torch.cat(cost.fill(dks, nc), dim=2)
    dv = torch.cat(cost.fill(dvs, nc), dim=2)
    return (dq[:, :, :s].to(dt), dk[:, :, :s].to(k.dtype),
            dv[:, :, :s].to(v.dtype))
