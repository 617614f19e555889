"""Flash attention (online softmax), the forward pass.

Counterpart of the forward of ``repro.models.flash``, which the reference
writes in plain ``jax.numpy`` (no Pallas kernel): queries and keys in
blocks of ``chunk``, a running max ``m``, normaliser ``l`` and float32
accumulator per query row, so the (S, S) probability matrix never exists.
Each block's logits are formed in the input dtype and then cast to float32;
the probabilities are cast back to the input dtype before the PV product,
whose result accumulates in float32; padded keys are masked by the true
sequence length.

Under the causal mask a key block that lies wholly after its query block
adds nothing (its probabilities are exactly 0, its correction exactly 1),
so the loop skips it: the result is the reference's, bit for bit in the
same arithmetic.

The reference's hand-written backward (recomputing P blockwise from the
saved log-sum-exp) becomes a ``torch.autograd.Function`` with the training
slice; :func:`_flash_fwd` already returns that residual.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["flash_attention"]

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, chunk: int = 512) -> torch.Tensor:
    """q,k,v: (B,H,S,D[v]) — q pre-scaled by 1/√d. Returns (B,H,S,Dv)."""
    out, _ = _flash_fwd(q, k, v, causal, chunk)
    return out


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
    for qi in range(nc):
        q_i = q[:, :, qi * chunk:(qi + 1) * chunk]
        m = torch.full((b, h, chunk), _NEG, dtype=f32, device=q.device)
        l = torch.zeros((b, h, chunk), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, chunk, dv), dtype=f32, device=q.device)
        for kj in range(qi + 1 if causal else nc):
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
    out = torch.cat(outs, dim=2)[:, :, :s]
    lse = torch.cat(lses, dim=2)[:, :, :s]
    return out, lse
