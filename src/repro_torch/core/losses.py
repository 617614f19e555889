"""Loss functions and their Taylor-series approximations (paper §3.4,
Table 5).

The paper replaces the logarithms inside the cross-entropy losses with
3-term Taylor polynomials so that training-side error signals can be
evaluated in a fixed-point pipeline.  Table 5, verbatim:

  MSE:  (y − ŷ)²                                    (already polynomial)
  BCE:  −y(ŷ − ŷ²/2 + ŷ³/3) − (1−y)(−ŷ − ŷ²/2 − ŷ³/3)
  CCE:  −Σᵢ yᵢ (ŷᵢ − ŷᵢ²/2 + ŷᵢ³/3)

Counterpart of ``repro.core.losses``: the printed rows, their exact
references, the normalized MSE of the paper's Figs 3/4, and the exact LM
losses (``cross_entropy_logits``, ``chunked_cross_entropy``).
Divisions by 3 go through ``fixedpoint.true_divide`` so that they round
as the reference's on the card too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.constrain import local_sums
from .fixedpoint import true_divide

__all__ = ["mse", "bce", "cce", "bce_taylor", "cce_taylor", "log_taylor3",
           "normalized_mse", "cross_entropy_logits", "chunked_cross_entropy"]


def mse(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """Mean Squared Error — Table 5 row 1 (its own Taylor expansion)."""
    return torch.mean((y - y_hat) ** 2)


def log_taylor3(p: torch.Tensor) -> torch.Tensor:
    """The paper's 3-term log substitute: log(p) → p − p²/2 + p³/3."""
    return p - p * p / 2.0 + true_divide(p * p * p, 3.0)


def bce(y: torch.Tensor, y_hat: torch.Tensor,
        eps: float = 1e-7) -> torch.Tensor:
    """Exact binary cross-entropy (reference for Table 5 row 2)."""
    y_hat = torch.clamp(y_hat, eps, 1.0 - eps)
    return torch.mean(-(y * torch.log(y_hat) + (1.0 - y) * torch.log1p(-y_hat)))


def bce_taylor(y: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """Table 5 row 2, verbatim:
    −y(ŷ − ŷ²/2 + ŷ³/3) − (1−y)(−ŷ − ŷ²/2 − ŷ³/3)."""
    cube = true_divide(y_hat ** 3, 3.0)
    t_pos = y_hat - y_hat ** 2 / 2.0 + cube
    t_neg = -y_hat - y_hat ** 2 / 2.0 - cube
    return torch.mean(-y * t_pos - (1.0 - y) * t_neg)


def cce(y: torch.Tensor, y_hat: torch.Tensor, eps: float = 1e-7,
        axis: int = -1) -> torch.Tensor:
    """Exact categorical cross-entropy (reference for Table 5 row 3)."""
    y_hat = torch.clamp(y_hat, eps, 1.0)
    return torch.mean(-torch.sum(y * torch.log(y_hat), dim=axis))


def cce_taylor(y: torch.Tensor, y_hat: torch.Tensor,
               axis: int = -1) -> torch.Tensor:
    """Table 5 row 3, verbatim: −Σᵢ yᵢ (ŷᵢ − ŷᵢ²/2 + ŷᵢ³/3)."""
    return torch.mean(-torch.sum(y * log_taylor3(y_hat), dim=axis))


def normalized_mse(y_ref: torch.Tensor, y_approx: torch.Tensor) -> torch.Tensor:
    """The paper's Fig 3/Fig 4 metric: E[(y_ref − y_approx)²] / E[y_ref²]."""
    num = torch.mean((y_ref - y_approx) ** 2)
    den = torch.clamp_min(torch.mean(y_ref ** 2), 1e-12)
    return num / den


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood of float32 ``logits``."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - ll


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard LM loss (exact, log-sum-exp), as the training substrate uses
    it; the Table-5 polynomial form is for paper-scale models only."""
    nll = _nll(logits.to(torch.float32), labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def _chunk_nll_sum(h_i: torch.Tensor, w: torch.Tensor, l_i: torch.Tensor,
                   m_i: torch.Tensor) -> torch.Tensor:
    """Masked NLL sum of one chunk: its (B, chunk, V) float32 logits live
    only inside this call."""
    logits = (h_i @ w).to(torch.float32)
    return (_nll(logits, l_i) * m_i).sum()


def _ce_sums(h: torch.Tensor, w_unembed: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor], chunk: int):
    """The masked NLL sum and the mask's sum, chunk by chunk."""
    b, s, d = h.shape
    pad = (-s) % chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    w = w_unembed.to(h.dtype)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled()
    for i in range(0, h.shape[1], chunk):
        args = (h[:, i:i + chunk], w, labels[:, i:i + chunk],
                mask[:, i:i + chunk])
        nll_sum = nll_sum + (checkpoint(_chunk_nll_sum, *args,
                                        use_reentrant=False)
                             if remat else _chunk_nll_sum(*args))
        m_sum = m_sum + args[3].sum()
    return nll_sum, m_sum


def chunked_cross_entropy(h: torch.Tensor, w_unembed: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """LM loss without materializing the full (B, S, V) logits: the
    sequence is cut into chunks whose (B, chunk, V) logits are made one at
    a time.  h: (B, S, D) final hidden states; w_unembed: (D, V).  The
    chunk size follows the reference's formula (≈2^31 logits per chunk,
    a power of two in [32, 512], at most S).  Under autograd each chunk's
    logits are recomputed in the backward (``torch.utils.checkpoint``, as
    the reference's ``jax.checkpoint``), so the peak vocab-sized temporary
    is one chunk's.  Under a mesh each rank runs the chunks of its own
    rows with the whole unembedding (gathered) and the two sums are
    reduced across the ranks (``distributed.constrain.local_sums``)."""
    b, s, d = h.shape
    if chunk is None:
        v = w_unembed.shape[-1]
        chunk = int(min(512, max(32, (1 << 31) // max(b * v, 1))))
        chunk = 1 << (chunk.bit_length() - 1)  # round down to a power of two
        chunk = min(chunk, s) if s >= 32 else s
    nll_sum, m_sum = local_sums(
        lambda h_, w_, l_, m_: _ce_sums(h_, w_, l_, m_, chunk), h,
        w_unembed, labels, mask, why="cross-entropy: each rank's rows "
        "against the whole unembedding")
    return nll_sum / torch.clamp_min(m_sum, 1.0)
