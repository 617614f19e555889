"""AdamW with optional fixed-point (int8) moment storage.

Counterpart of ``repro.optim.adamw``: the paper's Table-2 encode/decode
applied beyond the paper.  Adam's m/v moments can be stored as int8 codes,
8× less optimizer state than float32, decoded and re-encoded around each
update.

Layout: codes keep the parameter's own shape (int8) with one float32
absmax scale per last-axis row (per-row, not per-tensor: Adam moments span
orders of magnitude within a tensor).  Leaves with fewer than 2 dims stay
float32.

The update runs in place under ``torch.no_grad()``: parameters and moments
are overwritten, and the returned trees are the same objects.  The
arithmetic is the reference's, in its order: float32 bias corrections
``1 - b ** step``, weight decay on every leaf (norms and biases included),
round half to even, and every division that feeds a rounding step divides
by a tensor on the operand's device (``core.fixedpoint.true_divide``), so
that the card's codes round as the CPU's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..core import tree as T
from ..core.fixedpoint import true_divide
from ..distributed import cost

__all__ = ["AdamWConfig", "init", "apply_updates", "adamw_step"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: int = 32  # 8 → fixed-point moments (paper C1 beyond-paper)


# ---------------------------------------------------------------------------
# blockwise fixed-point moment codec
# ---------------------------------------------------------------------------


def _q_encode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Shape-preserving int8 codes + per-row (last axis) float32 scales."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = true_divide(torch.clamp_min(absmax, 1e-12), 127.0)
    codes = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return {"codes": codes, "scale": scale.to(torch.float32)}


def _q_decode(q: Dict[str, torch.Tensor]) -> torch.Tensor:
    return q["codes"].to(torch.float32) * q["scale"]


def _quantizable(leaf: torch.Tensor) -> bool:
    return leaf.dim() >= 2


def _zeros_f32(leaf: torch.Tensor) -> torch.Tensor:
    """float32 zeros of ``leaf``'s shape (a DTensor keeps its layout)."""
    return torch.zeros_like(leaf, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def _moment_init(leaf: torch.Tensor, bits: int):
    zeros = _zeros_f32(leaf)
    if bits == 8 and _quantizable(leaf):
        return _q_encode(zeros)
    return zeros


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def init(params, cfg: AdamWConfig):
    """Zero moments for every leaf of ``params`` (int8 codes and scales for
    leaves of rank ≥ 2 when ``cfg.state_bits == 8``) and a step count,
    int32, on the first leaf's device."""
    first = T.leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": T.map_leaves(lambda p: _moment_init(p, cfg.state_bits), params),
        "v": T.map_leaves(lambda p: _moment_init(p, cfg.state_bits), params),
    }


def _global_norm(grads) -> torch.Tensor:
    total = 0
    for g in T.leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig,
                  lr: Optional[torch.Tensor] = None):
    """One AdamW step, in place.  Returns ``(params, state, metrics)``: the
    same trees, updated, and ``{"grad_norm"}``."""
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    gnorm = _global_norm(grads)
    clip = torch.clamp(torch.full((), cfg.grad_clip, dtype=torch.float32,
                                  device=gnorm.device)
                       / torch.clamp_min(gnorm, 1e-9), max=1.0)

    bits = cfg.state_bits
    stepf = step.to(torch.float32)

    def bias_correction(b: float) -> torch.Tensor:
        return 1.0 - torch.pow(torch.full((), b, dtype=torch.float32,
                                          device=step.device), stepf)

    bc1, bc2 = bias_correction(cfg.b1), bias_correction(cfg.b2)

    def upd(p, g, m_q, v_q):
        g = g.to(torch.float32) * clip
        q = bits == 8 and _quantizable(p)
        m = _q_decode(m_q) if q else m_q
        v = _q_decode(v_q) if q else v_q
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        # int8 moments: a channel whose v rounds to code 0 while its m does
        # not would take an O(m/ε) step; the denominator is bounded by the
        # OLD v codes' per-row resolution, as in the reference
        denom = torch.sqrt(vhat) + cfg.eps
        if q:
            denom = denom + torch.sqrt(v_q["scale"] * 0.5 / bc2)
        pf = p.to(torch.float32)
        delta = mhat / denom + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        for old, new in ((m_q, m), (v_q, v)):
            if q:
                enc = _q_encode(new)
                old["codes"].copy_(enc["codes"])
                old["scale"].copy_(enc["scale"])
            else:
                old.copy_(new)
        return p

    T.map_leaves(upd, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm}


def _split(batch: Dict[str, Any], k: int, i: int) -> Dict[str, Any]:
    """Microbatch ``i`` of ``k``: rows ``i·B/k … (i+1)·B/k`` of every input
    (numpy arrays or tensors), as the reference's reshape (k, B/k, …).  A
    DTensor whose rows are sharded keeps them sharded: each rank takes rows
    ``i·b/k … (i+1)·b/k`` of its own ``b`` rows, so the k microbatches
    still partition the batch (their grouping follows the ranks; the
    summed gradient is the same sum)."""
    out = {}
    for name, x in batch.items():
        n = x.shape[0] // k
        out[name] = _rows(x, k, i) if _row_sharded(x) else x[i * n:(i + 1) * n]
    return out


def _row_sharded(x) -> bool:
    if not (isinstance(x, torch.Tensor) and torch.distributed.is_available()):
        return False
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim == 0 for p in x.placements)


def _rows(x, k: int, i: int):
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    n = local.shape[0] // k
    return DTensor.from_local(local[i * n:(i + 1) * n], x.device_mesh,
                              x.placements, run_check=False,
                              shape=(x.shape[0] // k, *x.shape[1:]),
                              stride=local[i * n:(i + 1) * n].stride())


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor loss summed across its partial ranks (the value every
    rank then differentiates); a plain tensor as it is."""
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor, Replicate
        if isinstance(x, DTensor):
            return x.redistribute(x.device_mesh,
                                  [Replicate()] * x.device_mesh.ndim)
    return x


def _grads(loss_fn: Callable, params, batch):
    """``loss_fn``'s value, metrics and gradients with respect to every
    floating leaf of ``params`` (zeros for a leaf the loss does not reach).
    The loss runs on detached aliases of the leaves, so ``params`` never
    comes to require grad."""
    live = T.map_leaves(
        lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    flat = T.leaves(live)
    wrt = [p for p in flat if p.requires_grad]
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        loss = _replicated(loss)
        gs = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = [next(gs) if p.requires_grad else None for p in flat]
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, T.unflatten(params, grads)


def adamw_step(loss_fn: Callable, params, state, batch, cfg: AdamWConfig,
               lr: Optional[torch.Tensor] = None, accum_steps: int = 1):
    """The loss's gradients and the AdamW update, in one call.  Returns
    ``(params, state, metrics)`` with ``grad_norm`` and ``loss``.

    ``accum_steps > 1`` splits the batch's leading axis into microbatches
    and sums their float32 gradients, divided by ``accum_steps``: live
    activations shrink ÷k at the cost of one parameter-sized float32
    buffer.  Under the dry run's folding cost counter one microbatch runs,
    its counts multiplied by ``accum_steps``.
    """
    if accum_steps <= 1:
        loss, metrics, grads = _grads(loss_fn, params, batch)
        params, state, opt_metrics = apply_updates(params, grads, state, cfg,
                                                   lr)
        return params, state, {**metrics, **opt_metrics, "loss": loss}

    g_acc = T.map_leaves(_zeros_f32, params)
    loss_sum = None
    for i in cost.loop(accum_steps):
        loss, _, grads = _grads(loss_fn, params, _split(batch, accum_steps, i))
        T.map_leaves(lambda a, g: a.add_(g.to(torch.float32)), g_acc, grads)
        if loss_sum is None:
            loss_sum = torch.zeros((), dtype=torch.float32, device=loss.device)
        loss_sum = loss_sum + loss
        del grads
    grads = T.map_leaves(lambda g: true_divide(g, accum_steps), g_acc)
    loss = true_divide(loss_sum, accum_steps)
    params, state, opt_metrics = apply_updates(params, grads, state, cfg, lr)
    return params, state, {**opt_metrics, "loss": loss}
