"""Learning-rate schedules (pure functions of the step counter).

Counterpart of ``repro.optim.schedule``.  A schedule maps a step tensor to
a float32 0-d tensor on the step's device, computed in float32 as the
reference computes it (not in Python doubles).
"""

from __future__ import annotations

import math

import torch

from ..core.fixedpoint import true_divide

__all__ = ["warmup_cosine", "constant"]


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else None


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_device(step))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac · peak_lr`` at ``total_steps``."""
    def fn(step):
        step = torch.as_tensor(step, device=_device(step)).to(torch.float32)
        warm = true_divide(peak_lr * step, max(warmup_steps, 1))
        prog = torch.clamp(true_divide(step - warmup_steps,
                                       max(total_steps - warmup_steps, 1)),
                           0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn
