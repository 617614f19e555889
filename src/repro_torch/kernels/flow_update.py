"""Host-side helpers of the flow-update stage that the ingress pipeline
shares (counterparts of ``repro.kernels.flow_update.rank_from_order``).  The flow-update kernel
and its vectorized host lowering are ported with the flow slice."""

from __future__ import annotations

import numpy as np

__all__ = ["rank_from_order"]


def rank_from_order(order: np.ndarray, newg: np.ndarray) -> np.ndarray:
    """Per-group occurrence rank (original order) from a stable sort's
    ``order`` permutation and its group-start mask ``newg``."""
    n = order.shape[0]
    ar = np.arange(n)
    gstart = np.maximum.accumulate(np.where(newg, ar, 0))
    rank = np.empty(n, np.int64)
    rank[order] = ar - gstart
    return rank

