"""Synthetic flow datasets for the tree-ensemble lane.

Counterpart of ``repro.data.packets`` (``flow_features``,
``anomaly_dataset``, ``qos_dataset``): numpy only and bit-identical to the
reference on the same ``numpy.random.Generator``.  Every generator takes an
explicit ``rng`` and never touches global RNG state.  The raw-header codec
and trace generator belong to the flow engine and are not here yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["flow_features", "anomaly_dataset", "qos_dataset"]


def flow_features(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """Synthetic flow statistics: pkt sizes, inter-arrival, rates, flags —
    normalized to ~N(0, 0.5) like the QoS training data."""
    base = rng.normal(size=(n, d)) * 0.5
    base[:, 0] = np.abs(base[:, 0])  # packet size ≥ 0
    return base.astype(np.float32)


def anomaly_dataset(rng: np.random.Generator, n: int, d: int = 8, *,
                    drift: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled anomaly-detection flows (the tree-ensemble training task):
    bursty size×rate regions and a flag-pattern trigger, both axis-aligned.
    ``drift`` shifts the burst region to emulate traffic drift.

    Returns ``(X float32 (n, d), y int64 in {0, 1})``.
    """
    X = flow_features(rng, n, d)
    burst = (X[:, 0] > 0.55 + drift) & (X[:, 1 % d] < -0.1 + drift)
    flagged = (X[:, 2 % d] > 0.6) & (X[:, 3 % d] > 0.2)
    y = (burst | flagged).astype(np.int64)
    return X, y


def qos_dataset(rng: np.random.Generator, n: int, d: int = 8
                ) -> Tuple[np.ndarray, np.ndarray]:
    """QoS latency-regression flows: piecewise queueing-delay target (step
    congestion regimes + load slope) for the regression-forest family.

    Returns ``(X float32 (n, d), y float32 (n,))``.
    """
    X = flow_features(rng, n, d)
    congested = (X[:, 0] > 0.5).astype(np.float32)
    y = (0.2 + 0.6 * congested + 0.3 * np.maximum(X[:, 1 % d], 0)
         + 0.1 * (X[:, 2 % d] > 0.3))
    return X, y.astype(np.float32)
