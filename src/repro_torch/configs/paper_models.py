"""The paper's own model family: small regression / MLP nets that ride in
packets (QoS prediction, anomaly detection — paper §1, §4).

These are what the Fig-1/3/4 reproductions run.  Architectures are not given
numerically in the paper, so we fix representative instances and sweep the
paper's hyperparameters (fractional bits, Taylor order) around them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["PAPER_MODELS", "make_paper_model", "train_qos_regressor"]

# name → (layer dims, hidden activation)
PAPER_MODELS: Dict[str, Tuple[List[int], str]] = {
    # linear QoS regressor: flow stats → predicted latency class
    "qos_linear": ([8, 1], "none"),
    # 2-layer sigmoid MLP: the paper's canonical neural net
    "qos_mlp": ([8, 16, 1], "sigmoid"),
    # anomaly-detection classifier head (binary)
    "anomaly_mlp": ([16, 32, 8, 1], "relu"),
}


def make_paper_model(name: str, rng: np.random.Generator,
                     weight_scale: float = 0.5):
    """Random-init instance of a paper model: [(W, b), ...], activations."""
    dims, act = PAPER_MODELS[name]
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = rng.normal(size=(din, dout)).astype(np.float32)
        w *= weight_scale / np.sqrt(din)
        b = rng.normal(size=(dout,)).astype(np.float32) * 0.1
        layers.append((w, b))
    acts = [act] * (len(layers) - 1)
    return layers, acts


def train_qos_regressor(rng: np.random.Generator, n_samples: int = 2048,
                        name: str = "qos_mlp", epochs: int = 200,
                        lr: float = 0.05):
    """Train a paper-scale model on synthetic QoS data (pure numpy GD).

    Synthetic task: predict normalized queue latency from flow features —
    a smooth nonlinear target, matching the paper's "regression tasks like
    QoS prediction".  Returns (layers, activations, (X, y)).
    """
    dims, act = PAPER_MODELS[name]
    d_in = dims[0]
    X = rng.normal(size=(n_samples, d_in)).astype(np.float32)
    w_true = rng.normal(size=(d_in,)).astype(np.float32)
    y = np.tanh(X @ w_true * 0.5) * 0.8 + 0.1 * np.sin(X[:, 0])
    y = y[:, None].astype(np.float32)

    layers, acts = make_paper_model(name, rng)
    names = acts + ["none"]

    def act_fn(z, a):
        if a == "sigmoid":
            return 1 / (1 + np.exp(-z))
        if a == "relu":
            return np.maximum(z, 0)
        return z

    def act_grad(z, a):
        if a == "sigmoid":
            s = 1 / (1 + np.exp(-z))
            return s * (1 - s)
        if a == "relu":
            return (z > 0).astype(z.dtype)
        return np.ones_like(z)

    def forward(ls, x):
        h, cache = x, []
        for (w, b), a in zip(ls, names):
            z = h @ w + b
            cache.append((h, z, a))
            h = act_fn(z, a)
        return h, cache

    for _ in range(epochs):
        pred, cache = forward(layers, X)
        dz = 2 * (pred - y) / len(X)  # final layer is linear ⇒ dz = dh
        grads = []
        for (w, b), (h_in, z, a) in zip(reversed(layers), reversed(cache)):
            dz = dz * act_grad(z, a)
            grads.append((h_in.T @ dz, dz.sum(0)))
            dz = dz @ w.T
        layers = [(w - lr * gw, b - lr * gb)
                  for (w, b), (gw, gb) in zip(layers, reversed(grads))]
    pred, _ = forward(layers, X)
    return layers, acts, (X, y, pred)
