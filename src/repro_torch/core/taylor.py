"""Taylor-series approximations of non-linear functions (paper §3.2–§3.3).

The data plane has no transcendental units, so the sigmoid (and the logs
inside the losses) become low-order Taylor polynomials whose *scaled
constants* are data-plane arguments (Tables 3 & 4).  Counterpart of
``repro.core.taylor``:

  * the published series (Table 3) and the other named series;
    :func:`taylor_coefficients` for any of the named functions (the exact
    derivative recurrence for the sigmoid, nested ``torch.autograd.grad``
    on a float32 scalar for the rest) and :func:`scaled_constants`, which
    truncates toward zero as the reference does (Table 4:
    ``[32768, 16384, 0, -1365, 0, 45]`` at order 5, ``s=16``);
  * float Horner (:func:`polyval`) and the integer Horner of the data plane
    (:func:`polyval_fixed`: int32 multiplies and rounding shifts only, what
    ``kernels.taylor_activation`` runs on the card);
  * the named Taylor activations, segmented Taylor (a range-match table of
    per-segment expansions), ``taylor_softmax`` and the second-order
    attention feature map;
  * the piecewise-linear units of §3.3.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .fixedpoint import _rounding_shift_right, true_divide

__all__ = [
    "taylor_coefficients",
    "polyval",
    "polyval_fixed",
    "sigmoid_taylor",
    "sigmoid_taylor_fixed",
    "scaled_constants",
    "exp_taylor",
    "tanh_taylor",
    "gelu_taylor",
    "silu_taylor",
    "softplus_taylor",
    "log1p_taylor",
    "segmented_coefficients",
    "segmented_taylor",
    "taylor_softmax",
    "taylor_attention_kernel",
    "relu",
    "leaky_relu",
    "prelu",
    "hard_sigmoid",
]

#: σ(x) ≈ 0.5 + x/4 − x³/48 + x⁵/1440 … — the paper's Table 3, verbatim.
#: The true quintic coefficient is 1/480; the published table (and its
#: scaled constant 45 = ⌊65536/1440⌋) uses 1/1440, and so does the
#: reference, so the port keeps it.  ``exact=True`` gives the true series.
_SIGMOID_SERIES = (0.5, 0.25, 0.0, -1.0 / 48.0, 0.0, 1.0 / 1440.0, 0.0,
                   -17.0 / 80640.0)

_NAMED_SERIES: Dict[str, Sequence[float]] = {
    "sigmoid": _SIGMOID_SERIES,
    "exp": [1.0, 1.0, 1.0 / 2, 1.0 / 6, 1.0 / 24, 1.0 / 120, 1.0 / 720,
            1.0 / 5040],
    "tanh": [0.0, 1.0, 0.0, -1.0 / 3, 0.0, 2.0 / 15, 0.0, -17.0 / 315],
    # log(1+x) — used by the Table-5 loss expansions
    "log1p": [0.0, 1.0, -1.0 / 2, 1.0 / 3, -1.0 / 4, 1.0 / 5, -1.0 / 6,
              1.0 / 7],
    "softplus": [float(np.log(2.0)), 0.5, 0.125, 0.0, -1.0 / 192.0, 0.0,
                 1.0 / 2880.0, 0.0],
}

_REFERENCE_FNS: Dict[str, Callable] = {
    "sigmoid": torch.sigmoid,
    "exp": torch.exp,
    "tanh": torch.tanh,
    "log1p": torch.log1p,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
}


@lru_cache(maxsize=None)
def _sigmoid_derivative_polys(order: int) -> tuple:
    """σ's k-th derivatives as polynomials in s = σ(x) (ascending coeffs).

    Recurrence: ds/dx = s(1−s); if f = Σ aⱼ sʲ then f' = Σ aⱼ·j·(sʲ − sʲ⁺¹).
    """
    polys = [np.asarray([0.0, 1.0])]  # f0 = s
    for _ in range(order):
        a = polys[-1]
        nxt = np.zeros(len(a) + 1)
        for j, aj in enumerate(a):
            if aj:
                nxt[j] += aj * j
                nxt[j + 1] -= aj * j
        polys.append(nxt)
    return tuple(tuple(p) for p in polys)


def _autodiff_coefficients(fn: Callable, order: int, center: float) -> tuple:
    """``f^(k)(center) / k!`` for k ≤ ``order`` by nested autograd on a
    float32 scalar (the reference nests ``jax.jacfwd``)."""
    x = torch.tensor(center, dtype=torch.float32, requires_grad=True)
    d = fn(x)
    coeffs, fact = [float(d.detach())], 1.0
    for k in range(1, order + 1):
        fact *= k
        # a derivative that no longer depends on x has zero derivatives
        d = (torch.autograd.grad(d, x, create_graph=True, allow_unused=True)[0]
             if d is not None and d.requires_grad else None)
        coeffs.append(0.0 if d is None else float(d.detach()) / fact)
    return tuple(coeffs)


@lru_cache(maxsize=None)
def taylor_coefficients(name: str, order: int, center: float = 0.0,
                        exact: bool = False) -> tuple:
    """Ascending Taylor coefficients of ``name`` around ``center`` up to
    ``order``: the closed-form series at center 0 where there is one
    (unless ``exact``), the exact derivative recurrence for the sigmoid,
    and nested autograd on a float32 scalar for the other functions."""
    if (not exact and center == 0.0 and name in _NAMED_SERIES
            and order < len(_NAMED_SERIES[name])):
        return tuple(float(c) for c in _NAMED_SERIES[name][: order + 1])
    if name == "sigmoid":
        s = 1.0 / (1.0 + np.exp(-float(center)))
        coeffs, fact = [], 1.0
        for k, poly in enumerate(_sigmoid_derivative_polys(order)):
            coeffs.append(sum(a * s ** j for j, a in enumerate(poly)) / fact)
            fact *= k + 1
        return tuple(float(c) for c in coeffs)
    return _autodiff_coefficients(_REFERENCE_FNS[name], order, float(center))


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------


def polyval(coeffs: Sequence[float], x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of an ascending-coefficient polynomial (float)."""
    acc = torch.full_like(x, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def polyval_fixed(coeffs_q, coeff_frac: int, x_q: torch.Tensor,
                  x_frac: int) -> torch.Tensor:
    """Integer Horner: int32 multiplies (wrapping) and rounding arithmetic
    shifts only.  ``coeffs_q`` are the scaled constants (Table 4) with
    ``coeff_frac`` fractional bits, ``x_q`` carries ``x_frac``; the result
    carries ``coeff_frac``.  Callers clamp ``x_q``."""
    x_q = torch.as_tensor(x_q).to(torch.int32)
    coeffs = [int(c) for c in np.asarray(coeffs_q).reshape(-1).tolist()]
    acc = torch.full_like(x_q, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = _rounding_shift_right(acc * x_q, x_frac) + c
    return acc


def scaled_constants(name: str, order: int, s: int = 16, *,
                     center: float = 0.0) -> np.ndarray:
    """Fixed-point codes of the Taylor constants at scale ``2**s`` (Table 4),
    truncated toward zero to stay bit-faithful to the published table."""
    coeffs = taylor_coefficients(name, order, center)
    return np.asarray([int(c * (2 ** s)) for c in coeffs], dtype=np.int64)


# ---------------------------------------------------------------------------
# Named activations
# ---------------------------------------------------------------------------


def sigmoid_taylor(x: torch.Tensor, order: int = 3) -> torch.Tensor:
    """Paper Table 3: σ(x) ≈ 0.5 + x/4 [− x³/48 [+ x⁵/1440]]."""
    return polyval(taylor_coefficients("sigmoid", order), x)


def sigmoid_taylor_fixed(x_q: torch.Tensor, x_frac: int, order: int = 3,
                         s: int = 16) -> torch.Tensor:
    """Integer-only sigmoid (Table 3 × Table 4): codes at frac ``s``."""
    return polyval_fixed(scaled_constants("sigmoid", order, s), s, x_q, x_frac)


def exp_taylor(x: torch.Tensor, order: int = 5) -> torch.Tensor:
    return polyval(taylor_coefficients("exp", order), x)


def tanh_taylor(x: torch.Tensor, order: int = 5) -> torch.Tensor:
    return polyval(taylor_coefficients("tanh", order), x)


def silu_taylor(x: torch.Tensor, order: int = 3) -> torch.Tensor:
    """SiLU(x) = x·σ(x) with the paper's sigmoid polynomial inside."""
    return x * sigmoid_taylor(x, order)


def gelu_taylor(x: torch.Tensor, order: int = 3) -> torch.Tensor:
    """GELU via its sigmoid form GELU(x) ≈ x·σ(1.702x), sigmoid Taylor-ized."""
    return x * sigmoid_taylor(1.702 * x, order)


def softplus_taylor(x: torch.Tensor, order: int = 4) -> torch.Tensor:
    return polyval(taylor_coefficients("softplus", order), x)


def log1p_taylor(x: torch.Tensor, order: int = 3) -> torch.Tensor:
    return polyval(taylor_coefficients("log1p", order), x)


# ---------------------------------------------------------------------------
# Segmented Taylor — range-match table lookup
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def segmented_coefficients(name: str, order: int, lo: float, hi: float,
                           n_segments: int) -> tuple:
    """Per-segment Taylor tables (the P4 "range match → action data"
    pattern): ``[lo, hi]`` cut into ``n_segments`` equal cells, each with
    the expansion around its midpoint.  Returns ``(centers, table)`` as
    tuples of shape ``(n,)`` and ``(n, order+1)``."""
    centers = np.linspace(lo, hi, n_segments * 2 + 1)[1::2]  # cell midpoints
    table = np.stack([
        np.asarray(taylor_coefficients(name, order, float(c)), np.float64)
        for c in centers
    ])
    return (tuple(centers.tolist()), tuple(map(tuple, table.tolist())))


def segmented_taylor(x: torch.Tensor, name: str, order: int = 3, *,
                     lo: float = -8.0, hi: float = 8.0,
                     n_segments: int = 16) -> torch.Tensor:
    """Evaluate ``name`` by gathering the matching segment's Taylor row."""
    centers_t, table_t = segmented_coefficients(name, order, lo, hi,
                                                n_segments)
    centers = torch.tensor(centers_t, dtype=torch.float32, device=x.device)
    table = torch.tensor(table_t, dtype=torch.float32, device=x.device)
    xc = torch.clamp(x, lo, hi - 1e-6)
    idx = torch.floor(true_divide(xc - lo, hi - lo) * n_segments).to(
        torch.int64)
    idx = torch.clamp(idx, 0, n_segments - 1)
    coeffs = table[idx]  # (..., order+1)
    dx = x - centers[idx]
    acc = coeffs[..., -1]
    for k in range(order - 1, -1, -1):
        acc = acc * dx + coeffs[..., k]
    return acc


# ---------------------------------------------------------------------------
# Taylor softmax / linear attention feature map
# ---------------------------------------------------------------------------


def taylor_softmax(x: torch.Tensor, order: int = 2,
                   axis: int = -1) -> torch.Tensor:
    """Softmax with exp replaced by its truncated Taylor polynomial,
    floored at 1e-6 (order 2 is positive everywhere: no max-subtraction)."""
    num = torch.clamp_min(polyval(taylor_coefficients("exp", order), x), 1e-6)
    return num / torch.sum(num, dim=axis, keepdim=True)


def taylor_attention_kernel(q: torch.Tensor, k: torch.Tensor):
    """2nd-order Taylor feature map φ with φ(q)·φ(k) = 1 + q·k + (q·k)²/2:
    ``(..., d)`` → ``(..., 1 + d + d²)`` as ``[1, x, vec(x⊗x)/√2]``."""
    def feat(x):
        *batch, d = x.shape
        ones = torch.ones((*batch, 1), dtype=x.dtype, device=x.device)
        outer = true_divide(torch.einsum("...i,...j->...ij", x, x),
                            math.sqrt(2.0))
        return torch.cat([ones, x, outer.reshape(*batch, d * d)], dim=-1)

    return feat(q), feat(k)


# ---------------------------------------------------------------------------
# Piecewise-linear units (paper §3.3)
# ---------------------------------------------------------------------------


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU(x) = max(0, x) — single conditional, trivially P4-expressible."""
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * x)


def prelu(x: torch.Tensor, alpha) -> torch.Tensor:
    """Parametric ReLU — α is a learnable (control-plane-table) parameter."""
    return torch.where(x > 0, x, alpha * x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear sigmoid: clip(0.5 + x/4, 0, 1) — the paper's 1st-order
    Taylor made total by clamping."""
    return torch.clamp(0.5 + 0.25 * x, 0.0, 1.0)
