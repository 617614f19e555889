"""Taylor coefficients of the sigmoid and their fixed-point constants
(paper §3.2, Tables 3–4).

The data plane has no transcendental units, so the sigmoid is a low-order
Taylor polynomial whose *scaled constants* are data-plane arguments.  This is
the serving path's subset of ``repro.core.taylor``, in numpy: the published
series (Table 3), the exact derivative recurrence for other centers, and
:func:`scaled_constants`, which truncates toward zero exactly as the
reference does (Table 4: ``[32768, 16384, 0, -1365, 0, 45]`` at order 5,
``s=16``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["taylor_coefficients", "scaled_constants"]

#: σ(x) ≈ 0.5 + x/4 − x³/48 + x⁵/1440 … — the paper's Table 3, verbatim.
#: The true quintic coefficient is 1/480; the published table (and its
#: scaled constant 45 = ⌊65536/1440⌋) uses 1/1440, and so does the
#: reference, so the port keeps it.
_SIGMOID_SERIES = (0.5, 0.25, 0.0, -1.0 / 48.0, 0.0, 1.0 / 1440.0, 0.0,
                   -17.0 / 80640.0)


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


@lru_cache(maxsize=None)
def taylor_coefficients(name: str, order: int, center: float = 0.0,
                        exact: bool = False) -> tuple:
    """Ascending Taylor coefficients of the sigmoid around ``center`` up to
    ``order``: the published series at center 0, else (or with
    ``exact=True``) the exact derivative recurrence.  Other functions are
    not on the serving path and raise ``NotImplementedError``."""
    if name != "sigmoid":
        raise NotImplementedError(
            f"Taylor coefficients of {name!r} are not part of the serving path")
    if not exact and center == 0.0 and order < len(_SIGMOID_SERIES):
        return tuple(float(c) for c in _SIGMOID_SERIES[: order + 1])
    s = 1.0 / (1.0 + np.exp(-float(center)))
    coeffs, fact = [], 1.0
    for k, poly in enumerate(_sigmoid_derivative_polys(order)):
        coeffs.append(sum(a * s ** j for j, a in enumerate(poly)) / fact)
        fact *= k + 1
    return tuple(float(c) for c in coeffs)


def scaled_constants(name: str, order: int, s: int = 16, *,
                     center: float = 0.0) -> np.ndarray:
    """Fixed-point codes of the Taylor constants at scale ``2**s`` (Table 4),
    truncated toward zero to stay bit-faithful to the published table."""
    coeffs = taylor_coefficients(name, order, center)
    return np.asarray([int(c * (2 ** s)) for c in coeffs], dtype=np.int64)
