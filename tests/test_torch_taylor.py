"""The port's C2 surface — the integer Taylor activation, the fixed-point and
float Taylor evaluators, the Taylor coefficients and the Table-5 losses —
against the JAX reference on the CPU.  The same seeded numpy inputs go
through both packages.  Integer results are bit-exact (including the
Pallas kernel in interpret mode); coefficients from the closed-form series
and the sigmoid recurrence are exact, the autodiff-derived ones agree to
``rtol=1e-4, atol=1e-7`` (the two frameworks differentiate float32 code
differently; the largest relative gap measured is 3.4e-5); the float
evaluators and losses to ``rtol=1e-6``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro.core import taylor as jt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.taylor_activation import taylor_activation_pallas
from repro_torch.core import losses as tl
from repro_torch.core import taylor as tt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

CLAMP = (1 << 14) - 1


def _t(a):
    return torch.as_tensor(np.array(a))


def _codes(seed, shape, lo=-2 ** 15, hi=2 ** 15):
    """int32 codes that straddle the kernel's ±(2**14 - 1) clamp."""
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the integer Taylor activation (the kernel's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 3, 5, 7])
@pytest.mark.parametrize("x_frac", [0, 8, 12, 16])
@pytest.mark.parametrize("s", [12, 16])
def test_taylor_activation_matches_reference(order, x_frac, s):
    coeffs = jt.scaled_constants("sigmoid", order, s)
    x = _codes(order * 100 + x_frac + s, (37, 41))
    want = jops.taylor_activation(jnp.asarray(x), coeffs, x_frac,
                                  backend="ref")
    for backend in ("auto", "ref"):
        got = tops.taylor_activation(_t(x), coeffs, x_frac, backend=backend)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xc = np.clip(x, -CLAMP, CLAMP)
    np.testing.assert_array_equal(
        tref.taylor_activation_ref(_t(xc), coeffs, x_frac).numpy(),
        np.asarray(jref.taylor_activation_ref(jnp.asarray(xc), coeffs,
                                              x_frac)))


@pytest.mark.parametrize("order", [1, 3, 5])
def test_taylor_activation_matches_pallas_interpret(order):
    """One (256, 512) tile of the Pallas kernel, in interpret mode."""
    frac = 12
    coeffs = jt.scaled_constants("sigmoid", order, frac)
    x = _codes(order, (256, 512), -3 * 2 ** frac, 3 * 2 ** frac)
    x[0, :8] = [CLAMP, CLAMP + 1, -CLAMP, -CLAMP - 1, 2 ** 31 - 1, -2 ** 31,
                0, -1]
    want = taylor_activation_pallas(jnp.asarray(x), tuple(map(int, coeffs)),
                                    frac, interpret=True)
    got = tops.taylor_activation(_t(x), coeffs, frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(1,), (17,), (3, 5, 7), (0, 4)])
def test_taylor_activation_any_shape(shape):
    coeffs = jt.scaled_constants("sigmoid", 3, 10)
    x = _codes(len(shape), shape)
    got = tops.taylor_activation(_t(x), coeffs, 10)
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.taylor_activation(jnp.asarray(x), coeffs, 10, backend="ref")))


def test_taylor_activation_wraps_as_the_reference():
    """exp constants at s=16 on codes at 8 fractional bits: the Horner
    products pass 2**31, and both packages wrap them the same way."""
    coeffs = jt.scaled_constants("exp", 5, 16)
    x = np.arange(-20000, 20001, dtype=np.int32)
    got = tops.taylor_activation(_t(x), coeffs, 8).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jops.taylor_activation(jnp.asarray(x), coeffs, 8, backend="ref")))
    wide = np.full(x.shape, int(coeffs[-1]), np.int64)
    xc = np.clip(x, -CLAMP, CLAMP).astype(np.int64)
    for c in coeffs[-2::-1]:
        p = wide * xc
        wide = ((p + np.where(p >= 0, 128, 127)) >> 8) + int(c)
    assert (wide != got).any()  # the int64 chain differs: int32 wrapped


@pytest.mark.parametrize("coeffs", [[2 ** 31, 1], [-2 ** 31 - 1, 5, 1],
                                    [2 ** 33, 0, 1]])
def test_taylor_activation_rejects_constants_outside_int32(coeffs):
    x = np.zeros(4, np.int32)
    with pytest.raises(OverflowError):
        jops.taylor_activation(jnp.asarray(x), coeffs, 8, backend="ref")
    with pytest.raises(OverflowError):
        tops.taylor_activation(_t(x), coeffs, 8)


def test_top_constant_outside_int32_raises_where_the_reference_wraps():
    """The reference fills the top constant with ``jnp.full(..., int32)``,
    which wraps 2**31 to -2**31, while every other constant goes through
    ``jnp.int32(c)``, which raises (ROADMAP §3, R5).  The port raises on
    any constant outside int32."""
    x = np.arange(-3, 4, dtype=np.int32)
    wrapped = jops.taylor_activation(jnp.asarray(x), [1, 2 ** 31], 8,
                                     backend="ref")
    np.testing.assert_array_equal(np.asarray(wrapped), np.asarray(
        jops.taylor_activation(jnp.asarray(x), [1, -2 ** 31], 8,
                               backend="ref")))
    with pytest.raises(OverflowError):
        tops.taylor_activation(_t(x), [1, 2 ** 31], 8)


# ---------------------------------------------------------------------------
# fixed-point Horner and Taylor constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,order,s", [("sigmoid", 5, 16),
                                          ("sigmoid", 3, 12), ("exp", 4, 14),
                                          ("tanh", 5, 16), ("log1p", 3, 12)])
@pytest.mark.parametrize("x_frac", [0, 6, 12])
def test_polyval_fixed_matches(name, order, s, x_frac):
    coeffs = jt.scaled_constants(name, order, s)
    np.testing.assert_array_equal(tt.scaled_constants(name, order, s), coeffs)
    x = _codes(order + x_frac, (300,), -2 ** 14, 2 ** 14)
    np.testing.assert_array_equal(
        tt.polyval_fixed(coeffs, s, _t(x), x_frac).numpy(),
        np.asarray(jt.polyval_fixed(coeffs, s, jnp.asarray(x), x_frac)))


@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("x_frac,s", [(12, 12), (8, 16), (16, 16)])
def test_sigmoid_taylor_fixed_matches(order, x_frac, s):
    x = _codes(order * x_frac, (257,), -4 << x_frac, 4 << x_frac)
    np.testing.assert_array_equal(
        tt.sigmoid_taylor_fixed(_t(x), x_frac, order, s=s).numpy(),
        np.asarray(jt.sigmoid_taylor_fixed(jnp.asarray(x), x_frac, order,
                                           s=s)))


@pytest.mark.parametrize("name", ["sigmoid", "exp", "tanh", "log1p",
                                  "softplus"])
@pytest.mark.parametrize("order", [1, 3, 5, 7])
def test_named_series_exact(name, order):
    assert (tt.taylor_coefficients(name, order)
            == jt.taylor_coefficients(name, order))


@pytest.mark.parametrize("center", [0.0, -3.5, 1.25, 6.0])
@pytest.mark.parametrize("order", [3, 5, 9])
def test_sigmoid_recurrence_exact(center, order):
    assert (tt.taylor_coefficients("sigmoid", order, center, exact=True)
            == jt.taylor_coefficients("sigmoid", order, center, exact=True))
    np.testing.assert_array_equal(
        tt.scaled_constants("sigmoid", order, 16, center=center),
        jt.scaled_constants("sigmoid", order, 16, center=center))


@pytest.mark.parametrize("name", ["gelu", "silu", "tanh", "softplus", "exp",
                                  "log1p"])
@pytest.mark.parametrize("center", [-3.5, 0.75])
def test_autodiff_coefficients_close(name, center):
    if name == "log1p" and center < -1:
        center = -0.5  # log1p is defined above -1 only
    want = jt.taylor_coefficients(name, 5, center)
    got = tt.taylor_coefficients(name, 5, center)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_autodiff_coefficients_at_zero_close(name):
    """gelu and silu have no closed-form series: at center 0 they go
    through autograd too (their zero odd derivatives included)."""
    np.testing.assert_allclose(tt.taylor_coefficients(name, 5),
                               jt.taylor_coefficients(name, 5),
                               rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# float evaluators, segmented Taylor, softmax, attention map, losses
# ---------------------------------------------------------------------------


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)


_FLOAT_FNS = [
    ("sigmoid_taylor", (1,)), ("sigmoid_taylor", (3,)),
    ("sigmoid_taylor", (5,)), ("exp_taylor", ()), ("tanh_taylor", ()),
    ("silu_taylor", ()), ("gelu_taylor", ()), ("softplus_taylor", ()),
    ("log1p_taylor", ()), ("relu", ()), ("leaky_relu", ()),
    ("leaky_relu", (0.2,)), ("hard_sigmoid", ()),
]


@pytest.mark.parametrize("fn,args", _FLOAT_FNS)
def test_float_evaluators_match(fn, args):
    x = np.linspace(-3, 3, 301).astype(np.float32)
    _close(getattr(tt, fn)(_t(x), *args),
           getattr(jt, fn)(jnp.asarray(x), *args))


def test_polyval_and_prelu_match():
    x = np.linspace(-2, 2, 101).astype(np.float32)
    coeffs = [0.5, -1.25, 0.0, 0.375, 2.0]
    _close(tt.polyval(coeffs, _t(x)), jt.polyval(coeffs, jnp.asarray(x)))
    alpha = np.linspace(0, 0.5, 101).astype(np.float32)
    _close(tt.prelu(_t(x), _t(alpha)),
           jt.prelu(jnp.asarray(x), jnp.asarray(alpha)))


@pytest.mark.parametrize("name,order,n_seg", [("sigmoid", 3, 16),
                                              ("sigmoid", 2, 7),
                                              ("exp", 3, 8)])
def test_segmented_taylor_matches(name, order, n_seg):
    lo, hi = -8.0, 8.0
    c_t, tab_t = tt.segmented_coefficients(name, order, lo, hi, n_seg)
    c_j, tab_j = jt.segmented_coefficients(name, order, lo, hi, n_seg)
    assert c_t == c_j
    np.testing.assert_allclose(tab_t, tab_j, rtol=1e-6)
    x = np.linspace(-10, 10, 401).astype(np.float32)
    _close(tt.segmented_taylor(_t(x), name, order, n_segments=n_seg),
           jt.segmented_taylor(jnp.asarray(x), name, order, n_segments=n_seg))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("axis", [-1, 0])
def test_taylor_softmax_matches(order, axis):
    x = np.random.default_rng(order).normal(size=(6, 9)).astype(np.float32)
    _close(tt.taylor_softmax(_t(x), order, axis=axis),
           jt.taylor_softmax(jnp.asarray(x), order, axis=axis))


def test_taylor_attention_kernel_matches():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 5, 4)).astype(np.float32)
    k = rng.normal(size=(2, 7, 4)).astype(np.float32)
    got = tt.taylor_attention_kernel(_t(q), _t(k))
    want = jt.taylor_attention_kernel(jnp.asarray(q), jnp.asarray(k))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def _probs(seed, shape):
    p = np.random.default_rng(seed).random(shape).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("loss", ["mse", "bce", "bce_taylor", "cce",
                                  "cce_taylor", "normalized_mse"])
def test_table5_losses_match(loss):
    rng = np.random.default_rng(len(loss))
    y_hat = _probs(1, (8, 5))
    if loss.startswith("cce"):
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    elif loss.startswith("bce"):
        y = rng.integers(0, 2, (8, 5)).astype(np.float32)
    else:
        y = rng.normal(size=(8, 5)).astype(np.float32)
    _close(getattr(tl, loss)(_t(y), _t(y_hat)),
           getattr(jl, loss)(jnp.asarray(y), jnp.asarray(y_hat)))


def test_log_taylor3_matches():
    p = np.linspace(0.01, 1.0, 50).astype(np.float32)
    _close(tl.log_taylor3(_t(p)), jl.log_taylor3(jnp.asarray(p)))
