"""The port's numeric core against the JAX reference, bit for bit:
fixed-point encode/decode (including the saturating casts PyTorch does not
do by itself), the rounding shift and requantize, and the Taylor constants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import fixedpoint as jfp
from repro.core import taylor as jtaylor
from repro_torch.core import fixedpoint as tfp
from repro_torch.core import taylor as ttaylor

torch.set_num_threads(1)


@pytest.mark.parametrize("value,s,total_bits", [
    (1e6, 16, 32),              # clips to float32(2**31 - 1) == 2**31
    (2.0 ** 31, 0, 32),
    (-2.0 ** 31 - 1e3, 0, 32),
    (3e9, 0, 32),
    (-3e9, 0, 32),
    (float("inf"), 8, 32),
    (float("-inf"), 8, 16),
    (float("nan"), 8, 32),
    (40000.0, 0, 16),
    (-40000.0, 0, 16),
    (200.0, 0, 8),
    (0.5, 0, 8),
    (-0.5, 0, 8),
    (2.5, 1, 8),
    (-1.375, 2, 8),
])
def test_encode_saturation_cases(value, s, total_bits):
    want = np.asarray(jfp.encode(value, s, total_bits=total_bits))
    got = tfp.encode(value, s, total_bits=total_bits).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total_bits,s", [(8, 4), (8, 8), (16, 8), (16, 12),
                                          (32, 16), (32, 24)])
def test_encode_decode_arrays_match(total_bits, s):
    rng = np.random.default_rng(total_bits * 100 + s)
    w = np.concatenate([rng.normal(size=500) * 4.0,
                        rng.normal(size=100) * 1e6,
                        (np.arange(-20, 21) + 0.5) / (1 << s)]).astype(np.float64)
    for b in (0, 3):
        want = np.asarray(jfp.encode(w, s, b, total_bits=total_bits))
        got = tfp.encode(w, s, b, total_bits=total_bits).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tfp.decode(torch.as_tensor(got), s, b).numpy(),
            np.asarray(jfp.decode(want, s, b)))


@settings(database=None, deadline=None, max_examples=60)
@given(w=st.floats(-1e4, 1e4, allow_nan=False, allow_infinity=False),
       s=st.integers(0, 16), b=st.integers(-4, 4))
def test_encode_property_bit_exact_and_bounded(w, s, b):
    """Equal to the reference for any input, and within half an LSB of
    float32(w) when the code does not saturate (the reference rounds the
    float32 product, so the bound is against float32(w), not w)."""
    want = np.asarray(jfp.encode(w, s, b, total_bits=32))
    got = tfp.encode(w, s, b, total_bits=32).numpy()
    np.testing.assert_array_equal(got, want)
    w32 = float(np.float32(w))
    if abs(w32 * 2.0 ** s) < 2 ** 30:
        back = float(tfp.decode(torch.as_tensor(got), s, b))
        assert abs(back - w32) <= 0.5 / 2 ** s + abs(w32) * 2 ** -23


@pytest.mark.parametrize("shift", [-2, 0, 1, 4, 8, 16, 30])
def test_rounding_shift_right_matches(shift):
    rng = np.random.default_rng(shift + 7)
    x = np.concatenate([rng.integers(-2 ** 31, 2 ** 31 - 1, 300),
                        [-2 ** 31, 2 ** 31 - 1, -1, 0, 1, -3, 3]]).astype(np.int32)
    want = np.asarray(jfp._rounding_shift_right(jnp.asarray(x), shift))
    got = tfp._rounding_shift_right(torch.as_tensor(x), shift).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("from_frac,to_frac,total_bits", [(16, 8, 16),
                                                          (16, 8, 8),
                                                          (24, 8, 32)])
def test_requantize_matches(from_frac, to_frac, total_bits):
    rng = np.random.default_rng(from_frac + total_bits)
    acc = rng.integers(-2 ** 31, 2 ** 31 - 1, 400).astype(np.int32)
    jf = jfp.FixedPointFormat(total_bits=total_bits, frac_bits=to_frac)
    tf = tfp.FixedPointFormat(total_bits=total_bits, frac_bits=to_frac)
    want = np.asarray(jfp.requantize(jnp.asarray(acc), from_frac, to_frac, jf))
    got = tfp.requantize(torch.as_tensor(acc), from_frac, to_frac, tf).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("s", [8, 16])
def test_scaled_constants_match(order, s):
    np.testing.assert_array_equal(
        ttaylor.scaled_constants("sigmoid", order, s),
        jtaylor.scaled_constants("sigmoid", order, s))


def test_scaled_constants_table4_and_centered():
    np.testing.assert_array_equal(
        ttaylor.scaled_constants("sigmoid", 5, 16),
        [32768, 16384, 0, -1365, 0, 45])
    np.testing.assert_array_equal(
        ttaylor.scaled_constants("sigmoid", 3, 12, center=1.5),
        jtaylor.scaled_constants("sigmoid", 3, 12, center=1.5))
    assert (ttaylor.taylor_coefficients("sigmoid", 5, exact=True)
            == jtaylor.taylor_coefficients("sigmoid", 5, exact=True))
