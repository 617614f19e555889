"""The fused multi-model MLP's plain versions against the JAX reference, bit
for bit: the masked-GEMM form and the gather form, both weight lanes,
including accumulators that wrap, every opcode and an invalid one, and gaps
in layer_on — held against ``repro.kernels.ref`` and against the Pallas
kernel itself (interpret mode).  Also the MLP half of ``serve_lanes``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fixedpoint_mlp as tfmlp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_serve import LaneConfig, serve_lanes
from repro_torch.core.control_plane import (forest_tables_from_numpy,
                                           tables_from_numpy)
from repro_torch.core.taylor import scaled_constants

torch.set_num_threads(1)

FRAC = 8


def _case(seed, *, n_batch, n_models, n_layers, width, variant, wrap):
    """Control-plane-layout tables and codes.  ``wrap`` puts codes near
    ±2**30 and full-range int32 biases in, so int32 accumulators overflow."""
    rng = np.random.default_rng(seed)
    w_dtype = np.int8 if variant == "int8" else np.int16
    if wrap:
        info = np.iinfo(w_dtype)
        w = rng.integers(info.min, info.max, (n_models, n_layers, width,
                                              width), endpoint=True)
        b = rng.integers(-2 ** 31, 2 ** 31 - 1, (n_models, n_layers, width))
        x = rng.integers(-2 ** 30, 2 ** 30, (n_batch, width))
    else:
        w = rng.integers(-300, 300, (n_models, n_layers, width, width))
        w = np.clip(w, -128, 127) if variant == "int8" else w
        b = rng.integers(-2 ** 20, 2 ** 20, (n_models, n_layers, width))
        x = rng.integers(-3000, 3000, (n_batch, width))
    act = rng.choice([0, 1, 2, 3, 4, 7], (n_models, n_layers))
    on = (rng.random((n_models, n_layers)) < 0.75).astype(np.int32)
    slot = rng.integers(0, n_models, n_batch)
    return dict(x=x.astype(np.int32), slot=slot.astype(np.int32),
                w=w.astype(w_dtype), b=b.astype(np.int32),
                act=act.astype(np.int32), layer_on=on)


def _kw(order=3):
    return dict(frac=FRAC, sig_coeffs=tuple(
        int(c) for c in scaled_constants("sigmoid", order, FRAC)),
        leaky_alpha_q=3)


def _layer_major(c):
    m, l, w, _ = c["w"].shape
    return (np.transpose(c["w"], (1, 0, 2, 3)).astype(np.int32).reshape(
                l, m * w, w),
            np.transpose(c["b"], (1, 0, 2)),
            np.transpose(c["act"], (1, 0))[:, :, None],
            np.transpose(c["layer_on"], (1, 0))[:, :, None])


def _t(c):
    return {k: torch.as_tensor(v) for k, v in c.items()}


CASES = [
    # (seed, batch, models, layers, width, order, wrap)
    (0, 300, 4, 3, 8, 3, False),
    (1, 300, 4, 3, 12, 5, False),
    (2, 300, 3, 2, 8, 1, True),
    (3, 257, 4, 3, 12, 3, True),
]


@pytest.mark.parametrize("variant", ["int16", "int8"])
@pytest.mark.parametrize("seed,n_batch,n_models,n_layers,width,order,wrap",
                         CASES)
def test_plain_versions_match_reference(variant, seed, n_batch, n_models,
                                        n_layers, width, order, wrap):
    c = _case(seed, n_batch=n_batch, n_models=n_models, n_layers=n_layers,
              width=width, variant=variant, wrap=wrap)
    kw = _kw(order)
    lane = 8 if variant == "int8" else None
    want = np.asarray(jref.fused_mlp_gather_ref(
        jnp.asarray(c["x"]), jnp.asarray(c["slot"]), jnp.asarray(c["w"]),
        jnp.asarray(c["b"]), jnp.asarray(c["act"]), jnp.asarray(c["layer_on"]),
        lane_bits=lane, **kw))
    wl, bl, al, onl = _layer_major(c)
    want_masked = np.asarray(jref.fused_mlp_ref(
        jnp.asarray(c["x"]), jnp.asarray(c["slot"])[:, None], jnp.asarray(wl),
        jnp.asarray(bl), jnp.asarray(al), jnp.asarray(onl), lane_bits=lane,
        **kw))
    np.testing.assert_array_equal(want, want_masked)
    tc = _t(c)
    got_gather = tref.fused_mlp_gather_ref(
        tc["x"], tc["slot"], tc["w"], tc["b"], tc["act"], tc["layer_on"],
        lane_bits=lane, **kw).numpy()
    got_masked = tref.fused_mlp_ref(
        tc["x"], tc["slot"][:, None], torch.as_tensor(wl), torch.as_tensor(bl),
        torch.as_tensor(al), torch.as_tensor(onl), lane_bits=lane,
        **kw).numpy()
    np.testing.assert_array_equal(got_gather, want)
    np.testing.assert_array_equal(got_masked, want)
    for backend in ("auto", "ref"):
        got = tops.fused_mlp(tc["x"], tc["slot"], tc["w"], tc["b"],
                             tc["act"], tc["layer_on"], backend=backend,
                             variant=variant, **kw).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["int16", "int8"])
def test_plain_version_matches_pallas_kernel(variant):
    """The TPU kernel itself (Pallas interpreter on the CPU), wrap case."""
    c = _case(11, n_batch=300, n_models=4, n_layers=3, width=8,
              variant=variant, wrap=True)
    kw = _kw(3)
    want = np.asarray(jops.fused_mlp(
        jnp.asarray(c["x"]), jnp.asarray(c["slot"]), jnp.asarray(c["w"]),
        jnp.asarray(c["b"]), jnp.asarray(c["act"]), jnp.asarray(c["layer_on"]),
        backend="pallas", variant=variant, **kw))
    tc = _t(c)
    got = tops.fused_mlp(tc["x"], tc["slot"], tc["w"], tc["b"], tc["act"],
                         tc["layer_on"], variant=variant, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_invalid_slot_returns_input_in_masked_form():
    """A slot outside [0, M) selects no model in the masked-GEMM form (the
    formulation the CUDA kernel reproduces): the row comes back as its
    lane-clamped input."""
    c = _case(5, n_batch=40, n_models=3, n_layers=2, width=8,
              variant="int8", wrap=True)
    c["slot"][:10] = 3
    wl, bl, al, onl = _layer_major(c)
    kw = _kw(3)
    want = np.asarray(jref.fused_mlp_ref(
        jnp.asarray(c["x"]), jnp.asarray(c["slot"])[:, None], jnp.asarray(wl),
        jnp.asarray(bl), jnp.asarray(al), jnp.asarray(onl), lane_bits=8, **kw))
    got = tref.fused_mlp_ref(
        torch.as_tensor(c["x"]), torch.as_tensor(c["slot"])[:, None],
        torch.as_tensor(wl), torch.as_tensor(bl), torch.as_tensor(al),
        torch.as_tensor(onl), lane_bits=8, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:10], np.clip(c["x"][:10], -128, 127))


@pytest.mark.parametrize("shift", [0, 1, 2, 8, 16])
def test_rounding_rshift_and_lane_clamp_match(shift):
    rng = np.random.default_rng(shift)
    x = np.concatenate([rng.integers(-2 ** 31, 2 ** 31 - 1, 200),
                        [-2 ** 31, 2 ** 31 - 1, -1, 1, -2, 2]]).astype(np.int32)
    np.testing.assert_array_equal(
        tref.rounding_rshift(torch.as_tensor(x), shift).numpy(),
        np.asarray(jref.rounding_rshift(jnp.asarray(x), shift)))
    for bits in (None, 8, 16):
        np.testing.assert_array_equal(
            tref.lane_clamp(torch.as_tensor(x), bits).numpy(),
            np.asarray(jref.lane_clamp(jnp.asarray(x), bits)))


@pytest.mark.parametrize("dispatch", ["fused", "gather"])
@pytest.mark.parametrize("variant", ["int16", "int8"])
def test_serve_lanes_matches_reference(dispatch, variant):
    """id_map lookup, valid masking, out_dim masking and zero rows for ids
    that are not installed, against repro's serve_lanes (both of its MLP
    dispatch forms)."""
    from repro.core.control_plane import ModelTables as JTables
    from repro.kernels.fused_serve import LaneConfig as JCfg
    from repro.kernels.fused_serve import serve_lanes as jserve
    c = _case(21, n_batch=300, n_models=4, n_layers=3, width=12,
              variant=variant, wrap=False)
    rng = np.random.default_rng(3)
    id_map = np.full(65536, -1, np.int32)
    id_map[[5, 9, 300, 65535]] = [0, 1, 2, 3]
    out_dim = np.asarray([12, 3, 1, 7], np.int32)
    mids = rng.choice([5, 9, 300, 65535, 0, 17], 300).astype(np.int32)
    kw = _kw(3)
    jt = JTables(w=jnp.asarray(c["w"]), b=jnp.asarray(c["b"]),
                 act=jnp.asarray(c["act"]), layer_on=jnp.asarray(c["layer_on"]),
                 out_dim=jnp.asarray(out_dim), id_map=jnp.asarray(id_map))
    for feat_w in (12, 16, 8):
        x0 = rng.integers(-3000, 3000, (300, feat_w)).astype(np.int32)
        jcfg = JCfg(frac=FRAC, sig_coeffs=kw["sig_coeffs"], leaky_alpha_q=3,
                    max_features=feat_w, max_tree_depth=1, dispatch=dispatch,
                    kernel_variant=variant)
        want = np.asarray(jserve(jnp.asarray(x0), jnp.asarray(mids), jt, None,
                                 None, jcfg, use_mlp=True, use_forest=False))
        tt = tables_from_numpy(c["w"], c["b"], c["act"], c["layer_on"],
                               out_dim, id_map)
        tcfg = LaneConfig(frac=FRAC, sig_coeffs=kw["sig_coeffs"],
                          leaky_alpha_q=3, max_features=feat_w,
                          kernel_variant=variant)
        got = serve_lanes(torch.as_tensor(x0), torch.as_tensor(mids), tt,
                          None, None, tcfg).numpy()
        np.testing.assert_array_equal(got, want)
    # with the forest lane on but no forest installed, every row keeps its
    # MLP-lane egress
    ft = forest_tables_from_numpy(np.zeros((1, 1, 1, 5), np.int32),
                                  np.zeros((1, 1), np.int32),
                                  np.zeros(1, np.int32), np.zeros(1, np.int32),
                                  np.full(65536, -1, np.int32))
    both = serve_lanes(torch.as_tensor(x0), torch.as_tensor(mids), tt, ft,
                       None, tcfg, use_forest=True).numpy()
    np.testing.assert_array_equal(both, want)


def test_kernel_wrapper_cpu_path_and_argument_checks():
    """On a CPU tensor the wrapper is its plain version and launches
    nothing; the kernel backend refuses CPU tensors; bad arguments raise."""
    c = _t(_case(8, n_batch=50, n_models=2, n_layers=2, width=8,
                 variant="int16", wrap=False))
    kw = _kw(3)
    before = dict(tfmlp.launches)
    got = tfmlp.fixedpoint_mlp(c["x"], c["slot"], c["w"], c["b"], c["act"],
                               c["layer_on"], **kw)
    want = tref.fused_mlp_gather_ref(c["x"], c["slot"], c["w"], c["b"],
                                     c["act"], c["layer_on"], **kw)
    assert torch.equal(got, want)
    assert tfmlp.launches == before
    with pytest.raises(ValueError, match="kernel"):
        tops.fused_mlp(c["x"], c["slot"], c["w"], c["b"], c["act"],
                       c["layer_on"], backend="kernel", **kw)
    with pytest.raises(ValueError):
        tops.fused_mlp(c["x"], c["slot"], c["w"], c["b"], c["act"],
                       c["layer_on"], backend="pallas", **kw)
    with pytest.raises(ValueError):
        tfmlp.fixedpoint_mlp(c["x"], c["slot"], c["w"], c["b"], c["act"],
                             c["layer_on"], variant="int4", **kw)
