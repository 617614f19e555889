"""The parts of the card kernels' redesign that run on the CPU, against the
JAX reference where it has a counterpart:

  * the W8A8 weight codes' K-major layout (``core.quantize.k_major``) from
    ``quantize_tree``, ``QuantizedLinear``, ``WeightRegistry.install`` and
    ``params_from_numpy``: the reference's codes and scales, value for
    value, with strides (…, 1, K);
  * ``w8a8_matmul_int`` and the GEMM wrapper on the CPU: the same bits for
    row-major and K-major codes;
  * the GEMM wrapper's pure-Python planner (``fixedpoint_matmul.plan``):
    the split it picks at the paths' shapes, and the zero codes it appends
    to a K that TMA cannot take;
  * the WKV kernel's two-phase decomposition, mirrored in plain PyTorch
    (``ref.wkv_scan_two_phase_ref``), against ``wkv_scan_ref`` and the JAX
    oracle within 2e-5 (the reference's kernel tolerance);
  * the flow kernel's decomposition into links and update
    (``ref.flow_update_two_phase_ref``) against the JAX package's per-packet
    oracle ``flow_update_numpy`` (the Pallas flow kernel does not run on the
    installed JAX) and the port's ``flow_update_ref``, bit for bit;
  * the MLP kernel's decomposition (``ref.fused_mlp_warp_ref``) against the
    reference's gather form and its Pallas kernel in interpret mode, bit for
    bit, in both weight lanes, with slots outside ``[0, M)``;
  * the range kernel's decomposition (packets grouped by forest in
    ``ref.forest_blocks``, per-forest staging, the half-warp AND split:
    ``ref.forest_range_grouped_ref``) against the reference's scalar oracle
    ``forest_traverse_numpy``, the port's gather and masked forms and, at
    small extents, the Pallas range kernel in interpret mode, bit for bit
    (the chase's plain versions beside it on the same tables); and the
    wrapper's pure-Python launch plan (``forest_traversal.plan``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ref import wkv_scan_ref as jwkv_scan_ref
from repro_torch.core import quantize as tq
from repro_torch.core.control_plane import WeightRegistry
from repro_torch.core.taylor import scaled_constants
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import params_from_numpy

from repro_torch.forest.synthetic import (random_forest_tables,
                                          rejected_tables, stack_ranges)
from repro_torch.kernels import forest_traversal as ftk

fmm = importlib.import_module("repro_torch.kernels.fixedpoint_matmul")
fmlp = importlib.import_module("repro_torch.kernels.fixedpoint_mlp")

torch.set_num_threads(1)

H100_SMS = 132


def _data(seed, *shape, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * np.float32(scale)


def _k_major(t: torch.Tensor) -> bool:
    return t.transpose(-1, -2).is_contiguous()


# ---------------------------------------------------------------------------
# K-major weight codes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8), (16, 8), (8, 1), (3, 8, 4),
                                   (2, 3, 5, 7)])
def test_k_major_keeps_values_and_sets_strides(shape):
    codes = torch.as_tensor(np.random.default_rng(1).integers(
        -128, 128, shape).astype(np.int8))
    got = tq.k_major(codes)
    assert got.shape == codes.shape and torch.equal(got, codes)
    assert _k_major(got)
    assert tq.k_major(got) is got  # already K-major: no copy


def _tree(seed):
    r = np.random.default_rng(seed)

    def f(*s):
        return r.normal(size=s).astype(np.float32)

    return {"attn": {"wq": {"w": f(16, 8), "b": f(8)}, "wo": {"w": f(8, 16)}},
            "blocks": {"mlp": {"w_up": f(3, 16, 32), "w_down": f(3, 32, 16)}},
            "norm": {"scale": f(16)}}


def _pairs(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_pairs(v, f"{path}/{k}"))
        return out
    return {path: tree} if isinstance(tree, tuple) else {}


def test_quantize_tree_codes_are_k_major_and_match_reference():
    params = _tree(3)
    want = _pairs(jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray,
                                                          params)))
    got = _pairs(tq.quantize_tree(jax.tree_util.tree_map(torch.as_tensor,
                                                         params)))
    assert sorted(got) == sorted(want) and len(got) == 4
    for path, (codes, scale) in got.items():
        wc, ws = want[path]
        assert _k_major(codes), path
        np.testing.assert_array_equal(codes.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(ws))
        assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    # a stacked leaf's layers stay K-major when sliced, as the model slices
    codes = got["/blocks/mlp/w_up"][0]
    assert codes.shape == (3, 16, 32) and _k_major(codes[1])


@pytest.mark.parametrize("din,dout", [(32, 12), (48, 1), (16, 64)])
def test_quantized_linear_codes_are_k_major_and_match_reference(din, dout):
    w, x = _data(20, din, dout), _data(21, 5, din)
    want = jq.QuantizedLinear(jnp.asarray(w))
    got = tq.QuantizedLinear(w, device="cpu")
    assert _k_major(got.codes)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got(torch.as_tensor(x)).numpy(),
                                  np.asarray(want(jnp.asarray(x))))


def test_weight_registry_and_params_from_numpy_store_k_major_codes():
    params = _tree(4)
    jtree = jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, params))
    want = _pairs(jtree)
    # the reference's tree as numpy: row-major codes, made K-major on entry
    loaded = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                               "cpu")
    row_major = {k: (torch.as_tensor(np.array(c)), torch.as_tensor(
        np.array(s))) for k, (c, s) in want.items()}
    assert all(c.is_contiguous() and not _k_major(c)
               for c, _ in row_major.values())
    reg = WeightRegistry()
    reg.install("rows", {"leaves": row_major, "norm": loaded["norm"]})
    installed = reg.get("rows")
    for tree in (_pairs(loaded), installed["leaves"]):
        for path, (codes, scale) in tree.items():
            key = path if path in want else path.split("/")[-1]
            wc, ws = want[key]
            assert _k_major(codes), path
            np.testing.assert_array_equal(codes.numpy(), np.asarray(wc))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(ws))
    assert installed["norm"]["scale"] is loaded["norm"]["scale"]
    # float leaves are never taken for pairs
    reg.install("floats", {"p": (torch.ones(4, 4), torch.ones(4))})
    p = reg.get("floats")["p"]
    assert p[0].is_contiguous() and torch.equal(p[0], torch.ones(4, 4))


# ---------------------------------------------------------------------------
# the GEMM on the CPU: both layouts, same bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,k,n", [((7, 33), 33, 5), ((2, 5, 64), 64, 48),
                                       ((64,), 64, 7), ((1, 1, 200), 200, 1)])
def test_w8a8_matmul_int_same_bits_for_both_layouts(shape, k, n):
    x, w = _data(30, *shape), _data(31, k, n)
    jcodes, jscale = jq.absmax_quantize(jnp.asarray(w), axis=0)
    want = np.asarray(jq.w8a8_matmul_int(jnp.asarray(x), jcodes, jscale))
    codes = torch.as_tensor(np.asarray(jcodes))
    scale = torch.as_tensor(np.asarray(jscale))
    xt = torch.as_tensor(x)
    for layout in (codes, tq.k_major(codes)):
        got = tq.w8a8_matmul_int(xt, layout, scale)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(17, 96, 33), (1, 512, 7), (100, 300, 50)])
def test_fixedpoint_matmul_wrapper_takes_both_layouts_on_cpu(m, k, n):
    rng = np.random.default_rng(m + k + n)
    xc = torch.as_tensor(rng.integers(-128, 128, (m, k)).astype(np.int8))
    wc = torch.as_tensor(rng.integers(-128, 128, (k, n)).astype(np.int8))
    xs = torch.as_tensor(rng.uniform(0.01, 1, (m, 1)).astype(np.float32))
    ws = torch.as_tensor(rng.uniform(0.01, 1, (1, n)).astype(np.float32))
    want = tref.fixedpoint_matmul_ref(xc, wc, xs, ws)
    before = dict(fmm.launches), dict(fmm.relayouts)
    for layout in (wc, tq.k_major(wc)):
        assert torch.equal(fmm.fixedpoint_matmul(xc, layout, xs, ws), want)
        assert torch.equal(ops.fixedpoint_matmul(xc, layout, xs, ws), want)
    # the plain version launches nothing and copies no layout
    assert (dict(fmm.launches), dict(fmm.relayouts)) == before
    with pytest.raises(ValueError, match="device"):
        fmm.run_split(xc, wc, xs, ws, 1)


# ---------------------------------------------------------------------------
# the GEMM's planner at the paths' shapes
# ---------------------------------------------------------------------------

# (M, K, N) → split on an H100's 132 SMs: the qwen2-1.5b layer's
# projections on 2048 tokens and at decode (M = 1, 17: split-K only where K
# is long and the tiles few), the rwkv6-3b quantized prefill's projections
# on 4 × 2048 tokens, a small grid with a long K, and shapes whose K the
# wrapper pads to a multiple of 16 (K % 16 != 0, K = 0)
PLANS = [
    ((2048, 1536, 8960), 1),   # up, gate
    ((2048, 8960, 1536), 1),   # down
    ((2048, 1536, 1536), 1),   # wq, wo
    ((2048, 1536, 256), 1),    # wk, wv
    ((17, 1536, 8960), 1),
    ((1, 1536, 8960), 1),
    ((1, 8960, 1536), 4),
    ((17, 8960, 1536), 4),
    ((64, 8960, 1536), 4),
    ((8192, 2560, 2560), 1),
    ((8192, 2560, 8960), 1),
    ((8192, 8960, 2560), 1),
    ((255, 8960, 129), 4),
    ((100, 300, 50), 1),
    ((1, 512, 7), 1),
    ((5, 0, 7), 1),
    ((257, 513, 129), 1),
    ((1, 8190, 1536), 4),      # padded to 8192: 64 K steps
    ((1, 8064, 1536), 1),      # 63 K steps
    ((33, 8960, 1536), 4),     # 12 tiles × 4 = 48 ≤ 132 SMs
    ((1, 8960, 4480), 1),      # 35 tiles × 4 = 140 > 132 SMs
]


@pytest.mark.parametrize("mkn,want", PLANS)
def test_gemm_planner_picks_the_documented_design(mkn, want):
    m, k, n = mkn
    assert fmm.plan(m, n, k, H100_SMS) == want


@pytest.mark.parametrize("k", [0, 1, 33, 300, 513, 1536, 8960])
def test_gemm_wrapper_pads_k_to_a_multiple_of_16_with_zero_codes(k):
    """The wgmma design's operands (``_tma_operands``): K padded with zero
    codes, w K-major, the int32 sums unchanged; each copy counted."""
    rng = np.random.default_rng(k)
    for layout in ("row_major", "k_major"):
        xc = torch.as_tensor(rng.integers(-128, 128, (9, k)).astype(np.int8))
        wc = torch.as_tensor(rng.integers(-128, 128, (k, 5)).astype(np.int8))
        w = tq.k_major(wc) if layout == "k_major" else wc
        before = fmm.relayouts["fixedpoint_matmul"]
        xp, wp = fmm._tma_operands(xc, w)
        kp = max(16, -(-k // 16) * 16)
        assert xp.shape == (9, kp) and wp.shape == (kp, 5)
        assert xp.is_contiguous() and _k_major(wp)
        assert torch.equal(xp[:, :k], xc) and torch.equal(wp[:k], wc)
        assert not xp[:, k:].any() and not wp[k:].any()
        assert torch.equal(tref.int32_matmul(xp, wp), tref.int32_matmul(xc,
                                                                        wc))
        copies = 2 if kp != k else int(layout == "row_major")
        assert fmm.relayouts["fixedpoint_matmul"] == before + copies
        if kp == k and layout == "k_major":
            assert xp is xc and wp is w  # nothing to copy
        fmm.relayouts["fixedpoint_matmul"] = before


def test_gemm_wrapper_copies_unaligned_operands():
    """An operand that does not start on a 16-byte boundary (TMA's) is copied
    to one that does, values unchanged; an aligned one is taken as it is."""
    rng = np.random.default_rng(2)
    store = torch.as_tensor(rng.integers(-128, 128, 9 * 32 + 1).astype(np.int8))
    xc = store[1:].view(9, 32)
    wc = tq.k_major(torch.as_tensor(rng.integers(-128, 128, (32, 5)).astype(
        np.int8)))
    assert xc.data_ptr() % 16 and not wc.data_ptr() % 16
    before = fmm.relayouts["fixedpoint_matmul"]
    xp, wp = fmm._tma_operands(xc, wc)
    assert fmm.relayouts["fixedpoint_matmul"] == before + 1
    assert not xp.data_ptr() % 16 and torch.equal(xp, xc) and wp is wc
    fmm.relayouts["fixedpoint_matmul"] = before


@pytest.mark.parametrize("num_sms", [1, 16, 132])
def test_gemm_planner_never_leaves_a_slice_of_k_empty(num_sms):
    rng = np.random.default_rng(num_sms)
    for _ in range(200):
        m, n = (int(v) for v in rng.integers(1, 4096, 2))
        k = int(rng.integers(0, 20000))
        split = fmm.plan(m, n, k, num_sms)
        nk = -(-max(k, 1) // fmm.TILE)
        kper = -(-nk // split)
        assert split in (1, fmm.SPLIT)
        assert (split - 1) * kper < nk  # the last slice has K steps


# ---------------------------------------------------------------------------
# the WKV kernel's two-phase decomposition
# ---------------------------------------------------------------------------


def _wkv_operands(rng, bh, nc, c, d):
    return (rng.normal(size=(bh, nc, c, d)).astype(np.float32) * 0.4,
            rng.normal(size=(bh, nc, c, d)).astype(np.float32) * 0.4,
            rng.normal(size=(bh, nc, c, d)).astype(np.float32),
            rng.uniform(0.2, 0.95, size=(bh, nc, 1, d)).astype(np.float32),
            rng.normal(size=(bh, nc, c, 1)).astype(np.float32) * 0.2)


@pytest.mark.parametrize("bh,nc,c,d", [(2, 4, 64, 64), (1, 8, 128, 64),
                                       (4, 2, 64, 32), (2, 3, 37, 48),
                                       (3, 2, 200, 17), (1, 2, 1, 64),
                                       (2, 1, 256, 16), (0, 2, 16, 8)])
def test_wkv_two_phase_decomposition_matches_plain_and_reference(bh, nc, c,
                                                                  d):
    args = _wkv_operands(np.random.default_rng(bh * 100 + c + d), bh, nc, c,
                         d)
    got = tref.wkv_scan_two_phase_ref(*map(torch.as_tensor, args))
    want = tref.wkv_scan_ref(*map(torch.as_tensor, args))
    assert got.shape == want.shape == (bh, nc, c, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    if bh:
        jwant = np.asarray(jwkv_scan_ref(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got.numpy(), jwant, rtol=2e-5, atol=2e-5)


def test_wkv_two_phase_decomposition_carries_state():
    a, b, v, tot, diag = map(torch.as_tensor, _wkv_operands(
        np.random.default_rng(5), 1, 3, 64, 32))
    base = tref.wkv_scan_two_phase_ref(a, b, v, tot, diag)
    b2 = b.clone()
    b2[:, 0] = 0.0
    moved = tref.wkv_scan_two_phase_ref(a, b2, v, tot, diag)
    assert float((base[:, 1:] - moved[:, 1:]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the flow kernel's links-then-update decomposition
# ---------------------------------------------------------------------------

FLOW_KW = dict(frac=8, ewma_shift=3, byte_shift=6, dur_shift=10)


def _flow_case(rng, n, n_slots, cms_shape, case):
    """``chip_smoke.py``'s flow batches at a small size: a random
    pre-populated state and a batch shaped by ``case``."""
    depth, width_c = cms_shape
    state = np.zeros((n_slots, 8), np.int32)
    pre = int(rng.integers(0, n_slots + 1))
    state[:pre] = rng.integers(0, 5000, (pre, 8))
    state[:pre, 0] = rng.integers(0, 5, pre)
    cms = rng.integers(0, 100, cms_shape).astype(np.int32)
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    cells = rng.integers(0, width_c, (n, depth)).astype(np.int32)
    ts = np.cumsum(rng.integers(0, 100, n)).astype(np.int32)
    length = rng.integers(0, 2000, n).astype(np.int32)
    live = np.ones(n, np.int32)
    if case == "one_flow":
        slots[:] = int(rng.integers(0, n_slots))
    elif case == "distinct":
        slots = rng.permutation(n_slots)[:n].astype(np.int32)
    elif case == "dead":
        live = (rng.random(n) > 0.15).astype(np.int32)
    elif case == "dead_interleaved":
        live[1::2] = 0
    elif case == "one_cell":
        cells[:] = cells[0]
    elif case == "non_monotone":
        ts = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    elif case == "saturation":
        code_max = tref.FLOW_CODE_MAX
        state[:] = [code_max - 1, code_max - 1, 0, 0, code_max, code_max, 1,
                    code_max >> FLOW_KW["frac"]]
        cms[:] = code_max
        ts[:] = 2 ** 31 - 1
        length[:] = 65535
    return state, cms, slots, cells, ts, length, live


@pytest.mark.parametrize("case", ["random", "one_flow", "distinct", "dead",
                                  "dead_interleaved", "one_cell",
                                  "non_monotone", "saturation"])
@pytest.mark.parametrize("n,n_slots,cms_shape", [(37, 64, (2, 32)),
                                                 (130, 256, (3, 8))])
def test_flow_two_phase_decomposition_matches_oracle_and_plain(case, n,
                                                               n_slots,
                                                               cms_shape):
    args = _flow_case(np.random.default_rng(n + len(case)), n, n_slots,
                      cms_shape, case)
    want = jref.flow_update_numpy(*args, **FLOW_KW)
    targs = [torch.as_tensor(a) for a in args]
    got = tref.flow_update_two_phase_ref(*targs, **FLOW_KW)
    plain = tref.flow_update_ref(*targs, **FLOW_KW)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(p.numpy(), w)
    # the inputs are not modified
    for a, t in zip(args, targs):
        np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# the MLP kernel's decomposition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["int16", "int8"])
@pytest.mark.parametrize("width", [1, 31, 32, 33])
def test_mlp_warp_decomposition_matches_reference_and_pallas(variant, width):
    """Every opcode, a layer switched off in the middle, accumulators that
    wrap, and slots outside [0, M) (which the Pallas kernel's masked form
    returns as the lane-clamped input; the gather form takes valid slots)."""
    rng = np.random.default_rng(width)
    n_batch, n_models, n_layers = 40, 3, 4
    w_dtype = np.int8 if variant == "int8" else np.int16
    info = np.iinfo(w_dtype)
    w = rng.integers(info.min, info.max, (n_models, n_layers, width, width),
                     endpoint=True).astype(w_dtype)
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, (n_models, n_layers, width),
                     endpoint=True).astype(np.int32)
    x = rng.integers(-2 ** 30, 2 ** 30, (n_batch, width)).astype(np.int32)
    act = np.asarray([[0, 1, 2, 3], [4, 7, 2, 1], [3, 2, 0, 4]], np.int32)
    on = np.ones((n_models, n_layers), np.int32)
    on[:, 1:3] = [[0, 1], [1, 0], [0, 0]]
    slot = rng.integers(0, n_models, n_batch).astype(np.int32)
    slot[:6] = [n_models, -1, 999, n_models, -7, 2 ** 20]
    kw = dict(frac=8, leaky_alpha_q=3, sig_coeffs=tuple(
        int(c) for c in scaled_constants("sigmoid", 3, 8)))
    lane = 8 if variant == "int8" else None
    got = tref.fused_mlp_warp_ref(
        *map(torch.as_tensor, (x, slot, w, b, act, on)), lane_bits=lane,
        **kw).numpy()
    pallas = np.asarray(jops.fused_mlp(
        *map(jnp.asarray, (x, slot, w, b, act, on)), backend="pallas",
        variant=variant, **kw))
    np.testing.assert_array_equal(got, pallas)
    gather = np.asarray(jref.fused_mlp_gather_ref(
        *map(jnp.asarray, (x, slot, w, b, act, on)), lane_bits=lane, **kw))
    valid = (slot >= 0) & (slot < n_models)
    np.testing.assert_array_equal(got[valid], gather[valid])
    lo, hi = (-128, 127) if variant == "int8" else (-2 ** 31, 2 ** 31 - 1)
    np.testing.assert_array_equal(got[~valid], np.clip(x[~valid], lo, hi))
    # the port's wrapper on the CPU (the gather form) agrees on valid slots
    tc = {k: torch.as_tensor(v[valid] if k in ("x_q", "slot") else v)
          for k, v in dict(x_q=x, slot=slot, w=w, b=b, act=act,
                           layer_on=on).items()}
    np.testing.assert_array_equal(
        fmlp.fixedpoint_mlp(**tc, variant=variant, **kw).numpy(),
        got[valid])


# ---------------------------------------------------------------------------
# the forest kernels' decomposition: grouped by forest, staged, lane split
# ---------------------------------------------------------------------------

FOREST_FRAC = 8
# NI (range entries) → the tree depth and node count that need that many
NI_TREES = {1: (1, 3), 7: (3, 15), 31: (5, 63)}


def _forest_case(seed, n_forests, n_trees, ni, width=16, n_batch=48):
    rng = np.random.default_rng(seed)
    depth, n_nodes = NI_TREES[ni]
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    ranges = stack_ranges(nodes, tree_on, depth, n_entries=ni, n_leaves=8)
    x = rng.integers(-1000, 1000, (n_batch, width)).astype(np.int32)
    x[rng.random(n_batch) < 0.1] = np.iinfo(np.int32).max
    slot = rng.integers(0, n_forests, n_batch).astype(np.int32)
    return rng, depth, x, slot, nodes, tree_on, mode, ranges


def _grouped(x, slot, tree_on, mode, ranges, chunk=16):
    t = [torch.as_tensor(np.ascontiguousarray(a))
         for a in (x, slot, tree_on, mode, *ranges)]
    return tref.forest_range_grouped_ref(*t[:2], *t[4:], *t[2:4],
                                         frac=FOREST_FRAC, chunk=chunk)


def _masked(x, slot, nodes, tree_on, mode, ranges, depth):
    t = [torch.as_tensor(np.ascontiguousarray(a))
         for a in (x, slot, nodes, tree_on, mode)]
    rt = tuple(torch.as_tensor(a) for a in ranges)
    return {v: ops.forest_traverse(*t, max_depth=depth, frac=FOREST_FRAC,
                                   backend="ref", variant=v, ranges=rt)
            for v in ("chase", "range")}


def _pallas(x, slot, nodes, tree_on, mode, ranges, depth,
            variants=("chase", "range")):
    args = [jnp.asarray(a) for a in (x, slot, nodes, tree_on, mode)]
    u32 = ranges[:2] + (ranges[2].view(np.uint32),) + ranges[3:]
    return {v: np.asarray(jops.forest_traverse(
        *args, max_depth=depth, frac=FOREST_FRAC, backend="pallas",
        variant=v, ranges=u32 if v == "range" else None))
        for v in variants}


@pytest.mark.parametrize("slots", ["uniform", "one_forest"])
@pytest.mark.parametrize("ni", [1, 7, 31])
@pytest.mark.parametrize("n_trees", [1, 15, 16, 17, 33])
def test_forest_grouped_decomposition_matches_oracle_and_plain(n_trees, ni,
                                                              slots):
    """The range lane split changes at T = 16 (two lanes per tree) and
    T = 32 (trees in steps of 32); NI = 31 is the compiled-in serving
    extent.  The chase's plain versions are held to the oracle beside it."""
    _, depth, x, slot, nodes, tree_on, mode, ranges = _forest_case(
        n_trees * 10 + ni, 3, n_trees, ni)
    if slots == "one_forest":
        slot[:] = 2
    want = jref.forest_traverse_numpy(x, slot, nodes, tree_on, mode,
                                      max_depth=depth, frac=FOREST_FRAC)
    got = _grouped(x, slot, tree_on, mode, ranges)
    masked = _masked(x, slot, nodes, tree_on, mode, ranges, depth)
    t = [torch.as_tensor(a) for a in (x, slot, nodes, tree_on, mode)]
    gather = {
        "chase": tref.forest_traverse_gather_ref(
            *t, max_depth=depth, frac=FOREST_FRAC),
        "range": tref.forest_range_gather_ref(
            *t[:2], *(torch.as_tensor(a) for a in ranges), *t[3:],
            frac=FOREST_FRAC)}
    np.testing.assert_array_equal(got.numpy(), want)
    for v in ("chase", "range"):
        np.testing.assert_array_equal(masked[v].numpy(), want, err_msg=v)
        np.testing.assert_array_equal(gather[v].numpy(), want, err_msg=v)


@pytest.mark.parametrize("n_trees,ni,slots", [
    (1, 7, "uniform"), (15, 1, "one_forest"), (16, 7, "uniform"),
    (17, 1, "uniform"), (16, 7, "one_forest")])
def test_forest_grouped_decomposition_matches_pallas(n_trees, ni, slots):
    """At small extents, against the Pallas range kernel (interpret mode)
    on the same inputs."""
    _, depth, x, slot, nodes, tree_on, mode, ranges = _forest_case(
        n_trees + ni, 2, n_trees, ni, n_batch=40)
    if slots == "one_forest":
        slot[:] = 0
    got = _grouped(x, slot, tree_on, mode, ranges, chunk=16)
    want = _pallas(x, slot, nodes, tree_on, mode, ranges, depth, ("range",))
    np.testing.assert_array_equal(got.numpy(), want["range"])


@pytest.mark.parametrize("n_trees", [1, 15, 16, 17, 33])
def test_forest_grouped_decomposition_on_rejected_tables(n_trees):
    """Tables install_forest rejects and slots outside [0, F): the masked
    forms define the result (all-zero records, x = 0 for a feature outside
    [0, W), classify leaves that vote nowhere, zero rows)."""
    rng = np.random.default_rng(n_trees)
    n_forests, width, depth, n_nodes = 3, 16, 4, 16
    nodes, tree_on, mode, ranges = rejected_tables(
        rng, n_forests, n_trees, n_nodes, width, depth, 7, 8)
    x = rng.integers(-600, 600, (60, width)).astype(np.int32)
    slot = rng.integers(-2, n_forests + 3, 60).astype(np.int32)
    slot[:3] = [-(2 ** 31), 2 ** 31 - 1, n_forests]
    got = _grouped(x, slot, tree_on, mode, ranges, chunk=8).numpy()
    want = _masked(x, slot, nodes, tree_on, mode, ranges, depth)
    outside = (slot < 0) | (slot >= n_forests)
    np.testing.assert_array_equal(got, want["range"].numpy())
    assert not got[outside].any()
    if n_trees <= 16:  # the Pallas kernels at the small extents
        pallas = _pallas(x, slot, nodes, tree_on, mode, ranges, depth)
        np.testing.assert_array_equal(got, pallas["range"])
        np.testing.assert_array_equal(want["chase"].numpy(), pallas["chase"])


@pytest.mark.parametrize("n_batch,n_forests,chunk", [
    (0, 3, 16), (1, 3, 16), (37, 1, 8), (200, 4, 16), (200, 4, 1),
    (257, 9, 32), (5, 9, 16)])
def test_forest_blocks_cover_every_packet_once_in_bin_order(n_batch,
                                                           n_forests, chunk):
    rng = np.random.default_rng(n_batch + chunk)
    slot = torch.as_tensor(rng.integers(-2, n_forests + 2, n_batch)
                           .astype(np.int32))
    blocks = tref.forest_blocks(slot, n_forests, chunk)
    seen = torch.cat([idx for _, idx in blocks]) if blocks else \
        torch.zeros(0, dtype=torch.int64)
    assert sorted(seen.tolist()) == list(range(n_batch))
    bins = [b for b, _ in blocks]
    assert bins == sorted(bins)
    for b, idx in blocks:
        assert 1 <= len(idx) <= chunk and bool((idx[1:] > idx[:-1]).all())
        s = slot[idx].to(torch.int64)
        if b == n_forests:
            assert bool(((s < 0) | (s >= n_forests)).all())
        else:
            assert bool((s == b).all())
    grid = -(-n_batch // chunk) + min(n_forests + 1, n_batch)
    assert len(blocks) <= grid


# (B, T, NI, L) → the range plan on an H100's 132 SMs: 16 packets a block
# up to B = 2112, then the next power of two, at most 4096; tables staged
# up to 96 KB
FOREST_PLANS = [
    ((2048, 16, 31, 32), (16, True)),     # the serving extents
    ((2112, 16, 31, 32), (16, True)),
    ((2113, 16, 31, 32), (32, True)),
    ((4099, 16, 31, 32), (32, True)),
    ((1, 16, 31, 32), (16, True)),
    ((4225, 16, 31, 32), (64, True)),
    ((8448, 16, 31, 32), (64, True)),
    ((8449, 16, 31, 32), (128, True)),
    ((33_792, 16, 31, 32), (256, True)),
    ((200_000, 16, 31, 32), (2048, True)),
    ((1_000_000, 16, 31, 32), (4096, True)),
    ((2048, 1, 1, 1), (16, True)),
    ((2048, 64, 31, 32), (16, True)),     # 62.5 KB
    ((2048, 96, 31, 32), (16, True)),     # 93.8 KB
    ((2048, 128, 31, 32), (16, False)),   # 125 KB
    ((2048, 16, 255, 32), (16, False)),   # 102 KB
]


@pytest.mark.parametrize("args,want", FOREST_PLANS)
def test_forest_plan_from_sizes(args, want):
    assert tuple(ftk.plan(*args, num_sms=H100_SMS)) == want


def test_forest_stage_bytes_match_the_kernel_layout():
    """At the serving extents: 3 copied (16, 31) tables + the (16, 32)
    payload + 496 16-byte records + tree_on; each copy padded to 16 bytes."""
    assert ftk.stage_bytes(16, 31, 32) == 4 * (16 + 3 * 496 + 512 + 4 * 496)
    assert ftk.stage_bytes(3, 5, 7) == 4 * (4 + 3 * 16 + 24 + 4 * 15)


def test_forest_wrapper_cpu_route_launches_nothing():
    _, depth, x, slot, nodes, tree_on, mode, ranges = _forest_case(5, 3, 16,
                                                                   7)
    t = [torch.as_tensor(a) for a in (x, slot, nodes, tree_on, mode)]
    rt = [torch.as_tensor(a) for a in ranges]
    before = dict(ftk.launches)
    got = {"chase": ftk.forest_traverse(*t, max_depth=depth,
                                        frac=FOREST_FRAC),
           "range": ftk.forest_range(*t[:2], *rt, *t[3:], frac=FOREST_FRAC)}
    assert ftk.launches == before
    assert torch.equal(got["range"], _grouped(x, slot, tree_on, mode, ranges))
    assert torch.equal(got["chase"], tref.forest_traverse_gather_ref(
        *t, max_depth=depth, frac=FOREST_FRAC))
