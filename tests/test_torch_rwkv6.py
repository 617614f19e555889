"""The port's RWKV-6 slice against the JAX reference on the CPU: the layers
it calls, the WKV chunk scan's plain version (against the reference's
oracle and its Pallas kernel in interpret mode), both chunked-WKV routes,
and the whole model (forward, loss, prefill, decode, the LM server) with
the reference's own ``init`` carried across by ``params_from_numpy``.

Tolerances, each with its reason:

  * WKV plain version vs the reference's oracle and Pallas kernel: rtol =
    atol = 2e-5, the reference's own (``tests/test_wkv_kernel.py``).
  * The ``"scan"`` route vs the reference's ``_wkv_chunked``: rtol + atol
    3e-2, the reference's own for its kernel against its model
    (``tests/test_wkv_kernel.py:81-83``): the model rounds the chunk-GEMM
    operands to bf16, the kernel's form is float32 throughout.
  * The ``"scan"`` route vs the reference's own float32 kernel form (the
    operand prep of ``tests/test_wkv_kernel.py:62-79`` with
    ``_wkv_chunked``'s right-padding, then ``wkv_scan_ref``), alone and
    patched into the reference model in place of ``_wkv_chunked``: 2e-5
    relative to the largest output or logit.  Both are float32 throughout;
    XLA's and PyTorch's ``exp``, ``cumsum`` and products differ in the last
    bits (measured ≤ 2e-6 on the CPU).
  * The port's ``_wkv_chunked`` vs the reference's: 2e-3 relative to the
    largest output.  Both round the same operands to bf16, but the
    float32 values they round come from different ``exp`` and ``cumsum``
    code, so an operand may round to the neighbouring bf16 value.
  * Whole-model logits, ``dtype="float32"``: 1e-3 relative to the largest
    logit through ``"chunked"`` (the bf16 operand rounding above, carried
    through two layers), 3e-2 through ``"scan"``.  Decode steps, which
    have no bf16 rounding in float32: 1e-5.
  * ``dtype="bfloat16"`` (the configs' default): 5e-2 relative.  XLA's and
    PyTorch's bf16 matrix products round at other places, and every
    activation is bf16.
  * Decode against prefill in the port: 0.08 relative, the reference's
    rwkv6 tolerance (``tests/test_arch_smoke.py:139``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import quantize as jq
from repro.core.control_plane import WeightRegistry as JWeightRegistry
from repro.kernels.ref import wkv_scan_ref as jwkv_scan_ref
from repro.kernels.wkv_scan import wkv_scan_pallas
from repro.launch.serve import LMServer as JLMServer
from repro.models import layers as JL
from repro.models import rwkv6 as JR
from repro_torch.configs import get_config, reduced
from repro_torch.core import quantize as tq
from repro_torch.core.control_plane import WeightRegistry
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import LMServer
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import rwkv6 as TR

torch.set_num_threads(1)

T_SEQ = 37  # a non-multiple of every chunk: the last chunk is padded
F32_CHUNKED_TOL = 1e-3
SCAN_TOL = 3e-2
SCAN_F32_TOL = 2e-5
BF16_TOL = 5e-2


def _rel(got, want) -> float:
    got = np.asarray(got.float().detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _cfgs(**kw):
    """The same reduced rwkv6 config in both packages."""
    return (jreduced(jget_config("rwkv6-3b")).replace(remat=False, **kw),
            reduced(get_config("rwkv6-3b")).replace(remat=False, **kw))


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return JR.init(jax.random.key(0), jcfg)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(seed, b=2, t=T_SEQ, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _data(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["fp", "w8a8_sim", "w8a8_int", "tuple"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_reference(mode, dtype, bias):
    jcfg, tcfg = _cfgs(quant_mode="fp" if mode == "tuple" else mode,
                       dtype=dtype)
    x = _data(1, 3, 5, 64, scale=2.0)
    p = {"w": _data(2, 64, 48, scale=0.125)}
    if bias:
        p["b"] = _data(3, 48)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    jp = jax.tree.map(jnp.asarray, p)
    if mode == "tuple":
        jp = jq.quantize_tree(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = JL.linear(jp, jx, jcfg)
    got = TL.linear(tp, tx, tcfg)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    if dtype == "float32" and mode in ("w8a8_int", "tuple"):
        # the integer datapath and its float32 epilogue are bit-exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        tol = 1e-5 if dtype == "float32" else 1e-2
        assert _rel(got, want) < tol


@pytest.mark.parametrize("style", ["rmsnorm", "layernorm", "gemma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_reference(style, dtype):
    kw = dict(norm="layernorm") if style == "layernorm" else dict(
        gemma_style=style == "gemma")
    jcfg, tcfg = _cfgs(dtype=dtype, **kw)
    x = _data(4, 3, 7, 128, scale=3.0) + 0.5
    jp = JL.init_norm(jcfg)
    jp = {k: v + jnp.asarray(_data(5 + i, 128, scale=0.1))
          for i, (k, v) in enumerate(sorted(jp.items()))}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert set(TL.init_norm(tcfg)) == set(jp)
    want = JL.norm(jp, jnp.asarray(x).astype(jnp.dtype(dtype)), jcfg)
    got = TL.norm(tp, torch.as_tensor(x).to(getattr(torch, dtype)), tcfg)
    # float32: rsqrt and mean round differently in the last bits;
    # bf16: one bf16 step (2^-7 relative) at a rounding boundary
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["silu", "geglu", "gelu", "relu"])
@pytest.mark.parametrize("order,segmented", [(0, False), (3, False),
                                             (3, True), (5, False)])
def test_act_fn_matches_reference(kind, order, segmented):
    jcfg, tcfg = _cfgs(dtype="float32", activation=kind, taylor_order=order,
                       taylor_segmented=segmented)
    x = _data(6, 4, 200, scale=3.0)
    want = JL.act_fn(jnp.asarray(x), jcfg)
    got = TL.act_fn(torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


# ---------------------------------------------------------------------------
# the WKV chunk scan's plain version
# ---------------------------------------------------------------------------


def _wkv_operands(rng, bh, nc, c, d):
    """As the reference's test makes them: tot in [0.2, 0.95], so that a
    state scaled by columns instead of rows shows."""
    return (rng.normal(size=(bh, nc, c, d)).astype(np.float32) * 0.4,
            rng.normal(size=(bh, nc, c, d)).astype(np.float32) * 0.4,
            rng.normal(size=(bh, nc, c, d)).astype(np.float32),
            rng.uniform(0.2, 0.95, size=(bh, nc, 1, d)).astype(np.float32),
            rng.normal(size=(bh, nc, c, 1)).astype(np.float32) * 0.2)


@pytest.mark.parametrize("bh,nc,c,d", [(2, 4, 64, 64), (1, 8, 128, 64),
                                       (4, 2, 64, 32)])
def test_wkv_scan_ref_matches_reference_and_pallas(bh, nc, c, d):
    args = _wkv_operands(np.random.default_rng(bh * 100 + c), bh, nc, c, d)
    got = tref.wkv_scan_ref(*map(torch.as_tensor, args)).numpy()
    jargs = tuple(map(jnp.asarray, args))
    for want in (jwkv_scan_ref(*jargs),
                 wkv_scan_pallas(*jargs, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_wkv_scan_ref_carries_state_across_chunks():
    a, b, v, tot, diag = map(torch.as_tensor, _wkv_operands(
        np.random.default_rng(7), 1, 3, 64, 32))
    base = tref.wkv_scan_ref(a, b, v, tot, diag)
    b2 = b.clone()
    b2[:, 0] = 0.0  # chunk 0's keys no longer reach the state
    alt = tref.wkv_scan_ref(a, b2, v, tot, diag)
    assert float((base[:, 1:] - alt[:, 1:]).abs().max()) > 1e-4
    # tot scales the state's rows: with tot ≡ 1 the later chunks change
    ones = tref.wkv_scan_ref(a, b, v, torch.ones_like(tot), diag)
    assert float((base[:, 1:] - ones[:, 1:]).abs().max()) > 1e-3


def test_ops_wkv_scan_backends_on_cpu():
    args = tuple(map(torch.as_tensor, _wkv_operands(
        np.random.default_rng(8), 2, 3, 16, 8)))
    want = tref.wkv_scan_ref(*args)
    assert torch.equal(ops.wkv_scan(*args), want)
    assert torch.equal(ops.wkv_scan(*args, backend="ref"), want)
    with pytest.raises(ValueError, match="card"):
        ops.wkv_scan(*args, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        ops.wkv_scan(*args, backend="pallas")
    a, b, v, tot, diag = args
    with pytest.raises(ValueError, match="shape"):
        ops.wkv_scan(a, b, v, tot[..., :4], diag)
    wide = _wkv_operands(np.random.default_rng(9), 1, 1, 4, 65)
    with pytest.raises(ValueError, match="head dim"):
        ops.wkv_scan(*map(torch.as_tensor, wide))


def _wkv_inputs(seed, b, h, t, d, decay_hi):
    """Log-decays in [−decay_hi, −0.05].  Over a chunk of C tokens they
    should not sum below −30, where both chunked forms clamp (an
    underflow guard, not the recurrence): the reference's own tests keep
    −0.8 at C ≤ 64 and D ≤ 32; at D = 64 and C = 64 the case below keeps
    −0.3, near the model's own decays (−exp(−2) at init)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, t, d)).astype(np.float32) * 0.5,
            rng.normal(size=(b, h, t, d)).astype(np.float32) * 0.5,
            rng.normal(size=(b, h, t, d)).astype(np.float32),
            -rng.uniform(0.05, decay_hi, size=(b, h, t, d)).astype(np.float32),
            rng.normal(size=(h, d)).astype(np.float32) * 0.3)


WKV_CASES = [(1, 2, 128, 32, 64, 0.8),  # tests/test_wkv_kernel.py's geometry
             (1, 2, 37, 8, 16, 1.0),    # test_models_deep.py's: padded chunk
             (2, 2, 150, 64, 64, 0.3)]  # head dim 64, three chunks, padded


@pytest.mark.parametrize("b,h,t,d,chunk,decay_hi", WKV_CASES[:2])
def test_scan_route_matches_reference_chunked(b, h, t, d, chunk, decay_hi):
    args = _wkv_inputs(9, b, h, t, d, decay_hi)
    want = JR._wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    got = TR._wkv_scan(*map(torch.as_tensor, args), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2,
                               atol=3e-2)


def _jax_wkv_scan_f32(r, k, v, logw, u, chunk=64):
    """The reference's float32 kernel form of the chunked WKV: the operand
    prep of ``tests/test_wkv_kernel.py:62-79``, with ``_wkv_chunked``'s
    right-padding to a multiple of the chunk, then its oracle
    ``wkv_scan_ref``; a drop-in for ``repro.models.rwkv6._wkv_chunked``."""
    b, h, t, d = r.shape
    pad = (-t) % chunk
    nc = (t + pad) // chunk

    def split(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))).reshape(
            b, h, nc, chunk, d)

    def rows(x):
        return x.reshape(b * h, nc, *x.shape[3:])

    r_, k_, v_, lw = split(r), split(k), split(v), split(logw)
    cum = jnp.maximum(jnp.cumsum(lw, axis=-2), -30.0)
    cum_prev = cum - lw
    diag = (r_ * (u[None, :, None, None, :] * k_)).sum(-1)[..., None]
    o = jwkv_scan_ref(rows(r_ * jnp.exp(cum_prev)), rows(k_ * jnp.exp(-cum)),
                      rows(v_), rows(jnp.exp(cum[..., -1:, :])), rows(diag))
    return o.reshape(b, h, nc * chunk, d)[:, :, :t]


@pytest.fixture
def jax_kernel_form(monkeypatch):
    """The reference model with its kernel's float32 form in place of the
    bf16 ``_wkv_chunked`` (prefill, forward and loss call it by name)."""
    monkeypatch.setattr(JR, "_wkv_chunked", _jax_wkv_scan_f32)


@pytest.mark.parametrize("b,h,t,d,chunk,decay_hi", WKV_CASES)
def test_scan_route_matches_reference_kernel_form(b, h, t, d, chunk,
                                                   decay_hi):
    args = _wkv_inputs(9, b, h, t, d, decay_hi)
    want = _jax_wkv_scan_f32(*map(jnp.asarray, args), chunk=chunk)
    got = TR._wkv_scan(*map(torch.as_tensor, args), chunk=chunk)
    assert _rel(got, want) < SCAN_F32_TOL


@pytest.mark.parametrize("b,h,t,d,chunk,decay_hi", WKV_CASES)
def test_chunked_matches_reference_chunked(b, h, t, d, chunk, decay_hi):
    args = _wkv_inputs(10, b, h, t, d, decay_hi)
    want = JR._wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    got = TR._wkv_chunked(*map(torch.as_tensor, args), chunk=chunk)
    assert _rel(got, want) < 2e-3


@pytest.mark.parametrize("route,b,h,t,d,chunk,decay_hi", [
    ("chunked", *WKV_CASES[1]), ("scan", *WKV_CASES[1]),
    ("scan", *WKV_CASES[2])])
def test_chunked_routes_match_recurrent(route, b, h, t, d, chunk, decay_hi):
    """Both chunked forms == the step-by-step recurrence.  ``"chunked"``
    at the reference's tolerance for its bf16 operands and at its geometry
    (test_models_deep.py::test_wkv_chunked_vs_recurrent, 5e-2; at D = 64
    the bf16 rounding alone exceeds it); ``"scan"``, float32 throughout,
    at 1e-4 and also at head dim 64."""
    r, k, v, logw, u = map(torch.as_tensor,
                           _wkv_inputs(5, b, h, t, d, decay_hi))
    chunked = TR._WKV[route](r, k, v, logw, u, chunk=chunk)
    state = torch.zeros((b, h, d, d))
    outs = []
    for i in range(t):
        o, state = TR._wkv_recurrent_step(state, r[:, :, i], k[:, :, i],
                                          v[:, :, i], torch.exp(logw[:, :, i]),
                                          u)
        outs.append(o)
    rec = torch.stack(outs, dim=2)
    tol = 5e-2 if route == "chunked" else 1e-4
    np.testing.assert_allclose(chunked.numpy(), rec.numpy(), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_init_matches_reference_layout(jparams):
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    tp = TR.init(g, tcfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}[{k!r}]", v)
        else:
            tflat[path] = node

    walk("", tp)
    assert set(tflat) == set(jflat)
    for name, leaf in tflat.items():
        assert tuple(leaf.shape) == jflat[name].shape, name
        assert leaf.dtype == torch.float32
        want = np.asarray(jflat[name])
        if np.all(want == want.flat[0]):  # constants: equal
            assert torch.equal(leaf, torch.tensor(want)), name
        else:  # seeded draws: same scale
            ratio = float(leaf.std()) / float(want.std())
            assert 0.8 < ratio < 1.25, (name, ratio)


def test_init_caches_match_reference():
    jcfg, tcfg = _cfgs()
    want = JR.init_caches(jcfg, 3, 16)
    got = TR.init_caches(tcfg, 3, 16, device="cpu")
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.float().numpy(), np.asarray(w.astype(jnp.float32))), want, got)
    assert got["tm"]["shift"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wkv", ["chunked", "scan"])
@pytest.mark.parametrize("chunk", [64, 16])
def test_forward_matches_reference(jparams, tparams, dtype, wkv, chunk):
    jcfg, tcfg = _cfgs(dtype=dtype, rwkv_chunk=chunk)
    tok = _tokens(1)
    want, _ = JR.forward(jparams, jnp.asarray(tok), jcfg)
    got, aux = TR.forward(tparams, tok, tcfg, wkv)
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    tol = {("float32", "chunked"): F32_CHUNKED_TOL,
           ("float32", "scan"): SCAN_TOL}.get((dtype, wkv), BF16_TOL)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wkv", ["chunked", "scan"])
def test_loss_matches_reference(jparams, tparams, dtype, wkv):
    jcfg, tcfg = _cfgs(dtype=dtype)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 512, (2, T_SEQ)),
             "labels": rng.integers(0, 512, (2, T_SEQ)),
             "mask": (rng.random((2, T_SEQ)) < 0.8).astype(np.float32)}
    want, wm = JR.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    got, gm = TR.loss_fn(tparams, batch, tcfg, wkv)
    assert set(gm) == set(wm) and float(gm["ce"]) == float(got)
    # a mean of log-likelihoods near log(512): relative error of the
    # logits carries over at most linearly
    tol = 1e-4 if (dtype, wkv) == ("float32", "chunked") else 5e-3
    assert abs(float(got) - float(want)) / float(want) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wkv", ["chunked", "scan"])
def test_prefill_matches_reference(jparams, tparams, dtype, wkv):
    jcfg, tcfg = _cfgs(dtype=dtype)
    tok = _tokens(3)
    want = JR.prefill(jparams, jnp.asarray(tok), jcfg)
    got = build_model(tcfg, wkv=wkv, device="cpu").prefill(tparams,
                                                           tokens=tok)
    assert tuple(got.shape) == (2, 1, 512)
    tol = {("float32", "chunked"): F32_CHUNKED_TOL,
           ("float32", "scan"): SCAN_TOL}.get((dtype, wkv), BF16_TOL)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("chunk", [64, 16])
def test_scan_forward_matches_reference_kernel_form(jparams, tparams,
                                                    jax_kernel_form, chunk):
    jcfg, tcfg = _cfgs(dtype="float32", rwkv_chunk=chunk)
    tok = _tokens(1)
    want, _ = JR.forward(jparams, jnp.asarray(tok), jcfg)
    got, _ = TR.forward(tparams, tok, tcfg, "scan")
    assert _rel(got, want) < SCAN_F32_TOL


def test_scan_prefill_and_loss_match_reference_kernel_form(jparams, tparams,
                                                           jax_kernel_form):
    jcfg, tcfg = _cfgs(dtype="float32")
    tok = _tokens(3)
    want = JR.prefill(jparams, jnp.asarray(tok), jcfg)
    got = build_model(tcfg, device="cpu").prefill(tparams, tokens=tok)
    assert _rel(got, want) < SCAN_F32_TOL
    rng = np.random.default_rng(2)
    batch = {"tokens": tok, "labels": rng.integers(0, 512, tok.shape)}
    want, _ = JR.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    got, _ = TR.loss_fn(tparams, batch, tcfg, "scan")
    assert abs(float(got) - float(want)) / float(want) < SCAN_F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(jparams, tparams, dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    tok = _tokens(4, t=6)
    jc = JR.init_caches(jcfg, 2, 6)
    tc = TR.init_caches(tcfg, 2, 6, device="cpu")
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    for t in range(tok.shape[1]):
        pos = np.full((2,), t, np.int32)
        want, jc = JR.decode_step(jparams, jc, jnp.asarray(tok[:, t:t + 1]),
                                  jnp.asarray(pos), jcfg)
        got, tc = TR.decode_step(tparams, tc, tok[:, t:t + 1], pos, tcfg)
        assert _rel(got, want) < tol
    for path in (("tm", "s"), ("tm", "shift"), ("cm", "shift")):
        g, w = tc[path[0]][path[1]], jc[path[0]][path[1]]
        assert tuple(g.shape) == w.shape
        assert _rel(g, w) < tol


@pytest.mark.parametrize("wkv", ["chunked", "scan"])
def test_decode_matches_prefill(tparams, wkv):
    """Token-by-token decode logits == full-sequence forward logits, within
    the reference's rwkv6 tolerance (tests/test_arch_smoke.py:139)."""
    _, tcfg = _cfgs()
    model = build_model(tcfg, wkv=wkv, device="cpu")
    tok = _tokens(7, t=8)
    full, _ = TR.forward(tparams, tok, tcfg, wkv)
    caches = model.init_caches(2, 8)
    outs = []
    for t in range(8):
        logits, caches = model.decode_step(tparams, caches, tok[:, t:t + 1],
                                           np.full((2,), t, np.int32))
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1).float()
    full = full.float()
    assert float((dec - full).abs().max() / (full.abs().max() + 1e-6)) < 0.08


@pytest.mark.parametrize("wkv", ["chunked", "scan"])
def test_quantized_prefill_matches_reference(jparams, tparams, wkv):
    """quantize_tree's (codes, scale) pairs run the integer datapath in
    every projection; the port quantizes the converted float tree to the
    reference's codes and scales, bit for bit."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jqp = jq.quantize_tree(jparams)
    tqp = tq.quantize_tree(tparams)
    converted = params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu")
    for mix, leaves in (("time_mix", ("wr", "wk", "wv", "wg", "wo")),
                        ("channel_mix", ("wk", "wv", "wr"))):
        for name in leaves:
            got = tqp["blocks"][mix][name]["w"]
            assert isinstance(got, tuple) and got[0].dtype == torch.int8
            for g, c in zip(got, converted["blocks"][mix][name]["w"]):
                assert torch.equal(g, c)
    tok = _tokens(5)
    want = JR.prefill(jqp, jnp.asarray(tok), jcfg)
    got = build_model(tcfg, wkv=wkv, device="cpu").prefill(tqp, tokens=tok)
    tol = F32_CHUNKED_TOL if wkv == "chunked" else SCAN_TOL
    assert _rel(got, want) < tol


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-base"])
def test_build_model_serves_hybrid_and_encdec_on_cpu(arch):
    """Every family builds: the hybrid and the encoder-decoder run init,
    init_caches, prefill (with ``frames`` for encdec), decode_step and
    loss_fn on the CPU when asked, with finite outputs of the right
    shapes."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 6))
    inputs = {}
    if cfg.family == "encdec":
        inputs["frames"] = rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    logits = model.prefill(params, tokens=tok, **inputs)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    caches = model.init_caches(2, 8)
    step, caches = model.decode_step(params, caches, tok[:, :1],
                                     np.zeros((2,), np.int32))
    assert tuple(step.shape) == (2, 1, cfg.vocab_size)
    loss, _ = model.loss_fn(params, {"tokens": tok, "labels": tok, **inputs})
    assert all(bool(torch.isfinite(t).all()) for t in (logits, step, loss))


def test_build_model_rejects_unknown_route():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="wkv"):
        build_model(tcfg, wkv="pallas", device="cpu")


# ---------------------------------------------------------------------------
# serving: the weight registry and the LM server
# ---------------------------------------------------------------------------


def test_lm_server_greedy_tokens_match_reference(jparams, tparams):
    jcfg, tcfg = _cfgs(dtype="float32")
    prompt = _tokens(6, t=6)
    jsrv = JLMServer(jcfg, batch=2, max_seq=16)
    jsrv.install("m", jparams)
    want = jsrv.generate("m", prompt, 5)
    srv = LMServer(tcfg, batch=2, max_seq=16, device="cpu")
    srv.install("m", tparams)
    got = srv.generate("m", prompt, 5)
    assert got.dtype == np.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert srv.tokens_per_second() > 0
    assert srv.stats["tokens"] == 2 * (6 + 5 - 1)


def test_lm_server_trace_count_flat_across_install(tparams):
    _, tcfg = _cfgs(dtype="float32")
    srv = LMServer(tcfg, batch=2, max_seq=16, device="cpu")
    srv.install("m", tparams)
    prompt = _tokens(8, t=4)
    first = srv.generate("m", prompt, 3)
    assert srv.trace_count == 1
    other = TR.init(torch.Generator().manual_seed(1), tcfg, device="cpu")
    srv.install("m", other)  # same structure: a hot swap
    second = srv.generate("m", prompt, 3)
    assert srv.trace_count == 1 and srv.registry.swaps == 2
    assert not np.array_equal(first, second)
    sampled = srv.generate("m", prompt, 3, temperature=0.7, seed=3)
    assert np.array_equal(sampled, srv.generate("m", prompt, 3,
                                                temperature=0.7, seed=3))
    assert srv.trace_count == 1
    srv.install("q", tq.quantize_tree(other))  # another structure: a new one
    srv.generate("q", prompt, 2)
    assert srv.trace_count == 2
    with pytest.raises(ValueError, match="batch"):
        srv.generate("m", _tokens(8, b=3, t=4), 2)


def test_weight_registry_raises_on_structure_change(jparams, tparams):
    reg = WeightRegistry()
    reg.install("m", tparams)
    reg.install("m", TR.init(torch.Generator().manual_seed(2),
                             _cfgs()[1], device="cpu"))
    assert reg.names() == ["m"] and reg.swaps == 2
    with pytest.raises(ValueError, match="structure"):
        reg.install("m", tq.quantize_tree(tparams))
    with pytest.raises(ValueError, match="structure"):
        reg.install("m", {k: v for k, v in tparams.items() if k != "embed"})
    # the reference refuses the same change
    jreg = JWeightRegistry()
    jreg.install("m", jparams)
    with pytest.raises(ValueError, match="structure"):
        jreg.install("m", jq.quantize_tree(jparams))
    reg.install("q", tq.quantize_tree(tparams))
    assert reg.names() == ["m", "q"] and reg.get("m") is not None
