"""The port's Zamba2 hybrid (Mamba-2/SSD layers and one shared transformer
block) against the JAX reference on the CPU: the chunked SSD and its
recurrent step, the causal conv, softplus, one Mamba-2 block (prefill and
decode), and the whole model (forward, loss, prefill, decode with the full
and the Taylor-linear shared attention, the quantized prefill, the LM
server), reduced (4 Mamba layers in 2 groups, d_model 128), with the
reference's own ``init`` carried across by ``params_from_numpy``.

Tolerances, each with its reason (relative: max |Δ| over the largest
reference value, unless a line says otherwise):

  * Exact: the parameter tree's layout and constants, the caches, the conv
    state, softplus's float32 values.
  * Float32 layers and the SSD: 1e-5 (XLA's and PyTorch's ``exp``,
    ``cumsum`` and contraction orders differ in the last bits; measured
    ≤ 1e-6).
  * The chunked SSD against its own recurrent step: atol 1e-4, rtol 1e-3,
    the reference's tolerance for its own pair
    (``tests/test_models_deep.py:151-152``).
  * Float32 whole models: 1e-4 on the logits (measured ≤ 1e-6), losses
    1e-5.
  * Bfloat16 layers: 2e-2, two bf16 steps: the causal conv sums its four
    taps with a rounding after every add in PyTorch, where XLA may keep
    float32 through the fused chain, and the projections round at other
    places.  Bfloat16 whole models: 5e-2 (measured ≤ 2.8e-2), the
    transformer families' bound.
  * Decode against the port's own forward: 0.08, the reference's tolerance
    for the hybrid family (``tests/test_arch_smoke.py:139``).
  * The quantized (W8A8) prefill against the reference's: 2e-2 (an
    activation that differs in its last float32 bit may round to the
    neighbouring int8 code); against the float prefill NMSE below the
    reference's 0.15 (``tests/test_arch_smoke.py:184``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import quantize as jq
from repro.launch.serve import LMServer as JLMServer
from repro.models import ssm as JS
from repro_torch.configs import get_config, reduced
from repro_torch.core import quantize as tq
from repro_torch.launch.serve import LMServer
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import ssm as TS
from repro_torch.models.layers import layer_params

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
LAYER_TOL = 1e-5
F32_TOL = 1e-4
BF16_LAYER_TOL = 2e-2
BF16_TOL = 5e-2
DECODE_TOL = 0.08
QUANT_TOL = 2e-2
SEQ = 29  # ragged: one full chunk of 16 and a padded one where C = 16

_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                               "xla_llvm_disable_expensive_passes": True})
J_INIT = _jit(JS.init, static_argnums=(1,))
J_SSD = _jit(JS._ssd_chunked, static_argnums=(5,))
J_BLOCK = _jit(JS.mamba_block_fwd, static_argnums=(2,))
J_DECODE = _jit(JS.decode_step, static_argnums=(4,))


def _rel(got, want) -> float:
    got = np.asarray(got.float().detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _cfgs(**kw):
    """The same reduced config in both packages."""
    return (jreduced(jget_config(ARCH)).replace(remat=False, **kw),
            reduced(get_config(ARCH)).replace(remat=False, **kw))


def _data(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pair(x, dtype):
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


_PARAMS = {}


def _params():
    """The reference's own init of the reduced config and its conversion
    (made once)."""
    if not _PARAMS:
        jcfg, _ = _cfgs()
        jp = J_INIT(jax.random.key(0), jcfg)
        _PARAMS["p"] = (jp, _to_torch(jp))
    return _PARAMS["p"]


def _tokens(seed, b=2, s=SEQ):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


def _ssd_inputs(seed, b, t, h, dh, n):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    bm = (rng.normal(size=(b, t, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, t, n)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, t, h)).astype(np.float32)
    a = -np.asarray([0.5, 2.0, 8.0][:h], np.float32)
    return xh, bm, cm, dt, a


# ---------------------------------------------------------------------------
# the SSD, the conv, softplus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,t", [(8, 29), (64, 29), (64, 130)])
def test_ssd_chunked_matches_reference(chunk, t):
    """Ragged T (a padded last chunk), one chunk of 64, and three chunks of
    64 with the state carried across them; a head whose decay reaches the
    −30 clamp inside a chunk."""
    args = _ssd_inputs(1, 2, t, 3, 4, 8)
    want = J_SSD(*(jnp.asarray(v) for v in args), chunk)
    got = TS._ssd_chunked(*(torch.as_tensor(v) for v in args), chunk)
    assert _rel(got, want) < LAYER_TOL


@pytest.mark.parametrize("chunk", [8, 64])
def test_ssd_chunked_matches_own_recurrent_step(chunk):
    """The reference's pair test (``test_models_deep.py``) on the port:
    the chunked form against ``_ssd_step`` applied token by token."""
    xh, bm, cm, dt, a = (torch.as_tensor(v)
                         for v in _ssd_inputs(6, 1, 29, 2, 4, 8))
    chunked = TS._ssd_chunked(xh, bm, cm, dt, a, chunk=chunk)
    state = torch.zeros((1, 2, 4, 8))
    outs = []
    for i in range(29):
        y, state = TS._ssd_step(state, xh[:, i], bm[:, i], cm[:, i],
                                dt[:, i], a)
        outs.append(y)
    np.testing.assert_allclose(chunked.numpy(),
                               torch.stack(outs, dim=1).numpy(),
                               atol=1e-4, rtol=1e-3)


def test_ssd_step_matches_reference():
    xh, bm, cm, dt, a = _ssd_inputs(2, 2, 1, 3, 4, 8)
    s0 = _data(3, 2, 3, 4, 8)
    want_y, want_s = JS._ssd_step(jnp.asarray(s0), jnp.asarray(xh[:, 0]),
                                  jnp.asarray(bm[:, 0]), jnp.asarray(cm[:, 0]),
                                  jnp.asarray(dt[:, 0]), jnp.asarray(a))
    got_y, got_s = TS._ssd_step(torch.as_tensor(s0),
                                *(torch.as_tensor(v[:, 0])
                                  for v in (xh, bm, cm, dt)),
                                torch.as_tensor(a))
    assert _rel(got_y, want_y) < LAYER_TOL and _rel(got_s, want_s) < LAYER_TOL


def test_ssd_clamp_keeps_strong_decay_finite():
    """A decay of −40 per token: without the −30 clamp the masked-out upper
    triangle overflows exp to inf, and inf · 0 is NaN."""
    xh, bm, cm, dt, a = _ssd_inputs(4, 1, 16, 1, 4, 8)
    a = np.asarray([-400.0], np.float32)
    got = TS._ssd_chunked(*(torch.as_tensor(v) for v in (xh, bm, cm, dt, a)),
                          chunk=16)
    want = J_SSD(*(jnp.asarray(v) for v in (xh, bm, cm, dt, a)), 16)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) < LAYER_TOL


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(with_state, dtype):
    x = _pair(_data(5, 2, 7, 12), dtype)
    w = _data(6, 4, 12, scale=0.2)
    b = _data(7, 12, scale=0.1)
    st = _pair(_data(8, 2, 3, 12), dtype) if with_state else (None, None)
    want, want_s = JS._causal_conv(x[0], jnp.asarray(w), jnp.asarray(b),
                                   st[0])
    got, got_s = TS._causal_conv(x[1], torch.as_tensor(w), torch.as_tensor(b),
                                 st[1])
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert got.dtype == x[1].dtype and _rel(got, want) < tol
    np.testing.assert_array_equal(got_s.float().numpy(),
                                  np.asarray(want_s.astype(jnp.float32)))


def test_softplus_matches_reference_past_twenty():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere; ``F.softplus``
    switches to x past 20, which the port does not use."""
    x = np.asarray([-50.0, -3.0, 0.0, 0.5, 19.5, 20.5, 25.0, 90.0],
                   np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS._softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


# ---------------------------------------------------------------------------
# one Mamba-2 block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_prefill_and_decode_match_reference(dtype):
    """Layer (1, 0) of the reference's init: the chunked prefill on 29
    positions, then 3 decode steps from the reference's own state."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params()
    jb = jax.tree.map(lambda a: a[1, 0], jp["mamba"])
    tb = layer_params(layer_params(tp["mamba"], 1), 0)
    x = _pair(_data(9, 2, SEQ, jcfg.d_model, scale=0.5), dtype)
    want, _ = J_BLOCK(jb, x[0], jcfg)
    got, none = TS.mamba_block_fwd(tb, x[1], tcfg)
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert none is None and got.dtype == x[1].dtype
    assert _rel(got, want) < tol
    jst = jax.tree.map(lambda a: a[1, 0], JS.init_caches(jcfg, 2, 4)["mamba"])
    tst = _to_torch(jst)
    for t in range(3):
        want, jst = J_BLOCK(jb, x[0][:, t:t + 1], jcfg, state=jst)
        got, tst = TS.mamba_block_fwd(tb, x[1][:, t:t + 1], tcfg, state=tst)
        assert _rel(got, want) < tol
        assert _rel(tst["s"], jst["s"]) < tol
        assert _rel(tst["conv"], jst["conv"]) < tol


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{path}[{key!r}]").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{path}[{i}]").items()}
    return {path: tree}


@pytest.mark.parametrize("impl", ["full", "taylor_linear"])
def test_init_and_caches_match_reference_layout(impl):
    """The port's seeded init has the reference's tree ((groups, per, …)
    Mamba stack, one shared block), shapes, dtypes and scales, its
    constants equal; the caches equal the reference's."""
    jcfg, tcfg = _cfgs(attention_impl=impl)
    jp, _ = _params()
    tp = TS.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = _flat(tp)
    assert set(tflat) == set(jflat)
    assert tuple(tp["mamba"]["in_z"]["w"].shape[:2]) == (2, 2)
    for name, leaf in tflat.items():
        want = np.asarray(jflat[name])
        assert tuple(leaf.shape) == want.shape and leaf.dtype == torch.float32
        if np.all(want == want.flat[0]):  # constants: equal
            assert torch.equal(leaf, torch.tensor(want)), name
        elif "a_log" in name:  # log(linspace(1, 8, h))
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-6)
        else:  # seeded draws: same scale
            assert 0.75 < float(leaf.std()) / float(want.std()) < 1.33, name
    want = JS.init_caches(jcfg, 2, 6)
    got = TS.init_caches(tcfg, 2, 6, device="cpu")
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.float().numpy(), np.asarray(w.astype(jnp.float32))), want, got)


def _batch():
    tok = _tokens(10)
    labels = np.random.default_rng(11).integers(0, 512, tok.shape)
    mask = (np.arange(SEQ)[None] < np.asarray([[SEQ], [SEQ - 5]])).astype(
        np.float32)
    return tok, labels, mask


def _reference_all(params, tok, labels, mask, cfg):
    batch = {"tokens": tok, "labels": labels, "mask": mask}
    return (JS.forward(params, tok, cfg)[0], JS.loss_fn(params, batch, cfg),
            JS.prefill(params, tok, cfg))


J_ALL = _jit(_reference_all, static_argnums=(4,))
_REFERENCE = {}


def _reference(dtype):
    if dtype not in _REFERENCE:
        jcfg, _ = _cfgs(dtype=dtype)
        _REFERENCE[dtype] = J_ALL(_params()[0],
                                  *(jnp.asarray(v) for v in _batch()), jcfg)
    return _REFERENCE[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_prefill_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    _, tp = _params()
    tok, labels, mask = _batch()
    want_fwd, (want_loss, jm), want_pre = _reference(dtype)
    model = build_model(tcfg, device="cpu")
    got, aux = TS.forward(tp, tok, tcfg)
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    assert tuple(got.shape) == (2, SEQ, jcfg.vocab_size)
    pre = model.prefill(tp, tokens=tok)
    assert tuple(pre.shape) == (2, 1, jcfg.vocab_size)
    loss, m = model.loss_fn(tp, {"tokens": tok, "labels": labels,
                                 "mask": mask})
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(got, want_fwd) < tol and _rel(pre, want_pre) < tol
    ltol = 1e-5 if dtype == "float32" else BF16_TOL
    for k in ("loss", "ce"):
        assert abs(float(m[k]) - float(jm[k])) <= ltol * float(jm[k])
    assert float(loss) == float(m["loss"])


@pytest.mark.parametrize("impl", ["full", "taylor_linear"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(impl, dtype):
    """6 positions one token at a time from zeroed caches: the logits of
    every step and the final caches (the Mamba states and each shared-block
    application's KV cache or Taylor feature-map state)."""
    jcfg, tcfg = _cfgs(dtype=dtype, attention_impl=impl)
    jp, tp = _params()
    tok = _tokens(12, s=6)
    jc = JS.init_caches(jcfg, 2, 6)
    tc = build_model(tcfg, device="cpu").init_caches(2, 6)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(6):
        pos = np.full((2,), t, np.int32)
        want, jc = J_DECODE(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                            jnp.asarray(pos), jcfg)
        got, tc = TS.decode_step(tp, tc, tok[:, t:t + 1], pos, tcfg)
        assert _rel(got, want) < tol
    jax.tree.map(lambda w, g: _rel(g, w) < tol or pytest.fail("cache"),
                 jc, tc)


@pytest.mark.parametrize("impl", ["full", "taylor_linear"])
def test_decode_matches_forward(impl):
    """Token-by-token decode logits against the full-sequence forward in
    the port, within the reference's 0.08 for the hybrid family; with
    ``taylor_linear`` the prefill runs the chunked linear attention and the
    decode its O(1) state."""
    _, tcfg = _cfgs(attention_impl=impl)
    _, tp = _params()
    model = build_model(tcfg, device="cpu")
    tok = _tokens(13, s=8)
    full, _ = TS.forward(tp, tok, tcfg)
    caches = model.init_caches(2, 8)
    outs = []
    for t in range(8):
        logits, caches = model.decode_step(tp, caches, tok[:, t:t + 1],
                                           np.full((2,), t, np.int32))
        outs.append(logits[:, 0])
    dec, full = torch.stack(outs, dim=1).float(), full.float()
    assert float((dec - full).abs().max() / full.abs().max()) < DECODE_TOL


def test_quantized_prefill_and_decode_match_reference():
    """quantize_tree's (codes, scale) pairs run the integer datapath in the
    5 projections of every Mamba layer and the 6 of the shared block; the
    port quantizes the converted float tree to the reference's codes and
    scales, bit for bit, and the reference's integer path runs for this
    family (prefill and decode)."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _params()
    jqp, tqp = jq.quantize_tree(jp), tq.quantize_tree(tp)
    converted, got_leaves = _to_torch(jqp), _flat(tqp)
    conv_leaves = _flat(converted)
    assert set(got_leaves) == set(conv_leaves)
    pairs = [k for k in got_leaves if k.endswith("[0]")]
    assert len(pairs) == 11, pairs
    for k, v in got_leaves.items():
        assert torch.equal(v, conv_leaves[k]), k
    tok = _tokens(14)
    want = _jit(JS.prefill, static_argnums=(2,))(jqp, jnp.asarray(tok), jcfg)
    got = build_model(tcfg, device="cpu").prefill(tqp, tokens=tok)
    assert _rel(got, want) < QUANT_TOL
    fp = TS.prefill(tp, tok, tcfg).float()
    nmse = float(((fp - got.float()) ** 2).mean() / (fp ** 2).mean())
    assert nmse < 0.15
    pos = np.zeros((2,), np.int32)
    want, _ = J_DECODE(jqp, JS.init_caches(jcfg, 2, 4),
                       jnp.asarray(tok[:, :1]), jnp.asarray(pos), jcfg)
    got, _ = TS.decode_step(tqp, TS.init_caches(tcfg, 2, 4, device="cpu"),
                            tok[:, :1], pos, tcfg)
    assert _rel(got, want) < QUANT_TOL


# ---------------------------------------------------------------------------
# serving: the LM server
# ---------------------------------------------------------------------------


def test_lm_server_greedy_tokens_match_reference_and_hot_swap():
    """Greedy tokens equal the reference's server's; a same-structure
    install is a hot swap (``trace_count`` stays 1), a quantized tree is
    another structure."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _params()
    prompt = _tokens(15, s=5)
    jsrv = JLMServer(jcfg, batch=2, max_seq=8)
    jsrv.install("m", jp)
    want = jsrv.generate("m", prompt, 4)
    srv = LMServer(tcfg, batch=2, max_seq=8, device="cpu")
    srv.install("m", tp)
    first = srv.generate("m", prompt, 4)
    assert first.dtype == np.int32 and first.shape == (2, 4)
    np.testing.assert_array_equal(first, np.asarray(want))
    other = TS.init(torch.Generator().manual_seed(1), tcfg, device="cpu")
    srv.install("m", other)
    second = srv.generate("m", prompt, 4)
    assert srv.trace_count == 1 and srv.registry.swaps == 2
    assert not np.array_equal(first, second)
    srv.install("q", tq.quantize_tree(other))
    srv.generate("q", prompt, 2)
    assert srv.trace_count == 2
