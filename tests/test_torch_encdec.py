"""The port's Whisper encoder–decoder against the JAX reference on the CPU:
the sinusoidal positions, cross-attention and its K/V, the encoder and
decoder blocks, and the whole model (encode, forward, loss, prefill with
``frames``, ``precompute_cross`` and decode, the quantized prefill, the LM
server), reduced (2 + 2 layers, d_model 128, 16 frames), with the
reference's own ``init`` carried across by ``params_from_numpy``.

Tolerances, each with its reason (relative: max |Δ| over the largest
reference value):

  * Exact: the sinusoid table (numpy in both), the parameter tree's layout
    and constants, the caches.
  * Float32 layers: 1e-5 (XLA's and PyTorch's softmax ``exp`` and
    contraction orders differ in the last bits); float32 whole models:
    1e-4 on the logits (measured ≤ 1e-6), losses 1e-5.
  * Bfloat16 layers 2e-2 and whole models 5e-2 (measured ≤ 1e-2), the
    transformer families' bounds: XLA keeps excess precision through fused
    chains where PyTorch rounds every op.
  * Decode against the port's own forward: 0.03, the reference's tolerance
    for this family (``tests/test_arch_smoke.py:139``).
  * The quantized (W8A8) prefill against the reference's: 2e-2; against
    the float prefill NMSE below 0.15 (``tests/test_arch_smoke.py:184``).
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
from repro.models import encdec as JE
from repro_torch.configs import get_config, reduced
from repro_torch.core import quantize as tq
from repro_torch.launch.serve import LMServer
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import encdec as TE
from repro_torch.models.layers import layer_params

torch.set_num_threads(1)

ARCH = "whisper-base"
LAYER_TOL = 1e-5
F32_TOL = 1e-4
BF16_LAYER_TOL = 2e-2
BF16_TOL = 5e-2
DECODE_TOL = 0.03
QUANT_TOL = 2e-2
SEQ = 12

_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                               "xla_llvm_disable_expensive_passes": True})
J_INIT = _jit(JE.init, static_argnums=(1,))
J_DECODE = _jit(JE.decode_step, static_argnums=(4,))
J_ENC_BLOCK = _jit(JE.encoder_block_fwd, static_argnums=(2,))
J_DEC_BLOCK = _jit(JE.decoder_block_fwd, static_argnums=(4,))
J_CROSS = _jit(JE.cross_attention, static_argnums=(4,))
J_PRECOMPUTE = _jit(JE.precompute_cross, static_argnums=(2,))


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
    if not _PARAMS:
        jcfg, _ = _cfgs()
        jp = J_INIT(jax.random.key(0), jcfg)
        _PARAMS["p"] = (jp, _to_torch(jp))
    return _PARAMS["p"]


def _tokens(seed, b=2, s=SEQ):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


def _frames(seed, b=2):
    jcfg, _ = _cfgs()
    return _data(seed, b, jcfg.encoder_seq, jcfg.d_model)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,d", [(16, 128), (1500, 512)])
def test_sinusoid_equals_reference(seq, d):
    got = TE._sinusoid(seq, d)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JE._sinusoid(seq, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_kv_match_reference(dtype):
    """Decoder layer 1's cross-attention over 16 memory positions from 5
    queries: its K/V, then the bidirectional attention through ``wq`` and
    ``wo`` (both with the reference's biases)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params()
    jb = jax.tree.map(lambda a: a[1], jp["dec_blocks"]["cross_attn"])
    tb = layer_params(tp["dec_blocks"]["cross_attn"], 1)
    mem = _pair(_data(1, 2, 16, jcfg.d_model, scale=0.5), dtype)
    x = _pair(_data(2, 2, 5, jcfg.d_model, scale=0.5), dtype)
    jk, jv = JE.cross_kv(jb, mem[0], jcfg)
    tk, tv = TE.cross_kv(tb, mem[1], tcfg)
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert _rel(tk, jk) < tol and _rel(tv, jv) < tol
    want = J_CROSS(jb, x[0], jk, jv, jcfg)
    got = TE.cross_attention(tb, x[1], tk, tv, tcfg)
    assert got.dtype == x[1].dtype and _rel(got, want) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_decoder_blocks_match_reference(dtype):
    """Layer 0 of each stack: the encoder block (bidirectional), the
    decoder block over 7 positions, then 3 decode steps of the decoder
    block against its KV cache, each on the reference's own input."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params()
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    je = jax.tree.map(lambda a: a[0], jp["enc_blocks"])
    x = _pair(_data(3, 2, 16, jcfg.d_model, scale=0.5), dtype)
    want = J_ENC_BLOCK(je, x[0], jcfg)
    got = TE.encoder_block_fwd(layer_params(tp["enc_blocks"], 0), x[1], tcfg)
    assert _rel(got, want) < tol
    jd = jax.tree.map(lambda a: a[0], jp["dec_blocks"])
    td = layer_params(tp["dec_blocks"], 0)
    jk, jv = JE.cross_kv(jd["cross_attn"], want, jcfg)
    tk, tv = (torch.as_tensor(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jk, jv))
    y = _pair(_data(4, 2, 7, jcfg.d_model, scale=0.5), dtype)
    want, _ = J_DEC_BLOCK(jd, y[0], jk, jv, jcfg)
    got, none = TE.decoder_block_fwd(td, y[1], tk, tv, tcfg)
    assert none is None and _rel(got, want) < tol
    jc = jax.tree.map(lambda a: a[0], JE.init_caches(jcfg, 2, 4)["self"])
    tc = _to_torch(jc)
    for t in range(3):
        pos = np.full((2,), t, np.int32)
        want, jc = J_DEC_BLOCK(jd, y[0][:, t:t + 1], jk, jv, jcfg,
                               pos=jnp.asarray(pos), cache=jc)
        got, tc = TE.decoder_block_fwd(td, y[1][:, t:t + 1], tk, tv, tcfg,
                                       pos=torch.as_tensor(pos), cache=tc)
        assert _rel(got, want) < tol
    jax.tree.map(lambda w, g: _rel(g, w) < tol or pytest.fail("cache"),
                 jc, tc)


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


def test_init_and_caches_match_reference_layout():
    """The port's seeded init has the reference's tree (stacked encoder and
    decoder layers, ``pos_dec`` of 65536 learned positions), shapes, dtypes
    and scales, its constants equal; the caches equal the reference's."""
    jcfg, tcfg = _cfgs()
    jp, _ = _params()
    tp = TE.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = _flat(tp)
    assert set(tflat) == set(jflat)
    assert tuple(tp["pos_dec"].shape) == (65_536, jcfg.d_model)
    for name, leaf in tflat.items():
        want = np.asarray(jflat[name])
        assert tuple(leaf.shape) == want.shape and leaf.dtype == torch.float32
        if np.all(want == want.flat[0]):  # constants: equal
            assert torch.equal(leaf, torch.tensor(want)), name
        else:  # seeded draws: same scale
            assert 0.75 < float(leaf.std()) / float(want.std()) < 1.33, name
    want = JE.init_caches(jcfg, 2, 6)
    got = TE.init_caches(tcfg, 2, 6, device="cpu")
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.float().numpy(), np.asarray(w.astype(jnp.float32))), want, got)


def _batch():
    tok = _tokens(10)
    labels = np.random.default_rng(11).integers(0, 512, tok.shape)
    mask = (np.arange(SEQ)[None] < np.asarray([[SEQ], [SEQ - 4]])).astype(
        np.float32)
    return tok, labels, mask, _frames(12)


def _reference_all(params, tok, labels, mask, frames, cfg):
    batch = {"tokens": tok, "labels": labels, "mask": mask, "frames": frames}
    return (JE.encode(params, frames, cfg),
            JE.forward(params, tok, cfg, frames=frames)[0],
            JE.loss_fn(params, batch, cfg),
            JE.prefill(params, tok, cfg, frames=frames))


J_ALL = _jit(_reference_all, static_argnums=(5,))
_REFERENCE = {}


def _reference(dtype):
    if dtype not in _REFERENCE:
        jcfg, _ = _cfgs(dtype=dtype)
        _REFERENCE[dtype] = J_ALL(_params()[0],
                                  *(jnp.asarray(v) for v in _batch()), jcfg)
    return _REFERENCE[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_forward_loss_prefill_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    _, tp = _params()
    tok, labels, mask, frames = _batch()
    want_mem, want_fwd, (_, jm), want_pre = _reference(dtype)
    model = build_model(tcfg, device="cpu")
    mem = TE.encode(tp, frames, tcfg)
    got, aux = TE.forward(tp, tok, tcfg, frames=frames)
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    assert tuple(got.shape) == (2, SEQ, jcfg.vocab_size)
    pre = model.prefill(tp, tokens=tok, frames=torch.as_tensor(frames))
    assert tuple(pre.shape) == (2, 1, jcfg.vocab_size)
    _, m = model.loss_fn(tp, {"tokens": tok, "labels": labels, "mask": mask,
                              "frames": frames})
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in ((mem, want_mem), (got, want_fwd), (pre, want_pre)):
        assert _rel(g, w) < tol
    ltol = 1e-5 if dtype == "float32" else BF16_TOL
    for k in ("loss", "ce"):
        assert abs(float(m[k]) - float(jm[k])) <= ltol * float(jm[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_precompute_cross_and_decode_match_reference(dtype):
    """``precompute_cross`` on 16 frames, then 6 positions one token at a
    time (``pos_dec[pos]`` per row, the rows at different positions): the
    logits of every step and the final caches."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params()
    frames = _frames(13)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jc = J_PRECOMPUTE(jp, jnp.asarray(frames), jcfg, JE.init_caches(jcfg, 2, 8))
    model = build_model(tcfg, device="cpu")
    tc = TE.precompute_cross(tp, frames, tcfg, model.init_caches(2, 8))
    for name in ("cross_k", "cross_v"):
        assert _rel(tc[name], jc[name]) < tol
    tok = _tokens(14, s=6)
    for t in range(6):
        pos = np.asarray([t, t + 2], np.int32)
        want, jc = J_DECODE(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                            jnp.asarray(pos), jcfg)
        got, tc = model.decode_step(tp, tc, tok[:, t:t + 1], pos)
        assert _rel(got, want) < tol
    jax.tree.map(lambda w, g: _rel(g, w) < tol or pytest.fail("cache"),
                 jc, tc)


def test_decode_matches_forward():
    """Token-by-token decode against the cross memory of
    ``precompute_cross`` equals the full forward in the port, within the
    reference's 0.03 (bf16)."""
    _, tcfg = _cfgs()
    _, tp = _params()
    model = build_model(tcfg, device="cpu")
    tok, frames = _tokens(15, s=8), _frames(16)
    full, _ = TE.forward(tp, tok, tcfg, frames=frames)
    caches = TE.precompute_cross(tp, frames, tcfg, model.init_caches(2, 8))
    outs = []
    for t in range(8):
        logits, caches = model.decode_step(tp, caches, tok[:, t:t + 1],
                                           np.full((2,), t, np.int32))
        outs.append(logits[:, 0])
    dec, full = torch.stack(outs, dim=1).float(), full.float()
    assert float((dec - full).abs().max() / full.abs().max()) < DECODE_TOL


def test_quantized_prefill_and_decode_match_reference():
    """quantize_tree's pairs run the integer datapath in the encoder's 6
    projections a layer and the decoder's 10 (self 4, cross ``wq``/``wo``
    and the cross K/V, MLP 2); the port's codes and scales equal the
    reference's, and the reference's integer path runs for this family."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _params()
    jqp, tqp = jq.quantize_tree(jp), tq.quantize_tree(tp)
    got_leaves, conv_leaves = _flat(tqp), _flat(_to_torch(jqp))
    assert set(got_leaves) == set(conv_leaves)
    pairs = [k for k in got_leaves if k.endswith("[0]")]
    assert len(pairs) == 16, pairs
    for k, v in got_leaves.items():
        assert torch.equal(v, conv_leaves[k]), k
    tok, frames = _tokens(17), _frames(18)
    want = _jit(JE.prefill, static_argnums=(2,))(
        jqp, jnp.asarray(tok), jcfg, frames=jnp.asarray(frames))
    got = build_model(tcfg, device="cpu").prefill(tqp, tokens=tok,
                                                  frames=frames)
    assert _rel(got, want) < QUANT_TOL
    fp = TE.prefill(tp, tok, tcfg, frames=frames).float()
    nmse = float(((fp - got.float()) ** 2).mean() / (fp ** 2).mean())
    assert nmse < 0.15
    pos = np.zeros((2,), np.int32)
    jc = JE.precompute_cross(jqp, jnp.asarray(frames), jcfg,
                             JE.init_caches(jcfg, 2, 4))
    want, _ = J_DECODE(jqp, jc, jnp.asarray(tok[:, :1]), jnp.asarray(pos),
                       jcfg)
    tc = TE.precompute_cross(tqp, frames, tcfg,
                             TE.init_caches(tcfg, 2, 4, device="cpu"))
    got, _ = TE.decode_step(tqp, tc, tok[:, :1], pos, tcfg)
    assert _rel(got, want) < QUANT_TOL


def test_lm_server_greedy_tokens_match_reference():
    """The reference's server never calls ``precompute_cross``: its decode
    attends to zero cross memory, and so does the port's; greedy tokens
    equal, ``trace_count`` flat across a same-structure install."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _params()
    prompt = _tokens(19, s=4)
    jsrv = JLMServer(jcfg, batch=2, max_seq=8)
    jsrv.install("m", jp)
    want = jsrv.generate("m", prompt, 4)
    srv = LMServer(tcfg, batch=2, max_seq=8, device="cpu")
    srv.install("m", tp)
    got = srv.generate("m", prompt, 4)
    np.testing.assert_array_equal(got, np.asarray(want))
    srv.install("m", TE.init(torch.Generator().manual_seed(2), tcfg,
                             device="cpu"))
    srv.generate("m", prompt, 2)
    assert srv.trace_count == 1 and srv.registry.swaps == 2
