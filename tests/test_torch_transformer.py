"""The port's transformer families (dense, MoE with MLA, VLM) against the JAX
reference on the CPU: the attention layers they call (RoPE, the KV
repetition, the three SDPA forms, flash attention, the int8 KV cache and
its writes, Taylor-linear attention) and the whole models (forward, loss,
prefill, decode, the LM server, the quantized prefill) for each of the 7
configs, reduced (2 layers, d_model 128), with the reference's own
``init`` carried across by ``params_from_numpy``.  The MoE and MLA layers
are held in ``tests/test_torch_moe_mla.py``.

Tolerances, each with its reason (relative: max |Δ| over the largest
reference value):

  * Exact (``torch.equal``/``assert_array_equal``): the KV repetition, the
    int8 KV codes and scales against the reference run op by op (compiled,
    XLA may turn the scale's division by 127 into a product with its
    reciprocal, one ulp away), the cache writes (including the clamp of a
    position past the end), the parameter trees and the tokens.
  * Float32 layers: 1e-5 (RoPE's float32 ``pow``/``cos``/``sin`` and the
    softmax's ``exp`` differ between XLA and PyTorch in the last bits, at
    positions up to 2048 with theta 1e6 too; measured ≤ 1e-6).  Flash
    attention against the reference's flash: 1e-5.
  * Float32 whole models: 1e-4 on the logits (measured ≤ 1.3e-6 over the 7
    configs), tighter than the 1e-3 of the rwkv6 precedent, which had a
    bf16 operand rounding inside its float32 model; these models have
    none.  Losses: 1e-5.
  * Bfloat16 layers: 2e-2, two bf16 steps (2^-7 relative each): XLA keeps
    excess precision through fused elementwise chains, PyTorch rounds every
    op, and both round the matrix products at other places.
  * Bfloat16 whole models: 5e-2 for the dense and VLM configs, on the
    logits and the loss.  The MoE configs' logits are held sublayer by
    sublayer at 5e-2 instead (the attention and the MoE FFN, each on the
    reference's own input): top-k routing is discontinuous, and the bf16
    rounding differences above move a near-tied expert choice at a few
    positions (measured on the whole models: 0.14 and 0.24 at 1 and 2 of
    48 positions for granite-moe, 0.22 at 3 of 48 for deepseek-v2; on one
    whole block against the compiled reference, 0.14), which no tolerance
    on the logits can state.  The MoE aux loss on the same input: 1e-5.
  * Decode against the port's own forward: 0.03, the reference's tolerance
    for these families (``tests/test_arch_smoke.py:139``), MoE at the
    dropless capacity the reference uses there.
  * The quantized (W8A8) prefill against the reference's: 2e-2.  The int8
    GEMM and its epilogue are bit-exact, but an activation that differs in
    its last float32 bit may round to the neighbouring int8 code.  Against
    the float prefill: NMSE below 0.15, the reference's budget
    (``tests/test_arch_smoke.py:184``).
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
from repro.models import flash as JF
from repro.models import layers as JL
from repro.models import mla as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.core import quantize as tq
from repro_torch.launch.serve import LMServer
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import flash as TF
from repro_torch.models import layers as TL
from repro_torch.models import mla as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import layer_params

torch.set_num_threads(1)

ARCHS = ["gemma-7b", "qwen2-1.5b", "chatglm3-6b", "granite-20b",
         "granite-moe-3b-a800m", "deepseek-v2-236b", "pixtral-12b"]
MOE = ("granite-moe-3b-a800m", "deepseek-v2-236b")
F32_TOL = 1e-4
LAYER_TOL = 1e-5
BF16_LAYER_TOL = 2e-2
BF16_TOL = 5e-2
DECODE_TOL = 0.03
QUANT_TOL = 2e-2
SEQ = 16


def _rel(got, want) -> float:
    got = np.asarray(got.float().detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _cfgs(arch, **kw):
    """The same reduced config in both packages."""
    return (jreduced(jget_config(arch)).replace(remat=False, **kw),
            reduced(get_config(arch)).replace(remat=False, **kw))


def _data(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pair(x, dtype):
    """``x`` (numpy float32) in both packages, rounded to ``dtype`` alike."""
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# The reference's functions, compiled once per config (cfg is static), at
# XLA's lowest LLVM optimisation level without its expensive passes: the
# same HLO and the same IEEE float operations (no fast math either way),
# compiled ≈3× faster on the CPU, where the compile is most of these
# tests' time.
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                               "xla_llvm_disable_expensive_passes": True})
J_INIT = _jit(JT.init, static_argnums=(1,))
J_DECODE = _jit(JT.decode_step, static_argnums=(4,))
J_PREFILL = _jit(JT.prefill, static_argnums=(2,))
J_FORWARD = _jit(JT.forward, static_argnums=(2,))
J_BLOCK = _jit(JT.block_fwd, static_argnums=(2,))
J_TL_DECODE = _jit(JL.taylor_linear_decode, static_argnums=(2,))
J_ATTENTION = _jit(JL.attention, static_argnums=(2,))
J_MOE = _jit(JL.moe_ffn, static_argnums=(2,))
J_MLA = _jit(JM.mla_attention, static_argnums=(2,))
J_ROPE = _jit(JL.rope, static_argnums=(2, 3))
J_REPEAT_KV = _jit(JL._repeat_kv, static_argnums=(1,))
J_SDPA = _jit(JL._sdpa_causal, static_argnums=(3, 4))
J_SDPA_DECODE = _jit(JL._sdpa_decode, static_argnums=(4,))
J_FLASH = _jit(JF.flash_attention, static_argnums=(3, 4))
J_FLASH_FWD = _jit(JF._flash_fwd, static_argnums=(3, 4))
J_CACHE_WRITE = _jit(JL._cache_write)
J_TAYLOR_LINEAR = _jit(JL.taylor_linear_attention, static_argnums=(3,))

_PARAMS = {}


def _params(arch, scan_layers=True):
    """The reference's own init of the reduced ``arch`` and its conversion
    (module cache: each is made once)."""
    key = (arch, scan_layers)
    if key not in _PARAMS:
        jcfg, _ = _cfgs(arch, scan_layers=scan_layers)
        jp = J_INIT(jax.random.key(0), jcfg)
        _PARAMS[key] = (jp, _to_torch(jp))
    return _PARAMS[key]


def _inputs(cfg, seed=0, b=2, s=SEQ):
    """Text tokens, and for the VLM patch embeddings (float32 numpy)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s))
    pe = None
    if cfg.family == "vlm":
        pe = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return tok, pe


# ---------------------------------------------------------------------------
# RoPE, the KV repetition, the SDPA forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(fraction, theta, dtype):
    x = _data(1, 2, 9, 3, 32, scale=2.0)
    pos = np.stack([np.arange(9), [0, 1, 5, 63, 511, 1000, 1500, 2047,
                                   2048]]).astype(np.int32)
    jx, tx = _pair(x, dtype)
    want = J_ROPE(jx, jnp.asarray(pos), theta, fraction)
    got = TL.rope(tx, torch.as_tensor(pos), theta, fraction)
    assert got.dtype == tx.dtype
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert _rel(got, want) < tol
    if fraction < 1:  # the tail stays as it was, bit for bit
        assert torch.equal(got[..., 16:], tx[..., 16:])


def test_rope_preserves_norm_and_relative_position():
    x = torch.as_tensor(_data(2, 1, 1, 1, 16))
    k = torch.as_tensor(_data(3, 1, 1, 1, 16))

    def at(t, m):
        return TL.rope(t, torch.full((1, 1), m), 100.0)

    for m in (0, 7, 500):
        assert abs(float(at(x, m).norm()) - float(x.norm())) < 1e-4
    dot = lambda m, n: float((at(x, m) * at(k, n)).sum())  # noqa: E731
    assert abs(dot(5, 3) - dot(105, 103)) < 1e-3


@pytest.mark.parametrize("n_rep", [1, 2, 6])
def test_repeat_kv_matches_reference(n_rep):
    k = _data(4, 2, 5, 3, 8)
    want = J_REPEAT_KV(jnp.asarray(k), n_rep)
    got = TL._repeat_kv(torch.as_tensor(k), n_rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n_rep > 1:  # query head i reads KV head i // n_rep
        assert torch.equal(got[:, :, n_rep], torch.as_tensor(k)[:, :, 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hkv,q_pos0", [(4, 0), (2, 0), (1, 3)])
def test_sdpa_causal_matches_reference(dtype, hkv, q_pos0):
    _, tcfg = _cfgs("qwen2-1.5b")
    jcfg = _cfgs("qwen2-1.5b")[0]
    q, k, v = (_pair(_data(s, 2, 11, h, 16), dtype)
               for s, h in ((5, 4), (6, hkv), (7, hkv)))
    want = J_SDPA(q[0], k[0], v[0], jcfg, q_pos0)
    got = TL._sdpa_causal(q[1], k[1], v[1], tcfg, q_pos0)
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert got.dtype == q[1].dtype and _rel(got, want) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_chunked_route_matches_reference(dtype):
    """640 queries against 640 keys take the flash route (two 512-blocks,
    the second padded) in both packages; 2 KV heads for 4 query heads."""
    jcfg, tcfg = _cfgs("qwen2-1.5b")
    q, k, v = (_pair(_data(s, 1, 640, h, 16), dtype)
               for s, h in ((8, 4), (9, 2), (10, 2)))
    want = J_SDPA(q[0], k[0], v[0], jcfg, 0)
    got = TL._sdpa_causal(q[1], k[1], v[1], tcfg)
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert _rel(got, want) < tol
    # and the chunked form equals the materialized one on a 512-prefix
    exact = TL._sdpa_causal(*(t[:, :512].float() for t in (q[1], k[1], v[1])),
                            tcfg)
    chunked = TL._sdpa_causal_chunked(
        *(t[:, :512].float() for t in (q[1], k[1], v[1])), tcfg, chunk=128)
    assert float((chunked - exact).abs().max()) < 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_decode_matches_reference(dtype):
    jcfg, tcfg = _cfgs("chatglm3-6b")
    q = _pair(_data(11, 3, 1, 4, 16), dtype)
    kc, vc = (_pair(_data(s, 3, 12, 1, 16), dtype) for s in (12, 13))
    pos = np.asarray([0, 5, 11], np.int32)
    want = J_SDPA_DECODE(q[0], kc[0], vc[0], jnp.asarray(pos), jcfg)
    got = TL._sdpa_decode(q[1], kc[1], vc[1], torch.as_tensor(pos), tcfg)
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert _rel(got, want) < tol


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [64, 96, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference(causal, chunk, dtype):
    """200 positions (padded in every chunk size), a value width unlike the
    key width, as MLA gives."""
    q, k = (_pair(_data(s, 1, 2, 200, 8, scale=0.5), dtype) for s in (14, 15))
    v = _pair(_data(16, 1, 2, 200, 12), dtype)
    want = J_FLASH(q[0], k[0], v[0], causal, chunk)
    got = TF.flash_attention(q[1], k[1], v[1], causal, chunk)
    tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
    assert got.dtype == q[1].dtype and _rel(got, want) < tol


def test_flash_forward_residual_matches_reference():
    q, k, v = (_pair(_data(s, 1, 2, 130, 8, scale=0.5), "float32")
               for s in (17, 18, 19))
    _, (*_, jlse, _) = J_FLASH_FWD(q[0], k[0], v[0], True, 64)
    _, lse = TF._flash_fwd(q[1], k[1], v[1], True, 64)
    assert _rel(lse, jlse) < LAYER_TOL


# ---------------------------------------------------------------------------
# the KV cache: int8 codes, writes, the clamp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_reference(dtype):
    jcfg, tcfg = _cfgs("chatglm3-6b", kv_cache_bits=8)
    x = _pair(_data(20, 2, 3, 2, 32, scale=3.0), dtype)
    want = JL.maybe_quantize_kv(x[0], jcfg)  # op by op: see the docstring
    got = TL.maybe_quantize_kv(x[1], tcfg)
    assert got["codes"].dtype == torch.int8
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        TL.dequantize_kv(got, x[1].dtype).float().numpy(),
        np.asarray(JL.dequantize_kv(want, x[0].dtype).astype(jnp.float32)))
    assert TL.maybe_quantize_kv(x[1], tcfg.replace(kv_cache_bits=0)) is x[1]


@pytest.mark.parametrize("bits", [0, 8])
def test_init_kv_cache_matches_reference(bits):
    jcfg, tcfg = _cfgs("chatglm3-6b", kv_cache_bits=bits)
    want = JL.init_kv_cache(jcfg, 2, 5, jnp.bfloat16)
    got = TL.init_kv_cache(tcfg, 2, 5, torch.bfloat16)
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.float().numpy(), np.asarray(w.astype(jnp.float32))), want, got)


@pytest.mark.parametrize("pos", [[0, 3], [4, 7], [9, 100], [-1, -3],
                                 [-8, -20]])
@pytest.mark.parametrize("quantized", [False, True])
def test_cache_write_clamps_as_reference(pos, quantized):
    """``dynamic_update_slice`` places its start so: a negative position
    counts from the end once, then the start clamps into [0, 7] (max_seq =
    8); a position at or past 8 writes the last slot."""
    buf = _data(21, 2, 8, 2, 4)
    new = _data(22, 2, 1, 2, 4)
    pos = np.asarray(pos, np.int32)
    if quantized:
        cfg = _cfgs("chatglm3-6b", kv_cache_bits=8)
        jb = JL.maybe_quantize_kv(jnp.asarray(buf), cfg[0])
        jn = JL.maybe_quantize_kv(jnp.asarray(new), cfg[0])
        tb, tn = _to_torch(jb), _to_torch(jn)
    else:
        jb, jn = jnp.asarray(buf), jnp.asarray(new)
        tb, tn = torch.as_tensor(buf), torch.as_tensor(new)
    want = J_CACHE_WRITE(jb, jn, jnp.asarray(pos))
    got = TL._cache_write(tb, tn, torch.as_tensor(pos))
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.numpy(), np.asarray(w)), want, got)
    if not quantized:  # the write is a copy: the input stays as it was
        assert torch.equal(tb, torch.as_tensor(buf))


# ---------------------------------------------------------------------------
# Taylor-softmax linear attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_taylor_linear_attention_matches_reference(dtype):
    """40 positions in chunks of 16 (the last one padded)."""
    s, chunk = 40, 16
    q, k = (_pair(_data(sd, 2, s, 4, 8, scale=0.5), dtype) for sd in (23, 24))
    v = _pair(_data(25, 2, s, 4, 8), dtype)
    kv = tuple(t[:, :, :2] for t in k), tuple(t[:, :, :2] for t in v)
    for kk, vv in ((k, v), kv):  # MHA and GQA
        want = J_TAYLOR_LINEAR(q[0], kk[0], vv[0], chunk)
        got = TL.taylor_linear_attention(q[1], kk[1], vv[1], chunk)
        tol = LAYER_TOL if dtype == "float32" else BF16_LAYER_TOL
        assert got.dtype == q[1].dtype and _rel(got, want) < tol


def test_taylor_linear_decode_matches_reference():
    jcfg, tcfg = _cfgs("qwen2-1.5b", dtype="float32",
                       attention_impl="taylor_linear")
    jp, tp = _params("qwen2-1.5b")
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    ta = layer_params(tp["blocks"]["attn"], 0)
    x = _data(26, 2, 5, jcfg.d_model, scale=0.3)
    jc = JL.init_taylor_linear_cache(jcfg, 2, jnp.float32)
    tc = TL.init_taylor_linear_cache(tcfg, 2, torch.float32)
    for t in range(3):
        pos = np.full((2,), t, np.int32)
        want, jc = J_TL_DECODE(ja, jnp.asarray(x[:, t:t + 1]), jcfg,
                               cache=jc, pos=jnp.asarray(pos))
        got, tc = TL.taylor_linear_decode(ta, torch.as_tensor(x[:, t:t + 1]),
                                          tcfg, cache=tc,
                                          pos=torch.as_tensor(pos))
        assert _rel(got, want) < LAYER_TOL
    for name in ("s_kv", "s_k"):
        assert _rel(tc[name], jc[name]) < LAYER_TOL
    # the full attention with the Taylor impl: the linear form in prefill
    y = _data(27, 2, 20, jcfg.d_model, scale=0.3)
    want, _ = J_ATTENTION(ja, jnp.asarray(y), jcfg)
    got, _ = TL.attention(ta, torch.as_tensor(y), tcfg)
    assert _rel(got, want) < LAYER_TOL


# ---------------------------------------------------------------------------
# the whole models
# ---------------------------------------------------------------------------


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{path}[{key!r}]").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{path}[{i}]").items()}
    return {path: tree}


def _check_layout(arch, scan_layers):
    """The port's seeded init has the reference's tree (stacked or a list of
    layers), shapes, dtypes and scales; its caches the reference's too."""
    jcfg, tcfg = _cfgs(arch, scan_layers=scan_layers)
    jp, _ = _params(arch, scan_layers)
    tp = TT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = _flat(tp)
    assert set(tflat) == set(jflat)
    for name, leaf in tflat.items():
        want = np.asarray(jflat[name])
        assert tuple(leaf.shape) == want.shape and leaf.dtype == torch.float32
        if np.all(want == want.flat[0]):  # constants: equal
            assert torch.equal(leaf, torch.tensor(want)), name
        else:  # seeded draws: same scale
            assert 0.8 < float(leaf.std()) / float(want.std()) < 1.25, name
    want = JT.init_caches(jcfg, 2, 6)
    got = TT.init_caches(tcfg, 2, 6, device="cpu")
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.float().numpy(), np.asarray(w.astype(jnp.float32))), want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_layout(arch):
    _check_layout(arch, scan_layers=True)


def _batch(cfg):
    """One batch for forward, loss and prefill: tokens, labels, a mask that
    drops the tail of the second row, and for the VLM patch embeddings."""
    tok, pe = _inputs(cfg)
    labels = np.random.default_rng(2).integers(0, cfg.vocab_size, tok.shape)
    mask = (np.arange(SEQ)[None] < np.asarray([[SEQ], [SEQ - 5]])).astype(
        np.float32)
    return tok, pe, labels, mask


def _reference_all(params, tok, labels, mask, pe, cfg):
    batch = {"tokens": tok, "labels": labels, "mask": mask}
    if pe is not None:
        batch["patch_embeds"] = pe
    return (JT.forward(params, tok, cfg, patch_embeds=pe),
            JT.loss_fn(params, batch, cfg),
            JT.prefill(params, tok, cfg, patch_embeds=pe))


J_ALL = _jit(_reference_all, static_argnums=(5,))
_REFERENCE = {}


def _reference(arch, dtype):
    """The reference's forward, loss and prefill on ``_batch`` (one compiled
    program per config, made once)."""
    if (arch, dtype) not in _REFERENCE:
        jcfg, _ = _cfgs(arch, dtype=dtype)
        tok, pe, labels, mask = _batch(jcfg)
        _REFERENCE[arch, dtype] = J_ALL(
            _params(arch)[0], jnp.asarray(tok), jnp.asarray(labels),
            jnp.asarray(mask), None if pe is None else jnp.asarray(pe), jcfg)
    return _REFERENCE[arch, dtype]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    _, tp = _params(arch)
    tok, pe, _, _ = _batch(jcfg)
    (want, jaux), _, _ = _reference(arch, dtype)
    got, aux = TT.forward(tp, tok, tcfg, patch_embeds=pe)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, SEQ + jcfg.n_patches, jcfg.vocab_size)
    if dtype == "float32":
        assert _rel(got, want) < F32_TOL
        assert abs(float(aux) - float(jaux)) <= 1e-5 * max(1.0, float(jaux))
    elif arch not in MOE:
        assert _rel(got, want) < BF16_TOL


def _bf16(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("decode", [False, True])
def test_moe_sublayers_bf16_match_reference(arch, decode):
    """bf16 MoE configs, layer by layer and sublayer by sublayer: the
    attention (MLA for deepseek-v2, with its cache when decoding) and the
    MoE FFN of the port and of the reference, each on the reference's own
    input, the reference's block output carried to the next layer.  Given
    the same bf16 input, the router's float32 logits pick the same experts
    in both packages."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp, tp = _params(arch)
    tok, _ = _inputs(jcfg)
    x = JT._embed(jp, jnp.asarray(tok[:, :1] if decode else tok), jcfg)
    jcache = JT.init_caches(jcfg, 2, 4)
    pos = np.full((2,), 0, np.int32)
    for i in range(jcfg.n_layers):
        jb = jax.tree.map(lambda a: a[i], jp["blocks"])
        tb = layer_params(tp["blocks"], i)
        kw, tkw = {}, {}
        if decode:
            c = jax.tree.map(lambda a: a[i], jcache)
            kw = dict(pos=jnp.asarray(pos), cache=c)
            tkw = dict(pos=torch.as_tensor(pos), cache=_to_torch(c))
        h = JL.norm(jb["ln1"], x, jcfg)
        jattn, tattn = ((J_MLA, TM.mla_attention) if jcfg.mla
                        else (J_ATTENTION, TL.attention))
        att, jnew = jattn(jb["attn"], h, jcfg, **kw)
        got, tnew = tattn(tb["attn"], _bf16(h), tcfg, **tkw)
        assert _rel(got, att) < BF16_TOL
        if decode:
            jax.tree.map(lambda w, g: _rel(g, w) < BF16_TOL or pytest.fail(
                "cache"), jnew, tnew)
        h2 = JL.norm(jb["ln2"], x + att, jcfg).reshape(-1, jcfg.d_model)
        want, jaux = J_MOE(jb["moe"], h2, jcfg)
        got, aux = TL.moe_ffn(tb["moe"], _bf16(h2), tcfg)
        assert _rel(got, want) < BF16_TOL
        assert abs(float(aux) - float(jaux)) < 1e-5 * float(jaux)
        x = J_BLOCK(jb, x, jcfg, **kw)[0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    _, tp = _params(arch)
    tok, pe, labels, mask = _batch(jcfg)
    tb = {"tokens": tok, "labels": labels, "mask": mask}
    if pe is not None:
        tb["patch_embeds"] = torch.as_tensor(pe)
    _, (want, jm), _ = _reference(arch, dtype)
    got, m = build_model(tcfg, device="cpu").loss_fn(tp, tb)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    for k in ("loss", "ce", "aux"):
        assert abs(float(m[k]) - float(jm[k])) <= tol * max(1.0, float(jm[k]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    _, tp = _params(arch)
    tok, pe, _, _ = _batch(jcfg)
    inputs = {} if pe is None else {"patch_embeds": pe}
    _, _, want = _reference(arch, dtype)
    got = build_model(tcfg, device="cpu").prefill(tp, tokens=tok, **inputs)
    assert tuple(got.shape) == (2, 1, jcfg.vocab_size)
    if dtype == "float32":
        assert _rel(got, want) < F32_TOL
    elif arch not in MOE:
        assert _rel(got, want) < BF16_TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(arch, dtype):
    """8 positions one token at a time from zeroed caches; the logits of
    every step and the final caches (MLA latents for deepseek-v2)."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp, tp = _params(arch)
    tok, _ = _inputs(jcfg, seed=4, s=8)
    jc = JT.init_caches(jcfg, 2, 8)
    tc = build_model(tcfg, device="cpu").init_caches(2, 8)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(8):
        pos = np.full((2,), t, np.int32)
        want, jc = J_DECODE(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                            jnp.asarray(pos), jcfg)
        got, tc = TT.decode_step(tp, tc, tok[:, t:t + 1], pos, tcfg)
        if dtype == "float32" or arch not in MOE:
            assert _rel(got, want) < tol
    if dtype == "float32" or arch not in MOE:
        jax.tree.map(lambda w, g: _rel(g, w) < tol or pytest.fail("cache"),
                     jc, tc)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b"])
def test_list_layout_matches_reference(arch):
    """``scan_layers=False``: parameters and caches as lists of layers."""
    _check_layout(arch, scan_layers=False)
    jcfg, tcfg = _cfgs(arch, dtype="float32", scan_layers=False)
    jp, tp = _params(arch, scan_layers=False)
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    tok, _ = _inputs(jcfg, seed=5, s=6)
    want, _ = J_FORWARD(jp, jnp.asarray(tok), jcfg)
    got, _ = TT.forward(tp, tok, tcfg)
    assert _rel(got, want) < F32_TOL
    jc, tc = JT.init_caches(jcfg, 2, 6), TT.init_caches(tcfg, 2, 6,
                                                        device="cpu")
    assert isinstance(tc, list)
    for t in range(3):
        pos = np.full((2,), t, np.int32)
        want, jc = J_DECODE(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                            jnp.asarray(pos), jcfg)
        got, tc = TT.decode_step(tp, tc, tok[:, t:t + 1], pos, tcfg)
        assert isinstance(tc, list) and _rel(got, want) < F32_TOL


def test_int8_kv_cache_carried_across():
    """chatglm3 with the int8 KV cache: the reference decodes 4 positions,
    its caches ({"codes", "scale"} dicts) are converted, and both packages
    decode 4 more from there; codes equal, logits within float32's 1e-4."""
    jcfg, tcfg = _cfgs("chatglm3-6b", dtype="float32", kv_cache_bits=8)
    jp, tp = _params("chatglm3-6b")
    tok, _ = _inputs(jcfg, seed=6, s=8)
    jc = JT.init_caches(jcfg, 2, 8)
    for t in range(4):
        _, jc = J_DECODE(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                         jnp.full((2,), t, jnp.int32), jcfg)
    tc = _to_torch(jc)
    assert tc["k"]["codes"].dtype == torch.int8
    for t in range(4, 8):
        pos = np.full((2,), t, np.int32)
        want, jc = J_DECODE(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                            jnp.asarray(pos), jcfg)
        got, tc = TT.decode_step(tp, tc, tok[:, t:t + 1], pos, tcfg)
        assert _rel(got, want) < F32_TOL
    np.testing.assert_array_equal(tc["v"]["codes"].numpy(),
                                  np.asarray(jc["v"]["codes"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Token-by-token decode logits == full-sequence forward logits in the
    port, within the reference's 0.03 (MoE at its dropless capacity)."""
    _, tcfg = _cfgs(arch)
    if tcfg.n_experts:
        tcfg = tcfg.replace(moe_capacity_factor=float(tcfg.n_experts))
    _, tp = _params(arch)
    model = build_model(tcfg, device="cpu")
    tok, _ = _inputs(tcfg, seed=7, s=8)
    full, _ = TT.forward(tp, tok, tcfg)
    caches = model.init_caches(2, 8)
    outs = []
    for t in range(8):
        logits, caches = model.decode_step(tp, caches, tok[:, t:t + 1],
                                           np.full((2,), t, np.int32))
        outs.append(logits[:, 0])
    dec, full = torch.stack(outs, dim=1).float(), full.float()
    assert float((dec - full).abs().max() / full.abs().max()) < DECODE_TOL


def test_build_model_serves_the_transformer_families():
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        model = build_model(cfg, device="cpu")
        assert model.device == torch.device("cpu")
        p = model.init(torch.Generator().manual_seed(0))
        assert p["embed"].shape == (cfg.vocab_size, cfg.d_model)


# ---------------------------------------------------------------------------
# serving: the LM server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_lm_server_greedy_tokens_match_reference(arch):
    """5 prompt tokens + 5 greedy ones decode 9 positions into max_seq = 8
    slots: the last position writes the last slot in both packages."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    jp, tp = _params(arch)
    prompt = _inputs(jcfg, seed=8, s=5)[0]
    jsrv = JLMServer(jcfg, batch=2, max_seq=8)
    jsrv.install("m", jp)
    want = jsrv.generate("m", prompt, 5)
    srv = LMServer(tcfg, batch=2, max_seq=8, device="cpu")
    srv.install("m", tp)
    got = srv.generate("m", prompt, 5)
    assert got.dtype == np.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_lm_server_trace_count_flat_across_install():
    """A same-structure install is a hot swap: ``trace_count`` stays at 1;
    a decode past max_seq writes the last cache slot, as the reference's."""
    _, tcfg = _cfgs("qwen2-1.5b", dtype="float32")
    _, tp = _params("qwen2-1.5b")
    srv = LMServer(tcfg, batch=2, max_seq=8, device="cpu")
    srv.install("m", tp)
    prompt = _inputs(tcfg, seed=9, s=4)[0]
    first = srv.generate("m", prompt, 6)  # positions 0..8: one past the end
    other = TT.init(torch.Generator().manual_seed(1), tcfg, device="cpu")
    srv.install("m", other)
    second = srv.generate("m", prompt, 6)
    assert srv.trace_count == 1 and srv.registry.swaps == 2
    assert not np.array_equal(first, second)
    srv.install("q", tq.quantize_tree(other))  # another structure
    srv.generate("q", prompt, 2)
    assert srv.trace_count == 2


# ---------------------------------------------------------------------------
# the paper's numerics: the quantized prefill, the quant modes
# ---------------------------------------------------------------------------


def test_quantized_prefill_matches_reference():
    """quantize_tree's (codes, scale) pairs run the integer datapath in
    every projection (7 per layer); the port quantizes the converted float
    tree to the reference's codes and scales, bit for bit."""
    jcfg, tcfg = _cfgs("qwen2-1.5b", dtype="float32")
    jp, tp = _params("qwen2-1.5b")
    jqp, tqp = jq.quantize_tree(jp), tq.quantize_tree(tp)
    converted = _to_torch(jqp)
    got_leaves, conv_leaves = _flat(tqp), _flat(converted)
    assert set(got_leaves) == set(conv_leaves)
    pairs = [k for k, v in got_leaves.items() if "[0]" in k[-3:]]
    assert len(pairs) == 7  # wq wk wv wo up gate down, stacked over layers
    for k, v in got_leaves.items():
        assert torch.equal(v, conv_leaves[k]), k
    tok, _ = _inputs(jcfg, seed=10)
    want = J_PREFILL(jqp, jnp.asarray(tok), jcfg)
    got = build_model(tcfg, device="cpu").prefill(tqp, tokens=tok)
    assert _rel(got, want) < QUANT_TOL
    fp = build_model(tcfg, device="cpu").prefill(tp, tokens=tok).float()
    nmse = float(((fp - got.float()) ** 2).mean() / (fp ** 2).mean())
    assert nmse < 0.15


@pytest.mark.parametrize("mode", ["w8a8_sim", "w8a8_int"])
def test_quant_modes_match_reference(mode):
    jcfg, tcfg = _cfgs("qwen2-1.5b", dtype="float32", quant_mode=mode)
    jp, tp = _params("qwen2-1.5b")
    tok, _ = _inputs(jcfg, seed=11)
    want = J_PREFILL(jp, jnp.asarray(tok), jcfg)
    got = build_model(tcfg, device="cpu").prefill(tp, tokens=tok)
    assert _rel(got, want) < QUANT_TOL
    fp = TT.prefill(tp, tok, tcfg.replace(quant_mode="fp")).float()
    nmse = float(((fp - got.float()) ** 2).mean() / (fp ** 2).mean())
    assert nmse < 0.15
