"""The port's MoE FFN and Multi-head Latent Attention against the JAX
reference on the CPU, reduced (d_model 128; granite-moe: 8 experts, top-2;
deepseek-v2: 8 experts, top-2, one shared expert, q_lora 64, kv_lora 64),
with the reference's own ``init_moe``/``init_mla`` carried across by
``params_from_numpy``; and the two reference faults of the quantized trees
(R8: no integer MoE, R9: no integer absorbed MLA decode), pinned on both
packages.

Tolerances, each with its reason (relative: max |Δ| over the largest
reference value):

  * Exact: the top-k indices (ties go to the lower index in both), the
    converted trees.
  * Float32 MoE output: 1e-5; the aux loss: 1e-6.  The routing is the same
    (the router's logits are float32 products of the same inputs), and the
    expert GEMMs and the combine sum in another order.
  * Bfloat16 MoE output: 2e-2, two bf16 steps (XLA keeps excess precision
    through fused elementwise chains, PyTorch rounds every op).
  * Float32 MLA, expanded and absorbed: 1e-5 (float32 ``exp``, ``cos`` and
    ``sin`` differ in the last bits); bfloat16: 2e-2.
  * The port's absorbed decode against its own expanded form: 2e-3, the
    reference's tolerance (``tests/test_models_deep.py:41``).
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
from repro.models import layers as JL
from repro.models import mla as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.core import quantize as tq
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import mla as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import layer_params

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 2e-2
ABSORBED_TOL = 2e-3

# The reference's functions, compiled once per config (cfg is static), at
# XLA's lowest LLVM optimisation level without its expensive passes: the
# same HLO and the same IEEE float operations (no fast math either way),
# compiled ≈3× faster on the CPU, where the compile is most of these
# tests' time.
_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                               "xla_llvm_disable_expensive_passes": True})
J_MOE = _jit(JL.moe_ffn, static_argnums=(2,))
J_MLA = _jit(JM.mla_attention, static_argnums=(2,))
J_INIT = _jit(JT.init, static_argnums=(1,))
J_PREFILL = _jit(JT.prefill, static_argnums=(2,))
J_QUANTIZE = _jit(jq.quantize_tree, static_argnames=("skip",))


def _rel(got, want) -> float:
    got = np.asarray(got.float().detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _cfgs(arch, **kw):
    return (jreduced(jget_config(arch)).replace(remat=False, **kw),
            reduced(get_config(arch)).replace(remat=False, **kw))


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _pair(x, dtype):
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _data(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


_MOE = {}


def _moe(arch):
    if arch not in _MOE:
        jcfg, _ = _cfgs(arch)
        jp = _jit(JL.init_moe, static_argnums=(1,))(jax.random.key(1),
                                                       jcfg)
        _MOE[arch] = (jp, _to_torch(jp))
    return _MOE[arch]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def test_top_k_breaks_ties_as_reference():
    """``jax.lax.top_k`` gives the lower index first among equal values;
    the port's top-k sorts stably, so it does too."""
    x = np.asarray([[0.2, 0.3, 0.2, 0.3, 0.0, 0.3, 0.1, 0.2],
                    [0.125] * 8, [0.0, 0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0]],
                   np.float32)
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TL._top_k(torch.as_tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_tree_converts_with_expert_stacks():
    jp, tp = _moe("deepseek-v2-236b")
    assert tp["w_gate"].shape == (8, 128, 64) and "shared" in tp
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.numpy(), np.asarray(w)), jp, tp)
    got = TL.init_moe(torch.Generator().manual_seed(0), _cfgs(
        "deepseek-v2-236b")[1], lead=(3,))
    assert got["w_down"].shape == (3, 8, 64, 128)
    assert got["shared"]["gate"]["w"].shape == (3, 128, 64)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
@pytest.mark.parametrize("capacity", [0.1, 1.25, 8.0])
@pytest.mark.parametrize("t", [48, 600])
def test_moe_ffn_matches_reference(arch, capacity, t):
    """Tight (drops), the default and loose capacity; one group of 48
    tokens, and 600 tokens in two groups of 512 (the second right-padded)."""
    jcfg, tcfg = _cfgs(arch, dtype="float32", moe_capacity_factor=capacity)
    jp, tp = _moe(arch)
    x = _data(t, t, jcfg.d_model, scale=0.7)
    want, jaux = J_MOE(jp, jnp.asarray(x), jcfg)
    got, aux = TL.moe_ffn(tp, torch.as_tensor(x), tcfg)
    assert _rel(got, want) < TOL
    assert abs(float(aux) - float(jaux)) < 1e-6 * float(jaux)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_moe_ffn_bf16_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp, tp = _moe(arch)
    x = _pair(_data(7, 48, jcfg.d_model, scale=0.7), "bfloat16")
    want, jaux = J_MOE(jp, x[0], jcfg)
    got, aux = TL.moe_ffn(tp, x[1], tcfg)
    assert got.dtype == torch.bfloat16 and _rel(got, want) < BF16_TOL
    assert abs(float(aux) - float(jaux)) < 1e-6 * float(jaux)


def test_moe_router_follows_the_taylor_softmax():
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", dtype="float32",
                       attention_impl="taylor_linear")
    jp, tp = _moe("granite-moe-3b-a800m")
    x = _data(8, 32, jcfg.d_model, scale=0.7)
    want, jaux = J_MOE(jp, jnp.asarray(x), jcfg)
    got, aux = TL.moe_ffn(tp, torch.as_tensor(x), tcfg)
    assert _rel(got, want) < TOL
    assert abs(float(aux) - float(jaux)) < 1e-6 * float(jaux)
    exact, _ = TL.moe_ffn(tp, torch.as_tensor(x), tcfg.replace(
        attention_impl="full"))
    assert float((exact - got).abs().max()) > 1e-4


def test_moe_routing_capacity_and_aux_behave():
    """Permuting the experts changes the output; a tight capacity drops
    tokens; a router pinned on one expert raises the aux loss."""
    _, tcfg = _cfgs("granite-moe-3b-a800m", dtype="float32")
    _, tp = _moe("granite-moe-3b-a800m")
    x = torch.as_tensor(_data(9, 64, tcfg.d_model))
    out, aux = TL.moe_ffn(tp, x, tcfg)
    perm = dict(tp, w_down=tp["w_down"].flip(0))
    assert float((TL.moe_ffn(perm, x, tcfg)[0] - out).abs().max()) > 1e-4
    tight, _ = TL.moe_ffn(tp, x, tcfg.replace(moe_capacity_factor=0.1))
    loose, _ = TL.moe_ffn(tp, x, tcfg.replace(moe_capacity_factor=8.0))
    assert float((tight - loose).abs().max()) > 1e-5
    w = torch.zeros_like(tp["router"]["w"])
    w[:, 0] = 10.0
    _, bad = TL.moe_ffn(dict(tp, router={"w": w}), x, tcfg)
    assert float(bad) > float(aux)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


_MLA = {}


def _mla(q_lora=True):
    if q_lora not in _MLA:
        jcfg, _ = _cfgs("deepseek-v2-236b", **({} if q_lora else dict(
            q_lora_rank=0)))
        jp = JM.init_mla(jax.random.key(2), jcfg)
        _MLA[q_lora] = (jp, _to_torch(jp))
    return _MLA[q_lora]


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_tree_converts_and_inits_alike(q_lora):
    kw = {} if q_lora else dict(q_lora_rank=0)
    _, tcfg = _cfgs("deepseek-v2-236b", **kw)
    jp, tp = _mla(q_lora)
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        g.numpy(), np.asarray(w)), jp, tp)
    mine = TM.init_mla(torch.Generator().manual_seed(0), tcfg)
    jax.tree.map(lambda w, g: g.shape == w.shape or pytest.fail("shape"),
                 tp, mine)
    c = TM.init_mla_cache(tcfg, 1, 10, torch.float32)
    # the cache holds kv_lora + rope values per token
    assert c["ckv"].shape[-1] + c["krope"].shape[-1] == 64 + 16


@pytest.mark.parametrize("s", [6, 520])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_expanded_matches_reference(s, dtype, q_lora):
    """Causal over 6 positions, and over 520 (the flash route: two blocks
    of 512, the second padded, with dv ≠ dk)."""
    kw = {} if q_lora else dict(q_lora_rank=0)
    jcfg, tcfg = _cfgs("deepseek-v2-236b", dtype=dtype, **kw)
    jp, tp = _mla(q_lora)
    x = _pair(_data(s, 1, s, jcfg.d_model, scale=0.5), dtype)
    want, _ = J_MLA(jp, x[0], jcfg)
    got, cache = TM.mla_attention(tp, x[1], tcfg)
    assert cache is None and got.dtype == x[1].dtype
    assert _rel(got, want) < (TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_reference(dtype):
    jcfg, tcfg = _cfgs("deepseek-v2-236b", dtype=dtype)
    jp, tp = _mla()
    x = _data(11, 2, 6, jcfg.d_model, scale=0.3)
    jc = JM.init_mla_cache(jcfg, 2, 6, jnp.dtype(dtype))
    tc = TM.init_mla_cache(tcfg, 2, 6, getattr(torch, dtype))
    tol = TOL if dtype == "float32" else BF16_TOL
    for t in range(6):
        pos = np.full((2,), t, np.int32)
        xs = _pair(x[:, t:t + 1], dtype)
        want, jc = J_MLA(jp, xs[0], jcfg, pos=jnp.asarray(pos), cache=jc)
        got, tc = TM.mla_attention(tp, xs[1], tcfg, pos=torch.as_tensor(pos),
                                   cache=tc)
        assert _rel(got, want) < tol
    for name in ("ckv", "krope"):
        assert _rel(tc[name], jc[name]) < tol


def test_mla_absorbed_equals_expanded():
    """The serving-time absorbed form equals the expanded training form
    position by position, within the reference's 2e-3."""
    _, tcfg = _cfgs("deepseek-v2-236b", dtype="float32")
    _, tp = _mla()
    x = torch.as_tensor(_data(12, 2, 6, tcfg.d_model, scale=0.3))
    full, _ = TM.mla_attention(tp, x, tcfg)
    cache = TM.init_mla_cache(tcfg, 2, 6, torch.float32)
    outs = []
    for t in range(6):
        o, cache = TM.mla_attention(tp, x[:, t:t + 1], tcfg,
                                    pos=torch.full((2,), t), cache=cache)
        outs.append(o[:, 0])
    dec = torch.stack(outs, dim=1)
    assert float((dec - full).abs().max() / full.abs().max()) < ABSORBED_TOL


# ---------------------------------------------------------------------------
# reference faults R8 and R9: quantized trees
# ---------------------------------------------------------------------------


_MODELS = {}


def _quantized_model(arch, **skip):
    """The reference's init of the reduced ``arch``, quantized by both
    packages' ``quantize_tree`` (the float init made once)."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    if arch not in _MODELS:
        jp = J_INIT(jax.random.key(0), jcfg)
        _MODELS[arch] = (jp, _to_torch(jp))
    jp, tp = _MODELS[arch]
    return jcfg, tcfg, J_QUANTIZE(jp, **skip), tq.quantize_tree(tp, **skip)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_quantized_moe_refused_r8(arch):
    """R8: ``quantize_tree`` quantizes the MoE router's ``['w']`` and the
    expert stacks; the reference's prefill then fails on the router's pair
    (a ``TracerArrayConversionError`` at its einsum), and the port refuses
    with a ``ValueError`` naming the leaf, on prefill and on decode (where
    deepseek-v2's absorbed MLA refuses first, R9).  With the router kept
    float, both still fail, now on the expert stacks: the reference with
    an ``AttributeError`` ('tuple' object has no attribute 'astype')."""
    jcfg, tcfg, jqp, tqp = _quantized_model(arch)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 8))
    with pytest.raises(jax.errors.TracerArrayConversionError):
        J_PREFILL(jqp, jnp.asarray(tok), jcfg)
    with pytest.raises(ValueError, match=r"\['router'\]\['w'\]"):
        build_model(tcfg, device="cpu").prefill(tqp, tokens=tok)
    caches = TT.init_caches(tcfg, 2, 8, device="cpu")
    first = r"\['wk_b'\]" if tcfg.mla else r"\['router'\]\['w'\]"
    with pytest.raises(ValueError, match=first):
        TT.decode_step(tqp, caches, tok[:, :1], np.zeros(2, np.int32), tcfg)

    def router(path):
        return "router" in path

    jcfg, tcfg, jqp, tqp = _quantized_model(arch, skip=router)
    assert not isinstance(tqp["blocks"]["moe"]["router"]["w"], tuple)
    with pytest.raises(AttributeError, match="astype"):
        J_PREFILL(jqp, jnp.asarray(tok), jcfg)
    with pytest.raises(ValueError, match=r"\['w_gate'\]"):
        build_model(tcfg, device="cpu").prefill(tqp, tokens=tok)


def test_quantized_mla_absorbed_decode_refused_r9():
    """R9: the absorbed decode reads ``wk_b``/``wv_b`` as float matrices;
    on quantized pairs the reference fails with an ``AttributeError``
    ('tuple' object has no attribute 'astype') and the port refuses with a
    ``ValueError`` naming the leaf.  The expanded form runs the integer
    datapath in both and agrees."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b", dtype="float32")
    jp, tp = _mla()
    jqp, tqp = J_QUANTIZE(jp), tq.quantize_tree(tp)
    assert isinstance(tqp["wk_b"]["w"], tuple)
    x = _data(13, 2, 1, jcfg.d_model, scale=0.3)
    pos = np.zeros(2, np.int32)
    with pytest.raises(AttributeError, match="astype"):
        J_MLA(jqp, jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
              cache=JM.init_mla_cache(jcfg, 2, 4, jnp.float32))
    with pytest.raises(ValueError, match=r"\['wk_b'\]\['w'\]"):
        TM.mla_attention(tqp, torch.as_tensor(x), tcfg,
                         pos=torch.as_tensor(pos),
                         cache=TM.init_mla_cache(tcfg, 2, 4, torch.float32))
    y = _data(14, 2, 5, jcfg.d_model, scale=0.3)
    want, _ = J_MLA(jqp, jnp.asarray(y), jcfg)
    got, _ = TM.mla_attention(tqp, torch.as_tensor(y), tcfg)
    assert _rel(got, want) < 2e-2  # an int8 code may round the other way


def test_moe_layer_params_slice_keeps_pairs():
    """``layer_params`` slices a stacked quantized tree into per-layer
    (codes, scale) pairs with K-major codes, as the W8A8 GEMM reads them."""
    _, tcfg, _, tqp = _quantized_model("qwen2-1.5b")
    one = layer_params(tqp["blocks"], 1)
    codes, scale = one["mlp"]["up"]["w"]
    assert codes.shape == (128, 256) and codes.stride() == (1, 128)
    assert scale.shape == (1, 256)
