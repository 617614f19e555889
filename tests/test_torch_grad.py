"""Gradients of the port against the JAX reference on the CPU: flash
attention's hand-written backward against ``jax.vjp`` of the reference's
``custom_vjp``, the chunked cross-entropy's gradient, and
``build_model(cfg).loss_fn``'s gradients against ``jax.grad`` for every
family (dense, MoE, MoE with MLA, VLM, RWKV-6, the hybrid, the
encoder–decoder, and dense with ``w8a8_sim`` and segmented Taylor
activations), reduced to 2 layers (deepseek-v2: 1; zamba2: one group) in
float32, on the reference's own ``init`` carried across by
``params_from_numpy``.  Also: remat changes no gradient, and the WKV
kernel's wrapper refuses autograd (P4).

Tolerances (max |Δ| over the largest reference magnitude):

  * flash attention, float32: 1e-5 (measured ≤ 1e-6); bfloat16: 2e-2.  The
    bfloat16 reference is compiled with ``xla_allow_excess_precision``
    off, so that XLA rounds the einsums' bf16 results as written, as
    PyTorch does (with it on, XLA drops the bf16 round trip of the logits
    and the two differ by up to 3e-2; with it off they are bit-equal).
  * the chunked cross-entropy's gradient: 1e-6.
  * the models' gradients: every leaf within 1e-4 of its own largest |g|
    (measured ≤ 2.2e-6), RWKV-6 within 2e-3.  The reference's chunked WKV
    rounds the cotangents of its bf16 chunk operands to bf16 (each use's,
    summed in bf16), and so does the port; alone, the WKV's gradients agree
    within 1e-6 (dv bit for bit).  Inside the model, a last-bit float32
    difference in the cotangent arriving from the layer above moves some
    elements across a bf16 rounding boundary, one bf16 step (2^-8) each:
    measured 8.4e-4 of the largest |g| in the lower layer's decay LoRA,
    3e-5 in the top layer.
  * remat on against off: equal (the recomputation repeats the same
    operations on the same inputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import losses as JLoss
from repro.models import build_model as jbuild_model
from repro.models import flash as JF
from repro.models import rwkv6 as JR
from repro_torch.configs import get_config, reduced
from repro_torch.core import losses as TLoss
from repro_torch.core import tree as T
from repro_torch.kernels import ops
from repro_torch.models import build_model, layers, params_from_numpy, rwkv6
from repro_torch.models import flash as TF

torch.set_num_threads(1)

GRAD_TOL = 1e-4
RWKV_GRAD_TOL = 2e-3

_OPTS = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
_jit = functools.partial(jax.jit, compiler_options=_OPTS)
_jit_exact = functools.partial(
    jax.jit, compiler_options={**_OPTS, "xla_allow_excess_precision": False})


def _rel(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# flash attention's backward
# ---------------------------------------------------------------------------


@functools.partial(_jit_exact, static_argnums=(4, 5))
def _flash_vjp(q, k, v, dout, causal, chunk):
    _, vjp = jax.vjp(lambda a, b, c: JF.flash_attention(a, b, c, causal,
                                                        chunk), q, k, v)
    return vjp(dout)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [48, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_reference_vjp(causal, s, dtype):
    """dq, dk, dv against ``jax.vjp`` of the reference's flash attention,
    chunk 16: S = 48 (3 whole blocks) and 40 (a padded last block)."""
    rng = np.random.default_rng(s + causal)
    q, k, v, do = (rng.normal(size=(2, 3, s, 8)).astype(np.float32)
                   for _ in range(4))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = _flash_vjp(*(jnp.asarray(x).astype(jd) for x in (q, k, v, do)),
                      causal, 16)
    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    out = TF.flash_attention(tq, tk, tv, causal, 16)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do).to(td))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == td
        assert _rel(g, w) < tol


def test_flash_backward_matches_autograd_of_plain_attention():
    """The hand-written backward against autograd through the materialized
    softmax attention in float64 (the flash form computes its logits and
    probabilities in float32: 1e-5)."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.normal(size=(1, 2, 37, 8)),
                            dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    do = torch.tensor(rng.normal(size=(1, 2, 37, 8)))
    got = torch.autograd.grad(TF.flash_attention(q, k, v, True, 16),
                              (q, k, v), do)
    logits = q @ k.transpose(-1, -2)
    logits = logits.masked_fill(~torch.ones(37, 37, dtype=torch.bool).tril(),
                                float("-inf"))
    plain = torch.softmax(logits, -1) @ v
    want = torch.autograd.grad(plain, (q, k, v), do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# the chunked cross-entropy
# ---------------------------------------------------------------------------


@functools.partial(_jit, static_argnums=(4,))
def _ce_grad(h, w, labels, mask, chunk):
    return jax.value_and_grad(JLoss.chunked_cross_entropy, argnums=(0, 1))(
        h, w, labels, mask, chunk)


@pytest.mark.parametrize("chunk", [None, 8])
def test_chunked_cross_entropy_gradient_matches_reference(chunk):
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 37, 16)).astype(np.float32)
    w = rng.normal(size=(16, 50)).astype(np.float32) * 0.3
    labels = rng.integers(0, 50, (2, 37)).astype(np.int32)
    mask = (rng.random((2, 37)) < 0.8).astype(np.float32)
    want_loss, (want_h, want_w) = _ce_grad(
        *(jnp.asarray(x) for x in (h, w, labels, mask)), chunk)
    th, tw = (torch.tensor(x, requires_grad=True) for x in (h, w))
    loss = TLoss.chunked_cross_entropy(th, tw, torch.tensor(labels),
                                       torch.tensor(mask), chunk)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    got_loss = float(loss.detach())
    assert abs(got_loss - float(want_loss)) / float(want_loss) < 1e-6
    assert _rel(gh, want_h) < 1e-6
    assert _rel(gw, want_w) < 1e-6


# ---------------------------------------------------------------------------
# loss_fn's gradients, every family
# ---------------------------------------------------------------------------

SEQ = 16
#: (case id, arch, config overrides, sequence length)
CASES = [
    ("qwen2", "qwen2-1.5b", {}, SEQ),
    ("qwen2-flash", "qwen2-1.5b", {}, 520),
    ("qwen2-w8a8-taylor", "qwen2-1.5b",
     {"quant_mode": "w8a8_sim", "taylor_order": 3, "taylor_segmented": True},
     SEQ),
    ("granite-moe", "granite-moe-3b-a800m", {}, SEQ),
    ("deepseek-v2", "deepseek-v2-236b", {"n_layers": 1}, SEQ),
    ("pixtral", "pixtral-12b", {}, SEQ),
    ("rwkv6", "rwkv6-3b", {}, SEQ),
    ("zamba2", "zamba2-2.7b", {"n_layers": 2}, SEQ),
    ("whisper", "whisper-base", {}, SEQ),
]


def _cfgs(arch, remat=False, **kw):
    kw = dict(dtype="float32", remat=remat, **kw)
    return (jreduced(jget_config(arch)).replace(**kw),
            reduced(get_config(arch)).replace(**kw))


def _batch(cfg, s):
    rng = np.random.default_rng(5)
    b = 1 if s > SEQ else 2
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)),
             "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _reference_grads(jcfg, batch):
    model = jbuild_model(jcfg)
    params = _jit(model.init)(jax.random.key(0))

    def loss(p, b):
        return model.loss_fn(p, b)[0]

    value, grads = _jit_exact(jax.value_and_grad(loss))(
        params, jax.tree.map(jnp.asarray, batch))
    return params, value, grads


def _port_grads(tcfg, params, batch):
    model = build_model(tcfg, device="cpu")
    live = T.map_leaves(lambda p: p.requires_grad_(), params)
    loss, _ = model.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, T.leaves(live))
    return loss.detach(), grads


@pytest.mark.parametrize("case,arch,over,s", CASES,
                         ids=[c[0] for c in CASES])
def test_loss_gradients_match_reference(case, arch, over, s):
    jcfg, tcfg = _cfgs(arch, **over)
    batch = _batch(tcfg, s)
    jparams, want_loss, want = _reference_grads(jcfg, batch)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    loss, got = _port_grads(tcfg, tparams, batch)
    assert abs(float(loss) - float(want_loss)) / float(want_loss) < 1e-5
    want_flat = jax.tree_util.tree_leaves_with_path(want)
    paths = [p for p, _ in T.leaves_with_paths(tparams)]
    assert paths == [jax.tree_util.keystr(p) for p, _ in want_flat]
    worst = {}
    for path, g, (_, w) in zip(paths, got, want_flat):
        worst[path] = _rel(g, w)
    tol = RWKV_GRAD_TOL if tcfg.family == "rwkv6" else GRAD_TOL
    bad = {p: e for p, e in worst.items() if not e < tol}
    assert not bad, (bad, max(worst.values()))


@functools.partial(_jit_exact, static_argnums=(6,))
def _wkv_vjp(r, k, v, logw, u, do, chunk):
    _, vjp = jax.vjp(lambda *x: JR._wkv_chunked(*x, chunk=chunk),
                     r, k, v, logw, u)
    return vjp(do)


@pytest.mark.parametrize("t,chunk", [(16, 64), (40, 16)])
def test_wkv_chunked_gradients_match_reference(t, chunk):
    """The chunked WKV's gradients against ``jax.vjp`` of the reference's
    ``_wkv_chunked`` on the same cotangent: dv bit for bit (its bf16
    cotangents rounded and summed as the reference's), the others 1e-6."""
    rng = np.random.default_rng(t)
    r, k, v, do = (rng.normal(size=(2, 4, t, 32)).astype(np.float32)
                   for _ in range(4))
    logw = -np.exp(rng.normal(size=(2, 4, t, 32)) - 2).astype(np.float32)
    u = (rng.normal(size=(4, 32)) * 0.1).astype(np.float32)
    want = _wkv_vjp(*(jnp.asarray(x) for x in (r, k, v, logw, u, do)), chunk)
    ts = [torch.tensor(x, requires_grad=True) for x in (r, k, v, logw, u)]
    got = torch.autograd.grad(rwkv6._wkv_chunked(*ts, chunk=chunk), ts,
                              torch.tensor(do))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-6


def test_unstack_layers_reads_the_first_layers_as_layer_params():
    """One read of each stacked leaf gives the trees ``layer_params`` gives
    for the first ``n`` layers (a config may run fewer layers than the
    stack holds); a stack of fewer layers raises."""
    tree = {"a": {"w": torch.arange(24.0).reshape(3, 2, 4)},
            "pair": (torch.ones((3, 2), dtype=torch.int8),
                     torch.arange(3.0)[:, None])}
    for n in (1, 3):
        got = layers.unstack_layers(tree, n)
        assert len(got) == n
        for i, t in enumerate(got):
            want = layers.layer_params(tree, i)
            assert type(t["pair"]) is tuple
            for a, b in zip(T.leaves(t), T.leaves(want)):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="layers"):
        layers.unstack_layers(tree, 4)


@pytest.mark.parametrize("arch,over", [
    ("qwen2-1.5b", {"n_layers": 4}), ("rwkv6-3b", {"n_layers": 4}),
    ("zamba2-2.7b", {}), ("whisper-base", {})])
def test_remat_changes_no_gradient(arch, over):
    """``cfg.remat`` (checkpointed layers, and groups of
    ``remat_group_size`` layers where the reference groups them) against
    no remat: the same loss and gradients, bit for bit."""
    _, on = _cfgs(arch, remat=True, **over)
    off = on.replace(remat=False)
    model = build_model(on, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(on, SEQ)
    results = [_port_grads(cfg, params, batch) for cfg in (on, off)]
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def test_wkv_scan_refuses_autograd_p4():
    """The WKV kernel has no backward: its wrapper raises under autograd
    (on every device, and so on the CPU here) instead of handing back a
    tensor cut from the graph; without grad it runs."""
    rng = np.random.default_rng(0)
    bh, nc, c, d = 2, 2, 4, 8
    args = [torch.tensor(rng.normal(size=shape).astype(np.float32))
            for shape in ((bh, nc, c, d),) * 3 + ((bh, nc, 1, d),
                                                 (bh, nc, c, 1))]
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv_scan(*args)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv_scan(*args, backend="ref")
    with torch.no_grad():
        assert ops.wkv_scan(*args).shape == (bh, nc, c, d)
    # the model's "scan" route reaches it; the loss's default route does not
    _, tcfg = _cfgs("rwkv6-3b")
    params = T.map_leaves(lambda p: p.requires_grad_(),
                          rwkv6.init(torch.Generator(), tcfg, device="cpu"))
    batch = _batch(tcfg, SEQ)
    with pytest.raises(RuntimeError, match="no backward"):
        rwkv6.loss_fn(params, batch, tcfg, "scan")
    loss, _ = build_model(tcfg, device="cpu").loss_fn(params, batch)
    loss.backward()
    assert float(params["blocks"]["time_mix"]["wr"]["w"].grad.abs().max()) > 0
