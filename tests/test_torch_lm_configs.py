"""The port's LM configuration registry and exact LM losses against the JAX
reference on the CPU: every field of the ten architectures, their reduced
forms, the parameter accounting and the dry-run cells are equal; the
losses agree within float32 summation order."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.configs import base as jbase
from repro.core import losses as jl
from repro_torch import configs as tc
from repro_torch.configs import base as tbase
from repro_torch.core import losses as tl

torch.set_num_threads(1)

ARCHS = list(jc.ARCH_NAMES)


def test_registry_matches_reference():
    assert tc.ARCH_NAMES == jc.ARCH_NAMES
    assert tc.SUBQUADRATIC == jc.SUBQUADRATIC
    for include in (False, True):
        assert list(tc.cells(include)) == list(jc.cells(include))
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jc.SHAPES.items()}
    assert [s.tokens for s in tc.SHAPES.values()] == [
        s.tokens for s in jc.SHAPES.values()]
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("gpt-5")
    assert [f.name for f in dataclasses.fields(tbase.ModelConfig)] == [
        f.name for f in dataclasses.fields(jbase.ModelConfig)]
    assert dataclasses.asdict(tbase.ModelConfig()) == dataclasses.asdict(
        jbase.ModelConfig())


def _same(tcfg, jcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.q_dim, tcfg.kv_dim, tcfg.n_heads_ssm()) == (
        jcfg.q_dim, jcfg.kv_dim, jcfg.n_heads_ssm())
    assert tbase.n_heads_ssm(tcfg) == jbase.n_heads_ssm(jcfg)
    assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
    assert tbase.active_params(tcfg) == jbase.active_params(jcfg)
    assert tbase.remat_group_size(tcfg) == jbase.remat_group_size(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    _same(tc.get_config(arch), jc.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("overrides", [{}, {"n_layers": 3, "remat_group": 3},
                                       {"dtype": "float32",
                                        "quant_mode": "w8a8_int"}])
def test_reduced_matches_reference(arch, overrides):
    _same(tc.reduced(tc.get_config(arch), **overrides),
          jc.reduced(jc.get_config(arch), **overrides))


def test_replace_and_frozen():
    cfg = tc.get_config("rwkv6-3b")
    assert cfg.replace(n_layers=2).n_layers == 2 and cfg.n_layers == 32
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.n_layers = 1


# ---------------------------------------------------------------------------
# exact LM losses (forward)
# ---------------------------------------------------------------------------


def _loss_inputs(seed, b, s, d, v):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(d, v)).astype(np.float32),
            rng.integers(0, v, (b, s)),
            (rng.random((b, s)) < 0.7).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_logits_matches_reference(masked):
    h, w, labels, mask = _loss_inputs(1, 2, 40, 16, 77)
    logits = h @ w
    m = mask if masked else None
    want = jl.cross_entropy_logits(jnp.asarray(logits), jnp.asarray(labels),
                                   None if m is None else jnp.asarray(m))
    got = tl.cross_entropy_logits(torch.as_tensor(logits),
                                  torch.as_tensor(labels),
                                  None if m is None else torch.as_tensor(m))
    # float32 log-sum-exp and mean in another order: a few ulps
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("b,s,chunk", [(2, 40, 16), (2, 40, None),
                                       (3, 17, None), (1, 64, 32),
                                       (2, 33, 8)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_cross_entropy_matches_reference(b, s, chunk, masked, dtype):
    h, w, labels, mask = _loss_inputs(2, b, s, 16, 77)
    m = mask if masked else None
    jh = jnp.asarray(h).astype(jnp.dtype(dtype))
    th = torch.as_tensor(h).to(getattr(torch, dtype))
    want = jl.chunked_cross_entropy(jh, jnp.asarray(w), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m),
                                    chunk=chunk)
    got = tl.chunked_cross_entropy(th, torch.as_tensor(w),
                                   torch.as_tensor(labels),
                                   None if m is None else torch.as_tensor(m),
                                   chunk=chunk)
    exact = tl.cross_entropy_logits((th.float() @ torch.as_tensor(w)),
                                    torch.as_tensor(labels),
                                    None if m is None else torch.as_tensor(m))
    # float32: summation order only; bf16: the (B, chunk, V) logits are a
    # bf16 product, rounded differently by XLA and by PyTorch
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(got), float(want), rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(float(got), float(exact), rtol=1e-5)
