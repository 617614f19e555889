"""The hand-written CUDA kernel against its plain version on the card, and
the port's serving path on the card against the port on the CPU.  Every
test here needs an NVIDIA GPU with nvcc (``-m cuda``) and skips without
one.  On a machine with a card (``--noconftest``: ``tests/conftest.py``
imports the JAX package, which this file does not need):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.packet import encode_packets_np
from repro_torch.core.taylor import scaled_constants
from repro_torch.kernels import fixedpoint_mlp as fmlp
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_mlp_gather_ref
from repro_torch.launch.serve import PacketServer

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

FRAC = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _case(seed, dev, n_batch, n_models, n_layers, width, variant):
    rng = np.random.default_rng(seed)
    w_dtype = np.int8 if variant == "int8" else np.int16
    info = np.iinfo(w_dtype)
    w = rng.integers(info.min, info.max, (n_models, n_layers, width, width),
                     endpoint=True).astype(w_dtype)
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, (n_models, n_layers, width))
    x = rng.integers(-2 ** 30, 2 ** 30, (n_batch, width))
    act = rng.choice([0, 1, 2, 3, 4, 9], (n_models, n_layers))
    on = (rng.random((n_models, n_layers)) < 0.75)
    slot = rng.integers(0, n_models, n_batch)

    def t(a, dt=np.int32):
        return torch.as_tensor(np.asarray(a, dt), device=dev)

    return dict(x_q=t(x), slot=t(slot), w=t(w, w_dtype), b=t(b), act=t(act),
                layer_on=t(on))


def _kw(order=3):
    return dict(frac=FRAC, leaky_alpha_q=3, sig_coeffs=tuple(
        int(c) for c in scaled_constants("sigmoid", order, FRAC)))


@pytest.mark.parametrize("variant", ["int16", "int8"])
@pytest.mark.parametrize("n_batch,width,order", [(1, 32, 3), (255, 32, 5),
                                                 (2048, 32, 3), (4099, 32, 1),
                                                 (300, 8, 3), (300, 48, 3)])
def test_kernel_equals_plain_version(card, variant, n_batch, width, order):
    c = _case(n_batch + width, card, n_batch, 16, 4, width, variant)
    kw = _kw(order)
    before = fmlp.launches[variant]
    got = fmlp.fixedpoint_mlp(**c, **kw, variant=variant)
    assert fmlp.launches[variant] == before + 1
    want = fused_mlp_gather_ref(**c, **kw,
                                lane_bits=8 if variant == "int8" else None)
    masked = ops.fused_mlp(c["x_q"], c["slot"], c["w"], c["b"], c["act"],
                           c["layer_on"], backend="ref", variant=variant, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, masked)


def test_kernel_rejects_bad_arguments(card):
    c = _case(0, card, 8, 2, 2, 8, "int16")
    kw = _kw()
    with pytest.raises(TypeError):
        fmlp.fixedpoint_mlp(**c, **kw, variant="int8")  # int16 weights
    with pytest.raises(ValueError):
        fmlp.fixedpoint_mlp(**dict(c, x_q=c["x_q"].t().contiguous().t()),
                            **kw)  # not contiguous
    with pytest.raises(ValueError):
        fmlp.fixedpoint_mlp(**dict(c, slot=c["slot"].cpu()), **kw)


@pytest.mark.parametrize("variant,weight_bits", [("int16", 16), ("int8", 8)])
def test_packet_server_on_card_matches_cpu_port(card, variant, weight_bits):
    rng = np.random.default_rng(1)
    kw = dict(max_models=4, max_layers=3, max_width=16, ingress_batch=128,
              weight_bits=weight_bits, kernel_variant=variant)
    servers = [PacketServer(device=card, **kw), PacketServer(device="cpu", **kw)]
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        for s in servers:
            s.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                      final_activation="hard_sigmoid")
    feats = rng.integers(-500, 500, (1000, 16)).astype(np.int32)
    mids = rng.integers(0, 6, 1000).astype(np.int32)
    rows = encode_packets_np(mids, FRAC, feats)
    outs = []
    for s in servers:
        for i in range(0, 1000, 77):
            s.submit_packets(rows[i: i + 77])
        outs.append(np.stack(s.drain_packets()))
        np.testing.assert_array_equal(np.asarray(s.process(rows[:100])),
                                      np.asarray(servers[1].process(rows[:100])))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_quickstart_example_runs_on_card(card):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "pt_quickstart.py"
    spec = importlib.util.spec_from_file_location("pt_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main("cuda")
    assert res["recompiles"] == 1 and res["nmse"] < 0.15
