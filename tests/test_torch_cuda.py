"""The hand-written CUDA kernels against their plain versions on the card,
and the port's serving paths on the card against the port on the CPU.
Every test here needs an NVIDIA GPU with nvcc (``-m cuda``) and skips
without one.  On a machine with a card (``--noconftest``: ``tests/conftest.py``
imports the JAX package, which this file does not need):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.packet import HEADER_BYTES, encode_packets_np
from repro_torch.core.taylor import scaled_constants
from repro_torch.data.packets import anomaly_dataset, qos_dataset
from repro_torch.forest import train_forest
from repro_torch.forest.synthetic import random_forest_tables, stack_ranges
from repro_torch.kernels import fixedpoint_mlp as fmlp
from repro_torch.kernels import forest_traversal as ftk
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (forest_range_gather_ref,
                                     forest_traverse_gather_ref,
                                     fused_mlp_gather_ref)
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


@pytest.mark.parametrize("n_batch", [1, 127, 2048, 4099])
@pytest.mark.parametrize("extent", [(8, 16, 64, 32, 6, 31, 32),
                                    (3, 5, 16, 8, 4, 7, 8)])
def test_forest_kernels_equal_plain_versions(card, n_batch, extent):
    """Both forest kernels against the gather and masked plain versions at
    the serving extents (F=8, T=16, N=64, W=32, depth 6, NI=31, L=32) and a
    small one, with mixed modes, ragged tree_on and full-range codes."""
    n_forests, n_trees, n_nodes, width, depth, ni, nl = extent
    rng = np.random.default_rng(n_batch + width)
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    ranges = stack_ranges(nodes, tree_on, depth, n_entries=ni, n_leaves=nl)
    x = rng.integers(-1000, 1000, (n_batch, width)).astype(np.int32)
    x[rng.random(n_batch) < 0.1] = np.iinfo(np.int32).max
    slot = rng.integers(0, n_forests, n_batch).astype(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=card)

    x, slot, nodes, tree_on, mode = map(t, (x, slot, nodes, tree_on, mode))
    ranges = [t(a) for a in ranges]
    before = dict(ftk.launches)
    chase = ftk.forest_traverse(x, slot, nodes, tree_on, mode,
                                max_depth=depth, frac=FRAC)
    rng_out = ftk.forest_range(x, slot, *ranges, tree_on, mode, frac=FRAC)
    assert ftk.launches == {"chase": before["chase"] + 1,
                            "range": before["range"] + 1}
    kw = dict(max_depth=depth, frac=FRAC, backend="ref", ranges=ranges)
    want_chase = [forest_traverse_gather_ref(x, slot, nodes, tree_on, mode,
                                             max_depth=depth, frac=FRAC),
                  ops.forest_traverse(x, slot, nodes, tree_on, mode, **kw)]
    want_range = [forest_range_gather_ref(x, slot, *ranges, tree_on, mode,
                                          frac=FRAC),
                  ops.forest_traverse(x, slot, nodes, tree_on, mode, **kw,
                                      variant="range")]
    torch.cuda.synchronize()
    for w in want_chase:
        assert torch.equal(chase, w)
    for w in want_range:
        assert torch.equal(rng_out, w)


def test_forest_kernels_reject_bad_arguments(card):
    nodes = torch.zeros((2, 3, 5, 5), dtype=torch.int32, device=card)
    on = torch.ones((2, 3), dtype=torch.int32, device=card)
    mode = torch.zeros(2, dtype=torch.int32, device=card)
    x = torch.zeros((4, 8), dtype=torch.int32, device=card)
    slot = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        ftk.forest_traverse(x, slot.long(), nodes, on, mode, max_depth=2,
                            frac=FRAC)
    with pytest.raises(ValueError):
        ftk.forest_traverse(x, slot, nodes.cpu(), on, mode, max_depth=2,
                            frac=FRAC)
    big = torch.zeros((2, 3, 33), dtype=torch.int32, device=card)
    feat = torch.zeros((2, 3, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="32"):
        ftk.forest_range(x, slot, feat, feat, feat, big, on, mode, frac=FRAC)


def _forests(width=16):
    out = {}
    for k in range(3):
        rng = np.random.default_rng(100 + k)
        data, task = ((anomaly_dataset, "classify") if k % 2 == 0
                      else (qos_dataset, "regress"))
        X, y = data(rng, 600, width)
        out[5 + k] = train_forest(X, y, task=task, n_trees=4, max_depth=4,
                                  max_nodes=31, seed=200 + k)
    return out


@pytest.mark.parametrize("variant", ["range", "chase"])
def test_mixed_packet_server_on_card_matches_cpu_port(card, variant):
    rng = np.random.default_rng(2)
    kw = dict(max_models=4, max_layers=3, max_width=16, ingress_batch=128,
              max_forests=4, max_trees=4, max_nodes=31, max_tree_depth=4,
              forest_variant=variant)
    servers = [PacketServer(device=card, **kw),
               PacketServer(device="cpu", **kw)]
    forests = _forests()
    for m in range(4):
        layers = [(rng.normal(size=(16, 16)).astype(np.float32) * 0.4,
                   rng.normal(size=(16,)).astype(np.float32) * 0.1)
                  for _ in range(3)]
        for s in servers:
            s.install(m + 1, layers, ["sigmoid", "leaky_relu"],
                      final_activation="hard_sigmoid")
    for s in servers:
        for mid, f in forests.items():
            s.install_forest(mid, f)
        s.engine.warm(128, HEADER_BYTES + 4 * 16,
                      lanes=("mlp", "forest", "both"))
    feats = rng.integers(-500, 500, (3000, 16)).astype(np.int32)
    mids = rng.integers(0, 9, 3000).astype(np.int32)
    rows = encode_packets_np(mids, FRAC, feats)
    outs, before = [], dict(ftk.launches)
    for s in servers:
        rc = None
        for i in range(0, 3000, 77):
            if i == 1540:
                rc = s.stats()["recompiles"]
                s.install_forest(5, forests[7])
            s.submit_packets(rows[i: i + 77])
        outs.append(np.stack(s.drain_packets()))
        assert s.stats()["recompiles"] == rc
        lanes = s.ingress.stats["lane_batches"]
        assert lanes["mlp"] > 0 and lanes["forest"] > 0
    assert ftk.launches[variant] > before[variant]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_forest_example_runs_on_card(card):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "pt_forest_anomaly.py"
    spec = importlib.util.spec_from_file_location("pt_forest_anomaly", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main("cuda")
    assert res["recompiles"] == 1 and res["acc"] > 0.9
