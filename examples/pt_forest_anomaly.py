"""Scenario on the PyTorch/CUDA port: in-network anomaly detection with a
hot-retrainable random forest (the pForest / Planter story on our data
plane).

A random forest is trained in pure NumPy on synthetic flow telemetry,
compiled into control-plane node tables (thresholds quantized onto the
wire's fixed-point grid), and served next to an MLP QoS model through one
data plane: per-packet Model IDs route each packet to the fused-MLP kernel
or the tree-traversal kernel.  When traffic drifts, the forest is retrained
and hot-swapped mid-serving — a control-plane table write, no new serving
configuration — and detection accuracy recovers.

    PYTHONPATH=src python examples/pt_forest_anomaly.py            # on the GPU
    PYTHONPATH=src python examples/pt_forest_anomaly.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.paper_models import make_paper_model
from repro_torch.core.packet import encode_packets, parse_packets
from repro_torch.data.packets import anomaly_dataset
from repro_torch.forest import predict_float, train_forest
from repro_torch.launch.serve import PacketServer

WIDTH = 8
FRAC = 8
DRIFT = 0.35


def serve_accuracy(server, X, y, model_id):
    """Encapsulate flows, serve them, argmax the vote lanes → accuracy."""
    codes = np.round(X * (1 << FRAC)).astype(np.int32)
    pkts = encode_packets(model_id, FRAC, torch.as_tensor(codes))
    server.submit_packets(pkts.numpy())
    rows = np.stack(server.drain_packets())
    parsed = parse_packets(torch.as_tensor(rows), max_features=2)
    votes = parsed.features_q.numpy()  # lane c = votes for class c
    return float((votes.argmax(1) == y).mean())


def main(device: str = "cuda") -> dict:
    rng = np.random.default_rng(0)
    server = PacketServer(max_models=8, max_layers=4, max_width=WIDTH,
                          frac_bits=FRAC, max_forests=4, max_trees=8,
                          max_nodes=63, max_tree_depth=5, device=device)

    # tenant 1: an MLP QoS model shares the data plane
    layers, acts = make_paper_model("qos_linear", rng)
    server.install(1, layers, acts)

    # tenant 2: train → quantize → install the anomaly forest
    X, y = anomaly_dataset(rng, 4096, WIDTH)
    # seed pin: every generator draws only from the explicit rng chain
    # above, so this statistic is reproducible run to run (loose on
    # purpose: only a different draw sequence should fail it)
    assert abs(float(np.abs(X).sum()) - 13059.76) < 50.0 \
        and abs(int(y.sum()) - 604) < 25, \
        "pt_forest_anomaly example lost its seed pinning"
    forest = train_forest(X[:3072], y[:3072], task="classify", n_trees=8,
                          max_depth=5, max_nodes=63, seed=1)
    server.install_forest(2, forest)
    float_acc = float((predict_float(forest, X[3072:]) == y[3072:]).mean())
    acc = serve_accuracy(server, X[3072:], y[3072:], model_id=2)
    print(f"anomaly forest: float accuracy {float_acc:.3f}, "
          f"in-network (quantized, served on {server.device}, "
          f"{server.engine.forest_variant}) {acc:.3f}")

    # traffic drifts: the burst region moves — the installed forest decays
    Xd, yd = anomaly_dataset(rng, 4096, WIDTH, drift=DRIFT)
    acc_drift = serve_accuracy(server, Xd[3072:], yd[3072:], model_id=2)
    print(f"after drift   : served accuracy degrades to {acc_drift:.3f}")

    # hot-retrain on drifted telemetry and swap the tables mid-serving —
    # one generation bump, cached results invalidated, nothing rebuilt
    retrained = train_forest(Xd[:3072], yd[:3072], task="classify",
                             n_trees=8, max_depth=5, max_nodes=63, seed=2)
    server.install_forest(2, retrained)
    acc_re = serve_accuracy(server, Xd[3072:], yd[3072:], model_id=2)
    print(f"hot-retrained : served accuracy recovers to {acc_re:.3f}")
    stats = server.stats()
    print(f"server stats  : {stats}")

    assert acc > 0.9, "quantized serving should track the float forest"
    assert acc_re > acc_drift + 0.03, "retrain should recover accuracy"
    # the whole lifecycle used one serving configuration
    assert stats["recompiles"] == 1
    print("OK")
    return {"acc": acc, "acc_drift": acc_drift, "acc_re": acc_re, **stats}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the GPU)")
    main(p.parse_args().device)
