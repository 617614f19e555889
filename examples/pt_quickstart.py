"""Quickstart on the PyTorch/CUDA port: the paper's pipeline end to end.

Train a QoS regression model in float (control plane) → fixed-point convert
(Table 2) → install into the data plane → push encapsulated feature packets
through the fused MLP kernel on the card → read predictions back out of the
egress packets — then retrain and hot-swap without rebuilding anything.

    PYTHONPATH=src python examples/pt_quickstart.py            # on the GPU
    PYTHONPATH=src python examples/pt_quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.paper_models import train_qos_regressor
from repro_torch.core.packet import encode_packets, parse_packets
from repro_torch.launch.serve import PacketServer


def main(device: str = "cuda") -> dict:
    rng = np.random.default_rng(0)

    # 1. control plane: train the model in float
    layers, acts, (X, y, pred) = train_qos_regressor(rng, name="qos_mlp")
    print(f"trained qos_mlp: float MSE = {((pred - y) ** 2).mean():.4f}")

    # 2. install → fixed-point tables (Table 2 encode, s = 8 fractional bits)
    server = PacketServer(frac_bits=8, taylor_order=3, device=device)
    server.install(model_id=7, layers=layers, activations=acts)

    # 3. data plane: features ride in packets (Table 1 header)
    codes = np.round(X[:256] * (1 << 8)).astype(np.int32)
    pkts = encode_packets(7, 8, torch.as_tensor(codes, device=server.device))
    out = server.process(pkts)

    # 4. egress: predictions replace features in the payload
    parsed = parse_packets(out.tensor, max_features=1)
    preds_q = parsed.features_q[:, 0].cpu().numpy() / (1 << 8)
    ref = pred[:256, 0]
    nmse = float(((preds_q - ref) ** 2).mean() / (ref ** 2).mean())
    print(f"in-network inference NMSE vs float: {nmse:.5f} "
          f"(paper budget: < 0.15)")

    # 5. retrain + hot-swap: the serving configuration never changes
    layers2, acts2, _ = train_qos_regressor(rng, name="qos_mlp", epochs=400)
    server.install(model_id=7, layers=layers2, activations=acts2)
    server.process(pkts)
    stats = server.stats()
    print(f"hot-swapped retrained weights on {server.device}; "
          f"engine stats: {stats}")
    assert stats["recompiles"] == 1, "an install must not add a configuration"
    assert nmse < 0.15, nmse
    print("OK")
    return {"nmse": nmse, **stats}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the GPU)")
    main(p.parse_args().device)
