"""Scenario on the PyTorch/CUDA port: multi-tenant in-network QoS + anomaly
detection at line rate.

Three models (linear QoS, MLP QoS, anomaly classifier) share ONE serving
configuration; a mixed packet stream carrying different Model IDs is
dispatched per packet through the fused MLP kernel on the card, at µs-scale
amortized latency — the paper's NRP deployment story.

    PYTHONPATH=src python examples/pt_inline_qos_serving.py            # GPU
    PYTHONPATH=src python examples/pt_inline_qos_serving.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.configs.paper_models import (make_paper_model,
                                              train_qos_regressor)
from repro_torch.core.packet import parse_packets
from repro_torch.data.packets import PacketGenConfig, packet_stream
from repro_torch.launch.serve import PacketServer


def main(device: str = "cuda", n_batches: int = 10) -> dict:
    rng = np.random.default_rng(1)
    server = PacketServer(max_models=8, max_layers=4, max_width=32,
                          frac_bits=8, taylor_order=3, device=device)

    # tenant 1: linear QoS predictor; tenant 2: MLP; tenant 3: anomaly net
    l1, a1 = make_paper_model("qos_linear", rng)
    server.install(1, l1, a1)
    l2, a2, _ = train_qos_regressor(rng, name="qos_mlp", epochs=100)[:3]
    server.install(2, l2, a2)
    l3, a3 = make_paper_model("anomaly_mlp", rng)
    server.install(3, l3, a3, final_activation="sigmoid")

    # mixed traffic: packets from all three tenants interleaved
    gen = packet_stream(PacketGenConfig(
        n_features=16, batch=2048, frac_bits=8, model_ids=(1, 2, 3), seed=2))
    batch = next(gen)
    server.process(batch["packets"])  # warm: builds the kernel once

    t0 = time.perf_counter()
    for _ in range(n_batches):
        batch = next(gen)
        out = server.process(batch["packets"])
    dt = time.perf_counter() - t0
    total = 2048 * n_batches
    stats = server.stats()
    print(f"processed {total} mixed-tenant packets on {server.device} in "
          f"{dt * 1e3:.1f} ms ({dt / total * 1e6:.2f} µs/packet amortized)")
    print(f"engine: {stats}")

    # per-tenant outputs come back in the same stream
    parsed = parse_packets(out.tensor, max_features=1)
    preds = {}
    for mid in (1, 2, 3):
        sel = batch["model_id"] == mid
        vals = parsed.features_q[:, 0].cpu().numpy()[sel] / (1 << 8)
        preds[mid] = float(vals.mean())
        print(f"  tenant {mid}: {sel.sum()} packets, "
              f"pred mean {vals.mean():+.3f}")

    assert stats["recompiles"] == 1, "three tenants share one configuration"
    print("OK")
    return {"preds": preds, "egress": np.asarray(out), **stats}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the GPU)")
    main(p.parse_args().device)
