"""Scenario on the PyTorch/CUDA port: W8A8 fixed-point LM serving with
control-plane hot-swap — the paper's C1+C3 promoted to framework scale.

A small qwen2-family model is served twice: float weights vs int8
control-plane tables (quantize_tree, whose projections run the
hand-written W8A8 kernel on the card).  Greedy tokens are compared,
weights are hot-swapped without a new serving configuration, and an int8
KV cache halves the decode state.

    PYTHONPATH=src python examples/pt_serve_lm_quantized.py            # GPU
    PYTHONPATH=src python examples/pt_serve_lm_quantized.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.quantize import quantize_tree
from repro_torch.launch.serve import LMServer


def main(device: str = "cuda", init=None) -> dict:
    """Run the scenario on ``device``.  ``init(seed)`` makes the float
    model's parameters (default: the model's own seeded init)."""
    cfg = reduced(get_config("qwen2-1.5b"), d_model=256, n_layers=4,
                  d_ff=512).replace(remat=False)

    # float serving baseline
    srv = LMServer(cfg, batch=2, max_seq=64, device=device)
    if init is None:
        def init(seed):
            gen = torch.Generator(device=srv.device).manual_seed(seed)
            return srv.model.init(gen)
    model_params = init(0)
    srv.install("prod", model_params)
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
    out_fp = srv.generate("prod", prompt, 12)
    print(f"float decode: {srv.tokens_per_second():,.0f} tok/s")

    # fixed-point serving: weights become int8 control-plane tables
    srv_q = LMServer(cfg, batch=2, max_seq=64, device=device)
    q_params = quantize_tree(model_params, bits=8)
    srv_q.install("prod", q_params)
    out_q = srv_q.generate("prod", prompt, 12)
    agree = (out_fp == out_q).mean()
    print(f"W8A8 decode: {srv_q.tokens_per_second():,.0f} tok/s; "
          f"token agreement with float: {agree:.2%}")

    # hot-swap a 'retrained' checkpoint — no new serving configuration
    n = srv_q.trace_count
    srv_q.install("prod", quantize_tree(init(1), bits=8))
    srv_q.generate("prod", prompt, 4)
    assert srv_q.trace_count == n, "hot-swap must not recompile"
    print(f"hot-swap OK (trace_count still {n})")

    # int8 KV cache variant (paper C1 on the decode bottleneck)
    srv_kv = LMServer(cfg.replace(kv_cache_bits=8), batch=2, max_seq=64,
                      device=device)
    srv_kv.install("prod", model_params)
    out_kv = srv_kv.generate("prod", prompt, 12)
    print(f"int8-KV decode agreement: {(out_fp == out_kv).mean():.2%}")
    print("OK")
    return {"float": out_fp, "w8a8": out_q, "int8_kv": out_kv,
            "agreement": float(agree), "trace_count": n}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the GPU)")
    main(p.parse_args().device)
