"""End-to-end training on the PyTorch/CUDA port: train a ~100M-param LM
with the full substrate — the token stream, AdamW with fixed-point int8
moments, checkpointing with a mid-run restart, and the paper's Taylor
activations (segmented, order 3).

    PYTHONPATH=src python examples/pt_train_lm.py [--steps 300]   # GPU
    PYTHONPATH=src python examples/pt_train_lm.py --device cpu --steps 4 \
        --batch 2 --seq 16
"""

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import param_count
from repro_torch.launch.train import TrainLoop


def main(device: str = "cuda", steps: int = 300, batch: int = 8,
         seq: int = 256, log_every: int = 25) -> dict:
    # ~100M params: qwen2 family at width 512, 8 layers, its own GQA ratio
    cfg = get_config("qwen2-1.5b").replace(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
        d_ff=1536, vocab_size=32_768, accum_steps=1,
        taylor_order=3,          # paper C2: polynomial SiLU ...
        taylor_segmented=True,   # ... in the range-match segmented form —
                                 # the plain order-3 polynomial diverges for
                                 # |x|>2.6 pre-activations during training
        opt_state_bits=8,        # paper C1: fixed-point Adam moments
    )
    print(f"model: {param_count(cfg)/1e6:.0f}M params, segmented "
          f"taylor_order=3, int8 optimizer moments, on {device}")

    kw = dict(lr=1e-3, total_steps=steps, global_batch=batch, seq_len=seq,
              ckpt_every=100, device=device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop = TrainLoop(cfg, ckpt_dir=ckpt_dir, **kw)
        state, hist = loop.run(max_steps=steps // 2, log_every=log_every)
        print(f"-- simulated failure at step {state['step']}; restarting --")
        loop2 = TrainLoop(cfg, ckpt_dir=ckpt_dir, **kw)
        state2, hist2 = loop2.run(max_steps=steps, log_every=log_every)

    first, last = hist[0]["loss"], hist2[-1]["loss"]
    print(f"loss: {first:.3f} → {last:.3f} over {state2['step']} steps "
          f"(with one checkpoint/restart)")
    assert last < first, "training must make progress"
    print("OK")
    return {"history": hist + hist2, "steps": state2["step"],
            "first_loss": first, "last_loss": last}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the GPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    main(args.device, args.steps, args.batch, args.seq)
