"""End-to-end training: data pipeline → train step →
checkpoint/restart → metrics.

Counterpart of ``repro.launch.train``.  Fault-tolerance behaviour:
  * resumes from the latest checkpoint (params, optimizer state, data-stream
    step);
  * SIGTERM (preemption) triggers checkpoint-and-exit at a step boundary.

The step is ``build_model(cfg).loss_fn`` → autograd → ``optim.adamw_step``
(AdamW in place, optionally with int8 moments), on the card unless the
caller passes ``device="cpu"``.  With ``mesh=`` (a ``DeviceMesh`` named
``("data", "model")`` or ``("pod", "data", "model")``, on the same device
type) the step is the reference's sharded one: parameters and optimizer
state are DTensors placed by ``distributed.sharding.make_plan``, the batch
by ``logical_batch_sharding``, and the step runs under
``activation_mesh(mesh)``; the update stays in place, as the reference
donates its buffers.  Checkpoints hold full tensors either way.

    python -m repro_torch.launch.train --arch qwen2-1.5b --reduced
    python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced
from ..core import tree as T
from ..core.inference import resolve_device
from ..data import TokenStream, TokenStreamConfig
from ..distributed.constrain import activation_mesh
from ..distributed.sharding import logical_batch_sharding, make_plan
from ..models import build_model
from ..optim import AdamWConfig, adamw, adamw_step, warmup_cosine

__all__ = ["TrainLoop", "main"]


class TrainLoop:
    """Owns the step, the stream, and the checkpoint manager."""

    def __init__(self, cfg, *, mesh=None, ckpt_dir: Optional[str] = None,
                 lr: float = 3e-4, warmup: int = 50, total_steps: int = 1000,
                 global_batch: int = 8, seq_len: int = 128,
                 ckpt_every: int = 100, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed "
                                f"DeviceMesh, got {type(mesh).__name__}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh on {mesh.device_type!r}, TrainLoop "
                                 f"on {self.device.type!r}")
        self.model = build_model(cfg, device=self.device)
        self.opt_cfg = AdamWConfig(lr=lr, state_bits=cfg.opt_state_bits)
        self.schedule = warmup_cosine(lr, warmup, total_steps)
        self.total_steps = total_steps
        self.stream = TokenStream(TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch))
        self.ckpt = (CheckpointManager(ckpt_dir, every=ckpt_every)
                     if ckpt_dir else None)
        if self.ckpt:
            self.ckpt.save_on_preemption()

    def _step(self, params, opt_state, batch, step: torch.Tensor):
        if self.mesh is None:
            return adamw_step(self.model.loss_fn, params, opt_state, batch,
                              self.opt_cfg, lr=self.schedule(step),
                              accum_steps=self.cfg.accum_steps)
        from torch.distributed.tensor.experimental import implicit_replication
        batch = self._distribute_batch(batch)
        with activation_mesh(self.mesh), implicit_replication():
            return adamw_step(self.model.loss_fn, params, opt_state, batch,
                              self.opt_cfg, lr=self.schedule(step),
                              accum_steps=self.cfg.accum_steps)

    # -- sharding ------------------------------------------------------------

    def _distribute(self, params, opt_state):
        """Full trees → DTensors placed by the plans of the reference's
        ``make_plan`` (parameters, then optimizer state)."""
        plan = make_plan(params, self.cfg, self.mesh)
        opt_plan = make_plan(opt_state, self.cfg, self.mesh)
        return plan.distribute(params), opt_plan.distribute(opt_state)

    def _distribute_batch(self, batch):
        from torch.distributed.tensor import DTensor, distribute_tensor
        if any(isinstance(v, DTensor) for v in batch.values()):
            return batch
        n = next(iter(batch.values())).shape[0]
        pl = logical_batch_sharding(self.mesh, batch, n)
        # every rank reads the same batch from the stream: no broadcast
        return {k: distribute_tensor(v, self.mesh, pl[k], src_data_rank=None)
                for k, v in batch.items()}

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen)
        opt_state = adamw.init(params, self.opt_cfg)
        if self.mesh is not None:
            params, opt_state = self._distribute(params, opt_state)
        return {"params": params, "opt": opt_state, "step": 0,
                "data_step": 0}

    def restore_or_init(self):
        state = self.init_state()
        if self.ckpt:
            like = {"params": state["params"], "opt": state["opt"],
                    "meta": np.zeros((2,), np.int64)}
            if self.mesh is not None:
                like = _full(like)
            step, restored = self.ckpt.restore_latest(like)
            if step is not None:
                state["params"] = restored["params"]
                state["opt"] = restored["opt"]
                if self.mesh is not None:
                    state["params"], state["opt"] = self._distribute(
                        restored["params"], restored["opt"])
                state["step"] = int(restored["meta"][0])
                state["data_step"] = int(restored["meta"][1])
                self.stream.step = state["data_step"]
                print(f"[train] resumed from step {state['step']}")
        return state

    def save(self, state) -> None:
        if not self.ckpt:
            return
        tree = {"params": state["params"], "opt": state["opt"],
                "meta": np.asarray([state["step"], self.stream.state()],
                                   np.int64)}
        self.ckpt.save(state["step"], _full(tree))

    # -- loop ---------------------------------------------------------------

    def run(self, max_steps: Optional[int] = None, log_every: int = 10):
        state = self.restore_or_init()
        max_steps = max_steps or self.total_steps
        history = []
        it = iter(self.stream)
        t0 = time.perf_counter()
        tokens_done = 0
        while state["step"] < max_steps:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in next(it).items()}
            step = torch.tensor(state["step"], dtype=torch.int32,
                                device=self.device)
            state["params"], state["opt"], metrics = self._step(
                state["params"], state["opt"], batch, step)
            state["step"] += 1
            state["data_step"] = self.stream.state()
            tokens_done += batch["tokens"].numel()
            if state["step"] % log_every == 0 or state["step"] == max_steps:
                loss = float(_full(metrics["loss"]))
                dt = time.perf_counter() - t0
                history.append({"step": state["step"], "loss": loss,
                                "tokens_per_s": tokens_done / dt})
                print(f"[train] step {state['step']:5d} loss {loss:.4f} "
                      f"({tokens_done / dt:,.0f} tok/s)")
            if self.ckpt and self.ckpt.should_save(state["step"]):
                self.save(state)
                if self.ckpt.preempted.is_set():
                    print("[train] preempted — checkpointed and exiting")
                    break
        if self.ckpt:
            self.save(state)
            self.ckpt.finalize()
        return state, history


def _full(tree):
    """``tree`` with every DTensor leaf gathered to its full tensor."""
    if not torch.distributed.is_available():
        return tree
    from torch.distributed.tensor import DTensor
    return T.map_leaves(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        over = {"accum_steps": 1}
        if args.d_model:
            over.update(d_model=args.d_model,
                        n_heads=max(4, args.d_model // 32),
                        d_ff=4 * args.d_model)
        cfg = reduced(cfg, **over)
    loop = TrainLoop(cfg, ckpt_dir=args.ckpt_dir, lr=args.lr,
                     total_steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, device=args.device)
    state, history = loop.run(max_steps=args.steps)
    print(json.dumps({"final_loss": history[-1]["loss"] if history else None,
                      "steps": state["step"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
