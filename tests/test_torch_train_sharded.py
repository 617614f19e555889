"""``TrainLoop(mesh=...)``: the sharded training step on 4 gloo CPU ranks
(a 2 × 2 ("data", "model") mesh) against the unsharded port.

Reduced qwen2-1.5b (column/row tensor parallelism, the KV projections
replicated on ``model`` since one KV head does not divide it), reduced
granite-moe-3b-a800m (8 experts: expert parallelism on ``model``) and
reduced rwkv6-3b (the chunked WKV on each rank's (batch, head) rows)
train 3 steps in float32 activations, one microbatch a step (a sharded
step splits microbatches by rank, which regroups the same sum: Adam
carries its rounding past 1e-5 by step 3); every step's loss must be within 1e-5 of
the unsharded ``TrainLoop``'s on the same seed and stream.  ``mesh=None``
is the unsharded loop itself.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import TrainLoop

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK = textwrap.dedent("""
    import json, sys; sys.path.insert(0, "src")
    import torch, torch.distributed as dist
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import TrainLoop
    arch, rank, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = reduced(get_config(arch)).replace(dtype="float32", accum_steps=1)
    loop = TrainLoop(cfg, mesh=mesh, global_batch=4, seq_len=32,
                     device="cpu")
    state, hist = loop.run(max_steps=3, log_every=1)
    from torch.distributed.tensor import DTensor
    leaf = state["params"]["embed"]
    assert isinstance(leaf, DTensor), type(leaf)
    if rank == 0:
        json.dump({"losses": [h["loss"] for h in hist],
                   "placements": [str(p) for p in leaf.placements]},
                  open(out, "w"))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m",
                                  "rwkv6-3b"])
def test_sharded_train_loop_matches_unsharded(arch, tmp_path):
    out = tmp_path / "rank0.json"
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, arch, str(r),
                               str(port), str(out)], cwd=_ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    cfg = reduced(get_config(arch)).replace(dtype="float32", accum_steps=1)
    _, hist = TrainLoop(cfg, global_batch=4, seq_len=32,
                        device="cpu").run(max_steps=3, log_every=1)
    want = [h["loss"] for h in hist]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    got = json.loads(out.read_text())
    assert len(got["losses"]) == 3
    for a, b in zip(got["losses"], want):
        assert abs(a - b) <= 1e-5, (got["losses"], want)
    assert "S(0)" in got["placements"]  # vocab rows sharded on model


def test_unsharded_loop_has_no_mesh():
    loop = TrainLoop(reduced(get_config("qwen2-1.5b")), global_batch=2,
                     seq_len=16, device="cpu")
    assert loop.mesh is None
    state = loop.init_state()
    assert type(state["params"]["embed"]) is torch.Tensor
