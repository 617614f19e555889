"""Shard placement for the sharded serving fabric.

Counterpart of ``repro.launch.mesh.shard_devices``.  The reference's mesh
constructors (``make_mesh``, ``make_production_mesh``) and its hardware table
belong to the LM distribution slice and are not here.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.inference import resolve_device

__all__ = ["shard_devices"]


def shard_devices(n_shards: int, device="cuda") -> List[torch.device]:
    """Round-robin ``n_shards`` placements over the local devices of
    ``device``'s type.

    ``device="cuda"`` (the default) places shard ``i`` on
    ``cuda:(i mod torch.cuda.device_count())`` and raises when PyTorch sees
    no card; on a one-card host every shard lands on ``cuda:0`` (shards are
    then a concurrency and affinity construct, not a placement one, as the
    reference's shards are on a one-device host).  ``device="cpu"`` puts
    every shard on the CPU.  Returns a list of length ``n_shards``.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_shards
    n_dev = torch.cuda.device_count()
    return [torch.device("cuda", i % n_dev) for i in range(n_shards)]
