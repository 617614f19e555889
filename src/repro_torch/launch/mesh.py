"""Mesh construction, the hardware table, and shard placement.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller sets up (``torch.distributed.init_process_group``
with an address, world size and rank).  Functions, not module-level
constants: importing this module touches no device or process group.

The dry run builds its meshes on ``"meta"`` over the ``"fake"`` backend
(:func:`fake_world`), which holds any world size in one process and moves
no data, as the reference's dry run hosts its production mesh on 512
placeholder CPU devices.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Sequence

import torch

from ..core.inference import resolve_device

__all__ = ["make_mesh", "make_production_mesh", "fake_world",
           "shard_devices", "HW"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on ``device``'s type:
    ``"cuda"`` (the card, the default; raises when there is none),
    ``"cpu"`` (gloo) or ``"meta"`` (the fake backend of the dry run).  The
    default process group must hold ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call "
                           "torch.distributed.init_process_group first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    # A meta mesh is a host mesh whose tensors live on "meta": DTensor
    # asks the mesh's device type for its host layout, which "meta" lacks.
    return init_device_mesh("cpu" if dev.type == "meta" else dev.type,
                            tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod:   (pod=2, data=16, model=16) = 512 devices.
    The reference's shapes, so that plans and fallbacks compare one to
    one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks on the ``"fake"``
    backend for the length of the block: collectives return at once and
    move nothing, so meshes of any size live in one process on ``"meta"``
    tensors.  Raises if a default group already exists (one per
    process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group already "
                           "exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


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
    if dev.type != "cuda":
        return [dev] * n_shards
    n_dev = torch.cuda.device_count()
    return [torch.device("cuda", i % n_dev) for i in range(n_shards)]


class HW:
    """NVIDIA H100 SXM5 80GB datasheet constants (per card, 700 W) for the
    roofline terms."""

    PEAK_BF16 = 989.4e12  # FLOP/s, dense bf16 tensor cores
    PEAK_INT8 = 1979e12  # OP/s, dense int8 tensor cores
    HBM_BW = 3.35e12  # B/s, HBM3
    HBM_BYTES = 80 * 1024 ** 3
    # The collective term's rate: one 400 Gb/s NIC per GPU.  Every axis of
    # 16 on the production meshes spans more than the 8-GPU NVLink domain
    # of one host, so its collectives cross the network at this rate.
    NET_BW = 50e9  # B/s
