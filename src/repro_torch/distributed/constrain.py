"""Activation sharding constraints, on one device.

Counterpart of ``repro.distributed.constrain``.  The reference pins the
sharding of activations at block boundaries when a launcher has installed a
mesh, and is the identity otherwise (single-device tests).  The port has no
mesh yet, so both functions return their input unchanged and
``mesh_axis_size`` is 1 for every axis; models call them at the reference's
places so that a sharded plan has its hooks.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["constrain", "constrain_batch", "mesh_axis_size"]


def constrain(x: torch.Tensor, spec: Sequence) -> torch.Tensor:
    """Pin ``x`` to ``spec``; the identity while no mesh is installed."""
    return x


def constrain_batch(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Shard ``dim`` over the data axes; the identity on one device."""
    return x


def mesh_axis_size(name: str) -> int:
    """Size of a mesh axis in the ambient activation mesh: 1, since no mesh
    is installed on one device."""
    return 1
