"""Elastic restart: rebuild the mesh from surviving devices and resume.

Counterpart of ``repro.distributed.elastic``.  Failure model: a pod loses
hosts or cards → the job restarts on the remaining N' devices.
Checkpoints are mesh-agnostic (full logical tensors addressed by leaf,
``repro_torch.checkpoint.store``), so resume is:

    1. ``plan_downsized_mesh(N')`` — keep the model axis intact (TP degree
       is baked into layout efficiency), shrink the data axis; drop
       stragglers to the largest usable power-of-two if needed;
    2. restore the checkpoint into the new sharding plan;
    3. the data pipeline's state is one integer (step), so no data is lost
       or repeated; global batch is preserved via gradient accumulation
       (``accum_steps *= old_data / new_data``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["plan_downsized_mesh", "ElasticPlan", "make_elastic_mesh"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_devices: int
    accum_multiplier: int  # gradient-accumulation factor preserving batch


def plan_downsized_mesh(n_available: int, *, model: int = 16,
                        old_data: int = 16,
                        multi_pod: bool = False) -> ElasticPlan:
    """Largest (data', model) mesh fitting ``n_available`` devices.

    The model axis is preserved (resharding TP mid-run changes per-op
    layouts; shrinking DP only re-slices the batch).
    """
    if n_available < model:
        raise ValueError(
            f"cannot keep model axis {model} with {n_available} devices; "
            "TP degree change requires full re-layout (cold restart)")
    data = n_available // model
    # largest power of two ≤ data keeps batch divisibility stable
    data = 1 << (data.bit_length() - 1)
    used = data * model
    accum = max(1, old_data // data)
    return ElasticPlan(shape=(data, model), axis_names=("data", "model"),
                       dropped_devices=n_available - used,
                       accum_multiplier=accum)


def make_elastic_mesh(plan: ElasticPlan, device="cuda"):
    """The plan's ``DeviceMesh`` on ``device``'s type over the first
    ``prod(plan.shape)`` ranks of a default process group of exactly that
    size (``launch.mesh.make_mesh``)."""
    from ..launch.mesh import make_mesh
    return make_mesh(plan.shape, plan.axis_names, device=device)
