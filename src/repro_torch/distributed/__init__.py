"""Distribution substrate.  One device for now: ``constrain`` pins nothing.
The sharding plan, collectives and elastic restart come with their slice."""

from .constrain import constrain, constrain_batch, mesh_axis_size

__all__ = ["constrain", "constrain_batch", "mesh_axis_size"]
