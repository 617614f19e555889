"""Distribution substrate: the sharding rule engine (specs as DTensor
placements), activation constraints, collective accounting, the
compressed gradient reduction, elastic restart planning and the per-step
cost counter of the dry run.  Counterpart of ``repro.distributed``."""

from . import collectives, cost, elastic, sharding
from .collectives import CollectiveCounter, compressed_all_reduce
from .constrain import (activation_mesh, constrain, constrain_batch,
                        mesh_axis_size)
from .cost import CostCounter, StepCost
from .elastic import ElasticPlan, plan_downsized_mesh
from .sharding import ShardingPlan, batch_axes, batch_spec, cache_specs, make_plan

__all__ = ["collectives", "cost", "elastic", "sharding",
           "CollectiveCounter", "compressed_all_reduce", "activation_mesh",
           "constrain", "constrain_batch", "mesh_axis_size", "CostCounter",
           "StepCost", "ElasticPlan", "plan_downsized_mesh", "ShardingPlan",
           "batch_axes", "batch_spec", "cache_specs", "make_plan"]
