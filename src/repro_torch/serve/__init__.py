"""Serving fabric support: deterministic fault injection.  The sharded
fabric and the reflex lane arrive with their slice."""

from .faults import FaultPlan, FaultSpec, InjectedFault, chaos_plan_from_env

__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "chaos_plan_from_env"]
