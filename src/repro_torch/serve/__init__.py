"""Sharded serving fabric (scale-out past the single-engine PacketServer)
plus its fault layer (deterministic fault injection, shard failover,
graceful degradation) and the hard-latency reflex lane."""

from .fabric import ShardedPacketServer, rss_shard
from .faults import FaultPlan, FaultSpec, InjectedFault, chaos_plan_from_env
from .reflex import ReflexConfirmer, ReflexProgram, reflex_oracle

__all__ = ["ShardedPacketServer", "rss_shard",
           "FaultPlan", "FaultSpec", "InjectedFault", "chaos_plan_from_env",
           "ReflexProgram", "ReflexConfirmer", "reflex_oracle"]
