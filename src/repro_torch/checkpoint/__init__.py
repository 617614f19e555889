"""Fault-tolerance substrate: atomic sharded async checkpoints + manager."""

from . import manager, store
from .manager import CheckpointManager
from .store import (all_steps, latest_step, restore, save, save_async,
                    wait_for_async)

__all__ = ["manager", "store", "CheckpointManager", "save", "save_async",
           "restore", "latest_step", "all_steps", "wait_for_async"]
