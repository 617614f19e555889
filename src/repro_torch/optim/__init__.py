"""Optimizer substrate: AdamW (optionally with fixed-point int8 moments —
the paper's C1 applied to optimizer state) and LR schedules."""

from . import adamw, schedule
from .adamw import AdamWConfig, adamw_step, apply_updates
from .schedule import constant, warmup_cosine

__all__ = ["adamw", "schedule", "AdamWConfig", "adamw_step", "apply_updates",
           "constant", "warmup_cosine"]
