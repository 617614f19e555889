"""Checkpoint manager: retention, cadence, preemption-safe resume.

Counterpart of ``repro.checkpoint.manager``."""

from __future__ import annotations

import os
import shutil
import signal
import threading
from typing import Any, Optional

from . import store

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """Owns the cadence/retention policy around `store`.

    ``save_on_preemption()`` installs a SIGTERM handler that flags the train
    loop to checkpoint-and-exit at the next step boundary — the pattern for
    preemptible machines.
    """

    def __init__(self, root: str, *, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.root = root
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self.preempted = threading.Event()
        os.makedirs(root, exist_ok=True)

    # -- policy -------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        return step > 0 and (step % self.every == 0 or self.preempted.is_set())

    def save(self, step: int, tree) -> None:
        if self.async_save:
            store.save_async(self.root, step, tree)
        else:
            store.save(self.root, step, tree)
        self._gc()

    def restore_latest(self, like) -> tuple[Optional[int], Any]:
        step = store.latest_step(self.root)
        if step is None:
            return None, None
        return step, store.restore(self.root, step, like)

    def _gc(self) -> None:
        steps = store.all_steps(self.root)
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- preemption ---------------------------------------------------------

    def save_on_preemption(self) -> None:
        def handler(signum, frame):
            self.preempted.set()
        signal.signal(signal.SIGTERM, handler)

    def finalize(self) -> None:
        store.wait_for_async()
