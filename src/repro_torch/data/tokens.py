"""Deterministic synthetic LM token pipeline with host-sharded loading.

Counterpart of ``repro.data.tokens``, in pure numpy: the same seed
sequence ``[seed, step, host_index]``, the same draws in the same order
(``choice``, then ``random``, then ``integers``) and the same prefetch
thread, so every batch is byte-identical to the reference's.

Production shape: each host process loads only its slice of the global batch
(``process_index``-striped), double-buffers ahead of the step loop, and the
stream is fully resumable (state = a single step counter) — the property that
makes checkpoint/restart exact (no data repeated or skipped after a restart).

Synthetic text: a mixture of Zipf-distributed unigrams and a Markov-ish
repeated-ngram process, so models have real structure to fit (loss decreases
measurably within a few hundred steps — used by examples/train_lm.py).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["TokenStreamConfig", "TokenStream"]


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.35  # probability of continuing an ngram repeat


class TokenStream:
    """Iterator of {tokens, labels} host-local batches; O(1) resume state."""

    def __init__(self, cfg: TokenStreamConfig, start_step: int = 0,
                 prefetch: int = 2):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self.step = start_step
        self._local_batch = cfg.global_batch // cfg.n_hosts
        # Zipf-ish unigram distribution (stable across hosts)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = (probs / probs.sum()).astype(np.float64)
        self._q: Optional[queue.Queue] = None
        self._prefetch = prefetch

    # -- deterministic batch synthesis ------------------------------------

    def _rng_for(self, step: int) -> np.random.Generator:
        # host/step-addressed seed: any host can regenerate any step
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_index]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng_for(step)
        b, s = self._local_batch, cfg.seq_len + 1
        toks = rng.choice(cfg.vocab_size, size=(b, s), p=self._probs)
        # overlay repeated n-grams (compressible structure)
        rep = rng.random((b, s)) < cfg.repeat_p
        lag = rng.integers(1, 16, size=(b,))
        for i in range(b):
            idx = np.where(rep[i])[0]
            idx = idx[idx >= lag[i]]
            toks[i, idx] = toks[i, idx - lag[i]]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # -- iterator protocol with background prefetch ------------------------

    def _fill(self):
        while True:
            step = self._next_to_produce
            self._next_to_produce += 1
            self._q.put((step, self.batch_at(step)))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._q = queue.Queue(maxsize=self._prefetch)
        self._next_to_produce = self.step
        t = threading.Thread(target=self._fill, daemon=True)
        t.start()
        while True:
            step, batch = self._q.get()
            self.step = step + 1
            yield batch

    def state(self) -> int:
        """Resume token: the only pipeline state is the step counter."""
        return self.step
