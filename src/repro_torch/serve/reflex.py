"""Reflex lane: host-side threshold/rule programs with async confirmation.

Counterpart of ``repro.serve.reflex``.  The hard-latency half of the
two-lane design: when the model lane cannot answer inside a packet's
budget — the ingress queue is past its high watermark — the packet is
answered at once by a tiny per-model vectorized-numpy rule program instead
of being queued.  The answer carries ``FLAG_REFLEX`` so callers can tell
the lanes apart, and the model lane confirms asynchronously: a
:class:`ReflexConfirmer` replays reflex-served rows through the real model
(fixed-shape batches through the engine — on the card, launches of the MLP
kernel — with self-cancelling engine credits, as the shadow scorer does)
and folds a ``reflex_agreement`` metric into the registry.

Programs are installed through the control plane
(:meth:`ControlPlane.install_reflex`) with the same prepare-then-commit
generation swap as every table family; the packed evaluation (one map
gather + a weighted vote over ``K`` threshold terms) runs in host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ReflexProgram", "ReflexConfirmer", "reflex_oracle"]


@dataclasses.dataclass(frozen=True)
class ReflexProgram:
    """A vectorized threshold/vote rule answering in host microseconds.

    Semantics (fixed-point input codes ``x``, all-int arithmetic)::

        votes = bias + sum_k weights[k] * [x[lanes[k]] >= thresholds[k]]
        out   = on_true if votes >= 0 else on_false

    ``on_true``/``on_false`` are output *code* rows on the same
    fixed-point grid as model egress (length = the model's output dim),
    so a reflex answer is wire-compatible with a model answer apart from
    its ``FLAG_REFLEX`` bit.  A single-threshold classifier is
    :meth:`threshold`; richer programs stack weighted terms (a depth-1
    decision list / linear vote — pForest's "crude but answerable"
    fallback regime).
    """

    lanes: Tuple[int, ...]
    thresholds: Tuple[int, ...]
    weights: Tuple[int, ...]
    on_true: Tuple[int, ...]
    on_false: Tuple[int, ...]
    bias: int = 0

    def __post_init__(self):
        n = len(self.lanes)
        if n == 0 or len(self.thresholds) != n or len(self.weights) != n:
            raise ValueError("ReflexProgram needs equal-length, non-empty "
                             "lanes/thresholds/weights")
        if not self.on_true or len(self.on_true) != len(self.on_false):
            raise ValueError("ReflexProgram output rows must be equal "
                             "length and non-empty")
        for lane in self.lanes:
            if int(lane) < 0:
                raise ValueError(f"reflex lane {lane} is negative")

    @classmethod
    def threshold(cls, lane: int, threshold: int, *,
                  on_true, on_false) -> "ReflexProgram":
        """One-comparison program: ``x[lane] >= threshold`` picks the row."""
        return cls(lanes=(int(lane),), thresholds=(int(threshold),),
                   weights=(1,), bias=-1,
                   on_true=tuple(int(v) for v in np.atleast_1d(on_true)),
                   on_false=tuple(int(v) for v in np.atleast_1d(on_false)))

    @property
    def out_dim(self) -> int:
        return len(self.on_true)


def reflex_oracle(program: ReflexProgram, x_row) -> List[int]:
    """Scalar pure-Python reference semantics (tests compare the packed
    control-plane evaluation against this, element for element)."""
    x = [int(v) for v in x_row]
    votes = int(program.bias)
    for lane, thr, w in zip(program.lanes, program.thresholds,
                            program.weights):
        if x[int(lane)] >= int(thr):
            votes += int(w)
    row = program.on_true if votes >= 0 else program.on_false
    return [int(v) for v in row]


class ReflexConfirmer:
    """Async model-lane confirmation of reflex-served packets.

    The ingress reflex path hands every reflex-served row (inputs, Model
    ID, the reflex answer's label) to :meth:`observe`; full fixed-shape
    batches replay through the real model with Model-ID-0 dead padding
    and self-cancelling engine credits (the
    :class:`~repro_torch.obs.ShadowScorer` discipline, so confirmation
    traffic never skews throughput stats or adds a serving
    configuration).  ``reflex_pairs_total`` /
    ``reflex_agree_total`` and the per-model tallies are the
    ``reflex_agreement`` metric: how often the crude lane matched the
    model it stood in for.
    """

    def __init__(self, pipeline, *, max_buffer: int | None = None) -> None:
        self.pipeline = pipeline
        self.engine = pipeline.engine
        self.batch = int(pipeline.batch_size)
        self.width = int(pipeline.width)
        self.out_feats = int(pipeline.out_feats)
        self._in_row = int(pipeline.wire_bytes)
        self._out_row = int(pipeline.out_bytes)
        self._buf_x0 = np.zeros((self.batch, self.width), np.int32)
        self._buf_mid = np.zeros(self.batch, np.int32)
        self._buf_lbl = np.zeros(self.batch, np.int64)
        self._fill = 0
        self._max_buffer = max_buffer
        self.by_model: Dict[int, List[int]] = {}   # mid -> [agree, pairs]
        reg = pipeline.obs.registry
        sid = int(getattr(pipeline, "shard_id", 0) or 0)
        self._c_pairs = reg.counter(
            "reflex_pairs_total", "model-confirmed reflex answers",
            shard=sid)
        self._c_agree = reg.counter("reflex_agree_total", shard=sid)

    # -- feed --------------------------------------------------------------

    def observe(self, x0: np.ndarray, mid: np.ndarray,
                reflex_out: np.ndarray) -> None:
        """Buffer reflex-served rows (inputs + the reflex answer) for the
        next confirmation batch."""
        n = int(np.asarray(mid).shape[0])
        if n == 0:
            return
        lbl = self._labels(np.asarray(reflex_out), n)
        pos = 0
        while pos < n:
            take = min(self.batch - self._fill, n - pos)
            lo, hi = self._fill, self._fill + take
            self._buf_x0[lo:hi] = x0[pos: pos + take, : self.width]
            self._buf_mid[lo:hi] = mid[pos: pos + take]
            self._buf_lbl[lo:hi] = lbl[pos: pos + take]
            self._fill += take
            pos += take
            if self._fill == self.batch:
                self.flush()

    # -- replay (the shadow scorer's self-cancelling credits) --------------

    def _run(self, x: np.ndarray, m: np.ndarray) -> np.ndarray:
        lanes = "both" if self.pipeline.cp.forest_active else "mlp"
        fut = self.engine.run_features(x, m, block=False, lanes=lanes)
        try:
            return np.asarray(fut)
        finally:
            self.engine.credit_packets(-self.batch)
            self.engine.credit_bytes(-self.batch * self._in_row,
                                     -self.batch * self._out_row)

    def _labels(self, out: np.ndarray, k: int) -> np.ndarray:
        if self.out_feats > 1:
            return np.argmax(out[:k, : self.out_feats], axis=1)
        thr = 1 << (int(self.engine.frac) - 1)     # fixed-point 0.5
        return (out[:k, 0] >= thr).astype(np.int64)

    def flush(self) -> None:
        """Replay the buffered reflex-served rows through the model lane
        and fold agreement into the registry."""
        k = self._fill
        if k == 0:
            return
        if k < self.batch:                 # Model-ID-0 dead padding keeps
            self._buf_x0[k:] = 0           # the dispatch shape fixed
            self._buf_mid[k:] = 0
        model = self._run(self._buf_x0, self._buf_mid)
        ml = self._labels(model, k)
        agree = ml == self._buf_lbl[:k]
        self._c_pairs.inc(k)
        self._c_agree.inc(int(agree.sum()))
        mids = self._buf_mid[:k]
        for m in np.unique(mids).tolist():
            sel = mids == m
            rec = self.by_model.setdefault(int(m), [0, 0])
            rec[0] += int(agree[sel].sum())
            rec[1] += int(sel.sum())
        self._fill = 0

    # -- reads -------------------------------------------------------------

    @property
    def pairs(self) -> int:
        return int(self._c_pairs.value)

    def agreement(self) -> float:
        """Fraction of confirmed reflex answers that matched the model
        (NaN until any pair has been confirmed)."""
        n = int(self._c_pairs.value)
        if n == 0:
            return float("nan")
        return int(self._c_agree.value) / n

    def disagreement(self, min_pairs: int = 64) -> float:
        """Health-rule signal: 1 − agreement, NaN below ``min_pairs``."""
        n = int(self._c_pairs.value)
        if n < min_pairs:
            return float("nan")
        return 1.0 - int(self._c_agree.value) / n

    def snapshot(self) -> dict:
        n = int(self._c_pairs.value)
        agree = int(self._c_agree.value)
        return {
            "pairs": n,
            "agreement": (agree / n) if n else None,
            "by_model": {m: {"agree": a, "pairs": p}
                         for m, (a, p) in sorted(self.by_model.items())},
        }
