"""Flow frontend: raw 5-tuple headers → per-flow features → the serving
pipeline.

Counterpart of ``repro.flow.frontend``:

    raw header batch ──▶ parse (numpy)                     data/packets.py
        │
        ▼
    FlowTable.lookup_or_insert        5-tuple → register slot (open
        │                             addressing, idle expiry, eviction)
        ▼
    kernels.ops.flow_update           sequential scatter-update of the
        │                             register file + count-min sketch,
        │                             emits post-update feature codes
        ▼
    FeatureSpec gather                per-packet: which flow-feature lanes
        │                             feed this Model ID's input columns
        ▼
    IngressPipeline.submit_features()   (dedup → cache → lane-pure
                                         dispatch; wire bytes only at egress)

The flow table and its register file live on the host (the table zeroes
rows on claim, expiry and eviction between batches).  On an engine on the
card, every :meth:`FlowFrontend.extract` call uploads the register file and
the sketch, runs the hand-written CUDA flow-update kernel, and copies
state, sketch and features back into the host arrays before it returns —
the round trip the reference makes on its accelerator.  On the CPU the
update is the rank-round numpy lowering, in place.  A FeatureSpec
reinstall is a pure control-plane swap: no new serving configuration.
:meth:`FlowFrontend.serve_raw_fused` is the one-dispatch deployment shape
(flow-update kernel → spec take → lanes → egress encode on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.ingress import _dedup_rows
from ..core.packet import HEADER_BYTES
from ..data.packets import RAW_KEY_BYTES, RawHeaderBatch, parse_raw_headers
from ..kernels.ops import flow_update
from ..kernels.ref import N_FLOW_FEATURES, N_FLOW_REGISTERS, flow_update_numpy
from ..obs.trace import FLOW_GATHER, FLOW_PARSE, FLOW_STATE, FLOW_TABLE
from .table import FlowTable

__all__ = ["FlowParams", "FlowFrontend", "reference_features"]

# Deterministic odd multipliers, one per count-min sketch row (the sketch's
# pairwise-independent-ish hash family over the 64-bit key hash) — the
# reference's exact draw.
_CMS_MULTS = ((np.random.default_rng(0x51E7C4).integers(
    0, 2 ** 63, 8, np.uint64) << np.uint64(1)) | np.uint64(1))


@dataclasses.dataclass(frozen=True)
class FlowParams:
    """Flow-engine arithmetic configuration (shared by the frontend, the
    kernels and the reference oracle).

    ``frac`` is the wire's fixed-point grid (``ControlPlane.frac_bits``);
    ``ewma_shift`` the EWMA alpha as a right shift (alpha = 2^-shift);
    ``byte_shift``/``dur_shift`` pre-scale byte counts / durations before
    they are encoded; ``cms_depth``×``2**cms_width_pow2`` is the count-min
    sketch geometry.
    """

    frac: int
    ewma_shift: int = 3
    byte_shift: int = 6
    dur_shift: int = 10
    cms_depth: int = 2
    cms_width_pow2: int = 12

    def __post_init__(self):
        if not 0 < self.cms_depth <= _CMS_MULTS.size:
            raise ValueError(f"cms_depth outside (0, {_CMS_MULTS.size}]")
        if not 0 < self.cms_width_pow2 < 31:
            raise ValueError("cms_width_pow2 outside (0, 31)")

    def cms_cells(self, hashes: np.ndarray) -> np.ndarray:
        """Per-row sketch cells from the 64-bit key hashes (uint64 multiply
        wraps, top bits select the cell)."""
        mults = _CMS_MULTS[: self.cms_depth]
        return ((hashes[:, None] * mults[None, :])
                >> np.uint64(64 - self.cms_width_pow2)).astype(np.int32)


class FlowFrontend:
    """Stateful flow engine in front of an
    :class:`~repro_torch.core.ingress.IngressPipeline`.

    Parameters
    ----------
    pipeline:
        The serving pipeline; its control plane supplies the wire grid
        (``frac_bits``) and the per-model :class:`FeatureSpec` mappings, and
        its engine the device the flow update runs on.
    capacity_pow2 / idle_timeout:
        Flow-table geometry and aging (see :class:`FlowTable`).
    backend:
        Flow-update backend (``kernels.ops.flow_update``): ``"auto"`` (the
        CUDA kernel on an engine on the card, the rank-round numpy lowering
        on the CPU), ``"kernel"`` (the card only), or ``"ref"`` (the
        pure-Python oracle — tests only).
    """

    def __init__(self, pipeline, *, capacity_pow2: int = 14,
                 idle_timeout: Optional[int] = None,
                 backend: str = "auto"):
        if backend not in ("auto", "kernel", "ref"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.pipeline = pipeline
        self.cp = pipeline.cp
        self.engine = pipeline.engine
        self.device = self.engine.device
        if backend == "kernel" and self.device.type != "cuda":
            raise ValueError("backend='kernel' needs an engine on the card, "
                             f"got {self.device}")
        self.params = FlowParams(frac=self.cp.frac_bits)
        self.width = self.engine.max_features  # wire feature-block columns
        self.backend = backend
        self.key_words = (RAW_KEY_BYTES + 7) // 8
        self.table = FlowTable(self.key_words, capacity_pow2=capacity_pow2,
                               idle_timeout=idle_timeout)
        self.cms = np.zeros(
            (self.params.cms_depth, 1 << self.params.cms_width_pow2),
            np.int32)
        # canonical names (see FlowTable.stats); the frontend's cells
        # graft into the owning server's registry along with the table's,
        # plus a flow_occupancy gauge collector
        from ..obs import Counter, StatsAdapter
        stats = StatsAdapter()
        stats.bind("flow_raw_packets_total", Counter())
        stats.bind("flow_raw_batches_total", Counter())
        self.stats = stats
        # the pipeline's host stage counters: the flow stages charge there
        self.stages = pipeline.stages
        self._arange = np.arange(0).reshape(0, 1)  # grown on demand
        self._ones = np.ones(0, np.int32)

    # -- the register file's round trip to the card ------------------------

    def _on_card(self) -> bool:
        return self.device.type == "cuda" and self.backend != "ref"

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def upload_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The register file and the sketch as tensors on the engine's
        device (the first half of the per-batch round trip)."""
        return self._put(self.table.registers), self._put(self.cms)

    def download_state(self, state: torch.Tensor, cms: torch.Tensor) -> None:
        """Copy an updated register file and sketch back into the host
        arrays (the second half; returns when the copy has landed)."""
        self.table.registers[:] = state.cpu().numpy()
        self.cms[:] = cms.cpu().numpy()

    def _update(self, slots, cells, ts, length, rank) -> np.ndarray:
        """Run the flow update for one batch of resolved live packets,
        leaving the new state in the host arrays; returns the features."""
        p = self.params
        kw = dict(frac=p.frac, ewma_shift=p.ewma_shift,
                  byte_shift=p.byte_shift, dur_shift=p.dur_shift)
        n = slots.shape[0]
        if self._ones.shape[0] < n:
            self._ones = np.ones(n, np.int32)
        live = self._ones[:n]
        if self._on_card():
            state, cms = self.upload_state()
            state, cms, feats = flow_update(
                state, cms, self._put(slots), self._put(cells),
                self._put(ts), self._put(length), self._put(live),
                backend=self.backend, **kw)
            self.download_state(state, cms)
            return feats.cpu().numpy()
        state, cms, feats = flow_update(
            self.table.registers, self.cms, slots, cells, ts, length, live,
            backend=self.backend, copy=False, rank=rank, **kw)
        if state is not self.table.registers:  # the oracle returns fresh
            self.table.registers[:] = np.asarray(state)
            self.cms[:] = np.asarray(cms)
        return np.asarray(feats)

    # -- feature extraction -------------------------------------------------

    def extract(self, raw, *, fields: Optional[RawHeaderBatch] = None,
                cms_est_q: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, RawHeaderBatch, np.ndarray,
                           np.ndarray]:
        """Run the stateful stage for one raw header batch: resolve flows,
        update registers/sketch, emit features.  Returns ``(features,
        fields, is_new, rejected)`` with ``features`` (B, N_FLOW_FEATURES)
        int32 codes at ``params.frac`` (post-update state as each packet
        observed it) and ``rejected`` True where the flow table overflowed
        and rejected the packet's whole flow (its feature row is zeros and
        must not be served — ``submit_raw`` turns it into a per-packet
        error slot; rejected flows never touch register or sketch state).

        ``fields`` lets a caller that already parsed the headers (the
        sharded fabric's dispatcher hashes the 5-tuples before routing)
        skip the second parse.  ``cms_est_q`` overrides the count-min
        feature lane with externally computed codes: the fabric keeps one
        sketch across its shards (heavy-hitter counts are a whole-fabric
        property), so the flow update still runs on this frontend's own
        sketch, and the fabric's per-packet estimates replace lane
        ``N_FLOW_FEATURES - 1`` once the features are back on the host.
        """
        stages = self.stages
        k = stages.push(FLOW_PARSE)
        try:
            if fields is None:
                fields = parse_raw_headers(raw)
            n = fields.model_id.shape[0]
            if n == 0:
                return (np.zeros((0, N_FLOW_FEATURES), np.int32), fields,
                        np.zeros(0, bool), np.zeros(0, bool))
            stages.swap(FLOW_TABLE)
            self.stats["flow_raw_packets_total"] += n
            self.stats["flow_raw_batches_total"] += 1
            words, hashes = FlowTable.pack_keys(fields.key_bytes,
                                                self.key_words)
            slots, is_new, rank = self.table.lookup_or_insert(
                words, hashes, fields.ts, want_rank=True)
            rejected = slots < 0
            cells = self.params.cms_cells(hashes)
            stages.swap(FLOW_STATE)
            if rejected.any():
                # overflow degradation: whole flows were rejected, so the kept
                # packets' slots and within-flow ranks are still exact — run
                # the update on the kept subset and leave zero rows (never
                # served) at the rejected positions
                keep = np.nonzero(~rejected)[0]
                feats = np.zeros((n, N_FLOW_FEATURES), np.int32)
                if keep.size:
                    feats[keep] = self._update(
                        slots[keep], cells[keep], fields.ts[keep],
                        fields.length[keep],
                        None if rank is None else rank[keep])
            else:
                feats = self._update(slots, cells, fields.ts, fields.length,
                                     rank)
            if cms_est_q is not None:
                if not feats.flags.writeable:
                    feats = np.array(feats)
                feats[:, N_FLOW_FEATURES - 1] = cms_est_q
            return feats, fields, is_new, rejected
        finally:
            stages.leave(k)

    # -- serving -------------------------------------------------------------

    def _gather(self, feats: np.ndarray, model_id: np.ndarray) -> np.ndarray:
        """Per-model FeatureSpec gather: land each packet's flow-feature
        lanes on its model's input columns (one int32 gather — ``-1``
        columns read the appended zero lane, exactly the device program's
        ``fused_serve.spec_take`` convention)."""
        n = feats.shape[0]
        cols, _ = self.cp.feature_spec_rows(model_id, self.width)
        feats_z = np.concatenate(
            [feats, np.zeros((n, 1), np.int32)], axis=1)
        if self._arange.shape[0] < n:
            self._arange = np.arange(n).reshape(n, 1)
        return np.ascontiguousarray(feats_z[self._arange[:n], cols])

    def submit_raw(self, raw, *, fields: Optional[RawHeaderBatch] = None,
                   cms_est_q: Optional[np.ndarray] = None,
                   drop_mask: Optional[np.ndarray] = None,
                   drop_reason: str = "malformed raw header"
                   ) -> Tuple[int, int]:
        """Feed one raw header batch through flow-update → feature-spec
        gather → the ingress pipeline's **feature-domain** entry.  Returns
        the pipeline's ``(first_ticket, n_packets)``; results arrive
        through the usual ``drain()`` surface in submission order.

        ``drop_mask`` marks rows the caller's validation already rejected
        (truncated/malformed headers, unknown Model IDs): they never touch
        flow state and resolve as
        :class:`~repro_torch.core.ingress.PacketError` slots carrying
        ``drop_reason``, interleaved at their submission-order positions.
        Flow-table overflow rejections from :meth:`extract` degrade the
        same way (reason ``"flow table overflow — flow rejected"``).
        ``fields``/``cms_est_q`` pass through to :meth:`extract` (the
        sharded fabric's pre-parsed, global-sketch entry).
        """
        stages = self.stages
        d = stages.enter()
        try:
            if drop_mask is not None and drop_mask.any():
                return self._submit_raw_partial(raw, fields, cms_est_q,
                                                np.asarray(drop_mask, bool),
                                                drop_reason)
            feats, fields, _, rejected = self.extract(raw, fields=fields,
                                                      cms_est_q=cms_est_q)
            n = feats.shape[0]
            if n == 0:
                return self.pipeline.submit_features(
                    np.zeros((0, self.width), np.int32),
                    np.zeros(0, np.int32))
            k = stages.push(FLOW_GATHER)
            gathered = self._gather(feats, fields.model_id)
            stages.leave(k)
            if rejected.any():
                return self.pipeline.submit_features(
                    gathered, fields.model_id, error_mask=rejected,
                    error_reason="flow table overflow — flow rejected")
            return self.pipeline.submit_features(gathered, fields.model_id)
        finally:
            stages.leave(d)

    def _submit_raw_partial(self, raw, fields, cms_est_q,
                            drop: np.ndarray, drop_reason: str
                            ) -> Tuple[int, int]:
        """Validation-rejected rows interleave as error tickets while the
        good subset runs the full flow stage (rejected rows must never
        touch register/sketch state).  Assembling the submission-order
        rows charges to ``flow_gather``."""
        stages = self.stages
        k = stages.push(FLOW_GATHER)
        n_total = drop.size
        x_full = np.zeros((n_total, self.width), np.int32)
        mid_full = np.zeros(n_total, np.int32)
        err = drop.copy()
        reasons = np.full(n_total, drop_reason, object)
        good = np.nonzero(~drop)[0]
        if good.size:
            if fields is not None:
                sub_fields = RawHeaderBatch(
                    key_bytes=fields.key_bytes[good],
                    model_id=fields.model_id[good],
                    ts=fields.ts[good], length=fields.length[good])
                sub_raw = raw
            else:
                sub_fields = None
                sub_raw = np.ascontiguousarray(
                    np.asarray(raw), np.uint8)[good]
            sub_est = None if cms_est_q is None else cms_est_q[good]
            feats, f2, _, rejected = self.extract(
                sub_raw, fields=sub_fields, cms_est_q=sub_est)
            x_full[good] = self._gather(feats, f2.model_id)
            mid_full[good] = f2.model_id
            if rejected.any():
                gi = good[rejected]
                err[gi] = True
                reasons[gi] = "flow table overflow — flow rejected"
        stages.leave(k)
        return self.pipeline.submit_features(
            x_full, mid_full, error_mask=err, error_reason=reasons)

    # -- checkpoint / restore ------------------------------------------------

    def snapshot(self) -> dict:
        """Checkpoint the whole stateful stage: flow table (live keys +
        register rows + generation) and the count-min sketch."""
        return {"table": self.table.snapshot(), "cms": self.cms.copy()}

    def restore(self, snap: dict) -> None:
        """Restore a :meth:`snapshot` — this port's or the reference's
        (``repro.flow.FlowFrontend.snapshot()``: the same numpy fields) —
        by a table rebuild under a generation bump and a sketch copy-in.
        Geometry must match."""
        cms = np.asarray(snap["cms"], np.int32)
        if cms.shape != self.cms.shape:
            raise ValueError(
                f"snapshot sketch geometry {cms.shape} != this "
                f"frontend's {self.cms.shape}")
        self.table.restore(snap["table"])
        self.cms[:] = cms

    def serve_raw_fused(self, raw) -> np.ndarray:
        """One-dispatch raw serving: flow-update kernel → spec take → lane
        dispatch → egress encode, chained on the engine's device
        (``kernels.fused_serve.serve_raw``), bypassing the ingress caches.

        The host still resolves 5-tuples → register slots (the flow hash
        table is host-side), so the register file and sketch round-trip
        host↔device per batch.  Returns the egress wire rows in batch
        order, bit-exact with ``submit_raw``'s results for the same
        arrivals (with no error channel: a flow-table overflow raises).
        """
        from ..kernels.fused_serve import serve_raw

        fields = parse_raw_headers(raw)
        n = fields.model_id.shape[0]
        if n == 0:
            return np.zeros((0, HEADER_BYTES + 4 * self.width), np.uint8)
        self.stats["flow_raw_packets_total"] += n
        self.stats["flow_raw_batches_total"] += 1
        words, hashes = FlowTable.pack_keys(fields.key_bytes, self.key_words)
        # no rank wanted: the kernel walks in batch order
        slots, _ = self.table.lookup_or_insert(words, hashes, fields.ts)
        if np.any(slots < 0):
            # the fused surface has no per-packet error channel — keep the
            # overflow loud here rather than serving zero rows
            raise ValueError(
                "flow table overflow in serve_raw_fused: "
                f"{int((slots < 0).sum())} packets' flows rejected — size "
                "the table above the trace's flow count for the fused path")
        cells = self.params.cms_cells(hashes)
        cols, _ = self.cp.feature_spec_rows(fields.model_id, self.width)
        eng = self.engine
        use_mlp, use_forest = eng._lane_flags("both")
        tables = eng.cp.tables(eng.device)
        ftables, rtables = eng._forest_snapshots(use_forest)
        p = self.params
        state, cms = self.upload_state()
        state, cms, rows = serve_raw(
            state, cms, self._put(slots), self._put(cells),
            self._put(fields.ts), self._put(fields.length),
            torch.ones(n, dtype=torch.int32, device=self.device),
            self._put(cols), self._put(fields.model_id), tables, ftables,
            rtables, eng.lane_cfg, use_mlp=use_mlp, use_forest=use_forest,
            ewma_shift=p.ewma_shift, byte_shift=p.byte_shift,
            dur_shift=p.dur_shift, backend=self.backend)
        self.download_state(state, cms)
        return rows.cpu().numpy()

    def flow_table_hit_rate(self) -> float:
        return self.table.hit_rate()


def reference_features(raw, params: FlowParams) -> np.ndarray:
    """Hand-built feature vectors for a raw trace: the pure-Python oracle
    over an unbounded flow table (every 5-tuple gets its own slot, no
    expiry/eviction) — the ground truth ``submit_raw()`` reproduces
    whenever the real table never evicts."""
    fields = parse_raw_headers(raw)
    if fields.model_id.shape[0] == 0:
        return np.zeros((0, N_FLOW_FEATURES), np.int32)
    key_words = (RAW_KEY_BYTES + 7) // 8
    words, hashes = FlowTable.pack_keys(fields.key_bytes, key_words)
    uidx, inverse = _dedup_rows(words, hashes)  # flow id per packet
    state = np.zeros((uidx.size, N_FLOW_REGISTERS), np.int32)
    cms = np.zeros((params.cms_depth, 1 << params.cms_width_pow2), np.int32)
    cells = params.cms_cells(hashes)
    _, _, feats = flow_update_numpy(
        state, cms, inverse, cells, fields.ts, fields.length,
        np.ones(inverse.shape[0], np.int32), frac=params.frac,
        ewma_shift=params.ewma_shift, byte_shift=params.byte_shift,
        dur_shift=params.dur_shift)
    return feats
