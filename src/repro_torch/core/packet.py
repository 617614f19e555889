"""Neural-network encapsulation header codec (paper Table 1, Figs 1–2).

Wire format (network byte order), as published:

    ┌────────────┬──────────────┬─────────────────────────────────────┐
    │ Field      │ Size (bits)  │ Description                         │
    ├────────────┼──────────────┼─────────────────────────────────────┤
    │ Model ID   │ 16           │ Model identifier                    │
    │ Feature Cnt│ 8            │ # input features                    │
    │ Output Cnt │ 8            │ # output features                   │
    │ Scale      │ 16           │ Fixed-point scaling factor          │
    │ Flags      │ 8            │ Control flags (e.g. padding)        │
    │ Feature i  │ 32 each      │ fixed-point feature values          │
    └────────────┴──────────────┴─────────────────────────────────────┘

Packets enter carrying input features; egress replaces the feature block
with the model's outputs (Fig 2).  Two codecs, byte-identical to
``repro.core.packet``:

  * numpy twins (``encode_packets_np``, ``write_header_np``,
    ``parse_packets_np``, ``emit_results_np``) — the ingress pipeline parses
    each chunk once on the host and encodes egress rows once at retire;
  * torch versions (``parse_packets``, ``emit_results``, ``encode_packets``)
    on ``(B, L)`` uint8 tensors on any device — the engine's wire path
    (``DataPlaneEngine.run``/``process``).  Byte assembly runs in int64
    and wraps into int32 explicitly, since PyTorch's uint32 arithmetic is
    incomplete on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "HEADER_BYTES",
    "FEATURE_BYTES",
    "ParsedBatch",
    "packet_nbytes",
    "encode_packets",
    "encode_packets_np",
    "write_header_np",
    "parse_packets",
    "parse_packets_np",
    "emit_results",
    "emit_results_np",
    "FLAG_PADDED",
    "FLAG_RESULT",
    "FLAG_REFLEX",
]

HEADER_BYTES = 7  # 16+8+8+16+8 bits
FEATURE_BYTES = 4  # 32-bit features

FLAG_PADDED = 0x01  # feature block padded to max_features
FLAG_RESULT = 0x02  # payload carries outputs (egress), not inputs (ingress)
FLAG_REFLEX = 0x04  # result produced by the host reflex lane, not the model


def packet_nbytes(n_features: int) -> int:
    """Total encapsulation overhead in bytes for ``n_features``."""
    return HEADER_BYTES + FEATURE_BYTES * n_features


@dataclasses.dataclass
class ParsedBatch:
    """Header fields + feature codes for a batch of packets (all int32)."""

    model_id: torch.Tensor  # (B,)
    feature_cnt: torch.Tensor  # (B,)
    output_cnt: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,) fractional bits of the feature codes
    flags: torch.Tensor  # (B,)
    features_q: torch.Tensor  # (B, max_features) fixed-point codes


# ---------------------------------------------------------------------------
# numpy twins (host ingress/egress)
# ---------------------------------------------------------------------------


def encode_packets_np(model_id, scale, features_q: np.ndarray,
                      flags=None, output_cnt=None,
                      feature_cnt=None) -> np.ndarray:
    """Build a ``uint8`` packet batch ``(B, HEADER_BYTES + 4*F)`` on the
    host.  ``feature_cnt`` optionally sets the per-packet declared feature
    count (the parser masks features beyond it)."""
    features_q = np.asarray(features_q, np.int32)
    b, f = features_q.shape
    out = np.empty((b, HEADER_BYTES + FEATURE_BYTES * f), np.uint8)
    write_header_np(out, model_id, scale, flags=flags,
                    output_cnt=output_cnt,
                    feature_cnt=f if feature_cnt is None else feature_cnt)
    out[:, HEADER_BYTES:] = np.ascontiguousarray(
        features_q.astype(">i4")).view(np.uint8).reshape(b, 4 * f)
    return out


def write_header_np(out: np.ndarray, model_id, scale, *, flags=None,
                    output_cnt=None, feature_cnt=0) -> None:
    """Write the 7-byte encapsulation header into ``out[:, :HEADER_BYTES]``
    (vectorized, broadcasting scalars)."""
    b = out.shape[0]
    mid = np.broadcast_to(np.asarray(model_id, np.int64), (b,))
    out[:, 0] = (mid >> 8) & 0xFF
    out[:, 1] = mid & 0xFF
    fc = np.broadcast_to(np.asarray(feature_cnt, np.int64), (b,))
    out[:, 2] = fc & 0xFF
    oc = np.broadcast_to(
        np.asarray(0 if output_cnt is None else output_cnt, np.int64), (b,))
    out[:, 3] = oc & 0xFF
    sc = np.broadcast_to(np.asarray(scale, np.int64), (b,))
    out[:, 4] = (sc >> 8) & 0xFF
    out[:, 5] = sc & 0xFF
    fl = np.broadcast_to(
        np.asarray(0 if flags is None else flags, np.int64), (b,))
    out[:, 6] = fl & 0xFF


def parse_packets_np(rows: np.ndarray, max_features: int):
    """Host header parse of ``(B, L)`` uint8 rows.  Returns
    ``(model_id, feature_cnt, flags, features_q)`` as int32 arrays, with
    features beyond each packet's declared count zeroed."""
    rows = np.ascontiguousarray(rows, np.uint8)
    b, length = rows.shape
    model_id = ((rows[:, 0].astype(np.int32) << 8)
                | rows[:, 1]).astype(np.int32)
    feature_cnt = rows[:, 2].astype(np.int32)
    flags = rows[:, 6].astype(np.int32)
    avail = (length - HEADER_BYTES) // FEATURE_BYTES
    n = min(max_features, avail)
    if n:
        blk = np.ascontiguousarray(
            rows[:, HEADER_BYTES: HEADER_BYTES + FEATURE_BYTES * n])
        feats = blk.view(">i4").astype(np.int32)
    else:
        feats = np.zeros((b, 0), np.int32)
    if n < max_features:
        feats = np.concatenate(
            [feats, np.zeros((b, max_features - n), np.int32)], axis=1)
    idx = np.arange(max_features, dtype=np.int32)[None, :]
    feats = np.where(idx < feature_cnt[:, None], feats, 0)
    return model_id, feature_cnt, flags, feats


def emit_results_np(model_id: np.ndarray, flags: np.ndarray,
                    outputs_q: np.ndarray, out_scale: int) -> np.ndarray:
    """Egress rows on the host: same header layout, outputs as the feature
    block, Scale set to the output scale and the RESULT flag set."""
    outputs_q = np.asarray(outputs_q, np.int32)
    n_out = outputs_q.shape[1]
    return encode_packets_np(
        model_id, out_scale, outputs_q,
        flags=np.asarray(flags, np.int64) | FLAG_RESULT, output_cnt=n_out)


# ---------------------------------------------------------------------------
# torch codec (the engine's wire path, any device)
# ---------------------------------------------------------------------------

_BE_SHIFTS = (24, 16, 8, 0)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` → the int32 with the same low 32 bits."""
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def _read_be(pkts: torch.Tensor, offset: int, nbytes: int) -> torch.Tensor:
    out = torch.zeros(pkts.shape[0], dtype=torch.int64, device=pkts.device)
    for i in range(nbytes):
        out = (out << 8) | pkts[:, offset + i].to(torch.int64)
    return _wrap_int32(out)


def parse_packets(pkts: torch.Tensor, max_features: int) -> ParsedBatch:
    """Vectorized header parse of a ``(B, L)`` uint8 tensor.  Packets with
    fewer than ``max_features`` features are zero-padded; features beyond a
    packet's declared count are masked to zero."""
    model_id = _read_be(pkts, 0, 2)
    feature_cnt = _read_be(pkts, 2, 1)
    output_cnt = _read_be(pkts, 3, 1)
    scale = _read_be(pkts, 4, 2)
    flags = _read_be(pkts, 6, 1)
    b, length = pkts.shape
    avail = (length - HEADER_BYTES) // FEATURE_BYTES
    n = min(max_features, avail)
    features = torch.zeros((b, max_features), dtype=torch.int32,
                           device=pkts.device)
    if n > 0:
        raw = pkts[:, HEADER_BYTES: HEADER_BYTES + 4 * n].reshape(b, n, 4)
        raw = raw.to(torch.int64)
        words = ((raw[..., 0] << 24) | (raw[..., 1] << 16)
                 | (raw[..., 2] << 8) | raw[..., 3])
        features[:, :n] = _wrap_int32(words)
    idx = torch.arange(max_features, device=pkts.device)[None, :]
    features = torch.where(idx < feature_cnt[:, None], features,
                           torch.zeros_like(features))
    return ParsedBatch(model_id=model_id, feature_cnt=feature_cnt,
                       output_cnt=output_cnt, scale=scale, flags=flags,
                       features_q=features)


def _be_bytes(x: torch.Tensor, nbytes: int):
    v = x.to(torch.int64) & 0xFFFFFFFF
    return [((v >> (8 * (nbytes - 1 - i))) & 0xFF).to(torch.uint8)
            for i in range(nbytes)]


def encode_packets(model_id, scale, features_q: torch.Tensor,
                   flags: Optional[torch.Tensor] = None,
                   output_cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Build a ``uint8`` packet batch ``(B, HEADER_BYTES + 4*F)`` on
    ``features_q``'s device (fields broadcast over the batch)."""
    b, f = features_q.shape
    dev = features_q.device

    def col(v, default=0):
        v = default if v is None else v
        return torch.as_tensor(v, dtype=torch.int64, device=dev).expand(b)

    cols = []
    cols += _be_bytes(col(model_id), 2)
    cols += _be_bytes(torch.full((b,), f, dtype=torch.int64, device=dev), 1)
    cols += _be_bytes(col(output_cnt), 1)
    cols += _be_bytes(col(scale), 2)
    cols += _be_bytes(col(flags), 1)
    header = torch.stack(cols, dim=1)
    fq = features_q.to(torch.int64) & 0xFFFFFFFF
    payload = torch.stack([((fq >> s) & 0xFF) for s in _BE_SHIFTS],
                          dim=2).to(torch.uint8).reshape(b, f * 4)
    return torch.cat([header, payload], dim=1)


def emit_results(parsed: ParsedBatch, outputs_q: torch.Tensor,
                 out_scale: int) -> torch.Tensor:
    """Egress packets: same header layout, features ← model outputs, Output
    Cnt copied into Feature Cnt, Scale rewritten, RESULT flag set."""
    _, n_out = outputs_q.shape
    return encode_packets(parsed.model_id, out_scale, outputs_q,
                          flags=parsed.flags | FLAG_RESULT,
                          output_cnt=n_out)
