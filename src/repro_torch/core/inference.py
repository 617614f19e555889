"""The batched multi-model data-plane engine (paper Fig 2, §2).

    parse header → Model-ID table lookup → fixed-point MLP forward with
    Taylor-approximated activations  ─┐
                                      ├→ deparse (outputs replace features)
    parse header → forest-slot lookup → tree-ensemble traversal
    (pointer chase or range table) with majority/mean vote ─┘

It serves a mixed-model batch: every packet may target a different installed
model of either family.  The forest lane runs only once a forest has ever
been installed (the monotone ``ControlPlane.forest_active``), so an
MLP-only deployment never launches it.  Counterpart of
``repro.core.inference.DataPlaneEngine`` with two surfaces sharing one lane
core (``kernels.fused_serve.serve_lanes``):

  * ``run()`` / ``process()`` — the wire path: uint8 packet batches, byte
    parse and egress deparse on the device;
  * ``run_features()`` — the feature path the ingress pipeline serves
    through: parsed int32 codes and Model IDs in, int32 output codes out.

The engine runs on ``device`` — the card by default; it raises at
construction when asked for the card and there is none.  Every table is a
kernel argument fetched from the control plane's per-generation snapshot,
so installs never rebuild anything.  PyTorch runs eagerly, so
``trace_count`` counts the first use of each distinct static serving
configuration ``(surface, batch rows, row width, use_mlp, use_forest,
kernel variant, forest variant)`` — what a jit cache would hold; it stays
flat across installs.

``block=False`` returns as soon as the work is queued: the result is a
:class:`DeviceResult`, whose device→host copy completes asynchronously.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.fixedpoint_mlp import KERNEL_VARIANTS
from ..kernels.forest_traversal import FOREST_VARIANTS
from ..kernels.fused_serve import LaneConfig, serve_lanes
from .control_plane import ControlPlane
from .packet import FEATURE_BYTES, HEADER_BYTES, emit_results, parse_packets
from .taylor import scaled_constants

__all__ = ["DataPlaneEngine", "DeviceResult", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names the card and
    PyTorch sees none (there is no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class DeviceResult:
    """A batch result whose device→host copy may still be in flight.

    On the card the output is copied into pinned host memory on the current
    stream and an event is recorded after it: ``is_ready()`` polls the
    event, ``block_until_ready()`` waits on it, and ``np.asarray(result)``
    waits and returns the host copy.  On the CPU the result is ready at
    once.  ``tensor`` is the output on the engine's device.
    """

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        if tensor.is_cuda:
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))
        else:
            self._host = tensor
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def block_until_ready(self) -> "DeviceResult":
        if self._event is not None:
            self._event.synchronize()
        return self

    def __array__(self, dtype=None, copy=None):
        self.block_until_ready()
        arr = self._host.numpy()
        if dtype is not None and arr.dtype != dtype:
            return arr.astype(dtype)
        return arr.copy() if copy else arr


class DataPlaneEngine:
    """Batched mixed-model packet-inference pipeline over a
    :class:`ControlPlane`.

    Parameters mirror the reference: ``max_features`` (static parser
    bound), ``taylor_order`` (sigmoid polynomial order), ``leaky_alpha``,
    ``kernel_variant`` (``"int16"`` or the saturating ``"int8"`` lane,
    which needs ``weight_bits <= 8``) and ``forest_variant`` (``"chase"``,
    ``"range"`` or ``"auto"``), plus ``device`` (default the card).
    ``"auto"`` picks the range form on the card when the control plane has
    the range family (the reference's choice on its accelerator) and the
    chase on the CPU; ``"range"`` without the range family raises.  Both
    lanes always go through the kernel wrappers: the CUDA kernels on the
    card, their plain versions on the CPU.
    """

    def __init__(self, control_plane: ControlPlane, *, max_features: int = 16,
                 taylor_order: int = 3, leaky_alpha: float = 0.01,
                 kernel_variant: str = "int16", forest_variant: str = "auto",
                 device="cuda"):
        if kernel_variant not in KERNEL_VARIANTS:
            raise ValueError(f"unknown kernel variant: {kernel_variant!r}")
        if kernel_variant == "int8" and control_plane.fmt.total_bits > 8:
            raise ValueError(
                f"kernel_variant='int8' needs weight_bits <= 8, but the "
                f"control plane quantizes at {control_plane.fmt.total_bits} "
                "bits — construct it with ControlPlane(weight_bits=8)")
        if forest_variant not in FOREST_VARIANTS + ("auto",):
            raise ValueError(f"unknown forest variant: {forest_variant!r}")
        self.device = resolve_device(device)
        if forest_variant == "auto":
            forest_variant = ("range" if self.device.type == "cuda"
                              and control_plane.range_available else "chase")
        if forest_variant == "range" and not control_plane.range_available:
            raise ValueError(
                "forest_variant='range' needs the control plane's range "
                f"family (max_nodes={control_plane.max_nodes} > 64 exceeds "
                "the 32-leaf mask bound)")
        self.kernel_variant = kernel_variant
        self.forest_variant = forest_variant
        self.cp = control_plane
        self.max_features = max_features
        self.taylor_order = taylor_order
        self.frac = control_plane.frac_bits
        self._leaky_alpha_q = int(round(leaky_alpha * (1 << self.frac)))
        self._sig_coeffs = tuple(
            int(c) for c in scaled_constants("sigmoid", taylor_order, self.frac))
        self.lane_cfg = LaneConfig(
            frac=self.frac, sig_coeffs=self._sig_coeffs,
            leaky_alpha_q=self._leaky_alpha_q, max_features=max_features,
            max_tree_depth=control_plane.max_tree_depth,
            kernel_variant=kernel_variant, forest_variant=forest_variant)
        self.out_features = min(max_features, int(control_plane.max_width))
        self._configs: set = set()
        self.stats = {"packets": 0, "bytes_in": 0, "bytes_out": 0,
                      "seconds": 0.0}

    @property
    def trace_count(self) -> int:
        """Distinct static serving configurations used so far."""
        return len(self._configs)

    def _lane_flags(self, lanes: str):
        """Resolve the lane hint against the monotone forest switch, from
        one ``forest_active`` read."""
        forest_active = self.cp.forest_active
        use_forest = lanes != "mlp" and forest_active
        use_mlp = lanes != "forest" or not forest_active
        return use_mlp, use_forest

    def _forest_snapshots(self, use_forest: bool):
        """Both forest lowerings of one generation under one control-plane
        lock (a racing ``install_forest`` cannot hand the range traversal a
        torn pair)."""
        if not use_forest:
            return None, None
        return self.cp.forest_snapshots(self.forest_variant == "range",
                                        device=self.device)

    def _snapshots(self, key: tuple, lanes: str):
        """Table snapshots and lane flags for one batch; records the
        batch's serving configuration under ``key`` (surface, shape)."""
        tables = self.cp.tables(self.device)
        use_mlp, use_forest = self._lane_flags(lanes)
        ftables, rtables = self._forest_snapshots(use_forest)
        self._configs.add(key + (use_mlp, use_forest, self.kernel_variant,
                                 self.forest_variant))
        return tables, ftables, rtables, dict(use_mlp=use_mlp,
                                              use_forest=use_forest)

    def _to_device(self, a, dtype: torch.dtype) -> torch.Tensor:
        """Host array or tensor → contiguous tensor on the engine's device.
        A host→device copy from pageable memory has completed when this
        returns, so the caller may refill its staging buffer at once."""
        if isinstance(a, torch.Tensor):
            t = a
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype).contiguous()

    # -- host API -----------------------------------------------------------

    def run(self, pkts, *, block: bool = True,
            lanes: str = "both") -> DeviceResult:
        """One mixed-model batch of ingress packets → egress packets (the
        wire path).  ``block=False`` returns once the work is queued."""
        if lanes not in ("both", "mlp", "forest"):
            raise ValueError(f"unknown lanes hint: {lanes!r}")
        if isinstance(pkts, torch.Tensor):
            pkts = pkts.to(self.device).to(torch.uint8).contiguous()
        else:
            pkts = self._to_device(np.asarray(pkts).astype(np.uint8, copy=False),
                                   torch.uint8)
        tables, ftables, rtables, flags = self._snapshots(
            ("wire", tuple(pkts.shape)), lanes)
        t0 = time.perf_counter()
        parsed = parse_packets(pkts, self.max_features)
        outputs = serve_lanes(parsed.features_q, parsed.model_id, tables,
                              ftables, rtables, self.lane_cfg, **flags)
        out = DeviceResult(emit_results(parsed, outputs, self.frac))
        self.stats["packets"] += int(pkts.shape[0])
        self.stats["bytes_in"] += int(pkts.numel())
        self.stats["bytes_out"] += int(out.tensor.numel())
        if block:
            out.block_until_ready()
            self.stats["seconds"] += time.perf_counter() - t0
        return out

    def run_features(self, feats_q, model_id, *, block: bool = True,
                     lanes: str = "both") -> DeviceResult:
        """One mixed-model batch of already-parsed feature codes — the
        feature path: feats_q (B, W) int32 codes at the engine's ``frac`` ·
        model_id (B,) int32 → (B, out_features) int32 output codes.  Byte
        counters credit the equivalent wire row sizes."""
        if lanes not in ("both", "mlp", "forest"):
            raise ValueError(f"unknown lanes hint: {lanes!r}")
        x0 = self._to_device(feats_q, torch.int32)
        mid = self._to_device(model_id, torch.int32)
        tables, ftables, rtables, flags = self._snapshots(
            ("features", tuple(x0.shape)), lanes)
        t0 = time.perf_counter()
        out = DeviceResult(serve_lanes(x0, mid, tables, ftables, rtables,
                                       self.lane_cfg, **flags))
        n = int(x0.shape[0])
        self.stats["packets"] += n
        self.stats["bytes_in"] += n * (HEADER_BYTES
                                       + FEATURE_BYTES * self.max_features)
        self.stats["bytes_out"] += n * (HEADER_BYTES
                                        + FEATURE_BYTES * self.out_features)
        if block:
            out.block_until_ready()
            self.stats["seconds"] += time.perf_counter() - t0
        return out

    def process(self, pkts) -> DeviceResult:
        """Blocking alias of :meth:`run`."""
        return self.run(pkts, block=True)

    def warm(self, batch_size: int, wire_len: int, *,
             lanes: Sequence[str] = ("both",),
             feature_batches: Optional[Sequence[int]] = None) -> None:
        """Run each serving configuration a loop will use once on a dead
        batch (builds the kernel library on first use); stats roll back."""
        if feature_batches is None:
            feature_batches = (batch_size,)
        pkts = np.zeros((batch_size, wire_len), np.uint8)
        before = dict(self.stats)
        for lane in lanes:
            self.run(pkts, block=True, lanes=lane)
            for fb in feature_batches:
                x0 = np.zeros((fb, self.max_features), np.int32)
                mid = np.zeros((fb,), np.int32)
                self.run_features(x0, mid, block=True, lanes=lane)
        self.stats = before

    def add_seconds(self, dt: float) -> None:
        """Credit wall-clock spent by an external async drain loop."""
        self.stats["seconds"] += dt

    def credit_packets(self, n: int) -> None:
        """Adjust the served-packet counter on behalf of the ingress
        pipeline (cache hits and coalesced duplicates count as served,
        dead padding rows do not)."""
        self.stats["packets"] += int(n)

    def credit_bytes(self, n_in: int, n_out: int) -> None:
        """Byte-counter analogue of :meth:`credit_packets`."""
        self.stats["bytes_in"] += int(n_in)
        self.stats["bytes_out"] += int(n_out)

    def throughput_gbps(self) -> float:
        s = self.stats
        if s["seconds"] == 0:
            return 0.0
        return (s["bytes_in"] + s["bytes_out"]) * 8 / s["seconds"] / 1e9

    def packets_per_second(self) -> float:
        s = self.stats
        return s["packets"] / s["seconds"] if s["seconds"] else 0.0
