"""Collective utilities: collective-bytes accounting (for the roofline) and
the int8-compressed gradient all-reduce (paper C1 applied to the wire).

Counterpart of ``repro.distributed.collectives``.  The reference sums the
output-shape bytes of every collective in the compiled per-device HLO text
(``collective_bytes``).  The port's programs are eager, so
:class:`CollectiveCounter` watches them instead: a ``TorchDispatchMode``
that records each ``_c10d_functional`` collective's kind, count and output
bytes on this rank (the ops DTensor's redistributions issue, and those of
``torch.distributed._functional_collectives``).  ``distributed.cost``
counts collectives the same way inside its per-step cost.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .cost import COLLECTIVE_KINDS

__all__ = ["CollectiveCounter", "compressed_all_reduce", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}


class CollectiveCounter(TorchDispatchMode):
    """Output bytes and counts per collective kind (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``) of the collectives
    issued under it, on this rank.  ``result()`` has the reference's
    ``collective_bytes`` layout: bytes per kind, ``"_counts"`` and
    ``"total"``."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = defaultdict(int)
        self.counts: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = COLLECTIVE_KINDS.get(func._overloadpacket.__name__)
        if kind is not None:
            outs = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
            self.bytes[kind] += sum(o.numel() * o.element_size()
                                    for o in outs)
            self.counts[kind] += 1
        return out

    def result(self) -> Dict:
        res: Dict = dict(self.bytes)
        res["_counts"] = dict(self.counts)
        res["total"] = sum(self.bytes.values())
        return res


# ---------------------------------------------------------------------------
# int8-compressed all-reduce (beyond-paper C1: fixed-point on the wire)
# ---------------------------------------------------------------------------


def compressed_all_reduce(x: torch.Tensor, group=None, bits: int = 8
                          ) -> torch.Tensor:
    """All-reduce of this rank's ``x`` over ``group`` (the default group
    when ``None``) with int8 fixed-point codes on the wire (~4× fewer bytes
    than a float32 ring all-reduce).

    The reference's two-phase quantized reduction:
      1. slice locally into N chunks, quantize (per-chunk absmax scale),
         ``all_to_all`` the int8 codes (+tiny f32 scales): each rank
         receives every peer's copy of ITS chunk — 1 B/elem on the wire;
      2. dequantize-sum locally, re-quantize the reduced chunk,
         ``all_gather`` codes back — ≈1 B/elem.
    Rounding is half to even (``torch.round``), as ``jnp.round``.
    """
    import torch.distributed._functional_collectives as fc
    group = group if group is not None else torch.distributed.group.WORLD
    n = torch.distributed.get_world_size(group)
    orig_shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1)  # chunk i → rank i

    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp_min(chunks.abs().amax(dim=1, keepdim=True),
                            1e-12) / qmax
    codes = torch.clamp(torch.round(chunks / scale), -qmax - 1,
                        qmax).to(torch.int8)

    # phase 1: exchange codes so rank i holds all peers' chunk-i
    codes_t = fc.all_to_all_single(codes, None, None, group).wait()
    scales_t = fc.all_to_all_single(scale, None, None, group).wait()
    reduced = (codes_t.to(torch.float32) * scales_t).sum(dim=0)  # (C,)

    # phase 2: re-quantize reduced chunk, gather all chunks
    r_scale = torch.clamp_min(reduced.abs().amax(), 1e-12) / qmax
    r_codes = torch.clamp(torch.round(reduced / r_scale), -qmax - 1,
                          qmax).to(torch.int8)
    all_codes = fc.all_gather_tensor(r_codes[None], 0, group).wait()
    all_scales = fc.all_gather_tensor(r_scale.reshape(1), 0, group).wait()
    full = (all_codes.to(torch.float32) * all_scales[:, None]).reshape(-1)
    if pad:
        full = full[:-pad]
    return full.reshape(orig_shape)
