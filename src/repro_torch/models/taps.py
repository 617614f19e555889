"""Taps on the intermediate values of a transformer prefill.

``with taps.recording(fn):`` calls ``fn(site, tensors)`` at each tap a
``transformer.prefill`` passes, in order, with the tensors as the pass
computed them (not copies; ``fn`` copies what it keeps).  The block tap
is in ``transformer.block_fwd``, so the other passes that run blocks
(``forward``, ``loss_fn``, ``decode_step``) pass it too:

* ``"embed"``: ``(x,)``, the embedding's rows (B, S, D);
* ``"block"``, once a block in layer order: ``(x, h1, attn, h2, ffn, y)``,
  the block's input, the first norm's output (the attention's input), the
  attention's output, the second norm's output (the FFN's input, the
  MoE's as (B, S, D)), the FFN's output and the block's output
  ``x + attn + ffn``;
* ``"head"``: ``(x, logits)``, the last position's hidden state before
  the final norm (B, 1, D) and its logits.

This is the contract that the benchmark's MLA + MoE prefill surface
(``portbench/surfaces/mla_moe_prefill.py``) reads to hold each piece of a
call against its reference: a change that fuses or reorders these steps
keeps passing the same values here.  Without a recording a tap costs one
test of a module global.  Record no-grad passes: under ``cfg.remat`` a
backward recomputes its blocks and taps them again.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch

__all__ = ["recording", "tap"]

_sink: Optional[Callable[[str, Tuple[torch.Tensor, ...]], None]] = None


@contextlib.contextmanager
def recording(fn: Callable[[str, Tuple[torch.Tensor, ...]], None]):
    """Calls ``fn(site, tensors)`` at every tap inside the ``with`` block
    (one recording at a time)."""
    global _sink
    if _sink is not None:
        raise RuntimeError("taps: a recording is already open")
    _sink = fn
    try:
        yield fn
    finally:
        _sink = None


def tap(site: str, *tensors: torch.Tensor) -> None:
    """Hands ``tensors`` to the open recording, if any."""
    if _sink is not None:
        _sink(site, tensors)
