"""Per-step cost of the eager program on one rank: the dry run's profiler.

Counterpart of ``repro.distributed.hlo_cost``, which parses the compiled
per-device HLO text of a step and propagates while-loop trip counts.  The
port runs eagerly, so the same numbers come from watching the ops as they
run: :class:`CostCounter` is a ``TorchDispatchMode`` that sees every op on
**local (per-rank) tensors**, with the reference's semantics:

  * ``flops`` — matmul-family ops counted exactly by the formulas of
    ``torch.utils.flop_counter`` (``2·M·N·K`` for a GEMM; the two
    kernel ops register their own, ``kernels/ops.py``); every other
    non-view op ≈ 1 flop per output element;
  * ``bytes`` — per op: operand bytes + output bytes, views excluded;
  * ``collective_bytes`` / ``collective_counts`` — per collective kind
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``),
    the output bytes on this rank, as the reference sums output shapes of
    the per-device program (:mod:`.collectives`);
  * the live-bytes peak: every storage an op creates is live until its
    last tensor dies.

A DTensor op is not counted itself: the mode declines it, DTensor runs its
local op (and any redistribution's collectives) on plain tensors, and the
mode counts those.  The shape-propagation ops DTensor runs on fake tensors
are skipped, so nothing is counted twice.

Nothing fuses in an eager program: every cast, copy and elementwise op
reads and writes memory.  The byte count therefore covers every eager op
and is an upper bound of the count XLA reports for its fused program.

**Loops.**  The reference counts a ``while`` body once times its trip
count.  With ``fold_loops=True`` the port does the same: a loop written
with :func:`loop` or :func:`fold_loop` runs its body once, and every count
inside is multiplied by the trip count (nested loops multiply).  Under
autograd the body's backward (and its recomputation under remat) is
multiplied too: marks around the body push the multiplier when the
backward enters it and pop it when it leaves.  For the live-bytes peak,
what one iteration leaves alive for its backward (its saved carry, or its
activations without remat) is held ``n − 1`` more times from the end of
the forward loop until the backward leaves the loop.  Without an active
folding counter every loop runs in full.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core import tree as T

__all__ = ["StepCost", "CostCounter", "loop", "fold_loop", "fill", "folding",
           "COLLECTIVE_KINDS"]

#: the functional-collective op name → the reference's collective kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}

# ops that move or make data without arithmetic (the reference's
# _ZERO_FLOP: copies, casts, gathers/scatters, concatenation, padding,
# creation, collectives)
_ZERO_FLOP = {
    "_to_copy", "copy_", "clone", "contiguous", "cat", "stack", "index",
    "index_select", "gather", "scatter", "scatter_", "index_put",
    "index_put_", "embedding", "constant_pad_nd", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "empty", "empty_like",
    "empty_strided", "new_zeros", "new_ones", "new_full", "new_empty",
    "new_empty_strided", "fill_", "fill", "zero_", "arange", "lift_fresh",
    "repeat", "repeat_interleave", "slice_scatter", "select_scatter",
    "_local_scalar_dense", "split_with_sizes_copy", "unbind_copy",
    "masked_select", "tril", "triu", "wait_tensor", "flip", "roll",
    "embedding_dense_backward", "index_add", "index_add_",
}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "wait_tensor",
             "_local_scalar_dense"}

# views and wrappers that move no data
_NOT_OPS = {"detach", "alias", "lift_fresh", "_unsafe_view",
            "_wrap_tensor_autograd"}

_STACK: List["CostCounter"] = []


def _fake_cls():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


def _dtensor_cls():
    if not torch.distributed.is_available():
        return ()
    from torch.distributed.tensor import DTensor
    return DTensor


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class StepCost:
    flops: float
    bytes: float
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class CostCounter(TorchDispatchMode):
    """Counts flops, bytes, collectives and the live-bytes peak of the ops
    run under it (see the module docstring).  ``track(tree)`` registers
    tensors that exist before the block (arguments) as live; ``by_op``
    holds ``[flops, bytes]`` per op name."""

    def __init__(self, fold_loops: bool = False):
        super().__init__()
        self.fold_loops = fold_loops
        self.mult = 1.0
        self._mults: List[float] = []
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, float] = defaultdict(float)
        self.live = 0
        self.phantom = 0
        self.peak = 0
        self.by_op: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
        self._storages: Dict[int, weakref.ref] = {}
        self._fake = _fake_cls()
        self._dtensor = _dtensor_cls()

    # -- the multiplier ----------------------------------------------------

    def push(self, n: float) -> None:
        self._mults.append(self.mult)
        self.mult *= n

    def pop(self) -> None:
        self.mult = self._mults.pop()

    @contextmanager
    def repeat(self, n: float):
        self.push(n)
        try:
            yield
        finally:
            self.pop()

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    # -- live bytes ----------------------------------------------------------

    def _local(self, t):
        if self._dtensor and isinstance(t, self._dtensor):
            return t._local_tensor
        return t

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages and self._storages[key]() is st:
            return
        nb = st.nbytes()

        def free(_ref, key=key, nb=nb):
            if self._storages.get(key) is _ref:
                del self._storages[key]
                self.live -= nb
        self._storages[key] = weakref.ref(st, free)
        self.live += nb
        self.peak = max(self.peak, self.live + self.phantom)

    def track(self, tree) -> int:
        """Register the tensors of ``tree`` (plain or DTensor) as live;
        returns the bytes newly registered."""
        before = self.live
        for leaf in T.leaves(tree):
            if isinstance(leaf, torch.Tensor):
                self._alloc(self._local(leaf))
        return self.live - before

    def hold(self, nbytes: int) -> None:
        """Count ``nbytes`` as live without a tensor (a folded loop's other
        iterations); :meth:`release` ends it."""
        self.phantom += nbytes
        self.peak = max(self.peak, self.live + self.phantom)

    def release(self, nbytes: int) -> None:
        self.phantom -= nbytes

    # -- counting ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if self._dtensor and any(isinstance(a, self._dtensor) for a in flat):
            return NotImplemented  # DTensor runs the local op; count that
        out = func(*args, **kwargs)
        if any(isinstance(a, self._fake) for a in flat):
            return out  # DTensor's shape propagation (global shapes)
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if any(isinstance(o, self._fake) for o in outs):
            return out
        for o in outs:
            self._alloc(o)
        name = func._overloadpacket.__name__
        m = self.mult
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            self.coll_bytes[kind] += m * sum(_nbytes(o) for o in outs)
            self.coll_counts[kind] += m
        if func.is_view or name in _NOT_OPS:
            return out
        nbytes = flops = 0
        if name not in _NO_BYTES:
            ins = [a for a in flat if isinstance(a, torch.Tensor)]
            nbytes = m * (sum(_nbytes(a) for a in ins)
                          + sum(_nbytes(o) for o in outs))
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = m * formula(*args, **kwargs, out_val=out)
        elif kind is None and name not in _ZERO_FLOP and \
                func.namespace == "aten":
            flops = m * sum(o.numel() for o in outs)
        self.flops += flops
        self.bytes += nbytes
        entry = self.by_op[name]
        entry[0] += flops
        entry[1] += nbytes
        return out

    def result(self) -> StepCost:
        return StepCost(flops=self.flops, bytes=self.bytes,
                        collective_bytes=dict(self.coll_bytes),
                        collective_counts=dict(self.coll_counts))


# ---------------------------------------------------------------------------
# loops
# ---------------------------------------------------------------------------


def folding() -> Optional[CostCounter]:
    """The innermost active counter if it folds loops, else ``None``."""
    if _STACK and _STACK[-1].fold_loops:
        return _STACK[-1]
    return None


def loop(n: int, weight: Optional[float] = None) -> Iterator[int]:
    """``range(n)``; under a folding counter, the single index 0 with every
    count multiplied by ``weight`` (default ``n``).  For loops that carry
    no autograd state across iterations."""
    c = folding()
    if c is None or n <= 1 and weight is None:
        yield from range(n)
        return
    with c.repeat(n if weight is None else weight):
        yield 0


def fill(blocks: list, n: int) -> list:
    """The per-iteration results of a :func:`loop` of ``n`` iterations:
    under folding the one block stands for all ``n`` (same shapes)."""
    return blocks * n if len(blocks) == 1 and n > 1 else blocks


class _Mark(torch.autograd.Function):
    """Identity on a loop body's tensors; its backward enters (output side)
    or leaves (input side) the body's multiplier."""

    @staticmethod
    def forward(ctx, state, enter, *xs):
        ctx.state, ctx.enter = state, enter
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        c, n, held = ctx.state["counter"], ctx.state["n"], ctx.state["held"]
        if ctx.enter:
            c.push(n)
        elif ctx.state.get("open", True):
            ctx.state["open"] = False
            c.pop()
            c.release(held)
        return (None, None, *gs)


def _tensors(carry) -> list:
    return [t for t in (carry if isinstance(carry, tuple) else (carry,))
            if isinstance(t, torch.Tensor)]


def _replace(carry, new: Sequence[torch.Tensor]):
    it = iter(new)
    if isinstance(carry, tuple):
        return tuple(next(it) if isinstance(t, torch.Tensor) else t
                     for t in carry)
    return next(it)


def fold_loop(body: Callable, carry, items: Sequence):
    """``carry = body(carry, item)`` for each item in order.  Under a
    folding counter, the body runs once (on ``items[0]``) with its counts,
    and those of its backward, multiplied by ``len(items)``; ``carry`` is a
    tensor or a tuple (non-tensor members pass through)."""
    c = folding()
    n = len(items)
    if c is None or n <= 1:
        for item in items:
            carry = body(carry, item)
        return carry
    if torch._C._current_graph_task_id() != -1:
        # A recomputation under remat (inside the backward, where the
        # original forward's marks hold the multiplier): an enclosing
        # group's recomputation stops at the input of its last checkpointed
        # layer, so it runs n − 1 layers in full — counted here once,
        # without grad — and the folded body's own run stops at once.  The
        # backward asks for it from inside the folded layer's window, whose
        # mark already multiplies by n: hence (n − 1) / n.
        if torch.is_grad_enabled():
            with torch.no_grad(), c.repeat((n - 1) / n):
                body(carry, items[0])
        return body(carry, items[0])
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(carry))
    state = {"counter": c, "n": n, "held": 0}
    if grad:
        ins = _tensors(carry)
        carry = _replace(carry, _Mark.apply(state, False, *ins))
    live0 = c.live
    with c.repeat(n):
        carry = body(carry, items[0])
    if grad:
        held = (n - 1) * max(c.live - live0, 0)
        state["held"] = held
        c.hold(held)
        outs = [t for t in _tensors(carry)]
        carry = _replace(carry, _Mark.apply(state, True, *outs))
    return carry
