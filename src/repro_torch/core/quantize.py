"""Model-level quantization: the paper's fixed-point encode applied at LM
scale.  Counterpart of ``repro.core.quantize``, with its three modes:

  * ``fp``        — float path (the paper's CPU/Python reference stage);
  * ``w8a8_sim``  — fake-quant simulation (fixed-point grid, float ops) with
                    straight-through gradients, for QAT and accuracy studies;
  * ``w8a8_int``  — the integer datapath: per-channel symmetric int8
                    weights, dynamic per-row int8 activations, int32
                    accumulation (the FPGA stage, C1).

``absmax_quantize`` runs per row on the card as one hand-written kernel
(``kernels/row_quantize.py``) wherever :func:`row_kernel_applies` says so
— a CUDA tensor (not a DTensor) in bf16, fp16 or fp32, the absmax over its
contiguous last axis, at most 8 bits, no autograd graph through it, no
dispatch mode — with the plain chain's codes and scales bit for bit; the
weights' per-channel quantization, the CPU and meta paths and DTensor
shards keep the plain chain.  ``quantize_stats`` counts the calls on card
tensors by path.

``w8a8_matmul_int`` quantizes ``x`` per row, flattens its leading dims to
``(M, K)`` and calls ``kernels.ops.fixedpoint_matmul`` with the weight codes
as they are (under a mesh, on each rank's shards: column-parallel weights
give sharded output columns, row-parallel ones partial sums reduced in
float32 after the rescale): the hand-written
CUDA W8A8 kernel for tensors on the card, its plain version
(``ref.fixedpoint_matmul_ref``) for tensors on the CPU.  Both give the bits
of the reference's ``dot_general`` path: the int32 accumulator, then
``(float32(acc) · x_scale) · w_scale``.  The card path takes int8 codes
(``bits <= 8``).

Weight codes keep the reference's shape and values, (in, out), but are
stored K-major — strides (1, in) on the last two axes, ``k_major(codes)`` —
because the card's GEMM reads its weight operand along K; a row-major
(in, out) array costs that GEMM a layout copy per call.

Also ``quantize_tree`` (whole-tree weight quantization for serving, with a
name filter so norms, biases and embeddings stay float) over nested dicts,
lists and tuples, with the reference's path strings, and
``QuantizedLinear``, an ``nn.Module`` holding the codes and scale as
buffers on an explicit device.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..distributed.constrain import is_dtensor, reduce_partial, tp_layout
from ..kernels import ops
from ..kernels import row_quantize as rq
from .fixedpoint import fake_quant, true_divide
from .inference import resolve_device

__all__ = [
    "absmax_quantize",
    "row_kernel_applies",
    "quantize_stats",
    "QuantizeStats",
    "w8a8_matmul_int",
    "w8a8_matmul_sim",
    "matmul",
    "quantize_tree",
    "QuantizedLinear",
    "k_major",
    "k_major_pairs",
]


class QuantizeStats:
    """Calls of :func:`absmax_quantize` on card tensors since the last
    :meth:`reset`, by path: ``kernel`` (the row kernel) and ``plain``.
    Host integers (no device read)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.kernel = self.plain = 0


#: the calls of :func:`absmax_quantize` on card tensors by path
#: (``quantize_stats.reset()``)
quantize_stats = QuantizeStats()


def row_kernel_applies(x: torch.Tensor, bits: int, axis: int) -> bool:
    """Whether :func:`absmax_quantize` takes the row kernel for ``x``: what
    ``kernels.row_quantize.kernel_applies`` takes, and ``x`` is no DTensor,
    autograd records no graph through it and no dispatch mode (the dry
    run's cost counter, fake tensors) is active, which must see the plain
    ops."""
    return (rq.kernel_applies(x.device.type, x.dtype, x.shape,
                              x.stride(-1) if x.dim() else 0, axis, bits)
            and not (x.requires_grad and torch.is_grad_enabled())
            and not is_dtensor(x) and _get_current_dispatch_mode() is None)


def absmax_quantize(x: torch.Tensor, bits: int = 8, axis: int = -1,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice quantization: ``(codes, scale)`` with
    ``x ≈ codes * scale``.  ``axis`` is the absmax reduction axis (``-1``:
    per row for activations; ``0`` or ``-2``: per output channel for
    weights).  The scale keeps ``x``'s dtype."""
    return _absmax_quantize(x, bits, axis)[:2]


def _absmax_quantize(x: torch.Tensor, bits: int, axis: int):
    """:func:`absmax_quantize`'s pair and the scale as an (M, 1) float32
    tensor where the row kernel wrote one (else ``None``)."""
    if x.is_cuda:
        if row_kernel_applies(x, bits, axis):
            quantize_stats.kernel += 1
            return rq.row_quantize(x, bits)
        quantize_stats.plain += 1
    qmax = 2.0 ** (bits - 1) - 1
    absmax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = true_divide(torch.clamp_min(absmax, 1e-8), qmax)
    codes = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return codes.to(torch.int8 if bits <= 8 else torch.int16), scale, None


def w8a8_matmul_int(x: torch.Tensor, w_codes: torch.Tensor,
                    w_scale: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Integer GEMM: dynamic per-row activation quantization, int32
    accumulate, float32 rescale.  ``w_codes`` (in, out) int8, ``w_scale``
    (1, out).  Returns float32 of shape ``(*x.shape[:-1], out)`` (``(1, out)``
    for a 1-D ``x``, as the reference's broadcast gives)."""
    if w_codes.dim() != 2:
        raise ValueError(f"2-D weight codes expected, got {tuple(w_codes.shape)}")
    x, w_codes, kind = tp_layout(x, w_codes)
    x_codes, x_scale, x_scale32 = _absmax_quantize(x, bits, -1)
    if x_scale32 is None:
        x_scale32 = x_scale.reshape(-1, 1).to(torch.float32).contiguous()
    k, n = w_codes.shape
    operands = (x_codes.reshape(-1, k), w_codes, x_scale32,
                w_scale.reshape(1, n).to(torch.float32).contiguous())
    if kind == "rep" and not is_dtensor(x_codes):
        out = ops.fixedpoint_matmul(*operands)
    else:
        out = reduce_partial(_local_gemm(kind, *operands))
    return out.reshape(*x.shape[:-1], n) if x.dim() > 1 else out


def _local_gemm(kind: str, x_codes, w_codes, x_scale, w_scale):
    """The W8A8 GEMM on each rank's shards of DTensor operands
    (``local_map``): the rows of ``x`` keep their data-axis sharding;
    on ``model`` a column-parallel weight (``kind="col"``) gives output
    columns ``Shard(-1)``, a row-parallel one (``"row"``, ``x`` sharded on
    K) a ``Partial()`` sum, and a replicated one a replicated output."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w_codes.device_mesh
    pl = {name: [] for name in ("x", "w", "xs", "ws", "out")}
    for name, xp in zip(mesh.mesh_dim_names, x_codes.placements):
        if name == "model":
            col, row = kind == "col", kind == "row"
            pl["x"].append(Shard(1) if row else Replicate())
            pl["w"].append(Shard(1) if col else Shard(0) if row
                           else Replicate())
            pl["xs"].append(Replicate())
            pl["ws"].append(Shard(1) if col else Replicate())
            pl["out"].append(Shard(1) if col else Partial() if row
                             else Replicate())
        else:
            rows = Shard(0) if isinstance(xp, Shard) and xp.dim == 0 \
                else Replicate()
            pl["x"].append(rows)
            pl["w"].append(Replicate())
            pl["xs"].append(rows)
            pl["ws"].append(Replicate())
            pl["out"].append(rows)
    fn = local_map(ops.fixedpoint_matmul, out_placements=pl["out"],
                   in_placements=(pl["x"], pl["w"], pl["xs"], pl["ws"]),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x_codes, w_codes, x_scale, w_scale)


def _calibrated_fake_quant(x: torch.Tensor, bits: int,
                           axis: Optional[int] = None) -> torch.Tensor:
    """Snap onto a power-of-two grid whose step is calibrated from the data
    (the paper's per-tensor Scale field): the smallest step ``2**e`` that
    still covers absmax; straight-through gradient."""
    qmax = 2.0 ** (bits - 1) - 1
    absmax = (torch.amax(torch.abs(x)) if axis is None
              else torch.amax(torch.abs(x), dim=axis, keepdim=True))
    absmax = torch.clamp_min(absmax, 1e-12)
    step = torch.pow(2.0, torch.ceil(torch.log2(true_divide(absmax, qmax))))
    q = torch.clamp(torch.round(x / step), -qmax - 1, qmax) * step
    return x + (q - x).detach()  # STE


def w8a8_matmul_sim(x: torch.Tensor, w: torch.Tensor,
                    frac_bits: Optional[int] = None,
                    bits: int = 8) -> torch.Tensor:
    """Fake-quant GEMM on the fixed-point grid (QAT / accuracy simulation).
    ``frac_bits=None`` calibrates a per-tensor power-of-two step for the
    activations and a per-output-channel step for the weights; an integer
    pins the fixed grid Q·.frac_bits for both."""
    if frac_bits is not None:
        return fake_quant(x, frac_bits, bits) @ fake_quant(w, frac_bits, bits)
    xq = _calibrated_fake_quant(x, bits)
    wq = _calibrated_fake_quant(w, bits, axis=-2)  # per output channel
    return xq @ wq


def matmul(x: torch.Tensor, w, mode: str = "fp") -> torch.Tensor:
    """Mode-dispatched linear: ``w`` is a float tensor in ``fp`` and
    ``w8a8_sim``, a ``(codes, scale)`` pair (from :func:`quantize_tree`) in
    ``w8a8_int``."""
    if mode == "fp":
        return x @ w
    if mode == "w8a8_sim":
        return w8a8_matmul_sim(x, w)
    if mode == "w8a8_int":
        codes, scale = w
        return w8a8_matmul_int(x, codes, scale).to(x.dtype)
    raise ValueError(f"unknown quant mode: {mode}")


def k_major(codes: torch.Tensor) -> torch.Tensor:
    """The same (…, K, N) values with strides (…, 1, K) on the last two axes
    (each (K, N) matrix stored as its (N, K) transpose, row-major); a tensor
    already so laid out is returned as is."""
    t = codes.transpose(-1, -2)
    return codes if t.is_contiguous() else t.contiguous().transpose(-1, -2)


def k_major_pairs(tree):
    """``tree`` with the codes of every ``(integer codes of rank ≥ 2, float
    scale)`` pair made K-major (:func:`k_major`); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: k_major_pairs(v) for k, v in tree.items()}
    if (isinstance(tree, tuple) and len(tree) == 2
            and all(isinstance(t, torch.Tensor) for t in tree)
            and tree[0].dim() >= 2 and not tree[0].is_floating_point()
            and tree[1].is_floating_point()):
        return (k_major(tree[0]), tree[1])
    if isinstance(tree, (list, tuple)):
        return type(tree)(k_major_pairs(v) for v in tree)
    return tree


# GEMM weight leaves only (whitelist): dense '.../w', MoE expert stacks.
# Norms, biases, embeddings, conv/recurrence tables stay high-precision.
_DEFAULT_INCLUDE = re.compile(r"\['w'\]$|\['w_(gate|up|down)'\]$")


def quantize_tree(params, bits: int = 8,
                  skip: Optional[Callable[[str], bool]] = None):
    """Quantize the GEMM weight leaves of a tree of dicts, lists and tuples
    to ``(int8 codes, float32 per-channel scale)`` pairs.

    A leaf is quantized when it is a floating tensor of rank ≥ 2 whose path
    — spelled as the reference's ``jax.tree_util.keystr``, ``['a']['w']``
    for dict keys and ``[0]`` for sequence indices — matches the weight
    filter and ``skip`` (optional) does not veto it.  The absmax runs over
    the input axis (−2), so leading layer-stack dims are kept.  The result
    has the same structure; the codes are K-major (:func:`k_major`)."""
    def visit(path: str, node):
        if isinstance(node, dict):
            return {k: visit(f"{path}[{k!r}]", v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(f"{path}[{i}]", v)
                              for i, v in enumerate(node))
        if (isinstance(node, torch.Tensor) and node.dim() >= 2
                and node.is_floating_point() and _DEFAULT_INCLUDE.search(path)
                and not (skip and skip(path))):
            codes, scale = absmax_quantize(node, bits=bits, axis=-2)
            return (k_major(codes), scale.to(torch.float32))
        return node

    return visit("", params)


class QuantizedLinear(torch.nn.Module):
    """A linear layer on the integer datapath: the weight ``w`` (in, out) is
    quantized per output channel once, into ``codes`` (K-major) and
    ``scale`` buffers on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, w, bits: int = 8, *, device="cuda"):
        super().__init__()
        w = torch.as_tensor(w).to(resolve_device(device))
        codes, scale = absmax_quantize(w, bits=bits, axis=0)
        self.register_buffer("codes", k_major(codes))
        self.register_buffer("scale", scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8a8_matmul_int(x, self.codes, self.scale)
