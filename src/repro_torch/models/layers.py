"""Shared model building blocks: linear layers in the paper's numeric modes,
norms and activations.

Counterpart of the parts of ``repro.models.layers`` that the RWKV-6 family
calls (``init_linear``, ``linear``, ``init_norm``, ``norm``, ``act_fn``);
attention, RoPE, the MLPs and the MoE come with the transformer families.
Parameters are plain dicts of tensors with the reference's leaf names, so
``core.quantize.quantize_tree`` finds the same weight leaves.  The paper's
numerics plug in through ``cfg.quant_mode`` (fixed-point GEMMs, C1) and
``cfg.taylor_order`` (polynomial activations, C2); a ``(codes, scale)``
weight leaf installed by ``quantize_tree`` runs the integer datapath, which
on the card is the hand-written W8A8 kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import quantize as qz
from ..core import taylor as ty

__all__ = ["init_linear", "linear", "init_norm", "norm", "act_fn"]

Params = Dict[str, Any]


def init_linear(generator: torch.Generator, din: int, dout: int, *,
                bias: bool = False, dtype=torch.float32,
                device="cpu") -> Params:
    """``w`` ~ N(0, 1/din) of shape (din, dout), drawn from ``generator``
    (which must live on ``device``); a zero bias when asked."""
    w = torch.randn((din, dout), generator=generator, dtype=dtype,
                    device=device) * (1.0 / math.sqrt(din))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((dout,), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["w"]
    if isinstance(w, tuple):  # control-plane-installed quantized table
        y = qz.matmul(x, w, "w8a8_int")
    elif cfg.quant_mode == "fp":
        y = x @ w.to(x.dtype)
    elif cfg.quant_mode == "w8a8_sim":
        y = qz.w8a8_matmul_sim(x, w.to(x.dtype))
    else:  # w8a8_int on float weights: quantize on the fly (tests/smoke)
        codes, scale = qz.absmax_quantize(w, bits=8, axis=0)
        y = qz.w8a8_matmul_int(x, codes, scale).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_norm(cfg: ModelConfig, d: Optional[int] = None,
              device="cpu") -> Params:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    init = torch.zeros if cfg.gemma_style else torch.ones
    return {"scale": init((d,), device=device)}


def norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        scale = (1.0 + p["scale"]) if cfg.gemma_style else p["scale"]
        y = y * scale
    return y.to(x.dtype)


def act_fn(x: torch.Tensor, cfg: ModelConfig,
           kind: Optional[str] = None) -> torch.Tensor:
    """Exact or Taylor activation per config (contribution C2).  GELU is
    the tanh form, as ``jax.nn.gelu`` computes it by default."""
    kind = kind or cfg.activation
    base = {"silu": "silu", "geglu": "gelu", "gelu": "gelu", "relu": "relu"}[kind]
    if base == "relu":
        return ty.relu(x)
    if cfg.taylor_order <= 0:
        return F.silu(x) if base == "silu" else F.gelu(x, approximate="tanh")
    if cfg.taylor_segmented:
        sig_in = x if base == "silu" else 1.702 * x
        sig = ty.segmented_taylor(sig_in, "sigmoid", cfg.taylor_order)
        return x * sig.to(x.dtype)
    if base == "silu":
        return ty.silu_taylor(x, cfg.taylor_order)
    return ty.gelu_taylor(x, cfg.taylor_order)
