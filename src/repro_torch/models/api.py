"""Unified model API: ``build_model(cfg)`` → one object with the same entry
points for every family.

Counterpart of ``repro.models.api`` for every family: the transformer
families (dense, moe, vlm), RWKV-6, the Zamba2 hybrid (hybrid) and the
Whisper encoder–decoder (encdec); and the families the port adds at
published configurations: Zamba2 (zamba2) and Kimi Linear
(kimi_linear).  The dry-run helpers
(``abstract_params``, ``abstract_caches``, ``input_specs``) give the
reference's trees, shapes and dtypes as tensors on the ``"meta"`` device:
they allocate nothing, so a 236B-parameter config costs no memory.

``params_from_numpy`` carries the reference's parameters across: a tree of
numpy arrays (``jax.tree.map(np.asarray, params)``) becomes the same tree of
tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.inference import resolve_device
from ..core.quantize import k_major_pairs
from . import encdec, kimi_linear, rwkv6, ssm, transformer, zamba2

__all__ = ["Model", "build_model", "params_from_numpy"]

Params = Dict[str, Any]

@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable  # (generator) -> params on ``device``
    loss_fn: Callable  # (params, batch) -> (loss, metrics)
    prefill: Callable  # (params, **inputs) -> last-position logits (B,1,V)
    decode_step: Callable  # (params, caches, tokens, pos) -> (logits, caches)
    init_caches: Callable  # (batch, max_seq) -> caches on ``device``
    wkv: Optional[str] = None  # rwkv6's WKV route (build_model's ``wkv``)

    def _meta(self) -> "Model":
        return build_model(self.cfg, wkv=self.wkv, device="meta")

    def abstract_params(self) -> Params:
        """The parameter tree on ``"meta"``: the reference's leaves, shapes
        and dtypes, with no data and no draw from a generator."""
        return self._meta().init(None)

    def abstract_caches(self, batch: int, max_seq: int) -> Params:
        """The decode caches on ``"meta"``."""
        return self._meta().init_caches(batch, max_seq)

    # -- dry-run inputs -----------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Model inputs on ``"meta"`` for one (arch × shape) cell, with the
        reference's shapes and dtypes."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        f = getattr(torch, cfg.dtype)

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": spec((b, 1), i32), "pos": spec((b,), i32)}
        specs: Dict[str, torch.Tensor] = {}
        s_text = s
        if cfg.family == "vlm":
            s_text = s - cfg.n_patches  # patches occupy the head of the seq
            specs["patch_embeds"] = spec((b, cfg.n_patches, cfg.d_model), f)
        if cfg.family == "encdec":
            specs["frames"] = spec((b, cfg.encoder_seq, cfg.d_model), f)
        specs["tokens"] = spec((b, s_text), i32)
        if shape.kind == "train":
            specs["labels"] = spec((b, s_text), i32)
        return specs


def build_model(cfg: ModelConfig, *, wkv: Optional[str] = None,
                device="cuda") -> Model:
    """The family's entry points bound to ``cfg``.  ``wkv`` picks the
    RWKV-6 chunked-WKV route (``rwkv6.WKV_ROUTES``; the other families
    ignore it) for both ``prefill`` and ``loss_fn``; by default ``prefill``
    runs the kernel (``"scan"``) and ``loss_fn`` the differentiable
    ``"chunked"`` form, as the reference's loss does.  ``device`` is where
    ``init`` and ``init_caches`` allocate
    (the card unless the caller asks for the CPU; raises when there is no
    card; ``"meta"`` gives shapes without data, and ``init(None)`` then
    draws nothing).  The VLM's ``prefill`` takes ``patch_embeds`` (B, n_patches,
    d_model) beside ``tokens``, the encoder–decoder's ``frames``
    (B, encoder_seq, d_model)."""
    if cfg.family in ("dense", "moe", "vlm"):
        dev = resolve_device(device)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda g: transformer.init(g, cfg, device=dev),
            loss_fn=lambda p, b: transformer.loss_fn(p, b, cfg),
            prefill=lambda p, **inp: transformer.prefill(
                p, inp["tokens"], cfg, patch_embeds=inp.get("patch_embeds")),
            decode_step=lambda p, c, t, pos: transformer.decode_step(
                p, c, t, pos, cfg),
            init_caches=lambda b, s: transformer.init_caches(cfg, b, s,
                                                             device=dev),
        )
    if cfg.family == "rwkv6":
        if wkv is not None:
            rwkv6.check_wkv(wkv)
        serve_wkv, train_wkv = wkv or "scan", wkv or "chunked"
        dev = resolve_device(device)
        return Model(
            cfg=cfg,
            device=dev,
            wkv=wkv,
            init=lambda g: rwkv6.init(g, cfg, device=dev),
            loss_fn=lambda p, b: rwkv6.loss_fn(p, b, cfg, train_wkv),
            prefill=lambda p, **inp: rwkv6.prefill(p, inp["tokens"], cfg,
                                                   serve_wkv),
            decode_step=lambda p, c, t, pos: rwkv6.decode_step(p, c, t, pos,
                                                               cfg),
            init_caches=lambda b, s: rwkv6.init_caches(cfg, b, s, device=dev),
        )
    if cfg.family == "hybrid":
        dev = resolve_device(device)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda g: ssm.init(g, cfg, device=dev),
            loss_fn=lambda p, b: ssm.loss_fn(p, b, cfg),
            prefill=lambda p, **inp: ssm.prefill(p, inp["tokens"], cfg),
            decode_step=lambda p, c, t, pos: ssm.decode_step(p, c, t, pos,
                                                             cfg),
            init_caches=lambda b, s: ssm.init_caches(cfg, b, s, device=dev),
        )
    if cfg.family == "zamba2":
        dev = resolve_device(device)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda g: zamba2.init(g, cfg, device=dev),
            loss_fn=lambda p, b: zamba2.loss_fn(p, b, cfg),
            prefill=lambda p, **inp: zamba2.prefill(p, inp["tokens"], cfg),
            decode_step=lambda p, c, t, pos: zamba2.decode_step(p, c, t, pos,
                                                                cfg),
            init_caches=lambda b, s: zamba2.init_caches(cfg, b, s,
                                                        device=dev),
        )
    if cfg.family == "kimi_linear":
        dev = resolve_device(device)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda g: kimi_linear.init(g, cfg, device=dev),
            loss_fn=lambda p, b: kimi_linear.loss_fn(p, b, cfg),
            prefill=lambda p, **inp: kimi_linear.prefill(p, inp["tokens"],
                                                         cfg),
            decode_step=lambda p, c, t, pos: kimi_linear.decode_step(
                p, c, t, pos, cfg),
            init_caches=lambda b, s: kimi_linear.init_caches(cfg, b, s,
                                                             device=dev),
        )
    if cfg.family == "encdec":
        dev = resolve_device(device)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda g: encdec.init(g, cfg, device=dev),
            loss_fn=lambda p, b: encdec.loss_fn(p, b, cfg),
            prefill=lambda p, **inp: encdec.prefill(
                p, inp["tokens"], cfg, frames=inp["frames"]),
            decode_step=lambda p, c, t, pos: encdec.decode_step(p, c, t, pos,
                                                                cfg),
            init_caches=lambda b, s: encdec.init_caches(cfg, b, s,
                                                        device=dev),
        )
    raise ValueError(f"unknown family {cfg.family}")


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch dtype map
        return torch.tensor(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.tensor(a).to(dev)  # a copy: JAX's host views are read-only


def params_from_numpy(tree, device):
    """The reference's parameter (or cache) tree as numpy arrays → the same
    tree of tensors on ``device``.  Dicts, lists and tuples keep their
    structure, so ``quantize_tree``'s ``(codes, scale)`` pairs stay pairs,
    their codes K-major as the port's ``quantize_tree`` stores them."""
    dev = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return _tensor(node, dev)

    return k_major_pairs(visit(tree))
