"""Model configurations: the paper's packet models that the serving path
installs, and the registry of the assigned LM architectures
(``get_config("<arch-id>")``), counterpart of ``repro.configs``."""

from __future__ import annotations

from . import (base, chatglm3_6b, deepseek_v2, deepseek_v2_236b, gemma_7b,
               granite_20b, granite_moe_3b_a800m, kimi_linear_48b,
               pixtral_12b, qwen2_1_5b, rwkv6_3b, whisper_base, zamba2_2_7b,
               zamba2_7b)
from .base import SHAPES, ModelConfig, ShapeConfig, reduced
from .paper_models import PAPER_MODELS, make_paper_model, train_qos_regressor

_MODULES = {
    "gemma-7b": gemma_7b,
    "qwen2-1.5b": qwen2_1_5b,
    "chatglm3-6b": chatglm3_6b,
    "granite-20b": granite_20b,
    "rwkv6-3b": rwkv6_3b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "deepseek-v2-236b": deepseek_v2_236b,
    "zamba2-2.7b": zamba2_2_7b,
    "pixtral-12b": pixtral_12b,
    "whisper-base": whisper_base,
}

#: the assigned architectures, the reference's registry
ARCH_NAMES = tuple(_MODULES)

#: architectures the port registers beyond the reference's, at their
#: published configurations (not dry-run cells)
_PUBLISHED = {"deepseek-v2": deepseek_v2, "zamba2-7b": zamba2_7b,
              "kimi-linear-48b": kimi_linear_48b}

#: archs whose attention is sub-quadratic (or hybrid) — the only ones that
#: run ``long_500k`` (full attention is quadratic at 500k tokens)
SUBQUADRATIC = ("rwkv6-3b", "zamba2-2.7b")


def get_config(name: str) -> ModelConfig:
    try:
        return {**_MODULES, **_PUBLISHED}[name].CONFIG
    except KeyError:
        raise KeyError(f"unknown arch '{name}'; choose from "
                       f"{ARCH_NAMES + tuple(_PUBLISHED)}") from None


def cells(include_skipped: bool = False):
    """Every (arch × shape) dry-run cell, with skip annotations.

    Yields (arch_name, shape_name, runnable, reason)."""
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in SUBQUADRATIC:
                if include_skipped:
                    yield arch, shape, False, "full attention is quadratic at 500k (DESIGN.md §5)"
                continue
            yield arch, shape, True, ""


__all__ = ["get_config", "reduced", "cells", "ARCH_NAMES", "SUBQUADRATIC",
           "SHAPES", "ModelConfig", "ShapeConfig", "base", "PAPER_MODELS",
           "make_paper_model", "train_qos_regressor"]
