"""Model substrate: the assigned LM architectures behind one API.  The
transformer families (dense, MoE with MLA, VLM), the Zamba2 hybrid of
Mamba-2 layers and a shared attention block (and Zamba2 as published:
grouped B/C, two shared blocks with LoRA adapters), Kimi Linear (Kimi
Delta Attention beside MLA, sigmoid-routed experts), and the Whisper
encoder–decoder (their quantized projections run the hand-written W8A8
kernel), and RWKV-6 (its prefill runs the hand-written WKV kernel)."""

from . import (api, encdec, flash, kda, kimi_linear, layers, mla, rwkv6,
               ssm, taps, transformer, zamba2)
from .api import Model, build_model, params_from_numpy

__all__ = ["api", "encdec", "flash", "kda", "kimi_linear", "layers", "mla",
           "rwkv6", "ssm", "taps", "transformer", "zamba2", "Model",
           "build_model", "params_from_numpy"]
