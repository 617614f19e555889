"""Model substrate: the assigned LM architectures behind one API.  The
transformer families (dense, MoE with MLA, VLM), the Zamba2 hybrid of
Mamba-2 layers and a shared attention block, and the Whisper
encoder–decoder (their quantized projections run the hand-written W8A8
kernel), and RWKV-6 (its prefill runs the hand-written WKV kernel)."""

from . import (api, encdec, flash, layers, mla, rwkv6, ssm, taps,
               transformer)
from .api import Model, build_model, params_from_numpy

__all__ = ["api", "encdec", "flash", "layers", "mla", "rwkv6", "ssm",
           "taps", "transformer", "Model", "build_model", "params_from_numpy"]
