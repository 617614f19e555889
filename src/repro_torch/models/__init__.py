"""Model substrate: the assigned LM architectures behind one API.  The
transformer families (dense, MoE with MLA, VLM; their quantized
projections run the hand-written W8A8 kernel) and RWKV-6 (its prefill runs
the hand-written WKV kernel) are ported; the SSM and encoder-decoder
families come with a later slice."""

from . import api, flash, layers, mla, rwkv6, transformer
from .api import Model, build_model, params_from_numpy

__all__ = ["api", "flash", "layers", "mla", "rwkv6", "transformer", "Model",
           "build_model", "params_from_numpy"]
