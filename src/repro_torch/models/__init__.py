"""Model substrate: the assigned LM architectures behind one API.  The
RWKV-6 family is ported (its prefill runs the hand-written WKV kernel);
the transformer, SSM and encoder-decoder families come with later slices."""

from . import api, layers, rwkv6
from .api import Model, build_model, params_from_numpy

__all__ = ["api", "layers", "rwkv6", "Model", "build_model",
           "params_from_numpy"]
