"""Hand-written Hopper kernels and their plain PyTorch versions.

  * ``fixedpoint_mlp``   — fused multi-model fixed-point MLP
    (``csrc/fixedpoint_mlp.cu``; weight lanes ``"int16"`` and ``"int8"``)
  * ``forest_traversal`` — multi-forest tree-ensemble traversal
    (``csrc/forest_traversal.cu``; the pointer chase and the range table)
  * ``flow_update``      — the flow engine's per-flow register update,
    count-min sketch and feature emit (``csrc/flow_update.cu``), with its
    numpy rank-round lowering
  * ``fixedpoint_matmul`` — the paper's W8A8 GEMM (C1) on the int8 tensor
    cores (``csrc/fixedpoint_matmul.cu``)
  * ``taylor_activation`` — the paper's integer Horner activation (C2)
    (``csrc/taylor_activation.cu``)
  * ``wkv_scan``          — RWKV-6's chunked WKV recurrence in float32
    (``csrc/wkv_scan.cu``), the LM prefill's one kernel
  * ``flash_attention``   — flash attention's causal forward on wgmma and
    TMA (``csrc/flash_attention.cu``), grouped K/V read by index;
    ``models/flash.py`` takes it where its input allows
  * ``row_quantize``      — the W8A8 linear's per-row activation quantize
    in one pass (``csrc/row_quantize.cu``); ``core.quantize.absmax_quantize``
    takes it where its input allows
  * ``ssd_scan``          — the Mamba-2 SSD of a prefill in float32 accuracy,
    each head's state on chip across its chunks (``csrc/ssd_scan.cu``);
    ``models.zamba2.ssd`` takes it where its input allows
  * ``result_cache``     — the ingress result cache's probe sweeps as one
    host call per chunk (``csrc/result_cache.cpp``, built with the host
    C++ compiler)
  * ``ref``              — the plain versions every kernel is held to
  * ``ops``              — ``fused_mlp``, ``forest_traverse``,
    ``flow_update``, ``fixedpoint_matmul``, ``taylor_activation`` and
    ``wkv_scan`` with backend dispatch
  * ``fused_serve``      — ``serve_lanes``, the lane-dispatch core, and
    ``serve_raw``, the fused raw-packet program
"""

from .ops import fixedpoint_matmul, taylor_activation, wkv_scan  # noqa: E402

__all__ = ["fixedpoint_matmul", "taylor_activation", "wkv_scan"]
