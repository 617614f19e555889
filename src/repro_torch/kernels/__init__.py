"""Hand-written Hopper kernels of the serving path and their plain PyTorch
versions.

  * ``fixedpoint_mlp``   — fused multi-model fixed-point MLP
    (``csrc/fixedpoint_mlp.cu``; weight lanes ``"int16"`` and ``"int8"``)
  * ``forest_traversal`` — multi-forest tree-ensemble traversal
    (``csrc/forest_traversal.cu``; the pointer chase and the range table)
  * ``flow_update``      — the flow engine's per-flow register update,
    count-min sketch and feature emit (``csrc/flow_update.cu``), with its
    numpy rank-round lowering
  * ``ref``              — the plain versions every kernel is held to
  * ``ops``              — ``fused_mlp``, ``forest_traverse`` and
    ``flow_update`` with backend dispatch
  * ``fused_serve``      — ``serve_lanes``, the lane-dispatch core, and
    ``serve_raw``, the fused raw-packet program
"""
