"""Hand-written Hopper kernels of the serving path and their plain PyTorch
versions.

  * ``fixedpoint_mlp``   — fused multi-model fixed-point MLP
    (``csrc/fixedpoint_mlp.cu``; weight lanes ``"int16"`` and ``"int8"``)
  * ``forest_traversal`` — multi-forest tree-ensemble traversal
    (``csrc/forest_traversal.cu``; the pointer chase and the range table)
  * ``ref``              — the plain versions every kernel is held to
  * ``ops``              — ``fused_mlp`` and ``forest_traverse`` with
    backend dispatch
  * ``fused_serve``      — ``serve_lanes``, the lane-dispatch core
"""
