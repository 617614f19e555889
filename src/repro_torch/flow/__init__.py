"""Stateful flow engine — in-line per-flow feature extraction feeding the
data plane (the pForest / Planter stateful stage).

Counterpart of ``repro.flow``:

  * ``table``     — :class:`FlowTable`: vectorized open-addressing 5-tuple
                    → register-slot table (exact key verify, idle expiry,
                    tombstone compaction, eviction that can never serve one
                    flow another flow's registers)
  * update kernel — ``repro_torch.kernels.flow_update``: the sequential
                    scatter-update of the register file + count-min sketch
                    (a hand-written CUDA kernel on the card, the rank-round
                    numpy lowering on the CPU, both bit-exact against the
                    pure-Python oracle ``kernels.ref.flow_update_numpy``)
  * ``frontend``  — :class:`FlowFrontend`: ``submit_raw()`` wires parse →
                    flow-update → per-model FeatureSpec gather → the
                    ingress pipeline (dedup / result cache / lane-pure
                    dispatch)

Feature-to-model mapping lives in the control plane
(``ControlPlane.install_feature_spec``) with the same generation-swap
discipline as the weight tables.
"""

from ..kernels.ref import (FLOW_FEATURE_NAMES, N_FLOW_FEATURES,
                           N_FLOW_REGISTERS)
from .frontend import FlowFrontend, FlowParams, reference_features
from .table import FlowTable

__all__ = ["FlowTable", "FlowFrontend", "FlowParams", "reference_features",
           "FLOW_FEATURE_NAMES", "N_FLOW_FEATURES", "N_FLOW_REGISTERS"]
