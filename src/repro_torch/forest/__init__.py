"""In-network tree-ensemble engine (pForest / Planter analogue).

Counterpart of ``repro.forest``: trained decision-tree ensembles compile
into the control plane's dense node tables and serve through the same data
plane and ingress pipeline as the MLP family.

  * ``compile``   — pure-NumPy CART trainer, sklearn-convention import path,
                    fixed-point threshold/leaf quantization, table packing
  * ``ranges``    — the pForest range-table compilation served by the
                    ``"range"`` traversal, walk-validated at install
  * traversal     — ``repro_torch.kernels.forest_traversal`` (hand-written
                    CUDA kernels for the pointer chase and the range form)
  * installation  — ``ControlPlane.install_forest`` (generation-swapped;
                    both lowerings publish in one swap)
"""

from .compile import (FOREST_CLASSIFY, FOREST_REGRESS, DecisionTree, Forest,
                      PackedForest, pack_forest, predict_float, train_forest,
                      train_tree)
from .ranges import RangePacked, pack_forest_ranges, range_bounds

__all__ = ["DecisionTree", "Forest", "PackedForest", "pack_forest",
           "predict_float", "train_forest", "train_tree",
           "FOREST_REGRESS", "FOREST_CLASSIFY",
           "RangePacked", "pack_forest_ranges", "range_bounds"]
