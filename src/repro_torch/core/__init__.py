"""Fixed-point arithmetic, Taylor constants, the packet codec and the
control-plane/data-plane split of the serving path."""

from .control_plane import ControlPlane, ModelTables, tables_from_numpy
from .inference import DataPlaneEngine, DeviceResult

__all__ = ["ControlPlane", "ModelTables", "tables_from_numpy",
           "DataPlaneEngine", "DeviceResult"]
