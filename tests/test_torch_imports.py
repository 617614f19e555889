"""The port stands alone: importing its serving entry point, or
``chip_smoke.py``'s imports, loads neither JAX nor the JAX package; and its
entry points refuse to run on a card that is not there."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_CHECK = """
import sys
{imports}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def _run(imports: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", _CHECK.format(imports=imports)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("imports", [
    "import repro_torch.launch.serve",
    "import repro_torch.core, repro_torch.kernels.ops, "
    "repro_torch.kernels.fused_serve, repro_torch.configs, repro_torch.obs, "
    "repro_torch.serve",
    "import repro_torch.forest, repro_torch.forest.synthetic, "
    "repro_torch.data, repro_torch.kernels.forest_traversal",
    "sys.path.insert(0, '.'); import chip_smoke",
])
def test_port_imports_no_jax_and_no_reference(imports):
    r = _run(imports)
    assert r.returncode == 0, r.stdout + r.stderr


def test_packet_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.core.inference import DataPlaneEngine
    from repro_torch.launch.serve import PacketServer
    with pytest.raises(RuntimeError, match="cuda"):
        PacketServer()
    with pytest.raises(RuntimeError, match="cuda"):
        DataPlaneEngine(ControlPlane())


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
