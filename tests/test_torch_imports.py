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
    "import repro_torch.flow, repro_torch.flow.table, "
    "repro_torch.flow.frontend, repro_torch.kernels.flow_update",
    "import repro_torch.core.quantize, repro_torch.core.taylor, "
    "repro_torch.core.losses, repro_torch.core.fixedpoint, "
    "repro_torch.kernels.fixedpoint_matmul, "
    "repro_torch.kernels.taylor_activation",
    "import repro_torch.models, repro_torch.models.rwkv6, "
    "repro_torch.models.api, repro_torch.models.layers, "
    "repro_torch.kernels.wkv_scan, repro_torch.distributed, "
    "repro_torch.core.control_plane",
    "import repro_torch.configs, repro_torch.configs.base, "
    "repro_torch.configs.rwkv6_3b, repro_torch.configs.gemma_7b, "
    "repro_torch.configs.qwen2_1_5b, repro_torch.configs.chatglm3_6b, "
    "repro_torch.configs.granite_20b, "
    "repro_torch.configs.granite_moe_3b_a800m, "
    "repro_torch.configs.deepseek_v2_236b, repro_torch.configs.zamba2_2_7b, "
    "repro_torch.configs.pixtral_12b, repro_torch.configs.whisper_base",
    "from repro_torch.launch.serve import LMServer, PacketServer",
    "import repro_torch.serve.fabric, repro_torch.serve.reflex, "
    "repro_torch.launch.mesh",
    "from repro_torch.launch.serve import ShardedPacketServer, main",
    "import repro_torch.models.transformer, repro_torch.models.mla, "
    "repro_torch.models.flash",
    "import repro_torch.models.ssm, repro_torch.models.encdec, "
    "repro_torch.data.packets",
    "sys.path.insert(0, '.'); import chip_smoke",
    "import repro_torch.optim, repro_torch.optim.adamw, "
    "repro_torch.optim.schedule, repro_torch.data.tokens, "
    "repro_torch.checkpoint, repro_torch.checkpoint.store, "
    "repro_torch.checkpoint.manager, repro_torch.core.tree",
    "from repro_torch.launch.train import TrainLoop, main",
    "import repro_torch.distributed, repro_torch.distributed.sharding, "
    "repro_torch.distributed.constrain, repro_torch.distributed.collectives, "
    "repro_torch.distributed.elastic, repro_torch.distributed.cost",
    "import repro_torch.launch.dryrun, repro_torch.launch.mesh; "
    "from repro_torch.launch.dryrun import run_cell, run_cells, main",
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


def test_lm_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import build_model, rwkv6
    cfg = reduced(get_config("rwkv6-3b"))
    with pytest.raises(RuntimeError, match="cuda"):
        LMServer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        rwkv6.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        rwkv6.init_caches(cfg, 2)
    from repro_torch.models import transformer
    for arch in ("qwen2-1.5b", "deepseek-v2-236b", "pixtral-12b"):
        cfg = reduced(get_config(arch))
        with pytest.raises(RuntimeError, match="cuda"):
            LMServer(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            transformer.init(torch.Generator(), cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            transformer.init_caches(cfg, 2, 8)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-base"])
def test_hybrid_and_encdec_entry_points_without_a_card_raise(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import LMServer
    from repro_torch.models import build_model, encdec, ssm
    cfg = reduced(get_config(arch))
    module = ssm if cfg.family == "hybrid" else encdec
    with pytest.raises(RuntimeError, match="cuda"):
        LMServer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        module.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        module.init_caches(cfg, 2, 8)


def test_train_loop_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import TrainLoop, main
    with pytest.raises(RuntimeError, match="cuda"):
        TrainLoop(reduced(get_config("qwen2-1.5b")))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"])


def test_mesh_on_a_missing_card_raises():
    """``make_mesh(..., device="cuda")`` with no card raises; the dry run's
    ``"meta"`` mesh is not a fall-back and works without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    from repro_torch.launch.mesh import fake_world, make_mesh
    with fake_world(4):
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh((2, 2), ("data", "model"))
        assert make_mesh((2, 2), ("data", "model"),
                         device="meta").device_type == "cpu"
