"""The benchmark loads neither JAX nor the JAX package: importing the
harness, the reference and every reader, in a fresh process, leaves no
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``repro``; and a run refuses to start where no card is."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHECK = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import bench, deploy, traffic, work, profile
from portbench.reference import dataplane, lm
from portbench.surfaces import lm_prefill
import repro_torch.launch.serve, repro_torch.flow, repro_torch.forest
spec = bench.load_benchmark()
for m in spec["per_layer"]:
    bench.load_reader(m["name"])
print("BAD", bench.forbidden_modules())
sys.exit(1 if bench.forbidden_modules() else 0)
"""


def test_no_jax_loaded():
    code = _CHECK.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_forbidden_names_compared_whole():
    sys.path[:0] = [str(ROOT)]
    from portbench import bench

    names = ["repro_torch", "repro_torch.core", "jaxtyping", "reprolib",
             "jax", "jax.numpy", "jaxlib.xla", "flax.linen", "repro",
             "repro.core.ingress", "numpy"]
    assert bench.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "repro",
         "repro.core.ingress"])


def test_run_refuses_without_card():
    code = ("import torch, runpy, sys; "
            "torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', 'feat16.sat_dup30', "
            "'--seed', '1', '--seconds', '1', '--trace', '0']; "
            "runpy.run_path('portbench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "needs 1 CUDA device" in out.stderr


def test_refuses_outside_a_checkout(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the
    program is missing: the run fails and prints no result."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import torch, runpy, sys; "
            "torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv = ['run.py', '--workload', 'feat16.sat_dup30', "
            "'--seed', '1', '--seconds', '1', '--trace', '0']; "
            "runpy.run_path('portbench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
