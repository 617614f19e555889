"""The port's distribution substrate against the reference's
(``repro.distributed``): the sharding plan leaf by leaf, batch and cache
specs, the rule engine's cases, elastic plans, collective accounting under
the fake process group and the int8-compressed all-reduce on gloo ranks.

Plans are compared exactly (each leaf's spec tuple and the fallback list,
word for word, in order); the compressed all-reduce is held within 0.02 of
the exact sum (the reference's bound) and within one re-quantization step
per element of the reference's own output on the same seeded input.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_sh
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import tree as T
from repro_torch.distributed import sharding as sh
from repro_torch.models import build_model

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MESHES = {
    "16x16": (("data", 16), ("model", 16)),
    "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
    "2x4": (("data", 2), ("model", 4)),
}


class _FakeMesh:
    """Duck-typed mesh for the pure rule-engine tests (no devices)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def _ref_specs(plan):
    return {p: tuple(s) for p, s in plan.specs.items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_matches_reference_leaf_by_leaf(arch):
    """Every leaf's spec and the fallback list, on the production meshes
    and a (2, 4) mesh, at full size (tolerance: exact)."""
    ref_params = ref_build_model(ref_get_config(arch)).abstract_params()
    params = build_model(get_config(arch), device="meta").abstract_params()
    assert all(l.device.type == "meta" for l in T.leaves(params))
    for name, shape in _MESHES.items():
        mesh = _FakeMesh(shape)
        ref = ref_sh.make_plan(ref_params, ref_get_config(arch), mesh)
        got = sh.make_plan(params, get_config(arch), mesh)
        assert got.specs == _ref_specs(ref), name
        assert got.fallbacks == ref.fallbacks, name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_match_reference(arch):
    """``cache_specs`` (and ``batch_spec`` inside it) on each family's
    decode caches at decode_32k's batch, exactly."""
    b, s = 128, 256
    ref_caches = ref_build_model(ref_get_config(arch)).abstract_caches(b, s)
    caches = build_model(get_config(arch), device="meta").abstract_caches(
        b, s)
    for name, shape in _MESHES.items():
        mesh = _FakeMesh(shape)
        ref_fb, fb = [], []
        ref = ref_sh.cache_specs(ref_caches, ref_get_config(arch), mesh, b,
                                 ref_fb)
        got = sh.cache_specs(caches, get_config(arch), mesh, b, fb)
        assert got.specs == _ref_specs(ref), name
        assert fb == ref_fb, name


@pytest.mark.parametrize("batch", [256, 32, 1])
def test_batch_spec_matches_reference(batch):
    for shape in _MESHES.values():
        mesh = _FakeMesh(shape)
        ref_fb, fb = [], []
        assert sh.batch_spec(mesh, batch, fb) == tuple(
            ref_sh.batch_spec(mesh, batch, ref_fb))
        assert fb == ref_fb


def test_opt_state_plan_matches_reference():
    """The int8-moment optimizer state of qwen2-1.5b plans as the
    reference's (codes like the parameter, per-row scales)."""
    from repro.optim import AdamWConfig as RefCfg
    from repro.optim import adamw as ref_adamw
    from repro_torch.optim import AdamWConfig, adamw
    cfg = get_config("qwen2-1.5b")
    ref_abs = ref_build_model(ref_get_config("qwen2-1.5b")).abstract_params()
    ref_opt = jax.eval_shape(lambda p: ref_adamw.init(p, RefCfg(
        state_bits=8)), ref_abs)
    opt = adamw.init(build_model(cfg, device="meta").abstract_params(),
                     AdamWConfig(state_bits=8))
    mesh = _FakeMesh(_MESHES["16x16"])
    ref = ref_sh.make_plan(ref_opt, ref_get_config("qwen2-1.5b"), mesh)
    got = sh.make_plan(opt, cfg, mesh)
    assert got.specs == _ref_specs(ref)
    assert got.fallbacks == ref.fallbacks


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh(_MESHES["2x16x16"])
    assert sh.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert sh.placements((), mesh) == [Replicate()] * 3
    assert sh.placements((None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]


class TestShardingRules:
    """The reference's ``TestShardingRules`` on the port's plan."""

    def _plan(self, arch, mesh_shape=(("data", 16), ("model", 16))):
        cfg = get_config(arch)
        params = build_model(cfg, device="meta").abstract_params()
        return sh.make_plan(params, cfg, _FakeMesh(mesh_shape)), cfg

    def test_gemma_attention_tp(self):
        plan, _ = self._plan("gemma-7b")
        wq = [s for p, s in plan.specs.items() if "'wq'" in p][0]
        assert wq[-1] == "model"

    def test_qwen2_heads_fallback(self):
        """12 heads % 16 ⇒ attention col-TP blocked, recorded; MLP TP'd."""
        plan, _ = self._plan("qwen2-1.5b")
        assert any("col-TP blocked" in f for f in plan.fallbacks)
        up = [s for p, s in plan.specs.items()
              if "'up'" in p and "'w'" in p][0]
        assert up[-1] == "model"  # d_ff 8960 = 16·560

    def test_granite20b_mqa_kv_replicated(self):
        plan, _ = self._plan("granite-20b")
        wk = [s for p, s in plan.specs.items()
              if "'wk'" in p and "'w'" in p][0]
        assert wk[-1] != "model"  # kv=1 head can't shard
        wq = [s for p, s in plan.specs.items()
              if "'wq'" in p and "'w'" in p][0]
        assert wq[-1] == "model"  # 48 = 16·3

    def test_deepseek_expert_parallel(self):
        plan, _ = self._plan("deepseek-v2-236b")
        wg = [s for p, s in plan.specs.items() if "w_gate" in p][0]
        assert "model" in [a for a in wg if a]  # 160 experts = 16·10 ⇒ EP

    def test_granite_moe_ep_fallback(self):
        plan, _ = self._plan("granite-moe-3b-a800m")
        assert any("EP blocked" in f for f in plan.fallbacks)
        wg = [s for p, s in plan.specs.items() if "w_gate" in p][0]
        assert "model" not in [a for a in wg if a]

    def test_vocab_shard_fallback(self):
        """granite-moe vocab 49155 % 16 ≠ 0 ⇒ embed shards d_model."""
        plan, _ = self._plan("granite-moe-3b-a800m")
        emb = [s for p, s in plan.specs.items() if "'embed'" in p][0]
        assert emb[-1] == "model"  # d_model 1536 = 16·96
        assert any("vocab-shard blocked" in f for f in plan.fallbacks)

    def test_fsdp_applies_to_large_leaves(self):
        plan, _ = self._plan("gemma-7b")
        big = [s for p, s in plan.specs.items()
               if "'up'" in p and "'w'" in p][0]
        assert "data" in [a for a in big if a]

    def test_norms_replicated(self):
        plan, _ = self._plan("gemma-7b")
        for p, s in plan.specs.items():
            if "norm" in p and "scale" in p:
                assert all(a is None for a in s), p

    def test_batch_spec_divisibility(self):
        mesh = _FakeMesh((("pod", 2), ("data", 16), ("model", 16)))
        fb = []
        assert sh.batch_spec(mesh, 256, fb) == (("pod", "data"),)
        assert sh.batch_spec(_FakeMesh(_MESHES["16x16"]), 256) == ("data",)
        fb2 = []
        assert sh.batch_spec(mesh, 1, fb2) == ()  # long_500k
        assert len(fb2) == 2


class TestElastic:
    """The reference's ``TestElastic`` on the port."""

    def test_downsize_plan(self):
        from repro_torch.distributed import plan_downsized_mesh
        plan = plan_downsized_mesh(200, model=16, old_data=16)
        assert plan.shape == (8, 16)  # largest pow2 data ≤ 12
        assert plan.accum_multiplier == 2
        assert plan.dropped_devices == 200 - 128

    def test_too_few_devices_raises(self):
        from repro_torch.distributed import plan_downsized_mesh
        with pytest.raises(ValueError):
            plan_downsized_mesh(8, model=16)

    @pytest.mark.parametrize("n", [16, 31, 64, 100, 256, 300, 511])
    def test_matches_reference(self, n):
        from repro.distributed import plan_downsized_mesh as ref_plan
        from repro_torch.distributed import plan_downsized_mesh
        assert plan_downsized_mesh(n) == plan_downsized_mesh(n)
        got, ref = plan_downsized_mesh(n), ref_plan(n)
        assert (got.shape, got.axis_names, got.dropped_devices,
                got.accum_multiplier) == (ref.shape, ref.axis_names,
                                          ref.dropped_devices,
                                          ref.accum_multiplier)


def test_collective_counter_counts_shapes():
    """The reference's ``test_counts_shapes`` numbers from collectives
    issued under the fake process group: a bf16 (16, 1024) all-gather, an
    f32 (128,) all-reduce, and two f32 (64,) all-to-alls."""
    import torch.distributed._functional_collectives as fc
    from repro_torch.distributed import CollectiveCounter
    from repro_torch.launch.mesh import fake_world
    with fake_world(16):
        group = torch.distributed.group.WORLD
        c = CollectiveCounter()
        with c:
            fc.all_gather_tensor(torch.zeros(1, 1024, dtype=torch.bfloat16),
                                 0, group).wait()
            fc.all_reduce(torch.zeros(128), "sum", group).wait()
            for _ in range(2):
                fc.all_to_all_single(torch.zeros(64), None, None,
                                     group).wait()
    got = c.result()
    assert got["all-gather"] == 16 * 1024 * 2
    assert got["all-reduce"] == 128 * 4
    assert got["all-to-all"] == 2 * 64 * 4
    assert got["_counts"] == {"all-gather": 1, "all-reduce": 1,
                              "all-to-all": 2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_REF_AR = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys; sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.collectives import compressed_all_reduce, shard_map
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((8,), ("d",))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 1000)),
                    jnp.float32)
    y = jax.jit(shard_map(lambda x: compressed_all_reduce(x, "d"), mesh=mesh,
                          in_specs=jax.sharding.PartitionSpec("d"),
                          out_specs=jax.sharding.PartitionSpec("d")))(x)
    np.save(sys.argv[1], np.asarray(y)[0])
""")

_PORT_AR = textwrap.dedent("""
    import sys; sys.path.insert(0, "src")
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.distributed import compressed_all_reduce
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=8, rank=rank)
    x = np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32)
    y = compressed_all_reduce(torch.from_numpy(x[rank:rank + 1]))
    if rank == 0:
        np.save(out, y.numpy()[0])
    dist.destroy_process_group()
""")


def test_compressed_all_reduce_on_8_gloo_ranks(tmp_path):
    """int8-wire all-reduce on 8 gloo CPU ranks ≈ the exact sum (relative
    0.02, the reference's bound) and the reference's own output within one
    re-quantization step (its phase-2 scale) per element."""
    ref_out, got_out = tmp_path / "ref.npy", tmp_path / "got.npy"
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # 8 ranks on a few cores
    procs = [subprocess.Popen([sys.executable, "-c", _PORT_AR, str(r),
                               str(port), str(got_out)], cwd=_ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(8)]
    r = subprocess.run([sys.executable, "-c", _REF_AR, str(ref_out)],
                       cwd=_ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    x = np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32)
    want = x.sum(0)
    got, ref = np.load(got_out), np.load(ref_out)
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 0.02, rel
    step = np.abs(want).max() / 127.0 * 1.01  # largest phase-2 scale
    assert np.abs(got - ref).max() <= step
