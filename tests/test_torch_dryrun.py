"""The port's dry run (``repro_torch.launch.dryrun``) on a small fake mesh,
the mirror of ``tests/test_dryrun_small.py``, and the meta-device model
specs (``abstract_params`` / ``abstract_caches`` / ``input_specs``) against
the reference's ``jax.eval_shape`` trees.

Four reduced train cells run on an 8-rank fake (2, 4) mesh: their FLOPs,
bytes, collective bytes and temporaries must be positive and their
fallback log must equal the reference's plans' (parameters, optimizer
state, batch) word for word.  Specs are compared exactly: the same leaf
paths, shapes and dtypes, on the meta device (nothing allocated).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import SHAPES as REF_SHAPES
from repro.distributed import sharding as ref_sh
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tree as T
from repro_torch.launch.dryrun import dry_run
from repro_torch.models import build_model


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


_SMALL = dict(d_model=256, n_heads=8, n_kv_heads=4, head_dim=32, d_ff=512,
              accum_steps=1)


def _ref_fallbacks(arch: str, shape) -> list:
    """The reference's plan fallbacks for the cell: parameters, optimizer
    state and batch, in the order its dry run collects them."""
    from repro.optim import AdamWConfig
    from repro.optim import adamw as ref_adamw
    cfg = ref_reduced(ref_get_config(arch), **_SMALL)
    model = ref_build_model(cfg)
    mesh = _FakeMesh((("data", 2), ("model", 4)))
    params = model.abstract_params()
    fb = list(ref_sh.make_plan(params, cfg, mesh, fsdp_min=1 << 12).fallbacks)
    opt = jax.eval_shape(lambda p: ref_adamw.init(p, AdamWConfig(
        state_bits=cfg.opt_state_bits)), params)
    fb += ref_sh.make_plan(opt, cfg, mesh, fsdp_min=1 << 12).fallbacks
    ref_sh.batch_spec(mesh, shape.global_batch, fb)
    return fb


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m",
                                  "deepseek-v2-236b", "whisper-base"])
def test_train_cell_traces_on_8_rank_mesh(arch):
    cfg = reduced(get_config(arch), **_SMALL)
    shape = ShapeConfig("t", seq_len=64, global_batch=4, kind="train")
    rec = dry_run(cfg, shape, (2, 4), ("data", "model"), fsdp_min=1 << 12)
    assert rec["status"] == "ok"
    assert rec["cost"]["flops"] > 0
    assert rec["cost"]["bytes"] > 0
    assert sum(rec["collectives"].values()) > 0  # sharded training talks
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["alias_bytes"] > 0  # the update is in place
    assert rec["fallbacks"] == _ref_fallbacks(arch, shape)
    assert not torch.distributed.is_initialized()  # the fake group is gone


def test_prefill_and_decode_cells_trace():
    """A prefill and a decode cell of the reduced qwen2 on the same mesh:
    positive costs; decode caches placed by ``cache_specs``."""
    cfg = reduced(get_config("qwen2-1.5b"), **_SMALL)
    for kind in ("prefill", "decode"):
        shape = ShapeConfig("t", seq_len=64, global_batch=4, kind=kind)
        rec = dry_run(cfg, shape, (2, 4), ("data", "model"),
                      fsdp_min=1 << 12)
        assert rec["cost"]["flops"] > 0, kind
        assert rec["memory"]["peak_est_bytes"] > 0, kind


def _sig(tree):
    return [(p, tuple(l.shape), str(l.dtype).split(".")[-1])
            for p, l in T.leaves_with_paths(tree)]


def _ref_sig(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(l.shape), jnp.dtype(l.dtype).name)
            for p, l in flat]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_specs_match_reference(arch):
    """Full-size ``abstract_params``, ``abstract_caches`` and
    ``input_specs`` for every shape kind: the reference's leaves, shapes
    and dtypes, all on ``"meta"``."""
    ref = ref_build_model(ref_get_config(arch))
    model = build_model(get_config(arch), device="meta")
    params = model.abstract_params()
    assert _sig(params) == _ref_sig(ref.abstract_params())
    caches = model.abstract_caches(8, 128)
    assert _sig(caches) == _ref_sig(ref.abstract_caches(8, 128))
    for name in SHAPES:
        assert _sig(model.input_specs(SHAPES[name])) == _ref_sig(
            ref.input_specs(REF_SHAPES[name])), name
    for leaf in T.leaves((params, caches)):
        assert leaf.device.type == "meta"


def test_meta_model_refuses_nothing_and_allocates_nothing():
    """The 236B config's parameter tree on meta: 239e9 elements, no
    storage behind them."""
    params = build_model(get_config("deepseek-v2-236b"),
                         device="meta").abstract_params()
    n = sum(l.numel() for l in T.leaves(params))
    assert n > 2.3e11
    assert all(l.untyped_storage().data_ptr() == 0 for l in T.leaves(params))
