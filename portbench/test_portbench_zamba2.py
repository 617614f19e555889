"""The hybrid prefill surface on the CPU at a small size: a whole run,
traced and untraced, comes out correct and well formed; every control of
the cell (a program made wrong on purpose) makes it not correct; faults
planted in the program underneath a run are caught; the configuration is
the published one; the work model counts the call as the published widths
give it; and the reference loads neither JAX, the JAX package nor the
port."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, deploy, work_zamba2  # noqa: E402
from portbench.surfaces import hybrid_prefill as S  # noqa: E402

CELL = "zamba2_7b.prefill_4x4k"
# Zamba2-7B-Instruct's published config.json (Zyphra; its 81-entry
# layers_block_type is the hybrid ids' pattern)
PUBLISHED = {
    "adapter_rank": 128, "add_bias_linear": False, "attention_head_dim": 224,
    "attention_hidden_size": 7168, "chunk_size": 256,
    "ffn_hidden_size": 14336, "hidden_act": "gelu", "hidden_size": 3584,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    "intermediate_size": 14336, "kv_channels": 112, "mamba_d_conv": 4,
    "mamba_d_state": 64, "mamba_expand": 2, "mamba_headdim": 64,
    "mamba_ngroups": 2, "max_position_embeddings": 4096,
    "model_type": "zamba2", "n_mamba_heads": 112, "num_attention_heads": 32,
    "num_hidden_layers": 81, "num_key_value_heads": 32,
    "num_logits_to_keep": 1, "num_mem_blocks": 2, "num_query_groups": 32,
    "rms_norm_eps": 1e-05, "rope_theta": 10000, "time_step_floor": 0.0001,
    "time_step_limit": None, "time_step_max": 0.1, "time_step_min": 0.001,
    "use_conv_bias": True, "use_long_context": False, "use_mem_rope": True,
    "use_shared_attention_adapter": False, "use_shared_mlp_adapter": True,
    "vocab_size": 32000}
IDS = [2, 5, 8]
# a reduced Zamba2 in the config.json keys; dt up to 1, so that the SSD's
# decays reach far below its chunk sums' bf16 precision
SMALL = dict(num_hidden_layers=10, hidden_size=64, hybrid_layer_ids=IDS,
             layers_block_type=["hybrid" if i in IDS else "mamba"
                                for i in range(10)],
             num_attention_heads=4, num_key_value_heads=4,
             num_query_groups=4, attention_head_dim=32,
             attention_hidden_size=128, intermediate_size=96,
             ffn_hidden_size=96, n_mamba_heads=4, mamba_headdim=32,
             mamba_ngroups=2, mamba_d_state=16, adapter_rank=8,
             vocab_size=97, time_step_min=0.05, time_step_max=1.0)
# over one 512-row flash block and nine SSD chunks
MIX = dict(batch=2, seq=600, pool_batches=4)
CHECKS = {"logit_rel_l2_max", "logit_rows_over_tol", "mamba_rel_l2_max",
          "shared_rel_l2_max", "glue_rel_l2_max", "chain_breaks",
          "nonfinite_logits", "replay_mismatch"}


def small_run(seed: int = 11, trace: bool = False, **over):
    torch.set_num_threads(1)
    spec = bench.load_benchmark()
    return bench.run(bench.find_workload(spec, CELL), spec, seed=seed,
                     seconds=0.3, trace=trace, device="cpu",
                     mix_override=MIX, server_override=dict(SMALL, **over))


def test_configuration_is_the_published_one():
    cfg_file = deploy.load_config("zamba2_7b")
    published = dict(PUBLISHED, layers_block_type=[
        "hybrid" if i in PUBLISHED["hybrid_layer_ids"] else "mamba"
        for i in range(81)])
    assert cfg_file["published"] == published
    assert S.run_sizes(cfg_file) == published
    assert cfg_file["reduced"] == []
    S.check_registered(cfg_file)
    with pytest.raises(ValueError):
        S.port_config("zamba2-7b", dict(published, time_step_limit=[0, 1]))
    with pytest.raises(ValueError):
        S.port_config("zamba2-7b", dict(published, n_mamba_heads=56))


@pytest.mark.parametrize("trace", [False, True])
def test_run_on_cpu_is_correct_and_well_formed(trace):
    r = small_run(seed=2 ** 31 + 9, trace=trace)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == CHECKS
    assert r["attempted"] > 0 and r["attempted"] % MIX["batch"] == 0
    assert r["failed"] == 0
    c = r["client"]
    calls = c["calls"]
    assert c["zamba2"] == dict(tokens=calls * 1200, mamba_layers=calls * 10,
                               ssd_chunks=calls * 2 * 10 * 10,
                               shared={"0": 2 * calls, "1": calls})
    assert len(c["mamba_rel_l2"]) == 10 and len(c["glue_rel_l2"]) == 10
    assert len(c["shared_rel_l2"]) == 3 and len(c["free_logit_rel_l2"]) == 2
    assert r["device"]["platform"] == "cpu"
    if trace:
        # no device trace on the CPU: only the host-clock share reads
        assert set(r["metrics"]) == {"mfu.hybrid"}
    else:
        assert set(r["metrics"]) == {"tokens_per_s", "setup_s"}
    json.dumps(r)


@pytest.mark.parametrize("control,check", [
    ("fp8_mamba", "mamba_rel_l2_max"), ("fp8_norms", "glue_rel_l2_max"),
    ("no_adapter", "shared_rel_l2_max"), ("ssd_bf16", "mamba_rel_l2_max"),
    ("group0_bc", "mamba_rel_l2_max"), ("scale_sqrt_d", "shared_rel_l2_max"),
    ("norm_before_gate", "mamba_rel_l2_max")])
def test_control_run_is_not_correct(control, check):
    r = small_run(seed=3, control=control)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_float32_run_matches_the_reference_closely():
    r = small_run(seed=4, dtype="float32")
    assert r["correct"] is True
    for k in ("logit_rel_l2_max", "mamba_rel_l2_max", "shared_rel_l2_max",
              "glue_rel_l2_max"):
        assert r["checks"][k]["value"] < 2e-5, k
    assert max(r["client"]["free_logit_rel_l2"]) < 1e-4


# -- faults planted in the program underneath a whole run ---------------------


def _altered(prefill):
    def fn(params, tokens, cfg, **kw):
        out = prefill(params, tokens, cfg, **kw)
        return out[torch.arange(out.shape[0]).roll(1)]  # answers swapped
    return fn


def _shared_term_dropped(mamba_layer):
    def fn(p, h, t, cfg, **kw):
        return mamba_layer(p, h, None, cfg, **kw)
    return fn


def _mixer_scaled(linear):
    def fn(p, x, cfg):
        y = linear(p, x, cfg)
        return y * 1.05 if y.shape[-1] == 64 and x.shape[-1] == 128 else y
    return fn


def _layer_skipped(mamba_layer):
    def fn(p, h, t, cfg, **kw):
        out, st = mamba_layer(p, h, t, cfg, **kw)
        return h, st
    return fn


@pytest.mark.parametrize("fault,target,check", [
    (_altered, "prefill", "logit_rows_over_tol"),
    (_shared_term_dropped, "mamba_layer", "chain_breaks"),
    (_layer_skipped, "mamba_layer", "chain_breaks")],
    ids=["answer_altered", "shared_term_dropped", "layer_skipped"])
def test_planted_fault_is_not_correct(fault, target, check, monkeypatch):
    from repro_torch.models import zamba2 as Z

    monkeypatch.setattr(Z, target, fault(getattr(Z, target)))
    r = small_run()
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_mixer_output_off_by_5pc_is_not_correct(monkeypatch):
    """The out-projection (d_inner 128 → 64) scaled by 1.05."""
    import repro_torch.models.layers as L

    monkeypatch.setattr(L, "linear", _mixer_scaled(L.linear))
    r = small_run()
    assert r["correct"] is False
    c = r["checks"]["mamba_rel_l2_max"]
    assert c["value"] > c["limit"]


# -- the work model, the seed, the reference ----------------------------------


def test_work_model_at_the_published_widths():
    """A 4 × 4096 call: 78.39e6 MACs a token a Mamba layer, 350.95e6 an
    application; 377.5 TFLOP a call; a layer's SSD at chunk 256 9.13e10
    FLOP and 0.717 GB, bound by its bytes at 0.214 ms."""
    sizes = S.run_sizes(deploy.load_config("zamba2_7b"))
    assert sum(a * c for a, c in work_zamba2.mamba_projections(sizes)) \
        == 78_389_248
    assert sum(a * c for a, c in work_zamba2.shared_projections(sizes)) \
        == 350_945_280
    assert work_zamba2.attention_flop(sizes, 4, 4096) == pytest.approx(
        9.6231e11, rel=1e-4)
    assert work_zamba2.ssd_flop(sizes, 4, 4096) == pytest.approx(
        9.1268e10, rel=1e-4)
    assert work_zamba2.ssd_bytes(sizes, 4, 4096) == pytest.approx(
        7.16702e8, rel=1e-5)
    assert work_zamba2.ssd_bound_s(sizes, 4, 4096) == pytest.approx(
        2.13941e-4, rel=1e-4)
    assert work_zamba2.call_flop(sizes, 4, 4096) == pytest.approx(
        3.77462e14, rel=1e-4)


def test_same_seed_same_weights():
    cfg_file = deploy.load_config("zamba2_7b")
    sizes = dict(S.run_sizes(cfg_file), **SMALL)
    draw = cfg_file["weights"]

    def one(seed):
        rest = S.seeds(seed, 4 + 15)[4:]
        get = S.reference_part(sizes, draw, S.part_seeds(sizes, rest),
                               "mamba", torch.device("cpu"))
        return get(3)
    big = 2 ** 31 + 12345
    a, b, c = one(big), one(big), one(big + 1)
    assert torch.equal(a["in_proj"]["w"], b["in_proj"]["w"])
    assert not torch.equal(a["in_proj"]["w"], c["in_proj"]["w"])
    # bf16 values, as the program holds them; dt_bias as drawn
    w = a["in_proj"]["w"]
    assert torch.equal(w, w.to(torch.bfloat16).float())
    assert not torch.equal(a["dt_bias"],
                           a["dt_bias"].to(torch.bfloat16).float())


_IMPORTS = """
import sys
sys.path[:0] = [{root!r}]
import portbench.reference.zamba2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro",
                                    "repro_torch", "transformers"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_reference_imports_no_jax_and_no_port():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORTS.format(root=str(ROOT))], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
