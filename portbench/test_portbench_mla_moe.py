"""The MLA + MoE prefill surface on the CPU at a small size: a whole run,
traced and untraced, comes out correct and well formed; the controls and
faults planted in the program underneath a run make it not correct; the
program's profiler ranges are found in a host trace; the work model
counts the call as the published widths give it; and the reference loads
neither JAX, the JAX package nor the port."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, deploy, work_mla_moe  # noqa: E402
from portbench.surfaces import mla_moe_prefill as S  # noqa: E402

CELL = "deepseek_v2_pp8s0.prefill_4x4k"
# a reduced DeepSeek-V2 in the config.json keys: one dense layer, two MoE
SMALL = dict(num_hidden_layers=3, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=4, q_lora_rank=64, kv_lora_rank=64,
             qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
             intermediate_size=256, moe_intermediate_size=64,
             n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1,
             vocab_size=512)
# over one 512-token block, so attention takes the flash route
MIX = dict(batch=2, seq=600, pool_batches=4)
CHECKS = {"logit_rel_l2_max", "logit_rows_over_tol", "mla_rel_l2_max",
          "ffn_rel_l2_max", "ffn_token_rel_l2_max", "glue_rel_l2_max",
          "chain_breaks", "nonfinite_logits", "replay_mismatch"}


def small_run(seed: int = 11, trace: bool = False, **over):
    torch.set_num_threads(1)
    spec = bench.load_benchmark()
    return bench.run(bench.find_workload(spec, CELL), spec, seed=seed,
                     seconds=0.3, trace=trace, device="cpu",
                     mix_override=MIX, server_override=dict(SMALL, **over))


@pytest.mark.parametrize("trace", [False, True])
def test_run_on_cpu_is_correct_and_well_formed(trace):
    r = small_run(seed=2 ** 31 + 9, trace=trace)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == CHECKS
    assert r["attempted"] > 0 and r["attempted"] % MIX["batch"] == 0
    assert r["failed"] == 0
    c = r["client"]
    calls = c["calls"]
    assert c["moe"] == dict(tokens=calls * 2 * 1200, slots=calls * 2 * 4800,
                            layer_calls=calls * 2)
    assert len(c["mla_rel_l2"]) == 3 and len(c["ffn_rel_l2"]) == 3
    assert len(c["ffn_token_rel_l2"]) == 3 and len(c["glue_rel_l2"]) == 3
    assert r["device"]["platform"] == "cpu"
    if trace:
        # no device trace on the CPU: only the host-clock share reads
        assert set(r["metrics"]) == {"mfu.mla_moe"}
    else:
        assert set(r["metrics"]) == {"tokens_per_s", "setup_s"}
    json.dumps(r)


@pytest.mark.parametrize("control,check", [
    ("fp8_experts", "ffn_rel_l2_max"), ("w8a8_dense", "mla_rel_l2_max"),
    ("fp8_norms", "glue_rel_l2_max")])
def test_control_run_is_not_correct(control, check):
    r = small_run(seed=3, control=control)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_float32_run_matches_the_reference_closely():
    r = small_run(seed=4, dtype="float32")
    assert r["correct"] is True
    assert r["checks"]["logit_rel_l2_max"]["value"] < 1e-5
    assert r["checks"]["mla_rel_l2_max"]["value"] < 1e-5
    assert r["checks"]["ffn_rel_l2_max"]["value"] < 1e-5
    assert r["checks"]["ffn_token_rel_l2_max"]["value"] < 1e-4
    assert r["checks"]["glue_rel_l2_max"]["value"] < 1e-5


# -- faults planted in the program underneath a whole run ---------------------


def _altered(prefill):
    def fn(params, tokens, cfg, **kw):
        out = prefill(params, tokens, cfg, **kw)
        return out[torch.arange(out.shape[0]).roll(1)]  # answers swapped
    return fn


def _half_batch(prefill):
    def fn(params, tokens, cfg, **kw):
        half = prefill(params, tokens[: tokens.shape[0] // 2], cfg, **kw)
        return torch.cat([half, half])
    return fn


def _state_unchanged(scan_blocks):
    def fn(params, x, cfg):
        _, aux = scan_blocks(params, x, cfg)
        return x, aux
    return fn


def _ffn_skipped(block_fwd):
    def fn(p, x, cfg, **kw):
        y, cache, aux = block_fwd(p, x, cfg, **kw)
        return (y + x) * 0.5, cache, aux
    return fn


def _norm_scaled(norm):
    def fn(p, x, cfg):
        return norm(p, x, cfg) * 1.05
    return fn


def _expert_scaled(moe_ffn):
    def fn(p, x, cfg):
        out, aux = moe_ffn(p, x, cfg)
        return out * 1.05, aux
    return fn


def _slot_dropped(grouped_mm):
    def fn(xs, w, offs, counts=None):
        out = grouped_mm(xs, w, offs, counts).clone()
        out[0] = 0  # the first slot in expert order computes nothing
        return out
    return fn


@pytest.mark.parametrize("fault,module,target,check", [
    (_altered, "transformer", "prefill", "logit_rows_over_tol"),
    (_half_batch, "transformer", "prefill", "chain_breaks"),
    (_state_unchanged, "transformer", "_scan_blocks", "chain_breaks"),
    (_ffn_skipped, "transformer", "block_fwd", "chain_breaks"),
    (_norm_scaled, "layers", "norm", "glue_rel_l2_max"),
    (_expert_scaled, "layers", "moe_ffn", "ffn_rel_l2_max")],
    ids=["answer_altered", "half_batch_left_out", "blocks_leave_state",
         "block_output_altered", "norms_off_by_5pc", "experts_off_by_5pc"])
def test_planted_fault_is_not_correct(fault, module, target, check,
                                      monkeypatch):
    import importlib

    mod = importlib.import_module(f"repro_torch.models.{module}")
    monkeypatch.setattr(mod, target, fault(getattr(mod, target)))
    r = small_run()
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_dropped_slot_is_not_correct(monkeypatch):
    """One routed slot of each MoE layer's call left out (of 4800): the
    error on the token that lost it fails the per-token check."""
    import repro_torch.models.layers as L

    monkeypatch.setattr(L, "_grouped_mm", _slot_dropped(L._grouped_mm))
    r = small_run()
    assert r["correct"] is False
    c = r["checks"]["ffn_token_rel_l2_max"]
    assert c["value"] > c["limit"]


# -- the program's ranges, the work model, the seed ---------------------------


def test_program_ranges_are_in_a_host_trace():
    """A host trace of a prefill holds each of the program's ranges once
    a layer that has it (the MLA's ``mla.project`` twice)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model

    torch.set_num_threads(1)
    sizes = dict(S.run_sizes(deploy.load_config("deepseek_v2_pp8s0")),
                 **SMALL)
    cfg = S.port_config("deepseek-v2", sizes)
    _, _, g_e, g_h, *ls = S.seeds(1, 7)
    params = S.program_weights(sizes, {"embed_std": 0.02,
                                       "norm_scale_std": 0.1}, ls, g_e, g_h,
                               torch.device("cpu"))
    tok = torch.randint(0, 512, (1, 64))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        build_model(cfg, device="cpu").prefill(params, tokens=tok)
    seconds, counts = S.range_device_s(prof)
    assert counts == {"mla.project": 6, "mla.attend": 3, "moe.route": 2,
                      "moe.dispatch": 2, "moe.experts": 2, "moe.combine": 2,
                      "moe.shared": 2}
    assert set(seconds.values()) == {0.0}       # no device on the CPU


def test_work_model_at_the_published_widths():
    """One call of 4 × 4096 tokens through the 8-layer stage: ≈110.8
    TFLOP; a layer's attention 2.75 T, its routed experts 4.64 T (FLOP
    bound: 4.69 ms at the bf16 peak against 2.85 ms of bytes)."""
    sizes = S.run_sizes(deploy.load_config("deepseek_v2_pp8s0"))
    assert work_mla_moe.call_flop(sizes, 4, 4096) == pytest.approx(
        110.78e12, rel=1e-3)
    assert work_mla_moe.attention_flop(sizes, 4, 4096) == pytest.approx(
        2.7495e12, rel=1e-4)
    slots = 4 * 4096 * 6
    assert work_mla_moe.expert_flop(sizes, slots) == pytest.approx(
        4.6386e12, rel=1e-4)
    assert work_mla_moe.expert_bound_s(sizes, slots) == pytest.approx(
        4.6883e-3, rel=1e-4)
    assert work_mla_moe.expert_bytes(sizes, slots) / 3.35e12 < 2.9e-3


def test_same_seed_same_weights():
    sizes = dict(S.run_sizes(deploy.load_config("deepseek_v2_pp8s0")),
                 **SMALL)
    draw = {"embed_std": 0.02, "norm_scale_std": 0.1}

    def one(seed):
        ls = S.seeds(seed, 7)[4:]
        return S.reference_layer(sizes, draw, ls, torch.device("cpu"))(1)
    big = 2 ** 31 + 12345
    a, b, c = one(big), one(big), one(big + 1)
    assert torch.equal(a["moe"]["w_up"], b["moe"]["w_up"])
    assert not torch.equal(a["moe"]["w_up"], c["moe"]["w_up"])
    # bf16 values, as the program holds them
    assert torch.equal(a["moe"]["w_up"],
                       a["moe"]["w_up"].to(torch.bfloat16).float())


_IMPORTS = """
import sys
sys.path[:0] = [{root!r}]
import portbench.reference.mla_moe
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro",
                                    "repro_torch"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_reference_imports_no_jax_and_no_port():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORTS.format(root=str(ROOT))], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
