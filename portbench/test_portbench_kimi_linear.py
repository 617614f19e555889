"""The Kimi Linear prefill surface on the CPU at a small size: a whole run,
traced and untraced, comes out correct and well formed; every control of
the cell (a program made wrong on purpose) makes it not correct; faults
planted in the program underneath a run are caught; the work model counts
the call as the published widths give it; and the reference loads
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

from portbench import bench, deploy, work_kimi_linear as W  # noqa: E402
from portbench.surfaces import kimi_linear_prefill as S  # noqa: E402

CELL = "kimi_linear_48b_pp2s0.prefill_2x16k"
# 5 layers (KDA, KDA, KDA, MLA, KDA), the first dense, 8 experts, top 2
SMALL = dict(num_hidden_layers=5, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, head_dim=16, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             intermediate_size=96, moe_intermediate_size=32, num_experts=8,
             num_experts_per_token=2, num_shared_experts=1, vocab_size=97,
             linear_attn_config=dict(kda_layers=[1, 2, 3, 5],
                                     full_attn_layers=[4], num_heads=2,
                                     head_dim=16, short_conv_kernel_size=4))
# three KDA chunks, the last one partial
MIX = dict(batch=2, seq=150, pool_batches=2)
CHECKS = {"logit_rel_l2_max", "logit_rows_over_tol", "kda_rel_l2_max",
          "mla_rel_l2_max", "ffn_rel_l2_max", "ffn_token_rel_l2_max",
          "glue_rel_l2_max", "chain_breaks", "nonfinite_logits",
          "replay_mismatch"}


def small_run(seed: int = 11, trace: bool = False, **over):
    torch.set_num_threads(1)
    spec = bench.load_benchmark()
    return bench.run(bench.find_workload(spec, CELL), spec, seed=seed,
                     seconds=0.2, trace=trace, device="cpu",
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
    assert c["kimi"] == dict(tokens=calls * 300, kda_layers=calls * 4,
                             mla_layers=calls, kda_chunks=calls * 4 * 2 * 3)
    assert c["moe"] == dict(tokens=calls * 4 * 300, slots=calls * 4 * 600,
                            layer_calls=calls * 4)
    # 150 positions: MLA's attention takes its one-block form, not flash
    assert c["flash"] == dict(kernel=0, plain=0)
    assert len(c["kda_rel_l2"]) == 4 and len(c["mla_rel_l2"]) == 1
    assert len(c["ffn_rel_l2"]) == 5 and len(c["glue_rel_l2"]) == 5
    assert len(c["free_logit_rel_l2"]) == 2
    assert r["device"]["platform"] == "cpu"
    if trace:
        # no device trace on the CPU: only the host-clock share reads
        assert set(r["metrics"]) == {"mfu.kimi"}
    else:
        assert set(r["metrics"]) == {"tokens_per_s", "setup_s"}
    json.dumps(r)


@pytest.mark.parametrize("flash,device,fails", [
    ((3, 0), "cuda", False), ((2, 1), "cuda", True), ((0, 3), "cuda", True),
    ((4, 0), "cuda", True), ((0, 3), "cpu", False)],
    ids=["kernel", "one_plain", "all_plain", "extra", "cpu"])
def test_card_run_requires_mla_on_the_flash_kernel(flash, device, fails):
    """3 MLA layer calls: on the card each on the flash kernel, or the
    run raises; the CPU has no kernel."""
    err = S.flash_path_error(dict(zip(("kernel", "plain"), flash)), 3,
                             device)
    assert (err is not None) == fails
    if fails:
        assert str(flash) in err


@pytest.mark.parametrize("control,check", [
    ("kda_state_bf16", "kda_rel_l2_max"), ("no_delta", "kda_rel_l2_max"),
    ("head_decay", "kda_rel_l2_max"), ("softmax_router", "ffn_rel_l2_max"),
    ("no_score_bias", "ffn_token_rel_l2_max"),
    ("mla_rope", "mla_rel_l2_max")])
def test_control_run_is_not_correct(control, check):
    r = small_run(seed=3, control=control)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_float32_run_matches_the_reference_closely():
    r = small_run(seed=4, dtype="float32")
    assert r["correct"] is True
    for k in ("logit_rel_l2_max", "kda_rel_l2_max", "mla_rel_l2_max",
              "ffn_rel_l2_max", "glue_rel_l2_max"):
        assert r["checks"][k]["value"] < 2e-5, k
    assert max(r["client"]["free_logit_rel_l2"]) < 1e-4


# -- faults planted in the program underneath a whole run ---------------------


def _altered(prefill):
    def fn(params, tokens, cfg, **kw):
        out = prefill(params, tokens, cfg, **kw)
        return out[torch.arange(out.shape[0]).roll(1)]  # answers swapped
    return fn


def _layer_skipped(layer_fwd):
    def fn(p, x, cfg, **kw):
        y, new = layer_fwd(p, x, cfg, **kw)
        return (x, new) if "attn" in p else (y, new)
    return fn


def _state_dropped(chunk_scan):
    """The KDA state restarts at every other chunk of 64."""
    def fn(q, k, v, g, beta, chunk=64):
        o = torch.cat([chunk_scan(*(x[:, i:i + chunk] for x in
                                    (q, k, v, g, beta)))[0]
                       for i in range(0, q.shape[1], chunk)], 1)
        return o, None
    return fn


@pytest.mark.parametrize("fault,module,target,check", [
    (_altered, "kimi_linear", "prefill", "logit_rows_over_tol"),
    (_layer_skipped, "kimi_linear", "layer_fwd", "chain_breaks"),
    (_state_dropped, "kda", "chunk_scan", "kda_rel_l2_max")],
    ids=["answer_altered", "mla_layer_skipped", "kda_state_dropped"])
def test_planted_fault_is_not_correct(fault, module, target, check,
                                      monkeypatch):
    import importlib

    mod = importlib.import_module(f"repro_torch.models.{module}")
    monkeypatch.setattr(mod, target, fault(getattr(mod, target)))
    r = small_run()
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


# -- the work model, the seed, the reference ----------------------------------


def test_work_model_at_the_published_widths():
    """A 2 × 16384 call on the 14-layer stage: 39.46e6 MACs a token a KDA
    layer's projections, 29.11e6 an MLA layer's; the chunk form 8.91e6
    FLOP a chunk and head (5·64²·128 + 6·64·128²), a layer's 146.0 GFLOP
    and 1.615 GB, bound by its bytes at 0.482 ms; 111.2 TFLOP a call."""
    sizes = S.run_sizes(deploy.load_config("kimi_linear_48b_pp2s0"))
    assert W.layer_counts(sizes) == dict(kda=11, mla=3, dense=1, moe=13)
    assert sum(a * c for a, c in W.kda_projections(sizes)) == \
        2304 * 12288 + 2 * (2304 * 128 + 128 * 4096) + 2304 * 32 \
        + 4096 * 2304 == 39_460_864
    assert sum(a * c for a, c in W.mla_projections(sizes)) == \
        2304 * 32 * 192 + 2304 * 576 + 2 * 512 * 4096 + 4096 * 2304 \
        == 29_114_368
    chunks = 2 * (16384 // 64) * 32
    assert W.kda_flop(sizes, 2, 16384) == chunks * (
        5 * 64 * 64 * 128 + 6 * 64 * 128 * 128) == pytest.approx(1.46029e11,
                                                                rel=1e-5)
    assert W.kda_bytes(sizes, 2, 16384) == 32768 * (
        4 * 2 * 4096 + 4 * (4096 + 32))
    assert W.kda_bound_s(sizes, 2, 16384) == pytest.approx(4.82032e-4,
                                                           rel=1e-5)
    # the experts: 8 slots a token, all 256 experts' weights
    assert W.expert_bound_s(sizes, 32768 * 8) == pytest.approx(
        6 * 32768 * 8 * 2304 * 1024 / 989.4e12, rel=1e-9)
    assert W.call_flop(sizes, 2, 16384) == pytest.approx(1.112212e14,
                                                         rel=1e-5)


def test_same_seed_same_weights():
    cfg_file = deploy.load_config("kimi_linear_48b_pp2s0")
    sizes = dict(S.run_sizes(cfg_file), **SMALL)
    draw = cfg_file["weights"]
    cfg = S.port_config(cfg_file["arch"], sizes)

    def one(seed):
        ls = S.seeds(seed, 4 + 5)[4:]
        return S.reference_layer(cfg, draw, ls, torch.device("cpu"))(1)
    big = 2 ** 31 + 12345
    a, b, c = one(big), one(big), one(big + 1)
    w = a["kda"]["wqkv"]["w"]
    assert torch.equal(w, b["kda"]["wqkv"]["w"])
    assert not torch.equal(w, c["kda"]["wqkv"]["w"])
    # bf16 values, as the program holds them; the float32 leaves as drawn
    assert torch.equal(w, w.to(torch.bfloat16).float())
    for leaf in (a["kda"]["dt_bias"], a["moe"]["router"]["bias"]):
        assert not torch.equal(leaf, leaf.to(torch.bfloat16).float())
    assert ((a["kda"]["a_log"] >= 0) & (a["kda"]["a_log"] <= 2.7726)).all()


_IMPORTS = """
import sys
sys.path[:0] = [{root!r}]
import portbench.reference.kimi_linear
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
