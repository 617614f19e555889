"""The LM prefill surface on the CPU at a small size: the port's W8A8
prefill agrees with the plain reference within the configuration's
tolerance and the controls do not; a whole run through the harness comes
out correct and well formed; faults planted in the program underneath a
run make it not correct; and the reference loads neither JAX, the JAX
package nor the port."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import bench, deploy  # noqa: E402
from portbench.reference import lm as ref  # noqa: E402
from portbench.surfaces import lm_prefill  # noqa: E402

CELL = "qwen2_1_5b_w8a8.prefill_4x2k"
# configs.reduced(qwen2-1.5b) in the published keys
SMALL = dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=1, intermediate_size=256, vocab_size=512)
# over one 512-token block, so attention takes the flash route
MIX = dict(batch=2, seq=600, pool_batches=16)


def small_errors(seed: int, control=None) -> torch.Tensor:
    """Per prompt: relative L2 error of the port's prefill logits against
    the reference's, on weights and tokens drawn from ``seed``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    torch.set_num_threads(1)
    cfg_file = deploy.load_config("qwen2_1_5b_w8a8")
    sizes = dict(cfg_file["published"], **SMALL)
    cfg = lm_prefill.port_config("qwen2-1.5b", sizes, cfg_file["overrides"])
    assert cfg == reduced(get_config("qwen2-1.5b"),
                          quant_mode="w8a8_int")
    g = torch.Generator().manual_seed(seed)
    w = lm_prefill.weights_tree(sizes, cfg_file["weights"], g,
                                torch.device("cpu"))
    tokens = torch.randint(0, sizes["vocab_size"], (2, MIX["seq"]),
                           generator=g)
    with torch.no_grad():
        got = build_model(cfg, device="cpu").prefill(
            lm_prefill.quantized(w, control), tokens=tokens)
    want = ref.last_logits(w, tokens, sizes)
    return ref.rel_l2(got.reshape(2, -1).float(), want)


def tolerance() -> float:
    return deploy.load_config("qwen2_1_5b_w8a8")["tolerance"]["logit_rel_l2"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_w8a8_prefill_agrees_with_reference(seed):
    assert float(small_errors(seed).max()) <= tolerance()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_int4_control_fails_the_tolerance(seed):
    assert float(small_errors(seed, "int4").max()) > tolerance()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lsb7_control_reads_above_the_sound_run(seed):
    """7-bit weight codes fail the limit at the cell's size on the card; at
    this size they read 0.06-0.16, so here they are held above the sound
    run's own error on the same weights and tokens."""
    assert float(small_errors(seed, "lsb7").max()) > \
        1.5 * float(small_errors(seed).max())


def test_reference_float_path_matches_the_port_in_float32():
    """With float projections and float32 activations the reference is
    the port's prefill to rounding: its blocks are the same model."""
    from repro_torch.models import build_model

    torch.set_num_threads(1)
    cfg_file = deploy.load_config("qwen2_1_5b_w8a8")
    sizes = dict(cfg_file["published"], **SMALL)
    cfg = lm_prefill.port_config("qwen2-1.5b", sizes,
                                 dict(quant_mode="fp", dtype="float32"))
    g = torch.Generator().manual_seed(5)
    w = lm_prefill.weights_tree(sizes, cfg_file["weights"], g,
                                torch.device("cpu"))
    tokens = torch.randint(0, sizes["vocab_size"], (2, 600), generator=g)
    with torch.no_grad():
        got = build_model(cfg, device="cpu").prefill(w, tokens=tokens)
    want = ref.last_logits(w, tokens, sizes, linear=lambda x, m: x @ m)
    assert float(ref.rel_l2(got.reshape(2, -1), want).max()) < 1e-5


def test_quantized_linear_is_exact_integer_product():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 70, generator=g)
    w = torch.randn(70, 9, generator=g)
    qx, sx = ref.absmax_codes(x, -1)
    qw, sw = ref.absmax_codes(w, 0)
    acc = qx.long() @ qw.long()
    want = (acc.to(torch.float32) * sx) * sw
    assert torch.equal(ref.quantized_linear(x, w), want)
    assert qx.abs().max() == 127 and qw.abs().amax(0).eq(127).all()


def small_run(seed: int = 11, trace: bool = False):
    torch.set_num_threads(1)
    spec = bench.load_benchmark()
    return bench.run(bench.find_workload(spec, CELL), spec, seed=seed,
                     seconds=0.5, trace=trace, device="cpu",
                     mix_override=MIX, server_override=SMALL)


@pytest.mark.parametrize("trace", [False, True])
def test_run_on_cpu_is_correct_and_well_formed(trace):
    r = small_run(seed=2 ** 31 + 5, trace=trace)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["attempted"] % MIX["batch"] == 0
    assert r["failed"] == 0
    assert set(r["checks"]) == {"logit_rel_l2_max", "logit_rows_over_tol",
                                "nonfinite_logits"}
    assert r["device"]["platform"] == "cpu"
    if trace:
        # no device trace on the CPU: only the host-clock share reads
        assert set(r["metrics"]) == {"mfu.prefill"}
    else:
        assert set(r["metrics"]) == {"tokens_per_s", "setup_s"}
        assert r["metrics"]["tokens_per_s"]["value"] > 0
    assert len(r["client"]["sampled_calls"]) == 2
    json.dumps(r)


def test_same_seed_same_inputs():
    """One seed gives the same weights; another seed other weights; seeds
    past 32 bits are taken whole."""
    cfg_file = deploy.load_config("qwen2_1_5b_w8a8")
    sizes = dict(cfg_file["published"], **SMALL)

    def draw(seed):
        g = torch.Generator().manual_seed(lm_prefill.seeds(seed, 3)[0])
        return lm_prefill.weights_tree(sizes, cfg_file["weights"], g,
                                       torch.device("cpu"))["blocks"]["mlp"]

    big = 2 ** 31 + 12345
    assert torch.equal(draw(big)["up"]["w"], draw(big)["up"]["w"])
    assert not torch.equal(draw(big)["up"]["w"], draw(big + 1)["up"]["w"])
    assert lm_prefill.seeds(big, 3) != lm_prefill.seeds(big + 2 ** 32, 3)


def test_registered_config_is_the_published_one():
    cfg_file = deploy.load_config("qwen2_1_5b_w8a8")
    lm_prefill.check_registered(cfg_file)
    bad = dict(cfg_file, published=dict(cfg_file["published"],
                                         intermediate_size=8192))
    with pytest.raises(ValueError, match="differs from the published"):
        lm_prefill.check_registered(bad)


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


@pytest.mark.parametrize("fault,target", [
    (_altered, "prefill"), (_half_batch, "prefill"),
    (_state_unchanged, "_scan_blocks")],
    ids=["answer_altered", "half_batch_left_out", "blocks_leave_state"])
def test_planted_fault_is_not_correct(fault, target, monkeypatch):
    import repro_torch.models.transformer as transformer

    monkeypatch.setattr(transformer, target,
                        fault(getattr(transformer, target)))
    r = small_run()
    assert r["correct"] is False
    assert r["checks"]["logit_rows_over_tol"]["value"] > 0


def test_control_run_is_not_correct():
    torch.set_num_threads(1)
    spec = bench.load_benchmark()
    r = bench.run(bench.find_workload(spec, CELL), spec, seed=3,
                  seconds=0.3, trace=False, device="cpu", mix_override=MIX,
                  server_override=dict(SMALL, control="int4"))
    assert r["correct"] is False


_IMPORTS = """
import sys
sys.path[:0] = [{root!r}]
import portbench.reference.lm
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
