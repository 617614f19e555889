"""The port's DeepSeek-V2 (``get_config("deepseek-v2")``: dense layer 0,
YaRN MLA, group-limited dropless MoE) against the plain reference
``portbench/reference/mla_moe.py`` on the CPU, at a reduced size: d_model
128, 16 experts in 8 groups, the best 3 groups, top-4, one shared expert,
q_lora 64, kv_lora 64, one dense and two MoE layers.

Tolerances, each with its reason:

  * Exact: the routed expert ids (both sort stably, ties to the lower
    index, on float32 router logits of the same inputs); YaRN's ramp
    bounds; a call against itself.
  * The dropless MoE in float32: 1e-5 relative; the expert GEMMs and the
    combine sum in another order than the reference's expert loop.
  * YaRN's frequencies: 1e-7 relative (the port's float32 copy of the
    float64 formula); the softmax scale to 1e-12.
  * Whole prefill logits in float32: 1e-4 relative; float32 angles (the
    port) against float64 ones (the reference) at positions up to 600
    move cos and sin by ≈3e-5.
  * Whole prefill logits in bf16: 0.06 relative; every activation is
    rounded to bf16 (8 bits) and the flash form rounds its logits to bf16
    too, ≈0.02 at this depth on these seeds, and a near-tied routing
    choice can move with it.
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from portbench import deploy  # noqa: E402
from portbench.reference import mla_moe as ref  # noqa: E402
from portbench.surfaces import mla_moe_prefill as S  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import active_params, param_count  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mla as TM  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(num_hidden_layers=3, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=4, q_lora_rank=64, kv_lora_rank=64,
             qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
             intermediate_size=256, moe_intermediate_size=64,
             n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1,
             vocab_size=512)
CFG_FILE = deploy.load_config("deepseek_v2_pp8s0")
SIZES = dict(S.run_sizes(CFG_FILE), **SMALL)
DRAW = CFG_FILE["weights"]


def small_cfg(dtype="float32"):
    return S.port_config("deepseek-v2", SIZES).replace(dtype=dtype)


def weights(seed: int, dtype=torch.float32):
    """The program's tree and the reference's per-layer weights, the same
    values, from ``seed``."""
    _, _, g_embed, g_head, *ls = S.seeds(seed, 4 + SIZES["num_hidden_layers"])
    dev = torch.device("cpu")
    params = S.program_weights(SIZES, DRAW, ls, g_embed, g_head, dev,
                               dtype=dtype)
    layer = S.reference_layer(SIZES, DRAW, ls, dev, dtype)
    emb = S.embedding(SIZES, DRAW, g_embed, dev).to(dtype)
    return params, layer, emb, S.head(SIZES, g_head, dev).to(dtype)


def tokens(seed: int, s: int = 600):
    return torch.randint(0, SIZES["vocab_size"], (2, s),
                         generator=torch.Generator().manual_seed(seed))


# -- routing ------------------------------------------------------------------


def test_group_limited_routing_matches_reference():
    cfg = small_cfg()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(257, 128, generator=g)
    w = torch.randn(128, 16, generator=g) / math.sqrt(128)
    probs = torch.softmax(x @ w, -1)
    gates, idx = TL._route(probs, cfg)
    want_g, want_i = ref.route(x, w, SIZES)
    assert torch.equal(idx, want_i)
    torch.testing.assert_close(gates, want_g, rtol=1e-6, atol=0)
    # only experts of the best 3 groups (2 experts a group)
    best = torch.sort(probs.reshape(-1, 8, 2).amax(-1), dim=-1,
                      descending=True, stable=True).indices[:, :3]
    assert ((idx // 2)[:, :, None] == best[:, None, :]).any(-1).all()
    # gates are 16·p, not renormalised
    torch.testing.assert_close(gates, 16 * torch.gather(probs, 1, idx))


def test_routing_ties_go_to_the_lower_index():
    """Groups 1 and 4 tie for the third group and experts 2 and 3 tie
    inside group 1: the lower group and the lower expert win, in the
    port and in the reference."""
    cfg = small_cfg()
    logits = torch.full((1, 16), -4.0)
    logits[0, 0], logits[0, 1] = 3.0, 2.9      # group 0
    logits[0, 14], logits[0, 15] = 2.8, 2.7    # group 7
    logits[0, 2] = logits[0, 3] = 2.0          # group 1: a tie inside
    logits[0, 8] = 2.0                         # group 4 ties group 1
    probs = torch.softmax(logits, -1)
    _, idx = TL._route(probs, cfg)
    assert idx.tolist() == [[0, 1, 14, 15]]
    cfg6 = cfg.replace(top_k=6)
    _, idx6 = TL._route(probs, cfg6)
    assert idx6.tolist() == [[0, 1, 14, 15, 2, 3]]
    for k, want in ((4, [0, 1, 14, 15]), (6, [0, 1, 14, 15, 2, 3])):
        _, ref_idx = ref.route(logits, torch.eye(16),
                               dict(SIZES, num_experts_per_tok=k))
        assert ref_idx.tolist() == [want]


def test_default_routing_is_unchanged():
    """With one group and renormalised gates (every other MoE config) the
    gates are the old ``top_k`` renormalisation, bit for bit."""
    cfg = get_config("granite-moe-3b-a800m")
    probs = torch.softmax(torch.randn(5, 3, 40, generator=torch.Generator()
                                      .manual_seed(1)), -1)
    gates, idx = TL._route(probs, cfg)
    vals, want_idx = TL._top_k(probs, cfg.top_k)
    assert torch.equal(idx, want_idx)
    assert torch.equal(gates, vals / torch.clamp_min(
        vals.sum(-1, keepdim=True), 1e-9))


# -- the dropless MoE ---------------------------------------------------------


def _moe_layer(seed: int):
    params, layer, _, _ = weights(seed)
    return TL.layer_params(params["blocks"], 0)["moe"], layer(1)


@pytest.mark.parametrize("seed", [1, 2])
def test_dropless_moe_matches_reference(seed):
    cfg = small_cfg()
    moe_p, p = _moe_layer(seed)
    x = torch.randn(3, 200, 128, generator=torch.Generator().manual_seed(seed))
    TL.moe_stats.reset()
    out, _ = TL.moe_ffn(moe_p, x.reshape(-1, 128), cfg)
    want = ref.moe(x, p, SIZES).reshape(-1, 128)
    assert float(ref.rel_l2(out.reshape(1, -1), want.reshape(1, -1))) < 1e-5
    # token by token: a slot left out would move its token's row
    assert float(ref.rel_l2(out, want).max()) < 1e-5
    assert TL.moe_stats.slots == 600 * 4 and TL.moe_stats.layer_calls == 1


def test_dropless_moe_keeps_every_slot_of_one_expert():
    """A router that sends every token to experts 0-3 (each gets all 512
    tokens, far past GShard's capacity): every slot is computed."""
    cfg = small_cfg()
    moe_p, p = _moe_layer(4)
    w = torch.zeros(128, 16)
    w[:, :4] = torch.linspace(4, 1, 4)[None, :]
    moe_p = dict(moe_p, router={"w": w})
    p = dict(p, moe=dict(p["moe"], router={"w": w}))
    x = torch.randn(512, 128, generator=torch.Generator().manual_seed(4)
                    ).abs()
    TL.moe_stats.reset()
    out, _ = TL.moe_ffn(moe_p, x, cfg)
    want = ref.moe(x[None], p, SIZES)[0]
    assert float(ref.rel_l2(out.reshape(1, -1), want.reshape(1, -1))) < 1e-5
    _, idx = TL._route(torch.softmax(x @ w, -1), cfg)
    assert torch.equal(torch.bincount(idx.reshape(-1), minlength=16)[:4],
                       torch.full((4,), 512))
    assert float(ref.rel_l2(out, want).max()) < 1e-5
    assert TL.moe_stats.slots == 512 * 4


# -- YaRN ---------------------------------------------------------------------


def test_yarn_frequencies_and_scale_follow_the_formulas():
    cfg = get_config("deepseek-v2")
    inv = TL.rope_inv_freq(cfg, 64, "cpu")
    j = torch.arange(32, dtype=torch.float64)
    extra = 1e4 ** (-2 * j / 64)
    ramp = ((j - 10) / (23 - 10)).clamp(0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    assert inv.dtype == torch.float32
    torch.testing.assert_close(inv.double(), want, rtol=1e-7, atol=0)
    sizes = S.run_sizes(CFG_FILE)
    torch.testing.assert_close(ref.yarn_inv_freq(sizes), want, rtol=1e-15,
                               atol=0)

    def corr(beta):
        return 64 * math.log(4096 / (2 * math.pi * beta)) / (2 * math.log(1e4))
    assert (math.floor(corr(32)), math.ceil(corr(1))) == (10, 23)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert round(mscale, 5) == 1.26080
    assert TM.softmax_scale(cfg) == pytest.approx(mscale ** 2 / math.sqrt(192),
                                                  rel=1e-12)
    assert round(TM.softmax_scale(cfg), 6) == 0.114721
    assert ref.softmax_scale(sizes) == pytest.approx(TM.softmax_scale(cfg),
                                                     rel=1e-12)
    # plain configs keep plain RoPE and 1/√(dn + dr)
    plain = get_config("deepseek-v2-236b")
    assert TL.rope_inv_freq(plain, 64, "cpu") is None
    assert TM.softmax_scale(plain) == 1 / math.sqrt(192)


# -- the whole prefill --------------------------------------------------------


def _prefill(seed: int, dtype: str):
    params, layer, emb, head = weights(seed, getattr(torch, dtype))
    tok = tokens(seed)
    with torch.no_grad():
        got = build_model(small_cfg(dtype), device="cpu").prefill(
            params, tokens=tok)
    want = ref.last_logits(emb[tok], layer, torch.ones(128), head, SIZES)
    return got, want


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.06)])
@pytest.mark.parametrize("seed", [1, 2])
def test_prefill_logits_match_reference(seed, dtype, tol):
    got, want = _prefill(seed, dtype)
    assert got.shape == (2, 1, SIZES["vocab_size"])
    assert float(ref.rel_l2(got.reshape(2, -1).float(), want).max()) < tol


def test_prefill_repeats_bit_for_bit():
    params, *_ = weights(5, torch.bfloat16)
    model = build_model(small_cfg("bfloat16"), device="cpu")
    tok = tokens(5)
    with torch.no_grad():
        a = model.prefill(params, tokens=tok)
        b = model.prefill(params, tokens=tok)
    assert torch.equal(a, b)


def test_taps_hand_over_each_piece_of_a_prefill():
    """A recording sees the embedding, every block's six values and the
    head, joined up exactly: each block's output is its input plus its
    two sublayers, and the next block's input; nesting is refused."""
    from repro_torch.models import taps

    params, *_ = weights(6)
    model = build_model(small_cfg(), device="cpu")
    seen = []
    with torch.no_grad(), taps.recording(lambda s, t: seen.append((s, t))):
        with pytest.raises(RuntimeError):
            with taps.recording(print):
                pass
        logits = model.prefill(params, tokens=tokens(6, 64))
    assert [s for s, _ in seen] == ["embed", "block", "block", "block",
                                    "head"]
    x = seen[0][1][0]
    for _, (xin, h1, a, h2, f, y) in seen[1:4]:
        assert torch.equal(xin, x) and h2.shape == h1.shape == x.shape
        assert torch.equal(y, (xin + a) + f)
        x = y
    assert torch.equal(seen[4][1][0], x[:, -1:])
    assert torch.equal(seen[4][1][1], logits)
    taps.tap("block", x)  # no recording open: nothing happens


def test_params_tree_has_the_dense_layer_first():
    cfg = small_cfg()
    p = build_model(cfg, device="meta").abstract_params()
    assert set(p) == {"embed", "final_norm", "dense_blocks", "blocks",
                      "head"}
    assert p["dense_blocks"]["mlp"]["gate"]["w"].shape == (1, 128, 256)
    assert p["blocks"]["moe"]["w_gate"].shape == (2, 16, 128, 64)
    lst = build_model(cfg.replace(scan_layers=False),
                      device="meta").abstract_params()["blocks"]
    assert ["mlp" in b for b in lst] == [True, False, False]


# -- the registered configuration ---------------------------------------------


def test_registered_config_is_the_published_one():
    S.check_registered(CFG_FILE)
    cfg = get_config("deepseek-v2")
    pub = CFG_FILE["published"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.moe_d_ff,
            cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.vocab_size) \
        == (pub["num_hidden_layers"], pub["hidden_size"],
            pub["num_attention_heads"], pub["intermediate_size"],
            pub["moe_intermediate_size"], pub["n_routed_experts"],
            pub["num_experts_per_tok"], pub["n_shared_experts"],
            pub["vocab_size"])
    assert dict(cfg.rope_scaling) == pub["rope_scaling"]
    assert cfg.moe_dropless and not cfg.norm_topk_prob
    bad = json.loads(json.dumps(CFG_FILE))
    bad["published"]["topk_group"] = 4
    with pytest.raises(ValueError, match="differs from the published"):
        S.check_registered(bad)
    with pytest.raises(ValueError, match="the port implements"):
        S.port_config("deepseek-v2", dict(pub, topk_method="greedy"))


def test_parameter_count_counts_the_dense_layer():
    """236B total and 21B active as published; the dense layer 0 (SwiGLU
    of width 12288) counted once, the other 59 as MoE."""
    cfg = get_config("deepseek-v2")
    assert 235e9 < param_count(cfg) < 237e9
    assert 21e9 < active_params(cfg) < 22e9
    all_moe = cfg.replace(first_k_dense_replace=0)
    ffn = 3 * 5120
    moe_layer = (160 + 2) * ffn * 1536 + 5120 * 160
    assert param_count(all_moe) - param_count(cfg) == moe_layer - ffn * 12288
    assert active_params(all_moe) - active_params(cfg) == \
        (6 + 2) * ffn * 1536 + 5120 * 160 - ffn * 12288
    # the reference's preset has no leading dense layer: unchanged
    assert get_config("deepseek-v2-236b").first_k_dense_replace == 0
