"""The port's Kimi Linear (``get_config("kimi-linear-48b")``, family
``kimi_linear``: KDA beside MLA without rotary parts, a dense layer and
sigmoid-routed MoE layers with a selection bias) against the plain
reference ``portbench/reference/kimi_linear.py`` on the CPU, at a small
size: d_model 64, 5 layers (KDA, KDA, KDA, MLA, KDA), the first dense,
KDA 2 heads of 16, MLA 4 heads (16 + 8, 16), 8 experts of 32, top 2, one
shared, vocabulary 97; and DeepSeek-V2's routing, unchanged to the bit.

Tolerances, each with its reason:

  * Exact: DeepSeek-V2's and the default router's gates and ids against
    a copy of the softmax path as it was; the routed expert ids against
    the reference (both sort stably on float32 scores of the same
    inputs); a pass against its taps; the counters.
  * KDA's chunk form against the token recurrence: 1e-5 relative in
    float32 (the chunk sums, the triangular inverse and the state steps
    sum in another order; ≈2e-6 here, the decays at −10 to −30 a step
    included).
  * The KDA and MLA mixers and the whole model in float32: 1e-4
    relative (flash's blocks, the chunk form and float32 sums in another
    order: ≈1e-6 at these sizes).
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from portbench import deploy  # noqa: E402
from portbench.reference import kimi_linear as ref  # noqa: E402
from portbench.surfaces import kimi_linear_prefill as S  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, taps  # noqa: E402
from repro_torch.models import kda as K  # noqa: E402
from repro_torch.models import kimi_linear as KL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mla as TM  # noqa: E402

torch.set_num_threads(1)

# Kimi-Linear-48B-A3B-Instruct's published config.json (moonshotai)
PUBLISHED = {
    "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu",
    "hidden_size": 2304, "intermediate_size": 9216, "kv_lora_rank": 512,
    "linear_attn_config": {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18,
                       19, 21, 22, 23, 25, 26],
        "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "model_max_length": 1048576,
    "model_type": "kimi_linear", "moe_intermediate_size": 1024,
    "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32,
    "num_expert_group": 1, "num_experts": 256, "num_experts_per_token": 8,
    "num_hidden_layers": 27, "num_key_value_heads": 32,
    "num_nextn_predict_layers": 0, "num_shared_experts": 1,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000,
    "routed_scaling_factor": 2.446, "tie_word_embeddings": False,
    "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
    "vocab_size": 163840}
SMALL = dict(num_hidden_layers=5, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, head_dim=16, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             intermediate_size=96, moe_intermediate_size=32, num_experts=8,
             num_experts_per_token=2, num_shared_experts=1, vocab_size=97,
             linear_attn_config=dict(kda_layers=[1, 2, 3, 5],
                                     full_attn_layers=[4], num_heads=2,
                                     head_dim=16, short_conv_kernel_size=4))
CFG_FILE = deploy.load_config("kimi_linear_48b_pp2s0")
SIZES = dict(S.run_sizes(CFG_FILE), **SMALL)
DRAW = CFG_FILE["weights"]
CFG = S.port_config("kimi-linear-48b", SIZES).replace(
    dtype="float32", param_dtype="float32")


def weights(seed: int):
    """The program's float32 tree and the reference's per-layer weights,
    the same values, from ``seed``."""
    _, _, g_embed, g_head, *ls = S.seeds(seed, 4 + SIZES["num_hidden_layers"])
    dev = torch.device("cpu")
    params = S.program_weights(SIZES, CFG, DRAW, ls, g_embed, g_head, dev,
                               dtype=torch.float32)
    layer = S.reference_layer(CFG, DRAW, ls, dev, torch.float32)
    return params, layer


def tokens(seed: int, s: int = 150):
    return torch.randint(0, SIZES["vocab_size"], (2, s),
                         generator=torch.Generator().manual_seed(seed))


def ref_logits(params, layer, tok):
    return ref.last_logits(params["embed"][tok], layer,
                           params["final_norm"]["scale"], params["head"],
                           SIZES)


def rel(got, want) -> float:
    """The largest relative L2 error over the last axis's rows."""
    return float(ref.rel_l2(got.reshape(want.shape), want).max())


def rel_all(got, want) -> float:
    """The relative L2 error over every entry."""
    return float((got.double() - want.double()).norm() / want.double().norm())


# -- KDA's chunk form ---------------------------------------------------------


def recurrence(q, k, v, g, beta):
    """The token recurrence in float64 (q, k normalised here)."""
    b, t, h, d = q.shape
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-6) / math.sqrt(d)
    k = k / torch.sqrt((k * k).sum(-1, keepdim=True) + 1e-6)
    s = torch.zeros(b, h, d, d, dtype=torch.float64)
    o = torch.empty(b, t, h, d, dtype=torch.float64)
    for i in range(t):
        s = s * torch.exp(g[:, i])[..., None]
        u = v[:, i, :, None, :] - k[:, i, :, None, :] @ s
        s = s + k[:, i, :, :, None] @ (beta[:, i, :, None, None] * u)
        o[:, i] = (q[:, i, :, None, :] @ s)[:, :, 0]
    return o, s


@pytest.mark.parametrize("t,a,dt", [(150, 1.0, 0.05), (64, 16.0, 2.0),
                                    (200, 16.0, 2.0), (37, 4.0, 0.5)],
                         ids=["mild_150", "strong_64", "strong_200",
                              "short_37"])
def test_chunk_form_matches_token_recurrence(t, a, dt):
    """Including T not a multiple of the chunk, and decays (A = 16, dt up
    to 2) whose chunk sums pass −88: a factorised exp(−G) overflows."""
    g_ = torch.Generator().manual_seed(t)
    b, h, d = 2, 3, 16
    q, k, v = (torch.randn(b, t, h, d, generator=g_, dtype=torch.float64)
               for _ in range(3))
    g = -a * torch.rand(b, t, h, d, generator=g_, dtype=torch.float64) * dt
    beta = torch.rand(b, t, h, generator=g_, dtype=torch.float64)
    if a == 16.0:
        G = g[:, :64].cumsum(1)
        assert float(-G.min()) > 88.0
        assert not torch.isfinite(torch.exp(-G.float())).all()
    want, want_s = recurrence(q, k, v, g, beta)
    got, got_s = K.chunk_scan(*(x.float() for x in (q, k, v, g, beta)))
    assert got.dtype == torch.float32 and got.shape == (b, t, h, d)
    assert rel_all(got, want) < 1e-5
    assert rel_all(got_s, want_s) < 1e-5
    # the decode step from a state: the next position's output and state
    o1, s1 = K.step(*(x[:, -1].float() for x in (q, k, v, g, beta)),
                    K.chunk_scan(*(x[:, :-1].float()
                                   for x in (q, k, v, g, beta)))[1])
    assert rel_all(o1, want[:, -1]) < 1e-5
    assert rel_all(s1, want_s) < 1e-5


@pytest.mark.parametrize("t", [200, 256], ids=["ragged_200", "whole_256"])
def test_chunk_form_in_spans_matches_one_span(t, monkeypatch):
    """Spans of 2 chunks (the state carried between them, the last span
    ragged or whole) give the token recurrence and the one-span form."""
    g_ = torch.Generator().manual_seed(t + 1)
    b, h, d = 2, 3, 16
    q, k, v = (torch.randn(b, t, h, d, generator=g_, dtype=torch.float64)
               for _ in range(3))
    g = -4.0 * torch.rand(b, t, h, d, generator=g_, dtype=torch.float64)
    beta = torch.rand(b, t, h, generator=g_, dtype=torch.float64)
    args = [x.float() for x in (q, k, v, g, beta)]
    one, one_s = K.chunk_scan(*args)
    monkeypatch.setattr(K, "SPAN_BYTES", 2 * b * h * d * d * 4)
    got, got_s = K.chunk_scan(*args)
    want, want_s = recurrence(q, k, v, g, beta)
    assert rel_all(got, want) < 1e-5 and rel_all(got_s, want_s) < 1e-5
    assert rel_all(got, one.double()) < 1e-6
    assert rel_all(got_s, one_s.double()) < 1e-6


def test_pair_products_use_no_positive_exponent():
    """A and M as the pairwise sums, with every exp of a difference ≤ 0:
    the products hold where exp(G_i) alone underflows to 0."""
    g_ = torch.Generator().manual_seed(5)
    q, k = (torch.randn(3, 64, 8, generator=g_) for _ in range(2))
    G = (-30.0 * torch.rand(3, 64, 8, generator=g_)).cumsum(1)
    a, m = K._pair_products(q, k, G)
    e = torch.exp((G[:, :, None, :] - G[:, None, :, :]).double().clamp_max(0))
    want_a = torch.einsum("btc,bic,btic->bti", k.double(), k.double(), e)
    want_m = torch.einsum("btc,bic,btic->bti", q.double(), k.double(), e)
    low = torch.ones(64, 64).tril(-1).bool()
    torch.testing.assert_close(a.double(), want_a * low, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m.double(), want_m * (low | torch.eye(64).bool()),
                               rtol=1e-5, atol=1e-6)


def test_kda_mixer_matches_reference():
    params, layer = weights(1)
    x = torch.randn(2, 150, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, _ = K.kda_attention(params["layers"][0]["kda"], x, CFG)
    want = ref.kda(x, layer(0)["kda"], SIZES)
    assert rel(got, want) < 1e-4


# -- routing ------------------------------------------------------------------


def _route_before(probs, cfg):
    """``layers._route`` as it was before the sigmoid router (softmax
    scores only), copied verbatim."""
    k = cfg.top_k
    if cfg.n_group > 1:
        e = probs.shape[-1]
        grouped = probs.reshape(*probs.shape[:-1], cfg.n_group,
                                e // cfg.n_group)
        _, best = TL._top_k(grouped.amax(-1), cfg.topk_group)
        keep = torch.zeros(grouped.shape[:-1], dtype=torch.bool,
                           device=probs.device).scatter_(-1, best, True)
        probs = grouped.masked_fill(~keep[..., None], 0.0).reshape(
            probs.shape)
    gates, idx = TL._top_k(probs, k)
    if cfg.norm_topk_prob:
        return gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                       1e-9), idx
    return gates * cfg.routed_scaling_factor, idx


@pytest.mark.parametrize("arch", ["deepseek-v2", "granite-moe-3b-a800m"])
def test_softmax_routing_keeps_its_bits(arch):
    """DeepSeek-V2 (8 groups, the best 3, top 6, gates 16·p) and the
    default router: gates and ids bit for bit as before."""
    cfg = get_config(arch)
    g_ = torch.Generator().manual_seed(11)
    logits = torch.randn(300, cfg.n_experts, generator=g_) * 2.0
    probs = TL._router_scores(logits, cfg)
    assert torch.equal(probs, torch.softmax(logits, -1))
    gates, idx = TL._route(probs, cfg)
    want_g, want_i = _route_before(probs, cfg)
    assert torch.equal(idx, want_i) and torch.equal(gates, want_g)


def test_sigmoid_router_matches_reference():
    p, _ = weights(3)
    router = p["layers"][1]["moe"]["router"]
    x = torch.randn(500, 64, generator=torch.Generator().manual_seed(4))
    probs = TL._router_scores(x @ router["w"], CFG)
    gates, idx = TL._route(probs, CFG, router["bias"])
    want_g, want_i = ref.route(x, router, SIZES)
    assert torch.equal(idx, want_i)
    torch.testing.assert_close(gates, want_g, rtol=1e-6, atol=0)
    # renormalised, then times 2.446
    torch.testing.assert_close(gates.sum(-1), torch.full((500,), 2.446))
    # the drawn bias moves a measurable share of the choices
    _, plain = TL._route(probs, CFG)
    moved = (torch.sort(idx).values != torch.sort(plain).values).any(-1)
    assert 0.1 < float(moved.float().mean()) < 0.9


def test_selection_bias_picks_but_does_not_weigh():
    """Expert 3's bias lifts it over expert 1 into the top 2; its gate is
    its own score, without the bias, renormalised and scaled."""
    cfg = CFG.replace(top_k=2)
    s = torch.tensor([[0.9, 0.8, 0.1, 0.7, 0.2, 0.3, 0.4, 0.5]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0])
    gates, idx = TL._route(s, cfg, bias)
    assert idx.tolist() == [[0, 3]]
    torch.testing.assert_close(
        gates, torch.tensor([[0.9, 0.7]]) / 1.6 * 2.446)
    gates0, idx0 = TL._route(s, cfg)
    assert idx0.tolist() == [[0, 1]]
    want_g, want_i = ref.route(torch.logit(s),
                               dict(w=torch.eye(8), bias=bias),
                               dict(SIZES, num_experts_per_token=2))
    assert want_i.tolist() == [[0, 3]]
    torch.testing.assert_close(gates, want_g)


def test_dropless_moe_matches_reference():
    params, layer = weights(5)
    x = torch.randn(2, 150, 64, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got, _ = TL.moe_ffn(params["layers"][1]["moe"], x.reshape(-1, 64),
                            CFG)
    want = ref.moe(x, layer(1)["moe"], SIZES)
    assert rel(got.reshape(want.shape), want) < 1e-5


# -- MLA without rotary parts -------------------------------------------------


def test_nope_mla_matches_reference():
    """600 positions: past one 512-row flash block; and with rotary parts
    the output differs."""
    params, layer = weights(7)
    p = params["layers"][3]["attn"]
    x = torch.randn(2, 600, 64, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        got, _ = TM.mla_attention(p, x, CFG)
        rotated, _ = TM.mla_attention(p, x, CFG.replace(mla_use_nope=False))
    want = ref.mla(x, layer(3)["attn"], SIZES)
    assert rel(got, want) < 1e-4
    assert rel(rotated, want) > 1e-2
    assert TM.softmax_scale(CFG) == pytest.approx(1 / math.sqrt(24))


# -- the whole model ----------------------------------------------------------


def test_prefill_and_forward_match_reference():
    params, layer = weights(9)
    tok = tokens(10)
    model = build_model(CFG, device="cpu")
    with torch.no_grad():
        got = model.prefill(params, tokens=tok)
        full, aux = KL.forward(params, tok, CFG)
    want = ref_logits(params, layer, tok)
    assert got.shape == (2, 1, 97)
    assert rel(got[:, 0], want) < 1e-4
    assert rel(full[:, -1], want) < 1e-4
    assert float(aux) == 0.0
    assert rel(full[:, 99], ref_logits(params, layer, tok[:, :100])) < 1e-4


def test_prefill_then_decode_match_forward():
    """Prefill S − k tokens into fresh caches, then k decode steps: each
    step's logits are the forward pass's at its position."""
    params = KL.init(torch.Generator().manual_seed(11), CFG, device="cpu")
    tok = tokens(12, 70)
    k = 4
    model = build_model(CFG, device="cpu")
    with torch.no_grad():
        full, _ = KL.forward(params, tok, CFG)
        caches = model.init_caches(2, 80)
        logits, caches = KL.prefill(params, tok[:, :-k], CFG, caches=caches)
        assert rel(logits[:, 0], full[:, -k - 1]) < 1e-4
        for i in range(70 - k, 70):
            logits, caches = model.decode_step(
                params, caches, tok[:, i:i + 1], torch.full((2,), i))
            assert rel(logits[:, 0], full[:, i]) < 1e-4


def test_loss_is_forward_cross_entropy():
    params, _ = weights(13)
    tok = tokens(14, 40)
    labels = torch.roll(tok, -1, 1)
    loss, metrics = KL.loss_fn(params, {"tokens": tok, "labels": labels}, CFG)
    logits, _ = KL.forward(params, tok, CFG)
    want = F.cross_entropy(logits.reshape(-1, 97), labels.reshape(-1))
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    assert metrics["ce"] is loss


def test_taps_counters_and_ranges():
    """One ``block`` tap a layer in order, joining up exactly; the
    counters count layers by kind, chunks and MoE calls; every mixer's
    ranges are entered."""
    from torch.profiler import ProfilerActivity, profile

    params, _ = weights(15)
    tok = tokens(16)
    seen = []
    KL.kimi_stats.reset()
    TL.moe_stats.reset()
    with torch.no_grad(), taps.recording(lambda s, t: seen.append((s, t))), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = KL.prefill(params, tok, CFG)
    assert [s for s, _ in seen] == ["embed"] + ["block"] * 5 + ["head"]
    x = seen[0][1][0]
    for _, (xin, h1, mix, h2, ffn, y) in seen[1:-1]:
        assert torch.equal(xin, x) and torch.equal(y, xin + mix + ffn)
        x = y
    assert torch.equal(seen[-1][1][0], x[:, -1:])
    assert torch.equal(seen[-1][1][1], logits)
    assert (KL.kimi_stats.tokens, KL.kimi_stats.kda_layers,
            KL.kimi_stats.mla_layers, KL.kimi_stats.kda_chunks) == \
        (300, 4, 1, 4 * 2 * 3)
    assert (TL.moe_stats.layer_calls, TL.moe_stats.slots) == (4, 4 * 600)
    names = [e.name for e in prof.events()]
    for r in ("kda.project", "kda.scan", "mla.project", "mla.attend",
              "moe.experts"):
        assert r in names, r
    assert names.count("kda.scan") == 4 and names.count("mla.attend") == 1


# -- the configuration --------------------------------------------------------


def test_registered_config_is_the_published_one():
    assert CFG_FILE["published"] == PUBLISHED
    S.check_registered(CFG_FILE)
    cfg = get_config("kimi-linear-48b")
    assert cfg.family == "kimi_linear" and not cfg.tie_embeddings
    assert (cfg.d_model, cfg.n_heads, cfg.kda_num_heads, cfg.kda_head_dim,
            cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.d_ff,
            cfg.vocab_size) == (2304, 32, 32, 128, 256, 8, 1024, 9216,
                                163840)
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == (192, 128)
    assert cfg.mla_use_nope and cfg.moe_router_activation_func == "sigmoid"
    # the cell's stage: 14 layers, 11 KDA, 3 MLA, one dense
    sizes = S.run_sizes(CFG_FILE)
    assert sizes["num_hidden_layers"] == 14
    stage = S.port_config("kimi-linear-48b", sizes)
    assert sum(KL.is_kda(stage, i) for i in range(14)) == 11
    with pytest.raises(ValueError):
        S.port_config("kimi-linear-48b", dict(PUBLISHED, q_lora_rank=1536))
    with pytest.raises(ValueError):
        S.port_config("kimi-linear-48b", dict(PUBLISHED, head_dim=64))
    # the whole model: 49.1e9 parameters
    p = build_model(cfg, device="meta").abstract_params()
    n = sum(t.numel() for lay in p["layers"] for t in _leaves(lay)) \
        + p["embed"].numel() + p["head"].numel()
    assert n == pytest.approx(49.12e9, rel=1e-3)
    # the sigmoid router carries its selection bias; a softmax router none
    assert p["layers"][1]["moe"]["router"]["bias"].shape == (256,)
    ds = build_model(get_config("deepseek-v2"), device="meta")
    assert list(ds.abstract_params()["blocks"]["moe"]["router"]) == ["w"]
    json.dumps(CFG_FILE)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
