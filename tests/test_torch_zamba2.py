"""The port's Zamba2 as published (``get_config("zamba2-7b")``, family
``zamba2``: grouped B/C, two alternating shared blocks on [hidden ‖
embedding] with per-application LoRA) against the plain reference
``portbench/reference/zamba2.py`` on the CPU, at a small size: d_model
64, 10 layers with hybrid ids [2, 5, 8], 2 shared blocks of 4 heads of
32, 4 Mamba heads of 32 in 2 groups, state 16, adapter rank 8,
vocabulary 97; and ``ssm.py``'s one-group SSD, unchanged to the bit.

Tolerances, each with its reason:

  * Exact: the one-group chunked SSD against its earlier form (the mask
    now applied to the exponent before the exp: the same values below
    the diagonal, zeros above); a pass against its taps; the counters.
  * float32 logits against the reference: 1e-4 relative.  The program
    runs the SSD chunked (64 positions) where the reference runs the
    quadratic form, flash attention where the reference runs a plain
    softmax, and float32 rotary angles where the reference takes
    float64 ones: ≈2e-6 at these sizes.
  * The grouped SSD against the quadratic form: 1e-5 relative (float32
    sums in another order).
"""

import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from portbench.reference import zamba2 as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, ssm, taps  # noqa: E402
from repro_torch.models import zamba2 as Z  # noqa: E402
from repro_torch.models.layers import layer_params  # noqa: E402

torch.set_num_threads(1)

IDS = (2, 5, 8)
CFG = get_config("zamba2-7b").replace(
    n_layers=10, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    attention_head_dim=32, attention_hidden_size=128, d_ff=96,
    vocab_size=97, ssm_state=16, ssm_head_dim=32, hybrid_layer_ids=IDS,
    adapter_rank=8, dtype="float32", param_dtype="float32")
# the same model in the config.json keys the reference reads
SIZES = dict(hidden_size=64, mamba_expand=2, n_mamba_heads=4,
             mamba_headdim=32, mamba_ngroups=2, mamba_d_state=16,
             num_attention_heads=4, attention_head_dim=32, rope_theta=10000,
             rms_norm_eps=1e-5, use_mem_rope=True, intermediate_size=96,
             hybrid_layer_ids=list(IDS), num_mem_blocks=2,
             num_hidden_layers=10, use_shared_mlp_adapter=True)
S = 150  # past two SSD chunks of 64


def _params(seed=0):
    return Z.init(torch.Generator().manual_seed(seed), CFG, device="cpu")


def _tokens(seed=1, s=S):
    return torch.randint(0, 97, (2, s),
                         generator=torch.Generator().manual_seed(seed))


def _ref_logits(p, tokens):
    apps = {k: p[k] for k in ("linear", "adapter_a", "adapter_b")}
    return ref.last_logits(
        p["embed"][tokens], lambda i: layer_params(p["mamba"], i),
        lambda b: layer_params(p["shared"], b),
        lambda j: layer_params(apps, j), p["final_norm"]["scale"],
        p["embed"], SIZES)


def _rel(got, want) -> float:
    return float(ref.rel_l2(got.reshape(want.shape), want).max())


def test_prefill_and_forward_match_reference():
    p, tok = _params(), _tokens()
    want = _ref_logits(p, tok)
    model = build_model(CFG, device="cpu")
    with torch.no_grad():
        got = model.prefill(p, tokens=tok)
        full, aux = Z.forward(p, tok, CFG)
    assert got.shape == (2, 1, 97)
    assert _rel(got[:, 0], want) < 1e-4
    assert _rel(full[:, -1], want) < 1e-4
    assert float(aux) == 0.0
    # an earlier prefix through forward is the reference on that prefix
    assert _rel(full[:, 99], _ref_logits(p, tok[:, :100])) < 1e-4


def test_prefill_then_decode_match_reference():
    """Prefill S−k tokens into fresh caches, then k decode steps: each
    step's logits are the reference's full forward on its prefix."""
    p, tok = _params(2), _tokens(3)
    k = 3
    model = build_model(CFG, device="cpu")
    with torch.no_grad():
        caches = model.init_caches(2, S + 4)
        _, caches = Z.prefill(p, tok[:, :S - k], CFG, caches=caches)
        for i in range(S - k, S):
            pos = torch.full((2,), i)
            logits, caches = model.decode_step(p, caches, tok[:, i:i + 1],
                                               pos)
            assert _rel(logits[:, 0], _ref_logits(p, tok[:, :i + 1])) < 1e-4


def test_loss_is_forward_cross_entropy():
    p, tok = _params(4), _tokens(5, 40)
    labels = torch.roll(tok, -1, 1)
    loss, metrics = Z.loss_fn(p, {"tokens": tok, "labels": labels}, CFG)
    logits, _ = Z.forward(p, tok, CFG)
    want = F.cross_entropy(logits.reshape(-1, 97), labels.reshape(-1))
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    assert metrics["ce"] is loss


def test_application_j_runs_block_j_mod_2_with_adapter_j():
    """Applications 0 and 2 run block 0 and 1 runs block 1, each with
    its own adapter: swapping adapters 0 and 2 changes the call, and a
    change to block 1 leaves application 0's output as it was and moves
    application 1's."""
    p, tok = _params(6), _tokens(7, 40)

    def run(params):
        seen = []
        with torch.no_grad(), taps.recording(
                lambda site, ts: seen.append(ts[-1].clone())
                if site == "shared" else None):
            out = Z.prefill(params, tok, CFG)
        return out, seen

    base, t_base = run(p)
    assert len(t_base) == len(IDS)
    swapped = {**p, "adapter_b": {"w": p["adapter_b"]["w"][[2, 1, 0]]}}
    out, t_swap = run(swapped)
    assert not torch.equal(out, base)
    assert not torch.equal(t_swap[0], t_base[0])
    moved = {**p, "shared": {**p["shared"], "down": {
        "w": p["shared"]["down"]["w"] * torch.tensor([1.0, 1.1])[
            :, None, None]}}}
    _, t_moved = run(moved)
    assert torch.equal(t_moved[0], t_base[0])
    assert not torch.equal(t_moved[1], t_base[1])


def test_ranges_and_counters_count_layers_and_applications():
    from torch.profiler import ProfilerActivity, profile

    from portbench.surfaces.mla_moe_prefill import range_device_s

    p, tok = _params(8), _tokens(9, 40)
    Z.zamba2_stats.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        Z.prefill(p, tok, CFG)
    _, counts = range_device_s(prof, ("ssm.project", "ssm.scan",
                                      "zamba2.shared", "zamba2.attend"))
    assert counts == {"ssm.project": 20, "ssm.scan": 10, "zamba2.shared": 6,
                      "zamba2.attend": 3}
    st = Z.zamba2_stats
    assert (st.tokens, st.mamba_layers, st.ssd_chunks) == (80, 10, 20)
    assert st.shared == {0: 2, 1: 1}


def test_taps_join_up():
    p, tok = _params(10), _tokens(11, 40)
    seen = []
    with torch.no_grad(), taps.recording(lambda s, ts: seen.append((s, ts))):
        logits = Z.prefill(p, tok, CFG)
    sites = [s for s, _ in seen]
    assert sites[0] == "embed" and sites[-1] == "head"
    assert sites.count("mamba") == 10 and sites.count("shared") == 3
    prev, e, t = seen[0][1][0], seen[0][1][0], None
    for s, ts in seen[1:-1]:
        if s == "shared":
            assert torch.equal(ts[0], torch.cat([prev, e], -1))
            t = ts[-1]
            continue
        assert torch.equal(ts[0], prev)
        if len(ts) == 5:
            assert torch.equal(ts[1], t)
        assert torch.equal(ts[-1], ts[0] + ts[-2])
        prev = ts[-1]
    assert torch.equal(seen[-1][1][0], prev[:, -1:])
    assert torch.equal(seen[-1][1][1], logits)


def test_gated_norm_gates_first_then_normalises_each_group():
    g = torch.Generator().manual_seed(12)
    y, z = torch.randn(3, 8, 128, generator=g), torch.randn(3, 8, 128,
                                                           generator=g)
    w = 1 + 0.1 * torch.randn(128, generator=g)
    got = Z.gated_norm(y, z, w, 2)
    assert torch.allclose(got, ref.gated_rms_norm(y, z, w, 2), rtol=1e-6,
                          atol=1e-6)
    one = Z.gated_norm(y, z, w, 1)
    assert not torch.allclose(got, one, atol=1e-3)


def test_softmax_scale_is_half_head_dim():
    assert Z.softmax_scale(get_config("zamba2-7b")) == pytest.approx(
        (224 / 2) ** -0.5)


@pytest.mark.parametrize("chunk", [16, 64])
def test_grouped_ssd_matches_quadratic_form_and_its_step(chunk):
    """Strong decays included (A down to −8, dt up to 2): no clamp, the
    chunked form is the quadratic one; the step from the prefill's state
    continues it."""
    g = torch.Generator().manual_seed(13)
    b, t, h, p, grp, n = 2, 100, 8, 16, 2, 8
    x = torch.randn(b, t, h, p, generator=g)
    dt = 2 * torch.rand(b, t, h, generator=g)
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    bm = torch.randn(b, t, grp, n, generator=g)
    cm = torch.randn(b, t, grp, n, generator=g)
    y, state = ssm.ssd_grouped(x, bm, cm, dt, a, chunk)
    want = ref.ssd(x, dt, a, bm, cm)
    assert float((y - want).norm() / want.norm()) < 1e-5
    y1, s_prev = ssm.ssd_grouped(x[:, :-1], bm[:, :-1], cm[:, :-1],
                                 dt[:, :-1], a, chunk)
    y_last, s_last = ssm.ssd_step_grouped(s_prev, x[:, -1], bm[:, -1],
                                          cm[:, -1], dt[:, -1], a)
    assert torch.allclose(y1, y[:, :-1], rtol=1e-5, atol=1e-5)
    assert torch.allclose(y_last, y[:, -1], rtol=1e-4, atol=1e-5)
    assert torch.allclose(s_last, state, rtol=1e-4, atol=1e-5)


def _ssd_chunked_before(xh, bmat, cmat, dt, a, chunk):
    """``ssm._ssd_chunked`` as it was before it took groups' callers and
    an optional floor: the clamp at −30, the exp then the mask."""
    b, t, h, dh = xh.shape
    n = bmat.shape[-1]
    pad = (-t) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bmat, cmat = (F.pad(m, (0, 0, 0, pad)) for m in (bmat, cmat))
        dt = F.pad(dt, (0, 0, 0, pad))
    tt = xh.shape[1]
    nc = tt // chunk
    x = xh.reshape(b, nc, chunk, h, dh).permute(1, 0, 3, 2, 4)
    bm = bmat.reshape(b, nc, chunk, n).transpose(0, 1)
    cm = cmat.reshape(b, nc, chunk, n).transpose(0, 1)
    dtc = dt.reshape(b, nc, chunk, h).permute(1, 0, 3, 2)
    logdec = dtc * a[None, None, :, None]
    cum = torch.clamp_min(torch.cumsum(logdec, dim=-1), -30.0)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=xh.dtype,
                                device=xh.device))
    g = torch.exp(cum[..., :, None] - cum[..., None, :]) * tri
    cb = torch.einsum("cbtn,cbsn->cbts", cm, bm)
    scores = cb[:, :, None] * g * dtc[..., None, :]
    y = torch.einsum("cbhts,cbhsd->cbhtd", scores, x)
    decay_to_end = torch.exp(cum[..., -1:] - cum) * dtc
    inc = torch.einsum("cbhsd,cbsn->cbhdn", decay_to_end[..., None] * x, bm)
    tot = torch.exp(cum[..., -1])[..., None, None]
    s = torch.zeros((b, h, dh, n), dtype=xh.dtype, device=xh.device)
    starts = []
    for i in range(nc):
        starts.append(s)
        s = s * tot[i] + inc[i]
    s0 = torch.stack(starts)
    y = y + torch.exp(cum)[..., None] * torch.einsum("cbtn,cbhdn->cbhtd",
                                                     cm, s0)
    y = y.permute(1, 0, 3, 2, 4).reshape(b, tt, h, dh)
    return y[:, :t]


@pytest.mark.parametrize("chunk,t,decay", [(64, 150, 0.1), (16, 40, 0.1),
                                           (64, 130, 2.0)])
def test_one_group_ssd_keeps_its_bits(chunk, t, decay):
    """The hybrid's one-group SSD (floor −30) gives the bits it gave
    before, strong decays (the clamp biting) included."""
    g = torch.Generator().manual_seed(14)
    b, h, p, n = 2, 4, 8, 16
    args = (torch.randn(b, t, h, p, generator=g),
            torch.randn(b, t, n, generator=g),
            torch.randn(b, t, n, generator=g),
            decay * torch.rand(b, t, h, generator=g),
            -torch.linspace(1.0, 8.0, h))
    assert torch.equal(ssm._ssd_chunked(*args, chunk),
                       _ssd_chunked_before(*args, chunk))


def test_published_config_and_its_parameters():
    """81 layers, 13 applications, 2 blocks, the tied head; 7.35e9
    parameters in bf16 on the meta device (no float32 copy)."""
    cfg = get_config("zamba2-7b")
    assert cfg.family == "zamba2" and cfg.tie_embeddings
    assert (cfg.n_layers, cfg.d_model, len(cfg.hybrid_layer_ids)) == \
        (81, 3584, 13)
    params = build_model(cfg, device="meta").abstract_params()
    leaves = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            leaves[path] = t
    walk(params, ())
    total = sum(x.numel() for x in leaves.values())
    assert total == pytest.approx(7.35e9, rel=2e-3)
    weights = [x for path, x in leaves.items()
               if path[-1] in ("w", "embed", "conv_w", "conv_b")]
    assert len(weights) == 14
    assert {x.dtype for x in weights} == {torch.bfloat16}
    assert params["mamba"]["in_proj"]["w"].shape == (81, 3584, 14704)
    assert params["adapter_b"]["w"].shape == (13, 128, 28672)
    assert sum(x.numel() for x in leaves.values()
               if x.dtype == torch.float32) / total < 1e-3


def test_attention_adapters_are_refused():
    with pytest.raises(NotImplementedError):
        Z.init(torch.Generator(), CFG.replace(
            use_shared_attention_adapter=True), device="cpu")
