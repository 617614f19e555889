"""The SSD scan kernel's rule and routing on the CPU
(``kernels/ssd_scan.py``, ``models/zamba2.py::ssd``): which operands the
kernel takes, what the caller refuses (autograd, DTensors, dispatch modes,
the decode step), how many heads a block takes, and that every call off
the card keeps ``ssm.ssd_grouped``'s bits and counts nothing on the
kernel's path.  The kernel itself runs only on the card: ``-k ssd`` in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as K
from repro_torch.models import ssm
from repro_torch.models import zamba2 as Z

torch.set_num_threads(1)

CSRC = Path(K.__file__).resolve().parent / "csrc" / "ssd_scan.cu"


def _ops(b=2, t=10, h=4, g=2, p=8, n=6, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen).to(dtype)
    bm = torch.randn(b, t, g, n, generator=gen).to(dtype)
    cm = torch.randn(b, t, g, n, generator=gen).to(dtype)
    dt = torch.rand(b, t, h, generator=gen)
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    return [x, bm, cm, dt, a]


def _with(ops, i, value):
    out = list(ops)
    out[i] = value
    return out


# each case: a change to the operands, and whether the kernel takes them
RULE = {
    "bf16": (lambda o: [o[0].bfloat16(), o[1].bfloat16(), o[2].bfloat16(),
                        *o[3:]], True),
    "fp16": (lambda o: [o[0].half(), o[1].half(), o[2].half(), *o[3:]],
             True),
    "fp32": (lambda o: o, True),
    "float64": (lambda o: [o[0].double(), o[1].double(), o[2].double(),
                           *o[3:]], False),
    "x and B/C in two types": (lambda o: _with(o, 0, o[0].bfloat16()), False),
    "B and C in two types": (lambda o: _with(o, 2, o[2].half()), False),
    "dt not float32": (lambda o: _with(o, 3, o[3].bfloat16()), False),
    "a not float32": (lambda o: _with(o, 4, o[4].double()), False),
    "H not divisible by G": (lambda o: [o[0][:, :, :3], o[1], o[2],
                                        o[3][..., :3], o[4][:3]], False),
    "one head a group": (lambda o: [o[0], o[1].repeat(1, 1, 2, 1),
                                    o[2].repeat(1, 1, 2, 1), *o[3:]], True),
    "P = 64": (lambda o: _with(o, 0, torch.zeros(2, 10, 4, 64)), True),
    "P = 65": (lambda o: _with(o, 0, torch.zeros(2, 10, 4, 65)), False),
    "P = N = 1": (lambda o: [torch.zeros(2, 10, 4, 1), o[1][..., :1],
                             o[2][..., :1], *o[3:]], True),
    "N = 64": (lambda o: [o[0], torch.zeros(2, 10, 2, 64),
                          torch.zeros(2, 10, 2, 64), *o[3:]], True),
    "N = 65": (lambda o: [o[0], torch.zeros(2, 10, 2, 65),
                          torch.zeros(2, 10, 2, 65), *o[3:]], False),
    "T = 0": (lambda o: [t[:, :0] if t.dim() > 1 else t for t in o], False),
    "B/C shapes differ": (lambda o: _with(o, 2, o[2][:, :, :1]), False),
    "dt of another length": (lambda o: _with(o, 3, o[3][:, :5]), False),
    "a of another count": (lambda o: _with(o, 4, o[4][:2]), False),
    "x not 4-D": (lambda o: _with(o, 0, o[0][0]), False),
    # strides: any, stride 0 included
    "B/C of group 0 expanded (stride 0)": (
        lambda o: [o[0], o[1][:, :, :1].expand_as(o[1]),
                   o[2][:, :, :1].expand_as(o[2]), *o[3:]], True),
    "views of one projection, as the mixer splits it": (
        lambda o: list(_split_views(o)), True),
    "x with heads and positions swapped in memory": (
        lambda o: _with(o, 0, o[0].transpose(1, 2).contiguous()
                        .transpose(1, 2)), True),
    "dt transposed in memory": (
        lambda o: _with(o, 3, o[3].transpose(1, 2).contiguous()
                        .transpose(1, 2)), True),
}


def _split_views(o):
    """x, B and C as views into one (B, T, H·P + 2·G·N) activation, as
    ``zamba2.mamba_layer`` hands them over."""
    b, t, h, p = o[0].shape
    g, n = o[1].shape[2:]
    cat = torch.cat([o[0].reshape(b, t, h * p), o[1].reshape(b, t, g * n),
                     o[2].reshape(b, t, g * n)], -1)
    x, bm, cm = torch.split(cat, [h * p, g * n, g * n], -1)
    return (x.reshape(b, t, h, p), bm.reshape(b, t, g, n),
            cm.reshape(b, t, g, n), *o[3:])


@pytest.mark.parametrize("case", sorted(RULE))
def test_kernel_rule(case):
    """``kernel_applies``' rule on dtypes and shapes: one type for x, B and C among bf16, fp16 and fp32; dt and
    a in float32; (B, T, H, P), (B, T, G, N), (B, T, H), (H,) with
    B, T ≥ 1, H % G == 0, 1 ≤ P, N ≤ 64; any strides."""
    change, want = RULE[case]
    ops = change(_ops())
    assert K._fits(*ops) is want


def test_kernel_applies_only_on_one_card():
    """Off the card (the CPU, the meta device) the kernel applies to
    nothing its shapes would allow."""
    ops = _ops()
    assert K._fits(*ops)
    assert not K.kernel_applies(*ops)
    assert not K.kernel_applies(*[t.to("meta") for t in ops])


@pytest.mark.parametrize("batch,heads,groups,sms,want", [
    (4, 112, 2, 132, 4),   # Zamba2-7B's prefill: 112 blocks
    (1, 112, 2, 132, 1),   # 112 blocks of one head
    (2, 112, 2, 132, 2),   # 112 blocks of two
    (8, 112, 2, 132, 4),   # more rows than SMs: the most a block takes
    (4, 8, 2, 132, 1),     # small: a head a block
    (80, 2, 1, 132, 2),    # a group's heads, no more
    (4, 112, 2, 114, 4),   # a card with fewer SMs
])
def test_plan_heads_a_block(batch, heads, groups, sms, want):
    hb = K.plan(batch, heads, groups, sms)
    assert hb == want
    per = heads // groups
    assert 1 <= hb <= min(K.MAX_HEADS, per)
    blocks = batch * groups * -(-per // hb)
    assert blocks <= sms or hb == min(K.MAX_HEADS, per)


def test_wrapper_raises_off_the_card():
    K.reset_launches()
    with pytest.raises(ValueError, match="plain form"):
        K.ssd_scan(*_ops())
    assert K.launches["ssd_scan"] == 0


def test_binding_matches_the_c_entry_point():
    """The ctypes argument list has the C function's arity, pointers where
    it takes pointers and 64-bit integers where it takes ``int64_t``."""
    text = CSRC.read_text()
    sig = re.search(r'extern "C" int ssd_scan_launch\(([^)]*)\)', text)
    params = [" ".join(p.split()) for p in sig.group(1).split(",")]
    argtypes = K._SYMBOLS["ssd_scan_launch"]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        if "*" in param:
            assert argtype is K._P, param
        elif param.startswith("int64_t"):
            assert argtype is K._I64, param
        else:
            assert param.startswith("int ") and argtype is K._I, param


# ---------------------------------------------------------------------------
# the caller: models/zamba2.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("why", ["dtensor", "grad", "dispatch_mode"])
def test_caller_refusals(why):
    """On any device ``ssd_kernel_applies`` keeps DTensors, operands
    autograd records a graph through and calls under a dispatch mode (the
    dry run's cost counter) on the plain form (``_plain_only``); off the
    card it applies to nothing."""
    ops = _ops()
    assert not Z._plain_only(*ops)
    assert not Z.ssd_kernel_applies(*ops)
    if why == "dtensor":
        from torch.distributed.tensor import Replicate, distribute_tensor

        from repro_torch.launch.mesh import fake_world, make_mesh
        with fake_world(1):
            mesh = make_mesh((1,), ("data",), device="meta")
            d = distribute_tensor(ops[0].to("meta"), mesh, [Replicate()])
            assert Z._plain_only(d, *ops[1:])
    elif why == "grad":
        for i in range(5):
            grad = _with(ops, i, ops[i].clone().requires_grad_(True))
            assert Z._plain_only(*grad)
            with torch.no_grad():
                assert not Z._plain_only(*grad)
    else:
        from torch.utils._python_dispatch import TorchDispatchMode

        class Seen(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return func(*args, **(kwargs or {}))

        with Seen():
            assert Z._plain_only(*ops)


def _paths():
    """The prefill SSDs since the last reset, (kernel, plain)."""
    return Z.zamba2_stats.ssd_kernel, Z.zamba2_stats.ssd_plain


@pytest.mark.parametrize("change", ["float64", "P = 65", "N = 65",
                                    "H not divisible by G"])
def test_kernel_path_raises_on_what_the_kernel_refuses(change, monkeypatch):
    """A call the caller sends to the kernel and the kernel does not take
    raises, with no plain form behind it, and counts on neither path (the
    kernel's rule here on dtypes and shapes alone, as on the card)."""
    monkeypatch.setattr(Z, "ssd_kernel_applies", lambda *a: True)
    monkeypatch.setattr(K, "kernel_applies", K._fits)
    Z.zamba2_stats.reset()
    K.reset_launches()
    with pytest.raises(ValueError, match="does not take"):
        Z.ssd(*RULE[change][0](_ops()), Z.SSD_CHUNK)
    assert _paths() == (0, 0)
    assert K.launches["ssd_scan"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 130])
def test_off_card_ssd_keeps_plain_bits(dtype, t):
    """On the CPU ``zamba2.ssd``'s prefill is ``ssm.ssd_grouped`` on the
    float32 copies, bit for bit; ``zamba2_stats`` counts a plain call and
    the kernel launches nothing."""
    ops = _ops(t=t, dtype=dtype, seed=t)
    Z.zamba2_stats.reset()
    K.reset_launches()
    y, s = Z.ssd(*ops, Z.SSD_CHUNK)
    f32 = [o.float() for o in ops[:3]]
    want_y, want_s = ssm.ssd_grouped(*f32, ops[3], ops[4], Z.SSD_CHUNK)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert _paths() == (0, 1)
    assert K.launches["ssd_scan"] == 0
    Z.zamba2_stats.reset()
    assert _paths() == (0, 0)


def test_kernel_chunk_is_the_counted_chunk():
    """``zamba2_stats.ssd_chunks`` counts chunks of ``SSD_CHUNK``, the
    kernel's own chunk as well as the plain form's."""
    assert Z.SSD_CHUNK == K.CHUNK == 64


CFG = get_config("zamba2-7b").replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    attention_head_dim=32, attention_hidden_size=128, d_ff=96,
    vocab_size=97, ssm_state=16, ssm_head_dim=32, hybrid_layer_ids=(1,),
    adapter_rank=8, dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_hands_the_kernel_the_mixers_own_views(dtype, monkeypatch):
    """Where the rule says yes, every prefill SSD goes to the kernel with
    x, B and C as the mixer made them (no float32 copy), dt and a in
    float32; ``zamba2_stats`` counts each call on the kernel's path."""
    cfg = CFG.replace(dtype=dtype, param_dtype=dtype)
    params = Z.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, 97, (2, 70),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = Z.prefill(params, tokens, cfg)
    seen = []

    def fake(xh, bmat, cmat, dt, a):
        seen.append((xh.dtype, bmat.dtype, cmat.dtype, dt.dtype, a.dtype,
                     xh.is_contiguous(), tuple(bmat.shape)))
        f32 = torch.float32
        return ssm.ssd_grouped(xh.to(f32), bmat.to(f32), cmat.to(f32), dt, a,
                               Z.SSD_CHUNK)

    monkeypatch.setattr(Z, "ssd_kernel_applies", lambda *a: True)
    monkeypatch.setattr(K, "ssd_scan", fake)
    Z.zamba2_stats.reset()
    with torch.no_grad():
        got = Z.prefill(params, tokens, cfg)
    low = getattr(torch, dtype)
    assert seen == [(low, low, low, torch.float32, torch.float32, False,
                     (2, 70, 2, 16))] * 4
    assert _paths() == (4, 0)
    assert torch.equal(got, want)


def test_decode_step_keeps_the_recurrent_step(monkeypatch):
    """A decode step never reaches the rule or the kernel, and counts no
    prefill SSD; a prefill into caches does, and hands the step its
    state."""
    params = Z.init(torch.Generator().manual_seed(2), CFG, device="cpu")
    tokens = torch.randint(0, 97, (2, 9),
                           generator=torch.Generator().manual_seed(3))
    calls = []

    def fake(xh, bmat, cmat, dt, a):
        calls.append(xh.shape[1])
        return ssm.ssd_grouped(xh.float(), bmat.float(), cmat.float(), dt, a,
                               Z.SSD_CHUNK)

    monkeypatch.setattr(Z, "ssd_kernel_applies", lambda *a: True)
    monkeypatch.setattr(K, "ssd_scan", fake)
    Z.zamba2_stats.reset()
    with torch.no_grad():
        caches = Z.init_caches(CFG, 2, 16, device="cpu")
        _, caches = Z.prefill(params, tokens[:, :8], CFG, caches=caches)
        assert calls == [8] * 4 and _paths() == (4, 0)
        step, _ = Z.decode_step(params, caches, tokens[:, 8:], torch.full(
            (2,), 8), CFG)
        full = Z.forward(params, tokens, CFG)[0][:, -1:]
    assert calls == [8] * 4 + [9] * 4  # forward's prefill SSDs, not the step
    assert _paths() == (8, 0)
    assert float((step - full).abs().max()) < 1e-4


def test_loss_under_autograd_keeps_the_plain_form(monkeypatch):
    """``loss_fn`` differentiates through the plain form: the rule refuses
    an autograd graph, so gradients still reach every Mamba parameter."""
    monkeypatch.setattr(Z, "ssd_kernel_applies",
                        lambda *ops: not Z._plain_only(*ops))
    monkeypatch.setattr(K, "ssd_scan", lambda *a: pytest.fail(
        "the kernel has no backward"))
    params = Z.init(torch.Generator().manual_seed(4), CFG, device="cpu")
    for leaf in params["mamba"].values():
        for t in (leaf.values() if isinstance(leaf, dict) else [leaf]):
            t.requires_grad_(True)
    tokens = torch.randint(0, 97, (2, 12),
                           generator=torch.Generator().manual_seed(5))
    Z.zamba2_stats.reset()
    loss, _ = Z.loss_fn(params, {"tokens": tokens,
                                 "labels": torch.roll(tokens, -1, 1)}, CFG)
    loss.backward()
    assert _paths() == (0, 4)
    assert params["mamba"]["a_log"].grad is not None
