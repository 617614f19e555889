"""Flash attention's dispatch between the hand-written forward
(``kernels/flash_attention.py``, on the card) and the plain form
(``models/flash.py``), on the CPU: the dispatch predicate branch by branch,
the calls counted by path, grouped K/V read by index against explicitly
repeated K/V, the kernel path's backward (the kernel's forward replaced by
the plain one, which the card tests hold it to), and the wrapper's argument
checks.  The kernel itself runs in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from repro_torch.distributed.cost import CostCounter
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import flash

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


def _qkv(b, h, hkv, s, dqk, dv, dtype=F32, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, h, dqk, generator=g).to(dtype) / dqk ** 0.5
    k = torch.randn(b, s, hkv, dqk, generator=g).to(dtype)
    v = torch.randn(b, s, hkv, dv, generator=g).to(dtype)
    # (B, S, H, D) transposed, as the model's callers hand them over
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if grad:
        for t in (q, k, v):
            t.requires_grad_(True)
    return q, k, v


@pytest.mark.parametrize("device,dtype,hkv,dqk,dv,causal,mode,want", [
    ("cuda", BF16, 2, 128, 128, True, False, True),
    ("cuda", F16, 12, 128, 128, True, False, True),
    ("cuda", BF16, 12, 192, 128, True, False, True),
    ("cpu", BF16, 2, 128, 128, True, False, False),
    ("meta", BF16, 2, 128, 128, True, False, False),
    ("cuda", F32, 2, 128, 128, True, False, False),
    ("cuda", BF16, 2, 128, 128, False, False, False),
    ("cuda", BF16, 2, 64, 64, True, False, False),
    ("cuda", BF16, 2, 192, 192, True, False, False),
    ("cuda", BF16, 5, 128, 128, True, False, False),
    ("cuda", BF16, 2, 128, 128, True, True, False),
], ids=["gqa", "fp16", "mla", "cpu", "meta", "float32", "non-causal",
        "dims-64", "dims-192-192", "heads-12-over-5", "dispatch-mode"])
def test_kernel_applies_each_branch(device, dtype, hkv, dqk, dv, causal, mode,
                                    want):
    b, h, s = 4, 12, 2048
    got = fa.kernel_applies(device, dtype, (b, h, s, dqk), (b, hkv, s, dqk),
                            (b, hkv, s, dv), causal, mode)
    assert got is want


@pytest.mark.parametrize("k_shape,v_shape", [
    ((4, 2, 1024, 128), (4, 2, 2048, 128)),   # keys fewer than queries
    ((4, 2, 2048, 128), (4, 3, 2048, 128)),   # K and V heads differ
    ((2, 2, 2048, 128), (2, 2, 2048, 128)),   # another batch
    ((4, 2, 2048), (4, 2, 2048, 128)),        # not 4-d
])
def test_kernel_applies_refuses_mismatched_shapes(k_shape, v_shape):
    assert not fa.kernel_applies("cuda", BF16, (4, 12, 2048, 128), k_shape,
                                 v_shape, True)


def test_cost_counter_is_an_active_dispatch_mode():
    """Under the dry run's counter the plain ops must run (its folded loop
    counts), so the path check sees the mode."""
    assert not flash._mode_active()
    with CostCounter(fold_loops=True):
        assert flash._mode_active()
    q, k, v = _qkv(1, 2, 1, 16, 128, 128, BF16)
    assert not flash._kernel_path(q, k, v, True)  # the CPU


def test_flash_stats_count_the_plain_path():
    q, k, v = _qkv(1, 4, 2, 40, 16, 16)
    flash.flash_stats.reset()
    flash.flash_attention(q, k, v, True, 16)
    flash.flash_attention(q, k, v, False, 16)
    assert (flash.flash_stats.plain, flash.flash_stats.kernel) == (2, 0)
    flash.flash_stats.reset()
    assert (flash.flash_stats.plain, flash.flash_stats.kernel) == (0, 0)


@pytest.mark.parametrize("view", [
    lambda x: x.transpose(1, 2),
    lambda x: x.transpose(1, 2).transpose(2, 3).contiguous().transpose(2, 3),
], ids=["transposed", "d-strided"])
def test_kernel_path_hands_operands_over_as_they_lie(monkeypatch, view):
    """The kernel path gives the wrapper q, k and v themselves, whatever
    their strides: an operand TMA cannot read reaches the wrapper, which
    raises on the card, and is never copied."""
    seen = []

    def fwd(q, k, v):
        seen.append((q, k, v))
        return flash._flash_fwd(q, k, v, True, 64)

    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(flash, "_kernel_path", lambda *a: True)
    q, k, v = (view(torch.randn(1, 16, 2, 64, dtype=BF16)) for _ in range(3))
    flash.flash_stats.reset()
    flash.flash_attention(q, k, v, True, 64)
    assert flash.flash_stats.kernel == 1
    assert len(seen) == 1 and all(a is b for a, b in zip(seen[0], (q, k, v)))


@pytest.mark.parametrize("ratio", [1, 2, 6])
def test_grouped_kv_bit_equal_to_repeated(ratio):
    """Query head h reads KV head h // ratio: the plain path on the grouped
    K/V gives the bits of the same call on K/V repeated per query head."""
    q, k, v = _qkv(2, 6, 6 // ratio, 600, 32, 24, BF16)
    got = flash.flash_attention(q, k, v, True, 128)
    rk = torch.repeat_interleave(k, ratio, dim=1)
    rv = torch.repeat_interleave(v, ratio, dim=1)
    want = flash.flash_attention(q, rk, rv, True, 128)
    assert torch.equal(got, want)


def test_grouped_heads_must_divide():
    q, k, v = _qkv(1, 6, 4, 40, 16, 16)
    with pytest.raises(ValueError, match="group"):
        flash.flash_attention(q, k, v, True, 16)


@pytest.mark.parametrize("ratio", [1, 3])
def test_kernel_path_backward_sums_each_group(monkeypatch, ratio):
    """The kernel path saves the grouped K/V and folds the repeated
    backward's dk, dv over each group.  With the kernel's forward replaced
    by the plain one on repeated K/V, its gradients are the repeated path's
    (float32: the same products, summed over the group in another order)."""
    def plain_fwd(q, k, v):
        n = q.shape[1] // k.shape[1]
        return flash._flash_fwd(q, flash._repeat_heads(k, n),
                                flash._repeat_heads(v, n), True, 64)

    monkeypatch.setattr(fa, "flash_attention_fwd", plain_fwd)
    q, k, v = _qkv(2, 6, 6 // ratio, 150, 16, 8, grad=True)
    dout = torch.randn(2, 6, 150, 8, generator=torch.Generator().manual_seed(1))
    out = flash._FlashAttention.apply(q, k, v, True, 64, True)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out2 = flash.flash_attention(q2, k2, v2, True, 64)
    want = torch.autograd.grad(out2, (q2, k2, v2), dout)
    assert torch.equal(out, out2)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,dqk,dv", [(BF16, 128, 128), (F32, 128, 128),
                                         (BF16, 64, 64)],
                         ids=["bf16", "float32", "dims-64"])
def test_wrapper_refuses_cpu_tensors(dtype, dqk, dv):
    q, k, v = _qkv(1, 4, 2, 64, dqk, dv, dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("view,ready", [
    (lambda x: x.transpose(1, 2), True),                 # (B, S, H, D) view
    (lambda x: x.contiguous(), True),
    (lambda x: x.transpose(2, 3), False),                # D not contiguous
    (lambda x: x[..., 1:], False),                       # 2-byte offset
    (lambda x: x[..., :-8], True),                       # 16-byte row stride
    (lambda x: x[..., :-4].contiguous(), False),         # rows of 120 bytes
], ids=["transposed", "contiguous", "d-strided", "misaligned", "padded-rows",
        "odd-rows"])
def test_tma_ready(view, ready):
    x = torch.zeros(2, 64, 3, 64, dtype=BF16)
    assert fa.tma_ready(view(x)) is ready


@pytest.mark.parametrize("shape,want", [
    ((4, 128, 128, 4096, 192, 128), 6),     # DeepSeek: 2.6 MB of K/V a row
    ((4, 12, 2, 2048, 128, 128), 48),       # qwen2: 6 rows share 1 MB
    ((1, 2, 2, 2048, 128, 128), 2),         # never more than B·H rows
    ((1, 1, 1, 2 ** 20, 192, 128), 1),      # at least one row
])
def test_chunk_rows_keep_a_chunks_kv_within_the_l2_share(shape, want):
    b, h, hkv, s, dqk, dv = shape
    got = fa.chunk_rows(*shape)
    assert got == want
    assert got == 1 or got * s * (dqk + dv) * 2 * hkv // h <= fa.L2_SHARE
