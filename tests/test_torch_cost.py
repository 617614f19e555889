"""The dry run's per-step cost counter (``repro_torch.distributed.cost``),
the counterpart of ``repro.distributed.hlo_cost``: the cases of
``tests/test_hlo_cost.py`` on the port, with its loop folding held to the
fully traced count, and local (per-rank) counting under DTensor.

Every count here is compared exactly (shapes decide them all); the tensors
are on the ``"meta"`` device, so nothing is computed.
"""

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed.cost import CostCounter, fold_loop
from repro_torch.models import build_model, flash
from repro_torch.models import layers as L

META = "meta"


def _counted(fn, fold: bool):
    c = CostCounter(fold_loops=fold)
    with c:
        fn()
    return c


def test_plain_matmul_exact():
    b, d, e = 256, 512, 384
    x = torch.empty(b, d, device=META)
    w = torch.empty(d, e, device=META)
    c = _counted(lambda: x @ w, False)
    assert c.flops == 2 * b * d * e
    assert c.bytes == (b * d + d * e + b * e) * 4


def test_bytes_at_least_operands_plus_outputs():
    b, d = 256, 512
    x = torch.empty(b, d, device=META)
    c = _counted(lambda: torch.tanh(x) + 1.0, False)
    assert c.bytes >= 2 * b * d * 4
    assert c.flops == 2 * b * d  # ≈1 flop per output element, two ops


@pytest.mark.parametrize("fold", [False, True])
def test_scan_layers_is_layers_times_one_layer(fold):
    """``scan_layers`` over L layers counts L × one layer, folded (one
    layer traced, ×L) or traced in full."""
    b, d, n = 128, 256, 12
    cfg = reduced(get_config("qwen2-1.5b")).replace(remat=False)
    x = torch.empty(b, d, device=META)
    ws = [torch.empty(d, d, device=META) for _ in range(n)]

    def body(c, w):
        return torch.relu(c @ w)

    one = _counted(lambda: body(x, ws[0]), False)
    c = _counted(lambda: L.scan_layers(body, x, ws, cfg), fold)
    assert c.flops == n * one.flops == n * (2 * b * d * d + b * d)
    assert c.bytes == n * one.bytes


def _remat_step(fold: bool, group: int):
    b, d, n = 32, 64, 12
    cfg = reduced(get_config("qwen2-1.5b")).replace(remat=True)
    x = torch.empty(b, d, device=META, requires_grad=True)
    stacked = torch.empty(n, d, d, device=META, requires_grad=True)

    def step():  # the models' layout: one stacked leaf, read once
        ws = L.unstack_layers(stacked, n)
        y = L.scan_layers(lambda c, w: torch.tanh(c @ w), x, ws, cfg, group)
        torch.autograd.grad(y.sum(), [x, stacked])

    return _counted(step, fold)


@pytest.mark.parametrize("group", [1, 3, 4])
def test_nested_remat_groups_folded_equals_traced(group):
    """Hierarchical remat (groups of checkpointed layers, each group
    checkpointed): the folded forward, recomputation and backward count
    what the fully traced step counts."""
    full, folded = _remat_step(False, group), _remat_step(True, group)
    assert folded.flops == full.flops
    # the one difference: the stacked leaf's backward (unbind's) fills the
    # 11 untraced layers' gradients from one float32 zero scalar each
    assert folded.bytes - full.bytes == 11 * 4
    assert folded.by_op["zeros"][1] - full.by_op.get("zeros", [0, 0])[1] \
        == 11 * 4


def test_collectives_inside_layers_multiplied():
    """A collective in every layer is counted once per layer, folded or
    traced (the reference's trip-count multiplication)."""
    import torch.distributed._functional_collectives as fc
    from repro_torch.launch.mesh import fake_world
    b, d, n = 16, 32, 6
    x = torch.empty(b, d, device=META)
    ws = [torch.empty(d, d, device=META) for _ in range(n)]
    with fake_world(4):
        group = torch.distributed.group.WORLD

        def run():
            return fold_loop(lambda c, w: fc.wait_tensor(
                fc.all_reduce(c @ w, "sum", group)), x, ws)
        counts = [_counted(run, fold) for fold in (False, True)]
    for c in counts:
        assert c.coll_counts["all-reduce"] == n
        assert c.coll_bytes["all-reduce"] == n * b * d * 4
    assert counts[0].flops == counts[1].flops


def test_flash_loops_folded_equal_traced():
    """Flash attention's block loops at T = 2048 (4 blocks of 512; the
    causal pairs folded by their mean per row): forward and backward
    counts folded equal the fully traced counts."""
    q, k, v = (torch.empty(1, 2, 2048, 64, dtype=torch.bfloat16,
                           device=META) for _ in range(3))

    def run():
        out, lse = flash._flash_fwd(q, k, v, True, 512)
        flash._flash_bwd(q, k, v, out, lse, out, True, 512)

    full, folded = _counted(run, False), _counted(run, True)
    assert folded.flops == full.flops
    assert folded.bytes == full.bytes
    # 10 causal block pairs: QK and PV forward, QK, dV, dP, dK, dQ backward
    pair = 2 * 2 * 512 * 512 * 64
    assert full.by_op["bmm"][0] == 10 * 7 * pair


@pytest.mark.parametrize("remat", [False, True])
def test_reduced_dense_train_step_matmul_flops(remat):
    """One reduced dense train step's matmul FLOPs equal the analytic count
    from its shapes and the remat schedule: forward + backward (2×) of
    every layer and of the tied unembed, the unembed's chunk recomputed
    (its checkpoint), and under remat each layer's forward recomputed up to
    its last saved activation — the down projection's output is not saved,
    so the recomputation stops before it.  The schedule is the installed
    torch's non-reentrant checkpoint (2.13 here; 2.11 recomputes more)."""
    from repro_torch.optim import AdamWConfig, adamw, adamw_step
    cfg = reduced(get_config("qwen2-1.5b"), n_layers=4,
                  accum_steps=1).replace(remat=remat)
    m = build_model(cfg, device=META)
    p = m.abstract_params()
    o = adamw.init(p, AdamWConfig())
    bsz, s = 2, 256
    tok = torch.zeros((bsz, s), dtype=torch.int32, device=META)
    for fold in (False, True):
        c = _counted(lambda: adamw_step(m.loss_fn, p, o, {
            "tokens": tok, "labels": tok}, AdamWConfig()), fold)
        t = bsz * s
        d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
        proj = 2 * t * (d * q + 2 * d * kv + q * d + 3 * d * ff)
        att = 2 * 2 * bsz * cfg.n_heads * s * s * cfg.head_dim
        head = 2 * t * d * cfg.vocab_size
        want = 3 * cfg.n_layers * (proj + att) + 4 * head
        if remat:
            want += cfg.n_layers * (proj + att - 2 * t * ff * d)
        assert c.by_op["mm"][0] + c.by_op["bmm"][0] == want


def test_dtensor_matmul_counts_local_shards_only():
    """A (64×1536)·(1536×8960) DTensor matmul on the 16×16 fake mesh
    (rows on data, columns on model) counts the local shard's
    2·4·1536·560, not the global op on top of it."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import fake_world, make_mesh
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device=META)
        x = distribute_tensor(torch.empty(64, 1536, device=META), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(1536, 8960, device=META), mesh,
                              [Replicate(), Shard(1)])
        c = _counted(lambda: x @ w, False)
    assert c.flops == 2 * 4 * 1536 * 560
    assert c.coll_counts == {}


def test_kernel_ops_count_their_formulas():
    """The two custom ops' FLOP formulas: the WKV scan's operation count
    (PERF.md §6) and the GEMM's 2·M·N·K."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv_scan import wkv_flops
    bh, nc, ch, d = 8, 4, 32, 64
    f32 = dict(device=META)
    a = torch.empty(bh, nc, ch, d, **f32)
    c = _counted(lambda: ops.wkv_scan(
        a, a, a, torch.empty(bh, nc, 1, d, **f32),
        torch.empty(bh, nc, ch, 1, **f32)), False)
    assert c.by_op["wkv_scan"][0] == wkv_flops(bh, nc, ch, d) == bh * nc * (
        2 * ch * (ch - 1) * d + 4 * ch * d * d + 3 * ch * d + 2 * d * d)
    m, k, n = 96, 256, 80
    i8 = dict(dtype=torch.int8, device=META)
    c = _counted(lambda: ops.fixedpoint_matmul(
        torch.empty(m, k, **i8), torch.empty(k, n, **i8),
        torch.empty(m, 1, device=META), torch.empty(1, n, device=META)),
        False)
    assert c.by_op["fixedpoint_matmul"][0] == 2 * m * n * k


def test_live_bytes_peak_tracks_storages():
    """The live-bytes peak: arguments registered, temporaries freed when
    their last tensor dies."""
    x = torch.empty(1024, device=META)
    c = CostCounter()
    assert c.track([x]) == 4096
    with c:
        y = x * 2  # +4096
        z = y + 1  # +4096, peak 12288
        del y
        w = z * 3  # y freed: live 12288 again
    assert c.peak == 3 * 4096
    assert c.live == 3 * 4096
    del z, w
    assert c.live == 4096
