"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

  1. device  — a CUDA card must be visible; prints its name and power limit.
  2. build   — compiles every hand-written kernel of the path with nvcc
               (one process per source, all started together) into
               build/kernels/, and logs registers, shared memory and spills.
  3. kernels — each kernel against its plain PyTorch versions on the card, on
               the same inputs, at the serving shapes and at edge shapes:
               results must be equal (torch.equal — integer codes, zero
               tolerance).  The fused MLP kernel in both weight lanes; the
               two forest kernels (pointer chase and range table) against
               the gather and the masked plain versions, on random, trained,
               saturating, stump and padded tables, and against the masked
               versions alone on tables that install_forest rejects.
  4. serve   — PacketServer() at its defaults on the card serves seeded
               traces of ragged chunks with duplicates and unknown Model IDs;
               its egress must be byte-identical, in submission order, to
               the port's own PacketServer(device="cpu") fed the same trace:
                 * 8 MLPs + 8 trained forests, 200k packets, range-table
                   forest lane, with a retrained forest installed mid-trace;
                 * the same mixed trace at 50k packets on the pointer chase;
                 * 16 MLPs, 200k packets on the int16 lane and 50k on the
                   int8 lane, with an MLP hot-swap mid-trace.
               The launch counters are zeroed right before the card's run and
               read right after it: every kernel of the path must have
               launched, the serving-configuration count must stay flat
               across the install, and a mixed run must dispatch both MLP and
               forest batches.
  5. numbers — per-kernel time (CUDA events: per call as the path issues
               it, and queued behind a device sleep, device only), the
               plain version's time, the least time the card could take
               (bytes or operations over its peak), and each path's packets
               per second with its engine-call and kernel shares of the wall
               time.

Output: a JSON line of per-kernel numbers, the card's name and power limit,
and, as the last line, {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.paper_models import PAPER_MODELS, make_paper_model  # noqa: E402
from repro_torch.core.control_plane import ControlPlane  # noqa: E402
from repro_torch.core.packet import HEADER_BYTES, encode_packets_np  # noqa: E402
from repro_torch.core.taylor import scaled_constants  # noqa: E402
from repro_torch.data.packets import anomaly_dataset, qos_dataset  # noqa: E402
from repro_torch.forest import train_forest  # noqa: E402
from repro_torch.forest.synthetic import (random_forest_tables,  # noqa: E402
                                          rejected_tables, stack_ranges)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fixedpoint_mlp as fmlp  # noqa: E402
from repro_torch.kernels import forest_traversal as ftk  # noqa: E402
from repro_torch.kernels.ops import forest_traverse, fused_mlp  # noqa: E402
from repro_torch.kernels.ref import (forest_range_gather_ref,  # noqa: E402
                                     forest_traverse_gather_ref,
                                     fused_mlp_gather_ref)
from repro_torch.launch.serve import PacketServer  # noqa: E402

SEED = 0
FRAC = 8
LEAKY_Q = 3  # round(0.01 * 2**FRAC), the engine's default slope
WIDTH = 32
# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12   # non-tensor-core rate (the float32 figure)
INT8_TENSOR_OPS_PER_S = 1979e12
# int32 compares, selects and adds on the CUDA cores: 64 INT32 lanes per SM
# (NVIDIA Hopper architecture white paper) × 132 SMs × 1.98 GHz boost clock
# (H100 SXM5 data sheet)
INT32_CORE_OPS_PER_S = 64 * 132 * 1.98e9
I32 = np.iinfo(np.int32)

# the forest family at the server's defaults: F forests, T trees, N nodes,
# the traversal depth bound, NI range entries and L leaves per tree
F, T, N, DEPTH = 8, 16, 64, 6
NI, NL = 31, 32
MLP_IDS = list(range(1, 9))
FOREST_IDS = list(range(9, 17))

# the kernels of the path: MLP weight lanes and forest variants
_FOREST_SRC = "src/repro_torch/kernels/csrc/forest_traversal.cu"
KERNELS = {
    "int16": dict(name="fixedpoint_mlp_int16", route="cuda",
                  source="src/repro_torch/kernels/csrc/fixedpoint_mlp.cu",
                  replaces="src/repro/kernels/fixedpoint_mlp.py:111"),
    "int8": dict(name="fixedpoint_mlp_int8", route="cuda",
                 source="src/repro_torch/kernels/csrc/fixedpoint_mlp.cu",
                 replaces="src/repro/kernels/fixedpoint_mlp.py:111"),
    "chase": dict(name="forest_chase", route="cuda", source=_FOREST_SRC,
                  replaces="src/repro/kernels/forest_traversal.py:125"),
    "range": dict(name="forest_range", route="cuda", source=_FOREST_SRC,
                  replaces="src/repro/kernels/forest_traversal.py:227"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    fmlp.reset_launches()
    ftk.reset_launches()


def read_launches() -> dict:
    return {**fmlp.launches, **ftk.launches}


# ---------------------------------------------------------------------------
# MLP kernel inputs, checks and timing
# ---------------------------------------------------------------------------


def make_case(rng, dev, *, n_batch, n_models, n_layers, width, variant):
    """Random tables and codes: every opcode 0..4 plus an invalid one, gaps
    in layer_on, and codes near ±2**30 so accumulators wrap."""
    w_dtype = np.int8 if variant == "int8" else np.int16
    info = np.iinfo(w_dtype)
    w = rng.integers(info.min, info.max, (n_models, n_layers, width, width),
                     endpoint=True).astype(w_dtype)
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, (n_models, n_layers, width),
                     endpoint=True).astype(np.int32)
    act = rng.choice(np.asarray([0, 1, 2, 3, 4, 7], np.int32),
                     (n_models, n_layers)).astype(np.int32)
    on = (rng.random((n_models, n_layers)) < 0.75).astype(np.int32)
    x = rng.integers(-2 ** 14, 2 ** 14, (n_batch, width)).astype(np.int32)
    big = rng.random((n_batch, width)) < 0.1
    x[big] = rng.integers(-2 ** 30, 2 ** 30, int(big.sum()))
    slot = rng.integers(0, n_models, n_batch).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return dict(x_q=t(x), slot=t(slot), w=t(w), b=t(b), act=t(act),
                layer_on=t(on))


def kernel_kw(order: int = 3):
    return dict(frac=FRAC, sig_coeffs=tuple(int(c) for c in scaled_constants(
        "sigmoid", order, FRAC)), leaky_alpha_q=LEAKY_Q)


def check_kernels(dev, shapes, variants=("int16", "int8")) -> dict:
    """Each (variant, shape): kernel wrapper vs plain gather form vs the
    masked-GEMM plain version, all on ``dev``; returns the largest absolute
    difference per variant (must be 0)."""
    rng = np.random.default_rng(SEED)
    worst = {v: 0 for v in variants}
    for variant in variants:
        for (n_batch, n_models, n_layers, width, order) in shapes:
            c = make_case(rng, dev, n_batch=n_batch, n_models=n_models,
                          n_layers=n_layers, width=width, variant=variant)
            kw = kernel_kw(order)
            k = fmlp.fixedpoint_mlp(**c, **kw, variant=variant)
            lane = 8 if variant == "int8" else None
            plain = fused_mlp_gather_ref(**c, **kw, lane_bits=lane)
            masked = fused_mlp(c["x_q"], c["slot"], c["w"], c["b"], c["act"],
                               c["layer_on"], backend="ref", variant=variant,
                               **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = int((k.to(torch.int64) - plain.to(torch.int64)).abs().max())
            worst[variant] = max(worst[variant], err)
            ok = torch.equal(k, plain) and torch.equal(k, masked)
            log(f"kernel {variant:5s} B={n_batch:5d} M={n_models:2d} "
                f"L={n_layers} W={width:2d} order={order}: "
                f"{'equal' if ok else 'DIFFERS'} (max_abs_err {err})")
            if not ok:
                raise SystemExit(f"fixedpoint_mlp {variant} differs from its "
                                 f"plain version at B={n_batch} W={width}")
    return worst


def cuda_ms(fn, reps: int = 21, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def queued_ms(fn, reps: int = 11, inner: int = 20,
              sleep_cycles: int = 8_000_000) -> float:
    """Device time alone: median over ``reps`` CUDA-event windows of
    ``inner`` calls, queued behind a device-side sleep of ``sleep_cycles``
    (≈4 ms at the boost clock) so that the host has issued every call
    before the first one runs, and the events time the device's back-to-back
    execution, not the host's issue rate.  For µs-scale kernels the
    :func:`cuda_ms` windows measure the wrapper's host cost instead."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int, ops: int, peak: float):
    """The larger of bytes over HBM bandwidth and operations over ``peak``,
    in ms, with which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(case, variant: str):
    """Least time for the MLP kernel: each input read once and the output
    written once over HBM bandwidth, vs the multiply-adds this data needs
    (2·W² per enabled layer of each packet's model) over the peak for their
    type."""
    x, slot, w = case["x_q"], case["slot"], case["w"]
    width = x.shape[1]
    n_bytes = nbytes(x, slot, w, case["b"], case["act"],
                     case["layer_on"]) + x.numel() * 4
    layers_on = (case["layer_on"] > 0).sum(1)[slot.long()].sum().item()
    ops = 2 * width * width * int(layers_on)
    peak = INT8_TENSOR_OPS_PER_S if variant == "int8" else CUDA_CORE_OPS_PER_S
    return bound_ms(n_bytes, ops, peak)


# ---------------------------------------------------------------------------
# forest kernel inputs, checks and timing
# ---------------------------------------------------------------------------


def train_forests():
    """The slice's eight forests (ids 9–16): forest k is an anomaly
    classifier (even k) or a QoS regressor (odd k) on 2048 flows of width
    32, 16 trees of depth ≤ 6; plus the anomaly classifier retrained on
    drifted traffic, installed as id 9 mid-trace.  ``max_nodes=61`` keeps
    every tree within the 64-node, 32-leaf tables (ROADMAP R3)."""
    kw = dict(n_trees=T, max_depth=DEPTH, max_nodes=61)
    forests = {}
    for k in range(8):
        rng = np.random.default_rng(100 + k)
        if k % 2 == 0:
            X, y = anomaly_dataset(rng, 2048, WIDTH)
            forests[9 + k] = train_forest(X, y, task="classify",
                                          seed=200 + k, **kw)
        else:
            X, y = qos_dataset(rng, 2048, WIDTH)
            forests[9 + k] = train_forest(X, y, task="regress",
                                          seed=200 + k, **kw)
    X, y = anomaly_dataset(np.random.default_rng(108), 2048, WIDTH,
                           drift=0.35)
    drifted = train_forest(X, y, task="classify", seed=208, **kw)
    return forests, drifted


def trained_tables(forests):
    """The trained forests as the control plane lays them out (F=8, T=16,
    N=64, NI=31, L=32), on the host."""
    cp = ControlPlane(max_width=WIDTH)
    for mid, forest in forests.items():
        cp.install_forest(mid, forest)
    ft, rt = cp.forest_snapshots(True)
    return (ft.nodes.numpy(), ft.tree_on.numpy(), ft.mode.numpy(),
            tuple(a.numpy() for a in (rt.feat, rt.thresh, rt.lmask,
                                      rt.payload)))


def forest_inputs(rng, n_batch, width, n_forests):
    """Codes on the wire grid, with a tenth of the rows across the whole
    int32 range and rows at INT32_MIN / INT32_MAX; slots in [0, F)."""
    x = rng.integers(-1000, 1000, (n_batch, width)).astype(np.int32)
    wide = rng.random(n_batch) < 0.1
    x[wide] = rng.integers(I32.min, I32.max, (int(wide.sum()), width),
                           endpoint=True)
    x[:1] = I32.min
    x[-1:] = I32.max
    slot = rng.integers(0, n_forests, n_batch).astype(np.int32)
    return x, slot


def table_cases(rng, extent, trained):
    """Valid table cases at one extent: ``(name, nodes, tree_on, mode,
    ranges, depth)``."""
    n_forests, n_trees, n_nodes, width, depth, ni, nl = extent
    cases = []

    def add(name, nodes, tree_on, mode, table_depth):
        ranges = stack_ranges(nodes, tree_on, table_depth, n_entries=ni,
                              n_leaves=nl)
        cases.append((name, nodes, tree_on, mode, ranges, depth))

    add("random", *random_forest_tables(rng, n_forests, width, depth,
                                        n_trees=n_trees, n_nodes=n_nodes),
        depth)
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    idx = np.arange(n_nodes)
    internal = nodes[..., 2] != idx
    flip = np.cumsum(internal, axis=-1) % 2 == 0
    nodes[..., 1] = np.where(internal, np.where(flip, I32.max, I32.min),
                             nodes[..., 1])
    add("saturating", nodes, tree_on, mode, depth)
    add("stumps", *random_forest_tables(rng, n_forests, width, 1,
                                        n_trees=n_trees, n_nodes=n_nodes), 1)
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    tree_on[:, 1::2] = 0  # padded trees hold in-range garbage
    dead = tree_on == 0
    junk = rng.integers(0, min(width, n_nodes), nodes[dead].shape)
    nodes[dead] = junk.astype(np.int32)
    add("padded", nodes, tree_on, mode, depth)
    if trained is not None:
        nodes, tree_on, mode, ranges = trained
        cases.append(("trained", nodes, tree_on, mode, ranges, depth))
    return cases


def _dev(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in arrays]


def check_forest(dev, name, x, slot, nodes, tree_on, mode, ranges, depth,
                 *, gather: bool):
    """Both forest kernels against the masked plain versions (and the
    gather ones when ``gather``); returns the largest absolute
    difference."""
    x, slot, nodes, tree_on, mode = _dev(dev, x, slot, nodes, tree_on, mode)
    rng_t = _dev(dev, *ranges)
    kw = dict(max_depth=depth, frac=FRAC)
    got = {"chase": ftk.forest_traverse(x, slot, nodes, tree_on, mode, **kw),
           "range": ftk.forest_range(x, slot, *rng_t, tree_on, mode,
                                     frac=FRAC)}
    want = {v: [forest_traverse(x, slot, nodes, tree_on, mode, **kw,
                                backend="ref", variant=v, ranges=rng_t)]
            for v in got}
    if gather:
        want["chase"].append(forest_traverse_gather_ref(
            x, slot, nodes, tree_on, mode, **kw))
        want["range"].append(forest_range_gather_ref(
            x, slot, *rng_t, tree_on, mode, frac=FRAC))
    torch.cuda.synchronize()
    worst = {}
    for v in got:
        err = max(int((got[v].to(torch.int64) - w.to(torch.int64)).abs().max())
                  for w in want[v])
        worst[v] = err
        ok = all(torch.equal(got[v], w) for w in want[v])
        log(f"kernel forest_{v:5s} {name:10s} B={x.shape[0]:5d} "
            f"F={nodes.shape[0]} T={nodes.shape[1]} N={nodes.shape[2]:2d} "
            f"W={x.shape[1]:2d} depth={depth}: "
            f"{'equal' if ok else 'DIFFERS'} to the "
            f"{'masked and gather' if gather else 'masked'} plain versions "
            f"(max_abs_err {err})")
        if not ok:
            raise SystemExit(f"forest {v} kernel differs from its plain "
                             f"version ({name}, B={x.shape[0]})")
    return worst


def check_forest_kernels(dev, trained) -> dict:
    rng = np.random.default_rng(SEED + 3)
    worst = {"chase": 0, "range": 0}
    extents = [(F, T, N, WIDTH, DEPTH, NI, NL),   # the serving extents
               (3, 5, 16, 8, 4, 7, 8)]           # a small one
    for e, extent in enumerate(extents):
        cases = table_cases(rng, extent, trained if e == 0 else None)
        bad = rejected_tables(rng, *extent)
        for n_batch in (1, 127, 2048, 4099):
            for name, nodes, tree_on, mode, ranges, depth in cases:
                x, slot = forest_inputs(rng, n_batch, extent[3], extent[0])
                errs = check_forest(dev, name, x, slot, nodes, tree_on, mode,
                                    ranges, depth, gather=True)
                for v in errs:
                    worst[v] = max(worst[v], errs[v])
            x, _ = forest_inputs(rng, n_batch, extent[3], extent[0])
            slot = rng.integers(-2, extent[0] + 3, n_batch).astype(np.int32)
            errs = check_forest(dev, "rejected", x, slot, *bad, extent[4],
                                gather=False)
            for v in errs:
                worst[v] = max(worst[v], errs[v])
    return worst


def forest_bound(x, slot, nodes, tree_on, mode, ranges, variant: str):
    """Least time for one forest kernel call: x, slot, the tables it reads
    (each once) and the output over HBM bandwidth, vs its int32 operations
    over the CUDA cores' int32 rate.  Operations per live tree of each
    packet's forest: a compare and a select per visited node (the chase
    takes ``DEPTH`` steps) or per real range entry (padding entries
    excluded), plus the vote's add."""
    live = (tree_on > 0)[slot.long()]                          # (B, T)
    if variant == "chase":
        tables = (nodes, tree_on, mode)
        per_tree = torch.full_like(live, 2 * DEPTH + 1, dtype=torch.int64)
    else:
        feat, thresh, lmask, payload = ranges
        tables = (feat, thresh, lmask, payload, tree_on, mode)
        real = (thresh != int(I32.max)).sum(-1)[slot.long()]   # (B, T)
        per_tree = 2 * real.to(torch.int64) + 1
    ops = int((per_tree * live).sum())
    n_bytes = nbytes(x, slot, *tables) + x.numel() * 4
    return bound_ms(n_bytes, ops, INT32_CORE_OPS_PER_S)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------


def install_models(srv, rng, ids=None, width: int = WIDTH,
                   n_layers: int = 4) -> list:
    """The three paper models plus random 4-layer width-32 models mixing
    every activation, under ``ids`` (default: 1–3 for the paper models and
    100, 101, … up to ``max_models``).  Returns the installed ids."""
    if ids is None:
        ids = [1, 2, 3] + [100 + m for m in
                           range(srv.control_plane.max_models - 3)]
    for i, name in enumerate(sorted(PAPER_MODELS)):
        layers, acts = make_paper_model(name, rng)
        srv.install(ids[i], layers, acts, final_activation="sigmoid")
    kinds = ["sigmoid", "relu", "leaky_relu", "hard_sigmoid"]
    for m, mid in enumerate(ids[len(PAPER_MODELS):]):
        layers = [(rng.normal(size=(width, width)).astype(np.float32)
                   * (1.5 / np.sqrt(width)),
                   rng.normal(size=(width,)).astype(np.float32) * 0.1)
                  for _ in range(n_layers)]
        acts = [kinds[(m + j) % 4] for j in range(n_layers - 1)]
        srv.install(mid, layers, acts, final_activation=kinds[m % 4])
    return list(ids)


def make_trace(rng, n_packets: int, ids: list, unknown=(7, 999),
               width: int = WIDTH):
    """Wire rows (≈30% exact duplicates, ≈3% uninstalled Model IDs drawn
    from ``unknown``) and ragged chunk boundaries (1–4096 rows)."""
    n_uniq = int(n_packets * 0.7)
    feats = np.round(rng.normal(size=(n_uniq, width)) * (1 << FRAC)
                     ).astype(np.int32)
    mids = rng.choice(np.asarray(list(ids) + list(unknown), np.int32),
                      n_uniq, p=[0.97 / len(ids)] * len(ids)
                      + [0.03 / len(unknown)] * len(unknown))
    uniq = encode_packets_np(mids, FRAC, feats)
    pick = np.concatenate([np.arange(n_uniq),
                           rng.integers(0, n_uniq, n_packets - n_uniq)])
    rows = uniq[rng.permutation(pick)]
    cuts = np.cumsum(rng.integers(1, 4097, n_packets // 64))
    cuts = np.unique(cuts[cuts < n_packets])
    return rows, np.split(rows, cuts)


def serve_trace(dev, n_packets: int, *, weight_bits: int = 16,
                kernel_variant: str = "int16", forests=None, drifted=None,
                **server_kw):
    """Serve one seeded trace.  With ``forests`` the server holds 8 MLPs
    (ids 1–8) and the 8 forests (ids 9–16) and installs ``drifted`` as id 9
    mid-trace; without, 16 MLPs with an MLP hot-swap mid-trace.  The launch
    counters are zeroed right before the trace and read right after it.
    Returns a dict: egress rows, seconds, recompiles before and after the
    install, seconds inside the engine's dispatch call (host→device copy,
    launches, queued copy back), launches, lane batches."""
    rng = np.random.default_rng(SEED + 1)
    srv = PacketServer(device=dev, weight_bits=weight_bits,
                       kernel_variant=kernel_variant, **server_kw)
    engine_s = [0.0]
    dispatch = srv.engine.run_features

    def timed_dispatch(*a, **kw):
        t = time.perf_counter()
        try:
            return dispatch(*a, **kw)
        finally:
            engine_s[0] += time.perf_counter() - t

    if forests is None:
        ids = install_models(srv, rng)
        _, chunks = make_trace(rng, n_packets, ids)
        new_layers = [(rng.normal(size=(32, 32)).astype(np.float32) * 0.2,
                       np.zeros(32, np.float32)) for _ in range(4)]

        def swap():
            srv.install(ids[-1], new_layers, ["relu", "sigmoid", "leaky_relu"],
                        final_activation="hard_sigmoid")
    else:
        install_models(srv, rng, ids=MLP_IDS)
        for mid, forest in forests.items():
            srv.install_forest(mid, forest)
        # all three lane programs once, before the trace: batches staged
        # before the mid-trace install dispatch on the "both" program
        srv.engine.warm(srv.ingress.batch_size, HEADER_BYTES + 4 * WIDTH,
                        lanes=("mlp", "forest", "both"))
        _, chunks = make_trace(rng, n_packets, MLP_IDS + FOREST_IDS,
                               unknown=(17, 999))

        def swap():
            srv.install_forest(FOREST_IDS[0], drifted)
    srv.engine.run_features = timed_dispatch
    mid = len(chunks) // 2
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i, chunk in enumerate(chunks):
        if i == mid:
            rc_before = srv.stats()["recompiles"]
            swap()
        srv.submit_packets(chunk)
    out = srv.drain_packets()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    bad = [o for o in out if not isinstance(o, np.ndarray)]
    if bad:
        raise SystemExit(f"{len(bad)} error slots, first: {bad[0]}")
    return dict(rows=np.stack(out), seconds=dt, rc_before=rc_before,
                rc_after=srv.stats()["recompiles"], engine_s=engine_s[0],
                launches=launches,
                lane_batches=dict(srv.ingress.stats["lane_batches"]))


def run_path(dev, n_packets: int, label: str, kernels: tuple, card: str,
             **kw) -> dict:
    """The card's run against the CPU port's on the same trace; every
    kernel in ``kernels`` must have launched on the card's run."""
    ref = serve_trace(torch.device("cpu"), n_packets, **kw)
    run = serve_trace(dev, n_packets, **kw)
    rows, ref_rows = run["rows"], ref["rows"]
    same = rows.shape == ref_rows.shape and np.array_equal(rows, ref_rows)
    launches = {k: run["launches"][k] for k in kernels}
    log(f"serve {label}: {n_packets} packets, egress "
        f"{'byte-identical' if same else 'DIFFERS'} to the CPU port; "
        f"launches {launches}; lane batches {run['lane_batches']}; "
        f"recompiles {run['rc_before']} -> {run['rc_after']}; "
        f"{n_packets / run['seconds']:.0f} packets/s on {dev} "
        f"({run['seconds']:.3f} s, of which {run['engine_s']:.3f} s inside "
        f"engine.run_features); {n_packets / ref['seconds']:.0f} packets/s "
        f"with the port on the host CPU [{card}]")
    if not same:
        diff = np.nonzero((rows != ref_rows).any(1))[0]
        raise SystemExit(f"{label} egress differs at {diff.size} rows, "
                         f"first {diff[:5].tolist()}")
    for k in kernels:
        if launches[k] == 0:
            raise SystemExit(f"kernel {k} never launched on the {label} "
                             "serving path")
    if run["rc_before"] != run["rc_after"]:
        raise SystemExit(f"install changed the serving configurations: "
                         f"{run['rc_before']} -> {run['rc_after']}")
    if kw.get("forests") is not None and not (
            run["lane_batches"]["mlp"] and run["lane_batches"]["forest"]):
        raise SystemExit(f"{label}: expected both MLP and forest batches, "
                         f"got {run['lane_batches']}")
    return dict(launches=launches, packets_per_s=n_packets / run["seconds"],
                seconds=run["seconds"], engine_s=run["engine_s"])


def main() -> int:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; card: {smi}")
    t_start = time.perf_counter()

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(["fixedpoint_mlp", "forest_traversal"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    shapes = [(b, 16, 4, 32, 3) for b in (1, 255, 2048, 4099)]
    shapes += [(255, 16, 4, 8, 3), (2048, 16, 4, 8, 5),
               (255, 16, 4, 48, 3), (2048, 16, 4, 48, 1)]
    worst = check_kernels(dev, shapes)
    t0 = time.perf_counter()
    forests, drifted = train_forests()
    log(f"trained {len(forests) + 1} forests on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    trained = trained_tables(forests)
    worst.update(check_forest_kernels(dev, trained))

    # -- 4. the serving path --------------------------------------------------
    mixed = dict(forests=forests, drifted=drifted)
    path = {
        "range": run_path(dev, 200_000, "mixed range", ("int16", "range"),
                          smi, forest_variant="range", **mixed),
        "chase": run_path(dev, 50_000, "mixed chase", ("int16", "chase"),
                          smi, forest_variant="chase", **mixed),
        "int16": run_path(dev, 200_000, "int16", ("int16",), smi,
                          kernel_variant="int16"),
        "int8": run_path(dev, 50_000, "int8", ("int8",), smi, weight_bits=8,
                         kernel_variant="int8"),
    }

    # -- 5. numbers -----------------------------------------------------------
    rng = np.random.default_rng(SEED + 2)
    kernels, k_ms = [], {}
    for variant in ("int16", "int8"):
        case = make_case(rng, dev, n_batch=2048, n_models=16, n_layers=4,
                         width=WIDTH, variant=variant)
        kw = kernel_kw(3)
        lane = 8 if variant == "int8" else None
        def call():
            fmlp.fixedpoint_mlp(**case, **kw, variant=variant)
        k_ms[variant] = cuda_ms(call)
        q_ms = queued_ms(call)
        p_ms = cuda_ms(lambda: fused_mlp_gather_ref(**case, **kw,
                                                    lane_bits=lane))
        b_ms, b_by = bound(case, variant)
        kernels.append(dict(KERNELS[variant],
                            launches=path[variant]["launches"][variant],
                            max_abs_err=worst[variant], ms=k_ms[variant],
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None))
        log(f"time {variant} B=2048 M=16 L=4 W=32: kernel "
            f"{k_ms[variant]:.4f} ms per call ({q_ms:.4f} ms queued, device "
            f"only), plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}) "
            f"[{smi}]")
    nodes, tree_on, mode, ranges = trained
    # codes as the serving trace has them
    x = np.round(rng.normal(size=(2048, WIDTH)) * (1 << FRAC)).astype(np.int32)
    slot = rng.integers(0, F, 2048).astype(np.int32)
    x, slot, nodes, tree_on, mode = _dev(dev, x, slot, nodes, tree_on, mode)
    ranges = _dev(dev, *ranges)
    calls = {
        "chase": (lambda: ftk.forest_traverse(
            x, slot, nodes, tree_on, mode, max_depth=DEPTH, frac=FRAC),
            lambda: forest_traverse_gather_ref(
            x, slot, nodes, tree_on, mode, max_depth=DEPTH, frac=FRAC)),
        "range": (lambda: ftk.forest_range(
            x, slot, *ranges, tree_on, mode, frac=FRAC),
            lambda: forest_range_gather_ref(
            x, slot, *ranges, tree_on, mode, frac=FRAC)),
    }
    for variant, (call, plain) in calls.items():
        k_ms[variant] = cuda_ms(call)
        q_ms = queued_ms(call)
        p_ms = cuda_ms(plain)
        b_ms, b_by = forest_bound(x, slot, nodes, tree_on, mode, ranges,
                                  variant)
        kernels.append(dict(KERNELS[variant],
                            launches=path[variant]["launches"][variant],
                            max_abs_err=worst[variant], ms=k_ms[variant],
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None))
        log(f"time forest_{variant} B=2048 F={F} T={T} N={N} depth={DEPTH} "
            f"NI={NI} L={NL} W={WIDTH} (trained forests): kernel "
            f"{k_ms[variant]:.4f} ms per call ({q_ms:.4f} ms queued, device "
            f"only), plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}) "
            f"[{smi}]")
    for label, p in path.items():
        kernel_s = sum(n * k_ms[k] * 1e-3 for k, n in p["launches"].items())
        log(f"path {label}: {p['packets_per_s']:.0f} packets/s, engine call "
            f"share {p['engine_s'] / p['seconds']:.4f}, kernel share "
            f"{kernel_s / p['seconds']:.5f} of the path's wall time "
            f"(launches {p['launches']}) [{smi}]")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
        "device check")
    print(json.dumps({"kernels": kernels,
                      "path_packets_per_s": {v: path[v]["packets_per_s"]
                                             for v in path}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
