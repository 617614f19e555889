"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

  1. device  — a CUDA card must be visible; prints its name and power limit.
  2. build   — compiles every hand-written kernel of the path with nvcc
               (one process per source, all started together) into
               build/kernels/.
  3. kernels — each kernel against its plain PyTorch version on the card, on
               the same inputs, at the serving shapes and at edge shapes:
               results must be equal (torch.equal — integer codes, zero
               tolerance).
  4. serve   — PacketServer() at its defaults (16 models, 4 layers, width 32,
               2048-row batches) on the card serves a seeded trace of ragged
               chunks with duplicates, unknown Model IDs and a mid-trace
               hot-swap install; its egress must be byte-identical, in
               submission order, to the port's own PacketServer(device="cpu")
               fed the same trace.  The launch counters are zeroed right
               before the card's run and read right after it: every kernel of
               the path must have launched, and the serving-configuration
               count must stay flat across the install.  Repeated with the
               int8 weight lane.
  5. numbers — per-kernel time (CUDA events), plain-version time, the least
               time the card could take (bytes or operations over its peak),
               and the path's packets per second.

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
from repro_torch.core.packet import encode_packets_np  # noqa: E402
from repro_torch.core.taylor import scaled_constants  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fixedpoint_mlp as fmlp  # noqa: E402
from repro_torch.kernels.ops import fused_mlp  # noqa: E402
from repro_torch.kernels.ref import fused_mlp_gather_ref  # noqa: E402
from repro_torch.launch.serve import PacketServer  # noqa: E402

SEED = 0
FRAC = 8
LEAKY_Q = 3  # round(0.01 * 2**FRAC), the engine's default slope
# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12   # non-tensor-core rate (the float32 figure)
INT8_TENSOR_OPS_PER_S = 1979e12

# the one kernel of this path, per weight lane
KERNELS = {
    "int16": dict(name="fixedpoint_mlp_int16", route="cuda",
                  source="src/repro_torch/kernels/csrc/fixedpoint_mlp.cu",
                  replaces="src/repro/kernels/fixedpoint_mlp.py:111"),
    "int8": dict(name="fixedpoint_mlp_int8", route="cuda",
                 source="src/repro_torch/kernels/csrc/fixedpoint_mlp.cu",
                 replaces="src/repro/kernels/fixedpoint_mlp.py:111"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# kernel inputs, checks and timing
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


def bound(case, variant: str):
    """Least time for the card: each input read once and the output written
    once over HBM bandwidth, vs the multiply-adds this data needs (2·W² per
    enabled layer of each packet's model) over the peak for their type."""
    x, slot, w = case["x_q"], case["slot"], case["w"]
    n_batch, width = x.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x, slot, w, case["b"], case["act"],
                           case["layer_on"])) + x.numel() * 4
    layers_on = (case["layer_on"] > 0).sum(1)[slot.long()].sum().item()
    ops = 2 * width * width * int(layers_on)
    peak = INT8_TENSOR_OPS_PER_S if variant == "int8" else CUDA_CORE_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------


def install_models(srv, rng, width: int = 32, n_layers: int = 4) -> list:
    """The three paper models plus random 4-layer width-32 models up to
    ``max_models``, mixing every activation.  Returns the installed ids."""
    ids = []
    for i, name in enumerate(sorted(PAPER_MODELS)):
        layers, acts = make_paper_model(name, rng)
        srv.install(1 + i, layers, acts, final_activation="sigmoid")
        ids.append(1 + i)
    kinds = ["sigmoid", "relu", "leaky_relu", "hard_sigmoid"]
    m = 0
    while len(ids) < srv.control_plane.max_models:
        layers = [(rng.normal(size=(width, width)).astype(np.float32)
                   * (1.5 / np.sqrt(width)),
                   rng.normal(size=(width,)).astype(np.float32) * 0.1)
                  for _ in range(n_layers)]
        acts = [kinds[(m + j) % 4] for j in range(n_layers - 1)]
        srv.install(100 + m, layers, acts, final_activation=kinds[m % 4])
        ids.append(100 + m)
        m += 1
    return ids


def make_trace(rng, n_packets: int, ids: list, width: int = 32):
    """Wire rows (≈30% exact duplicates, ≈3% uninstalled Model IDs) and
    ragged chunk boundaries."""
    n_uniq = int(n_packets * 0.7)
    feats = np.round(rng.normal(size=(n_uniq, width)) * (1 << FRAC)
                     ).astype(np.int32)
    mids = rng.choice(np.asarray(ids + [7, 999], np.int32), n_uniq,
                      p=[0.97 / len(ids)] * len(ids) + [0.015, 0.015])
    uniq = encode_packets_np(mids, FRAC, feats)
    pick = np.concatenate([np.arange(n_uniq),
                           rng.integers(0, n_uniq, n_packets - n_uniq)])
    rows = uniq[rng.permutation(pick)]
    cuts = np.cumsum(rng.integers(1, 4097, n_packets // 64))
    cuts = np.unique(cuts[cuts < n_packets])
    return rows, np.split(rows, cuts)


def serve_trace(dev, n_packets: int, *, weight_bits: int = 16,
                kernel_variant: str = "int16", **server_kw):
    """Serve one seeded trace; returns (egress rows, seconds, recompiles
    before and after the mid-trace install, seconds spent inside the
    engine's dispatch call — host→device copy, launches, queued copy back)."""
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

    srv.engine.run_features = timed_dispatch
    ids = install_models(srv, rng)
    _, chunks = make_trace(rng, n_packets, ids)
    new_layers = [(rng.normal(size=(32, 32)).astype(np.float32) * 0.2,
                   np.zeros(32, np.float32)) for _ in range(4)]
    mid = len(chunks) // 2
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, chunk in enumerate(chunks):
        if i == mid:
            rc_before = srv.stats()["recompiles"]
            srv.install(ids[-1], new_layers, ["relu", "sigmoid", "leaky_relu"],
                        final_activation="hard_sigmoid")
        srv.submit_packets(chunk)
    out = srv.drain_packets()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rc_after = srv.stats()["recompiles"]
    bad = [o for o in out if not isinstance(o, np.ndarray)]
    if bad:
        raise SystemExit(f"{len(bad)} error slots, first: {bad[0]}")
    return np.stack(out), dt, rc_before, rc_after, engine_s[0]


def run_path(dev, n_packets: int, variant: str, card: str, **kw) -> dict:
    """The card's run against the CPU port's on the same trace."""
    wb = 8 if variant == "int8" else 16
    ref_rows, ref_dt, _, _, _ = serve_trace(torch.device("cpu"), n_packets,
                                            weight_bits=wb,
                                            kernel_variant=variant, **kw)
    fmlp.reset_launches()
    rows, dt, rc0, rc1, eng_s = serve_trace(dev, n_packets, weight_bits=wb,
                                            kernel_variant=variant, **kw)
    launches = dict(fmlp.launches)
    same = rows.shape == ref_rows.shape and np.array_equal(rows, ref_rows)
    log(f"serve {variant}: {n_packets} packets, egress "
        f"{'byte-identical' if same else 'DIFFERS'} to the CPU port; "
        f"launches {launches}; recompiles {rc0} -> {rc1}; "
        f"{n_packets / dt:.0f} packets/s on {dev} ({dt:.3f} s, of which "
        f"{eng_s:.3f} s inside engine.run_features); "
        f"{n_packets / ref_dt:.0f} packets/s with the port on the host CPU "
        f"[{card}]")
    if not same:
        diff = np.nonzero((rows != ref_rows).any(1))[0]
        raise SystemExit(f"{variant} egress differs at {diff.size} rows, "
                         f"first {diff[:5].tolist()}")
    if launches[variant] == 0:
        raise SystemExit(f"fixedpoint_mlp {variant} never launched on the "
                         "serving path")
    if rc0 != rc1:
        raise SystemExit(f"install changed the serving configurations: "
                         f"{rc0} -> {rc1}")
    return dict(launches=launches[variant], packets_per_s=n_packets / dt,
                seconds=dt, engine_s=eng_s)


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

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(["fixedpoint_mlp"])
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

    # -- 4. the serving path --------------------------------------------------
    path = {"int16": run_path(dev, 200_000, "int16", smi),
            "int8": run_path(dev, 50_000, "int8", smi)}

    # -- 5. numbers -----------------------------------------------------------
    rng = np.random.default_rng(SEED + 2)
    kernels = []
    for variant in ("int16", "int8"):
        case = make_case(rng, dev, n_batch=2048, n_models=16, n_layers=4,
                         width=32, variant=variant)
        kw = kernel_kw(3)
        lane = 8 if variant == "int8" else None
        k_ms = cuda_ms(lambda: fmlp.fixedpoint_mlp(**case, **kw,
                                                   variant=variant))
        p_ms = cuda_ms(lambda: fused_mlp_gather_ref(**case, **kw,
                                                    lane_bits=lane))
        b_ms, b_by = bound(case, variant)
        kernels.append(dict(KERNELS[variant],
                            launches=path[variant]["launches"],
                            max_abs_err=worst[variant], ms=k_ms,
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None))
        p = path[variant]
        kernel_share = p["launches"] * k_ms * 1e-3 / p["seconds"]
        log(f"time {variant} B=2048 M=16 L=4 W=32: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
            f"path {p['packets_per_s']:.0f} packets/s, engine call share "
            f"{p['engine_s'] / p['seconds']:.4f}, kernel share "
            f"{kernel_share:.5f} of the path's wall time [{smi}]")
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
