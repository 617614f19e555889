"""Time the port's flow-update, fixed-point MLP and forest kernels against
those of another checkout of the port (the parent commit, say), in turns on
one NVIDIA GPU.

    git archive <commit> | tar -x -C parent_tree     # a directory .gitignore lists
    python3 benchmarks/pt_kernel_ab.py --other parent_tree \
        [--out kernel_ab.json]

The other checkout's ``repro_torch`` is imported under another name, so its
kernels build from its own sources into its own ``build/kernels/``.  Every
case runs both sides on the same card tensors, and their outputs must be
equal (``torch.equal``), else the script exits 1.  Each side is timed per
call (CUDA events around 20 wrapper calls, median of 21 windows; what the
path pays, host work included) and queued (the same calls behind a
device-side sleep, so the events see the device alone), in the order other,
this, this, other; the mean of each side's two readings is reported.

The cases are the serving defaults: a flow batch of B = 2048 and of
B = 8192 packets of the 200k flow trace that ``chip_smoke.py`` serves
(8192 flows, the same seed), with its chains of packets per flow, and a
2048-packet batch of one flow; the MLP at B = 2048, M = 16, L = 4, W = 32 in
both weight lanes.  The flow wrapper reads its error word (a
synchronisation), so a queued flow call is the kernel's launch alone: for a
checkout whose flow module has ``launch``, that function (its one
allocation and its two device kernels); for one without it, its C entry
point on outputs made once (that design's wrapper also clones the register
file and the sketch, which this leaves out).  The forest kernels (range
table and pointer chase) run on ``chip_smoke.py``'s eight trained forests at
the serving extents (F = 8, T = 16, N = 64, depth 6, NI = 31, L = 32,
W = 32): B = 2048 with slots uniform over the forests, the same batch with
every packet on one forest, and B = 4099.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core.taylor import scaled_constants  # noqa: E402
from repro_torch.data.packets import (RAW_KEY_BYTES,  # noqa: E402
                                      parse_raw_headers, raw_trace)
from repro_torch.flow import FlowTable  # noqa: E402
from repro_torch.flow.frontend import FlowParams  # noqa: E402
from repro_torch.kernels import fixedpoint_mlp as this_mlp  # noqa: E402
from repro_torch.kernels import flow_update as this_flow  # noqa: E402
from repro_torch.kernels import forest_traversal as this_forest  # noqa: E402
from chip_smoke import train_forests, trained_tables  # noqa: E402

FRAC = 8
FLOW_KW = dict(frac=FRAC, ewma_shift=3, byte_shift=6, dur_shift=10)
KEY_WORDS = (RAW_KEY_BYTES + 7) // 8  # as the flow frontend packs keys


def load_other(root: Path):
    """The other checkout's flow, MLP and forest kernel modules."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"other_repro_torch.kernels.{m}")
                 for m in ("flow_update", "fixedpoint_mlp",
                           "forest_traversal"))


def cuda_ms(fn, reps: int = 21, inner: int = 20,
            sleep_cycles: int = 0) -> float:
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def queued_ms(fn) -> float:
    return cuda_ms(fn, reps=11, sleep_cycles=8_000_000)


def in_turns(calls: dict, timer) -> dict:
    """``calls`` = {"other": fn, "this": fn}, timed other, this, this,
    other; the mean of each side's two readings."""
    got = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        got[side].append(timer(calls[side]))
    return {side: sum(v) / 2 for side, v in got.items()}


def flow_batches(dev) -> dict:
    rng = np.random.default_rng(5)  # chip_smoke.py's flow trace
    trace = raw_trace(rng, 200_000, n_flows=8192,
                      model_ids=tuple(range(1, 17)) + (999,),
                      pattern="mixed")
    params = FlowParams(frac=FRAC)
    out = {}
    for label, (lo, hi) in (("flow trace B=2048", (100_000, 102_048)),
                            ("flow trace B=8192", (110_000, 118_192))):
        fields = parse_raw_headers(trace[lo:hi])
        table = FlowTable(KEY_WORDS, capacity_pow2=14)
        words, hashes = FlowTable.pack_keys(fields.key_bytes, KEY_WORDS)
        slots, _ = table.lookup_or_insert(words, hashes, fields.ts)
        state = np.zeros((1 << 14, 8), np.int32)
        state[: 8192] = rng.integers(0, 5000, (8192, 8))
        state[: 8192, 0] = rng.integers(0, 5, 8192)
        cms = rng.integers(0, 100, (2, 4096)).astype(np.int32)
        out[label] = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
                      for a in (state, cms, slots.astype(np.int32),
                                params.cms_cells(hashes), fields.ts,
                                fields.length,
                                np.ones(slots.shape[0], np.int32))]
    one = list(out["flow trace B=2048"])
    one[2] = torch.full_like(one[2], int(one[2][0]))
    out["flow one_flow B=2048"] = one
    return out


def flow_queued_call(mod, args):
    """One launch of ``mod``'s flow kernel without reading its error word."""
    if hasattr(mod, "launch"):
        return lambda: mod.launch(*args, **FLOW_KW)
    state, cms, slots = args[:3]
    n, (depth, width_c) = slots.shape[0], cms.shape
    outs = (torch.empty_like(state), torch.empty_like(cms),
            torch.empty((n, 8), dtype=torch.int32, device=state.device),
            torch.zeros(1, dtype=torch.int32, device=state.device))
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    lib = mod.load_library()
    stream = torch.cuda.current_stream(state.device).cuda_stream

    def call():
        rc = lib.flow_update_launch(
            *ptrs, n, state.shape[0], depth, width_c, FLOW_KW["frac"],
            FLOW_KW["ewma_shift"], FLOW_KW["byte_shift"],
            FLOW_KW["dur_shift"], stream)
        if rc != 0:
            raise SystemExit(f"flow_update launch failed: CUDA error {rc}")
    return call


def mlp_case(dev, variant: str) -> dict:
    rng = np.random.default_rng(2)
    w_dtype = np.int8 if variant == "int8" else np.int16
    info = np.iinfo(w_dtype)
    m, l, w, b = 16, 4, 32, 2048
    arrays = dict(
        x_q=rng.integers(-2 ** 14, 2 ** 14, (b, w)).astype(np.int32),
        slot=rng.integers(0, m, b).astype(np.int32),
        w=rng.integers(info.min, info.max, (m, l, w, w),
                       endpoint=True).astype(w_dtype),
        b=rng.integers(-2 ** 31, 2 ** 31 - 1, (m, l, w),
                       endpoint=True).astype(np.int32),
        act=rng.choice(np.asarray([0, 1, 2, 3, 4], np.int32), (m, l)),
        layer_on=(rng.random((m, l)) < 0.75).astype(np.int32))
    return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}


def forest_cases(dev) -> dict:
    """The trained forests' tables on the card and the batches to serve."""
    nodes, tree_on, mode, ranges = trained_tables(train_forests()[0])
    tables = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
              for a in (nodes, tree_on, mode, *ranges)]
    rng = np.random.default_rng(7)
    n_forests, width = nodes.shape[0], 32
    cases = {}
    for label, n_batch, one in (("B=2048 uniform", 2048, False),
                                ("B=2048 one forest", 2048, True),
                                ("B=4099 uniform", 4099, False)):
        x = np.round(rng.normal(size=(n_batch, width)) * (1 << FRAC))
        slot = (np.zeros(n_batch) if one
                else rng.integers(0, n_forests, n_batch))
        cases[label] = [torch.as_tensor(a.astype(np.int32), device=dev)
                        for a in (x, slot)] + tables
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout of the repository")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pt_kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    other_flow, other_mlp, other_forest = load_other(args.other.resolve())
    rows = []

    def record(label, calls, queued_calls, outs):
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        if not same:
            raise SystemExit(f"{label}: the two checkouts' outputs differ")
        per_call = in_turns(calls, cuda_ms)
        queued = in_turns(queued_calls, queued_ms)
        row = dict(case=label, other_ms=per_call["other"],
                   this_ms=per_call["this"], other_queued_ms=queued["other"],
                   this_queued_ms=queued["this"])
        rows.append(row)
        print(f"{label}: per call other {row['other_ms']:.4f} ms, this "
              f"{row['this_ms']:.4f} ms; queued other "
              f"{row['other_queued_ms']:.4f} ms, this "
              f"{row['this_queued_ms']:.4f} ms; outputs equal [{card}]",
              flush=True)

    for label, fargs in flow_batches(dev).items():
        outs = [mod.flow_update_kernel(*fargs, **FLOW_KW)
                for mod in (other_flow, this_flow)]
        record(label,
               {side: (lambda m=mod: m.flow_update_kernel(*fargs, **FLOW_KW))
                for side, mod in (("other", other_flow),
                                  ("this", this_flow))},
               {"other": flow_queued_call(other_flow, fargs),
                "this": flow_queued_call(this_flow, fargs)}, outs)

    kw = dict(frac=FRAC, leaky_alpha_q=3, sig_coeffs=tuple(
        int(c) for c in scaled_constants("sigmoid", 3, FRAC)))
    for variant in ("int16", "int8"):
        case = mlp_case(dev, variant)
        calls = {side: (lambda m=mod: m.fixedpoint_mlp(**case, **kw,
                                                       variant=variant))
                 for side, mod in (("other", other_mlp), ("this", this_mlp))}
        outs = [[calls["other"]()], [calls["this"]()]]
        record(f"mlp {variant} B=2048 M=16 L=4 W=32", calls, calls, outs)

    for label, (x, slot, nodes, tree_on, mode, *ranges) in forest_cases(
            dev).items():
        for variant in ("range", "chase"):
            calls = {
                side: (lambda m=mod: m.forest_range(
                    x, slot, *ranges, tree_on, mode, frac=FRAC))
                if variant == "range" else
                (lambda m=mod: m.forest_traverse(
                    x, slot, nodes, tree_on, mode, max_depth=6, frac=FRAC))
                for side, mod in (("other", other_forest),
                                  ("this", this_forest))}
            outs = [[calls["other"]()], [calls["this"]()]]
            record(f"forest {variant} {label} F=8 T=16 N=64 NI=31 L=32 W=32",
                   calls, calls, outs)

    result = {"card": card, "rows": rows}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
