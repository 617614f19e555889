"""Multi-pod dry run: trace every assigned (architecture × input-shape ×
mesh) cell on the meta device and extract the roofline terms.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell's jitted step for 256 (single pod) and 512 (multi-pod) placeholder
CPU devices.  The port proves the same distribution config coherent
without hardware by running the step once on DTensors of ``"meta"``
tensors over the ``"fake"`` process-group backend at the mesh's world size
(``launch.mesh.fake_world``): the sharding plan (``make_plan``) places the
parameters and optimizer state, ``logical_batch_sharding`` the batch and
``cache_specs`` the decode caches; a train cell runs ``adamw_step`` with
the config's ``accum_steps``, a prefill ``model.prefill``, a decode
``decode_step``.  ``distributed.cost.CostCounter`` counts the step's
per-rank flops, bytes, collectives and live-bytes peak, with loops folded
(one layer, one attention block pair, one microbatch traced and
multiplied by its trip count).  A layout error, an op no sharding rule
covers, or a shape mismatch is a bug.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/ --jobs 4
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..configs import SHAPES, cells, get_config
from ..configs.base import (ModelConfig, ShapeConfig, active_params,
                            param_count)
from ..core import tree as T
from ..distributed.constrain import activation_mesh, pins
from ..distributed.cost import CostCounter
from ..distributed.sharding import (batch_spec, cache_specs,
                                    logical_batch_sharding, make_plan,
                                    placements)
from ..models import build_model
from ..optim import AdamWConfig, adamw, adamw_step
from .mesh import HW, fake_world, make_mesh

__all__ = ["run_cell", "run_cells", "dry_run", "cell_config", "main"]


def cell_config(arch: str, shape_name: str, **overrides) -> ModelConfig:
    cfg = get_config(arch)
    if shape_name == "long_500k" and arch == "zamba2-2.7b":
        # hybrid long-context: shared attention block switches to the
        # Taylor-softmax linear form (sub-quadratic end to end)
        cfg = cfg.replace(attention_impl="taylor_linear")
    return cfg.replace(**overrides) if overrides else cfg


def _cast_for_serving(tree, cfg=None, dtype=torch.bfloat16):
    """Serving cells hold bf16 weights (training master stays f32); in
    ``w8a8_int`` mode the GEMM weights become control-plane int8 tables
    (codes + per-channel scales — the paper's fixed-point serving path)."""
    def leaf(x, dt):
        if x.dim() >= 2 and x.is_floating_point():
            return torch.empty(x.shape, dtype=dt, device="meta")
        return x
    tree = T.map_leaves(lambda x: leaf(x, dtype), tree)
    if cfg is not None and cfg.quant_mode == "w8a8_int":
        from ..core.quantize import quantize_tree
        # over float32 stand-ins of the same structure, as the reference
        tree = quantize_tree(T.map_leaves(
            lambda x: leaf(x, torch.float32), tree), bits=8)
    return tree


def _mesh_name(shape: Sequence[int]) -> str:
    return "pod" + "x".join(str(s) for s in shape)


def _distribute_batch(mesh, batch, global_batch, fallbacks):
    from torch.distributed.tensor import distribute_tensor
    pl = logical_batch_sharding(mesh, batch, global_batch, fallbacks)
    return T.map_leaves(lambda x, p: distribute_tensor(x, mesh, p), batch, pl)


def _storages(tree) -> Dict[int, int]:
    out = {}
    for leaf in T.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            local = getattr(leaf, "_local_tensor", leaf)
            st = local.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def dry_run(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: Tuple[int, ...],
            axes: Tuple[str, ...], *, fsdp_min: int = 1 << 20,
            fold_loops: bool = True) -> Dict[str, Any]:
    """One cell's record (the roofline inputs) for ``cfg`` × ``shape`` on a
    fake mesh of ``mesh_shape`` named ``axes``.  Runs in a process with no
    default process group (it makes and destroys a fake one)."""
    n_dev = math.prod(mesh_shape)
    fallbacks: list = []
    t0 = time.time()
    with fake_world(n_dev):
        mesh = make_mesh(mesh_shape, axes, device="meta")
        model = build_model(cfg, device="meta")
        params_abs = model.abstract_params()
        if shape.kind != "train":
            params_abs = _cast_for_serving(params_abs, cfg)
        plan = make_plan(params_abs, cfg, mesh, fsdp_min=fsdp_min)
        fallbacks += plan.fallbacks
        params = plan.distribute(params_abs)
        counter = CostCounter(fold_loops=fold_loops)
        from torch.distributed.tensor.experimental import implicit_replication
        with activation_mesh(mesh), implicit_replication():
            if shape.kind == "train":
                opt_cfg = AdamWConfig(state_bits=cfg.opt_state_bits)
                opt_abs = adamw.init(params_abs, opt_cfg)
                opt_plan = make_plan(opt_abs, cfg, mesh, fsdp_min=fsdp_min)
                fallbacks += opt_plan.fallbacks
                opt = opt_plan.distribute(opt_abs)
                batch = _distribute_batch(mesh, model.input_specs(shape),
                                          shape.global_batch, fallbacks)
                args = (params, opt, batch)
                arg_bytes = counter.track(args)
                with counter:
                    out = adamw_step(model.loss_fn, params, opt, batch,
                                     opt_cfg, accum_steps=cfg.accum_steps)
            elif shape.kind == "prefill":
                batch = _distribute_batch(mesh, model.input_specs(shape),
                                          shape.global_batch, fallbacks)
                args = (params, batch)
                arg_bytes = counter.track(args)
                with torch.no_grad(), counter:
                    out = model.prefill(params, **batch)
            else:  # decode
                from torch.distributed.tensor import distribute_tensor
                caches_abs = model.abstract_caches(shape.global_batch,
                                                   shape.seq_len)
                cplan = cache_specs(caches_abs, cfg, mesh,
                                    shape.global_batch, fallbacks)
                caches = cplan.distribute(caches_abs)
                inp = model.input_specs(shape)
                bspec = batch_spec(mesh, shape.global_batch, fallbacks)
                tokens = distribute_tensor(
                    inp["tokens"], mesh, placements(bspec + (None,), mesh))
                pos = distribute_tensor(inp["pos"], mesh,
                                        placements(bspec, mesh))
                args = (params, caches, tokens, pos)
                arg_bytes = counter.track(args)
                with torch.no_grad(), counter:
                    out = model.decode_step(params, caches, tokens, pos)
            pinned = pins()
        arg_st, out_st = _storages(args), _storages(out)
        output_bytes = sum(out_st.values())
        alias_bytes = sum(nb for k, nb in out_st.items() if k in arg_st)
    trace_s = time.time() - t0
    peak = counter.peak
    temp = max(0, peak - arg_bytes - (output_bytes - alias_bytes))
    cost = counter.result()
    flops, bytes_acc = float(cost.flops), float(cost.bytes)
    coll_total = float(cost.total_collective_bytes)

    # roofline terms (per-rank program → per-card seconds)
    compute_s = flops / HW.PEAK_BF16
    memory_s = bytes_acc / HW.HBM_BW
    collective_s = coll_total / HW.NET_BW

    n_params = param_count(cfg)
    n_active = active_params(cfg)
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.tokens / n_dev
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.tokens / n_dev
    else:
        model_flops = 2 * n_active * shape.global_batch / n_dev

    return {
        "shape": shape.name,
        "mesh": _mesh_name(mesh_shape),
        "n_devices": n_dev,
        "status": "ok",
        "trace_seconds": round(trace_s, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias_bytes,
            "peak_est_bytes": arg_bytes + temp + output_bytes - alias_bytes,
        },
        "cost": {"flops": flops, "bytes": bytes_acc},
        "collectives": dict(cost.collective_bytes),
        "collective_counts": dict(cost.collective_counts),
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "bottleneck": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)], key=lambda kv: kv[1])[0],
            "model_flops_per_dev": model_flops,
            "useful_flop_frac": model_flops / flops if flops else 0.0,
        },
        "params": {"total": n_params, "active": n_active},
        "fallbacks": fallbacks,
        "pins": pinned,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """Trace one production cell; return the dry-run record."""
    overrides = overrides or {}
    cfg = cell_config(arch, shape_name, **overrides)
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    rec = {"arch": arch, **dry_run(cfg, SHAPES[shape_name], mesh_shape,
                                   axes), "overrides": overrides}
    if verbose:
        mem, rl = rec["memory"], rec["roofline"]
        print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: OK "
              f"({rec['trace_seconds']:.0f}s trace)")
        print(f"  memory/device: args {mem['argument_bytes']/2**30:.2f} GiB "
              f"+ temps {mem['temp_bytes']/2**30:.2f} GiB")
        print(f"  cost: {rec['cost']['flops']/1e9:.1f} GFLOP, "
              f"{rec['cost']['bytes']/2**30:.2f} GiB accessed, collectives "
              f"{sum(rec['collectives'].values())/2**20:.1f} MiB "
              f"{rec['collective_counts']}")
        print(f"  roofline terms (s): compute {rl['compute_s']:.4f} | memory "
              f"{rl['memory_s']:.4f} | collective {rl['collective_s']:.4f} → "
              f"{rl['bottleneck']}-bound")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every assigned cell")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. kv_cache_bits=8)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced in parallel worker processes")
    args = ap.parse_args(argv)

    overrides: Dict[str, Any] = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        todo = [(a, s) for a, s, runnable, _ in cells() if runnable]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        todo = [(args.arch, args.shape)]

    jobs = []
    for arch, shape_name in todo:
        for mp in meshes:
            key = f"{arch}_{shape_name}_{'multi' if mp else 'single'}"
            path = os.path.join(args.out, key + ".json") if args.out else None
            if path and os.path.exists(path):
                print(f"[dryrun] {key}: cached")
                continue
            jobs.append((arch, shape_name, mp, overrides, path))

    t0 = time.time()
    results = run_cells(jobs, args.jobs)
    failures = sum(rec["status"] != "ok" for rec in results)
    print(f"[dryrun] done: {len(results) - failures}/{len(results)} cells OK "
          f"in {time.time() - t0:.1f} s")
    return 1 if failures else 0


def run_cells(jobs, n_jobs: int = 1) -> list:
    """The records of ``jobs`` — ``(arch, shape, multi_pod, overrides,
    path or None)`` each — in order, traced in ``n_jobs`` worker processes
    (each holds its own fake process group) or in this one."""
    if n_jobs <= 1:
        return [_run_job(job) for job in jobs]
    import concurrent.futures as cf
    import multiprocessing as mproc
    with cf.ProcessPoolExecutor(
            n_jobs, mp_context=mproc.get_context("spawn")) as ex:
        return list(ex.map(_run_job, jobs))


def _run_job(job) -> Dict[str, Any]:
    """One cell of :func:`main`'s sweep (in a worker process with
    ``--jobs``): its record, or a ``FAIL`` record with the error."""
    arch, shape_name, mp, overrides, path = job
    try:
        rec = run_cell(arch, shape_name, multi_pod=mp, overrides=overrides)
    except Exception as e:  # a failure here is a bug in the system
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "pod2x16x16" if mp else "pod16x16",
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "overrides": overrides}
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


if __name__ == "__main__":
    raise SystemExit(main())
