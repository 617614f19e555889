"""The LM prefill surface: one cell of batch scoring through the port's
normal path, ``build_model(cfg).prefill`` on a weight tree that
``core.quantize.quantize_tree`` made from float weights drawn from the
seed.

Set-up draws the float weights on the device (one generator call a stacked
leaf), quantizes them through the program, draws a pool of token batches
and runs the mix's warm-up calls.  The window is a closed loop of prefill
calls on the pool's batches, back to back, closed by a synchronisation.
After it, the program's state is freed and the plain reference
(``reference/lm.py``) recomputes the last-position logits of the prompts
of ``sample_calls`` window calls drawn from the seed, from the same float
weights and tokens; every window prompt's logits are checked to be
finite.

A configuration names the port's architecture (``arch``), the published
``config.json`` sizes (``published``, which the reference reads and the
port's registered configuration must equal), the port's ``overrides``, the
weight draw (``weights``) and the comparison's ``tolerance``.  The run's
``server_override`` replaces published sizes (a smaller model for a test on
the CPU) and may hold ``control``: ``"int4"`` quantizes the weights to 4
bits through ``quantize_tree(bits=4)``, ``"lsb7"`` clears the lowest bit
of every 8-bit weight code.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import sys
import time
import traceback

import numpy as np

from portbench import bench, deploy, traffic

ROWS = "tokens"
GEMM = {"gemm": (("fixedpoint_matmul",), ("wgmma_gemm_kernel",), ())}
# published config.json key -> the port's ModelConfig field
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "hidden_act": "activation"}


def port_config(arch: str, sizes: dict, overrides: dict):
    """The port's registered configuration of ``arch`` with ``sizes``
    (published keys) and ``overrides`` applied."""
    from repro_torch.configs import get_config

    kw = {PORT_FIELDS[k]: v for k, v in sizes.items()}
    kw["head_dim"] = sizes["hidden_size"] // sizes["num_attention_heads"]
    return dataclasses.replace(get_config(arch), **kw, **overrides)


def check_registered(cfg_file: dict) -> None:
    """The port's registered configuration has the published sizes."""
    from repro_torch.configs import get_config

    have = get_config(cfg_file["arch"])
    want = port_config(cfg_file["arch"], cfg_file["published"], {})
    differ = {f.name: (getattr(have, f.name), getattr(want, f.name))
              for f in dataclasses.fields(have)
              if getattr(have, f.name) != getattr(want, f.name)}
    if differ:
        raise ValueError(f"{cfg_file['arch']}: the port's configuration "
                         f"differs from the published one: {differ}")


def seeds(seed: int, n: int) -> list:
    """``n`` independent 64-bit seeds for torch generators."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(
        n, np.uint64)]


def weights_tree(sizes: dict, draw: dict, gen, device) -> dict:
    """Float32 weights in the port's tree (layers stacked on a leading
    axis), one generator call a leaf: projections N(0, 1/fan_in), biases
    N(0, ``bias_std``), norm scales 1 + N(0, ``norm_scale_std``), the tied
    embedding N(0, ``embed_std``)."""
    import torch

    n, d = sizes["num_hidden_layers"], sizes["hidden_size"]
    f, v = sizes["intermediate_size"], sizes["vocab_size"]
    kv = sizes["num_key_value_heads"] * (d // sizes["num_attention_heads"])

    def randn(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(std).add_(mean)

    def w(din, dout):
        return {"w": randn(n, din, dout, std=1.0 / math.sqrt(din))}

    def wb(din, dout):
        return dict(w(din, dout), b=randn(n, dout, std=draw["bias_std"]))

    def scale(*shape):
        return {"scale": randn(*shape, std=draw["norm_scale_std"],
                               mean=1.0)}

    return {
        "embed": randn(v, d, std=draw["embed_std"]),
        "final_norm": scale(d),
        "blocks": {"ln1": scale(n, d), "ln2": scale(n, d),
                   "attn": {"wq": wb(d, d), "wk": wb(d, kv),
                            "wv": wb(d, kv), "wo": w(d, d)},
                   "mlp": {"gate": w(d, f), "up": w(d, f),
                           "down": w(f, d)}},
    }


def quantized(params: dict, control) -> dict:
    """The program's quantized tree, or a control's."""
    from repro_torch.core.quantize import quantize_tree

    if control == "int4":
        return quantize_tree(params, bits=4)
    q = quantize_tree(params)
    if control == "lsb7":
        def clear(node):
            if isinstance(node, dict):
                for x in node.values():
                    clear(x)
            elif isinstance(node, tuple):
                node[0].bitwise_and_(-2)
        clear(q)
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    return q


def gemm_launches() -> int:
    return importlib.import_module(
        "repro_torch.kernels.fixedpoint_matmul").launches["fixedpoint_matmul"]


def attention_device_s(trace, spans: list):
    """Device seconds of the kernels launched inside ``attention`` spans:
    each kernel is matched to its launch call by the trace's correlation
    id, and the launch's host time, put on the host clock by the marker's
    own launch, to the spans.  None where the trace has no launch calls."""
    from torch.autograd import DeviceType

    launch_ns, kernels = {}, []
    for e in trace.prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.correlation_id(), e.start_ns(), e.end_ns()))
        elif e.correlation_id():
            launch_ns[e.correlation_id()] = e.start_ns()
    kernels.sort(key=lambda r: r[1])
    if not kernels or kernels[0][0] not in launch_ns:
        print(f"attention_device_s: {len(launch_ns)} launch records, "
              f"{len(kernels)} kernels; none matched the marker",
              file=sys.stderr)
        return None
    offset = launch_ns[kernels[0][0]] - trace.t_mark
    iv = np.asarray([(a, b) for label, a, b in spans if label == "attention"],
                    np.int64).reshape(-1, 2) + offset
    iv = iv[np.argsort(iv[:, 0])]
    total = 0.0
    for corr, s, e in kernels[1:]:
        t = launch_ns.get(corr)
        if t is None:
            continue
        i = int(np.searchsorted(iv[:, 0], t, "right")) - 1
        if i >= 0 and t <= iv[i, 1]:
            total += (e - s) * 1e-9
    return total


def sync(device: str) -> None:
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def run(workload: dict, spec: dict, *, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t_start: float = None,
        marks=None, mix_override=None, server_override=None) -> dict:
    """Run one LM prefill cell and return the result object."""
    import torch

    import repro_torch.models.flash as flash
    from portbench.reference import lm as ref
    from repro_torch.models import build_model

    clock = time.perf_counter
    if t_start is None:
        t_start = clock()
    t = [clock()]
    name = workload["name"]
    cfg_file = deploy.load_config(workload["config"])
    mix = dict(traffic.load_traffic(workload["traffic"]),
               **(mix_override or {}))
    if mix["rows"] != ROWS:
        raise ValueError(f"{name}: mix rows {mix['rows']!r} do not fit "
                         f"surface {cfg_file['surface']!r}")
    over = dict(server_override or {})
    control = over.pop("control", None)
    check_registered(cfg_file)
    sizes = dict(cfg_file["published"], **over)
    cfg = port_config(cfg_file["arch"], sizes, cfg_file["overrides"])
    b, s = int(mix["batch"]), int(mix["seq"])
    g_w, g_tok, g_pick = seeds(seed, 3)
    dev = torch.device(device)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=dev).manual_seed(g_w)
    weights = weights_tree(sizes, cfg_file["weights"], gen, dev)
    t.append(clock())
    params = quantized(weights, control)
    gen.manual_seed(g_tok)
    pool = torch.randint(0, sizes["vocab_size"], (int(mix["pool_batches"]),
                         b, s), generator=gen, device=dev)
    t.append(clock())
    prefill = model.prefill
    spans = dev_trace = None
    attend = flash.flash_attention
    # served calls build no autograd graph
    with torch.no_grad():
        for i in range(int(mix["warmup_calls"])):
            prefill(params, tokens=pool[i % pool.shape[0]])
        sync(device)
        t.append(clock())
        if trace:
            from portbench.profile import Spans
            spans = Spans()
            prefill = spans.wrap(prefill, "prefill")
            flash.flash_attention = spans.wrap(attend, "attention")
            if device != "cpu":
                from portbench.profile import DeviceTrace
                dev_trace = DeviceTrace()
        try:
            l0 = gemm_launches()
            sync(device)
            setup_s = clock() - t_start
            if dev_trace is not None:
                dev_trace.start()
            outs, raised, marks_t = [], 0, []
            t0 = clock()
            deadline = t0 + seconds
            while True:
                k = len(outs)
                try:
                    outs.append(prefill(params,
                                        tokens=pool[k % pool.shape[0]]))
                except RuntimeError:
                    traceback.print_exc()
                    outs.append(None)
                    raised += 1
                now = clock()
                marks_t.append(now - t0)
                if now >= deadline:
                    break
            sync(device)
            t1 = clock()
            if dev_trace is not None:
                dev_trace.stop()
        finally:
            flash.flash_attention = attend
    phases = dict(zip(("weights_s", "quantize_s", "warmup_s"),
                      np.diff(t).tolist()))
    window_s = t1 - t0
    launched = gemm_launches() - l0
    calls = len(outs)
    device_info = bench.device_block(device)

    # every window prompt finite; the sampled calls' logits kept
    finite = [torch.zeros(b, dtype=torch.bool) if o is None else
              torch.isfinite(o.reshape(b, -1)).all(-1).cpu() for o in outs]
    nonfinite = int((~torch.cat(finite)).sum())
    rng = np.random.default_rng(g_pick)
    n_pick = min(int(mix["sample_calls"]), calls)
    pick = np.sort(rng.choice(calls, n_pick, replace=False)).tolist()
    got = [None if outs[i] is None else
           outs[i].reshape(b, -1).to(torch.float32) for i in pick]
    tokens = torch.cat([pool[i % pool.shape[0]] for i in pick])
    del outs, params, pool, model
    if device != "cpu":
        torch.cuda.empty_cache()

    t_ref = clock()
    want = ref.last_logits(weights, tokens, sizes)
    tol = float(cfg_file["tolerance"]["logit_rel_l2"])
    rel = torch.cat([torch.full((b,), math.inf, dtype=torch.float64)
                     if g is None else ref.rel_l2(g, w).cpu()
                     for g, w in zip(got, want.split(b))])
    rel = torch.nan_to_num(rel, nan=math.inf)
    checks = dict(
        logit_rel_l2_max=dict(value=float(rel.max()), limit=tol),
        logit_rows_over_tol=dict(value=int((rel > tol).sum()), limit=0),
        nonfinite_logits=dict(value=nonfinite, limit=0))
    ref_s = clock() - t_ref

    ok_calls = calls - raised
    result = dict(correct=all(v["value"] <= v["limit"]
                              for v in checks.values()),
                  attempted=calls * b, failed=raised * b + nonfinite)
    metrics, breakdown = {}, None
    if not trace:
        values = dict(tokens_per_s=ok_calls * b * s / window_s,
                      setup_s=setup_s)
        for m in spec["end_to_end"]:
            if bench.applies(m, name):
                if m["name"] not in values:
                    raise KeyError(f"no measurement for {m['name']}")
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    else:
        summary = attention_s = None
        if dev_trace is not None:
            from portbench.profile import summarize
            summary = summarize(dev_trace, spans.items, GEMM)
            records = summary.get("per_kernel", {}).get("gemm", {}).get(
                "records", 0)
            if records != launched:
                raise RuntimeError(
                    f"device trace records of the GEMM differ from its "
                    f"launch counter: {records} records, {launched} launches")
            attention_s = attention_device_s(dev_trace, spans.items)
            device_info.update(busy_s=summary["busy_s"],
                               window_s=summary["window_s"])
            breakdown = dict(device_ops=[[n[:120], v] for n, v in
                                         summary["device_ops"]],
                             idle_gaps=summary["idle_gaps"])
        rec = bench.Record(window_s=window_s, trace=summary, calls=ok_calls,
                           batch=b, seq=s, sizes=sizes,
                           attention_s=attention_s)
        for m in spec["per_layer"]:
            if bench.applies(m, name):
                v = bench.load_reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    result.update(metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    per_s = np.bincount(np.asarray(marks_t, np.float64).astype(np.int64))
    result["client"] = dict(
        window_s=window_s, calls=calls, calls_raised=raised,
        tokens_per_call=b * s, gemm_launches=launched,
        gemm_launches_per_call=launched / max(ok_calls, 1),
        calls_per_second=per_s.tolist(), sampled_calls=pick,
        logit_rel_l2=rel.tolist(), reference_s=ref_s,
        setup_phases=dict(before_run_s=t[0] - t_start, **(marks or {}),
                          **phases))
    result["checks"] = checks
    return result
