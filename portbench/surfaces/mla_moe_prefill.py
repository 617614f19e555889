"""The MLA + MoE prefill surface: one cell of document prefill through the
port's normal path, ``build_model(cfg).prefill``, on a DeepSeek-V2 stage
whose bf16 weights are drawn from the seed on the device.

Set-up draws the weights one projection or one expert at a time (one
generator per layer), so that no layer's float32 expert stack exists, and
keeps them in bf16 (norm scales in float32) in the port's tree: the
leading dense layers under ``dense_blocks``, the MoE layers stacked under
``blocks``.  It draws a pool of token batches and runs the mix's warm-up
calls.  The window is a closed loop of prefill calls on the pool's
batches, back to back under ``torch.no_grad()``, closed by a
synchronisation.

After it, one window call drawn from the seed runs once more with its
intermediate values copied to the host (``Capture``, a recording of the
program's ``repro_torch.models.taps``); its logits must equal the window
call's bit for bit.  The program's weights are freed, every layer's
weights are drawn again from its own seed (float32 tensors holding the
values the program held), and the plain reference
(``reference/mla_moe.py``) runs layer by layer on the program's own
inputs to each piece: each layer's MLA, its FFN (the MoE or the dense
MLP on the second norm's output) and its glue (the norms and the
residual adds), and the head on the final hidden state.  Each is a
relative L2 error over every token of the call (the head's per prompt);
the FFN's is also taken token by token, so that one routed slot left out
(a sixth of its token's routed output) fails the call.  Besides: the
tapped values join up exactly, from the embedding's rows to the head,
and every window prompt's logits are finite.  The dropless path drops
no slot by construction; the FFN checks are what would see one lost.

The logits of a reference run free from the embedding are not compared:
through eight layers of random weights they are chaotic (a bf16
rounding moves a near-tied routing choice or an attention weight, and
the change grows layer by layer).  Each piece on its own inputs sees one
step's arithmetic, where the same routing follows from the same inputs,
and holds the stated precision.

A configuration holds the ``config.json`` keys as run at its top level
(the port's registered ``arch`` must equal its ``published`` block), the
weight draw (``weights``) and the comparison's ``tolerance``.  The run's
``server_override`` replaces sizes (a smaller model on the CPU), may set
the ``dtype`` of the weights and activations (``"float32"`` holds the
program to the reference's arithmetic) and may hold a ``control``:
``"fp8_experts"`` rounds every routed expert's weights to
``float8_e4m3fn`` with a per-expert absmax scale, ``"fp8_head"`` the head
with one scale, and ``"w8a8_dense"`` puts every dense projection on the
program's W8A8 path (``quantize_tree``, the router and the expert stacks
skipped), and ``"fp8_norms"`` rounds each block's two norm scales
(``ln1``, ``ln2``) to ``float8_e4m3fn`` with one absmax scale each.

A ``--trace 1`` run records host activity as well as the device's, so
that the program's profiler ranges (``mla.*``, ``moe.*``) are in the
trace; each kernel is given to the range its launch call lies in, by the
trace's correlation ids.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import traceback

import numpy as np

from portbench import bench, deploy, traffic
from portbench.surfaces.lm_prefill import seeds, sync

ROWS = "tokens"
# config.json key -> the port's ModelConfig field
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff",
               "moe_intermediate_size": "moe_d_ff",
               "n_routed_experts": "n_experts",
               "num_experts_per_tok": "top_k",
               "n_shared_experts": "n_shared_experts",
               "vocab_size": "vocab_size", "rope_theta": "rope_theta",
               "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "hidden_act": "activation", "q_lora_rank": "q_lora_rank",
               "kv_lora_rank": "kv_lora_rank",
               "qk_nope_head_dim": "qk_nope_dim",
               "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "v_head_dim",
               "first_k_dense_replace": "first_k_dense_replace",
               "n_group": "n_group", "topk_group": "topk_group",
               "routed_scaling_factor": "routed_scaling_factor",
               "norm_topk_prob": "norm_topk_prob"}
# config.json keys the port has no field for: the values it implements
FIXED = {"attention_bias": False, "moe_layer_freq": 1,
         "scoring_func": "softmax", "topk_method": "group_limited_greedy"}
RANGES = ("mla.project", "mla.attend", "moe.route", "moe.dispatch",
          "moe.experts", "moe.combine", "moe.shared")
CONTROLS = ("fp8_experts", "fp8_head", "w8a8_dense", "fp8_norms")


def run_sizes(cfg_file: dict) -> dict:
    """The ``config.json`` keys as the cell runs them (the file's top
    level, under the names of its ``published`` block)."""
    return {k: cfg_file[k] for k in cfg_file["published"]}


def port_config(arch: str, sizes: dict):
    """The port's registered configuration of ``arch`` with ``sizes``
    (``config.json`` keys) applied; refuses keys whose published meaning
    the port does not implement."""
    from repro_torch.configs import get_config

    for k, v in FIXED.items():
        if sizes.get(k, v) != v:
            raise ValueError(f"{k}={sizes[k]!r}: the port implements {v!r}")
    if sizes["num_key_value_heads"] != sizes["num_attention_heads"]:
        raise ValueError("MLA has one key head per query head")
    kw = {PORT_FIELDS[k]: v for k, v in sizes.items() if k in PORT_FIELDS}
    kw["head_dim"] = sizes["qk_nope_head_dim"] + sizes["qk_rope_head_dim"]
    kw["rope_scaling"] = tuple(sorted(sizes["rope_scaling"].items()))
    return dataclasses.replace(get_config(arch), **kw)


def check_registered(cfg_file: dict) -> None:
    """The port's registered configuration is the published one."""
    from repro_torch.configs import get_config

    have = get_config(cfg_file["arch"])
    want = port_config(cfg_file["arch"], cfg_file["published"])
    differ = {f.name: (getattr(have, f.name), getattr(want, f.name))
              for f in dataclasses.fields(have)
              if getattr(have, f.name) != getattr(want, f.name)}
    if differ:
        raise ValueError(f"{cfg_file['arch']}: the port's configuration "
                         f"differs from the published one: {differ}")


def layer_plan(sizes: dict, i: int) -> list:
    """Layer ``i``'s leaves in draw order: (path, shape, kind), kind
    ``proj`` (N(0, 1/fan_in), the router included), ``scale`` (a norm scale) or ``experts``
    (E stacked projections, drawn one expert at a time)."""
    d, h = sizes["hidden_size"], sizes["num_attention_heads"]
    dn, dr = sizes["qk_nope_head_dim"], sizes["qk_rope_head_dim"]
    dv, lq = sizes["v_head_dim"], sizes["q_lora_rank"]
    lkv = sizes["kv_lora_rank"]
    plan = [(("ln1", "scale"), (d,), "scale"),
            (("ln2", "scale"), (d,), "scale"),
            (("attn", "wq_a", "w"), (d, lq), "proj"),
            (("attn", "q_norm", "scale"), (lq,), "scale"),
            (("attn", "wq_b", "w"), (lq, h * (dn + dr)), "proj"),
            (("attn", "wkv_a", "w"), (d, lkv + dr), "proj"),
            (("attn", "kv_norm", "scale"), (lkv,), "scale"),
            (("attn", "wk_b", "w"), (lkv, h * dn), "proj"),
            (("attn", "wv_b", "w"), (lkv, h * dv), "proj"),
            (("attn", "wo", "w"), (h * dv, d), "proj")]
    if i < sizes["first_k_dense_replace"]:
        f = sizes["intermediate_size"]
        return plan + [(("mlp", "gate", "w"), (d, f), "proj"),
                       (("mlp", "up", "w"), (d, f), "proj"),
                       (("mlp", "down", "w"), (f, d), "proj")]
    e, fe = sizes["n_routed_experts"], sizes["moe_intermediate_size"]
    fs = fe * sizes["n_shared_experts"]
    return plan + [(("moe", "router", "w"), (d, e), "proj"),
                   (("moe", "w_gate"), (e, d, fe), "experts"),
                   (("moe", "w_up"), (e, d, fe), "experts"),
                   (("moe", "w_down"), (e, fe, d), "experts"),
                   (("moe", "shared", "gate", "w"), (d, fs), "proj"),
                   (("moe", "shared", "up", "w"), (d, fs), "proj"),
                   (("moe", "shared", "down", "w"), (fs, d), "proj")]


def draw_layer(sizes: dict, draw: dict, i: int, seed: int, device, emit
               ) -> None:
    """Layer ``i``'s float32 weights from its own ``seed``, in
    :func:`layer_plan` order: ``emit(path, tensor, expert)`` for each
    leaf, or for each expert of a stacked leaf (``expert`` its index,
    else None)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    for path, shape, kind in layer_plan(sizes, i):
        if kind == "scale":
            t = torch.randn(shape, generator=gen, device=device)
            emit(path, t.mul_(draw["norm_scale_std"]).add_(1.0), None)
        elif kind == "proj":
            t = torch.randn(shape, generator=gen, device=device)
            emit(path, t.mul_(1.0 / math.sqrt(shape[0])), None)
        else:
            for e in range(shape[0]):
                t = torch.randn(shape[1:], generator=gen, device=device)
                emit(path, t.mul_(1.0 / math.sqrt(shape[1])), e)


def fp8_rounded(w):
    """``w`` rounded to ``float8_e4m3fn`` with one absmax scale, back in
    ``w``'s dtype (controls ``fp8_experts``, ``fp8_head``,
    ``fp8_norms``)."""
    import torch

    scale = w.abs().amax().to(torch.float32).clamp_min(1e-12) / 448.0
    q = (w.to(torch.float32) / scale).to(torch.float8_e4m3fn)
    return (q.to(torch.float32) * scale).to(w.dtype)


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def program_weights(sizes: dict, draw: dict, layer_seeds: list, g_embed,
                    g_head, device, control=None, dtype=None) -> dict:
    """The port's parameter tree in ``dtype`` (default bf16; norm scales
    float32), each stacked leaf allocated once and filled layer by layer,
    expert by expert."""
    import torch

    bf16, f32 = dtype or torch.bfloat16, torch.float32
    n, k = sizes["num_hidden_layers"], sizes["first_k_dense_replace"]
    params = {"embed": embedding(sizes, draw, g_embed, device).to(bf16),
              "final_norm": {"scale": torch.ones(
                  sizes["hidden_size"], device=device)},
              "head": head(sizes, g_head, device).to(bf16)}
    if control == "fp8_head":
        params["head"] = fp8_rounded(params["head"])
    for key, layers in (("dense_blocks", range(k)), ("blocks", range(k, n))):
        if not len(layers):
            continue
        tree: dict = {}
        for path, shape, kind in layer_plan(sizes, layers[0]):
            _set(tree, path, torch.empty(
                (len(layers), *shape), device=device,
                dtype=f32 if kind == "scale" else bf16))
        params[key] = tree
        for j, i in enumerate(layers):
            def emit(path, t, e, j=j):
                leaf = _get(tree, path)
                if control == "fp8_norms" and path[0] in ("ln1", "ln2"):
                    leaf[j].copy_(fp8_rounded(t))
                elif e is None:
                    leaf[j].copy_(t)
                else:
                    leaf[j, e].copy_(fp8_rounded(t) if control ==
                                     "fp8_experts" else t)
            draw_layer(sizes, draw, i, layer_seeds[i], device, emit)
    if control == "w8a8_dense":
        from repro_torch.core.quantize import quantize_tree
        params = quantize_tree(params, skip=lambda p: (
            "['router']" in p or p.endswith(("['w_gate']", "['w_up']",
                                             "['w_down']"))))
    elif control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    return params


def embedding(sizes: dict, draw: dict, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((sizes["vocab_size"], sizes["hidden_size"]),
                       generator=gen, device=device).mul_(draw["embed_std"])


def head(sizes: dict, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    d = sizes["hidden_size"]
    return torch.randn((d, sizes["vocab_size"]), generator=gen,
                       device=device).mul_(1.0 / math.sqrt(d))


def reference_layer(sizes: dict, draw: dict, layer_seeds: list, device,
                    dtype=None):
    """``layer(i)`` for the reference: layer ``i``'s weights drawn again
    from its seed, the expert stacks filled expert by expert, as float32
    tensors holding the values the program holds (each projection rounded
    through ``dtype``, bf16 by default; norm scales as drawn)."""
    import torch

    dtype = dtype or torch.bfloat16

    def layer(i):
        out: dict = {}

        def emit(path, t, e):
            if path[-1] != "scale":
                t = t.to(dtype).to(torch.float32)
            if e is None:
                _set(out, path, t)
                return
            if e == 0:
                shape = [s for p, s, _ in layer_plan(sizes, i) if p == path]
                _set(out, path, torch.empty(shape[0], device=device))
            _get(out, path)[e].copy_(t)
        draw_layer(sizes, draw, i, layer_seeds[i], device, emit)
        return out
    return layer


class Capture:
    """One prefill's intermediate values, copied to the host as the program
    hands them to its taps (``repro_torch.models.taps``): the embedding's
    rows, every block's ``(x, h1, attn, h2, ffn, y)``, and the head's
    input and logits.  Use as the recording's callback."""

    def __init__(self):
        self.sites = {"embed": [], "block": [], "head": []}

    def __call__(self, site, tensors) -> None:
        self.sites[site].append(tuple(t.cpu() for t in tensors))

    @property
    def blocks(self) -> list:
        return self.sites["block"]

    def chain_breaks(self, emb_rows, n_layers: int) -> int:
        """Places where the tapped values do not join up exactly: the
        embedding's rows, each block's input against the last one's
        output, the head's input against the last block's output at the
        last position, and the number of each tap."""
        import torch

        def differ(a, b):
            return int(a.shape != b.shape or not torch.equal(a, b))
        counts = tuple(len(v) for v in self.sites.values())
        if counts != (1, n_layers, 1):
            return 1 + abs(counts[1] - n_layers)
        x0 = self.sites["embed"][0][0]
        ins = [blk[0] for blk in self.blocks]
        outs = [blk[-1] for blk in self.blocks]
        return (differ(x0, emb_rows.to(x0.dtype).cpu())
                + sum(differ(a, b) for a, b in zip(ins, [x0] + outs[:-1]))
                + differ(self.sites["head"][0][0], outs[-1][:, -1:]))


def _rel(got, want) -> float:
    """||got - want|| / ||want|| over every entry (float64)."""
    g = got.reshape(-1).to(want.device, dtype=want.dtype)
    w = want.reshape(-1)
    return float((g.double() - w.double()).norm()
                 / w.double().norm().clamp_min(1e-30))


def _rel_rows(got, want) -> float:
    """The largest ||got_t - want_t|| / ||want_t|| over the tokens t (the
    last axis is a token's row)."""
    d = want.shape[-1]
    g = got.reshape(-1, d).to(want.device).double()
    w = want.reshape(-1, d).double()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def reference_pass(ref, layer, final_norm, head, sizes: dict,
                   cap: Capture) -> dict:
    """The reference, layer by layer on each layer's weights, on each
    piece of the program's call with the program's own inputs to it
    (``cap``).  Per layer, the relative L2 error over every token of the
    program's MLA output (on the first norm's output), of its FFN output
    (the MoE or the dense MLP on the second norm's output), the largest
    of the FFN's per token, and of its glue (each norm's output against
    the norm of the block's input and of the residual after attention,
    and the block's output less its input against both sublayers).  And
    the head on the program's last hidden state: its logits per
    prompt."""
    import torch

    ref.plain_precision()
    dev = final_norm.device
    f32 = torch.float32
    eps = sizes["rms_norm_eps"]
    mla_err, ffn_err, ffn_tok, glue_err = [], [], [], []
    for i in range(sizes["num_hidden_layers"]):
        p = layer(i)
        xin, h, a, h2, f, y = (t.to(dev, f32) for t in cap.blocks[i])
        mla_err.append(_rel(a, ref.mla(h, p["attn"], sizes)))
        want = (ref.moe(h2, p, sizes) if "moe" in p
                else ref.swiglu(h2, p["mlp"]))
        ffn_err.append(_rel(f, want))
        ffn_tok.append(_rel_rows(f, want))
        glue_err.append(max(
            _rel(h, ref.rms_norm(xin, p["ln1"]["scale"], eps)),
            _rel(h2, ref.rms_norm(xin + a, p["ln2"]["scale"], eps)),
            _rel(y - xin, a + f)))
        del p, xin, h, a, h2, f, y, want
    hx = cap.sites["head"][0][0].to(dev, f32)
    return dict(logits=ref.final_logits(hx, final_norm, head, sizes),
                mla=mla_err, ffn=ffn_err, ffn_token=ffn_tok, glue=glue_err)


def range_device_s(prof, names=RANGES) -> tuple:
    """Device seconds of the kernels launched inside each of the program's
    profiler ranges ``names``, and how many of each range the trace
    holds.  A kernel belongs to the range its launch (the ``cu*`` API
    call of the same correlation id) lies in; the named ranges do not
    nest, so the last one to start before the launch is its range."""
    from torch.autograd import DeviceType

    spans, launch, kernels = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in names:     # a range drawn on the device
                kernels.append((e.correlation_id(), e.start_ns(),
                                e.end_ns()))
        elif e.name() in names:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.correlation_id() and e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    spans.sort()
    starts = np.asarray([s[0] for s in spans], np.int64)
    seconds = dict.fromkeys(names, 0.0)
    for corr, s, e in kernels:
        t = launch.get(corr)
        if t is None or not spans:
            continue
        i = int(np.searchsorted(starts, t, "right")) - 1
        if i >= 0 and t <= spans[i][1]:
            seconds[spans[i][2]] += (e - s) * 1e-9
    counts = {n: sum(1 for s in spans if s[2] == n) for n in names}
    return seconds, counts


def host_and_device_trace():
    """The harness's device trace with host activity recorded too, so that
    the program's profiler ranges are in it.  The profiler also draws
    each range on the device's timeline; those spans are not device work
    and are left out of the device's events."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.profile import DeviceTrace

    class HostDeviceTrace(DeviceTrace):
        def __init__(self):
            super().__init__()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])

        def device_events(self):
            return [e for e in super().device_events() if e[0] not in RANGES]

    return HostDeviceTrace()


def run(workload: dict, spec: dict, *, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t_start: float = None,
        marks=None, mix_override=None, server_override=None) -> dict:
    """Run one MLA + MoE prefill cell and return the result object."""
    import torch

    from portbench.reference import mla_moe as ref
    from repro_torch.models import build_model, taps
    from repro_torch.models.layers import moe_stats

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
    dtype = over.pop("dtype", None)
    if control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    check_registered(cfg_file)
    sizes = dict(run_sizes(cfg_file), **over)
    cfg = port_config(cfg_file["arch"], sizes)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    draw = cfg_file["weights"]
    b, s = int(mix["batch"]), int(mix["seq"])
    n_layers = sizes["num_hidden_layers"]
    g_tok, g_pick, g_embed, g_head, *layer_seeds = seeds(seed, 4 + n_layers)
    dev = torch.device(device)
    model = build_model(cfg, device=device)
    params = program_weights(sizes, draw, layer_seeds, g_embed, g_head, dev,
                             control, dtype and getattr(torch, dtype))
    gen = torch.Generator(device=dev).manual_seed(g_tok)
    pool = torch.randint(0, sizes["vocab_size"], (int(mix["pool_batches"]),
                         b, s), generator=gen, device=dev)
    sync(device)
    t.append(clock())
    prefill = model.prefill
    spans = dev_trace = None
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
            if device != "cpu":
                dev_trace = host_and_device_trace()
        moe_stats.reset()
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
                outs.append(prefill(params, tokens=pool[k % pool.shape[0]]))
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
    phases = dict(zip(("weights_s", "warmup_s"), np.diff(t).tolist()))
    window_s = t1 - t0
    calls = len(outs)
    ok_calls = calls - raised
    moe = dict(tokens=moe_stats.tokens, slots=moe_stats.slots,
               layer_calls=moe_stats.layer_calls)
    device_info = bench.device_block(device)

    # every window prompt finite; the sampled calls' logits kept
    finite = [torch.zeros(b, dtype=torch.bool) if o is None else
              torch.isfinite(o.reshape(b, -1)).all(-1).cpu() for o in outs]
    nonfinite = int((~torch.cat(finite)).sum())
    pick = int(np.random.default_rng(g_pick).integers(calls))
    got = None if outs[pick] is None else \
        outs[pick].reshape(b, -1).to(torch.float32)
    tokens = pool[pick % pool.shape[0]]
    # the sampled call once more, its intermediate values kept: a call
    # repeats bit for bit, so they are the window call's
    t_rep = clock()
    cap = Capture()
    with torch.no_grad(), taps.recording(cap):
        again = model.prefill(params, tokens=tokens)
    replay_mismatch = int(got is None or not torch.equal(
        again.reshape(b, -1).to(torch.float32), got))
    del outs, params, pool, model, again
    if device != "cpu":
        torch.cuda.empty_cache()

    t_ref = clock()
    w_dtype = getattr(torch, dtype) if dtype else torch.bfloat16
    emb_rows = embedding(sizes, draw, g_embed, dev)[tokens.long()].to(
        w_dtype)
    breaks = cap.chain_breaks(emb_rows, n_layers)
    tol = cfg_file["tolerance"]
    if breaks:
        r = dict(logits=None, mla=[math.inf], ffn=[math.inf],
                 ffn_token=[math.inf], glue=[math.inf])
    else:
        r = reference_pass(
            ref, reference_layer(sizes, draw, layer_seeds, dev, w_dtype),
            torch.ones(sizes["hidden_size"], device=dev),
            head(sizes, g_head, dev).to(w_dtype), sizes, cap)
    del emb_rows, cap

    if got is None or r["logits"] is None:
        rel = torch.full((b,), math.inf, dtype=torch.float64)
    else:
        rel = torch.nan_to_num(ref.rel_l2(got, r["logits"]).cpu(),
                               nan=math.inf)
    lim = float(tol["logit_rel_l2"])
    checks = dict(
        logit_rel_l2_max=dict(value=float(rel.max()), limit=lim),
        logit_rows_over_tol=dict(value=int((rel > lim).sum()), limit=0),
        mla_rel_l2_max=dict(value=max(r["mla"]),
                            limit=float(tol["mla_rel_l2"])),
        ffn_rel_l2_max=dict(value=max(r["ffn"]),
                            limit=float(tol["ffn_rel_l2"])),
        ffn_token_rel_l2_max=dict(value=max(r["ffn_token"]),
                                  limit=float(tol["ffn_token_rel_l2"])),
        glue_rel_l2_max=dict(value=max(r["glue"]),
                             limit=float(tol["glue_rel_l2"])),
        chain_breaks=dict(value=breaks, limit=0),
        nonfinite_logits=dict(value=nonfinite, limit=0),
        replay_mismatch=dict(value=replay_mismatch, limit=0))
    ref_s = clock() - t_ref

    result = dict(correct=all(v["value"] <= v["limit"]
                              for v in checks.values()),
                  attempted=calls * b, failed=raised * b + nonfinite)
    metrics, breakdown, ranges = {}, None, None
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
        summary = range_s = None
        if dev_trace is not None:
            from portbench.profile import summarize
            summary = summarize(dev_trace, spans.items, {})
            range_s, counted = range_device_s(dev_trace.prof)
            if counted["moe.experts"] != moe["layer_calls"]:
                raise RuntimeError(
                    f"moe.experts ranges in the trace differ from the MoE "
                    f"layer counter: {counted['moe.experts']} ranges, "
                    f"{moe['layer_calls']} layer calls")
            ranges = dict(device_s=range_s, counts=counted)
            device_info.update(busy_s=summary["busy_s"],
                               window_s=summary["window_s"])
            breakdown = dict(device_ops=[[n[:120], v] for n, v in
                                         summary["device_ops"]],
                             idle_gaps=summary["idle_gaps"])
        rec = bench.Record(window_s=window_s, trace=summary, calls=ok_calls,
                           batch=b, seq=s, sizes=sizes, ranges=range_s,
                           moe=moe)
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
        tokens_per_call=b * s, moe=moe, ranges=ranges,
        calls_per_second=per_s.tolist(), sampled_call=pick,
        logit_rel_l2=rel.tolist(), mla_rel_l2=r["mla"], ffn_rel_l2=r["ffn"],
        ffn_token_rel_l2=r["ffn_token"], glue_rel_l2=r["glue"],
        replay_s=t_ref - t_rep, reference_s=ref_s,
        setup_phases=dict(before_run_s=t[0] - t_start, **(marks or {}),
                          **phases))
    result["checks"] = checks
    print(f"{name}: {calls} calls, moe {moe}", file=sys.stderr)
    return result
