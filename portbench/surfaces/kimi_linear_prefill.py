"""The Kimi Linear prefill surface: one cell of document prefill through
the port's normal path, ``build_model(cfg).prefill``, on a
Kimi-Linear-48B-A3B stage whose bf16 weights are drawn from the seed on
the device.

Set-up draws the weights one leaf at a time (one generator per layer),
the expert stacks expert by expert, so that no layer's float32 expert
stack exists, and keeps them in the port's tree: projections, experts,
the conv, the embedding and the head in bf16; norm scales, ``a_log``,
``dt_bias`` and the router's selection bias in float32.  It draws a pool
of token batches and runs the mix's warm-up calls.  The window is a
closed loop of prefill calls on the pool's batches, back to back under
``torch.no_grad()``, closed by a synchronisation.

After it, one window call drawn from the seed runs once more with its
intermediate values copied to the host (``mla_moe_prefill.Capture``, a
recording of the program's ``repro_torch.models.taps``); its logits must
equal the window call's bit for bit.  The program's weights are freed and
every layer's weights drawn again from its own seed (float32 tensors
holding the values the program held).  Layer by layer, the plain
reference (``reference/kimi_linear.py``) runs each piece on the
program's own inputs to it: the mixer (KDA or MLA) on the first norm's
output, the FFN (the dense SwiGLU, or the MoE with its shared expert) on
the second's, also token by token, and the glue (the norms and the
residual adds); and the head on the last hidden state.  Each is a
relative L2 error over every token of the call (the head's per prompt).
Besides: the tapped values join up exactly, from the embedding's rows to
the head, and every window prompt's logits are finite.  In the same
loop the reference runs free from the embedding rows through every
layer; its last-position logits against the window call's are reported
(``free_logit_rel_l2``) and not compared: through 14 random layers a
bf16 rounding moves near-tied routing choices, and the change grows
layer by layer.

A configuration holds the ``config.json`` keys as run at its top level
(the port's registered ``arch`` must equal its ``published`` block), the
weight draw (``weights``) and the comparison's ``tolerance``.  The run's
``server_override`` replaces sizes (a smaller model on the CPU; the
``linear_attn_config`` block whole), may set the ``dtype`` of the weights
and activations (``"float32"`` holds the program to the reference's
arithmetic) and may hold a ``control``, a program made wrong on purpose:
``"kda_state_bf16"`` runs KDA's chunk form (state, chunk sums, decays)
in bf16; ``"no_delta"`` drops the delta rule's correction (``S += β k
vᵀ``: the pseudo-values are ``β v``); ``"head_decay"`` gives each head
one decay, the mean of its channels'; ``"softmax_router"`` scores the
experts with a softmax; ``"no_score_bias"`` picks the experts without
the selection bias; ``"mla_rope"`` rotates MLA's ``q_pe`` and ``k_pe``
at θ = ``rope_theta``.

A ``--trace 1`` run records host activity as well as the device's
(``mla_moe_prefill.host_and_device_trace``), so that the program's
ranges ``kda.*``, ``mla.*`` and ``moe.*`` are in the trace (each kernel
goes to the range its launch lies in: ``mla_moe_prefill.range_device_s``);
the traced ``kda.scan``, ``mla.attend`` and ``moe.experts`` ranges must
equal the program's counters.  On a CUDA device every run requires each
MLA layer call's attention on the flash kernel (``flash_stats``: as many
kernel calls as MLA layer calls, none plain), since ``flash_attention``
falls back to its plain form without raising.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
import traceback

import numpy as np

from portbench import bench, deploy, traffic
from portbench.surfaces.lm_prefill import seeds, sync
from portbench.surfaces.mla_moe_prefill import (Capture, _get, _rel,
                                                _rel_rows, _set, embedding,
                                                head, host_and_device_trace,
                                                range_device_s, run_sizes)

ROWS = "tokens"
# config.json key -> the port's KimiLinearConfig field
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff",
               "moe_intermediate_size": "moe_d_ff",
               "num_experts": "n_experts",
               "num_experts_per_token": "top_k",
               "num_shared_experts": "n_shared_experts",
               "vocab_size": "vocab_size", "rope_theta": "rope_theta",
               "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "hidden_act": "activation", "kv_lora_rank": "kv_lora_rank",
               "qk_nope_head_dim": "qk_nope_dim",
               "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "v_head_dim",
               "first_k_dense_replace": "first_k_dense_replace",
               "num_expert_group": "n_group", "topk_group": "topk_group",
               "routed_scaling_factor": "routed_scaling_factor",
               "moe_renormalize": "norm_topk_prob",
               "mla_use_nope": "mla_use_nope",
               "moe_router_activation_func": "moe_router_activation_func"}
# linear_attn_config key -> field
KDA_FIELDS = {"kda_layers": "kda_layers",
              "full_attn_layers": "full_attn_layers",
              "num_heads": "kda_num_heads", "head_dim": "kda_head_dim",
              "short_conv_kernel_size": "short_conv_kernel_size"}
# config.json keys the port has no field for: the values it implements
FIXED = {"model_type": "kimi_linear", "moe_layer_freq": 1,
         "use_grouped_topk": True, "num_nextn_predict_layers": 0,
         "rope_scaling": None, "q_lora_rank": None}
RANGES = ("kda.project", "kda.scan", "mla.project", "mla.attend",
          "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
          "moe.shared")
CONTROLS = ("kda_state_bf16", "no_delta", "head_decay", "softmax_router",
            "no_score_bias", "mla_rope")
FLOAT32_KINDS = ("scale", "dt_bias", "a_log", "score_bias")


def port_config(arch: str, sizes: dict):
    """The port's registered configuration of ``arch`` with ``sizes``
    (``config.json`` keys) applied; refuses keys whose published meaning
    the port does not implement and keys that disagree with each other."""
    from repro_torch.configs import get_config

    for k, v in FIXED.items():
        if sizes.get(k, v) != v:
            raise ValueError(f"{k}={sizes[k]!r}: the port implements {v!r}")
    if sizes["num_key_value_heads"] != sizes["num_attention_heads"]:
        raise ValueError("MLA has one key head per query head")
    if "head_dim" in sizes and sizes["head_dim"] != \
            sizes["hidden_size"] // sizes["num_attention_heads"]:
        raise ValueError(f"head_dim={sizes['head_dim']!r} disagrees with "
                         "hidden_size / num_attention_heads")
    kw = {PORT_FIELDS[k]: v for k, v in sizes.items() if k in PORT_FIELDS}
    kw.update({KDA_FIELDS[k]: v
               for k, v in sizes["linear_attn_config"].items()})
    kw.update(kda_layers=tuple(kw["kda_layers"]),
              full_attn_layers=tuple(kw["full_attn_layers"]),
              q_lora_rank=0,
              head_dim=sizes["qk_nope_head_dim"] + sizes["qk_rope_head_dim"])
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


# -- weights ------------------------------------------------------------------


def layer_plan(cfg, i: int) -> list:
    """Layer ``i``'s leaves in draw order, of the port's configuration
    ``cfg``: (path, shape, kind), kind ``proj`` (N(0, 1/fan_in), the
    router included), ``scale`` (a norm scale), ``conv`` (U(±1/√K)),
    ``dt_bias``, ``a_log``, ``score_bias`` (the router's selection bias)
    or ``experts`` (E stacked projections, drawn one expert at a time)."""
    from repro_torch.models.kimi_linear import is_kda

    d, h = cfg.d_model, cfg.n_heads
    plan = [(("ln1", "scale"), (d,), "scale"),
            (("ln2", "scale"), (d,), "scale")]
    if is_kda(cfg, i):
        kh, kd = cfg.kda_num_heads, cfg.kda_head_dim
        hd = kh * kd
        plan += [(("kda", "wqkv", "w"), (d, 3 * hd), "proj"),
                 (("kda", "conv_w"), (cfg.short_conv_kernel_size, 3 * hd),
                  "conv"),
                 (("kda", "f_a", "w"), (d, kd), "proj"),
                 (("kda", "f_b", "w"), (kd, hd), "proj"),
                 (("kda", "dt_bias"), (hd,), "dt_bias"),
                 (("kda", "a_log"), (kh,), "a_log"),
                 (("kda", "b_proj", "w"), (d, kh), "proj"),
                 (("kda", "g_a", "w"), (d, kd), "proj"),
                 (("kda", "g_b", "w"), (kd, hd), "proj"),
                 (("kda", "o_norm", "scale"), (kd,), "scale"),
                 (("kda", "o_proj", "w"), (hd, d), "proj")]
    else:
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        dv, lkv = cfg.v_head_dim, cfg.kv_lora_rank
        plan += [(("attn", "wq", "w"), (d, h * (dn + dr)), "proj"),
                 (("attn", "wkv_a", "w"), (d, lkv + dr), "proj"),
                 (("attn", "kv_norm", "scale"), (lkv,), "scale"),
                 (("attn", "wk_b", "w"), (lkv, h * dn), "proj"),
                 (("attn", "wv_b", "w"), (lkv, h * dv), "proj"),
                 (("attn", "wo", "w"), (h * dv, d), "proj")]
    if i < cfg.first_k_dense_replace:
        f = cfg.d_ff
        return plan + [(("mlp", "gate", "w"), (d, f), "proj"),
                       (("mlp", "up", "w"), (d, f), "proj"),
                       (("mlp", "down", "w"), (f, d), "proj")]
    e, fe = cfg.n_experts, cfg.moe_d_ff
    fs = fe * cfg.n_shared_experts
    return plan + [(("moe", "router", "w"), (d, e), "proj"),
                   (("moe", "router", "bias"), (e,), "score_bias"),
                   (("moe", "w_gate"), (e, d, fe), "experts"),
                   (("moe", "w_up"), (e, d, fe), "experts"),
                   (("moe", "w_down"), (e, fe, d), "experts"),
                   (("moe", "shared", "gate", "w"), (d, fs), "proj"),
                   (("moe", "shared", "up", "w"), (d, fs), "proj"),
                   (("moe", "shared", "down", "w"), (fs, d), "proj")]


def draw_layer(cfg, draw: dict, i: int, seed: int, device, emit) -> None:
    """Layer ``i``'s float32 weights from its own ``seed``, in
    :func:`layer_plan` order: ``emit(path, tensor, expert)`` for each
    leaf, or for each expert of a stacked leaf (``expert`` its index,
    else None)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    for path, shape, kind in layer_plan(cfg, i):
        if kind == "experts":
            for e in range(shape[0]):
                emit(path, randn(shape[1:]).mul_(1.0 / math.sqrt(shape[1])),
                     e)
            continue
        if kind == "proj":
            t = randn(shape).mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "scale":
            t = randn(shape).mul_(draw["norm_scale_std"]).add_(1.0)
        elif kind == "conv":
            bound = 1.0 / math.sqrt(shape[0])
            t = rand(shape).mul_(2 * bound).sub_(bound)
        elif kind == "dt_bias":         # softplus⁻¹ of dt log-uniform
            lo, hi = math.log(draw["dt_min"]), math.log(draw["dt_max"])
            dt = torch.exp(rand(shape) * (hi - lo) + lo).clamp_min(
                draw["dt_floor"])
            t = dt + torch.log(-torch.expm1(-dt))
        elif kind == "a_log":
            lo, hi = draw["a_range"]
            t = torch.log(rand(shape).mul_(hi - lo).add_(lo))
        else:
            t = randn(shape).mul_(draw["score_bias_std"])
        emit(path, t, None)


def program_weights(sizes: dict, cfg, draw: dict, layer_seeds: list,
                    g_embed, g_head, device, control=None, dtype=None
                    ) -> dict:
    """The port's parameter tree: projections, experts, the conv, the
    embedding and the head in ``dtype`` (default bf16), the rest float32,
    each leaf allocated once and filled expert by expert."""
    import torch

    low, f32 = dtype or torch.bfloat16, torch.float32
    params = {"embed": embedding(sizes, draw, g_embed, device).to(low),
              "final_norm": {"scale": torch.ones(
                  sizes["hidden_size"], device=device)},
              "head": head(sizes, g_head, device).to(low),
              "layers": []}
    for i in range(cfg.n_layers):
        tree: dict = {}
        for path, shape, kind in layer_plan(cfg, i):
            _set(tree, path, torch.empty(
                shape, device=device,
                dtype=f32 if kind in FLOAT32_KINDS else low))

        def emit(path, t, e):
            leaf = _get(tree, path)
            if control == "no_score_bias" and path[-1] == "bias":
                t = t.zero_()
            (leaf if e is None else leaf[e]).copy_(t)
        draw_layer(cfg, draw, i, layer_seeds[i], device, emit)
        params["layers"].append(tree)
    return params


def reference_layer(cfg, draw: dict, layer_seeds: list, device,
                    dtype=None):
    """``layer(i)`` for the reference: layer ``i``'s weights drawn again
    from its seed, the expert stacks filled expert by expert, as float32
    tensors holding the values the program holds (each bf16 leaf rounded
    through ``dtype``, bf16 by default; the float32 leaves as drawn)."""
    import torch

    dtype = dtype or torch.bfloat16

    def layer(i):
        plan = {p: (s, k) for p, s, k in layer_plan(cfg, i)}
        out: dict = {}

        def emit(path, t, e):
            shape, kind = plan[path]
            if kind not in FLOAT32_KINDS:
                t = t.to(dtype).to(torch.float32)
            if e is None:
                _set(out, path, t)
                return
            if e == 0:
                _set(out, path, torch.empty(shape, device=device))
            _get(out, path)[e].copy_(t)
        draw_layer(cfg, draw, i, layer_seeds[i], device, emit)
        return out
    return layer


# -- program controls ---------------------------------------------------------


@contextlib.contextmanager
def program_control(control):
    """The program with ``control``'s change in place (the weight and
    configuration controls change nothing here)."""
    import torch

    from repro_torch.models import kda as K
    from repro_torch.models import layers as L

    saved = []

    def patch(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    if control == "kda_state_bf16":
        scan = K.scan

        def low_scan(q, k, v, g, beta, state=None):
            bf = torch.bfloat16
            o, s = scan(q.to(bf), k.to(bf), v.to(bf), g.to(bf), beta.to(bf),
                        None if state is None else state.to(bf))
            return o.float(), s.float()
        patch(K, "scan", low_scan)
    elif control == "no_delta":
        def plain(a, beta, v, kt):
            return beta[..., None] * v, torch.zeros_like(kt)
        patch(K, "_ut_transform", plain)
    elif control == "head_decay":
        decay = K.decay

        def per_head(f, a_log, dt_bias):
            g = decay(f, a_log, dt_bias)
            return g.mean(-1, keepdim=True).expand_as(g)
        patch(K, "decay", per_head)
    elif control == "softmax_router":
        patch(L, "_router_scores",
              lambda logits, cfg: torch.softmax(logits, -1))
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


# -- the check ----------------------------------------------------------------


def flash_path_error(flash: dict, mla_layers: int, device: str):
    """On a CUDA device every MLA layer's attention runs on the flash
    kernel (``flash.flash_stats``: ``kernel`` calls = MLA layer calls,
    ``plain`` 0); what differs, or None.  The CPU has no kernel."""
    got = (flash["kernel"], flash["plain"])
    if device == "cpu" or got == (mla_layers, 0):
        return None
    return (f"flash attention calls (kernel, plain) {got} on {device}, "
            f"expected ({mla_layers}, 0): the MLA layers' attention left "
            "the kernel")


def reference_pass(ref, layer, final_norm, head_w, emb_rows, sizes: dict,
                   cap: Capture) -> dict:
    """The reference, layer by layer on each layer's weights: on each
    piece of the program's call with the program's own inputs to it
    (``cap``), and free from the embedding rows.  Per layer, the relative
    L2 error over every token of the program's mixer output (KDA or MLA,
    on the first norm's output), of its FFN output (the MoE or the dense
    MLP on the second norm's output), the largest of the FFN's per token,
    and of its glue (each norm's output against the norm of the layer's
    input and of the residual after the mixer, and the layer's output
    less its input against both sublayers).  The head on the program's
    last hidden state and on the free run's: logits per prompt."""
    import torch

    ref.plain_precision()
    dev = final_norm.device
    f32 = torch.float32
    eps = sizes["rms_norm_eps"]
    err = {"kda": [], "mla": [], "ffn": [], "ffn_token": [], "glue": []}
    free = emb_rows.to(f32)
    for i in range(sizes["num_hidden_layers"]):
        p = layer(i)
        xin, h, a, h2, f, y = (t.to(dev, f32) for t in cap.blocks[i])
        if "kda" in p:
            err["kda"].append(_rel(a, ref.kda(h, p["kda"], sizes)))
        else:
            err["mla"].append(_rel(a, ref.mla(h, p["attn"], sizes)))
        want = (ref.moe(h2, p["moe"], sizes) if "moe" in p
                else ref.swiglu(h2, p["mlp"]))
        err["ffn"].append(_rel(f, want))
        err["ffn_token"].append(_rel_rows(f, want))
        err["glue"].append(max(
            _rel(h, ref.rms_norm(xin, p["ln1"]["scale"], eps)),
            _rel(h2, ref.rms_norm(xin + a, p["ln2"]["scale"], eps)),
            _rel(y - xin, a + f)))
        del xin, h, a, h2, f, y, want
        free = ref.block(free, p, sizes)
        del p
    hx = cap.sites["head"][0][0].to(dev, f32)
    return dict(err, logits=ref.final_logits(hx, final_norm, head_w, sizes),
                free=ref.final_logits(free, final_norm, head_w, sizes))


# -- the run ------------------------------------------------------------------


def run(workload: dict, spec: dict, *, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t_start: float = None,
        marks=None, mix_override=None, server_override=None) -> dict:
    """Run one Kimi Linear prefill cell and return the result object."""
    import torch

    from portbench.reference import kimi_linear as ref
    from repro_torch.models import build_model, taps
    from repro_torch.models.flash import flash_stats
    from repro_torch.models.kimi_linear import kimi_stats
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
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    if control == "mla_rope":
        cfg = cfg.replace(mla_use_nope=False)
    low = getattr(torch, cfg.dtype)
    draw = cfg_file["weights"]
    b, s = int(mix["batch"]), int(mix["seq"])
    n_layers = sizes["num_hidden_layers"]
    g_tok, g_pick, g_embed, g_head, *layer_seeds = seeds(seed, 4 + n_layers)
    dev = torch.device(device)
    model = build_model(cfg, device=device)
    params = program_weights(sizes, cfg, draw, layer_seeds, g_embed, g_head,
                             dev, control, low)
    gen = torch.Generator(device=dev).manual_seed(g_tok)
    pool = torch.randint(0, sizes["vocab_size"], (int(mix["pool_batches"]),
                         b, s), generator=gen, device=dev)
    sync(device)
    t.append(clock())
    prefill = model.prefill
    spans = dev_trace = None
    with program_control(control), torch.no_grad():
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
                events = dev_trace.device_events
                dev_trace.device_events = lambda: [
                    e for e in events() if e[0] not in RANGES]
        kimi_stats.reset()
        moe_stats.reset()
        flash_stats.reset()
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
        stats = dict(tokens=kimi_stats.tokens,
                     kda_layers=kimi_stats.kda_layers,
                     mla_layers=kimi_stats.mla_layers,
                     kda_chunks=kimi_stats.kda_chunks)
        moe = dict(tokens=moe_stats.tokens, slots=moe_stats.slots,
                   layer_calls=moe_stats.layer_calls)
        flash = dict(kernel=flash_stats.kernel, plain=flash_stats.plain)
        off_kernel = flash_path_error(flash, stats["mla_layers"], device)
        if off_kernel:
            raise RuntimeError(off_kernel)
        device_info = bench.device_block(device)

        # every window prompt finite; the sampled call's logits kept
        finite = [torch.zeros(b, dtype=torch.bool) if o is None else
                  torch.isfinite(o.reshape(b, -1)).all(-1).cpu()
                  for o in outs]
        nonfinite = int((~torch.cat(finite)).sum())
        pick = int(np.random.default_rng(g_pick).integers(calls))
        got = None if outs[pick] is None else \
            outs[pick].reshape(b, -1).to(torch.float32)
        tokens = pool[pick % pool.shape[0]]
        # the sampled call once more, its intermediate values kept: a call
        # repeats bit for bit, so they are the window call's
        t_rep = clock()
        cap = Capture()
        with taps.recording(cap):
            again = model.prefill(params, tokens=tokens)
        replay_mismatch = int(got is None or not torch.equal(
            again.reshape(b, -1).to(torch.float32), got))
        del outs, params, pool, model, again
    if device != "cpu":
        torch.cuda.empty_cache()

    t_ref = clock()
    emb_rows = embedding(sizes, draw, g_embed, dev)[tokens.long()].to(low)
    breaks = cap.chain_breaks(emb_rows, n_layers)
    tol = cfg_file["tolerance"]
    inf = [math.inf]
    if breaks:
        r = dict(logits=None, free=None, kda=inf, mla=inf, ffn=inf,
                 ffn_token=inf, glue=inf)
    else:
        with torch.no_grad():
            r = reference_pass(
                ref, reference_layer(cfg, draw, layer_seeds, dev, low),
                torch.ones(sizes["hidden_size"], device=dev),
                head(sizes, g_head, dev).to(low), emb_rows, sizes, cap)
    del emb_rows, cap
    ref_s = clock() - t_ref

    def per_prompt(want):
        if got is None or want is None:
            return torch.full((b,), math.inf, dtype=torch.float64)
        return torch.nan_to_num(ref.rel_l2(got, want).cpu(), nan=math.inf)
    rel, free_rel = per_prompt(r["logits"]), per_prompt(r["free"])
    err = {k: r[k] or inf for k in ("kda", "mla", "ffn", "ffn_token",
                                    "glue")}
    lim = float(tol["logit_rel_l2"])
    checks = dict(
        logit_rel_l2_max=dict(value=float(rel.max()), limit=lim),
        logit_rows_over_tol=dict(value=int((rel > lim).sum()), limit=0),
        kda_rel_l2_max=dict(value=max(err["kda"]),
                            limit=float(tol["kda_rel_l2"])),
        mla_rel_l2_max=dict(value=max(err["mla"]),
                            limit=float(tol["mla_rel_l2"])),
        ffn_rel_l2_max=dict(value=max(err["ffn"]),
                            limit=float(tol["ffn_rel_l2"])),
        ffn_token_rel_l2_max=dict(value=max(err["ffn_token"]),
                                  limit=float(tol["ffn_token_rel_l2"])),
        glue_rel_l2_max=dict(value=max(err["glue"]),
                             limit=float(tol["glue_rel_l2"])),
        chain_breaks=dict(value=breaks, limit=0),
        nonfinite_logits=dict(value=nonfinite, limit=0),
        replay_mismatch=dict(value=replay_mismatch, limit=0))

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
            range_s, counted = range_device_s(dev_trace.prof, RANGES)
            want = {"kda.scan": stats["kda_layers"],
                    "mla.attend": stats["mla_layers"],
                    "moe.experts": moe["layer_calls"]}
            if any(counted[k] != v for k, v in want.items()):
                raise RuntimeError(
                    f"traced ranges differ from the program's counters: "
                    f"{ {k: counted[k] for k in want} } ranges, {want} "
                    f"calls")
            ranges = dict(device_s=range_s, counts=counted)
            device_info.update(busy_s=summary["busy_s"],
                               window_s=summary["window_s"])
            breakdown = dict(device_ops=[[n[:120], v] for n, v in
                                         summary["device_ops"]],
                             idle_gaps=summary["idle_gaps"])
        rec = bench.Record(window_s=window_s, trace=summary, calls=ok_calls,
                           batch=b, seq=s, sizes=sizes, ranges=range_s,
                           moe=moe, kimi=stats)
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
        tokens_per_call=b * s, kimi=stats, moe=moe, flash=flash,
        ranges=ranges,
        calls_per_second=per_s.tolist(), sampled_call=pick,
        logit_rel_l2=rel.tolist(), kda_rel_l2=err["kda"],
        mla_rel_l2=err["mla"], ffn_rel_l2=err["ffn"],
        ffn_token_rel_l2=err["ffn_token"], glue_rel_l2=err["glue"],
        free_logit_rel_l2=free_rel.tolist(),
        replay_s=t_ref - t_rep, reference_s=ref_s,
        setup_phases=dict(before_run_s=t[0] - t_start, **(marks or {}),
                          **phases))
    result["checks"] = checks
    print(f"{name}: {calls} calls, kimi {stats}, moe {moe}, flash {flash}",
          file=sys.stderr)
    return result
