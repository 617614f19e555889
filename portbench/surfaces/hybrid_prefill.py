"""The hybrid prefill surface: one cell of document prefill through the
port's normal path, ``build_model(cfg).prefill``, on Zamba2 (Mamba-2
layers and shared attention blocks) whose bf16 weights are drawn from the
seed on the device.

Set-up draws the weights one leaf at a time from one generator per Mamba
layer, per shared block and per application (its adapter and ``linear``),
each stacked leaf allocated once in its dtype, so that no float32 copy of
the model exists: projections and the conv in bf16, norm scales and the
per-head ``a_log``, ``dt_bias`` and ``D`` in float32, in the port's tree.
It draws a pool of token batches and runs the mix's warm-up calls.  The
window is a closed loop of prefill calls on the pool's batches, back to
back under ``torch.no_grad()``, closed by a synchronisation.

After it, one window call drawn from the seed runs once more under a
recording of the program's ``repro_torch.models.taps`` (``Check``); its
logits must equal the window call's bit for bit.  As the program hands
each piece's values over, the plain reference (``reference/zamba2.py``)
runs that piece on the program's own inputs, with the piece's weights
drawn again from their seeds (float32 tensors holding the values the
program held): each Mamba layer's mixer on its norm output; each shared
application's attention on its ``[h ‖ e]`` and its MLP, adapter and
``linear`` on the attention's output; the glue (each layer's norm of
``h + t`` and its residual add); and the head on the last hidden state,
against the window call's logits.  Each is a relative L2 error over every
token of the call (the head's per prompt).  Besides: the tapped values
join up exactly, from the embedding's rows through every application and
layer to the head and the logits the call returns, and every window
prompt's logits are finite.  Then the program's weights are
freed and the reference runs free from the embedding rows through every
layer; its last-position logits against the window call's are reported
(``free_logit_rel_l2``) and not compared.

A configuration holds the ``config.json`` keys as run at its top level
(the port's registered ``arch`` must equal its ``published`` block), the
weight draw (``weights``) and the comparison's ``tolerance``.  The run's
``server_override`` replaces sizes (a smaller model on the CPU), may set
the ``dtype`` of the weights and activations (``"float32"`` holds the
program to the reference's arithmetic) and may hold a ``control``, a
program made wrong on purpose: ``"fp8_mamba"`` rounds every Mamba layer's
in- and out-projection to ``float8_e4m3fn`` with one absmax scale each,
``"fp8_norms"`` every norm scale; ``"no_adapter"`` leaves the adapters
out (their second factor zero); ``"ssd_bf16"`` runs the SSD with its
state, chunk sums and decays in bf16; ``"group0_bc"`` has every head read
group 0's B and C; ``"scale_sqrt_d"`` scales the shared attention's
softmax by 1/√D; ``"norm_before_gate"`` normalises the mixer's output
before its SiLU gate.

A ``--trace 1`` run records host activity as well as the device's
(``mla_moe_prefill.host_and_device_trace``), so that the program's
ranges ``ssm.project``, ``ssm.scan``, ``zamba2.shared`` and
``zamba2.attend`` are in the trace (each kernel goes to the range its
launch lies in: ``mla_moe_prefill.range_device_s``); the traced
``ssm.scan`` and ``zamba2.attend`` ranges must equal the program's
Mamba-layer and application counters.
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
from portbench.surfaces.mla_moe_prefill import (_get, _rel, _set,
                                                fp8_rounded,
                                                host_and_device_trace,
                                                range_device_s)

ROWS = "tokens"
# config.json key -> the port's Zamba2Config field
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "attention_head_dim": "head_dim",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
               "hidden_act": "activation", "mamba_d_state": "ssm_state",
               "mamba_headdim": "ssm_head_dim",
               "mamba_expand": "ssm_expand", "mamba_d_conv": "conv_width",
               "num_mem_blocks": "num_mem_blocks",
               "adapter_rank": "adapter_rank",
               "attention_hidden_size": "attention_hidden_size",
               "mamba_ngroups": "mamba_ngroups",
               "use_mem_rope": "use_mem_rope",
               "use_shared_mlp_adapter": "use_shared_mlp_adapter",
               "use_shared_attention_adapter":
                   "use_shared_attention_adapter",
               "chunk_size": "chunk_size"}
# config.json keys the port has no field for: the values it implements
FIXED = {"add_bias_linear": False, "use_conv_bias": True,
         "time_step_limit": None, "use_long_context": False,
         "hidden_act": "gelu", "model_type": "zamba2",
         "num_logits_to_keep": 1}
RANGES = ("ssm.project", "ssm.scan", "zamba2.shared", "zamba2.attend")
CONTROLS = ("fp8_mamba", "fp8_norms", "no_adapter", "ssd_bf16", "group0_bc",
            "scale_sqrt_d", "norm_before_gate")


def run_sizes(cfg_file: dict) -> dict:
    """The ``config.json`` keys as the cell runs them (the file's top
    level, under the names of its ``published`` block)."""
    return {k: cfg_file[k] for k in cfg_file["published"]}


def port_config(arch: str, sizes: dict):
    """The port's registered configuration of ``arch`` with ``sizes``
    (``config.json`` keys) applied; refuses keys whose published meaning
    the port does not implement and keys that disagree with each other."""
    from repro_torch.configs import get_config

    for k, v in FIXED.items():
        if sizes.get(k, v) != v:
            raise ValueError(f"{k}={sizes[k]!r}: the port implements {v!r}")
    ids = list(sizes["hybrid_layer_ids"])
    n, d = sizes["num_hidden_layers"], sizes["hidden_size"]
    heads = sizes["num_attention_heads"]
    derived = {
        "layers_block_type": ["hybrid" if i in ids else "mamba"
                              for i in range(n)],
        "n_mamba_heads": sizes["mamba_expand"] * d // sizes["mamba_headdim"],
        "attention_hidden_size": 2 * d,
        "num_key_value_heads": heads, "num_query_groups": heads,
        "ffn_hidden_size": sizes["intermediate_size"]}
    for k, v in derived.items():
        if k in sizes and sizes[k] != v:
            raise ValueError(f"{k}={sizes[k]!r} disagrees with the other "
                             f"keys ({v!r})")
    kw = {PORT_FIELDS[k]: v for k, v in sizes.items() if k in PORT_FIELDS}
    kw.update(hybrid_layer_ids=tuple(ids),
              attention_head_dim=sizes["attention_head_dim"])
    return dataclasses.replace(get_config(arch), **kw)


def check_registered(cfg_file: dict) -> None:
    """The port's registered configuration is the published one, with the
    head tied to the embedding."""
    from repro_torch.configs import get_config

    have = get_config(cfg_file["arch"])
    want = port_config(cfg_file["arch"], cfg_file["published"])
    differ = {f.name: (getattr(have, f.name), getattr(want, f.name))
              for f in dataclasses.fields(have)
              if getattr(have, f.name) != getattr(want, f.name)}
    if not have.tie_embeddings:
        differ["tie_embeddings"] = (False, True)
    if differ:
        raise ValueError(f"{cfg_file['arch']}: the port's configuration "
                         f"differs from the published one: {differ}")


# -- weights ------------------------------------------------------------------


def plans(sizes: dict) -> dict:
    """Each part's leaves in draw order: (path, shape, kind), kind
    ``proj`` (N(0, 1/fan_in)), ``scale`` (a norm scale), ``conv``
    (U(−1/√K, 1/√K), the conv's weight and bias), ``a_log``, ``dt_bias``
    or ``d_skip``."""
    d, f = sizes["hidden_size"], sizes["intermediate_size"]
    d_in = sizes["mamba_expand"] * d
    h, g = sizes["n_mamba_heads"], sizes["mamba_ngroups"]
    conv = d_in + 2 * g * sizes["mamba_d_state"]
    hd = sizes["num_attention_heads"] * sizes["attention_head_dim"]
    app = [(("linear", "w"), (d, d), "proj")]
    if sizes["use_shared_mlp_adapter"]:
        r = sizes["adapter_rank"]
        app += [(("adapter_a", "w"), (d, r), "proj"),
                (("adapter_b", "w"), (r, 2 * f), "proj")]
    return {
        "mamba": [(("ln", "scale"), (d,), "scale"),
                  (("in_proj", "w"), (d, d_in + conv + h), "proj"),
                  (("conv_w",), (sizes["mamba_d_conv"], conv), "conv"),
                  (("conv_b",), (conv,), "conv"),
                  (("a_log",), (h,), "a_log"),
                  (("dt_bias",), (h,), "dt_bias"),
                  (("d_skip",), (h,), "d_skip"),
                  (("out_norm",), (d_in,), "scale"),
                  (("out_proj", "w"), (d_in, d), "proj")],
        "shared": [(("ln1", "scale"), (2 * d,), "scale"),
                   (("wq", "w"), (2 * d, hd), "proj"),
                   (("wk", "w"), (2 * d, hd), "proj"),
                   (("wv", "w"), (2 * d, hd), "proj"),
                   (("wo", "w"), (hd, d), "proj"),
                   (("ln2", "scale"), (d,), "scale"),
                   (("gate_up", "w"), (d, 2 * f), "proj"),
                   (("down", "w"), (f, d), "proj")],
        "apps": app}


FLOAT32_KINDS = ("scale", "a_log", "dt_bias", "d_skip")


def draw_part(sizes: dict, draw: dict, part: str, seed: int, device, emit
              ) -> None:
    """One Mamba layer's, shared block's or application's float32
    weights from its own ``seed``, in :func:`plans` order:
    ``emit(path, tensor)`` for each leaf."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    for path, shape, kind in plans(sizes)[part]:
        if kind == "proj":
            t = torch.randn(shape, generator=gen, device=device)
            t.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "scale":
            t = torch.randn(shape, generator=gen, device=device)
            t.mul_(draw["norm_scale_std"]).add_(1.0)
        elif kind == "conv":
            bound = 1.0 / math.sqrt(sizes["mamba_d_conv"])
            t = torch.rand(shape, generator=gen, device=device)
            t.mul_(2 * bound).sub_(bound)
        elif kind == "a_log":
            t = torch.log(torch.arange(1, shape[0] + 1, device=device,
                                       dtype=torch.float32))
        elif kind == "dt_bias":
            lo = math.log(sizes["time_step_min"])
            hi = math.log(sizes["time_step_max"])
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (hi - lo) + lo).clamp_min(
                sizes["time_step_floor"])
            t = dt + torch.log(-torch.expm1(-dt))    # softplus⁻¹(dt)
        else:
            t = torch.ones(shape, device=device)
        emit(path, t)


def embedding(sizes: dict, draw: dict, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((sizes["vocab_size"], sizes["hidden_size"]),
                       generator=gen, device=device).mul_(draw["embed_std"])


def final_norm(sizes: dict, draw: dict, seed: int, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(sizes["hidden_size"], generator=gen,
                       device=device).mul_(draw["norm_scale_std"]).add_(1.0)


def counts(sizes: dict) -> dict:
    return {"mamba": sizes["num_hidden_layers"],
            "shared": sizes["num_mem_blocks"],
            "apps": len(sizes["hybrid_layer_ids"])}


def part_seeds(sizes: dict, rest: list) -> dict:
    """The per-part seeds, in order: Mamba layers, blocks, applications."""
    out, k = {}, 0
    for part, n in counts(sizes).items():
        out[part] = rest[k:k + n]
        k += n
    return out


def _controlled(control, path, t):
    if control == "fp8_norms" and path[-1] in ("scale", "out_norm"):
        return fp8_rounded(t)
    if control == "fp8_mamba" and path[0] in ("in_proj", "out_proj"):
        return fp8_rounded(t)
    if control == "no_adapter" and path[0] == "adapter_b":
        return t.zero_()
    return t


def program_weights(sizes: dict, draw: dict, pseeds: dict, g_embed: int,
                    g_final: int, device, control=None, dtype=None) -> dict:
    """The port's parameter tree: projections and the conv in ``dtype``
    (default bf16), the rest float32, each stacked leaf allocated once and
    filled part by part."""
    import torch

    low, f32 = dtype or torch.bfloat16, torch.float32
    norm = final_norm(sizes, draw, g_final, device)
    params = {"embed": embedding(sizes, draw, g_embed, device).to(low),
              "final_norm": {"scale": fp8_rounded(norm)
                             if control == "fp8_norms" else norm}}
    for part, leaves in plans(sizes).items():
        tree: dict = {}
        n = counts(sizes)[part]
        for path, shape, kind in leaves:
            _set(tree, path, torch.empty(
                (n, *shape), device=device,
                dtype=f32 if kind in FLOAT32_KINDS else low))
        for j in range(n):
            def emit(path, t, j=j):
                _get(tree, path)[j].copy_(_controlled(control, path, t))
            draw_part(sizes, draw, part, pseeds[part][j], device, emit)
        if part == "apps":
            params.update(tree)
        else:
            params[part] = tree
    return params


def reference_part(sizes: dict, draw: dict, pseeds: dict, part: str, device,
                   dtype=None):
    """``get(i)`` for the reference: part ``i``'s weights drawn again from
    its seed, float32 tensors holding the values the program holds (each
    projection and conv leaf rounded through ``dtype``, bf16 by default;
    the float32 leaves as drawn)."""
    import torch

    dtype = dtype or torch.bfloat16
    kinds = {p: k for p, _, k in plans(sizes)[part]}

    def get(i):
        out: dict = {}

        def emit(path, t):
            if kinds[path] not in FLOAT32_KINDS:
                t = t.to(dtype).to(torch.float32)
            _set(out, path, t)
        draw_part(sizes, draw, part, pseeds[part][i], device, emit)
        return out
    return get


# -- program controls ---------------------------------------------------------


@contextlib.contextmanager
def program_control(control):
    """The program with ``control``'s change in place (the weight
    controls change nothing here)."""
    import torch

    from repro_torch.models import ssm, zamba2 as Z

    saved = {}

    def patch(name, fn):
        saved[name] = getattr(Z, name)
        setattr(Z, name, fn)

    ssd = Z.ssd
    if control == "ssd_bf16":
        def low_ssd(xh, bmat, cmat, dt, a, chunk, state=None):
            if state is not None:
                return ssd(xh, bmat, cmat, dt, a, chunk, state)
            bf = torch.bfloat16
            y, s = ssm.ssd_grouped(xh.to(bf), bmat.to(bf), cmat.to(bf),
                                   dt.to(bf), a.to(bf), chunk)
            return y.float(), s.float()
        patch("ssd", low_ssd)
    elif control == "group0_bc":
        def group0(xh, bmat, cmat, dt, a, chunk, state=None):
            return ssd(xh, bmat[:, :, :1].expand_as(bmat),
                       cmat[:, :, :1].expand_as(cmat), dt, a, chunk, state)
        patch("ssd", group0)
    elif control == "scale_sqrt_d":
        patch("softmax_scale", lambda cfg: cfg.head_dim ** -0.5)
    elif control == "norm_before_gate":
        def before(y, z, w, groups, eps=Z.GATED_EPS):
            g = y.to(torch.float32).unflatten(-1, (groups, -1))
            g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + eps)
            g = g.flatten(-2) * w * torch.nn.functional.silu(
                z.to(torch.float32))
            return g.to(y.dtype)
        patch("gated_norm", before)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(Z, name, fn)


# -- the check ----------------------------------------------------------------


class Check:
    """Holds each piece of one prefill against the reference as the
    program hands its values to its taps (``repro_torch.models.taps``):
    use as the recording's callback.  ``mamba(i)``, ``block(b)`` and
    ``app(j)`` give the reference's float32 weights."""

    def __init__(self, ref, sizes: dict, emb_rows, mamba, block, app,
                 norm, embed, device):
        self.ref, self.sizes, self.device = ref, sizes, device
        self.emb_rows, self.norm, self.embed = emb_rows, norm, embed
        self.mamba_w, self.app_w = mamba, app
        self.blocks = {}
        self.block_w = block
        self.apps = list(sizes["hybrid_layer_ids"])
        self.err = {"mamba": [], "shared": [], "glue": []}
        self.breaks = 0
        self.layer = self.app = 0
        self.e = self.prev = self.t = None
        self.head = self.logits = None   # the head's logits: reference, tap

    def _f32(self, x):
        import torch
        return x.to(self.device, torch.float32)

    def _same(self, a, b) -> None:
        import torch
        if b is None or a.shape != b.shape or not torch.equal(a, b):
            self.breaks += 1

    def __call__(self, site, tensors) -> None:
        getattr(self, "_" + site)(*tensors)

    def _embed(self, e) -> None:
        self._same(e, self.emb_rows.to(e.dtype))
        self.e = self.prev = e.clone()

    def _shared(self, hc, a, t) -> None:
        import torch
        ref, sizes = self.ref, self.sizes
        j = self.app
        if j >= len(self.apps) or self.layer != self.apps[j] \
                or self.prev is None:
            self.breaks += 1
            return
        self._same(hc, torch.cat([self.prev, self.e], -1))
        b = j % sizes["num_mem_blocks"]
        if b not in self.blocks:
            self.blocks[b] = self.block_w(b)
        p = self.blocks[b]
        want_a = ref.attention(self._f32(hc), p, sizes)
        want_t = ref.shared_mlp(self._f32(a), p, self.app_w(j), sizes)
        self.err["shared"].append(max(_rel(a, want_a), _rel(t, want_t)))
        self.t = t.clone()
        self.app += 1

    def _mamba(self, x, *rest) -> None:
        ref, sizes = self.ref, self.sizes
        i = self.layer
        hybrid = self.app > 0 and self.apps[self.app - 1] == i
        if len(rest) != (4 if hybrid else 3) or self.prev is None:
            self.breaks += 1
            self.layer += 1
            return
        t = rest[0] if hybrid else None
        u, mix, y = rest[-3:]
        self._same(x, self.prev)
        if hybrid:
            self._same(t, self.t)
        p = self.mamba_w(i)
        xf = self._f32(x)
        xt = xf if t is None else xf + self._f32(t)
        self.err["mamba"].append(_rel(mix, ref.mixer(self._f32(u), p, sizes)))
        self.err["glue"].append(max(
            _rel(u, ref.rms_norm(xt, p["ln"]["scale"], sizes["rms_norm_eps"])),
            _rel(y, xf + self._f32(mix))))
        self.prev = y.clone()
        self.layer += 1

    def _head(self, x, logits) -> None:
        if self.prev is None:
            self.breaks += 1
            return
        self._same(x, self.prev[:, -1:])
        self.logits = logits.clone()
        self.head = self.ref.final_logits(self._f32(x), self.norm,
                                          self.embed, self.sizes)

    def finish(self) -> int:
        """Chain breaks, counting every site the call did not reach."""
        missing = (self.layer != self.sizes["num_hidden_layers"]) \
            + (self.app != len(self.apps)) + (self.head is None)
        return self.breaks + missing


# -- the run ------------------------------------------------------------------


def run(workload: dict, spec: dict, *, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t_start: float = None,
        marks=None, mix_override=None, server_override=None) -> dict:
    """Run one hybrid prefill cell and return the result object."""
    import torch

    from portbench.reference import zamba2 as ref
    from repro_torch.models import build_model, taps
    from repro_torch.models.zamba2 import zamba2_stats

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
    low = getattr(torch, cfg.dtype)
    draw = cfg_file["weights"]
    b, s = int(mix["batch"]), int(mix["seq"])
    n_parts = sum(counts(sizes).values())
    g_tok, g_pick, g_embed, g_final, *rest = seeds(seed, 4 + n_parts)
    pseeds = part_seeds(sizes, rest)
    dev = torch.device(device)
    model = build_model(cfg, device=device)
    params = program_weights(sizes, draw, pseeds, g_embed, g_final, dev,
                             control, low)
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
        zamba2_stats.reset()
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
        stats = dict(tokens=zamba2_stats.tokens,
                     mamba_layers=zamba2_stats.mamba_layers,
                     ssd_chunks=zamba2_stats.ssd_chunks,
                     shared={str(k): v for k, v in
                             sorted(zamba2_stats.shared.items())})
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
        del outs, pool

        # the sampled call once more, each piece held to the reference as
        # the program hands it over: a call repeats bit for bit, so they
        # are the window call's
        t_rep = clock()
        ref.plain_precision()
        emb_rows = embedding(sizes, draw, g_embed, dev)[tokens.long()]
        embed_ref = embedding(sizes, draw, g_embed, dev).to(low).float()
        norm_ref = final_norm(sizes, draw, g_final, dev)
        parts = {part: reference_part(sizes, draw, pseeds, part, dev, low)
                 for part in counts(sizes)}
        chk = Check(ref, sizes, emb_rows.to(low), parts["mamba"],
                    parts["shared"], parts["apps"], norm_ref, embed_ref, dev)
        with taps.recording(chk):
            again = model.prefill(params, tokens=tokens)
        replay_mismatch = int(got is None or not torch.equal(
            again.reshape(b, -1).to(torch.float32), got))
        breaks = chk.finish() + int(chk.logits is None
                                    or not torch.equal(chk.logits, again))
        del params, model, again, chk.blocks
    if device != "cpu":
        torch.cuda.empty_cache()

    # the reference free from the embedding rows
    t_free = clock()
    with torch.no_grad():
        free = ref.last_logits(emb_rows.to(low), parts["mamba"],
                               parts["shared"], parts["apps"], norm_ref,
                               embed_ref, sizes)
    free_rel = (torch.full((b,), math.inf, dtype=torch.float64)
                if got is None else torch.nan_to_num(
                    ref.rel_l2(got, free).cpu(), nan=math.inf))
    del free, emb_rows, embed_ref
    free_s = clock() - t_free

    tol = cfg_file["tolerance"]
    inf = [math.inf]
    err = {k: v or inf for k, v in chk.err.items()}
    head = (torch.full((b,), math.inf, dtype=torch.float64)
            if chk.head is None or got is None else
            torch.nan_to_num(ref.rel_l2(got, chk.head).cpu(), nan=math.inf))
    lim = float(tol["logit_rel_l2"])
    checks = dict(
        logit_rel_l2_max=dict(value=float(head.max()), limit=lim),
        logit_rows_over_tol=dict(value=int((head > lim).sum()), limit=0),
        mamba_rel_l2_max=dict(value=max(err["mamba"]),
                              limit=float(tol["mamba_rel_l2"])),
        shared_rel_l2_max=dict(value=max(err["shared"]),
                               limit=float(tol["shared_rel_l2"])),
        glue_rel_l2_max=dict(value=max(err["glue"]),
                             limit=float(tol["glue_rel_l2"])),
        chain_breaks=dict(value=breaks, limit=0),
        nonfinite_logits=dict(value=nonfinite, limit=0),
        replay_mismatch=dict(value=replay_mismatch, limit=0))
    ref_s = t_free - t_rep

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
            want = {"ssm.scan": stats["mamba_layers"],
                    "zamba2.attend": sum(stats["shared"].values())}
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
                           zamba2=stats)
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
        tokens_per_call=b * s, zamba2=stats, ranges=ranges,
        calls_per_second=per_s.tolist(), sampled_call=pick,
        logit_rel_l2=head.tolist(), mamba_rel_l2=err["mamba"],
        shared_rel_l2=err["shared"], glue_rel_l2=err["glue"],
        free_logit_rel_l2=free_rel.tolist(),
        reference_s=ref_s, free_reference_s=free_s,
        setup_phases=dict(before_run_s=t[0] - t_start, **(marks or {}),
                          **phases))
    result["checks"] = checks
    print(f"{name}: {calls} calls, zamba2 {stats}", file=sys.stderr)
    return result
