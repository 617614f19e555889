"""Zamba2 as published (arXiv:2411.15242; Zyphra's Zamba2-7B-Instruct
``config.json``, ``configs/zamba2_7b.py``): Mamba-2 layers with B and C in
groups of heads, and before the layers of ``cfg.hybrid_layer_ids`` one of
``cfg.num_mem_blocks`` shared attention + MLP blocks, alternating, on the
hidden state concatenated with the embedding, with a LoRA adapter and a
``linear`` of each application's own.

``h`` is the residual stream and ``e`` the embedding rows; nothing scales
them.  Layer ℓ::

    in = h + t              (t = 0 unless ℓ is hybrid)
    u = RMSNorm_ℓ(in)
    h ← h + Mixer_ℓ(u)      (the residual is h, not in)

Application ``j`` (layer ``hybrid_layer_ids[j]``) of block
``j % num_mem_blocks`` with adapter ``j``::

    c = RMSNorm([h ‖ e]);  q, k, v = c·W_q, c·W_k, c·W_v   (2d → H×D)
    a = softmax(rope(q)·rope(k)ᵀ · (D/2)^-½, causal)·v·W_o
    m = RMSNorm(a);  [g ‖ up] = m·W_gu + (m·A_j)·B_j
    t = (GELU(g) ⊙ up)·W_down·Linear_j                     (no residual)

Mixer::

    [z ‖ xBC ‖ dt] = u·W_in
    xBC = SiLU(causal depthwise conv(xBC) + b);  x, B, C = split(xBC)
    dt = softplus(dt + dt_bias)                            (unclamped)
    y = SSD(x, dt, A = −exp(A_log), B, C) + D ⊙ x          (head i: group
                                                           i // (H/G))
    out = W_out·GatedRMSNorm(y, z)

where the gated norm multiplies by SiLU(z) first and then takes the RMS
over each group's ``d_inner / G`` channels.  The head is the final RMSNorm
and the tied embedding.

The SSD runs chunked, its state and chunk sums in float32, in chunks of
``SSD_CHUNK`` positions, the program's choice (the result does not depend
on it; the published ``cfg.chunk_size`` is 256: a 4 × 4096 zamba2-7b
prefill took 3.06 s a call at 256, 2.68 s at 128 and 2.54 s at 64 on one
H100 at 700 W, in the plain form).  A prefill's SSD on the card runs the
hand-written scan ``kernels/ssd_scan.py`` (``csrc/ssd_scan.cu``, the same
chunk), which raises on operands it does not take; the CPU, autograd,
DTensors and dispatch modes (:func:`ssd_kernel_applies`) keep the plain
``ssm.ssd_grouped`` (the exponent masked before the exp, no clamp).
``zamba2_stats`` counts the prefill SSDs by path.  Decode is the
recurrent step (``ssm.ssd_step_grouped``).
Attention runs ``flash.flash_attention`` on q pre-scaled by (D/2)^-½.
``prefill`` with ``caches`` fills them (conv windows, SSD states, the
applications' KV caches) for ``decode_step``, whose token's ``e`` row is
its own embedding.

Parameters: ``mamba`` stacked over the layers, ``shared`` over the blocks,
``adapter_a``, ``adapter_b`` and ``linear`` over the applications;
``embed`` and ``final_norm``; projections, the conv and the embedding in
``cfg.param_dtype``, norm scales and the per-head ``a_log``, ``dt_bias``,
``d_skip`` in float32.  ``init`` draws them on its device layer by layer:
no float32 copy of the model exists.

Profiler ranges, siblings as ``mla.*`` are: ``ssm.project`` (the norm and
the residual adds, the in-projection, conv, dt, gated norm and
out-projection), ``ssm.scan`` (the SSD and the D skip), ``zamba2.shared``
(the concat and its norm, q/k/v/o, rope, the MLP and adapter, ``linear``)
and ``zamba2.attend`` (the attention call alone).  ``zamba2_stats`` counts
on the host.  ``models/taps.py`` receives ``embed``, ``mamba``, ``shared``
and ``head``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..configs.base import ModelConfig
from ..core.inference import resolve_device
from ..distributed.constrain import is_dtensor
from ..kernels import ssd_scan
from . import layers as L
from . import ssm, taps
from .layers import embed_tokens, layer_params, split_heads, stack_layers

__all__ = ["init", "forward", "loss_fn", "prefill", "init_caches",
           "decode_step", "mamba_layer", "shared_block", "gated_norm",
           "softmax_scale", "ssd", "ssd_kernel_applies", "zamba2_stats",
           "Zamba2Stats"]

Params = Dict[str, Any]

GATED_EPS = 1e-5  # the published mixer's gated norm (fixed in its code)
SSD_CHUNK = ssd_scan.CHUNK  # positions a chunk of the SSD holds, both forms


class Zamba2Stats:
    """Counters of the Zamba2 passes since the last :meth:`reset`: tokens
    (rows × positions of each pass), Mamba layer calls, SSD chunks (rows ×
    chunks of each chunked layer call), the prefill SSDs by path
    (``ssd_kernel``, the hand-written scan; ``ssd_plain``,
    ``ssm.ssd_grouped``) and shared-block applications by block.  Host
    integers from the shapes (no device read)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.tokens = self.mamba_layers = self.ssd_chunks = 0
        self.ssd_kernel = self.ssd_plain = 0
        self.shared: Dict[int, int] = {}


#: the Zamba2 passes' counters (``zamba2_stats.reset()`` to start a count)
zamba2_stats = Zamba2Stats()


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head dim, groups, state) of a Mamba layer."""
    d_in = cfg.ssm_expand * cfg.d_model
    return (d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim,
            cfg.mamba_ngroups, cfg.ssm_state)


def _check(cfg: ModelConfig) -> None:
    if cfg.use_shared_attention_adapter:
        raise NotImplementedError("zamba2: the q/k/v adapters "
                                  "(use_shared_attention_adapter)")
    if cfg.n_kv_heads != cfg.n_heads:
        raise ValueError("zamba2: one key head per query head")
    if cfg.attention_hidden_size != 2 * cfg.d_model:
        raise ValueError("zamba2: the shared blocks take [hidden ‖ "
                         "embedding], 2·d_model wide")
    _, h, _, g, _ = _dims(cfg)
    if h % g:
        raise ValueError(f"zamba2: {h} heads do not split into {g} groups")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _plan(cfg: ModelConfig) -> Dict[str, list]:
    """Each stacked part's leaves in draw order: (path, shape, kind), kind
    ``proj`` (N(0, 1/fan_in)), ``scale`` (ones), ``conv`` (N(0, 0.2)),
    ``zero``, ``a_log``, ``dt_bias`` or ``ones``."""
    d, f = cfg.d_model, cfg.d_ff
    d_in, h, _, g, n = _dims(cfg)
    conv = d_in + 2 * g * n
    hd = cfg.n_heads * cfg.head_dim
    mamba = [(("ln", "scale"), (d,), "scale"),
             (("in_proj", "w"), (d, d_in + conv + h), "proj"),
             (("conv_w",), (cfg.conv_width, conv), "conv"),
             (("conv_b",), (conv,), "zero"),
             (("a_log",), (h,), "a_log"),
             (("dt_bias",), (h,), "dt_bias"),
             (("d_skip",), (h,), "ones"),
             (("out_norm",), (d_in,), "scale"),
             (("out_proj", "w"), (d_in, d), "proj")]
    shared = [(("ln1", "scale"), (2 * d,), "scale"),
              (("wq", "w"), (2 * d, hd), "proj"),
              (("wk", "w"), (2 * d, hd), "proj"),
              (("wv", "w"), (2 * d, hd), "proj"),
              (("wo", "w"), (hd, d), "proj"),
              (("ln2", "scale"), (d,), "scale"),
              (("gate_up", "w"), (d, 2 * f), "proj"),
              (("down", "w"), (f, d), "proj")]
    apps = [(("linear", "w"), (d, d), "proj")]
    if cfg.use_shared_mlp_adapter:
        r = cfg.adapter_rank
        apps += [(("adapter_a", "w"), (d, r), "proj"),
                 (("adapter_b", "w"), (r, 2 * f), "proj")]
    return {"mamba": mamba, "shared": shared, "apps": apps}


_FLOAT32_KINDS = ("scale", "a_log", "dt_bias", "ones")


def _draw(shape, kind: str, gen, device) -> torch.Tensor:
    if kind == "proj":
        return torch.randn(shape, generator=gen, device=device).mul_(
            1.0 / math.sqrt(shape[0]))
    if kind == "conv":
        return torch.randn(shape, generator=gen, device=device).mul_(0.2)
    if kind == "a_log":  # A = −1 … −H, the published initialisation
        return torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                      device=device))
    if kind == "dt_bias":  # softplus⁻¹ of dt log-uniform in [1e-3, 0.1]
        u = torch.rand(shape, generator=gen, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    fill = 0.0 if kind == "zero" else 1.0
    return torch.full(shape, fill, dtype=torch.float32, device=device)


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def init(generator: torch.Generator, cfg: ModelConfig,
         device="cuda") -> Params:
    """Seeded parameters: every stacked leaf allocated once in its dtype
    and filled layer by layer from float32 draws (``generator`` lives on
    ``device``; ``"meta"`` with ``generator=None`` draws nothing)."""
    _check(cfg)
    dev = resolve_device(device)
    pdt = getattr(torch, cfg.param_dtype)
    plan = _plan(cfg)
    n_app = len(cfg.hybrid_layer_ids)
    counts = {"mamba": cfg.n_layers, "shared": cfg.num_mem_blocks,
              "apps": n_app}
    meta = dev.type == "meta"
    params: Params = {
        "embed": torch.empty((cfg.vocab_size, cfg.d_model), dtype=pdt,
                             device=dev),
        "final_norm": {"scale": torch.ones(cfg.d_model, device=dev)}}
    if not meta:
        params["embed"].copy_(torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=generator,
            device=dev).mul_(0.02))
    for part, leaves in plan.items():
        tree: dict = {}
        for path, shape, kind in leaves:
            dtype = torch.float32 if kind in _FLOAT32_KINDS else pdt
            _set(tree, path, torch.empty((counts[part], *shape),
                                         dtype=dtype, device=dev))
        for i in range(0 if meta else counts[part]):
            for path, shape, kind in leaves:
                _get(tree, path)[i].copy_(_draw(shape, kind, generator, dev))
        if part == "apps":
            params.update(tree)
        else:
            params[part] = tree
    return params


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
               groups: int, eps: float = GATED_EPS) -> torch.Tensor:
    """``y·SiLU(z)`` in float32, then RMS-normalised over each of
    ``groups`` equal runs of channels, times ``w``; in ``y``'s dtype."""
    g = y.to(torch.float32) * F.silu(z.to(torch.float32))
    g = g.unflatten(-1, (groups, -1))
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + eps)
    return (g.flatten(-2) * w).to(y.dtype)


def ssd_kernel_applies(xh, bmat, cmat, dt, a) -> bool:
    """Whether :func:`ssd`'s prefill goes to the scan kernel: the operands
    are on the card and none of :func:`_plain_only`'s refusals holds.  The
    kernel computes such a call or raises on what
    ``kernels.ssd_scan.kernel_applies`` refuses: the card has no silent
    plain form."""
    return xh.is_cuda and not _plain_only(xh, bmat, cmat, dt, a)


def _plain_only(*ops: torch.Tensor) -> bool:
    """Whether a call must run the plain ops on any device: an operand is a
    DTensor, autograd records a graph through one (the kernel has no
    backward), or a dispatch mode (the dry run's cost counter, fake
    tensors) is active, which must see them."""
    return ((torch.is_grad_enabled() and any(t.requires_grad for t in ops))
            or any(is_dtensor(t) for t in ops)
            or _get_current_dispatch_mode() is not None)


def ssd(xh, bmat, cmat, dt, a, chunk: int, state=None):
    """The SSD of one layer in float32: xh (B,T,H,dh), bmat/cmat
    (B,T,G,N) in the activation dtype, dt (B,T,H) and a (H,) float32.
    Without ``state`` the chunked form over the sequence from a zero
    state — the scan kernel where :func:`ssd_kernel_applies`, else
    ``ssm.ssd_grouped`` in chunks of ``chunk`` — else one recurrent step
    from ``state`` (T = 1).  Returns y (B,T,H,dh) float32 and the state
    after the last position."""
    f32 = torch.float32
    if state is None:
        if ssd_kernel_applies(xh, bmat, cmat, dt, a):
            out = ssd_scan.ssd_scan(xh, bmat, cmat, dt, a)
            zamba2_stats.ssd_kernel += 1
            return out
        zamba2_stats.ssd_plain += 1
        return ssm.ssd_grouped(xh.to(f32), bmat.to(f32), cmat.to(f32), dt,
                               a, chunk)
    y, s = ssm.ssd_step_grouped(state, xh[:, 0].to(f32), bmat[:, 0].to(f32),
                                cmat[:, 0].to(f32), dt[:, 0], a)
    return y[:, None], s


def mamba_layer(p: Params, h: torch.Tensor, t: Optional[torch.Tensor],
                cfg: ModelConfig, *, state: Optional[Params] = None,
                keep_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One Mamba layer: ``h + Mixer(RMSNorm(h + t))``.  With ``state``
    ({"conv", "s"}) one decode step; ``keep_state`` returns the state a
    prefill leaves.  Returns (h, state or None)."""
    b, s, _ = h.shape
    d_in, nh, dh, g, n = _dims(cfg)
    with record_function("ssm.project"):
        x_in = h if t is None else h + t
        u = L.norm(p["ln"], x_in, cfg)
        zxbcdt = L.linear(p["in_proj"], u, cfg)
        z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, nh], -1)
        xbc, conv_new = ssm._causal_conv(
            xbc, p["conv_w"], p["conv_b"],
            None if state is None else state["conv"])
        x, bmat, cmat = torch.split(F.silu(xbc), [d_in, g * n, g * n], -1)
        dt = ssm._softplus(dt.to(torch.float32) + p["dt_bias"])
        a = -torch.exp(p["a_log"])
        xh = x.reshape(b, s, nh, dh)
    with record_function("ssm.scan"):
        y, s_new = ssd(xh, bmat.reshape(b, s, g, n), cmat.reshape(b, s, g, n),
                       dt, a, SSD_CHUNK, None if state is None else state["s"])
        y = y.to(h.dtype) + xh * p["d_skip"][:, None].to(h.dtype)
    with record_function("ssm.project"):
        mix = L.linear(p["out_proj"], gated_norm(y.reshape(b, s, d_in), z,
                                                 p["out_norm"], g), cfg)
        out = h + mix
    zamba2_stats.mamba_layers += 1
    if state is None:
        zamba2_stats.ssd_chunks += b * -(-s // SSD_CHUNK)
    taps.tap("mamba", h, *(() if t is None else (t,)), u, mix, out)
    if state is None and not keep_state:
        return out, None
    return out, {"conv": conv_new, "s": s_new}


# ---------------------------------------------------------------------------
# the shared blocks
# ---------------------------------------------------------------------------


def softmax_scale(cfg: ModelConfig) -> float:
    """The shared attention's softmax scale, (head_dim / 2)^-½ (its input
    is twice the model's width)."""
    return (cfg.head_dim / 2) ** -0.5


def _attend(q, k, v, pos, cache):
    """Causal attention of q, k, v (B,S,H,D), q pre-scaled.  Without a
    cache the flash form over the sequence; with one (a prefill's fresh
    cache, or decode at ``pos`` (B,)) K and V are written at their
    positions first.  Returns (out (B,S,H,D), cache)."""
    from .flash import flash_attention

    if cache is None or pos is None:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), True, 512).transpose(1, 2)
        if cache is not None:
            s = q.shape[1]
            cache = {key: torch.cat([new.to(cache[key].dtype),
                                     cache[key][:, s:]], dim=1)
                     for key, new in (("k", k), ("v", v))}
        return out, cache
    cache = {"k": L._cache_write(cache["k"], k, pos),
             "v": L._cache_write(cache["v"], v, pos)}
    kc, vc = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kc).to(torch.float32)
    valid = (torch.arange(kc.shape[1], device=q.device)[None, :]
             <= pos.to(q.device)[:, None])
    logits = logits.masked_fill(~valid[:, None, None, :], L._NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vc), cache


def shared_block(params: Params, j: int, h: torch.Tensor, e: torch.Tensor,
                 cfg: ModelConfig, *, pos: Optional[torch.Tensor] = None,
                 cache: Optional[Params] = None
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Application ``j``: block ``j % num_mem_blocks`` on ``[h ‖ e]``
    with adapter ``j`` and ``linear`` ``j``.  Returns (t, the KV cache)."""
    bi = j % cfg.num_mem_blocks
    p = layer_params(params["shared"], bi)
    b, s, _ = h.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    with record_function("zamba2.shared"):
        hc = torch.cat([h, e], dim=-1)
        c = L.norm(p["ln1"], hc, cfg)
        q = split_heads(L.linear(p["wq"], c, cfg), nh, hd)
        k = split_heads(L.linear(p["wk"], c, cfg), nh, hd)
        v = split_heads(L.linear(p["wv"], c, cfg), nh, hd)
        if cfg.use_mem_rope:
            pos_arr = (torch.arange(s, device=h.device)[None].expand(b, s)
                       if pos is None else pos[:, None])
            q = L.rope(q, pos_arr, cfg.rope_theta)
            k = L.rope(k, pos_arr, cfg.rope_theta)
        q = q * torch.full((), softmax_scale(cfg), dtype=q.dtype,
                           device=q.device)
    with record_function("zamba2.attend"):
        out, cache = _attend(q, k, v, pos, cache)
    with record_function("zamba2.shared"):
        a = L.linear(p["wo"], out.reshape(b, s, nh * hd), cfg)
        m = L.norm(p["ln2"], a, cfg)
        gu = L.linear(p["gate_up"], m, cfg)
        if cfg.use_shared_mlp_adapter:
            gu = gu + L.linear(layer_params(params["adapter_b"], j),
                               L.linear(layer_params(params["adapter_a"], j),
                                        m, cfg), cfg)
        gate, up = gu.chunk(2, dim=-1)
        t = L.linear(p["down"], F.gelu(gate) * up, cfg)
        t = L.linear(layer_params(params["linear"], j), t, cfg)
    zamba2_stats.shared[bi] = zamba2_stats.shared.get(bi, 0) + 1
    taps.tap("shared", hc, a, t)
    return t, cache


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _trunk(params: Params, tokens, cfg: ModelConfig, *,
           caches: Optional[Params] = None,
           pos: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The hidden states after the last layer, before the final norm.
    With ``caches``: a prefill from position 0 that fills them (``pos``
    None) or one decode step at ``pos``; returns the new caches."""
    _check(cfg)
    e = embed_tokens(params, tokens, cfg)
    zamba2_stats.tokens += e.shape[0] * e.shape[1]
    taps.tap("embed", e)
    apps = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}
    step = caches is not None and pos is not None
    m_new, a_new = [], []
    h = e
    for i in range(cfg.n_layers):
        t = None
        j = apps.get(i)
        if j is not None:
            kv = None if caches is None else layer_params(caches["attn"], j)
            t, kv = shared_block(params, j, h, e, cfg, pos=pos, cache=kv)
            a_new.append(kv)
        state = layer_params(caches["mamba"], i) if step else None
        h, st = mamba_layer(layer_params(params["mamba"], i), h, t, cfg,
                            state=state, keep_state=caches is not None)
        m_new.append(st)
    if caches is None:
        return h, None
    return h, {"mamba": stack_layers(m_new), "attn": stack_layers(a_new)}


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.tied_unembed(params, L.norm(params["final_norm"], x, cfg))


def forward(params: Params, tokens, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits at every position (B, S, V) and a zero auxiliary loss."""
    h, _ = _trunk(params, tokens, cfg)
    return _head(params, h, cfg), torch.zeros((), dtype=torch.float32,
                                              device=h.device)


def loss_fn(params: Params, batch, cfg: ModelConfig):
    h, _ = _trunk(params, batch["tokens"], cfg)
    ce = L.tied_lm_loss(params, L.norm(params["final_norm"], h, cfg), batch)
    return ce, {"loss": ce, "ce": ce}


def prefill(params: Params, tokens, cfg: ModelConfig, *,
            caches: Optional[Params] = None):
    """Last-position logits (B, 1, V) of the whole prompt; with fresh
    ``caches`` (``init_caches``) also the caches it leaves for
    ``decode_step`` at position S."""
    h, new = _trunk(params, tokens, cfg, caches=caches)
    x = h[:, -1:]
    logits = _head(params, x, cfg)
    taps.tap("head", x, logits)
    return logits if caches is None else (logits, new)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                device="cuda") -> Params:
    """Per Mamba layer the conv window (``conv``, the activation dtype) and
    the SSD state (``s``, float32), stacked over the layers; per
    application a KV cache of ``max_seq`` positions (``attn``)."""
    _check(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    d_in, nh, dh, g, n = _dims(cfg)
    mamba = {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                             d_in + 2 * g * n), dtype=dtype, device=dev),
        "s": torch.zeros((cfg.n_layers, batch, nh, dh, n), device=dev),
    }
    shape = (len(cfg.hybrid_layer_ids), batch, max_seq, cfg.n_heads,
             cfg.head_dim)
    return {"mamba": mamba,
            "attn": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def decode_step(params: Params, caches: Params, tokens, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One token per row: tokens (B, 1) at positions ``pos`` (B,) →
    logits (B, 1, V) and new caches (the inputs stay)."""
    pos = torch.as_tensor(pos, device=params["embed"].device)
    h, new = _trunk(params, tokens, cfg, caches=caches, pos=pos)
    return _head(params, h, cfg), new
