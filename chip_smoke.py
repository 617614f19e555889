"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

  1. device  — a CUDA card must be visible; prints its name and power limit.
  2. build   — compiles every hand-written kernel of the paths with nvcc
               (one process per source, all started together) into
               build/kernels/, and logs registers, shared memory and spills.
  3. kernels — each kernel against its plain PyTorch versions on the card, on
               the same inputs, at the serving shapes and at edge shapes:
               results must be equal (torch.equal — integer codes, zero
               tolerance).  The fused MLP kernel in both weight lanes; the
               two forest kernels (pointer chase and range table) against
               the gather and the masked plain versions, on random, trained,
               saturating, stump and padded tables, with slots uniform and
               every packet on one forest, at the range kernel's lane edges
               (T = 1, 15, 17, 32, 33, 64), W = 33 and 128, range tables
               beyond the staging limit (T = 128) and a chase of N = 256
               at depth 8, and against the masked versions alone on tables
               that install_forest rejects, with slots outside [0, F)
               (some, and all of them); the
               flow-update kernel against ref.flow_update_ref (state, sketch
               and features) on random, one-flow, all-distinct, dead-row,
               non-monotone and saturating batches of 1–8193 packets, and
               an empty batch that must launch nothing; the W8A8 GEMM
               against ref.fixedpoint_matmul_ref on the qwen2-1.5b
               projections at M ∈ {1, 17, 64, 65, 255, 2048} (split-K at
               decode-sized M on the long K), ragged shapes
               (K % 16 != 0: zero codes appended to K, two counted
               copies), both weight layouts (one counted copy for a
               row-major w), raw int8 codes at unit
               scales against an exact int64 product (K = 8960 at splits
               1–35), a bfloat16 activation, and the shapes of the hybrid
               and encoder–decoder paths (zamba2's in_dt N = 80 and in_bc
               N = 128, in_z, out_proj K = 5120, the shared MLP's up and
               down K = 10240 with split-K at decode-sized M; whisper's
               attention and MLP) at M ∈ {1, 8, 8192}; the Taylor activation against
               its plain version at orders 1/3/5/7 × x_frac 0/8/12/16 over
               1 to 2048·8960 codes that straddle its clamp, and a case
               whose Horner products wrap int32; the WKV chunk scan (float,
               so within rtol = atol = 2e-5, the reference's tolerance)
               against ref.wkv_scan_ref at the reference's three test
               shapes, the rwkv6-3b prefill geometry (B·H = 160, 32 chunks
               of 64, D = 64), C = 16 and C = 256, one row of one chunk and
               a ragged C and D, plus its state carry across chunks and an
               empty input that must launch nothing; flash attention's
               forward (bf16) at the three LM cells' shapes (qwen2-1.5b's
               4 × 12/2 heads × 2048 × (128, 128), deepseek-v2's MLA
               4 × 128 × 4096 × (192, 128), kimi-linear's MLA
               2 × 32 × 16384 × (192, 128)) against flash_attention's plain
               path on the same grouped K/V: out within 2^-5, lse within
               1e-5, no farther from float64 attention than the plain form
               × 1.05, a second call bit-equal; the row quantize (the W8A8
               linear's activation codes and scales) against the plain
               chain bit for bit at the qwen2 prefill's two shapes
               (8192 × 1536 and × 8960, bf16, 4 and 8 bits), K = 8961, fp16
               and fp32.
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
               forest batches.  Then the raw-packet flow engine
               (PacketServer.submit_raw → flow-update kernel → FeatureSpec
               gather → MLP and forest lanes) against the CPU port on the
               same calls:
                 * 200k raw packets over 8192 flows with strict Model IDs
                   (one flow in 17 on an uninstalled id), a FeatureSpec and
                   a forest reinstall mid-trace: egress and error slots,
                   final registers and sketch equal, recompiles flat;
                 * 50k packets into a 4096-slot table with an idle timeout:
                   expiry, eviction and per-flow rejection all happen,
                   egress and error slots equal;
                 * 50k packets over 2048 flows through the one-dispatch
                   flow.serve_raw_fused on the card, against submit_raw on
                   a second card server: egress and registers equal.
               Then the sharded fabric (ShardedPacketServer, 4 shards on
               the one card, the PacketServer defaults, strict Model IDs)
               against the port's PacketServer(device="cpu") on the same
               calls:
                 * the flow 200k run's chunks with an MLP hot-swap and a
                   forest reinstall midway: egress and error slots, every
                   flow's registers over the union of the shards and the
                   fabric's sketch equal, every shard's recompiles flat,
                   one snapshot upload per generation on the card, int16,
                   range and flow_update launched on every shard; a
                   1-shard PacketServer on the card beside it;
                 * the same at 50k packets on the pointer chase;
                 * failover: 50k packets over 2048 flows, kill_shard(1)
                   halfway (every ticket equal to the oracle, the migrated
                   rows the dead shard's registers, survivors' recompiles
                   flat), then kills down to the last shard, which refuses;
                 * transient dispatch faults on every fifth event: the
                   drain equal to the unfaulted run, every shard retried;
                 * SLO budgets, reflex programs, a watermark and a capacity
                   with the "overload" site on shard 0: sheds only on shard
                   0's chunks, reflex rows equal to reflex_oracle,
                   model-lane rows equal to the oracle's;
                 * python -m repro_torch.launch.serve --shards 4 on the
                   card and on the CPU: the same metric names.
               Then the paper's C1/C2 library path at the width of
               qwen2-1.5b (d_model 1536, kv 256, d_ff 8960): quantize_tree
               on a seeded float32 decoder layer, matmul(x, leaf,
               "w8a8_int") for its 7 projections on 2048 seeded tokens
               (7 wgmma launches on the K-major codes quantize_tree stores,
               no layout copy; equal to the plain version on the card, equal
               to the CPU
               port at 17 tokens, NMSE against the float product below
               1e-3), and ops.taylor_activation on the 2048×8960 gate
               output at orders 1/3/5 (equal to the plain version; NMSE
               against the float sigmoid, order 5 below 1e-4 on
               [-1.5, 1.5]).  Then the RWKV-6 LM path at rwkv6-3b's full
               width and depth (32 layers, d_model 2560, seeded float32
               parameters): build_model(cfg).prefill on 4 × 2048 seeded
               tokens, one wkv_scan launch per layer; the kernel's float32
               form ("scan") against the reference model's bf16 chunked
               form at every depth from 1 to 32 layers (held at one layer,
               where the reference's 3e-2 applies); at all 32 layers the
               kernel against its plain version inside the model (the
               float32 prefill and forward with only ops.wkv_scan's backend
               changed, 1e-4) and each prefill WKV call on its own
               operands against the float64 plain version (2e-6), with the
               model's sensitivity to a 1e-6 nudge printed; decode_step
               against forward at 2 layers (0.08, the reference's); LMServer at
               batch 8 generating 16 greedy tokens, then 4 after a
               same-structure install with trace_count flat; the quantized
               prefill (quantize_tree, 2 layers: 16 fixedpoint_matmul
               launches, all wgmma with no layout copy, each equal to the
               plain version on the operands the path gave it, and 2
               wkv_scan launches; NMSE against the float logits below the
               reference's 0.15); and two
               layers at full width in float32 on the card against the CPU
               port (forward and prefill logits).  Then the transformer
               families: qwen2-1.5b at full width and depth (28 layers,
               seeded float32 parameters, bf16 activations):
               build_model(cfg).prefill on 4 × 2048 tokens (28
               flash_attention launches, the kernel taking every call; no
               other kernel of the port's own), the attention of one
               layer against F.scaled_dot_product_attention in turns,
               LMServer(batch=8, max_seq=256) generating 32 greedy tokens
               with a same-structure hot swap (trace_count flat), and the
               quantized prefill (quantize_tree at full depth: 196
               fixedpoint_matmul launches, all wgmma with no layout copy,
               each equal to the plain version on the operands the path
               gave it; 196 activation quantizes, every one on the row
               quantize kernel; NMSE at 2 layers below 0.15); the 7 transformer
               configs at full width, 2 layers (deepseek-v2: 1), float32,
               forward and prefill on the card against the CPU port
               (qwen2 also at T = 640, the padded flash route; chatglm3's
               int8 KV cache decode), decode against forward (MoE
               dropless, 0.03) and deepseek-v2's absorbed MLA against the
               expanded form (2e-3); granite-moe-3b-a800m at full depth
               (prefill 4 × 2048, the MoE layers' device time split by the
               profiler into expert GEMMs and routing, dispatch and
               combine); pixtral-12b at full width cut to 4 layers
               (prefill 4 × (256 patches + 1792 tokens)).  Then LM slice
               C: zamba2-2.7b at full width and depth (54 Mamba-2 layers,
               the shared block after every 6, seeded float32 parameters,
               bf16 activations): the prefill on 4 × 2048 tokens (no kernel
               of the port's own; the 54 SSD calls and the 9 shared-block
               attentions timed by CUDA events), LMServer(batch=8,
               max_seq=256) with a same-structure hot swap (trace_count
               flat), the quantized prefill at full depth (324
               fixedpoint_matmul launches, each equal to the plain version
               on the path's operands, no layout copy; NMSE at one group
               below 0.15) and long_500k (taylor_linear, batch 1: 16
               decode_steps up to position 2^19 with the state's bytes
               constant and no KV cache); whisper-base at full width and
               depth: prefill(frames=) on 8 × (1500 frames + 448 tokens)
               with its attention forms timed, precompute_cross and 64
               greedy decode_steps at batch 8, the quantized prefill (96
               launches, each equal to the plain version); and in float32
               on the card against the CPU port zamba2 cut to one group
               (forward, prefill, decode with full and Taylor-linear
               attention) and whisper at full depth (forward, prefill,
               decode after precompute_cross), 1e-3, decode against
               forward within the reference's 0.08 and 0.03.  Then
               kimi-linear-48b at its published widths cut to 4 layers
               (KDA, KDA, KDA, MLA; the first dense, then MoE of 256
               experts), bf16, on the Kimi cell's 2 × 16384 tokens: with
               the flash counters zeroed right before one prefill, the MLA
               layer's attention on the flash kernel (kernel calls and
               launches = MLA layers, none plain), the KDA and MoE
               counters as the layers give them, logits finite.  Then LM
               slice D, training (flash attention's forward on its
               kernel; its backward and AdamW are PyTorch ops):
               TrainLoop on qwen2-1.5b at full width and depth
               (float32 parameters, bf16 activations, remat in groups of
               4) on 4 × 2048 tokens a step, 6 steps with float32 moments
               and 6 with int8 moments: every loss finite, step 1's equal
               to loss_fn on the same batch (1e-6), tokens/s over steps
               2–6, each step, the flash forward and backward and the
               AdamW update timed by CUDA events, max_memory_allocated
               per mode; build_model(cfg).loss_fn's gradients at full
               width in float32 (qwen2-1.5b and granite-moe at 2 layers
               on 520 tokens, rwkv6-3b at 2 layers, zamba2 cut to one
               group on 520, whisper-base whole) against the CPU port,
               every leaf within 1e-3 of its largest |g| (rwkv6 3e-2: its
               bf16 cotangent rounding; MoE with the card's expert choices
               replayed on the CPU, a differing choice only at a near
               tie);
               examples/pt_train_lm.py (≈100M parameters, segmented
               order-3 Taylor, int8 moments) for 100 steps with a
               checkpoint and restart at 50: the loss must fall.
  5. numbers — per-kernel time (CUDA events: per call as the path issues
               it, and queued behind a device sleep, device only), the
               plain version's time, the least time the card could take
               (bytes or operations over its peak); for the forest kernels
               also with every packet on one forest, the range kernel's
               grouping-and-staging phase against the whole kernel
               (profiler), and an empty kernel queued (the launch floor);
               for the GEMM at all 7
               projection shapes and at M = 1 and 17 on up and down, the
               kernel and the library call (torch._int_mm + the rescale)
               timed in turns on one card; the WKV scan at the prefill
               geometry, its two device kernels split by the profiler;
               flash attention's forward at the LM cells' shapes, the
               kernel, the plain path and SDPA's fused backends timed in
               turns against the causal FLOP over the bf16 peak; the row
               quantize and the plain chain it replaces (with its float32
               scale cast) in turns at 8192 × 1536 and × 8960 against the
               bytes bound (3 B an element); also each
               path's packets per second with its engine-call and kernel
               shares of the wall time (for the fabric runs also each
               kernel's launches per shard and a 1-shard PacketServer's
               packets per second on the same calls); for the flow path also the longest
               flow chain of the
               timed batch, the register file's host↔card round trip and
               the share of the wall inside FlowFrontend.extract; for the
               LM path prefill and generate tokens per second and the WKV
               kernel's share of the prefill; for the transformer path
               prefill and decode tokens per second; for slice C the GEMM
               at its new shapes (M = 8192, 12000 for whisper, and 8)
               beside torch._int_mm + the rescale in turns, and each
               family's prefill and decode rates and the SSD and attention
               shares; for training, tokens/s, step ms, the flash shares,
               the AdamW ms and the peak memory of each moment mode.

Output: a JSON line of per-kernel numbers, the card's name and power limit,
and, as the last line, {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.paper_models import PAPER_MODELS, make_paper_model  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core.control_plane import ControlPlane  # noqa: E402
from repro_torch.core.fixedpoint import encode  # noqa: E402
from repro_torch.core.packet import HEADER_BYTES, encode_packets_np  # noqa: E402
from repro_torch.core.taylor import scaled_constants  # noqa: E402
from repro_torch.data.packets import (anomaly_dataset,  # noqa: E402
                                      parse_raw_headers, qos_dataset,
                                      raw_trace)
from repro_torch.flow import FlowTable  # noqa: E402
from repro_torch.forest import train_forest  # noqa: E402
from repro_torch.forest.synthetic import (random_forest_tables,  # noqa: E402
                                          rejected_tables, stack_ranges)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fixedpoint_mlp as fmlp  # noqa: E402
from repro_torch.kernels import flow_update as fuk  # noqa: E402
from repro_torch.kernels import forest_traversal as ftk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import row_quantize as ROW_QUANT  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD_SCAN  # noqa: E402
from repro_torch.kernels.ops import forest_traverse, fused_mlp  # noqa: E402
from repro_torch.kernels.ref import (FLOW_CODE_MAX,  # noqa: E402
                                     flow_update_ref,
                                     forest_range_gather_ref,
                                     forest_traverse_gather_ref,
                                     fused_mlp_gather_ref, fused_mlp_warp_ref,
                                     wkv_scan_ref)
from repro_torch.core.ingress import DEADLINE_SHED, PacketError  # noqa: E402
from repro_torch.core.packet import FLAG_REFLEX, emit_results_np  # noqa: E402
from repro_torch.launch.serve import (LMServer, PacketServer,  # noqa: E402
                                      ShardedPacketServer)
from repro_torch.serve import (FaultPlan, FaultSpec,  # noqa: E402
                               ReflexProgram, reflex_oracle)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import rwkv6, transformer  # noqa: E402
from repro_torch.models.layers import layer_params  # noqa: E402
from repro_torch.configs.base import remat_group_size  # noqa: E402
from repro_torch.core import tree as TREE  # noqa: E402
from repro_torch.launch.train import TrainLoop  # noqa: E402
from repro_torch.models import flash as FLASH  # noqa: E402
from repro_torch.kernels import flash_attention as FLASH_KERNEL  # noqa: E402
from repro_torch.optim import adamw as ADAMW  # noqa: E402
from repro_torch.distributed.constrain import activation_mesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    logical_batch_sharding, make_plan)
from repro_torch.launch.mesh import HW, make_mesh  # noqa: E402

# the C1/C2 kernel modules (``repro_torch.kernels`` exports their wrappers,
# which share the modules' names)
fmm = importlib.import_module("repro_torch.kernels.fixedpoint_matmul")
tak = importlib.import_module("repro_torch.kernels.taylor_activation")
wk = importlib.import_module("repro_torch.kernels.wkv_scan")

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
    "flow_update": dict(name="flow_update", route="cuda",
                        source="src/repro_torch/kernels/csrc/flow_update.cu",
                        replaces="src/repro/kernels/flow_update.py:132"),
    "fixedpoint_matmul": dict(
        name="fixedpoint_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/fixedpoint_matmul.cu",
        replaces="src/repro/kernels/fixedpoint_matmul.py:54"),
    "taylor_activation": dict(
        name="taylor_activation", route="cuda",
        source="src/repro_torch/kernels/csrc/taylor_activation.cu",
        replaces="src/repro/kernels/taylor_activation.py:52"),
    "wkv_scan": dict(
        name="wkv_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/wkv_scan.cu",
        replaces="src/repro/kernels/wkv_scan.py:67"),
    "flash_attention": dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/models/flash.py:58"),
    "row_quantize": dict(
        name="row_quantize", route="cuda",
        source="src/repro_torch/kernels/csrc/row_quantize.cu",
        replaces="none: src/repro/core/quantize.py::absmax_quantize is plain "
                 "jax.numpy"),
    "ssd_scan": dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="none: the chunked SSD of src/repro/models/ssm.py is plain "
                 "jax.numpy"),
}
SOURCES = ["fixedpoint_mlp", "forest_traversal", "flow_update",
           "fixedpoint_matmul", "taylor_activation", "wkv_scan",
           "flash_attention", "row_quantize", "ssd_scan"]

# one qwen2-1.5b decoder layer (src/repro/configs/qwen2_1_5b.py): d_model
# 1536, q_dim 12·128, kv_dim 2·128, d_ff 8960; leaf names as
# src/repro/models/layers.py:152-179 gives them
D_MODEL, KV_DIM, D_FF = 1536, 256, 8960
N_TOKENS = 2048
PROJECTIONS = {  # name: (path in the layer, K, N)
    "wq": (("attn", "wq"), D_MODEL, D_MODEL),
    "wk": (("attn", "wk"), D_MODEL, KV_DIM),
    "wv": (("attn", "wv"), D_MODEL, KV_DIM),
    "wo": (("attn", "wo"), D_MODEL, D_MODEL),
    "up": (("mlp", "up"), D_MODEL, D_FF),
    "gate": (("mlp", "gate"), D_MODEL, D_FF),
    "down": (("mlp", "down"), D_FF, D_MODEL),
}
TAYLOR_FRAC = 12  # x_frac of the Taylor pass, and the constants' scale

# the RWKV-6 LM family at rwkv6-3b's own width and depth
# (src/repro/configs/rwkv6_3b.py: 32 layers, d_model 2560, 40 heads of 64,
# d_ff 8960, vocab 65536, bf16 activations, float32 parameters); prefill on
# B sequences of T seeded tokens, so the WKV kernel runs at B·H = 160 rows
# of T / 64 = 32 chunks
LM_ARCH = "rwkv6-3b"
LM_BATCH, LM_SEQ = 4, 2048
# the WKV checks: the reference's three shapes (tests/test_wkv_kernel.py:
# 23-27), the prefill geometry, C = 16 and C = 256, one row of one chunk,
# and a ragged chunk and head dim
WKV_SHAPES = [(2, 4, 64, 64), (1, 8, 128, 64), (4, 2, 64, 32),
              (160, 32, 64, 64), (1, 3, 16, 64), (2, 2, 256, 64),
              (1, 1, 64, 64), (2, 3, 37, 48)]
WKV_TOL = 2e-5  # rtol = atol, the reference's (tests/test_wkv_kernel.py:33-34)
# relative error (max |Δ| / max |ref|) bounds of the LM path's comparisons
# the kernel's float32 form vs the bf16 chunked one at one layer, where the
# reference holds its kernel to 3e-2 (tests/test_wkv_kernel.py:81-83); the
# first full run measured 1.02e-2 there.  Deeper, random layers amplify the
# difference (0.22 at 32 layers), so the sweep by depth is printed, not held.
LM_SCAN_VS_CHUNKED = 2e-2
LM_CARD_VS_CPU = 1e-3      # 2 layers, float32 config: summation order only
# the kernel against its plain version at full depth, float32 activations:
# the same prefill and forward with only the WKV backend changed (the first
# measurement read 3.6e-5 and 2.2e-5)
LM_KERNEL_VS_REF = 1e-4
# each of the prefill's 32 WKV calls on its own operands against the plain
# version in float64: max |Δ| / max |exact|, about 16 float32 ulps of the
# largest output (the float32 plain version itself reads up to 3.9e-7)
LM_WKV_VS_EXACT = 2e-6
LM_DECODE_VS_PREFILL = 0.08  # the reference's (tests/test_arch_smoke.py:139)
# NMSE of the W8A8 model's logits against the float model's: the reference's
# budget for its quantized LM prefill (tests/test_arch_smoke.py:184, the
# paper's Fig-3 budget); the GEMM itself is held bit for bit
LM_QUANT_NMSE = 0.15

# the flow engine at the server's defaults: flow_capacity_pow2=14, a 2 x 4096
# count-min sketch, and the FlowParams shifts
FLOW_KW = dict(frac=FRAC, ewma_shift=3, byte_shift=6, dur_shift=10)
N_FLOWS = 8192
# FeatureSpecs as the reference's flow benchmark installs them
# (benchmarks/bench_fig1_throughput.py:708-711): the converging register
# lanes, EWMAs and min/max, in two orders
MLP_SPEC = (2, 3, 4, 5) * (WIDTH // 4)
FOREST_SPEC = (4, 5, 2, 3) * (WIDTH // 4)
SWAPPED_SPEC = (0, 7, 1, 6) * (WIDTH // 4)


def log(msg: str) -> None:
    print(msg, flush=True)


def sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def reset_launches() -> None:
    for mod in (fmlp, ftk, fuk, fmm, tak, wk):
        mod.reset_launches()


def read_launches() -> dict:
    return {**fmlp.launches, **ftk.launches, **fuk.launches, **fmm.launches,
            **tak.launches, **wk.launches}


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


def check_mlp_edges(dev) -> dict:
    """The MLP kernel at W ∈ {1, 31, 32, 33, 128} in both lanes, on tables
    where every model's layers run every opcode (0–4 and an unknown 7), the
    middle layers are off for some models, and slots outside [0, M) (which
    return the lane-clamped input): against ref.fused_mlp_warp_ref (the
    kernel's decomposition) and the masked plain version on every row, and
    the gather form on the rows with valid slots.  Returns the largest
    absolute difference per lane (must be 0)."""
    rng = np.random.default_rng(SEED + 9)
    worst = {"int16": 0, "int8": 0}
    n_models, n_layers = 16, 6
    for variant in worst:
        lane = 8 if variant == "int8" else None
        for width in (1, 31, 32, 33, 128):
            c = make_case(rng, dev, n_batch=1001, n_models=n_models,
                          n_layers=n_layers, width=width, variant=variant)
            ops_ = np.asarray([0, 1, 2, 3, 4, 7], np.int32)
            c["act"] = torch.as_tensor(np.stack([np.roll(ops_, m) for m in
                                                 range(n_models)]), device=dev)
            on = np.ones((n_models, n_layers), np.int32)
            on[::2, 1:-1] = 0  # middle layers off for the even models
            c["layer_on"] = torch.as_tensor(on, device=dev)
            slot = c["slot"].clone()
            slot[:40] = torch.as_tensor(np.resize(
                [n_models, -1, 999, -2 ** 31, 2 ** 31 - 1], 40), device=dev)
            c["slot"] = slot
            kw = kernel_kw(5)
            got = fmlp.fixedpoint_mlp(**c, **kw, variant=variant)
            warp = fused_mlp_warp_ref(**c, **kw, lane_bits=lane)
            masked = fused_mlp(c["x_q"], c["slot"], c["w"], c["b"], c["act"],
                               c["layer_on"], backend="ref", variant=variant,
                               **kw)
            valid = (slot >= 0) & (slot < n_models)
            gather = fused_mlp_gather_ref(
                c["x_q"][valid], slot[valid], c["w"], c["b"], c["act"],
                c["layer_on"], **kw, lane_bits=lane)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - warp.to(torch.int64)).abs().max())
            worst[variant] = max(worst[variant], err)
            ok = (torch.equal(got, warp) and torch.equal(got, masked)
                  and torch.equal(got[valid], gather))
            log(f"kernel {variant:5s} B=1001 M={n_models} L={n_layers} "
                f"W={width:3d}, every opcode, middle layers off, 40 slots "
                f"outside [0, M): {'equal' if ok else 'DIFFERS'} (max_abs_err "
                f"{err})")
            if not ok:
                raise SystemExit(f"fixedpoint_mlp {variant} differs from its "
                                 f"plain versions at W={width}")
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


# the lane and layout edges of the forest kernels: (F, T, N, W, depth, NI,
# L) — the range kernel's lane split changes at T = 16 and T = 32, NI = 31
# and depth 6 are compiled in, W = 33 and 128 give a lane more than one
# output column, T = 128 range tables exceed the staging limit (global
# path), and N = 256 at depth 8 is a chase beyond the serving tables
FOREST_EDGES = [(4, 1, 16, 32, 4, 7, 8), (4, 15, 16, 32, 5, 31, 32),
                (4, 17, 16, 32, 5, 31, 32), (3, 32, 16, 32, 4, 7, 8),
                (3, 33, 16, 32, 4, 7, 8), (2, 64, 16, 32, 4, 1, 8),
                (2, 16, 64, 128, 6, 31, 32), (2, 16, 64, 33, 6, 7, 8),
                (2, 128, 64, 32, 6, 31, 32), (2, 64, 256, 32, 8, 31, 32)]


def edge_tables(rng, extent):
    """Random tables at ``extent``; range tables of depth-5 trees where the
    chase's trees have more leaves than the 32-bit leaf mask holds."""
    n_forests, n_trees, n_nodes, width, depth, ni, nl = extent
    nodes, tree_on, mode = random_forest_tables(
        rng, n_forests, width, depth, n_trees=n_trees, n_nodes=n_nodes)
    try:
        ranges = stack_ranges(nodes, tree_on, depth, n_entries=ni,
                              n_leaves=nl)
    except ValueError:
        shallow, on5, _ = random_forest_tables(
            rng, n_forests, width, 5, n_trees=n_trees, n_nodes=n_nodes)
        ranges = stack_ranges(shallow, on5, 5, n_entries=ni, n_leaves=nl)
    return nodes, tree_on, mode, ranges


def check_forest_kernels(dev, trained) -> dict:
    rng = np.random.default_rng(SEED + 3)
    worst = {"chase": 0, "range": 0}

    def held(errs):
        for v in errs:
            worst[v] = max(worst[v], errs[v])

    extents = [(F, T, N, WIDTH, DEPTH, NI, NL),   # the serving extents
               (3, 5, 16, 8, 4, 7, 8)]           # a small one
    for e, extent in enumerate(extents):
        cases = table_cases(rng, extent, trained if e == 0 else None)
        bad = rejected_tables(rng, *extent)
        for n_batch in (1, 127, 2048, 4099):
            for name, nodes, tree_on, mode, ranges, depth in cases:
                x, slot = forest_inputs(rng, n_batch, extent[3], extent[0])
                held(check_forest(dev, name, x, slot, nodes, tree_on, mode,
                                  ranges, depth, gather=True))
                if name in ("trained", "random"):  # every packet on one
                    held(check_forest(dev, f"{name}-one", x,
                                      np.full_like(slot, extent[0] - 1),
                                      nodes, tree_on, mode, ranges, depth,
                                      gather=True))
            x, _ = forest_inputs(rng, n_batch, extent[3], extent[0])
            slot = rng.integers(-2, extent[0] + 3, n_batch).astype(np.int32)
            held(check_forest(dev, "rejected", x, slot, *bad, extent[4],
                              gather=False))
            held(check_forest(dev, "outside", x,
                              np.full_like(slot, extent[0]), *bad,
                              extent[4], gather=False))
    for extent in FOREST_EDGES:
        nodes, tree_on, mode, ranges = edge_tables(rng, extent)
        bad = rejected_tables(rng, *extent[:5], ranges[0].shape[-1],
                              ranges[3].shape[-1])
        for n_batch in (127, 2048):
            x, slot = forest_inputs(rng, n_batch, extent[3], extent[0])
            held(check_forest(dev, f"T={extent[1]}", x, slot, nodes,
                              tree_on, mode, ranges, extent[4], gather=True))
            held(check_forest(dev, f"T={extent[1]}-one", x,
                              np.zeros_like(slot), nodes, tree_on, mode,
                              ranges, extent[4], gather=True))
            slot = rng.integers(-2, extent[0] + 3, n_batch).astype(np.int32)
            held(check_forest(dev, f"T={extent[1]}-rej", x, slot, *bad,
                              extent[4], gather=False))
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


def range_phases(x, slot, ranges, tree_on, mode) -> dict:
    """The range kernel's device time (profiler, 20 calls) beside its
    grouping-and-staging phase alone (the same kernel stopped there,
    ``forest_range_prologue_launch``), ms per call each."""
    lib = ftk.load_library()
    n_batch, width = x.shape
    n_forests, n_trees, n_entries = ranges[0].shape
    n_leaves = ranges[3].shape[-1]
    chunk, staged = ftk.plan(n_batch, n_trees, n_entries, n_leaves, sms())
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in (x, slot, *ranges, tree_on, mode, out)]
    stream = torch.cuda.current_stream().cuda_stream
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            ftk.forest_range(x, slot, *ranges, tree_on, mode, frac=FRAC)
            rc = lib.forest_range_prologue_launch(
                *ptrs, n_batch, n_forests, n_trees, n_entries, n_leaves,
                width, FRAC, chunk, int(staged), stream)
            if rc != 0:
                raise SystemExit(f"range prologue launch failed: {rc}")
        torch.cuda.synchronize()
    phases = {}
    for e in prof.key_averages():
        m = re.search(r"forest_range_kernel<\d+, \w+, (true|false)>", e.key)
        if m and e.count:
            key = "grouping and staging" if m.group(1) == "true" else "kernel"
            phases[key] = e.device_time_total / e.count / 1e3
    return phases


# ---------------------------------------------------------------------------
# flow-update kernel inputs, checks and timing
# ---------------------------------------------------------------------------


def flow_batch(rng, n, n_slots, cms_shape, case):
    """One flow-update batch on the host: a random pre-populated state (the
    reference tests' recipe) and a batch shaped by ``case``."""
    depth, width_c = cms_shape
    state = np.zeros((n_slots, 8), np.int32)
    pre = int(rng.integers(0, n_slots + 1))
    state[:pre] = rng.integers(0, 5000, (pre, 8))
    state[:pre, 0] = rng.integers(0, 5, pre)
    cms = rng.integers(0, 100, cms_shape).astype(np.int32)
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    cells = rng.integers(0, width_c, (n, depth)).astype(np.int32)
    ts = np.cumsum(rng.integers(0, 100, n)).astype(np.int32)
    length = rng.integers(0, 2000, n).astype(np.int32)
    live = np.ones(n, np.int32)
    if case == "one_flow":       # one chain of length n
        slots[:] = int(rng.integers(0, n_slots))
    elif case == "distinct":     # every packet its own flow
        slots = rng.permutation(n_slots)[:n].astype(np.int32)
    elif case == "dead":         # about 15% padding rows
        live = (rng.random(n) > 0.15).astype(np.int32)
    elif case == "dead_interleaved":  # every other row padding
        live[1::2] = 0
    elif case == "one_cell":     # every packet in one cell of each row
        cells[:] = cells[0]
    elif case == "non_monotone":
        ts = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    elif case == "saturation":   # the reference's test_saturation_never_wraps
        state[:] = [FLOW_CODE_MAX - 1, FLOW_CODE_MAX - 1, 0, 0,
                    FLOW_CODE_MAX, FLOW_CODE_MAX, 1, FLOW_CODE_MAX >> FRAC]
        cms[:] = FLOW_CODE_MAX
        ts[:] = 2 ** 31 - 1
        length[:] = 65535
    return state, cms, slots, cells, ts, length, live


def check_flow(dev, args, label: str) -> int:
    """The flow kernel against ref.flow_update_ref on the card; returns the
    largest absolute difference over state, sketch and features."""
    args = _dev(dev, *args)
    got = fuk.flow_update_kernel(*args, **FLOW_KW)
    want = flow_update_ref(*args, **FLOW_KW)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    ok = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"kernel flow_update {label}: {'equal' if ok else 'DIFFERS'} to "
        f"ref.flow_update_ref in state, sketch and features "
        f"(max_abs_err {err})")
    if not ok:
        raise SystemExit(f"flow_update kernel differs from its plain version "
                         f"({label})")
    return err


def check_flow_kernels(dev) -> int:
    rng = np.random.default_rng(SEED + 6)
    worst = 0
    for n in (1, 127, 1001, 2048, 8192, 8193):
        for n_slots in (64, 16384):
            for cms_shape in ((2, 4096), (3, 64)):
                args = flow_batch(rng, n, n_slots, cms_shape, "random")
                worst = max(worst, check_flow(
                    dev, args, f"random B={n} S={n_slots} sketch={cms_shape}"))
        cms_shape = (2, 4096) if n % 2 else (3, 64)
        for case in ("one_flow", "distinct", "dead", "dead_interleaved",
                     "one_cell", "non_monotone", "saturation"):
            args = flow_batch(rng, n, 16384, cms_shape, case)
            worst = max(worst, check_flow(
                dev, args, f"{case} B={n} S=16384 sketch={cms_shape}"))
    # an empty batch launches nothing and passes the state through
    empty = _dev(dev, *flow_batch(rng, 0, 64, (2, 4096), "random"))
    before = fuk.launches["flow_update"]
    new_state, _, feats = fuk.flow_update_kernel(*empty, **FLOW_KW)
    torch.cuda.synchronize()
    if (fuk.launches["flow_update"] != before or feats.shape != (0, 8)
            or not torch.equal(new_state, empty[0])):
        raise SystemExit("flow_update: an empty batch launched or changed "
                         "the state")
    log("kernel flow_update B=0: no launch, state passed through")
    return worst


def flow_bound(n_live: int, args) -> tuple:
    """Least time for one flow-update call: the register file and the sketch
    read once and written once, the per-packet inputs read once and the
    features written once, over HBM bandwidth; vs the int32 operations the
    oracle does per live packet — 59 for the register update and the seven
    register features (clamps, shifts, the two rounding-shift EWMAs, the
    fresh / second-packet selects, min, max and the saturating counts) plus
    4 per sketch row and 3 for the estimate's code — over the CUDA cores'
    int32 rate."""
    state, cms, slots, cells, ts, length, live = args
    n = slots.shape[0]
    n_bytes = 2 * nbytes(state, cms) + nbytes(slots, cells, ts, length,
                                               live) + n * 8 * 4
    ops = n_live * (59 + 4 * cms.shape[0] + 3)
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


def flow_server(dev, forests, **kw):
    """PacketServer at its defaults on ``dev`` with the 8 MLPs (ids 1–8)
    and the 8 trained forests (ids 9–16), FeatureSpecs as the reference's
    flow benchmark installs them, and all three lane programs warmed."""
    srv = PacketServer(device=dev, **kw)
    install_models(srv, np.random.default_rng(SEED + 4), ids=MLP_IDS)
    for mid, forest in forests.items():
        srv.install_forest(mid, forest)
    for mid in MLP_IDS:
        srv.install_feature_spec(mid, MLP_SPEC)
    for mid in FOREST_IDS:
        srv.install_feature_spec(mid, FOREST_SPEC)
    srv.engine.warm(srv.ingress.batch_size, HEADER_BYTES + 4 * WIDTH,
                    lanes=("mlp", "forest", "both"))
    return srv


def flow_trace(n_packets: int, n_flows: int, ids) -> list:
    """A seeded raw 5-tuple trace (even flows periodic, odd flows bursty,
    Model IDs cyclic over the flows) cut into ragged chunks of 1–8192."""
    rng = np.random.default_rng(SEED + 5)
    raw = raw_trace(rng, n_packets, n_flows=n_flows, model_ids=tuple(ids),
                    pattern="mixed")
    cuts = np.unique(np.cumsum(rng.integers(1, 8193, n_packets // 256)))
    return np.split(raw, cuts[cuts < n_packets])


def egress_list(out) -> list:
    """Egress rows as bytes and error slots as their reasons, in order."""
    return [o.tobytes() if isinstance(o, np.ndarray) else o.reason
            for o in out]


def serve_flow(dev, chunks, forests, drifted=None, **server_kw) -> dict:
    """Serve raw chunks through submit_raw; with ``drifted``, reinstall one
    MLP's FeatureSpec and forest 9 at the midpoint.  The launch counters are
    zeroed right before the trace and read right after it."""
    srv = flow_server(dev, forests, **server_kw)
    flow = srv.flow
    timers = {"engine": 0.0, "extract": 0.0}

    def timed(fn, key):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timers[key] += time.perf_counter() - t
        return call

    srv.engine.run_features = timed(srv.engine.run_features, "engine")
    flow.extract = timed(flow.extract, "extract")
    mid = len(chunks) // 2
    rc_before = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i, chunk in enumerate(chunks):
        if i == mid and drifted is not None:
            rc_before = srv.stats()["recompiles"]
            srv.install_feature_spec(MLP_IDS[0], SWAPPED_SPEC)
            srv.install_forest(FOREST_IDS[0], drifted)
        srv.submit_raw(chunk)
    out = srv.drain_packets()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(server=srv, egress=egress_list(out), seconds=dt,
                engine_s=timers["engine"], extract_s=timers["extract"],
                launches=read_launches(), rc_before=rc_before,
                rc_after=srv.stats()["recompiles"],
                regs=flow.table.registers.copy(), cms=flow.cms.copy(),
                table={k: flow.table.stats[k] for k in (
                    "flow_created_total", "flow_expiries_total",
                    "flow_evictions_total", "flow_rejects_total")},
                lane_batches=dict(srv.ingress.stats["lane_batches"]))


def run_flow_path(dev, label: str, n_packets: int, card: str, forests,
                  drifted=None, **server_kw) -> dict:
    """The card's submit_raw run against the CPU port's on the same calls:
    egress and error slots must be equal, and the flow, MLP and forest
    kernels must all have launched on the card."""
    chunks = flow_trace(n_packets, N_FLOWS, list(MLP_IDS) + list(FOREST_IDS)
                        + [999])
    ref = serve_flow(torch.device("cpu"), chunks, forests, drifted,
                     **server_kw)
    run = serve_flow(dev, chunks, forests, drifted, **server_kw)
    same = run["egress"] == ref["egress"]
    n_err = sum(isinstance(e, str) for e in run["egress"])
    launches = {k: run["launches"][k] for k in ("int16", "range",
                                                "flow_update")}
    log(f"serve flow {label}: {n_packets} raw packets in {len(chunks)} "
        f"chunks, egress {'byte-identical' if same else 'DIFFERS'} to the "
        f"CPU port ({n_err} error slots); launches {launches}; lane batches "
        f"{run['lane_batches']}; flow table {run['table']}; recompiles "
        f"{run['rc_before']} -> {run['rc_after']}; "
        f"{n_packets / run['seconds']:.0f} packets/s on {dev} "
        f"({run['seconds']:.3f} s, of which {run['engine_s']:.3f} s inside "
        f"engine.run_features and {run['extract_s']:.3f} s inside "
        f"flow.extract); {n_packets / ref['seconds']:.0f} packets/s with the "
        f"port on the host CPU [{card}]")
    if not same:
        diff = [i for i, (a, b) in enumerate(zip(run["egress"],
                                                 ref["egress"])) if a != b]
        raise SystemExit(f"flow {label} egress differs at {len(diff)} "
                         f"packets, first {diff[:5]}")
    if not (np.array_equal(run["regs"], ref["regs"])
            and np.array_equal(run["cms"], ref["cms"])
            and run["table"] == ref["table"]):
        raise SystemExit(f"flow {label}: final registers, sketch or table "
                         "counters differ from the CPU port's")
    for k, v in launches.items():
        if v == 0:
            raise SystemExit(f"kernel {k} never launched on the flow "
                             f"{label} path")
    if drifted is not None and run["rc_before"] != run["rc_after"]:
        raise SystemExit(f"reinstalls changed the serving configurations: "
                         f"{run['rc_before']} -> {run['rc_after']}")
    if n_err == 0:
        raise SystemExit(f"flow {label}: expected error slots")
    return dict(launches=launches, packets_per_s=n_packets / run["seconds"],
                seconds=run["seconds"], engine_s=run["engine_s"],
                extract_s=run["extract_s"], server=run["server"],
                chunks=chunks, table=run["table"])


def run_fused_path(dev, n_packets: int, card: str, forests) -> dict:
    """flow.serve_raw_fused in 2048-packet chunks on the card against
    submit_raw + drain_packets on a second card server: egress and final
    registers must be equal."""
    raw = raw_trace(np.random.default_rng(SEED + 7), n_packets,
                    n_flows=2048, model_ids=tuple(MLP_IDS + FOREST_IDS),
                    pattern="mixed")
    chunks = [raw[i: i + 2048] for i in range(0, n_packets, 2048)]
    staged = flow_server(dev, forests)
    for chunk in chunks:
        staged.submit_raw(chunk)
    want = np.stack(staged.drain_packets())
    fused = flow_server(dev, forests)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = np.concatenate([fused.flow.serve_raw_fused(c) for c in chunks])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: read_launches()[k] for k in ("int16", "range",
                                                "flow_update")}
    same = np.array_equal(got[:, : want.shape[1]], want)
    regs = np.array_equal(fused.flow.table.registers,
                          staged.flow.table.registers) and np.array_equal(
        fused.flow.cms, staged.flow.cms)
    log(f"serve flow fused: {n_packets} raw packets over 2048 flows through "
        f"flow.serve_raw_fused in 2048-packet chunks, egress "
        f"{'byte-identical' if same else 'DIFFERS'} to submit_raw on a "
        f"second card server; registers and sketch "
        f"{'equal' if regs else 'DIFFER'}; launches {launches}; "
        f"{n_packets / dt:.0f} packets/s [{card}]")
    if not (same and regs):
        raise SystemExit("serve_raw_fused differs from the staged path")
    for k, v in launches.items():
        if v == 0:
            raise SystemExit(f"kernel {k} never launched on the fused path")
    return dict(launches=launches, packets_per_s=n_packets / dt, seconds=dt,
                engine_s=0.0)


# ---------------------------------------------------------------------------
# the sharded serving fabric
# ---------------------------------------------------------------------------

# the mid-trace MLP hot-swap of the fabric runs: a retrained 4-layer model
# under MLP id 2
SWAP_ID = MLP_IDS[1]
SWAP_ACTS = ["relu", "sigmoid", "leaky_relu"]


def swap_layers() -> list:
    rng = np.random.default_rng(SEED + 9)
    return [(rng.normal(size=(WIDTH, WIDTH)).astype(np.float32) * 0.2,
             rng.normal(size=(WIDTH,)).astype(np.float32) * 0.1)
            for _ in range(4)]


def fabric_server(dev, forests, n_shards: int = 4, **kw):
    """ShardedPacketServer at the PacketServer defaults on ``dev`` with
    strict Model IDs, the installs of ``flow_server``, and all three lane
    programs warmed on every shard."""
    fab = ShardedPacketServer(n_shards=n_shards, device=dev,
                              strict_model_ids=True, **kw)
    install_models(fab, np.random.default_rng(SEED + 4), ids=MLP_IDS)
    for mid, forest in forests.items():
        fab.install_forest(mid, forest)
    for mid in MLP_IDS:
        fab.install_feature_spec(mid, MLP_SPEC)
    for mid in FOREST_IDS:
        fab.install_feature_spec(mid, FOREST_SPEC)
    for sh in fab.shards:
        sh.engine.warm(sh.pipeline.batch_size, HEADER_BYTES + 4 * WIDTH,
                       lanes=("mlp", "forest", "both"))
    return fab


def engines(srv) -> list:
    return ([sh.engine for sh in srv.shards] if hasattr(srv, "shards")
            else [srv.engine])


def recompiles(srv) -> list:
    return [e.trace_count for e in engines(srv)]


def flow_rows(tables) -> dict:
    """key bytes → register row over the union of ``tables``; a flow that
    lives in two tables fails the run."""
    rows = {}
    for t in tables:
        snap = t.snapshot()
        for k, r in zip(snap["keys"], snap["registers"]):
            key = k.tobytes()
            if key in rows:
                raise SystemExit("fabric: a flow lives on two shards")
            rows[key] = r.tobytes()
    return rows


def alive_tables(srv) -> list:
    if not hasattr(srv, "shards"):
        return [srv.flow.table]
    return [srv.shards[s].flow.table for s in srv.alive_shards
            if srv.shards[s]._flow is not None]


def attribute_launches(srv) -> tuple:
    """Wrap each shard's (or the server's) engine call and flow extract:
    the launch-counter deltas inside each call are credited to its shard,
    and the engine call's seconds summed.  Returns (per-shard counters,
    engine seconds cell)."""
    stacks = (list(srv.shards) if hasattr(srv, "shards") else [srv])
    per = [dict() for _ in stacks]
    engine_s = [0.0]

    def wrap(fn, counts, timed):
        def call(*a, **kw):
            before = read_launches()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if timed:
                    engine_s[0] += time.perf_counter() - t
                for k, v in read_launches().items():
                    if v != before[k]:
                        counts[k] = counts.get(k, 0) + v - before[k]
        return call

    for st, counts in zip(stacks, per):
        st.engine.run_features = wrap(st.engine.run_features, counts, True)
        st.flow.extract = wrap(st.flow.extract, counts, False)
    return per, engine_s


def flush(srv) -> None:
    """Dispatch and retire every staged row of a fabric's shards or of a
    single server."""
    for pipe in ([sh.pipeline for sh in srv.shards] if hasattr(srv, "shards")
                 else [srv.ingress]):
        pipe.flush()


def serve_fabric(srv, chunks, drifted, *, swap: bool = True) -> dict:
    """Serve raw chunks through ``srv.submit_raw`` (a fabric or a single
    server), hot-swapping MLP ``SWAP_ID`` and reinstalling forest 9 at the
    midpoint when ``swap``.  The installs follow a flush, as the
    reference's fence test does (tests/test_sharded.py:187-208): a row
    staged before an install dispatches under the new tables, and each of
    N shards fills its batches N times slower than one server, so without
    it the two would serve different rows under the new generation.  The
    launch counters are zeroed right before the trace and read right
    after it."""
    per, engine_s = attribute_launches(srv)
    mid = len(chunks) // 2
    rc_before = recompiles(srv)
    on_card = engines(srv)[0].device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i, chunk in enumerate(chunks):
        if i == mid and swap:
            flush(srv)
            srv.install(SWAP_ID, swap_layers(), SWAP_ACTS,
                        final_activation="sigmoid")
            srv.install_forest(FOREST_IDS[0], drifted)
        srv.submit_raw(chunk)
    out = srv.drain_packets()
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cms = srv.cms if hasattr(srv, "shards") else srv.flow.cms
    return dict(egress=egress_list(out), seconds=dt, engine_s=engine_s[0],
                launches=read_launches(), per_shard=per,
                rc_before=rc_before, rc_after=recompiles(srv),
                rows=flow_rows(alive_tables(srv)), cms=cms.copy())


def check_same(label: str, run: dict, ref: dict) -> None:
    """Egress and error slots, every flow's registers and the sketch of a
    card run against its CPU oracle."""
    if run["egress"] != ref["egress"]:
        diff = [i for i, (a, b) in enumerate(zip(run["egress"],
                                                 ref["egress"])) if a != b]
        raise SystemExit(f"{label}: egress differs from the CPU oracle at "
                         f"{len(diff)} packets, first {diff[:5]}")
    if run["rows"] != ref["rows"]:
        raise SystemExit(f"{label}: flow registers differ from the CPU "
                         "oracle's")
    if not np.array_equal(run["cms"], ref["cms"]):
        raise SystemExit(f"{label}: the fabric's sketch differs from the "
                         "CPU oracle's")


def run_fabric_path(dev, label: str, chunks, card: str, forests, drifted,
                    kernels: tuple, **kw) -> dict:
    """The 4-shard fabric on the card against the port's PacketServer on
    the CPU on the same calls, and a 1-shard PacketServer on the card
    beside it."""
    n = sum(len(c) for c in chunks)
    ref = serve_fabric(flow_server(torch.device("cpu"), forests,
                                   strict_model_ids=True, **kw),
                       chunks, drifted)
    fab = fabric_server(dev, forests, **kw)
    run = serve_fabric(fab, chunks, drifted)
    check_same(f"fabric {label}", run, ref)
    one = serve_fabric(flow_server(dev, forests, strict_model_ids=True,
                                   **kw), chunks, drifted)
    check_same(f"fabric {label} (one card server)", one, ref)
    n_err = sum(isinstance(e, str) for e in run["egress"])
    launches = {k: run["launches"][k] for k in kernels}
    per_shard = [{k: c.get(k, 0) for k in kernels} for c in run["per_shard"]]
    uploads = sorted(str(d) for d in fab.control_plane._snapshot)
    log(f"fabric {label}: 4 shards on {dev}, {n} raw packets in "
        f"{len(chunks)} chunks, egress byte-identical to the CPU port's "
        f"PacketServer ({n_err} error slots), registers of "
        f"{len(run['rows'])} flows and the sketch equal; launches "
        f"{launches}, per shard {per_shard}; recompiles "
        f"{run['rc_before']} -> {run['rc_after']}; snapshot uploads keyed "
        f"{uploads}; {n / run['seconds']:.0f} packets/s ({run['seconds']:.3f}"
        f" s, of which {run['engine_s']:.3f} s inside the shards' "
        f"engine.run_features); 1-shard PacketServer on the card "
        f"{n / one['seconds']:.0f} packets/s ({one['seconds']:.3f} s); the "
        f"CPU port {n / ref['seconds']:.0f} packets/s [{card}]")
    for k, v in launches.items():
        if v == 0:
            raise SystemExit(f"kernel {k} never launched on the fabric "
                             f"{label} run")
    if any(min(c.values()) == 0 for c in per_shard):
        raise SystemExit(f"fabric {label}: a shard launched no kernel of "
                         f"{kernels}: {per_shard}")
    if run["rc_before"] != run["rc_after"]:
        raise SystemExit(f"fabric {label}: installs changed a shard's "
                         f"serving configurations: {run['rc_before']} -> "
                         f"{run['rc_after']}")
    if uploads != [str(dev)]:
        raise SystemExit(f"fabric {label}: expected one snapshot per "
                         f"generation on {dev}, got {uploads}")
    if n_err == 0:
        raise SystemExit(f"fabric {label}: expected error slots")
    return dict(launches=launches, per_shard=per_shard,
                packets_per_s=n / run["seconds"], seconds=run["seconds"],
                engine_s=run["engine_s"],
                one_server_packets_per_s=n / one["seconds"])


def drill_chunks() -> list:
    """The drills' trace: 50k raw packets over 2048 flows in 20 chunks."""
    raw = raw_trace(np.random.default_rng(SEED + 8), 50_000, n_flows=2048,
                    model_ids=tuple(MLP_IDS + FOREST_IDS), pattern="mixed")
    return np.array_split(raw, 20)


def run_failover_drill(dev, chunks, oracle, forests, card: str) -> None:
    """4 shards, kill shard 1 halfway: every ticket resolves and equals the
    CPU oracle, the migrated flows' rows are the dead shard's registers,
    the survivors add no serving configuration; then the cascade down to
    the last shard, which refuses to die, and one more window."""
    fab = fabric_server(dev, forests)
    rc0 = recompiles(fab)
    dead_rows = moved = None
    for i, chunk in enumerate(chunks):
        if i == len(chunks) // 2:
            dead_rows = flow_rows([fab.shards[1].flow.table])
            if not fab.kill_shard(1, "drill"):
                raise SystemExit("failover: kill_shard(1) refused")
            after = flow_rows(alive_tables(fab))
            moved = sum(after.get(k) == v for k, v in dead_rows.items())
            if moved != len(dead_rows):
                raise SystemExit(f"failover: {len(dead_rows) - moved} of "
                                 f"{len(dead_rows)} migrated flows differ "
                                 "from the dead shard's registers")
        fab.submit_raw(chunk)
    out = egress_list(fab.drain_packets())
    if out != oracle["egress"]:
        raise SystemExit("failover: the drain differs from the CPU oracle")
    if flow_rows(alive_tables(fab)) != oracle["rows"]:
        raise SystemExit("failover: the survivors' registers differ from "
                         "the CPU oracle's")
    rc1 = recompiles(fab)
    if any(rc1[s] != rc0[s] for s in fab.alive_shards):
        raise SystemExit(f"failover: survivors recompiled {rc0} -> {rc1}")
    faults = fab.stats()["faults"]
    cascade = [fab.kill_shard(2), fab.kill_shard(3), fab.kill_shard(0)]
    if cascade != [True, True, False] or fab.alive_shards != [0]:
        raise SystemExit(f"failover: cascade {cascade}, alive "
                         f"{fab.alive_shards}")
    tail = chunks[0]
    fab.submit_raw(tail)
    oracle["server"].submit_raw(tail)
    if egress_list(fab.drain_packets()) != egress_list(
            oracle["server"].drain_packets()):
        raise SystemExit("failover: the last shard's window differs from "
                         "the CPU oracle")
    log(f"fabric failover: 4 shards on {dev}, {sum(map(len, chunks))} raw "
        f"packets over 2048 flows, kill_shard(1) after chunk "
        f"{len(chunks) // 2}: every ticket resolved and equal to the CPU "
        f"oracle; {moved} migrated flows' registers bit-exact; survivors' "
        f"recompiles {rc0} -> {rc1}; fault_stats deaths "
        f"{faults['fabric_deaths_total']}, migrated "
        f"{faults['fabric_migrated_flows_total']}; kill 2, 3, 0 -> "
        f"{cascade}; the last shard's next window equal [{card}]")


def run_transient_drill(dev, chunks, oracle, forests, card: str) -> None:
    """Every fifth dispatch of every shard fails once and is retried: the
    drain equals the unfaulted CPU oracle's and every shard retried."""
    fab = fabric_server(dev, forests)
    FaultPlan(seed=SEED, specs=[FaultSpec(site="dispatch", every=5,
                                          count=1 << 40)]).install(fab)
    for chunk in chunks:
        fab.submit_raw(chunk)
    out = egress_list(fab.drain_packets())
    retries = [sh.pipeline.stats["ingress_dispatch_retries_total"]
               for sh in fab.shards]
    log(f"fabric transient faults: 4 shards on {dev}, dispatch fault every "
        f"5th event: drain {'equal' if out == oracle['egress'] else 'DIFFERS'}"
        f" to the unfaulted CPU oracle; dispatch retries per shard "
        f"{retries} [{card}]")
    if out != oracle["egress"]:
        raise SystemExit("transient faults: the drain differs from the "
                         "unfaulted run's")
    if min(retries) == 0:
        raise SystemExit(f"transient faults: a shard never retried: "
                         f"{retries}")


def run_slo_reflex_drill(dev, card: str) -> dict:
    """2 shards with latency budgets, reflex programs on MLP ids 1–4, a
    high watermark and a hard capacity, and the "overload" site on shard 0
    (as the reference's tests/test_slo.py:462-485): every ticket resolves;
    shed slots fall only on shard 0's chunks, each DEADLINE_SHED; every
    reflex-flagged row equals reflex_oracle on its features; every
    model-lane row equals an unconstrained CPU server's row."""
    chunk, n_warm, n_burst = 256, 4, 16
    kw = dict(ingress_batch=chunk, queue_high_watermark=3 * chunk,
              queue_capacity=4 * chunk)
    fab = ShardedPacketServer(n_shards=2, device=dev, **kw)
    oracle = PacketServer(device="cpu", ingress_batch=chunk)
    rng = np.random.default_rng(SEED + 10)
    for srv in (fab, oracle):
        install_models(srv, np.random.default_rng(SEED + 4), ids=MLP_IDS)
    progs = {mid: ReflexProgram.threshold(
        lane=mid % WIDTH, threshold=0, on_true=(1 << FRAC, 0),
        on_false=(0, 1 << FRAC)) for mid in MLP_IDS[:4]}
    for mid in MLP_IDS:
        fab.install_slo_budget(mid, 500.0)
    for mid, prog in progs.items():
        fab.install_reflex(mid, prog)
    feats = np.round(rng.normal(size=((n_warm + n_burst) * chunk, WIDTH))
                     * (1 << FRAC)).astype(np.int32)
    mids = rng.choice(np.asarray(MLP_IDS, np.int32), feats.shape[0])
    wire = encode_packets_np(mids, FRAC, feats)
    chunks = np.split(wire, n_warm + n_burst)
    for c in chunks[:n_warm]:           # warm both shards, seed the EWMAs
        fab.submit_packets(c)
    fab.drain_packets()
    for sh in fab.shards:               # pin the measured cost
        sh.pipeline.dispatch_cost_ewma = 2e-3
    FaultPlan([FaultSpec(site="overload", shard=0, slowdown=50.0,
                         count=1 << 40)]).install(fab)
    for c in chunks[n_warm:]:           # burst: chunks round-robin
        fab.submit_packets(c)
    out = fab.drain_packets(timeout_us=10e6)
    for c in chunks:
        oracle.submit_packets(c)
    want = oracle.drain_packets()[n_warm * chunk:]
    feats, mids = feats[n_warm * chunk:], mids[n_warm * chunk:]
    if len(out) != n_burst * chunk:
        raise SystemExit(f"slo drill: {len(out)} results for "
                         f"{n_burst * chunk} tickets")
    shed, reflex, model = [], 0, 0
    for i, o in enumerate(out):
        if isinstance(o, PacketError):
            shed.append(i)
            if o.reason != DEADLINE_SHED:
                raise SystemExit(f"slo drill: slot {i} is {o.reason!r}")
        elif int(o[6]) & FLAG_REFLEX:
            reflex += 1
            codes = np.zeros(WIDTH, np.int32)
            prog = progs[int(mids[i])]
            codes[:prog.out_dim] = reflex_oracle(prog, feats[i])
            row = emit_results_np(mids[i: i + 1], np.asarray([int(o[6])]),
                                  codes[None], FRAC)[0]
            if not np.array_equal(o, row):
                raise SystemExit(f"slo drill: reflex row {i} differs from "
                                 "reflex_oracle")
        else:
            model += 1
            if not np.array_equal(o, want[i]):
                raise SystemExit(f"slo drill: model-lane row {i} differs "
                                 "from the CPU oracle")
    shed_per = [sh.pipeline.stats["ingress_shed_total"] for sh in fab.shards]
    if not shed or any((i // chunk) % 2 for i in shed) or shed_per[1]:
        raise SystemExit(f"slo drill: shed slots must fall on shard 0's "
                         f"chunks only (per shard {shed_per})")
    confs = [sh.pipeline.reflex_confirm for sh in fab.shards]
    pairs = sum(c.pairs for c in confs)
    agree = sum(int(c._c_agree.value) for c in confs)
    if reflex == 0 or pairs != reflex:
        raise SystemExit(f"slo drill: {reflex} reflex rows, {pairs} "
                         "confirmed")
    log(f"fabric slo/reflex: 2 shards on {dev}, overload x50 on shard 0, "
        f"{len(out)} packets: {model} model-lane rows equal to the CPU "
        f"oracle, {reflex} reflex rows equal to reflex_oracle, {len(shed)} "
        f"DEADLINE_SHED slots all on shard 0's chunks (shed per shard "
        f"{shed_per}); reflex_agreement {agree / pairs:.4f} over {pairs} "
        f"pairs [{card}]")
    return dict(reflex_agreement=agree / pairs)


def run_serve_cli(card: str) -> None:
    """``python -m repro_torch.launch.serve --packets 8192 --shards 4`` on
    the card and on the CPU: both exit 0 and write the same metric names,
    the card one more, the counter that needs device events
    (``engine_batch_device_seconds_total``)."""
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "serve_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    names = {}
    for dev in ("cuda", "cpu"):
        path = out_dir / f"{dev}.json"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            "--packets", "8192", "--shards", "4",
                            "--device", dev, "--metrics-json", str(path)],
                           cwd=root, env=env, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            raise SystemExit(f"serve CLI --device {dev} exited "
                             f"{r.returncode}: {r.stderr[-2000:]}")
        snap = json.loads(path.read_text())
        names[dev] = sorted(snap["metrics"])
        log(f"serve CLI --device {dev} --shards 4: {r.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s with the interpreter's "
            f"start) [{card}]")
    want = sorted(names["cpu"] + ["engine_batch_device_seconds_total"])
    if names["cuda"] != want:
        raise SystemExit(
            "serve CLI: the card's metric names differ from the CPU's and "
            "its device-seconds counter: card only "
            f"{sorted(set(names['cuda']) - set(want))}, missing on the card "
            f"{sorted(set(want) - set(names['cuda']))}")


def run_fabric_phase(dev, card: str, forests, drifted, flow_chunks) -> dict:
    """The fabric phase: the 200k and chase runs, the failover, transient
    and SLO/reflex drills and the CLI.  Returns the runs' path entries."""
    t0 = time.perf_counter()
    paths = {
        "fabric": run_fabric_path(dev, "200k", flow_chunks, card, forests,
                                  drifted, ("int16", "range", "flow_update")),
        "fabric chase": run_fabric_path(
            dev, "chase", flow_trace(50_000, N_FLOWS, list(MLP_IDS)
                                     + list(FOREST_IDS) + [999]),
            card, forests, drifted, ("int16", "chase", "flow_update"),
            forest_variant="chase"),
    }
    chunks = drill_chunks()
    oracle_srv = flow_server(torch.device("cpu"), forests,
                             strict_model_ids=True)
    oracle = serve_fabric(oracle_srv, chunks, None, swap=False)
    oracle["server"] = oracle_srv
    run_failover_drill(dev, chunks, oracle, forests, card)
    run_transient_drill(dev, chunks, oracle, forests, card)
    paths["fabric"].update(run_slo_reflex_drill(dev, card))
    run_serve_cli(card)
    log(f"fabric phase: {time.perf_counter() - t0:.1f} s")
    return paths


def device_kernels(call, sep: str, n_calls: int = 10) -> tuple:
    """The device kernels of ``n_calls`` calls of ``call`` by name (the
    kernel's name cut at ``sep``), ms per call each (profiler), and the
    session that gave them: a session that records no device activity at
    all is taken again, at most twice more."""
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                call()
            torch.cuda.synchronize()
        split = {e.key.replace("(anonymous namespace)::", "").split(sep)[0]:
                 e.device_time_total / 1e3 / n_calls
                 for e in prof.key_averages() if e.device_time_total > 0}
        if split:
            break
    return split, attempt


def flow_timing_batch(fsrv, raw) -> list:
    """One batch of the flow trace as the card server's flow table resolves
    it (the trace's own mix of flows), on the card."""
    fields = parse_raw_headers(raw)
    words, hashes = FlowTable.pack_keys(fields.key_bytes,
                                        fsrv.flow.key_words)
    slots, _ = fsrv.flow.table.lookup_or_insert(words, hashes, fields.ts)
    if (slots < 0).any():
        raise SystemExit("timing batch: a flow was rejected")
    cells = fsrv.flow.params.cms_cells(hashes)
    return _dev(torch.device("cuda", 0), fsrv.flow.table.registers,
                fsrv.flow.cms, slots.astype(np.int32), cells, fields.ts,
                fields.length, np.ones(slots.shape[0], np.int32))


def flow_numbers(dev, flow: dict, worst: int, card: str) -> dict:
    """Phase 5 for the flow kernel, on 2048- and 8192-packet batches of the
    200k flow trace as the card server's flow table resolves them (the
    trace's own mix of flows) and on a 2048-packet batch of one flow: per
    call through the wrapper (which reads the kernel's error word, one
    synchronisation), per call without that read, queued (device only), the
    two device kernels split by the profiler, plain, bound, the longest flow
    chain, an on-device sort of the batch's keys (the floor of a sort-based
    links phase), the register file's round trip and the flow path's
    shares.  Returns the kernel's JSON entry (the 2048-packet trace
    batch)."""
    fsrv = flow["server"]
    trace = np.concatenate(flow["chunks"])
    batches = {"trace B=2048": flow_timing_batch(fsrv, trace[100_000:
                                                               102_048]),
               "trace B=8192": flow_timing_batch(fsrv, trace[110_000:
                                                               118_192])}
    one = list(batches["trace B=2048"])
    one[2] = torch.full_like(one[2], int(one[2][0]))  # every packet one slot
    batches["one_flow B=2048"] = one
    entry = None
    for label, fargs in batches.items():
        chain = int(torch.bincount(fargs[2].long()).max())
        k_ms = cuda_ms(lambda: fuk.flow_update_kernel(*fargs, **FLOW_KW))
        n_ms = cuda_ms(lambda: fuk.launch(*fargs, **FLOW_KW))
        q_ms = queued_ms(lambda: fuk.launch(*fargs, **FLOW_KW))
        split, session = device_kernels(
            lambda: fuk.launch(*fargs, **FLOW_KW), "<")
        if len(split) != 2:
            raise SystemExit(f"flow_update: expected two device kernels per "
                             f"call, the profiler saw {split} in "
                             f"{session} sessions")
        n = fargs[2].shape[0]
        sort_ms = cuda_ms(lambda: [torch.sort(k, stable=True) for k in (
            fargs[2], *fargs[3].t().contiguous())])
        p_ms = cuda_ms(lambda: flow_update_ref(*fargs, **FLOW_KW), reps=5,
                       inner=5) if n == 2048 else None
        b_ms, b_by = flow_bound(n, fargs)
        log(f"time flow_update {label} S={fargs[0].shape[0]} "
            f"sketch={tuple(fargs[1].shape)} (longest chain {chain}): kernel "
            f"{k_ms:.4f} ms per call through the wrapper, {n_ms:.4f} ms "
            f"without its error-word read ({k_ms - n_ms:.4f} ms for the "
            f"read), {q_ms:.4f} ms queued (device only): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in split.items())
            + f"; torch.sort of the {1 + fargs[3].shape[1]} key arrays "
            f"{sort_ms:.4f} ms; plain "
            + ("not timed" if p_ms is None else f"{p_ms:.4f} ms")
            + f", bound {b_ms:.6f} ms ({b_by}) [{card}]")
        if label == "trace B=2048":
            entry = dict(KERNELS["flow_update"],
                         launches=flow["launches"]["flow_update"],
                         max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    fargs = batches["trace B=2048"]
    rt = []
    for _ in range(21):
        t0 = time.perf_counter()
        fsrv.flow.download_state(*fsrv.flow.upload_state())
        rt.append((time.perf_counter() - t0) * 1e3)
    rt_ms = statistics.median(rt)
    n_calls = flow["launches"]["flow_update"]
    log(f"path flow 200k: extract share "
        f"{flow['extract_s'] / flow['seconds']:.4f} of the wall; {n_calls} "
        f"extract calls x {rt_ms:.4f} ms register-file round trip (upload + "
        f"copy back of {nbytes(fargs[0], fargs[1])} bytes) = "
        f"{n_calls * rt_ms * 1e-3 / flow['seconds']:.4f} of the wall "
        f"[{card}]")
    return entry

# ---------------------------------------------------------------------------
# the paper's C1/C2 primitives: the W8A8 GEMM and the Taylor activation
# ---------------------------------------------------------------------------


def gemm_operands(seed: int, m: int, k: int, n: int, dev):
    """Seeded float x (M, K) ~ N(0, 1) and w (K, N) ~ N(0, 1/K) on ``dev``,
    quantized as the path quantizes them: per row and per column, the weight
    codes K-major as quantize_tree stores them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)
    xc, xs = tq.absmax_quantize(x, axis=-1)
    wc, ws = tq.absmax_quantize(w, axis=0)
    return xc, tq.k_major(wc), xs, ws


def check_gemm(label: str, xc, wc, xs, ws, exact=None, split=None) -> float:
    """The GEMM kernel (with the wrapper's split, or ``split``) against
    ref.fixedpoint_matmul_ref on the same card inputs (and against ``exact``
    when given); returns the largest absolute difference (must be 0)."""
    got = (fmm.fixedpoint_matmul(xc, wc, xs, ws) if split is None
           else fmm.run_split(xc, wc, xs, ws, split))
    want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = torch.equal(got, want) and (exact is None or torch.equal(
        got.cpu(), exact))
    m, k = xc.shape
    if split is None:
        split = fmm.plan(m, wc.shape[1], k, sms())
    label = f"{label} [split {split}]"
    log(f"kernel fixedpoint_matmul {label} M={m} K={k} N={wc.shape[1]}: "
        f"{'equal' if ok else 'DIFFERS'} to its plain version"
        f"{' and the exact int64 product' if exact is not None else ''} "
        f"(max_abs_err {err})")
    if not ok:
        raise SystemExit(f"fixedpoint_matmul differs from its plain version "
                         f"({label}, M={m} K={k} N={wc.shape[1]})")
    return err


def check_gemm_kernels(dev) -> float:
    """The kernel at the layer's projections for M from one token to 2048
    (M at the 64-row wgmma slab and the 128-row tile, decode-sized M at the
    long K with split-K), ragged shapes (K % 16 != 0: K padded with zero codes), both
    weight layouts, the copies counted, raw codes over the whole int8 range
    at unit scales against the exact int64 product (every split of
    K = 8960), and a bfloat16 activation through the w8a8_int linear."""
    worst = 0.0
    for name, (_, k, n) in PROJECTIONS.items():
        if name in ("wk", "wo", "gate"):  # same (K, N) as wv, wq, up
            continue
        for m in (1, 17, 64, 65, 255, N_TOKENS):
            ops_ = gemm_operands(SEED + m, m, k, n, dev)
            worst = max(worst, check_gemm(f"qwen2-1.5b {name}", *ops_))
    for m, k, n in ((100, 300, 50), (257, 513, 129), (1, 512, 7),
                    (16, 1552, 136), (63, 1536, 129)):
        copies = fmm.relayouts["fixedpoint_matmul"]
        worst = max(worst, check_gemm(
            "ragged", *gemm_operands(SEED + k, m, k, n, dev)))
        if fmm.relayouts["fixedpoint_matmul"] != copies + 2 * (k % 16 != 0):
            raise SystemExit(f"fixedpoint_matmul: K={k} must copy x and w "
                             "(zero codes appended) where K % 16 != 0, "
                             "nothing else")
    xc, wc, xs, ws = gemm_operands(SEED + 13, 255, D_MODEL, KV_DIM, dev)
    copies = fmm.relayouts["fixedpoint_matmul"]
    worst = max(worst, check_gemm("row-major w", xc, wc.contiguous(), xs, ws))
    worst = max(worst, check_gemm("K-major w", xc, wc, xs, ws))
    if fmm.relayouts["fixedpoint_matmul"] != copies + 1:
        raise SystemExit("fixedpoint_matmul: a row-major w must be copied "
                         "to K-major once, a K-major w never")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    for k in (512, D_MODEL, D_FF):  # raw codes over the whole int8 range
        xc = torch.randint(-128, 128, (255, k), generator=g, device=dev,
                           dtype=torch.int8)
        wc = torch.randint(-128, 128, (k, 129), generator=g, device=dev,
                           dtype=torch.int8)
        exact = torch.as_tensor(xc.cpu().numpy().astype(np.int64)
                                @ wc.cpu().numpy().astype(np.int64))
        unit = (torch.ones((255, 1), device=dev),
                torch.ones((1, 129), device=dev))
        worst = max(worst, check_gemm(
            "raw codes, unit scales", xc, tq.k_major(wc), *unit,
            exact=exact.to(torch.float32)))
        if k == D_FF:
            for split in (2, 5, 14, 35):
                worst = max(worst, check_gemm(
                    "raw codes, unit scales", xc, tq.k_major(wc), *unit,
                    exact=exact.to(torch.float32), split=split))
    # a bfloat16 activation through the w8a8_int linear: card vs CPU port
    x = (torch.randn((255, D_MODEL), generator=g, device=dev) * 3).to(
        torch.bfloat16)
    _, wc, _, ws = gemm_operands(SEED + 12, 1, D_MODEL, KV_DIM, dev)
    got = tq.matmul(x, (wc, ws), "w8a8_int")
    want = tq.matmul(x.cpu(), (wc.cpu(), ws.cpu()), "w8a8_int")
    ok = got.dtype == torch.bfloat16 and torch.equal(got.cpu(), want)
    log(f"kernel fixedpoint_matmul bfloat16 x M=255 K={D_MODEL} N={KV_DIM} "
        f"through w8a8_matmul_int: {'equal' if ok else 'DIFFERS'} to the CPU "
        "port")
    if not ok:
        raise SystemExit("bfloat16 w8a8_int linear differs from the CPU port")
    return worst


def check_taylor(label: str, x, coeffs, x_frac: int) -> int:
    got = tak.taylor_activation(x, coeffs, x_frac)
    want = ops.taylor_activation(x, coeffs, x_frac, backend="ref")
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    ok = torch.equal(got, want)
    if not ok:
        raise SystemExit(f"taylor_activation differs from its plain version "
                         f"({label})")
    return err


def check_taylor_kernels(dev) -> int:
    """Orders 1/3/5/7 × x_frac 0/8/12/16 over 1, 17 and 2048·8960 codes
    drawn from ±2**15 (straddling the ±(2**14 − 1) clamp), and exp
    constants at s=16 on codes at 8 fractional bits, whose Horner products
    wrap int32, in aligned and unaligned views."""
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = 0
    for order in (1, 3, 5, 7):
        coeffs = scaled_constants("sigmoid", order, 16)
        for x_frac in (0, 8, 12, 16):
            for size in (1, 17, N_TOKENS * D_FF):
                x = torch.randint(-2 ** 15, 2 ** 15, (size,), generator=g,
                                  device=dev, dtype=torch.int32)
                worst = max(worst, check_taylor(
                    f"order {order} x_frac {x_frac} n={size}", x, coeffs,
                    x_frac))
        log(f"kernel taylor_activation order={order} x_frac=0/8/12/16 "
            f"n=1/17/{N_TOKENS * D_FF}: equal to its plain version "
            f"(max_abs_err {worst})")
    coeffs = scaled_constants("exp", 5, 16)
    x = torch.arange(-20000, 20001, dtype=torch.int32, device=dev)
    for view in (x, x[1:], x[3:-2]):
        worst = max(worst, check_taylor("exp wrap", view, coeffs, 8))
    wide = torch.full_like(x, int(coeffs[-1]), dtype=torch.int64)
    xc = torch.clamp(x, -tak.CLAMP, tak.CLAMP).to(torch.int64)
    for c in coeffs[-2::-1]:
        prod = wide * xc
        wide = ((prod + torch.where(prod >= 0, 128, 127)) >> 8) + int(c)
    wrapped = int((wide != tak.taylor_activation(x, coeffs, 8)).sum())
    log(f"kernel taylor_activation exp order 5 s=16 x_frac 8, aligned and "
        f"unaligned views: equal to its plain version; {wrapped} of "
        f"{x.numel()} codes differ from the unwrapped int64 chain")
    if wrapped == 0:
        raise SystemExit("exp wrap case: no Horner product wrapped")
    return worst


def qwen_layer(dev) -> dict:
    """A seeded float32 parameter tree shaped like one qwen2-1.5b decoder
    layer: the 7 projections (w ~ N(0, 1/K); q/k/v with biases) and one
    norm scale, which quantize_tree must leave float."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def lin(k, n, bias=False):
        p = {"w": torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)}
        if bias:
            p["b"] = torch.randn((n,), generator=g, device=dev) * 0.02
        return p

    layer = {"attn": {}, "mlp": {},
             "ln1": {"scale": torch.ones(D_MODEL, device=dev)}}
    for name, ((part, leaf), k, n) in PROJECTIONS.items():
        layer[part][leaf] = lin(k, n, bias=name in ("wq", "wk", "wv"))
    return layer


def nmse(ref, approx) -> float:
    return float(((ref - approx) ** 2).mean() / (ref ** 2).mean().clamp_min(
        1e-12))


def run_c1c2_path(dev, card: str) -> dict:
    """quantize_tree on one qwen2-1.5b layer, the 7 w8a8_int projections on
    2048 seeded tokens, and the Taylor sigmoid on the gate output's codes at
    orders 1/3/5; launch counters zeroed right before and read right
    after.  Each output is held to its plain version on the card, the
    projections at 17 tokens to the CPU port, and both to the float
    function they approximate."""
    params = qwen_layer(dev)
    q = tq.quantize_tree(params)
    leaves = {name: q[part][leaf]["w"]
              for name, ((part, leaf), _, _) in PROJECTIONS.items()}
    floats = {name: params[part][leaf]["w"]
              for name, ((part, leaf), _, _) in PROJECTIONS.items()}
    kept = [q["ln1"]["scale"]] + [q["attn"][n]["b"] for n in ("wq", "wk",
                                                               "wv")]
    if not (all(isinstance(v, tuple) and v[0].dtype == torch.int8
                and v[1].dtype == torch.float32 for v in leaves.values())
            and all(t.dtype == torch.float32 for t in kept)):
        raise SystemExit("quantize_tree: weight leaves not int8 pairs, or a "
                         "norm/bias leaf quantized")
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = torch.randn((N_TOKENS, D_MODEL), generator=g, device=dev)
    inputs = {name: x for name in PROJECTIONS}
    inputs["wo"] = torch.randn((N_TOKENS, D_MODEL), generator=g, device=dev)
    inputs["down"] = torch.randn((N_TOKENS, D_FF), generator=g, device=dev)
    sig = {o: scaled_constants("sigmoid", o, TAYLOR_FRAC) for o in (1, 3, 5)}

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = {name: tq.matmul(inputs[name], leaves[name], "w8a8_int")
            for name in PROJECTIONS}
    x_q = encode(outs["gate"], TAYLOR_FRAC)
    acts = {o: ops.taylor_activation(x_q, c, TAYLOR_FRAC)
            for o, c in sig.items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: read_launches()[k] for k in ("fixedpoint_matmul",
                                                "taylor_activation")}
    if launches != {"fixedpoint_matmul": 7, "taylor_activation": 3}:
        raise SystemExit(f"C1/C2 path launches {launches}, expected 7 and 3")
    if fmm.relayouts["fixedpoint_matmul"]:
        raise SystemExit(f"C1/C2 path GEMM layout copies {fmm.relayouts}: "
                         "expected none on the K-major codes quantize_tree "
                         "stores")

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 reference
    errs = {}
    for name, (codes, scale) in leaves.items():
        inp = inputs[name]
        xc, xs = tq.absmax_quantize(inp, axis=-1)
        plain = ops.fixedpoint_matmul(xc, codes, xs, scale, backend="ref")
        cpu = tq.matmul(inp[:17].cpu(), (codes.cpu(), scale.cpu()),
                        "w8a8_int")
        err = nmse(inp @ floats[name], outs[name])
        same = torch.equal(outs[name], plain)
        same_cpu = torch.equal(outs[name][:17].cpu(), cpu)
        errs[name] = err
        log(f"path C1 {name} {tuple(inp.shape)} · {tuple(codes.shape)} "
            f"w8a8_int: {'equal' if same else 'DIFFERS'} "
            f"to the plain version on the card, "
            f"{'equal' if same_cpu else 'DIFFERS'} to the CPU port at 17 "
            f"tokens; NMSE against the float32 product {err:.3e}")
        if not (same and same_cpu):
            raise SystemExit(f"C1 path: projection {name} differs")
        if not err < 1e-3:
            raise SystemExit(f"C1 path: {name} NMSE {err} above the 1e-3 "
                             "int8 budget")
    xf = x_q.to(torch.float32) / 2 ** TAYLOR_FRAC
    inside = xf.abs() <= 1.5
    ref_sig = torch.sigmoid(xf)
    nmse_in = {}
    for o, c in sig.items():
        plain = ops.taylor_activation(x_q, c, TAYLOR_FRAC, backend="ref")
        y = acts[o].to(torch.float32) / 2 ** TAYLOR_FRAC
        nmse_in[o] = nmse(ref_sig[inside], y[inside])
        same = torch.equal(acts[o], plain)
        log(f"path C2 sigmoid order {o} on the gate codes ({N_TOKENS}, "
            f"{D_FF}) at x_frac {TAYLOR_FRAC}: "
            f"{'equal' if same else 'DIFFERS'} to the plain version; NMSE "
            f"against the float sigmoid {nmse(ref_sig, y):.3e} over all "
            f"codes, {nmse_in[o]:.3e} over the "
            f"{float(inside.float().mean()):.3f} of them in [-1.5, 1.5]")
        if not same:
            raise SystemExit(f"C2 path: order {o} differs")
    if not (nmse_in[5] < 1e-4 and nmse_in[1] > nmse_in[3] > nmse_in[5]):
        raise SystemExit(f"C2 path: NMSE on [-1.5, 1.5] {nmse_in}: expected "
                         "order 5 below 1e-4 and falling with the order")
    log(f"path C1/C2: 7 projections + 3 Taylor passes in {dt:.4f} s "
        f"(launches {launches}; GEMM layout copies 0) "
        f"[{card}]")
    return dict(launches=launches, inputs=inputs, leaves=leaves, x_q=x_q,
                sig=sig, nmse=errs)


def gemm_bound(m: int, k: int, n: int):
    """Least time for one GEMM call: x, w, both scales and the float32
    output once over HBM bandwidth, vs 2·M·N·K operations over the int8
    tensor-core peak."""
    return bound_ms(m * k + k * n + 4 * m + 4 * n + 4 * m * n, 2 * m * n * k,
                    INT8_TENSOR_OPS_PER_S)


# int32 operations per element of the Taylor kernel: the clamp's min and max,
# then per Horner step the multiply, the sign test, the rounding add, the
# shift and the constant's add
def taylor_ops(n: int, order: int) -> int:
    return n * (2 + 5 * order)


def in_turns(calls: dict, timer) -> dict:
    """Time each of ``calls`` twice, in the order A, B, …, …, B, A on one
    card; returns the mean of each one's two readings."""
    order = list(calls) + list(calls)[::-1]
    got = {name: [] for name in calls}
    for name in order:
        got[name].append(timer(calls[name]))
    return {name: sum(v) / len(v) for name, v in got.items()}


def c1c2_numbers(dev, c1c2: dict, worst: dict, card: str) -> list:
    """Phase 5 for the GEMM and the Taylor kernel.  The GEMM at every
    projection of the layer on the path's own operands and at decode-sized
    M (1 and 17) on the widest and on the longest-K projection: the kernel
    and torch._int_mm + the rescale (checked equal) timed in turns, and the
    bound.  The Taylor kernel at order 5 on the path's 2048×8960 codes.
    Returns the two JSON entries; the GEMM's is the up projection, the
    layer's largest."""
    cases = {}
    for name, (codes, scale) in c1c2["leaves"].items():
        if name in ("wk", "gate"):  # same operand shapes as wv and up
            continue
        xc, xs = tq.absmax_quantize(c1c2["inputs"][name], axis=-1)
        cases[name] = (xc, codes, xs, scale)
    for name in ("up", "down"):
        _, k, n = PROJECTIONS[name]
        for m in (1, 17):
            cases[f"decode {name} M={m}"] = gemm_operands(SEED + m, m, k, n,
                                                          dev)
    rows = {}
    for name, (xc, codes, xs, scale) in cases.items():
        m, k = xc.shape
        n = codes.shape[1]
        split = fmm.plan(m, n, k, sms())
        calls = {
            "kernel": lambda: fmm.fixedpoint_matmul(xc, codes, xs, scale)}
        lib_ms = None
        if m > 16:  # torch._int_mm takes M > 16; codes K-major as cuBLASLt's
            def library():
                return (torch._int_mm(xc, codes).to(torch.float32) * xs) * scale

            if not torch.equal(library(), fmm.fixedpoint_matmul(
                    xc, codes, xs, scale)):
                raise SystemExit(f"torch._int_mm + rescale differs from the "
                                 f"kernel ({name}): not the same function")
            calls["library"] = library
        per_call = in_turns(calls, cuda_ms)
        queued = in_turns(calls, queued_ms)
        lib_ms = per_call.get("library")
        mm_ms = (cuda_ms(lambda: torch._int_mm(xc, codes)) if m > 16
                 else None)
        p_ms = cuda_ms(lambda: ops.fixedpoint_matmul(xc, codes, xs, scale,
                                                     backend="ref"),
                       reps=5, inner=5)
        b_ms, b_by = gemm_bound(m, k, n)
        k_ms = per_call["kernel"]
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms)
        lib = ("none (torch._int_mm needs M > 16)" if lib_ms is None else
               f"{lib_ms:.4f} ms ({queued['library']:.4f} queued; "
               f"torch._int_mm alone {mm_ms:.4f})")
        log(f"time fixedpoint_matmul {name} M={m} K={k} N={n}: kernel "
            f"[wgmma, split {split}] {k_ms:.4f} ms per call "
            f"({queued['kernel']:.4f} ms queued, device only), "
            f"torch._int_mm + rescale "
            f"{lib}, plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
            f"{2 * m * n * k / (k_ms * 1e9):.1f} TOP/s [{card}]")
    gemm = dict(KERNELS["fixedpoint_matmul"],
                launches=c1c2["launches"]["fixedpoint_matmul"],
                max_abs_err=worst["fixedpoint_matmul"], **rows["up"])

    x_q, coeffs = c1c2["x_q"], c1c2["sig"][5]

    def call():
        tak.taylor_activation(x_q, coeffs, TAYLOR_FRAC)

    k_ms, q_ms = cuda_ms(call), queued_ms(call)
    p_ms = cuda_ms(lambda: ops.taylor_activation(x_q, coeffs, TAYLOR_FRAC,
                                                 backend="ref"),
                   reps=5, inner=5)
    b_ms, b_by = bound_ms(8 * x_q.numel(), taylor_ops(x_q.numel(), 5),
                          INT32_CORE_OPS_PER_S)
    log(f"time taylor_activation order 5 ({N_TOKENS}, {D_FF}) x_frac "
        f"{TAYLOR_FRAC}: kernel {k_ms:.4f} ms per call ({q_ms:.4f} ms "
        f"queued, device only), plain {p_ms:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by}); {8 * x_q.numel() / (k_ms * 1e6):.1f} GB/s [{card}]")
    taylor = dict(KERNELS["taylor_activation"],
                  launches=c1c2["launches"]["taylor_activation"],
                  max_abs_err=worst["taylor_activation"], ms=k_ms,
                  plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                  library_ms=None)
    return [gemm, taylor]


# ---------------------------------------------------------------------------
# the RWKV-6 LM path: the WKV chunk-scan kernel, prefill, decode, serving
# ---------------------------------------------------------------------------


def wkv_operands(seed: int, bh: int, nc: int, c: int, d: int, dev):
    """Seeded operands as the reference's kernel test makes them: a, b ~
    0.4·N(0, 1), v ~ N(0, 1), tot ~ U(0.2, 0.95) (so that scaling S's
    columns instead of its rows shows), diag ~ 0.2·N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    tot = torch.rand((bh, nc, 1, d), generator=g, device=dev) * 0.75 + 0.2
    return (normal(bh, nc, c, d, scale=0.4), normal(bh, nc, c, d, scale=0.4),
            normal(bh, nc, c, d), tot, normal(bh, nc, c, 1, scale=0.2))


def check_wkv(label: str, args) -> float:
    """The WKV kernel against ref.wkv_scan_ref on the same card inputs:
    |Δ| ≤ WKV_TOL + WKV_TOL·|ref| everywhere; returns the largest |Δ|."""
    got = wk.wkv_scan(*args)
    want = ops.wkv_scan(*args, backend="ref")
    torch.cuda.synchronize()
    diff = (got - want).abs()
    ok = bool((diff <= WKV_TOL + WKV_TOL * want.abs()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    log(f"kernel wkv_scan {label} (BH, NC, C, D) = {tuple(args[0].shape)}: "
        f"{'within' if ok else 'OUTSIDE'} rtol = atol = {WKV_TOL} of its "
        f"plain version (max_abs_err {err:.3e}, max |ref| "
        f"{float(want.abs().max()):.3f})")
    if not ok:
        raise SystemExit(f"wkv_scan differs from its plain version ({label})")
    return err


def check_wkv_kernels(dev) -> float:
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 plain version
    worst = 0.0
    for i, shape in enumerate(WKV_SHAPES):
        label = "prefill geometry" if shape == (160, 32, 64, 64) else "case"
        worst = max(worst, check_wkv(label,
                                     wkv_operands(SEED + 40 + i, *shape, dev)))
    a, b, v, tot, diag = wkv_operands(SEED + 50, 1, 3, 64, 32, dev)
    base = wk.wkv_scan(a, b, v, tot, diag)
    b2 = b.clone()
    b2[:, 0] = 0.0  # chunk 0's keys no longer reach the state
    moved = float((base[:, 1:] - wk.wkv_scan(a, b2, v, tot, diag)[:, 1:])
                  .abs().max())
    log(f"kernel wkv_scan state carry: zeroing chunk 0's b moves chunks 1+ "
        f"by {moved:.3e} (must exceed 1e-4)")
    if not moved > 1e-4:
        raise SystemExit("wkv_scan: the state does not carry across chunks")
    before = wk.launches["wkv_scan"]
    out = wk.wkv_scan(*wkv_operands(SEED + 51, 0, 2, 64, 64, dev))
    if out.shape != (0, 2, 64, 64) or wk.launches["wkv_scan"] != before:
        raise SystemExit("wkv_scan: an empty input must launch nothing")
    log("kernel wkv_scan BH=0: no launch")
    return worst


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def layer_slice(params, n: int):
    """The first ``n`` layers of an RWKV-6 parameter tree."""
    blocks = params["blocks"]

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]

    return {**params, "blocks": cut(blocks)}


def check_logits(label: str, logits: torch.Tensor, shape: tuple) -> None:
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{label}: logits of shape {tuple(logits.shape)} "
                         f"(expected {shape}), finite "
                         f"{bool(torch.isfinite(logits).all())}")


def scan_vs_chunked(params, tokens, cfg, dev) -> float:
    """max |Δ| / max |ref| of the last-position logits, the kernel's
    float32 WKV (``"scan"``) against the reference's bf16 chunked form."""
    scan = build_model(cfg, device=dev).prefill(params, tokens=tokens)
    chunked = build_model(cfg, wkv="chunked", device=dev).prefill(
        params, tokens=tokens)
    return rel_err(scan, chunked)


@contextlib.contextmanager
def wkv_route(fn):
    """Send the model's WKV calls (``rwkv6._wkv_scan`` → ``ops.wkv_scan``)
    to ``fn`` instead, for the comparisons of the full-depth check."""
    orig = ops.wkv_scan
    ops.wkv_scan = fn
    try:
        yield orig
    finally:
        ops.wkv_scan = orig


def check_rwkv6_depth(params, tokens, cfg) -> None:
    """The WKV kernel inside the full-depth model.  (1) The float32 prefill
    (B=4, T=2048) and forward (B=1, T=150) through ``_wkv_scan`` twice,
    with ``ops.wkv_scan`` on backend "kernel" and then "ref": the inputs
    are identical and only the kernel differs, held at LM_KERNEL_VS_REF.
    (2) Each of the bf16 prefill's WKV calls, on its own operands, against
    the plain version in float64, held at LM_WKV_VS_EXACT.  Printed, not
    held: the bf16 prefill kernel vs "ref", and how far a relative 1e-6
    nudge of one position's embedding moves the float32 logits (the
    random-weight model's own sensitivity)."""
    cfg32 = cfg.replace(dtype="float32")
    tok = tokens[:1, :150]
    runs = {"prefill": lambda c: rwkv6.prefill(params, tokens, c),
            "forward": lambda c: rwkv6.forward(params, tok, c)[0]}
    got = {}
    for backend in ("kernel", "ref"):
        with wkv_route(functools.partial(ops.wkv_scan, backend=backend)):
            for name, run in runs.items():
                got[name, backend] = run(cfg32)
            got["bf16", backend] = runs["prefill"](cfg)
    errs = {k: rel_err(got[k, "kernel"], got[k, "ref"])
            for k in ("prefill", "forward", "bf16")}
    fk, fr = got["forward", "kernel"].float(), got["forward", "ref"].float()
    per_pos = (fk - fr).abs().amax(-1)[0] / fr.abs().max()
    log(f"path rwkv6 full depth ({cfg.n_layers} layers), kernel vs plain "
        f"version inside the model, float32: prefill B={LM_BATCH} "
        f"T={LM_SEQ} {errs['prefill']:.3e}, forward B=1 T=150 "
        f"{errs['forward']:.3e} (worst position {int(per_pos.argmax())}, "
        f"position 0 {float(per_pos[0]):.3e}) (bound {LM_KERNEL_VS_REF}); "
        f"bfloat16 prefill {errs['bf16']:.3e} (not held: every activation "
        f"rounds to bf16)")
    if not max(errs["prefill"], errs["forward"]) < LM_KERNEL_VS_REF:
        raise SystemExit(f"rwkv6 full depth, kernel vs plain version: {errs}")
    del got, fk, fr

    worst = []

    def against_exact(a, b, v, tot, diag, backend="auto"):
        o = plain(a, b, v, tot, diag, backend="kernel")
        exact = wkv_scan_ref(*(t.double() for t in (a, b, v, tot, diag)))
        top = exact.abs().max()
        worst.append((float((o.double() - exact).abs().max() / top),
                      float((wkv_scan_ref(a, b, v, tot, diag).double()
                             - exact).abs().max() / top)))
        return o

    with wkv_route(against_exact) as plain:
        runs["prefill"](cfg)
    kernel_err = max(w[0] for w in worst)
    log(f"path rwkv6 prefill's {len(worst)} WKV calls (bf16, B={LM_BATCH} "
        f"T={LM_SEQ}) on their own operands against the float64 plain "
        f"version: kernel max |Δ| / max |exact| {kernel_err:.3e} (worst "
        f"layer {max(range(len(worst)), key=lambda i: worst[i][0])}; bound "
        f"{LM_WKV_VS_EXACT}), float32 plain version "
        f"{max(w[1] for w in worst):.3e}")
    if len(worst) != cfg.n_layers or not kernel_err < LM_WKV_VS_EXACT:
        raise SystemExit(f"rwkv6 prefill's WKV calls against float64: "
                         f"{len(worst)} calls, worst {kernel_err}")

    base = runs["forward"](cfg32).float()
    embed = rwkv6._embed
    moved = {}
    for pos in (0, 1, 149):
        def nudged(p, tk, c, pos=pos):
            x = embed(p, tk, c).clone()
            x[:, pos] *= 1 + 1e-6
            return x

        rwkv6._embed = nudged
        try:
            moved[pos] = rel_err(runs["forward"](cfg32), base)
        finally:
            rwkv6._embed = embed
    log(f"path rwkv6 sensitivity, float32 forward B=1 T=150, "
        f"{cfg.n_layers} layers: a relative 1e-6 nudge of one position's "
        f"embedding moves the logits by " + ", ".join(
            f"{v:.3e} (position {p})" for p, v in moved.items()))


def run_rwkv6_path(dev, card: str) -> dict:
    """rwkv6-3b at full width and depth with seeded float32 parameters:
    ``build_model(cfg).prefill`` on 4 × 2048 seeded tokens (launch counters
    zeroed right before and read right after: one WKV launch per layer);
    the two WKV forms against each other at every depth from 1 to 32
    layers; decode against prefill; ``LMServer`` greedy generation with a
    same-structure hot swap; the quantized prefill through the W8A8
    kernel; and two layers at full width in float32 on the card against
    the CPU port."""
    cfg = get_config(LM_ARCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    params = rwkv6.init(g, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=g,
                           device=dev)
    n_params = tree_numel(params)
    model = build_model(cfg, device=dev)

    torch.cuda.synchronize()
    reset_launches()
    logits = model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    if launches != {"wkv_scan": cfg.n_layers}:
        raise SystemExit(f"rwkv6 prefill launches {launches}, expected "
                         f"wkv_scan {cfg.n_layers} (one per layer) and no other")
    check_logits("rwkv6 prefill", logits, (LM_BATCH, 1, cfg.vocab_size))
    log(f"path rwkv6 prefill {LM_ARCH} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f}e9 float32 parameters) on "
        f"B={LM_BATCH} T={LM_SEQ}: launches {launches}; last-position logits "
        f"{tuple(logits.shape)} {logits.dtype}, finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    log(f"path rwkv6 prefill: {prefill_s:.4f} s for {LM_BATCH * LM_SEQ} "
        f"tokens, {LM_BATCH * LM_SEQ / prefill_s:.0f} tokens/s (warm, host "
        f"wall with the card synchronised) [{card}]")

    # the kernel's form against the reference model's, by depth: the first
    # n layers of the same parameters (held at one layer, printed for all)
    sweep = {}
    depths = [n for n in (1, 2, 4, 8, 16, 32) if n <= cfg.n_layers]
    for dtype in ("bfloat16", "float32"):
        for n in depths:
            sweep[dtype, n] = scan_vs_chunked(
                params, tokens, cfg.replace(n_layers=n, dtype=dtype), dev)
        log(f"path rwkv6 prefill, \"scan\" vs \"chunked\", {dtype} "
            f"activations, B={LM_BATCH} T={LM_SEQ}, by depth: " + ", ".join(
                f"{n} layers {sweep[dtype, n]:.3e}" for n in depths))
    if not sweep["bfloat16", 1] < LM_SCAN_VS_CHUNKED:
        raise SystemExit(f"rwkv6 prefill: scan vs chunked at one layer "
                         f"{sweep['bfloat16', 1]} (bound {LM_SCAN_VS_CHUNKED})")
    check_rwkv6_depth(params, tokens, cfg)
    p2 = layer_slice(params, 2)

    # decode against prefill, 2 layers at the config's bf16
    cfg_b = cfg.replace(n_layers=2)
    model_b = build_model(cfg_b, device=dev)
    tok_b = tokens[:2, :16]
    full, _ = rwkv6.forward(p2, tok_b, cfg_b)
    caches = model_b.init_caches(2, 16)
    steps = []
    for t in range(16):
        step, caches = model_b.decode_step(
            p2, caches, tok_b[:, t:t + 1],
            torch.full((2,), t, dtype=torch.int32, device=dev))
        steps.append(step[:, 0])
    dec_err = rel_err(torch.stack(steps, dim=1), full)
    log(f"path rwkv6 decode vs prefill, 2 layers, bfloat16, B=2 T=16: "
        f"relative error {dec_err:.3e} (bound {LM_DECODE_VS_PREFILL})")
    if not dec_err < LM_DECODE_VS_PREFILL:
        raise SystemExit(f"rwkv6 decode vs prefill: {dec_err}")

    # LMServer at full width and depth, with a same-structure hot swap
    srv = LMServer(cfg, batch=8, max_seq=64, device=dev)
    srv.install(LM_ARCH, params)
    prompt = np.random.default_rng(SEED + 23).integers(0, cfg.vocab_size,
                                                       (8, 16))
    out = srv.generate(LM_ARCH, prompt, 16)
    gen_tps = srv.tokens_per_second()
    traces = srv.trace_count
    params_b = rwkv6.init(torch.Generator(device=dev).manual_seed(SEED + 22),
                          cfg, device=dev)
    srv.install(LM_ARCH, params_b)
    out_b = srv.generate(LM_ARCH, prompt, 4)
    traces_b = srv.trace_count
    del params_b, srv
    ok = (out.shape == (8, 16) and out_b.shape == (8, 4)
          and out.min() >= 0 and out.max() < cfg.vocab_size)
    log(f"path rwkv6 LMServer(batch=8, max_seq=64) at full width and depth: "
        f"16-token prompt + 16 greedy tokens, then 4 after a same-structure "
        f"install: trace_count {traces} then {traces_b}; {gen_tps:.1f} "
        f"tokens/s (prompt and new tokens, host wall with the card "
        f"synchronised) [{card}]")
    if not ok or traces != 1 or traces_b != 1:
        raise SystemExit(f"LMServer: tokens {out.shape} {out_b.shape}, "
                         f"trace_count {traces} then {traces_b}")

    # quantized prefill: quantize_tree, then every projection on the W8A8
    # kernel (8 per layer) and the WKV kernel
    q2 = tq.quantize_tree(p2)
    model_q = build_model(cfg_b, device=dev)
    gemm_calls = []  # the path's own GEMM operands, and what the kernel gave
    wrapper = fmm.fixedpoint_matmul

    def recorded(xc, wc, xs, ws):
        out = wrapper(xc, wc, xs, ws)
        gemm_calls.append((xc, wc, xs, ws, out.clone()))
        return out

    torch.cuda.synchronize()
    reset_launches()
    fmm.fixedpoint_matmul = recorded
    try:
        lq = model_q.prefill(q2, tokens=tokens)
    finally:
        fmm.fixedpoint_matmul = wrapper
    torch.cuda.synchronize()
    q_launches = {k: v for k, v in read_launches().items() if v}
    if q_launches != {"fixedpoint_matmul": 8 * 2, "wkv_scan": 2}:
        raise SystemExit(f"quantized rwkv6 prefill launches {q_launches}, "
                         "expected fixedpoint_matmul 16 and wkv_scan 2")
    if fmm.relayouts["fixedpoint_matmul"]:
        raise SystemExit(f"quantized rwkv6 prefill GEMM layout copies "
                         f"{fmm.relayouts}: expected none")
    # every GEMM of the path against its plain version on its own operands
    # (K-major slices of the stacked codes, the activations' codes)
    gemm_err, shapes = 0.0, {}
    for xc, wc, xs, ws, got in gemm_calls:
        want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
        gemm_err = max(gemm_err, float((got - want).abs().max()))
        shape = (xc.shape[0], xc.shape[1], wc.shape[1])
        shapes[shape] = shapes.get(shape, 0) + 1
        if not torch.equal(got, want) or wc.stride() != (1, wc.shape[0]):
            raise SystemExit(f"quantized rwkv6 prefill: the GEMM at (M, K, "
                             f"N) = {shape}, w strides {wc.stride()}, is not "
                             "equal to its plain version on K-major codes")
    if len(gemm_calls) != 8 * 2:
        raise SystemExit(f"quantized rwkv6 prefill: {len(gemm_calls)} GEMM "
                         "calls recorded, expected 16")
    log(f"kernel fixedpoint_matmul rwkv6-3b quantized prefill, the path's own "
        f"operands (K-major slices of the stacked codes): all "
        f"{len(gemm_calls)} calls equal to the plain version at (M, K, N) "
        f"{shapes} (max_abs_err {gemm_err})")
    del gemm_calls
    check_logits("quantized rwkv6 prefill", lq, (LM_BATCH, 1, cfg.vocab_size))
    q_nmse = nmse(model_q.prefill(p2, tokens=tokens).float(), lq.float())
    log(f"path rwkv6 quantized prefill (quantize_tree, 2 layers, bf16, "
        f"B={LM_BATCH} T={LM_SEQ}): launches {q_launches}, GEMM layout "
        f"copies 0; NMSE of the last-position logits "
        f"against the float prefill {q_nmse:.3e} (bound {LM_QUANT_NMSE})")
    if not q_nmse < LM_QUANT_NMSE:
        raise SystemExit(f"quantized rwkv6 prefill: NMSE {q_nmse} against "
                         f"the float prefill (bound {LM_QUANT_NMSE})")

    # two layers at full width in float32: the card against the CPU port
    cfg32 = cfg.replace(n_layers=2, dtype="float32")
    tok32 = tokens[:1, :150]  # 3 chunks, the last one padded
    on_cpu = tree_to(p2, "cpu")
    errs = {}
    for name, fn in (("forward", lambda p, t: rwkv6.forward(p, t, cfg32)[0]),
                     ("prefill", lambda p, t: rwkv6.prefill(p, t, cfg32))):
        on_card = fn(p2, tok32)
        check_logits(f"rwkv6 {name} float32", on_card,
                     (1, 150 if name == "forward" else 1, cfg.vocab_size))
        errs[name] = rel_err(on_card.cpu(), fn(on_cpu, tok32.cpu()))
    log(f"path rwkv6 card vs CPU port, 2 layers at full width, float32, B=1 "
        f"T=150 (3 chunks, the last padded): relative error forward "
        f"{errs['forward']:.3e}, prefill {errs['prefill']:.3e} (bound "
        f"{LM_CARD_VS_CPU})")
    if not max(errs.values()) < LM_CARD_VS_CPU:
        raise SystemExit(f"rwkv6 card vs CPU port: {errs}")

    heads, chunk = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_chunk
    return dict(launches=launches, prefill_s=prefill_s, gemm_err=gemm_err,
                gemm_launches=q_launches["fixedpoint_matmul"],
                prefill_tokens_per_s=LM_BATCH * LM_SEQ / prefill_s,
                generate_tokens_per_s=gen_tps, n_layers=cfg.n_layers,
                wkv_shape=(LM_BATCH * heads, -(-LM_SEQ // chunk), chunk,
                           cfg.rwkv_head_dim))


def wkv_numbers(dev, lm: dict, worst: float, card: str) -> dict:
    """Phase 5 for the WKV kernel at the prefill geometry (its work does not
    depend on the data, so seeded operands of the path's shape stand for
    the path's own)."""
    bh, nc, c, d = lm["wkv_shape"]
    args = wkv_operands(SEED + 60, bh, nc, c, d, dev)

    def call():
        wk.wkv_scan(*args)

    k_ms, q_ms = cuda_ms(call), queued_ms(call)
    p_ms = cuda_ms(lambda: ops.wkv_scan(*args, backend="ref"), reps=5,
                   inner=5)
    # the device kernels of one call, by name (CUDA events cannot split them)
    split, attempt = device_kernels(lambda: wk.wkv_scan(*args), "(")
    log(f"time wkv_scan per device kernel (profiler, 10 calls, session "
        f"{attempt}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items())
        + f"; {len(split)} device kernels per call [{card}]")
    if len(split) != 2:
        raise SystemExit(f"wkv_scan: expected two device kernels per call, "
                         f"the profiler saw {split}")
    # per chunk: the strictly lower triangles of a·bᵀ and scores·v
    # (C(C−1)/2 dot products of length D each), a·S and (b ⊙ tot)ᵀ·v, and
    # the elementwise diag ⊙ v (+ its add), b ⊙ tot and S ⊙ totᵀ (+ its add)
    n_ops = bh * nc * (2 * c * (c - 1) * d + 4 * c * d * d + 3 * c * d
                       + 2 * d * d)
    n_bytes = 4 * bh * nc * (4 * c * d + c + d)
    b_ms, b_by = bound_ms(n_bytes, n_ops, CUDA_CORE_OPS_PER_S)
    share = lm["n_layers"] * k_ms / (lm["prefill_s"] * 1e3)
    log(f"time wkv_scan (BH, NC, C, D) = ({bh}, {nc}, {c}, {d}): kernel "
        f"{k_ms:.4f} ms per call ({q_ms:.4f} ms queued, device only), plain "
        f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {n_ops / 1e9:.2f} GFLOP, "
        f"{n_bytes / 1e6:.1f} MB); {n_ops / (k_ms * 1e9):.2f} TFLOP/s; "
        f"{lm['launches']['wkv_scan']} launches per prefill, "
        f"{share:.4f} of the prefill's wall time [{card}]")
    return dict(KERNELS["wkv_scan"], launches=lm["launches"]["wkv_scan"],
                max_abs_err=worst, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------------------
# the transformer families: dense (qwen2-1.5b), MoE with MLA, VLM
# ---------------------------------------------------------------------------

# qwen2-1.5b at its own width and depth (src/repro/configs/qwen2_1_5b.py: 28
# layers, d_model 1536, 12 heads of 128, 2 KV heads, d_ff 8960, vocab
# 151936, bf16 activations, float32 parameters); prefill on B sequences of
# T seeded tokens, so attention takes the flash kernel (16 × 16 tiles of 128)
TF_ARCH = "qwen2-1.5b"
TF_BATCH, TF_SEQ = 4, 2048
TF_PROJECTIONS = 7  # wq wk wv wo up gate down: W8A8 GEMMs per layer
# the 7 transformer configs, at full width and 2 layers (deepseek-v2: 1,
# its expert stack is ≈15 GB a layer) in float32, card against CPU port
TF_CONFIGS = ("gemma-7b", "qwen2-1.5b", "chatglm3-6b", "granite-20b",
              "granite-moe-3b-a800m", "deepseek-v2-236b", "pixtral-12b")
TF_CARD_VS_CPU = 1e-3      # float32: summation order only
TF_DECODE_VS_FORWARD = 0.03  # the reference's (tests/test_arch_smoke.py:139)
TF_ABSORBED_VS_EXPANDED = 2e-3  # the reference's (tests/test_models_deep.py:41)
TF_PIXTRAL_LAYERS = 4      # of 40: 40 layers are ≈49 GB in float32


def transformer_params(cfg, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return transformer.init(g, cfg, device=dev), g


def free_card() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def checked_gemms(record: dict):
    """Every W8A8 GEMM the path launches, held ``torch.equal`` to its plain
    version on the operands the path gave it, at the call (the plain
    version launches nothing); ``record`` counts the calls by (M, K, N),
    the largest |Δ| and the weight layouts."""
    wrapper = fmm.fixedpoint_matmul
    record.update(shapes={}, err=0.0, calls=0, row_major=0, differ=0)

    def checked(xc, wc, xs, ws):
        out = wrapper(xc, wc, xs, ws)
        want = ops.fixedpoint_matmul(xc, wc, xs, ws, backend="ref")
        shape = (xc.shape[0], xc.shape[1], wc.shape[1])
        record["shapes"][shape] = record["shapes"].get(shape, 0) + 1
        record["err"] = max(record["err"], float((out - want).abs().max()))
        record["calls"] += 1
        record["row_major"] += wc.stride() != (1, wc.shape[0])
        record["differ"] += not torch.equal(out, want)
        return out

    fmm.fixedpoint_matmul = checked
    try:
        yield
    finally:
        fmm.fixedpoint_matmul = wrapper


def attention_vs_sdpa(dev, cfg, card: str) -> dict:
    """One layer's attention at the prefill's shapes (B=4, T=2048, 12 query
    and 2 KV heads of 128, bf16): the port's causal attention (the flash
    kernel on the grouped K/V) against
    ``F.scaled_dot_product_attention`` on the same operands, timed in
    turns.  SDPA is not on the path: its bf16 rounding is not the
    reference's."""
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    shape = (TF_BATCH, TF_SEQ)
    q = torch.randn((*shape, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((*shape, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        gqa = dict(enable_gqa=True)
    except TypeError:  # an older PyTorch: repeat the KV heads beforehand
        n_rep = cfg.n_heads // cfg.n_kv_heads
        kt, vt = (t.repeat_interleave(n_rep, dim=1) for t in (kt, vt))
        gqa = {}

    calls = {"port": lambda: TL._sdpa_causal(q, k, v, cfg),
             "sdpa": lambda: sdpa(qt, kt, vt, is_causal=True, **gqa)}
    ms = in_turns(calls, functools.partial(cuda_ms, reps=5, inner=3))
    diff = rel_err(calls["sdpa"]().transpose(1, 2), calls["port"]())
    log(f"time attention per layer {TF_ARCH} B={TF_BATCH} T={TF_SEQ} "
        f"H={cfg.n_heads} H_kv={cfg.n_kv_heads} D={cfg.head_dim} bf16, in "
        f"turns: the port (flash kernel) {ms['port']:.4f} ms, "
        f"F.scaled_dot_product_attention {ms['sdpa']:.4f} ms "
        f"({ms['port'] / ms['sdpa']:.2f}x){'' if gqa else ' (KV repeated first)'}"
        f"; max |Δ| / max |port| {diff:.3e} (bf16 rounding differs) "
        f"[{card}]")
    return dict(port_ms=ms["port"], sdpa_ms=ms["sdpa"])


# flash attention's forward at the LM prefill cells' shapes, bf16:
# qwen2-1.5b (B=4, 12 query heads over 2 KV heads, S=2048, (Dqk, Dv) =
# (128, 128)), deepseek-v2's MLA (B=4, 128 heads, S=4096, (192, 128)) and
# kimi-linear's MLA (B=2, 32 heads, S=16384, (192, 128))
FLASH_SHAPES = {"qwen2-1.5b": (4, 12, 2, 2048, 128, 128),
                "deepseek-v2 MLA": (4, 128, 128, 4096, 192, 128),
                "kimi-linear MLA": (2, 32, 32, 16384, 192, 128)}
# the card tests' limits (tests/test_torch_cuda.py): out within 2^-5 of the
# plain form (4 bf16 units at 1), lse within 1e-5, and no farther from
# float64 attention than the plain form x1.05
FLASH_ATOL, FLASH_LSE_TOL, FLASH_VS_EXACT = 2.0 ** -5, 1e-5, 1.05
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_TENSOR_FLOPS = 989.4e12


def flash_operands(dev, shape: tuple, seed: int) -> tuple:
    """Seeded bf16 q (pre-scaled by 1/√Dqk), k and v as the model hands them
    over: (B, S, H, D) tensors transposed to (B, H, S, D)."""
    b, h, hkv, s, dqk, dv = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, dqk, generator=g, device=dev) / math.sqrt(dqk)
    k = torch.randn(b, s, hkv, dqk, generator=g, device=dev)
    v = torch.randn(b, s, hkv, dv, generator=g, device=dev)
    return tuple(t.to(torch.bfloat16).transpose(1, 2) for t in (q, k, v))


def flash_plain(q, k, v) -> tuple:
    """``flash_attention``'s plain path: K/V repeated per query head, then
    the 512-block forward; (out, lse)."""
    n = q.shape[1] // k.shape[1]
    return FLASH._flash_fwd(q, FLASH._repeat_heads(k, n),
                            FLASH._repeat_heads(v, n), True, 512)


def exact_rel_l2(q, k, v, outs) -> list:
    """Relative L2 distance of each of ``outs`` from causal attention in
    float64 on the same operands, up to 8 query heads at a time (fewer
    past S = 4096, so that a group's S × S logits stay within 2 GiB)."""
    b, h, s, _ = q.shape
    heads = max(1, min(8, (1 << 28) // (s * s)))
    n = h // k.shape[1]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    num, den = [0.0] * len(outs), 0.0
    for i in range(b):
        for h0 in range(0, h, heads):
            idx = torch.arange(h0, min(h0 + heads, h), device=q.device)
            logits = q[i, idx].double() @ k[i, idx // n].double().mT
            exact = torch.softmax(logits.masked_fill_(~keep, float("-inf")),
                                  -1) @ v[i, idx // n].double()
            del logits
            den += float(exact.square().sum())
            for j, out in enumerate(outs):
                num[j] += float((out[i, idx].double() - exact).square().sum())
    return [math.sqrt(x / den) for x in num]


def check_flash_kernels(dev) -> float:
    """Phase 3 for the flash kernel at the LM cells' shapes: the wrapper on
    the grouped K/V against ``flash_attention``'s plain path, out within
    ``FLASH_ATOL`` and lse within ``FLASH_LSE_TOL``, no farther from float64
    attention than the plain form x ``FLASH_VS_EXACT``, a second call
    bit-equal, one launch a call.  Returns the largest |Δ| of out."""
    worst = 0.0
    for i, (label, shape) in enumerate(FLASH_SHAPES.items()):
        q, k, v = flash_operands(dev, shape, SEED + 70 + i)
        FLASH_KERNEL.reset_launches()
        out, lse = FLASH_KERNEL.flash_attention_fwd(q, k, v)
        out2, lse2 = FLASH_KERNEL.flash_attention_fwd(q, k, v)
        want, want_lse = flash_plain(q, k, v)
        torch.cuda.synchronize()
        launched = FLASH_KERNEL.launches["flash_attention"]
        same = torch.equal(out, out2) and torch.equal(lse, lse2)
        d_out = float((out.float() - want.float()).abs().max())
        d_lse = float((lse - want_lse).abs().max())
        e_kernel, e_plain = exact_rel_l2(q, k, v, (out, want))
        log(f"kernel flash_attention {label} (B, H, H_kv, S, Dqk, Dv) = "
            f"{shape} bf16: against the plain path max |Δ| out {d_out:.3e} "
            f"(bound {FLASH_ATOL:.3e}), lse {d_lse:.3e} (bound "
            f"{FLASH_LSE_TOL}); relative L2 to float64 kernel {e_kernel:.4e}, "
            f"plain {e_plain:.4e} (bound x{FLASH_VS_EXACT}); second call "
            f"{'bit-equal' if same else 'DIFFERS'}; launches {launched}")
        if not (launched == 2 and same and d_out <= FLASH_ATOL
                and d_lse <= FLASH_LSE_TOL
                and e_kernel <= FLASH_VS_EXACT * e_plain):
            raise SystemExit(f"flash_attention {label}: launches {launched}, "
                             f"bit-equal {same}, |Δ| out {d_out} lse "
                             f"{d_lse}, to float64 {e_kernel} vs plain "
                             f"{e_plain}")
        worst = max(worst, d_out)
        del q, k, v, out, lse, out2, lse2, want, want_lse
        free_card()
    return worst


def flash_numbers(dev, worst: float, launches: int, card: str) -> list:
    """Phase 5 for the flash kernel at each LM cell's shape: the kernel,
    ``flash_attention``'s plain path and F.scaled_dot_product_attention on
    the grouped K/V (its fused backends only) timed in turns, and the bound:
    S(S+1)/2 causal pairs a head at 2·(Dqk + Dv) FLOP each over the bf16
    tensor-core peak.  One JSON entry per shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [getattr(SDPBackend, n) for n in (
        "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
        if hasattr(SDPBackend, n)]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q, k, v):
        with sdpa_kernel(fused):
            return sdpa(q, k, v, is_causal=True, scale=1.0,
                        enable_gqa=k.shape[1] != q.shape[1])

    entries = []
    for i, (label, shape) in enumerate(FLASH_SHAPES.items()):
        b, h, hkv, s, dqk, dv = shape
        q, k, v = flash_operands(dev, shape, SEED + 70 + i)
        calls = {"kernel": functools.partial(
                     FLASH_KERNEL.flash_attention_fwd, q, k, v),
                 "plain": functools.partial(flash_plain, q, k, v),
                 "sdpa": functools.partial(library, q, k, v)}
        try:
            calls["sdpa"]()
        except (RuntimeError, TypeError) as e:  # no fused backend takes it
            log(f"time flash_attention {label}: SDPA left out ({e})")
            del calls["sdpa"]
        ms = in_turns(calls, functools.partial(cuda_ms, reps=5, inner=3))
        ops = b * h * s * (s + 1) * (dqk + dv)
        n_bytes = nbytes(q, k, v) + b * h * s * (2 * dv + 4)
        b_ms, b_by = bound_ms(n_bytes, ops, BF16_TENSOR_FLOPS)
        lib_ms = ms.get("sdpa")
        log(f"time flash_attention {label} (B, H, H_kv, S, Dqk, Dv) = "
            f"{shape} bf16, in turns: kernel {ms['kernel']:.4f} ms per call "
            f"({ops / (ms['kernel'] * 1e9):.1f} TFLOP/s, "
            f"{b_ms / ms['kernel']:.4f} of the bound), plain "
            f"{ms['plain']:.4f} ms, SDPA "
            f"{'not run' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
            f"{b_ms:.6f} ms ({b_by}; {ops / 1e12:.3f} TFLOP) [{card}]")
        entries.append(dict(KERNELS["flash_attention"], shape=label,
                            launches=launches, max_abs_err=worst,
                            ms=ms["kernel"], plain_ms=ms["plain"],
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        del q, k, v, calls
        free_card()
    return entries


@contextlib.contextmanager
def plain_quantize():
    """``absmax_quantize`` on its plain chain for the block: the row
    kernel bypassed."""
    rule = tq.row_kernel_applies
    tq.row_kernel_applies = lambda *a: False
    try:
        yield
    finally:
        tq.row_kernel_applies = rule


# the activation quantize's shapes on the qwen2 prefill: every projection
# but down (K = d_model) and down (K = d_ff), M = 4 · 2048 tokens
ROW_QUANT_SHAPES = {"K=1536": (TF_BATCH * TF_SEQ, D_MODEL),
                    "K=8960": (TF_BATCH * TF_SEQ, D_FF)}


def row_quant_input(dev, m: int, k: int, dtype, seed: int) -> torch.Tensor:
    """Normal rows at per-row power-of-two scales, with a zero row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    e = torch.randint(-12, 12, (m, 1), generator=g, device=dev).float()
    x = torch.randn(m, k, generator=g, device=dev) * torch.exp2(e)
    x[0] = 0.0
    return x.to(dtype)


def check_row_quantize_kernels(dev) -> int:
    """Phase 3 for the row quantize kernel: at the qwen2 prefill's two
    activation shapes in bf16 (4- and 8-bit codes), a K that is not a
    multiple of 8 (the scalar form), fp16 and fp32, the kernel's codes and
    scales against the plain chain's on the card bit for bit, one launch a
    call.  Returns the largest |Δ| of the codes (0)."""
    cases = [(label, m, k, torch.bfloat16, bits)
             for label, (m, k) in ROW_QUANT_SHAPES.items() for bits in (8, 4)]
    cases += [("K=8961", TF_BATCH * TF_SEQ, D_FF + 1, torch.bfloat16, 8),
              ("K=1536", TF_BATCH * TF_SEQ, D_MODEL, torch.float16, 8),
              ("K=1536", TF_BATCH * TF_SEQ, D_MODEL, torch.float32, 8)]
    for i, (label, m, k, dtype, bits) in enumerate(cases):
        x = row_quant_input(dev, m, k, dtype, SEED + 80 + i)
        before = ROW_QUANT.launches["row_quantize"]
        codes, scale = tq.absmax_quantize(x, bits=bits)
        launched = ROW_QUANT.launches["row_quantize"] - before
        with plain_quantize():
            want_c, want_s = tq.absmax_quantize(x, bits=bits)
        torch.cuda.synchronize()
        ok = (launched == 1 and torch.equal(codes, want_c)
              and torch.equal(scale, want_s))
        log(f"kernel row_quantize {label} M={m} {dtype} bits={bits}: codes "
            f"and scales {'equal' if ok else 'DIFFER'} to the plain chain; "
            f"launches {launched}")
        if not ok:
            raise SystemExit(f"row_quantize {label} {dtype} bits={bits}: "
                             f"launches {launched}, differs from the plain "
                             "chain")
        del x, codes, scale, want_c, want_s
    return 0


def row_quantize_numbers(dev, launches: int, card: str) -> list:
    """Phase 5 for the row quantize kernel at the qwen2 prefill's two
    activation shapes (bf16): the kernel (codes, scale and its float32
    copy) and the plain chain with the float32 cast of its scale that
    ``w8a8_matmul_int`` adds, timed in turns per call and queued, and the
    bound: a bf16 read and an int8 write per element, the bf16 and float32
    scales per row, over HBM bandwidth.  One JSON entry per shape."""
    entries = []
    for i, (label, (m, k)) in enumerate(ROW_QUANT_SHAPES.items()):
        x = row_quant_input(dev, m, k, torch.bfloat16, SEED + 90 + i)

        def plain():
            with plain_quantize():
                _, xs = tq.absmax_quantize(x)
            return xs.reshape(-1, 1).to(torch.float32).contiguous()

        calls = {"kernel": lambda: ROW_QUANT.row_quantize(x),
                 "plain": plain}
        per_call = in_turns(calls, cuda_ms)
        queued = in_turns(calls, queued_ms)
        b_ms, b_by = bound_ms(m * k * 3 + m * (2 + 4), 0, 1.0)
        log(f"time row_quantize {label} M={m} bf16: kernel "
            f"{per_call['kernel']:.4f} ms per call ({queued['kernel']:.4f} "
            f"queued, device only; {b_ms / queued['kernel']:.4f} of the "
            f"bound), plain chain {per_call['plain']:.4f} ms "
            f"({queued['plain']:.4f} queued), bound {b_ms:.6f} ms ({b_by}) "
            f"[{card}]")
        entries.append(dict(KERNELS["row_quantize"], shape=label,
                            launches=launches, max_abs_err=0,
                            ms=per_call["kernel"], queued_ms=queued["kernel"],
                            plain_ms=per_call["plain"], bound_ms=b_ms,
                            bound_by=b_by, library_ms=None))
        del x
    return entries


# the SSD scan at Zamba2-7B's per-layer shape on the benchmark's prefill
# (4 × 4096 positions, 112 heads of 64 in 2 groups, state 64, bf16 x, B, C)
# and around it: one position, ragged chunks, one group, strong decays
# (dt up to 2, A down to −112), B and C of group 0 expanded (stride 0), fp32
SSD_CELL = (4, 4096, 112, 2)
SSD_CASES = [("cell", SSD_CELL, torch.bfloat16, False, False),
             ("cell strong", SSD_CELL, torch.bfloat16, True, False),
             ("cell group 0", SSD_CELL, torch.bfloat16, False, True),
             ("T=1", (1, 1, 112, 2), torch.bfloat16, True, False),
             ("T=4097", (1, 4097, 16, 2), torch.bfloat16, True, False),
             ("T=65 G=1", (4, 65, 8, 1), torch.float32, True, False)]
SSD_TOL = 1e-4  # relative L2 against the plain float32 form (TF32: ≈1e-3)


def ssd_operands(dev, shape, dtype, strong: bool, expand: bool, seed: int):
    """x, B, C normal; A = −1 … −H as Zamba2 initialises it; dt
    log-uniform over [1e-3, 0.1] (its dt_bias) or, strong, uniform over
    [0, 2]; with ``expand`` B and C are group 0's, expanded."""
    b, t, h, grp = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, h, 64, generator=gen, device=dev).to(dtype)
    bm = torch.randn(b, t, grp, 64, generator=gen, device=dev).to(dtype)
    cm = torch.randn(b, t, grp, 64, generator=gen, device=dev).to(dtype)
    u = torch.rand(b, t, h, generator=gen, device=dev)
    dt = 2 * u if strong else torch.exp(u * math.log(100.0) + math.log(1e-3))
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    if expand:
        bm, cm = (m[:, :, :1].expand_as(m) for m in (bm, cm))
    return x, bm, cm, dt, a


def ssd_plain(x, bm, cm, dt, a):
    """``zamba2.ssd``'s plain prefill: the float32 copies, then
    ``ssm.ssd_grouped`` in chunks of 64."""
    f32 = torch.float32
    return SSM.ssd_grouped(x.to(f32), bm.to(f32), cm.to(f32), dt, a, 64)


def ssd_errors(got: tuple, want: tuple) -> tuple:
    """The largest relative L2 and the largest absolute difference of y and
    the final state against the plain form's."""
    rel = ab = 0.0
    for g, w in zip(got, want):
        d = g.double() - w.double()
        rel = max(rel, float(d.norm() / w.double().norm()))
        ab = max(ab, float(d.abs().max()))
    return rel, ab


def check_ssd_kernels(dev) -> tuple:
    """Phase 3 for the SSD scan: y and the final state against the plain
    float32 form at relative L2 ``SSD_TOL``, one launch a call.  Returns
    the largest relative L2 and the largest absolute difference."""
    worst = (0.0, 0.0)
    for i, (label, shape, dtype, strong, expand) in enumerate(SSD_CASES):
        ops_ = ssd_operands(dev, shape, dtype, strong, expand, SEED + 100 + i)
        before = SSD_SCAN.launches["ssd_scan"]
        got = SSD_SCAN.ssd_scan(*ops_)
        launched = SSD_SCAN.launches["ssd_scan"] - before
        want = ssd_plain(*ops_)
        torch.cuda.synchronize()
        rel, ab = ssd_errors(got, want)
        log(f"kernel ssd_scan {label} (B, T, H, G) = {shape} {dtype}: "
            f"relative L2 {rel:.3e} (max_abs_err {ab:.3e}), y and state, "
            f"against the plain float32 form; launches {launched}")
        if launched != 1 or not rel <= SSD_TOL:
            raise SystemExit(f"ssd_scan {label}: launches {launched}, "
                             f"relative L2 {rel} above {SSD_TOL}")
        worst = (max(worst[0], rel), max(worst[1], ab))
        del ops_, got, want
    free_card()
    return worst


# zamba2-7b (src/repro_torch/configs/zamba2_7b.py) at its published widths
# in bf16, cut to ZAMBA7_LAYERS Mamba layers and one application of each
# shared block, on the benchmark cell's prefill (4 × 4096 seeded tokens):
# models/zamba2.py sends every prefill SSD to the scan kernel
ZAMBA7_ARCH = "zamba2-7b"
ZAMBA7_LAYERS, ZAMBA7_SHARED = 4, (1, 3)
ZAMBA7_BATCH, ZAMBA7_SEQ = 4, 4096


def run_zamba2_7b_prefill(dev, card: str) -> dict:
    """The zamba2-7b prefill through ``models/zamba2.py`` with the counters
    zeroed right before it: every prefill SSD on the kernel (``ssd_kernel``
    = layers, ``ssd_plain`` 0, one launch each), each call within
    ``SSD_TOL`` of the plain float32 form on its own operands; then the
    prefill timed with the kernel and with the plain form, in turns."""
    from repro_torch.models import zamba2 as Z
    cfg = get_config(ZAMBA7_ARCH).replace(n_layers=ZAMBA7_LAYERS,
                                          hybrid_layer_ids=ZAMBA7_SHARED)
    g = torch.Generator(device=dev).manual_seed(SEED + 112)
    params = Z.init(g, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (ZAMBA7_BATCH, ZAMBA7_SEQ),
                           generator=g, device=dev)
    ssd, rule = Z.ssd, Z.ssd_kernel_applies
    errs = []

    def checked(xh, bmat, cmat, dt, a, chunk, state=None):
        out = ssd(xh, bmat, cmat, dt, a, chunk, state)
        if state is None:
            errs.append(ssd_errors(out, ssd_plain(xh, bmat, cmat, dt, a)))
        return out

    def plain():
        Z.ssd_kernel_applies = lambda *a: False
        try:
            return Z.prefill(params, tokens, cfg)
        finally:
            Z.ssd_kernel_applies = rule

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    label = (f"{ZAMBA7_ARCH} prefill ({ZAMBA7_LAYERS} Mamba-2 layers at the "
             f"published widths, bf16, B={ZAMBA7_BATCH} T={ZAMBA7_SEQ})")
    with torch.no_grad():
        Z.prefill(params, tokens, cfg)  # first call: allocator and cuBLAS
        torch.cuda.synchronize()
        Z.zamba2_stats.reset()
        SSD_SCAN.reset_launches()
        Z.ssd = checked
        try:
            logits = Z.prefill(params, tokens, cfg)
        finally:
            Z.ssd = ssd
        torch.cuda.synchronize()
        paths = (Z.zamba2_stats.ssd_kernel, Z.zamba2_stats.ssd_plain)
        launches = SSD_SCAN.launches["ssd_scan"]
        check_logits(label, logits, (ZAMBA7_BATCH, 1, cfg.vocab_size))
        rel = max((e[0] for e in errs), default=math.inf)
        ab = max((e[1] for e in errs), default=math.inf)
        if (paths != (ZAMBA7_LAYERS, 0) or launches != ZAMBA7_LAYERS
                or len(errs) != ZAMBA7_LAYERS or not rel <= SSD_TOL):
            raise SystemExit(f"{label}: prefill SSDs (kernel, plain) {paths},"
                             f" launches {launches}, {len(errs)} checked, "
                             f"relative L2 {rel} (bound {SSD_TOL}); expected "
                             f"{ZAMBA7_LAYERS} kernel, 0 plain")
        plain()
        secs = in_turns({"kernel": lambda: Z.prefill(params, tokens, cfg),
                         "plain": plain},
                        lambda fn: statistics.median(wall(fn)
                                                     for _ in range(3)))
        want = plain()
    logits_l2 = float((logits.float() - want.float()).norm()
                      / want.float().norm())
    log(f"path {label}: prefill SSDs kernel {paths[0]}, plain {paths[1]}, "
        f"ssd_scan launches {launches}; each call against the plain float32 "
        f"form on its own operands: relative L2 ≤ {rel:.3e} (max_abs_err "
        f"{ab:.3e}); last-position logits finite, relative L2 {logits_l2:.3e}"
        f" against the plain form's; {secs['kernel']:.4f} s a prefill with "
        f"the kernel, {secs['plain']:.4f} s with the plain form (host wall, "
        f"the card synchronised, median of 3, in turns) [{card}]")
    del params, tokens, logits, want
    free_card()
    return dict(launches=launches, rel_l2=rel, max_abs_err=ab,
                prefill_s=secs["kernel"], plain_prefill_s=secs["plain"])


# kimi-linear-48b (src/repro_torch/configs/kimi_linear_48b.py) at its
# published widths in bf16, cut to its first KIMI_LAYERS layers (KDA, KDA,
# KDA, MLA; the first dense, the others MoE of 256 experts), on the Kimi
# cell's prefill (2 × 16384 seeded tokens): MLA's attention at (192, 128)
# over 16384 positions goes to the flash kernel
KIMI_ARCH = "kimi-linear-48b"
KIMI_LAYERS = 4
KIMI_BATCH, KIMI_SEQ = 2, 16384


def run_kimi_linear_prefill(dev, card: str) -> dict:
    """The kimi-linear-48b prefill through ``models/kimi_linear.py`` with
    the flash counters zeroed right before it: every MLA layer's attention
    on the flash kernel (kernel calls = launches = MLA layers, none
    plain; ``flash_attention`` falls back to its plain form without
    raising), the KDA and MoE counters as the layers give them, the
    logits finite."""
    from repro_torch.models import kimi_linear as KL
    cfg = get_config(KIMI_ARCH).replace(n_layers=KIMI_LAYERS)
    n_kda = sum(KL.is_kda(cfg, i) for i in range(KIMI_LAYERS))
    n_mla = KIMI_LAYERS - n_kda
    g = torch.Generator(device=dev).manual_seed(SEED + 113)
    params = KL.init(g, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (KIMI_BATCH, KIMI_SEQ),
                           generator=g, device=dev)
    label = (f"{KIMI_ARCH} prefill ({n_kda} KDA + {n_mla} MLA layers at the "
             f"published widths, bf16, B={KIMI_BATCH} T={KIMI_SEQ})")
    with torch.no_grad():
        KL.prefill(params, tokens, cfg)  # first call: allocator and cuBLAS
        torch.cuda.synchronize()
        KL.kimi_stats.reset()
        TL.moe_stats.reset()
        reset_flash_calls()
        t0 = time.perf_counter()
        logits = KL.prefill(params, tokens, cfg)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    check_logits(label, logits, (KIMI_BATCH, 1, cfg.vocab_size))
    launches = check_flash_calls(label, n_mla)
    layers = (KL.kimi_stats.kda_layers, KL.kimi_stats.mla_layers,
              TL.moe_stats.layer_calls)
    want = (n_kda, n_mla, KIMI_LAYERS - cfg.first_k_dense_replace)
    if layers != want:
        raise SystemExit(f"{label}: (KDA, MLA, MoE) layer calls {layers}, "
                         f"expected {want}")
    log(f"path {label}: flash_attention launches {launches}, kernel calls "
        f"{FLASH.flash_stats.kernel}, plain {FLASH.flash_stats.plain}; "
        f"(KDA, MLA, MoE) layer calls {layers}; last-position logits "
        f"finite; {prefill_s:.4f} s a prefill (host wall, the card "
        f"synchronised, one call) [{card}]")
    del params, tokens, logits
    free_card()
    return dict(flash_launches=launches, prefill_s=prefill_s)


def ssd_numbers(dev, worst: tuple, launches: int, card: str) -> dict:
    """Phase 5 for the SSD scan at the cell's per-layer shape (bf16): the
    kernel per call and queued and the plain form (the float32 copies and
    ``ssm.ssd_grouped``), in turns, and the benchmark's bound of the layer's
    SSD (``portbench/work_zamba2.ssd_bound_s``: its bytes at HBM bandwidth
    at the published chunk, 256)."""
    from portbench import work_zamba2
    sizes = json.loads((Path(__file__).resolve().parent / "portbench"
                        / "configs" / "zamba2_7b.json").read_text())
    b, t = SSD_CELL[0], SSD_CELL[1]
    ops_ = ssd_operands(dev, SSD_CELL, torch.bfloat16, False, False,
                        SEED + 110)
    calls = {"kernel": lambda: SSD_SCAN.ssd_scan(*ops_),
             "plain": lambda: ssd_plain(*ops_)}
    per_call = in_turns(calls, lambda fn: cuda_ms(fn, reps=7, inner=5))
    queued = queued_ms(calls["kernel"], reps=5, inner=5)
    b_ms = work_zamba2.ssd_bound_s(sizes, b, t) * 1e3
    log(f"time ssd_scan (B, T, H, G, P, N) = {SSD_CELL + (64, 64)} bf16: "
        f"kernel {per_call['kernel']:.4f} ms per call ({queued:.4f} queued; "
        f"{b_ms / per_call['kernel']:.4f} of the bound), plain "
        f"{per_call['plain']:.4f} ms, bound {b_ms:.6f} ms (bytes) [{card}]")
    del ops_
    free_card()
    return dict(KERNELS["ssd_scan"], shape="4x4096 112x64 G=2 N=64",
                launches=launches, rel_l2=worst[0], max_abs_err=worst[1],
                ms=per_call["kernel"],
                queued_ms=queued, plain_ms=per_call["plain"], bound_ms=b_ms,
                bound_by="bytes", library_ms=None)


def check_flash_calls(label: str, want: int) -> int:
    """After a run that began with ``FLASH_KERNEL.reset_launches()`` and
    ``FLASH.flash_stats.reset()``: every ``flash_attention`` call took the
    kernel, ``want`` calls and launches.  Returns the launches."""
    got = (FLASH_KERNEL.launches["flash_attention"], FLASH.flash_stats.kernel,
           FLASH.flash_stats.plain)
    if got != (want, want, 0):
        raise SystemExit(f"{label}: flash kernel launches, kernel calls and "
                         f"plain calls {got}, expected ({want}, {want}, 0)")
    return want


def reset_flash_calls() -> None:
    FLASH_KERNEL.reset_launches()
    FLASH.flash_stats.reset()


def run_qwen2_full(dev, card: str) -> dict:
    """qwen2-1.5b at full width and depth: the float prefill (flash
    attention's forward on its kernel, no other kernel of the port's own),
    the attention against SDPA, ``LMServer`` with a same-structure hot swap,
    and the quantized prefill with every projection on the W8A8 kernel."""
    cfg = get_config(TF_ARCH)
    params, g = transformer_params(cfg, SEED + 31, dev)
    tokens = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_SEQ),
                           generator=g, device=dev)
    n_params = tree_numel(params)
    model = build_model(cfg, device=dev)

    torch.cuda.synchronize()
    reset_launches()
    reset_flash_calls()
    logits = model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    if launches:
        raise SystemExit(f"{TF_ARCH} float prefill launched {launches}: "
                         "expected no kernel of the port's own but flash "
                         "attention's")
    flash_launches = check_flash_calls(f"{TF_ARCH} float prefill",
                                       cfg.n_layers)
    check_logits(f"{TF_ARCH} prefill", logits,
                 (TF_BATCH, 1, cfg.vocab_size))
    t0 = time.perf_counter()
    model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    log(f"path transformer prefill {TF_ARCH} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f}e9 float32 parameters, bf16 "
        f"activations) on B={TF_BATCH} T={TF_SEQ}: flash_attention "
        f"launches {flash_launches}, every call; last-position logits "
        f"{tuple(logits.shape)}, finite; {prefill_s:.4f} s, "
        f"{TF_BATCH * TF_SEQ / prefill_s:.0f} tokens/s (warm, host wall "
        f"with the card synchronised) [{card}]")
    attn = attention_vs_sdpa(dev, cfg, card)

    # LMServer at full width and depth, with a same-structure hot swap
    srv = LMServer(cfg, batch=8, max_seq=256, device=dev)
    srv.install(TF_ARCH, params)
    prompt = np.random.default_rng(SEED + 32).integers(0, cfg.vocab_size,
                                                       (8, 16))
    out = srv.generate(TF_ARCH, prompt, 32)
    decode_tps = srv.tokens_per_second()
    traces = srv.trace_count
    params_b, _ = transformer_params(cfg, SEED + 33, dev)
    srv.install(TF_ARCH, params_b)
    out_b = srv.generate(TF_ARCH, prompt, 4)
    traces_b = srv.trace_count
    del params_b, srv
    free_card()
    log(f"path transformer LMServer(batch=8, max_seq=256) {TF_ARCH} at full "
        f"width and depth: 16-token prompt + 32 greedy tokens, then 4 after "
        f"a same-structure install: trace_count {traces} then {traces_b}; "
        f"{decode_tps:.1f} tokens/s (prompt and new tokens, one decode_step "
        f"per position, host wall with the card synchronised) [{card}]")
    if (out.shape != (8, 32) or out_b.shape != (8, 4) or out.min() < 0
            or out.max() >= cfg.vocab_size or traces != 1 or traces_b != 1):
        raise SystemExit(f"transformer LMServer: tokens {out.shape} "
                         f"{out_b.shape}, trace_count {traces} {traces_b}")

    # the quantized prefill at full depth: every projection on the kernel
    q = tq.quantize_tree(params)
    record = {}
    torch.cuda.synchronize()
    reset_launches()
    reset_flash_calls()
    tq.quantize_stats.reset()
    ROW_QUANT.reset_launches()
    with checked_gemms(record):
        lq = model.prefill(q, tokens=tokens)
    torch.cuda.synchronize()
    q_launches = {k: v for k, v in read_launches().items() if v}
    flash_launches += check_flash_calls(f"quantized {TF_ARCH} prefill",
                                        cfg.n_layers)
    want = TF_PROJECTIONS * cfg.n_layers
    quant = (tq.quantize_stats.kernel, tq.quantize_stats.plain,
             ROW_QUANT.launches["row_quantize"])
    log(f"quantized {TF_ARCH} prefill: activation quantizes (kernel calls, "
        f"plain calls, row_quantize launches) {quant}")
    if quant != (want, 0, want):
        raise SystemExit(f"quantized {TF_ARCH} prefill: activation quantizes "
                         f"(kernel, plain, launches) {quant}, expected "
                         f"({want}, 0, {want})")
    if q_launches != {"fixedpoint_matmul": want}:
        raise SystemExit(f"quantized {TF_ARCH} prefill launches {q_launches}, "
                         f"expected fixedpoint_matmul {want}")
    if fmm.relayouts["fixedpoint_matmul"] or record["row_major"]:
        raise SystemExit(f"quantized {TF_ARCH} prefill: GEMM layout copies "
                         f"{fmm.relayouts}, row-major codes "
                         f"{record['row_major']}: expected none")
    if record["calls"] != want or record["differ"]:
        raise SystemExit(f"quantized {TF_ARCH} prefill: {record['calls']} "
                         f"GEMM calls, {record['differ']} differ from the "
                         "plain version")
    check_logits(f"quantized {TF_ARCH} prefill", lq,
                 (TF_BATCH, 1, cfg.vocab_size))
    log(f"kernel fixedpoint_matmul {TF_ARCH} quantized prefill at full depth "
        f"({cfg.n_layers} layers, B={TF_BATCH} T={TF_SEQ}), the path's own "
        f"operands (K-major slices of the stacked codes): launches "
        f"{q_launches} and flash_attention {cfg.n_layers}, GEMM layout "
        f"copies 0; all {record['calls']} calls "
        f"equal to the plain version at (M, K, N) {record['shapes']} "
        f"(max_abs_err {record['err']})")
    t0 = time.perf_counter()
    model.prefill(q, tokens=tokens)
    torch.cuda.synchronize()
    q_prefill_s = time.perf_counter() - t0
    del q, lq
    # NMSE against the float logits at 2 layers, the reference's budget
    cfg2 = cfg.replace(n_layers=2)
    p2 = layer_slice(params, 2)
    model2 = build_model(cfg2, device=dev)
    q_nmse = nmse(model2.prefill(p2, tokens=tokens).float(),
                  model2.prefill(tq.quantize_tree(p2), tokens=tokens).float())
    log(f"path transformer quantized prefill {TF_ARCH}: {q_prefill_s:.4f} s "
        f"at full depth, {TF_BATCH * TF_SEQ / q_prefill_s:.0f} tokens/s "
        f"({TF_PROJECTIONS * cfg.n_layers} W8A8 GEMMs); at 2 layers NMSE of "
        f"the last-position logits against the float prefill {q_nmse:.3e} "
        f"(bound {LM_QUANT_NMSE}) [{card}]")
    if not q_nmse < LM_QUANT_NMSE:
        raise SystemExit(f"quantized {TF_ARCH} prefill: NMSE {q_nmse}")
    del params, p2, logits
    free_card()
    return dict(launches=q_launches, gemm_err=record["err"],
                flash_launches=flash_launches, quantize_launches=want,
                prefill_tokens_per_s=TF_BATCH * TF_SEQ / prefill_s,
                quantized_prefill_tokens_per_s=TF_BATCH * TF_SEQ / q_prefill_s,
                decode_tokens_per_s=decode_tps, **attn)


def host_gib_available() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return 0.0


def card_vs_cpu(label: str, fn, params, on_cpu, args, cpu_args) -> float:
    on_card = fn(params, *args)
    if not bool(torch.isfinite(on_card).all()):
        raise SystemExit(f"{label}: non-finite logits on the card")
    err = rel_err(on_card.cpu(), fn(on_cpu, *cpu_args))
    if not err < TF_CARD_VS_CPU:
        raise SystemExit(f"{label}: card vs CPU port {err} (bound "
                         f"{TF_CARD_VS_CPU})")
    return err


def decode_vs_forward(params, tok, cfg) -> float:
    """16 decode steps from zeroed caches against the forward logits."""
    full, _ = transformer.forward(params, tok, cfg)
    caches = transformer.init_caches(cfg, tok.shape[0], tok.shape[1],
                                     device=tok.device)
    steps = []
    for t in range(tok.shape[1]):
        pos = torch.full((tok.shape[0],), t, dtype=torch.int32,
                         device=tok.device)
        step, caches = transformer.decode_step(params, caches,
                                               tok[:, t:t + 1], pos, cfg)
        steps.append(step[:, 0])
    return rel_err(torch.stack(steps, dim=1), full)


def check_config(dev, arch: str, seed: int, card: str) -> None:
    """One config at full width, 2 layers (deepseek-v2: 1), float32:
    forward and prefill on the card against the CPU port, decode against
    forward on the card (MoE dropless), and the config's own checks."""
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=1 if cfg.mla else 2, dtype="float32")
    params, g = transformer_params(cfg, seed, dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=dev)
    pe = (torch.randn((2, cfg.n_patches, cfg.d_model), generator=g,
                      device=dev) if cfg.family == "vlm" else None)
    gib = 4 * tree_numel(params) / 2 ** 30
    avail = host_gib_available()
    fns = {"forward": lambda p, t, e: transformer.forward(
               p, t, cfg, patch_embeds=e)[0],
           "prefill": lambda p, t, e: transformer.prefill(
               p, t, cfg, patch_embeds=e)}
    errs = {}
    if avail > 2.5 * gib:
        on_cpu = tree_to(params, "cpu")
        cpu_pe = None if pe is None else pe.cpu()
        for name, fn in fns.items():
            errs[name] = card_vs_cpu(f"{arch} {name}", fn, params, on_cpu,
                                     (tok, pe), (tok.cpu(), cpu_pe))
        if arch == TF_ARCH:  # the padded flash route: 640 = 512 + 128
            long = torch.randint(0, cfg.vocab_size, (2, 640), generator=g,
                                 device=dev)
            for name, fn in fns.items():
                errs[f"{name} T=640"] = card_vs_cpu(
                    f"{arch} {name} T=640", fn, params, on_cpu,
                    (long, None), (long.cpu(), None))
        if cfg.kv_cache_bits == 0 and arch == "chatglm3-6b":
            cfg8 = cfg.replace(kv_cache_bits=8)
            got, want = [], []
            for p, out, d in ((params, got, dev), (on_cpu, want, "cpu")):
                caches = transformer.init_caches(cfg8, 2, 16, device=d)
                for t in range(16):
                    pos = torch.full((2,), t, dtype=torch.int32, device=d)
                    step, caches = transformer.decode_step(
                        p, caches, tok[:, t:t + 1].to(d), pos, cfg8)
                    out.append(step[:, 0].float().cpu())
            errs["int8 KV decode"] = rel_err(torch.stack(got, 1),
                                             torch.stack(want, 1))
            same = bool(torch.equal(torch.stack(got, 1).argmax(-1),
                                    torch.stack(want, 1).argmax(-1)))
            if not (errs["int8 KV decode"] < TF_CARD_VS_CPU and same):
                raise SystemExit(f"{arch} int8 KV decode, card vs CPU: "
                                 f"{errs['int8 KV decode']}, greedy tokens "
                                 f"{'equal' if same else 'differ'}")
        del on_cpu
    else:  # the host cannot hold a CPU copy: the attention alone there
        blk = layer_params(params["blocks"], 0)
        x = torch.randn((2, 64, cfg.d_model), generator=g, device=dev) * 0.3
        attn = MLA.mla_attention if cfg.mla else TL.attention
        errs["attention alone"] = rel_err(
            attn(blk["attn"], x, cfg)[0].cpu(),
            attn(tree_to(blk["attn"], "cpu"), x.cpu(), cfg)[0])
        if not errs["attention alone"] < TF_CARD_VS_CPU:
            raise SystemExit(f"{arch} attention alone, card vs CPU: {errs}")
    cfg_d = cfg.replace(moe_capacity_factor=float(cfg.n_experts or 1.25))
    errs["decode vs forward"] = decode_vs_forward(params, tok[:, :16], cfg_d)
    if not errs["decode vs forward"] < TF_DECODE_VS_FORWARD:
        raise SystemExit(f"{arch} decode vs forward on the card: {errs}")
    if cfg.mla:
        blk = layer_params(params["blocks"], 0)["attn"]
        x = torch.randn((2, 16, cfg.d_model), generator=g, device=dev) * 0.3
        full, _ = MLA.mla_attention(blk, x, cfg)
        cache = MLA.init_mla_cache(cfg, 2, 16, torch.float32, device=dev)
        outs = []
        for t in range(16):
            o, cache = MLA.mla_attention(
                blk, x[:, t:t + 1], cfg, cache=cache,
                pos=torch.full((2,), t, dtype=torch.int32, device=dev))
            outs.append(o[:, 0])
        errs["MLA absorbed vs expanded"] = rel_err(torch.stack(outs, 1), full)
        if not errs["MLA absorbed vs expanded"] < TF_ABSORBED_VS_EXPANDED:
            raise SystemExit(f"{arch} MLA absorbed vs expanded: {errs}")
    log(f"path transformer {arch} at full width (d_model {cfg.d_model}), "
        f"{cfg.n_layers} layer(s), float32, B=2 T=64"
        f"{f' + {cfg.n_patches} patches' if pe is not None else ''} "
        f"({gib:.1f} GiB of parameters; {avail:.0f} GiB free on the host): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bounds: card vs CPU {TF_CARD_VS_CPU}, decode "
        f"{TF_DECODE_VS_FORWARD}, MLA {TF_ABSORBED_VS_EXPANDED}) [{card}]")
    del params
    free_card()


@contextlib.contextmanager
def moe_ranges():
    """Profiler ranges around each MoE layer and around its expert GEMMs
    (the three einsums over the expert axis), by patching the module's
    ``moe_ffn`` and ``torch.einsum`` for the profiled run only."""
    moe, einsum = TL.moe_ffn, torch.einsum
    experts = {"ecd,edf->ecf", "ecf,efd->ecd"}

    def ranged_moe(*a, **kw):
        with torch.profiler.record_function("moe_ffn"):
            return moe(*a, **kw)

    def ranged_einsum(eq, *a, **kw):
        if eq in experts:
            with torch.profiler.record_function("moe_experts"):
                return einsum(eq, *a, **kw)
        return einsum(eq, *a, **kw)

    TL.moe_ffn, torch.einsum = ranged_moe, ranged_einsum
    try:
        yield
    finally:
        TL.moe_ffn, torch.einsum = moe, einsum


def run_granite_moe_full(dev, card: str) -> dict:
    """granite-moe-3b-a800m at full width and depth (32 layers, 40 experts,
    top-8): prefill on 4 × 2048 tokens, and the MoE layers' device time
    split by the profiler into the expert GEMMs and the rest (routing,
    dispatch and combine)."""
    cfg = get_config("granite-moe-3b-a800m")
    params, g = transformer_params(cfg, SEED + 50, dev)
    tokens = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_SEQ),
                           generator=g, device=dev)
    model = build_model(cfg, device=dev)
    logits = model.prefill(params, tokens=tokens)
    check_logits("granite-moe prefill", logits, (TF_BATCH, 1, cfg.vocab_size))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with moe_ranges():
            model.prefill(params, tokens=tokens)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ms = {e.key: e.device_time_total / 1e3 for e in events
          if e.key in ("moe_ffn", "moe_experts")}
    # the kernels themselves (an operator's entry repeats its kernels' time)
    total = sum(e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key not in ms) / 1e3
    moe_ms, exp_ms = ms.get("moe_ffn", 0.0), ms.get("moe_experts", 0.0)
    share = (moe_ms - exp_ms) / total if total else float("nan")
    # a cross-check by CUDA events: one MoE layer on a seeded hidden state
    h = torch.randn((TF_BATCH * TF_SEQ, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    blk = layer_params(params["blocks"], 0)["moe"]
    layer_ms = cuda_ms(lambda: TL.moe_ffn(blk, h, cfg), reps=5, inner=2)
    log(f"path transformer prefill granite-moe-3b-a800m ({cfg.n_layers} "
        f"layers, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"{tree_numel(params) / 1e9:.3f}e9 float32 parameters) on "
        f"B={TF_BATCH} T={TF_SEQ}: {prefill_s:.4f} s, "
        f"{TF_BATCH * TF_SEQ / prefill_s:.0f} tokens/s (warm, host wall) "
        f"[{card}]")
    log(f"time granite-moe prefill by the profiler (device time, one "
        f"prefill): all kernels {total:.2f} ms; MoE layers {moe_ms:.2f} ms, "
        f"of which the expert GEMMs {exp_ms:.2f} ms and routing, dispatch "
        f"and combine {moe_ms - exp_ms:.2f} ms ({share:.4f} of the "
        f"prefill's device time); one MoE layer on a seeded hidden state "
        f"by CUDA events {layer_ms:.4f} ms (x {cfg.n_layers} = "
        f"{layer_ms * cfg.n_layers:.2f} ms) [{card}]")
    del params, logits
    free_card()
    return dict(prefill_tokens_per_s=TF_BATCH * TF_SEQ / prefill_s,
                device_ms=total, moe_ms=moe_ms, experts_ms=exp_ms,
                dispatch_share=share)


def run_pixtral_cut(dev, card: str) -> dict:
    """pixtral-12b at full width, cut to 4 of its 40 layers: prefill on
    4 × (256 patch embeddings + 1792 text tokens)."""
    cfg = get_config("pixtral-12b").replace(n_layers=TF_PIXTRAL_LAYERS)
    params, g = transformer_params(cfg, SEED + 51, dev)
    text = TF_SEQ - cfg.n_patches
    tokens = torch.randint(0, cfg.vocab_size, (TF_BATCH, text), generator=g,
                           device=dev)
    pe = torch.randn((TF_BATCH, cfg.n_patches, cfg.d_model), generator=g,
                     device=dev)
    model = build_model(cfg, device=dev)
    logits = model.prefill(params, tokens=tokens, patch_embeds=pe)
    check_logits("pixtral prefill", logits, (TF_BATCH, 1, cfg.vocab_size))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, tokens=tokens, patch_embeds=pe)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    log(f"path transformer prefill pixtral-12b at full width (d_model "
        f"{cfg.d_model}), cut to {cfg.n_layers} of 40 layers "
        f"({tree_numel(params) / 1e9:.3f}e9 float32 parameters) on "
        f"B={TF_BATCH} x ({cfg.n_patches} patches + {text} tokens): "
        f"{prefill_s:.4f} s, {TF_BATCH * TF_SEQ / prefill_s:.0f} positions/s "
        f"(warm, host wall) [{card}]")
    del params, logits
    free_card()
    return dict(prefill_tokens_per_s=TF_BATCH * TF_SEQ / prefill_s,
                n_layers=cfg.n_layers)


def run_transformer_path(dev, card: str) -> dict:
    """The transformer families: qwen2-1.5b at full width and depth (float
    and quantized prefill, LMServer), the 7 configs at full width against
    the CPU port, granite-moe-3b-a800m at full depth and pixtral-12b cut to
    4 layers.  One model on the card at a time."""
    t0 = time.perf_counter()
    qwen = run_qwen2_full(dev, card)
    for i, arch in enumerate(TF_CONFIGS):
        check_config(dev, arch, SEED + 40 + i, card)
    moe = run_granite_moe_full(dev, card)
    pix = run_pixtral_cut(dev, card)
    log(f"transformer path: {time.perf_counter() - t0:.1f} s")
    return dict(qwen=qwen, moe=moe, pixtral=pix)


# ---------------------------------------------------------------------------
# LM slice C: the Zamba2 hybrid (Mamba-2/SSD) and the Whisper encoder–decoder
# ---------------------------------------------------------------------------

# zamba2-2.7b at its own width and depth (src/repro/configs/zamba2_2_7b.py:
# 54 Mamba-2 layers, d_model 2560, 80 SSD heads of 64, state 64, and one
# shared block of 32 heads of 80 with a GELU MLP of 10240 after every 6;
# vocab 32000, bf16 activations, float32 parameters); prefill on B sequences
# of T seeded tokens, so the SSD runs 32 chunks of 64 per layer
ZAMBA_ARCH = "zamba2-2.7b"
ZAMBA_BATCH, ZAMBA_SEQ = 4, 2048
ZAMBA_GEMMS = (5, 6)  # W8A8 GEMMs per Mamba layer, per shared-block application
# long_500k (src/repro/configs/base.py SHAPES): batch 1 at 2^19 positions,
# the shared block on Taylor-linear attention; 16 decode steps up to 2^19
LONG_POS, LONG_STEPS = 524_288 - 16, 16
# whisper-base at its own width and depth (src/repro/configs/whisper_base.py:
# 6 + 6 layers, d_model 512, 8 heads of 64, d_ff 2048, vocab 51865, 1500
# frames); 448 decoder tokens, Whisper's own text context
WHISPER_ARCH = "whisper-base"
WHISPER_GEMMS = (6, 10)  # per encoder layer; per decoder layer (self 4,
#                          cross wq/wo 2, cross K/V 2, MLP 2)
WHISPER_BATCH, WHISPER_TOKENS, WHISPER_DECODE = 8, 448, 64
SLICE_C_CARD_VS_CPU = 1e-3  # float32: summation order only
ZAMBA_DECODE_VS_FORWARD = 0.08  # the reference's (tests/test_arch_smoke.py:139)
WHISPER_DECODE_VS_FORWARD = 0.03
# the GEMM shapes these two paths add, (K, N): zamba2's in_dt (the first
# weight narrower than the kernel's 128-wide tile), in_bc, in_z/in_x,
# out_proj, the shared MLP's up and down (split-K at decode-sized M);
# whisper's attention, MLP up and MLP down
SLICE_C_SHAPES = {"zamba2 in_dt": (2560, 80), "zamba2 in_bc": (2560, 128),
                  "zamba2 in_z": (2560, 5120), "zamba2 out_proj": (5120, 2560),
                  "zamba2 up": (2560, 10240), "zamba2 down": (10240, 2560),
                  "whisper wq": (512, 512), "whisper up": (512, 2048),
                  "whisper down": (2048, 512)}


def check_slice_c_gemms(dev) -> float:
    """The kernel at the new shapes of the hybrid and encoder–decoder paths,
    at M ∈ {1, 8, 8192}, against its plain version."""
    worst = 0.0
    for name, (k, n) in SLICE_C_SHAPES.items():
        for m in (1, 8, ZAMBA_BATCH * ZAMBA_SEQ):
            worst = max(worst, check_gemm(name, *gemm_operands(
                SEED + 60 + m + k + n, m, k, n, dev)))
    return worst


def checked_quantized_prefill(label: str, fn, want: int) -> tuple:
    """``fn()`` (a quantized prefill) with the launch counters zeroed right
    before and read right after: exactly ``want`` W8A8 launches and nothing
    else, every call equal to the plain version on its own operands, no
    layout copy.  Returns the logits and the record."""
    record = {}
    torch.cuda.synchronize()
    reset_launches()
    with checked_gemms(record):
        out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in read_launches().items() if v}
    if got != {"fixedpoint_matmul": want}:
        raise SystemExit(f"{label}: launches {got}, expected "
                         f"fixedpoint_matmul {want}")
    if fmm.relayouts["fixedpoint_matmul"] or record["row_major"]:
        raise SystemExit(f"{label}: GEMM layout copies {fmm.relayouts}, "
                         f"row-major codes {record['row_major']}")
    if record["calls"] != want or record["differ"]:
        raise SystemExit(f"{label}: {record['calls']} GEMM calls, "
                         f"{record['differ']} differ from the plain version")
    log(f"kernel fixedpoint_matmul {label}, the path's own operands "
        f"(K-major slices of the stacked codes): launches {got}, GEMM layout "
        f"copies 0; all {record['calls']} calls equal to the plain version "
        f"at (M, K, N) {record['shapes']} (max_abs_err {record['err']})")
    return out, record


@contextlib.contextmanager
def event_ranges(module, name: str, events: list, tag=None):
    """CUDA events around every call of ``module.name`` in the run (start
    and end on the current stream, with ``tag(*args)`` when given), by
    patching the module's function."""
    fn = getattr(module, name)

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        events.append((start, end, tag(*a) if tag else name))
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def event_ms(events: list) -> dict:
    """Summed milliseconds of ``event_ranges``' events by tag."""
    out = {}
    for start, end, tag in events:
        out[tag] = out.get(tag, 0.0) + start.elapsed_time(end)
    return out


def run_zamba2_full(dev, card: str) -> dict:
    """zamba2-2.7b at full width and depth: the bf16 prefill (no kernel of
    the port's own; the SSD scans' share by CUDA events), ``LMServer`` with
    a same-structure hot swap, the quantized prefill with every projection
    on the W8A8 kernel, and ``long_500k``'s Taylor-linear decode."""
    cfg = get_config(ZAMBA_ARCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 70)
    params = SSM.init(g, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (ZAMBA_BATCH, ZAMBA_SEQ),
                           generator=g, device=dev)
    n_params = tree_numel(params)
    model = build_model(cfg, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    logits = model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    if launches:
        raise SystemExit(f"{ZAMBA_ARCH} float prefill launched {launches}: "
                         "expected no kernel of the port's own")
    check_logits(f"{ZAMBA_ARCH} prefill", logits,
                 (ZAMBA_BATCH, 1, cfg.vocab_size))
    t0 = time.perf_counter()
    model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with event_ranges(SSM, "_ssd_chunked", events), \
            event_ranges(TL, "_sdpa_causal", events):
        model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    ms = event_ms(events)
    ssd_ms, attn_ms = ms["_ssd_chunked"], ms["_sdpa_causal"]
    ssd_share, attn_share = (v / (timed_s * 1e3) for v in (ssd_ms, attn_ms))
    groups = cfg.n_layers // cfg.hybrid_attn_every
    calls = [tag for *_, tag in events]
    if (calls.count("_ssd_chunked"), calls.count("_sdpa_causal")) != (
            cfg.n_layers, groups):
        raise SystemExit(f"{ZAMBA_ARCH} prefill: {calls.count('_ssd_chunked')}"
                         f" SSD and {calls.count('_sdpa_causal')} attention "
                         f"calls, expected {cfg.n_layers} and {groups}")
    log(f"path slice C prefill {ZAMBA_ARCH} ({cfg.n_layers} Mamba-2 layers + "
        f"{cfg.n_layers // cfg.hybrid_attn_every} shared-block applications, "
        f"d_model {cfg.d_model}, {n_params / 1e9:.3f}e9 float32 parameters, "
        f"bf16 activations) on B={ZAMBA_BATCH} T={ZAMBA_SEQ}: last-position "
        f"logits {tuple(logits.shape)}, finite; {prefill_s:.4f} s, "
        f"{ZAMBA_BATCH * ZAMBA_SEQ / prefill_s:.0f} tokens/s (warm, host wall "
        f"with the card synchronised); by CUDA events in a prefill of "
        f"{timed_s:.4f} s: the {cfg.n_layers} SSD calls {ssd_ms:.2f} ms "
        f"({ssd_share:.4f}), the {groups} shared-block attentions (flash "
        f"route) {attn_ms:.2f} ms ({attn_share:.4f}) [{card}]")

    # LMServer at full width and depth, with a same-structure hot swap
    srv = LMServer(cfg, batch=8, max_seq=256, device=dev)
    srv.install(ZAMBA_ARCH, params)
    prompt = np.random.default_rng(SEED + 71).integers(0, cfg.vocab_size,
                                                       (8, 16))
    out = srv.generate(ZAMBA_ARCH, prompt, 32)
    decode_tps = srv.tokens_per_second()
    traces = srv.trace_count
    params_b = SSM.init(torch.Generator(device=dev).manual_seed(SEED + 72),
                        cfg, device=dev)
    srv.install(ZAMBA_ARCH, params_b)
    out_b = srv.generate(ZAMBA_ARCH, prompt, 4)
    traces_b = srv.trace_count
    del params_b, srv
    free_card()
    log(f"path slice C LMServer(batch=8, max_seq=256) {ZAMBA_ARCH} at full "
        f"width and depth: 16-token prompt + 32 greedy tokens, then 4 after "
        f"a same-structure install: trace_count {traces} then {traces_b}; "
        f"{decode_tps:.1f} tokens/s (prompt and new tokens, one decode_step "
        f"per position, host wall with the card synchronised) [{card}]")
    if (out.shape != (8, 32) or out_b.shape != (8, 4) or out.min() < 0
            or out.max() >= cfg.vocab_size or traces != 1 or traces_b != 1):
        raise SystemExit(f"{ZAMBA_ARCH} LMServer: tokens {out.shape} "
                         f"{out_b.shape}, trace_count {traces} {traces_b}")

    # the quantized prefill at full depth: every projection on the kernel
    q = tq.quantize_tree(params)
    want = ZAMBA_GEMMS[0] * cfg.n_layers + ZAMBA_GEMMS[1] * groups
    lq, record = checked_quantized_prefill(
        f"{ZAMBA_ARCH} quantized prefill at full depth ({cfg.n_layers} "
        f"layers, B={ZAMBA_BATCH} T={ZAMBA_SEQ})",
        lambda: model.prefill(q, tokens=tokens), want)
    check_logits(f"quantized {ZAMBA_ARCH} prefill", lq,
                 (ZAMBA_BATCH, 1, cfg.vocab_size))
    t0 = time.perf_counter()
    model.prefill(q, tokens=tokens)
    torch.cuda.synchronize()
    q_prefill_s = time.perf_counter() - t0
    del q, lq
    free_card()
    # NMSE against the float logits at one group, the reference's budget
    cfg1 = cfg.replace(n_layers=cfg.hybrid_attn_every)
    p1 = hybrid_slice(params, 1)
    model1 = build_model(cfg1, device=dev)
    q_nmse = nmse(model1.prefill(p1, tokens=tokens).float(),
                  model1.prefill(tq.quantize_tree(p1), tokens=tokens).float())
    log(f"path slice C quantized prefill {ZAMBA_ARCH}: {q_prefill_s:.4f} s at "
        f"full depth, {ZAMBA_BATCH * ZAMBA_SEQ / q_prefill_s:.0f} tokens/s "
        f"({want} W8A8 GEMMs); at one group NMSE of the last-position logits "
        f"against the float prefill {q_nmse:.3e} (bound {LM_QUANT_NMSE}) "
        f"[{card}]")
    if not q_nmse < LM_QUANT_NMSE:
        raise SystemExit(f"quantized {ZAMBA_ARCH} prefill: NMSE {q_nmse}")

    # long_500k: batch 1, Taylor-linear shared attention, decode at 2^19
    cfg_l = cfg.replace(attention_impl="taylor_linear")
    model_l = build_model(cfg_l, device=dev)
    caches = model_l.init_caches(1, 0)
    state_bytes = tree_bytes(caches)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=g, device=dev)
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LONG_STEPS):
        pos = torch.full((1,), LONG_POS + i, dtype=torch.int32, device=dev)
        step, caches = model_l.decode_step(params, caches, tok, pos)
        tok = step[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        steps.append(step)
        if tree_bytes(caches) != state_bytes:
            raise SystemExit(f"long_500k decode: the state grew from "
                             f"{state_bytes} to {tree_bytes(caches)} bytes")
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    check_logits("long_500k decode", torch.cat(steps, 1),
                 (1, LONG_STEPS, cfg.vocab_size))
    kv = [k for k in caches["attn"] if k not in ("s_kv", "s_k")]
    if kv:
        raise SystemExit(f"long_500k decode: a KV cache {kv} in the state")
    log(f"path slice C long_500k {ZAMBA_ARCH} (attention_impl taylor_linear, "
        f"batch 1) at full depth: {LONG_STEPS} decode_steps at positions "
        f"{LONG_POS}..{LONG_POS + LONG_STEPS - 1}, logits finite; the state "
        f"{state_bytes / 2 ** 20:.1f} MiB before and after every step (the "
        f"Mamba states and {groups} Taylor feature-map states, no KV cache); "
        f"{LONG_STEPS / long_s:.1f} tokens/s [{card}]")
    del params, logits, p1, caches
    free_card()
    return dict(gemm_launches=record["calls"], gemm_err=record["err"],
                prefill_tokens_per_s=ZAMBA_BATCH * ZAMBA_SEQ / prefill_s,
                quantized_prefill_tokens_per_s=(ZAMBA_BATCH * ZAMBA_SEQ
                                                / q_prefill_s),
                decode_tokens_per_s=decode_tps, ssd_share=ssd_share,
                attention_share=attn_share,
                long_tokens_per_s=LONG_STEPS / long_s)


def hybrid_slice(params, groups: int):
    """The first ``groups`` groups of a Zamba2 parameter tree."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:groups]

    return {**params, "mamba": cut(params["mamba"])}


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def greedy_decode(model, params, caches, first, n: int, pos0: int = 0):
    """``n`` greedy decode steps from the tokens ``first`` (B, 1); returns
    the tokens and each step's logits."""
    tok, toks, steps = first, [], []
    for t in range(n):
        pos = torch.full((tok.shape[0],), pos0 + t, dtype=torch.int32,
                         device=tok.device)
        logits, caches = model.decode_step(params, caches, tok, pos)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
        steps.append(logits)
    return torch.cat(toks, 1), torch.cat(steps, 1)


def run_whisper_full(dev, card: str) -> dict:
    """whisper-base at full width and depth: the bf16 prefill on 8 ×
    (1500 frames + 448 tokens), the encoder alone, ``precompute_cross`` and
    64 greedy decode steps at batch 8, and the quantized prefill with every
    projection on the W8A8 kernel."""
    cfg = get_config(WHISPER_ARCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 80)
    params = ED.init(g, cfg, device=dev)
    b, t = WHISPER_BATCH, WHISPER_TOKENS
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g,
                         device=dev)
    model = build_model(cfg, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    logits = model.prefill(params, tokens=tokens, frames=frames)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    if launches:
        raise SystemExit(f"{WHISPER_ARCH} float prefill launched {launches}: "
                         "expected no kernel of the port's own")
    check_logits(f"{WHISPER_ARCH} prefill", logits, (b, 1, cfg.vocab_size))
    t0 = time.perf_counter()
    model.prefill(params, tokens=tokens, frames=frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ED.encode(params, frames, cfg)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    # the attention forms' shares: encoder self-attention and cross-
    # attention (both materialized, told apart by the query length), the
    # decoder's causal self-attention
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with event_ranges(ED, "_bidirectional", events, tag=lambda q, *_: (
            "encoder" if q.shape[1] == cfg.encoder_seq else "cross")), \
            event_ranges(TL, "_sdpa_causal", events):
        model.prefill(params, tokens=tokens, frames=frames)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    shares = {k: v / (timed_s * 1e3) for k, v in event_ms(events).items()}
    log(f"path slice C prefill {WHISPER_ARCH} ({cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{tree_numel(params) / 1e9:.4f}e9 float32 parameters, bf16 "
        f"activations) on B={b} x ({cfg.encoder_seq} frames + {t} tokens): "
        f"last-position logits {tuple(logits.shape)}, finite; "
        f"{prefill_s:.4f} s, {b * (cfg.encoder_seq + t) / prefill_s:.0f} "
        f"positions/s, {b * t / prefill_s:.0f} decoder tokens/s; the encoder "
        f"alone {encode_s:.4f} s, {b * cfg.encoder_seq / encode_s:.0f} "
        f"frames/s (warm, host wall with the card synchronised); by CUDA "
        f"events in a prefill of {timed_s:.4f} s: encoder self-attention "
        f"{shares['encoder']:.4f}, cross-attention {shares['cross']:.4f}, "
        f"decoder self-attention {shares['_sdpa_causal']:.4f} [{card}]")

    # the serving path: precompute_cross, then greedy decode_steps
    caches = ED.precompute_cross(params, frames, cfg,
                                 model.init_caches(b, WHISPER_DECODE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, steps = greedy_decode(model, params, caches, tokens[:, :1],
                                WHISPER_DECODE)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check_logits(f"{WHISPER_ARCH} decode", steps,
                 (b, WHISPER_DECODE, cfg.vocab_size))
    log(f"path slice C decode {WHISPER_ARCH}: precompute_cross on B={b} x "
        f"{cfg.encoder_seq} frames, then {WHISPER_DECODE} greedy decode_steps "
        f"at batch {b}: {b * WHISPER_DECODE / decode_s:.1f} tokens/s (host "
        f"wall with the card synchronised), logits finite [{card}]")

    q = tq.quantize_tree(params)
    want = (WHISPER_GEMMS[0] * cfg.n_encoder_layers
            + WHISPER_GEMMS[1] * cfg.n_layers)
    lq, record = checked_quantized_prefill(
        f"{WHISPER_ARCH} quantized prefill at full depth (B={b} x "
        f"({cfg.encoder_seq} frames + {t} tokens))",
        lambda: model.prefill(q, tokens=tokens, frames=frames), want)
    check_logits(f"quantized {WHISPER_ARCH} prefill", lq,
                 (b, 1, cfg.vocab_size))
    q_nmse = nmse(logits.float(), lq.float())
    log(f"path slice C quantized prefill {WHISPER_ARCH} at full depth: NMSE "
        f"of the last-position logits against the float prefill "
        f"{q_nmse:.3e} (bound {LM_QUANT_NMSE}) [{card}]")
    if not q_nmse < LM_QUANT_NMSE:
        raise SystemExit(f"quantized {WHISPER_ARCH} prefill: NMSE {q_nmse}")
    del params, q, caches
    free_card()
    return dict(gemm_launches=record["calls"], gemm_err=record["err"],
                prefill_positions_per_s=b * (cfg.encoder_seq + t) / prefill_s,
                prefill_tokens_per_s=b * t / prefill_s,
                encoder_frames_per_s=b * cfg.encoder_seq / encode_s,
                decode_tokens_per_s=b * WHISPER_DECODE / decode_s,
                encoder_attention_share=shares["encoder"])


def slice_c_card_vs_cpu(dev, card: str) -> None:
    """Float32, the card against the CPU port on the same parameters:
    zamba2 at full width cut to one group (6 Mamba-2 layers and the shared
    block; forward and prefill at T = 100, two SSD chunks the last one
    padded; 8 decode steps; 8 ``long_500k`` Taylor-linear decode steps at
    2^19), and whisper at full depth (forward and prefill with 1500 frames;
    ``precompute_cross`` and 8 decode steps).  Decode against forward on
    the card within the reference's bounds."""
    errs = {}
    cfg = get_config(ZAMBA_ARCH)
    cfg = cfg.replace(n_layers=cfg.hybrid_attn_every, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    params = SSM.init(g, cfg, device=dev)
    on_cpu = tree_to(params, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 100), generator=g, device=dev)
    for name, fn in (("forward", lambda p, t: SSM.forward(p, t, cfg)[0]),
                     ("prefill", lambda p, t: SSM.prefill(p, t, cfg))):
        errs[f"zamba2 {name}"] = card_vs_cpu(
            f"{ZAMBA_ARCH} {name}", fn, params, on_cpu, (tok,), (tok.cpu(),))
    decoded = {}
    for impl, pos0 in (("full", 0), ("taylor_linear", LONG_POS)):
        cfg_i = cfg.replace(attention_impl=impl)
        runs = []
        for p, d in ((params, dev), (on_cpu, "cpu")):
            caches = SSM.init_caches(cfg_i, 2, 8, device=d)
            steps = []
            for t in range(8):
                pos = torch.full((2,), pos0 + t, dtype=torch.int32, device=d)
                step, caches = SSM.decode_step(p, caches,
                                               tok[:, t:t + 1].to(d), pos,
                                               cfg_i)
                steps.append(step.cpu())
            runs.append(torch.cat(steps, 1))
        errs[f"zamba2 decode {impl}"] = rel_err(*runs)
        decoded[impl] = runs[0]
    full = SSM.forward(params, tok[:, :8], cfg)[0]
    errs["zamba2 decode vs forward"] = rel_err(decoded["full"], full.cpu())
    del params, on_cpu
    free_card()

    cfg = get_config(WHISPER_ARCH).replace(dtype="float32")
    g = torch.Generator(device=dev).manual_seed(SEED + 91)
    params = ED.init(g, cfg, device=dev)
    on_cpu = tree_to(params, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=g, device=dev)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g,
                         device=dev)
    for name, fn in (("forward", lambda p, t, f: ED.forward(
            p, t, cfg, frames=f)[0]),
                     ("prefill", lambda p, t, f: ED.prefill(
                         p, t, cfg, frames=f))):
        errs[f"whisper {name}"] = card_vs_cpu(
            f"{WHISPER_ARCH} {name}", fn, params, on_cpu, (tok, frames),
            (tok.cpu(), frames.cpu()))
    runs = []
    for p, d in ((params, dev), (on_cpu, "cpu")):
        caches = ED.precompute_cross(p, frames.to(d), cfg,
                                     ED.init_caches(cfg, 2, 8, device=d))
        steps = []
        for t in range(8):
            pos = torch.full((2,), t, dtype=torch.int32, device=d)
            step, caches = ED.decode_step(p, caches, tok[:, t:t + 1].to(d),
                                          pos, cfg)
            steps.append(step.cpu())
        runs.append(torch.cat(steps, 1))
    errs["whisper decode"] = rel_err(*runs)
    full = ED.forward(params, tok[:, :8], cfg, frames=frames)[0]
    errs["whisper decode vs forward"] = rel_err(runs[0], full.cpu())
    del params, on_cpu
    free_card()
    log("path slice C card vs CPU port, float32: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bounds: card vs CPU {SLICE_C_CARD_VS_CPU}, decode vs forward "
        f"{ZAMBA_DECODE_VS_FORWARD} hybrid, {WHISPER_DECODE_VS_FORWARD} "
        f"encdec) [{card}]")
    for k, v in errs.items():
        bound = (ZAMBA_DECODE_VS_FORWARD if k == "zamba2 decode vs forward"
                 else WHISPER_DECODE_VS_FORWARD if k.endswith("vs forward")
                 else SLICE_C_CARD_VS_CPU)
        if not v < bound:
            raise SystemExit(f"slice C {k}: {v} (bound {bound})")


def run_slice_c_path(dev, card: str) -> dict:
    """LM slice C: zamba2-2.7b and whisper-base at full width and depth,
    then both in float32 on the card against the CPU port.  One model on
    the card at a time."""
    t0 = time.perf_counter()
    zamba = run_zamba2_full(dev, card)
    whisper = run_whisper_full(dev, card)
    slice_c_card_vs_cpu(dev, card)
    log(f"slice C path: {time.perf_counter() - t0:.1f} s")
    return dict(zamba2=zamba, whisper=whisper)


# -- LM slice D: training -----------------------------------------------------

# qwen2-1.5b at full width and depth (28 layers, d_model 1536, vocab
# 151936, tied embeddings; float32 parameters, bf16 activations, remat in
# groups of remat_group_size = 4): TrainLoop on 4 × 2048 tokens, so every
# layer's attention takes the flash route (4 blocks of 512) both ways
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 6
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
# step 1's loss against loss_fn on the same batch and parameters, on the
# card (the same operations, with and without autograd)
TRAIN_STEP1_TOL = 1e-6
# the loss_fn gradients, card vs CPU port, per leaf over the leaf's largest
# |g|: float32 summation order.  RWKV-6: its chunk operands' cotangents are
# rounded to bf16, as the reference's, so a last-bit difference upstream
# moves an element by a bf16 step (2^-8), and the decay LoRA sums such
# elements over the sequence (the first full-width run read 2.1e-2 at
# w_base, 2.5e-3 at the projections).  MoE: top-k routing is
# discontinuous, so the CPU replays the card's expert choices; a token the
# CPU would route otherwise must be a near tie (probability gap below
# GRAD_ROUTING_TIE; the first run found one at 7.5e-9)
GRAD_CARD_VS_CPU = 1e-3
GRAD_CARD_VS_CPU_RWKV = 3e-2
GRAD_ROUTING_TIE = 1e-6
GRAD_ARCHS = ("qwen2-1.5b", "granite-moe-3b-a800m", "rwkv6-3b",
              "zamba2-2.7b", "whisper-base")
GRAD_SEQ = 520  # crosses one 512-block: the flash backward over 2 blocks
# examples/pt_train_lm.py on the card: steps (a checkpoint and restart
# halfway), batch, sequence
EXAMPLE_STEPS, EXAMPLE_BATCH, EXAMPLE_SEQ = 100, 8, 256


def train_mode(dev, cfg, label: str, card: str) -> dict:
    """``TrainLoop.run`` for TRAIN_STEPS steps with every step, flash
    forward and backward and AdamW update timed by CUDA events (tagged
    with the step they fall in); step 1's loss held to ``loss_fn`` on the
    same batch and parameters."""
    loop = TrainLoop(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP, total_steps=100,
                     global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, device=dev)
    state0 = loop.init_state(0)
    batch0 = {k: torch.as_tensor(v, device=dev)
              for k, v in loop.stream.batch_at(0).items()}
    with torch.no_grad():
        want1 = float(loop.model.loss_fn(state0["params"], batch0)[0])
    del state0, batch0
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    steps, flash, adam = [], [], []

    def at(kind):
        return lambda *a, **kw: (kind, len(steps))

    with event_ranges(loop, "_step", steps), \
            event_ranges(FLASH, "_flash_fwd", flash, tag=at("forward")), \
            event_ranges(FLASH_KERNEL, "flash_attention_fwd", flash,
                         tag=at("forward")), \
            event_ranges(FLASH, "_flash_bwd", flash, tag=at("backward")), \
            event_ranges(ADAMW, "apply_updates", adam, tag=at("adamw")):
        t0 = time.perf_counter()
        state, hist = loop.run(max_steps=TRAIN_STEPS, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise SystemExit(f"train {label}: losses {losses}")
    step1 = abs(losses[0] - want1) / abs(want1)
    if not step1 < TRAIN_STEP1_TOL:
        raise SystemExit(f"train {label}: step 1 loss {losses[0]} against "
                         f"loss_fn {want1} ({step1:.3e})")
    step_ms = [a.elapsed_time(b) for a, b, _ in steps]
    by = event_ms(flash + adam)
    later = range(1, TRAIN_STEPS)  # steps 2..6
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # wall seconds at each logged step from the history's running rate
    ends = [h["step"] * tokens / h["tokens_per_s"] for h in hist]
    out = dict(
        losses=losses, loss_fn=want1, step1_rel=step1, peak_bytes=peak,
        tokens_per_s=tokens * len(later) / (ends[-1] - ends[0]),
        step_ms=step_ms, wall_s=wall,
        step_ms_later=statistics.mean(step_ms[k] for k in later),
        flash_fwd_ms=statistics.mean(by.get(("forward", k), 0.0)
                                     for k in later),
        flash_bwd_ms=statistics.mean(by.get(("backward", k), 0.0)
                                     for k in later),
        adamw_ms=statistics.mean(by[("adamw", k)] for k in later),
        flash_calls=(sum(t[0] == "forward" for *_, t in flash),
                     sum(t[0] == "backward" for *_, t in flash)))
    out["flash_fwd_share"] = out["flash_fwd_ms"] / out["step_ms_later"]
    out["flash_bwd_share"] = out["flash_bwd_ms"] / out["step_ms_later"]
    log(f"train {TRAIN_ARCH} {label} at full width and depth "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, remat groups of {remat_group_size(cfg)}), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; step 1 against loss_fn {want1:.6f} ({step1:.2e}); "
        f"{out['tokens_per_s']:.1f} tokens/s over steps 2-{TRAIN_STEPS} "
        f"(host wall); step {out['step_ms_later']:.2f} ms (CUDA events, "
        f"steps 2-{TRAIN_STEPS}; step 1 {step_ms[0]:.2f} ms); flash forward "
        f"{out['flash_fwd_ms']:.2f} ms ({out['flash_fwd_share']:.4f}) and "
        f"backward {out['flash_bwd_ms']:.2f} ms ({out['flash_bwd_share']:.4f})"
        f" a step ({out['flash_calls'][0]} forward and "
        f"{out['flash_calls'][1]} backward calls in {TRAIN_STEPS} steps); "
        f"AdamW update {out['adamw_ms']:.2f} ms; peak memory "
        f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated) [{card}]")
    del state, loop
    free_card()
    return out


def grads_card_vs_cpu(dev, card: str) -> dict:
    """``build_model(cfg).loss_fn``'s gradients at full width in float32 on
    the card against the CPU port on the same parameters and batch, every
    leaf: 2 layers (zamba2 one group, whisper whole), GRAD_SEQ tokens where
    the family has causal attention (64 for rwkv6 and whisper's decoder,
    with 1500 frames)."""
    worst = {}
    for i, arch in enumerate(GRAD_ARCHS):
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(dtype="float32")
        if cfg.family == "hybrid":
            cfg = cfg.replace(n_layers=cfg.hybrid_attn_every)
        elif cfg.family != "encdec":
            cfg = cfg.replace(n_layers=2)
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        model = build_model(cfg, device=dev)
        params = model.init(g)
        s = 64 if cfg.family in ("rwkv6", "encdec") else GRAD_SEQ
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s),
                                         generator=g, device=dev),
                 "labels": torch.randint(0, cfg.vocab_size, (1, s),
                                         generator=g, device=dev)}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn((1, cfg.encoder_seq, cfg.d_model),
                                          generator=g, device=dev)
        routes, ties = [], []
        with top_k_replay(routes, None):
            on_card = loss_grads(model, params, batch)
        with top_k_replay(routes, ties):
            on_cpu = loss_grads(build_model(cfg, device="cpu"),
                                tree_to(params, "cpu"),
                                {k: v.cpu() for k, v in batch.items()})
        if ties and not max(gap for _, gap in ties) < GRAD_ROUTING_TIE:
            raise SystemExit(f"train {arch}: the CPU routes tokens otherwise "
                             f"than the card beyond a near tie: {ties}")
        loss_err = abs(on_card[0] - on_cpu[0]) / abs(on_cpu[0])
        errs = {p: rel_err(a.cpu(), b) for p, a, b in zip(
            (p for p, _ in TREE.leaves_with_paths(params)), on_card[1],
            on_cpu[1])}
        bound = GRAD_CARD_VS_CPU_RWKV if cfg.family == "rwkv6" else \
            GRAD_CARD_VS_CPU
        path, err = max(errs.items(), key=lambda kv: kv[1])
        finite = all(bool(torch.isfinite(x).all()) for x in on_card[1])
        if not (err < bound and loss_err < 1e-5 and finite):
            raise SystemExit(f"train {arch}: gradients card vs CPU worst "
                             f"{err:.3e} at {path} (bound {bound}), loss "
                             f"{loss_err:.3e}, finite {finite}")
        worst[arch] = err
        log(f"train {arch} at full width, {cfg.n_layers} layer(s), float32, "
            f"T={s}: loss_fn gradients of {len(errs)} leaves, card vs CPU "
            f"port worst {err:.3e} at {path} (bound {bound}), loss "
            f"{loss_err:.2e}"
            + (f"; {len(routes)} top-k calls replayed on the CPU, "
               f"{sum(n for n, _ in ties)} token(s) at a near tie (largest "
               f"gap {max((g for _, g in ties), default=0.0):.2e})"
               if routes else "")
            + f" ({time.perf_counter() - t0:.1f} s) [{card}]")
        del params, on_card, on_cpu, model
        free_card()
    return worst


@contextlib.contextmanager
def top_k_replay(routes: list, ties):
    """The MoE router's top-k: with ``ties`` None, record each call's
    expert indices in ``routes``; otherwise replay ``routes`` in order
    (the same calls, forward then remat recomputations), taking the
    probabilities at the replayed indices, and append to ``ties`` each
    call's count of tokens whose own choice differs with the largest
    probability gap between the two choices."""
    own = TL._top_k
    replay = iter(routes)

    def top_k(x, k):
        vals, idx = own(x, k)
        if ties is None:
            routes.append(idx)
            return vals, idx
        forced = next(replay).to(x.device)
        differ = (idx != forced).any(-1)
        if bool(differ.any()):
            gap = vals.sum(-1) - torch.gather(x, -1, forced).sum(-1)
            ties.append((int(differ.sum()), float(gap[differ].max())))
        return torch.gather(x, -1, forced), forced

    TL._top_k = top_k
    try:
        yield
    finally:
        TL._top_k = own


def loss_grads(model, params, batch):
    """The loss and its gradients for every leaf of ``params`` (JAX's leaf
    order), through detached aliases of the leaves."""
    live = TREE.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss_fn(live, batch)
    return float(loss.detach()), torch.autograd.grad(loss, TREE.leaves(live))


def run_train_example(card: str) -> dict:
    """examples/pt_train_lm.py on the card: the ≈100M qwen2-family model
    with segmented order-3 Taylor activations and int8 moments, a
    checkpoint and a restart halfway; the loss must fall."""
    path = Path(__file__).resolve().parent / "examples" / "pt_train_lm.py"
    spec = importlib.util.spec_from_file_location("pt_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    res = mod.main("cuda", steps=EXAMPLE_STEPS, batch=EXAMPLE_BATCH,
                   seq=EXAMPLE_SEQ, log_every=EXAMPLE_STEPS // 4)
    dt = time.perf_counter() - t0
    if not res["last_loss"] < res["first_loss"]:
        raise SystemExit(f"pt_train_lm: the loss did not fall: {res}")
    log(f"train example pt_train_lm.py: {res['steps']} steps of "
        f"{EXAMPLE_BATCH} x {EXAMPLE_SEQ} with a checkpoint and restart at "
        f"{EXAMPLE_STEPS // 2}: loss "
        + " -> ".join(f"{h['loss']:.4f}" for h in res["history"])
        + f" ({dt:.1f} s in all) [{card}]")
    free_card()
    return res


def run_train_path(dev, card: str) -> dict:
    """LM slice D: qwen2-1.5b trained at full width and depth with float32
    and int8 moments, the gradients of five families against the CPU
    port, and the training example."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    out = {"f32": train_mode(dev, cfg, "float32 moments", card),
           "int8": train_mode(dev, cfg.replace(opt_state_bits=8),
                              "int8 moments", card)}
    f32, int8 = (out[m]["peak_bytes"] / 2 ** 30 for m in ("f32", "int8"))
    log(f"train peak memory: float32 moments {f32:.2f} GiB, int8 moments "
        f"{int8:.2f} GiB (saved {f32 - int8:.2f} GiB) [{card}]")
    out["grads"] = grads_card_vs_cpu(dev, card)
    out["example"] = run_train_example(card)
    log(f"train path: {time.perf_counter() - t0:.1f} s")
    return out


# -- LM slice E: distribution and the dry run --------------------------------
DIST_TRAIN_TOL = 1e-6  # sharded (1 × 1 mesh) vs unsharded losses, relative
DIST_MEM_TOL = 0.10  # the dry run's peak estimate vs max_memory_allocated
# the production cells the phase traces on both meshes (16×16, 2×16×16)
DIST_CELLS = [("qwen2-1.5b", "train_4k", {}), ("qwen2-1.5b", "prefill_32k", {}),
              ("qwen2-1.5b", "decode_32k", {}),
              ("deepseek-v2-236b", "train_4k", {}),
              ("granite-moe-3b-a800m", "train_4k", {}),
              ("rwkv6-3b", "prefill_32k", {}), ("zamba2-2.7b", "long_500k", {}),
              ("whisper-base", "train_4k", {}),
              ("qwen2-1.5b", "prefill_32k", {"quant_mode": "w8a8_int"})]
DIST_JOBS = 8  # worker processes for the production cells
# the dry run of the card's own train step (4 × 2048 on a 1-rank mesh) and
# of the production cells, in a subprocess: the fake process group of the
# dry run cannot live beside the NCCL group of this process
DIST_DRYRUN = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import dry_run, run_cells
batch, seq, cells, n_jobs = json.loads(sys.argv[1])
rec = dry_run(get_config("qwen2-1.5b"), ShapeConfig("card", seq, batch,
              "train"), (1, 1), ("data", "model"))
print("CARD " + json.dumps(rec), flush=True)
jobs = [(a, s, mp, ov, None) for a, s, ov in cells for mp in (False, True)]
for r in run_cells(jobs, n_jobs):
    print("CELL " + json.dumps(r), flush=True)
"""


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_prefill(model, params, tokens, mesh, cfg):
    """``model.prefill`` with the parameters distributed by ``make_plan``
    and the tokens by ``logical_batch_sharding`` on ``mesh``, under its
    activation mesh; the logits as a full tensor."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    dp = make_plan(params, cfg, mesh).distribute(params)
    pl = logical_batch_sharding(mesh, {"t": tokens}, tokens.shape[0])["t"]
    tok = distribute_tensor(tokens, mesh, pl, src_data_rank=None)
    with torch.no_grad(), activation_mesh(mesh), implicit_replication():
        out = model.prefill(dp, tokens=tok).full_tensor()
    del dp
    return out


def dist_train(dev, mesh, f32: dict, card: str) -> dict:
    """(a) ``TrainLoop(mesh=...)`` on the 1 × 1 NCCL mesh: qwen2-1.5b at
    full width and depth, TRAIN_BATCH × TRAIN_SEQ, TRAIN_STEPS steps with
    float32 moments, against the unsharded float32 run of the training
    phase (same seed, stream and schedule)."""
    cfg = get_config(TRAIN_ARCH)
    loop = TrainLoop(cfg, mesh=mesh, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                     total_steps=100, global_batch=TRAIN_BATCH,
                     seq_len=TRAIN_SEQ, device=dev)
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    state, hist = loop.run(max_steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, f32["losses"]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ends = [h["step"] * tokens / h["tokens_per_s"] for h in hist]
    tps = tokens * (TRAIN_STEPS - 1) / (ends[-1] - ends[0])
    log(f"dist (a) TrainLoop(mesh=1x1 NCCL) {TRAIN_ARCH} at full width and "
        f"depth, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; largest relative difference from the unsharded loop "
        f"{diff:.3e} (bound {DIST_TRAIN_TOL}); {tps:.1f} tokens/s over steps "
        f"2-{TRAIN_STEPS} against {f32['tokens_per_s']:.1f} unsharded "
        f"(host wall, the same call); peak memory {peak / 2 ** 30:.2f} GiB "
        f"against {f32['peak_bytes'] / 2 ** 30:.2f} GiB unsharded "
        f"(max_memory_allocated) [{card}]")
    if not (len(losses) == TRAIN_STEPS and diff <= DIST_TRAIN_TOL):
        raise SystemExit(f"dist train: losses {losses} against "
                         f"{f32['losses']} ({diff:.3e})")
    del state, loop
    free_card()
    return dict(losses=losses, max_rel_diff=diff, tokens_per_s=tps,
                peak_bytes=peak)


def dist_prefills(dev, mesh, card: str) -> dict:
    """(b) rwkv6-3b's float prefill (the WKV kernel) and qwen2-1.5b's
    quantized prefill (the W8A8 kernel) at full depth on the 1 × 1 mesh:
    logits ``torch.equal`` to the unsharded prefill's, the launches counted
    around the sharded run, every GEMM call held to its plain version."""
    out = {}
    cfg = get_config(LM_ARCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    params = rwkv6.init(g, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=g,
                           device=dev)
    model = build_model(cfg, device=dev)
    with torch.no_grad():
        want = model.prefill(params, tokens=tokens)
    torch.cuda.synchronize()
    reset_launches()
    got = sharded_prefill(model, params, tokens, mesh, cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    equal = torch.equal(got, want)
    log(f"dist (b) sharded prefill {LM_ARCH} (1x1 mesh, {cfg.n_layers} "
        f"layers, B={LM_BATCH} T={LM_SEQ}): launches {launches}; logits "
        f"torch.equal to the unsharded prefill: {equal} [{card}]")
    if launches != {"wkv_scan": cfg.n_layers} or not equal:
        raise SystemExit(f"dist rwkv6 prefill: launches {launches}, equal "
                         f"{equal}")
    out["wkv_launches"] = launches["wkv_scan"]
    del params, model, want, got
    free_card()

    cfg = get_config(TF_ARCH)
    params, g = transformer_params(cfg, SEED + 31, dev)
    tokens = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_SEQ),
                           generator=g, device=dev)
    q = tq.quantize_tree(params)
    del params
    model = build_model(cfg, device=dev)
    with torch.no_grad():
        want = model.prefill(q, tokens=tokens)
    record = {}
    torch.cuda.synchronize()
    reset_launches()
    with checked_gemms(record):
        got = sharded_prefill(model, q, tokens, mesh, cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    n = TF_PROJECTIONS * cfg.n_layers
    equal = torch.equal(got, want)
    log(f"dist (b) sharded quantized prefill {TF_ARCH} (1x1 mesh, "
        f"{cfg.n_layers} layers, B={TF_BATCH} T={TF_SEQ}): launches "
        f"{launches}; {record['calls']} GEMM calls, {record['differ']} "
        f"differ from the plain version (max_abs_err {record['err']}), "
        f"{record['row_major']} row-major codes; logits torch.equal to the "
        f"unsharded prefill: {equal} [{card}]")
    if (launches != {"fixedpoint_matmul": n} or record["calls"] != n
            or record["differ"] or not equal):
        raise SystemExit(f"dist quantized prefill: launches {launches}, "
                         f"calls {record['calls']}, differ "
                         f"{record['differ']}, equal {equal}")
    out.update(gemm_launches=n, gemm_err=record["err"])
    del q, model, want, got
    free_card()
    return out


def dist_dryrun(proc, f32: dict, card: str) -> dict:
    """(c) the dry run of the card's own step against the card, and (d)
    the production cells, from the subprocess started with DIST_DRYRUN."""
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"dist dry run failed:\n{stderr[-4000:]}")
    card_rec, cells = None, []
    for line in stdout.splitlines():
        if line.startswith("CARD "):
            card_rec = json.loads(line[5:])
        elif line.startswith("CELL "):
            cells.append(json.loads(line[5:]))
    est, meas = card_rec["memory"]["peak_est_bytes"], f32["peak_bytes"]
    mem_err = abs(est - meas) / meas
    flops = card_rec["cost"]["flops"]
    step_s = f32["step_ms_later"] * 1e-3
    tflops = flops / step_s / 1e12
    log(f"dist (c) dry run of the {TRAIN_ARCH} train step at "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} on a 1-rank fake mesh: peak_est "
        f"{est / 2 ** 30:.2f} GiB against max_memory_allocated "
        f"{meas / 2 ** 30:.2f} GiB of the unsharded step ({mem_err:.4f}, "
        f"bound {DIST_MEM_TOL}); {flops:.4e} FLOPs a step over the measured "
        f"{step_s:.4f} s (CUDA events, steps 2-{TRAIN_STEPS}) = {tflops:.2f} "
        f"TFLOP/s, {tflops * 1e12 / HW.PEAK_BF16:.4f} of the H100 SXM dense "
        f"bf16 peak ({HW.PEAK_BF16 / 1e12:.1f} TFLOP/s); traced in "
        f"{card_rec['trace_seconds']} s [{card}]")
    if not mem_err <= DIST_MEM_TOL:
        raise SystemExit(f"dist dry run: peak estimate {est} against {meas}")
    bad = [c for c in cells if c["status"] != "ok"]
    for c in cells:
        if c["status"] != "ok":
            continue
        rl = c["roofline"]
        log(f"dist (d) {c['arch']} x {c['shape']} x {c['mesh']}"
            + (f" {c['overrides']}" if c["overrides"] else "")
            + f": ok, compute {rl['compute_s']:.4f} s | memory "
            f"{rl['memory_s']:.4f} s | collective {rl['collective_s']:.4f} s"
            f" -> {rl['bottleneck']}; peak_est "
            f"{c['memory']['peak_est_bytes'] / 2 ** 30:.2f} GiB; "
            f"{len(c['fallbacks'])} fallbacks; traced in "
            f"{c['trace_seconds']} s")
    if bad or len(cells) != 2 * len(DIST_CELLS):
        raise SystemExit(f"dist production cells: {len(cells)} records, "
                         f"failed {[(c['arch'], c['shape'], c['mesh'], c.get('error')) for c in bad]}")
    return dict(mem_err=mem_err, peak_est_bytes=est, tflops=tflops,
                peak_share=tflops * 1e12 / HW.PEAK_BF16,
                cells_ok=len(cells))


def run_dist_path(dev, card: str, f32: dict) -> dict:
    """LM slice E: the sharded training loop and prefills on a 1 × 1 NCCL
    mesh against the unsharded paths, the dry run against the card, and
    the production cells' dry runs (a subprocess, started after the timed
    training so that it does not share the host with it)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    proc = None
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        out = {"train": dist_train(dev, mesh, f32, card)}
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(Path(__file__).resolve().parent / "src"),
             os.environ.get("PYTHONPATH", "")]), "CUDA_VISIBLE_DEVICES": ""}
        proc = subprocess.Popen(
            [sys.executable, "-c", DIST_DRYRUN, json.dumps(
                [TRAIN_BATCH, TRAIN_SEQ, DIST_CELLS, DIST_JOBS])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        out["prefill"] = dist_prefills(dev, mesh, card)
    except BaseException:
        if proc is not None:
            proc.kill()
            proc.wait()
        raise
    finally:
        dist.destroy_process_group()
    try:
        out["dryrun"] = dist_dryrun(proc, f32, card)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["seconds"] = time.perf_counter() - t0
    log(f"dist path: {out['seconds']:.1f} s")
    return out


def slice_c_gemm_numbers(dev, card: str) -> dict:
    """Phase 5 for the GEMM at the shapes slice C adds: at the prefill's
    M (zamba2 4 × 2048, whisper's 8 × 1500 encoder rows) and at M = 8 (a
    batch-8 decode), the kernel and torch._int_mm + the rescale (checked
    equal) in turns, and the bound.  Returns ms per call by shape."""
    rows = {}
    for name, (k, n) in SLICE_C_SHAPES.items():
        big = (WHISPER_BATCH * get_config(WHISPER_ARCH).encoder_seq
               if name.startswith("whisper") else ZAMBA_BATCH * ZAMBA_SEQ)
        for m in (big, 8):
            xc, wc, xs, ws = gemm_operands(SEED + 61 + m + n, m, k, n, dev)
            calls = {"kernel": lambda: fmm.fixedpoint_matmul(xc, wc, xs, ws)}
            if m > 16:
                def library():
                    return (torch._int_mm(xc, wc).to(torch.float32) * xs) * ws

                if not torch.equal(library(), calls["kernel"]()):
                    raise SystemExit(f"torch._int_mm + rescale differs from "
                                     f"the kernel ({name})")
                calls["library"] = library
            per_call = in_turns(calls, cuda_ms)
            queued = in_turns(calls, queued_ms)
            b_ms, b_by = gemm_bound(m, k, n)
            split = fmm.plan(m, n, k, sms())
            rows[f"{name} M={m}"] = dict(ms=per_call["kernel"],
                                         queued_ms=queued["kernel"],
                                         library_ms=per_call.get("library"),
                                         bound_ms=b_ms)
            lib = ("none (torch._int_mm needs M > 16)" if m <= 16 else
                   f"{per_call['library']:.4f} ms ({queued['library']:.4f} "
                   "queued)")
            log(f"time fixedpoint_matmul {name} M={m} K={k} N={n}: kernel "
                f"[wgmma, split {split}] {per_call['kernel']:.4f} ms per call "
                f"({queued['kernel']:.4f} ms queued, device only), "
                f"torch._int_mm + rescale {lib}, bound {b_ms:.6f} ms "
                f"({b_by}); {2 * m * n * k / (queued['kernel'] * 1e9):.1f} "
                f"TOP/s queued [{card}]")
    return rows


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
    _build.build_all(SOURCES)
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
    for variant, err in check_mlp_edges(dev).items():
        worst[variant] = max(worst[variant], err)
    t0 = time.perf_counter()
    forests, drifted = train_forests()
    log(f"trained {len(forests) + 1} forests on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    trained = trained_tables(forests)
    worst.update(check_forest_kernels(dev, trained))
    t0 = time.perf_counter()
    worst["flow_update"] = check_flow_kernels(dev)
    log(f"flow kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst["fixedpoint_matmul"] = max(check_gemm_kernels(dev),
                                     check_slice_c_gemms(dev))
    worst["taylor_activation"] = check_taylor_kernels(dev)
    worst["row_quantize"] = check_row_quantize_kernels(dev)
    log(f"C1/C2 kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst["wkv_scan"] = check_wkv_kernels(dev)
    log(f"WKV kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst["flash_attention"] = check_flash_kernels(dev)
    log(f"flash attention kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst["ssd_scan"] = check_ssd_kernels(dev)
    log(f"SSD scan kernel checks: {time.perf_counter() - t0:.1f} s")

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
    flow = run_flow_path(dev, "200k", 200_000, smi, forests, drifted,
                         strict_model_ids=True)
    overflow = run_flow_path(dev, "overflow", 50_000, smi, forests,
                             flow_capacity_pow2=12, flow_idle_timeout=1024,
                             strict_model_ids=True)
    if min(overflow["table"].values()) == 0:
        raise SystemExit(f"overflow run: expected expiry, eviction and "
                         f"rejection, got {overflow['table']}")
    path["flow"] = flow
    path["flow overflow"] = overflow
    path["flow fused"] = run_fused_path(dev, 50_000, smi, forests)
    path.update(run_fabric_phase(dev, smi, forests, drifted,
                                 flow["chunks"]))
    c1c2 = run_c1c2_path(dev, smi)
    t0 = time.perf_counter()
    lm = run_rwkv6_path(dev, smi)
    worst["fixedpoint_matmul"] = max(worst["fixedpoint_matmul"],
                                     lm["gemm_err"])
    log(f"rwkv6 path: {time.perf_counter() - t0:.1f} s")
    tf = run_transformer_path(dev, smi)
    worst["fixedpoint_matmul"] = max(worst["fixedpoint_matmul"],
                                     tf["qwen"]["gemm_err"])
    lmc = run_slice_c_path(dev, smi)
    worst["fixedpoint_matmul"] = max(worst["fixedpoint_matmul"],
                                     lmc["zamba2"]["gemm_err"],
                                     lmc["whisper"]["gemm_err"])
    zamba7 = run_zamba2_7b_prefill(dev, smi)
    worst["ssd_scan"] = tuple(max(w, zamba7[k]) for w, k in zip(
        worst["ssd_scan"], ("rel_l2", "max_abs_err")))
    kimi = run_kimi_linear_prefill(dev, smi)
    train = run_train_path(dev, smi)

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
        # the weights' locality: every packet on one model, or sorted by model
        one = dict(case, slot=torch.zeros_like(case["slot"]))
        by_model = dict(case, slot=torch.sort(case["slot"]).values)
        q_one, q_sorted = (queued_ms(lambda c=c: fmlp.fixedpoint_mlp(
            **c, **kw, variant=variant)) for c in (one, by_model))
        log(f"time {variant} B=2048 M=16 L=4 W=32: kernel "
            f"{k_ms[variant]:.4f} ms per call ({q_ms:.4f} ms queued, device "
            f"only; {q_one:.4f} with every packet on one model, {q_sorted:.4f} "
            f"with the packets sorted by model), plain {p_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}) [{smi}]")
    nodes, tree_on, mode, ranges = trained
    # codes as the serving trace has them
    x = np.round(rng.normal(size=(2048, WIDTH)) * (1 << FRAC)).astype(np.int32)
    slot = rng.integers(0, F, 2048).astype(np.int32)
    x, slot, nodes, tree_on, mode = _dev(dev, x, slot, nodes, tree_on, mode)
    ranges = _dev(dev, *ranges)
    calls = {
        "chase": (lambda s: ftk.forest_traverse(
            x, s, nodes, tree_on, mode, max_depth=DEPTH, frac=FRAC),
            lambda: forest_traverse_gather_ref(
            x, slot, nodes, tree_on, mode, max_depth=DEPTH, frac=FRAC)),
        "range": (lambda s: ftk.forest_range(
            x, s, *ranges, tree_on, mode, frac=FRAC),
            lambda: forest_range_gather_ref(
            x, slot, *ranges, tree_on, mode, frac=FRAC)),
    }
    stream = torch.cuda.current_stream().cuda_stream
    floor_ms = queued_ms(lambda: ftk.load_library().forest_empty_launch(
        stream))
    one = torch.zeros_like(slot)  # every packet on one forest
    for variant, (call, plain) in calls.items():
        k_ms[variant] = cuda_ms(lambda: call(slot))
        q_ms = queued_ms(lambda: call(slot))
        one_ms, one_q = (f(lambda: call(one)) for f in (cuda_ms, queued_ms))
        p_ms = cuda_ms(plain)
        b_ms, b_by = forest_bound(x, slot, nodes, tree_on, mode, ranges,
                                  variant)
        kernels.append(dict(KERNELS[variant],
                            launches=path[variant]["launches"][variant],
                            max_abs_err=worst[variant], ms=k_ms[variant],
                            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None))
        phases = ("" if variant == "chase" else "; " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in range_phases(
                x, slot, ranges, tree_on, mode).items()) + " (profiler)")
        log(f"time forest_{variant} B=2048 F={F} T={T} N={N} depth={DEPTH} "
            f"NI={NI} L={NL} W={WIDTH} (trained forests): kernel "
            f"{k_ms[variant]:.4f} ms per call ({q_ms:.4f} ms queued, device "
            f"only), every packet on one forest {one_ms:.4f} ms per call "
            f"({one_q:.4f} queued){phases}; an empty kernel queued "
            f"{floor_ms:.4f} ms (the launch floor); plain {p_ms:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}) [{smi}]")
    entry = flow_numbers(dev, flow, worst["flow_update"], smi)
    k_ms["flow_update"] = entry["ms"]
    kernels.append(entry)
    gemm, taylor = c1c2_numbers(dev, c1c2, worst, smi)
    # the GEMM's launches on every path that runs it: the C1/C2 layer, the
    # quantized rwkv6 prefill (2 layers) and the quantized qwen2-1.5b,
    # zamba2-2.7b and whisper-base prefills at full depth
    by_path = {"C1/C2 layer": c1c2["launches"]["fixedpoint_matmul"],
               "rwkv6 quantized prefill": lm["gemm_launches"],
               "qwen2-1.5b quantized prefill": tf["qwen"]["launches"][
                   "fixedpoint_matmul"],
               "zamba2-2.7b quantized prefill": lmc["zamba2"][
                   "gemm_launches"],
               "whisper-base quantized prefill": lmc["whisper"][
                   "gemm_launches"]}
    slice_c_gemm = slice_c_gemm_numbers(dev, smi)
    wkv = wkv_numbers(dev, lm, worst["wkv_scan"], smi)
    # the distribution phase comes after every profiler session: once its
    # NCCL group has been up, the profiler's sessions in this process were
    # seen to record no device activity
    dist = run_dist_path(dev, smi, train["f32"])
    by_path["qwen2-1.5b sharded quantized prefill"] = dist["prefill"][
        "gemm_launches"]
    gemm["launches"] = sum(by_path.values())
    gemm["max_abs_err"] = max(gemm["max_abs_err"], dist["prefill"]["gemm_err"])
    log(f"kernel fixedpoint_matmul launches by path: {by_path}")
    kernels.extend([gemm, taylor])
    wkv["launches"] += dist["prefill"]["wkv_launches"]
    log(f"kernel wkv_scan launches by path: rwkv6 prefill "
        f"{lm['launches']['wkv_scan']}, sharded rwkv6 prefill "
        f"{dist['prefill']['wkv_launches']}")
    kernels.append(wkv)
    kernels.extend(flash_numbers(dev, worst["flash_attention"],
                                 tf["qwen"]["flash_launches"]
                                 + kimi["flash_launches"], smi))
    kernels.extend(row_quantize_numbers(dev, tf["qwen"]["quantize_launches"],
                                        smi))
    kernels.append(ssd_numbers(dev, worst["ssd_scan"], zamba7["launches"],
                               smi))
    for label, p in path.items():
        kernel_s = sum(n * k_ms[k] * 1e-3 for k, n in p["launches"].items())
        log(f"path {label}: {p['packets_per_s']:.0f} packets/s, engine call "
            f"share {p['engine_s'] / p['seconds']:.4f}, kernel share "
            f"{kernel_s / p['seconds']:.5f} of the path's wall time "
            "(estimated as launches x per-call ms, host launch time included) "
            f"(launches {p['launches']}) [{smi}]")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
        "device check")
    print(json.dumps({"kernels": kernels,
                      "path_packets_per_s": {v: path[v]["packets_per_s"]
                                             for v in path},
                      "fabric": {v: dict(
                          launches_per_shard=path[v]["per_shard"],
                          one_server_packets_per_s=path[v][
                              "one_server_packets_per_s"])
                          for v in ("fabric", "fabric chase")},
                      "rwkv6_tokens_per_s": {
                          "prefill": lm["prefill_tokens_per_s"],
                          "generate": lm["generate_tokens_per_s"]},
                      "transformer": {
                          "qwen2_prefill_tokens_per_s": tf["qwen"][
                              "prefill_tokens_per_s"],
                          "qwen2_quantized_prefill_tokens_per_s": tf["qwen"][
                              "quantized_prefill_tokens_per_s"],
                          "qwen2_decode_tokens_per_s": tf["qwen"][
                              "decode_tokens_per_s"],
                          "attention_ms": tf["qwen"]["port_ms"],
                          "sdpa_ms": tf["qwen"]["sdpa_ms"],
                          "granite_moe_prefill_tokens_per_s": tf["moe"][
                              "prefill_tokens_per_s"],
                          "granite_moe_dispatch_share": tf["moe"][
                              "dispatch_share"],
                          "pixtral_prefill_positions_per_s": tf["pixtral"][
                              "prefill_tokens_per_s"],
                          "pixtral_layers": tf["pixtral"]["n_layers"]},
                      "slice_c": {
                          "zamba2_prefill_tokens_per_s": lmc["zamba2"][
                              "prefill_tokens_per_s"],
                          "zamba2_quantized_prefill_tokens_per_s": lmc[
                              "zamba2"]["quantized_prefill_tokens_per_s"],
                          "zamba2_decode_tokens_per_s": lmc["zamba2"][
                              "decode_tokens_per_s"],
                          "zamba2_ssd_share": lmc["zamba2"]["ssd_share"],
                          "zamba2_attention_share": lmc["zamba2"][
                              "attention_share"],
                          "zamba2_long_500k_tokens_per_s": lmc["zamba2"][
                              "long_tokens_per_s"],
                          "whisper_prefill_positions_per_s": lmc["whisper"][
                              "prefill_positions_per_s"],
                          "whisper_encoder_frames_per_s": lmc["whisper"][
                              "encoder_frames_per_s"],
                          "whisper_decode_tokens_per_s": lmc["whisper"][
                              "decode_tokens_per_s"],
                          "whisper_encoder_attention_share": lmc["whisper"][
                              "encoder_attention_share"],
                          "gemm_ms": {k: v["ms"] for k, v in
                                      slice_c_gemm.items()}},
                      "train": {
                          mode: {k: train[mode][k] for k in (
                              "tokens_per_s", "peak_bytes", "step_ms_later",
                              "flash_fwd_share", "flash_bwd_share",
                              "adamw_ms", "losses")}
                          for mode in ("f32", "int8")} | {
                          "grads_card_vs_cpu": train["grads"],
                          "example_losses": [h["loss"] for h in train[
                              "example"]["history"]]},
                      "dist": {
                          "train_tokens_per_s": dist["train"]["tokens_per_s"],
                          "train_peak_bytes": dist["train"]["peak_bytes"],
                          "train_max_rel_diff": dist["train"][
                              "max_rel_diff"],
                          "dryrun_peak_est_bytes": dist["dryrun"][
                              "peak_est_bytes"],
                          "dryrun_mem_err": dist["dryrun"]["mem_err"],
                          "train_tflops": dist["dryrun"]["tflops"],
                          "train_peak_share": dist["dryrun"]["peak_share"],
                          "cells_ok": dist["dryrun"]["cells_ok"],
                          "seconds": dist["seconds"]}}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
