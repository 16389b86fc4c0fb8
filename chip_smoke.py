#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them.  It builds
every kernel from the sources in this checkout, holds each against its plain
PyTorch version on the card, then drives:

* the flow a user of the compiler runs — build an HIR design (hand-written,
  or traced by the frontend from a PyTorch program: frontend_matmul,
  frontend_softmax_row, frontend_scan, whose build is the trace and the HLS
  schedule), verify it, optimize it, lower it to a generated CUDA kernel,
  run it on one stimulus vector and on 4096 of them, and check the results
  against the NumPy oracle, the cycle-accurate simulator and the functional
  lowering — and the
  GEMM binding through the hand-written matmul, whose bfloat16 kernel runs on
  wgmma and whose float32 kernel stays exact on integer operands (every
  shape, 4096^3 and a ragged 4000x3992x4104 included);
* serving seven models at full width (random weights from a seed) — the
  dense tinyllama-1.1b, the attention-free mamba2-780m, the hybrid
  recurrentgemma-9b, the MoE qwen2-moe-a2.7b (60 routed experts, top-4,
  head dim 128 with a KV head a query head), deepseek-v2-lite-16b at full
  depth (multi-head latent attention: queries and keys of 192 dims against
  values of 128; 64 routed experts, top-6), the encoder-decoder
  seamless-m4t-medium and llama-3.2-vision-90b cut to one group of its
  pattern (four attn layers and one gated cross_attn layer over 1600
  patches), one after another, each freed before the next: the
  continuous-batching ``Engine`` answers 8 requests over 4 slots (the
  recurrent two refill in waves), every decode step through the
  decode-attention kernel where the model has self- or cross-attention (the
  latent decode of MLA is eager torch, as the reference's is plain XLA);
  the cross models' gates are drawn from a seed (a fresh model's are 0);
  and tinyllama-1.1b again with Gemma-2's attention logit cap
  (``attn.logit_softcap`` 50, a config made here with ``cfg.scaled``: no
  config of the registry sets the field), every attention score through the
  capped instantiations of K3 and K4;
* each model's prefill step: flash attention for tinyllama and qwen2-moe,
  the SSD scan for Mamba-2, the RG-LRU scan and windowed flash attention
  (head dim 256) for RecurrentGemma, flash attention at head dims 192/128
  for deepseek's MLA, non-causal flash attention for seamless' encoder and
  the cross-attention of both cross models (seeded frontend embeddings);
* the reference's decode-consistency invariant: teacher-forced decode steps
  against the forward pass over the same tokens, at full width (RecurrentGemma
  cut to one group of its pattern, its window cut to 64; qwen2-moe and
  deepseek cut to their first 8 layers, at capacity factor 64; the cross
  models with their caches filled from seeded embeddings);
* training (``train``): tinyllama-1.1b at full width and depth, bfloat16
  with remat, 6 AdamW steps of 4 x 2048 tokens through ``launch.train``
  with a checkpoint after the last — every attention layer's forward through
  flash attention (again in the backward, under remat) and its backward
  through the flash kernel's backward (S2) — then every gradient leaf finite
  and non-zero, the last checkpoint restored equal to the live state and a
  profiled step; one float32 smoke step on the card against the CPU for
  tinyllama, Mamba-2 and RecurrentGemma (``train_card_vs_cpu[<arch>]``:
  K3 and S2, K5 and its backward S3, K6 and its backward S4); the bfloat16
  kernel gradients of the first two layers at full width against float32
  plain ones (``train_grads``); ``examples/train_tinylm_torch.py`` for 40
  steps with a failure injected (``train_example``); and every other arch
  at full width, its depth cut where the functional AdamW step would not
  fit the card (``train[<arch>]``: a checked warm-up gradient and two timed
  steps of 2 x 2048 tokens, Mamba-2's 4 x 2048, llama-3.2-vision-90b's
  gradients only, each with its launches by kernel and a profiled step);
  the capped tinyllama's first two layers' gradients at 4 x 2048 through
  the capped K3 and S2 against float32 plain ones (``train_grads[...]``);
* the dry-run (``dryrun``), on the host in a subprocess of its own that
  runs beside the card's phases from the K3 phase on, as a user runs
  ``python -m repro_torch.launch.dryrun``: tinyllama-1.1b x train_4k and
  qwen2-moe-a2.7b x decode_32k on the 256-rank mesh over a fake process
  group, and the train phase's own step (4 x 2048, remat) on one rank, its
  predicted FLOPs, bytes, H100 bound and peak bytes beside the
  step seconds and peak bytes the train phase measured;
* the mesh, on one rank: a ``("pod", "data", "model") = (1, 1, 1)`` mesh
  over NCCL (``launch.mesh.make_mesh``; NCCL takes one rank a card, the
  multi-rank paths run over gloo in the CPU tests): tinyllama-1.1b's decode
  under the flash-decode rules, every attention layer through K4's partials
  (``normalize=False``), an all-gather of (acc, m, l) and
  ``merge_partials``, against the unsharded step (``mesh_decode``, both
  timed); qwen2-moe's first MoE layer through ``moe_forward_ep`` against
  the local dispatch (``mesh_moe``); one int8-compressed gradient of
  tinyllama-1.1b at 4 x 2048 against the plain one, and the int8 and
  plain train steps timed (``mesh_train``);
* ``examples/serve_batched_torch.py`` as a user runs it on the card
  (``serve_example``);
* the designer's differential check (``differential``): the design lowered
  to RTL (``generate_verilog``) and run on the cycle-accurate simulator's
  kernel generated per design, on 4096 stimulus vectors — the reference's
  own matrix (nine designs at the sizes of its test, and the three traced
  designs at the sizes of the frontend's test, x {inline, modules})
  through ``run_differential`` (event-driven simulator on sample lanes, the
  design's oracle on every lane, every RTL pass), once each, and the
  five loop nests at both sizes held to ``lower_to_cuda`` on every lane.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; a row of the ``kernels`` line that names a main-path shape
carries that count, and the rows of further checks nested under it carry
``"launches": null``.  The attention rows (K3, K4) name the kernel they ran
and carry ``device_ms`` and ``library_device_ms`` beside the CUDA-event
``ms``: one replay of a CUDA graph of 20 calls over 20, the device's time
without the host's (``null`` with the reason where a call cannot be
captured).  The K5 rows (the SSD scan, several kernels a call) carry
``device_ms`` alike, each kernel's device time and launches a call and
their sum (``stage_device_ms``, ``stage_launches_per_call``,
``cuda_launches_per_call``, counted in a ``torch.profiler`` trace), the error
against the float64 recurrence over its limit (``worst_over_tolerance``) and
a bound for products on the TF32 tensor cores in three passes; the prefill
row adds each kernel's registers
and spills (``tools/ptxas_usage.py``).  The simulator rows (``rtl_sim[...]``)
carry ``device_ms`` (a CUDA graph of the launches), ``cycles``,
``ns_per_cycle`` (of ``ms``), ``run_ms`` (a whole ``sim.run``, the
stimulus copied to the card and laid out there, the results copied back),
the state words and bytes a lane their byte bound counts (each word at its
own size, 4 or 8 bytes; ``bound_ms_at_8_bytes_a_word`` beside it),
``placement`` (each memory and shift register in registers, shared or
global memory), ``word_bytes``, ``shared_bytes_per_lane`` and
``lanes_per_block``; a loop nest's large size is nested under its paper
row, held to its plain version on 16 lanes spread over the batch, on the
CPU (``plain_on``); the gemm and gemm_shared rows and the large rows carry
their kernels' registers and spills (``ptxas``), and gemm's a check on
65,536 lanes held to its plain version on the card.  An ``s1_gap`` line
sums launches x (ms - bound) over the rows the main path ran.  The S2 rows
(``flash_attention_bwd[...]``) name the kernels of the route that ran
(``flash_attention.bwd_route``: bfloat16 on the tensor cores below head dim
256), and carry each output's error and the backward of SDPA as
``library_ms``.  The S3 rows (``ssd_scan_bwd[...]``, the SSD scan's
backward, six kernels a call) and S4 rows (``rglru_scan_bwd[...]``) carry
each output's error against the float64 plain backward, ``device_ms``,
S3's kernels' device times a call (each training row also its kernels'
registers and spills), and ``library_ms`` null; S3's bound counts its products with
B and C once over the heads' sum.  The capped rows (``... softcap 50]``: K3,
K4 and S2 under the cap, with checks at RecurrentGemma's head dim 256, on
S2's CUDA cores and at MLA's (192, 128), which raises ``ValueError``) carry
``library_ms`` null (no single PyTorch call caps the scores), a bound that
counts the exp and the tanh a visible pair needs on the special-function
unit (S2 too, though its two passes form them twice), ``err_share_of_limit``,
``uncapped_device_ms`` (the same call without the cap) and
``uncapped_err_share_of_limit``: the uncapped kernel's distance from the
capped plain result over the same limit, which must exceed 1, so that a
kernel that ignored the cap would fail the row.  Checks with queries
``NEAR_CAP_Q`` times normal put each row's largest score near 0.9 of the
cap (``median_row_max_score_over_cap``), where ``tanh.approx`` errs most in
the capped score.  A ``softcap`` line shows that tinyllama's uncapped rows
keep their launch counts.
Output: one JSON object per line (``env``, ``build``,
``k1_without_staging``, ``main_path``, ``differential``, ``s1_gap``, then
``serve``, ``prefill``, ``consistency`` and ``profile`` for each model,
``mesh_decode`` and ``mesh_moe`` beside tinyllama's and qwen2-moe's,
``serve_example``, the training lines, ``mesh_train``, ``dryrun``, ``softcap``, ``phases``,
``kernels``), the card's name and power limit as ``nvidia-smi`` gives them, and a last line
``{"ok": true, "device": {...}}``.  Any mismatch or failure exits non-zero
before that line.  A ``phases`` line gives the host seconds of each group of
phases.  Work on the host alone runs beside the phases, so that the run
stays well inside its time limit on a host that shares its cores: the
dry-run and the large loop nests' plain simulator on the CPU in a process
each, and ``tools/ptxas_usage.py``'s compiles in threads.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import functools
import inspect
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.codegen import sim as rtl_sim  # noqa: E402
from repro_torch.core.codegen import sim_cuda  # noqa: E402
from repro_torch.core.gallery import (array_add, conv2d, fifo,  # noqa: E402
                                      frontend_matmul, frontend_scan,
                                      frontend_softmax_row, gemm, gemm_shared,
                                      histogram, mac, stencil1d, transpose)
from repro_torch.core.lower import lower_to_cuda, lower_to_torch, simulate  # noqa: E402
from repro_torch.core.lower import to_cuda  # noqa: E402
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager  # noqa: E402
from repro_torch.core.verifier import verify  # noqa: E402
from repro_torch.configs.base import Segment  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.checkpoint.store import restore  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import get_smoke_config, list_archs  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.launch.serve import Engine, make_requests, serve_requests  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import mla, mlp, ssd, transformer  # noqa: E402
from repro_torch.parallel import compression  # noqa: E402
from repro_torch.parallel.api import use_rules  # noqa: E402
from repro_torch.parallel.rules import rules_for  # noqa: E402
from repro_torch.optim.adamw import OptCfg, adamw_update, fixed_by_gradients  # noqa: E402
from repro_torch.train.steps import (init_train_state, make_grad_fn,  # noqa: E402
                                     make_prefill_step, make_train_step)

SEED = 0
LANES = 4096
# the lanes the main path holds to the event-driven simulator (Python, a
# second or more a lane at the large sizes): the first and the last at the
# paper sizes, the last (in the batch's ragged last block) at the large ones
SAMPLED_LANES = {"paper": (0, LANES - 1), "large": (LANES - 1,)}
# the lanes a large loop nest's simulator kernel is held to its plain version
# on, on the CPU: 16 spread over the batch, every block's warp a different one
PLAIN_LANES = np.linspace(0, LANES - 1, 16).astype(np.int64)
# lanes of the simulator's wide check: 2,048 blocks
WIDE_LANES = 65536

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,        # float32 outside the tensor cores
              torch.bfloat16: 989e12}      # bf16 tensor cores
# K5's products run on the TF32 tensor cores (494.7 TFLOP/s) in three passes
TF32X3_FLOPS = 494.7e12 / 3
# the special-function unit (MUFU: ex2, tanh): 16 a cycle an SM, about 3.9 T
# ops/s on an H100 SXM5 (the figure FlashAttention-3 publishes)
SFU_OPS_PER_S = 3.9e12

# design, keyword sizes: the gallery's default (paper) size, then a larger one
DESIGNS = [
    ("array_add", array_add, {}, {"n": 4096}),
    ("transpose", transpose, {}, {"n": 64}),
    ("stencil1d", stencil1d, {}, {"n": 4096}),
    ("histogram", histogram, {}, {"n": 4096, "bins": 256}),
    ("conv2d", conv2d, {}, {"h": 64, "w": 64}),
]
# the designs the frontend traces from PyTorch programs: the workloads' own
# (paper) sizes, then the gallery GEMM's 16^3 on a tile of 4 and 4096-element
# rows like the loop nests above.  K1 and the main path run them with the
# loop nests; the simulator runs them at their test sizes (RTL_MATRIX)
TRACED = [
    ("frontend_matmul", frontend_matmul, {}, {"m": 16, "k": 16, "n": 16, "tile": 4}),
    ("frontend_softmax_row", frontend_softmax_row, {}, {"n": 4096}),
    ("frontend_scan", frontend_scan, {}, {"n": 4096}),
]
ALL_DESIGNS = DESIGNS + TRACED
TRACED_NAMES = {d for d, *_ in TRACED}
# what the verifier says of a traced design after the HLS schedule, which
# hls_compile also verifies without raising: the tiled matmul reads each A
# element in its k loop and uses it in the inner ji loop, a use the verifier
# cannot prove in time (ROADMAP R10).  Any other diagnostic fails the run.
TRACED_VERIFY = {"frontend_matmul": "is defined under time variable"}

# the one PyTorch call that computes a design's function on the lanes batch,
# where there is one: timed as ``library_ms`` and used nowhere in the port
DESIGN_LIBRARY = {
    "array_add": lambda a, b: torch.add(a, b),                  # int32 wraps alike
    "transpose": lambda a: a.transpose(-1, -2).contiguous(),
    # an int32 batched matmul, where the build of the library takes int32
    # on the card (the row says so in ``library_note`` where it does not)
    "frontend_matmul": lambda a, b: torch.matmul(a, b),
}

# the reference's own matrix of the RTL simulator, at the sizes of its test
# (tests/core/test_rtl_sim.py): design -> (gallery module, build kwargs,
# make_inputs kwargs, oracle); mac takes three scalars and returns one
RTL_MATRIX = {
    "array_add": (array_add, {"n": 8}, {"n": 8}, (array_add.oracle, 2)),
    "transpose": (transpose, {"n": 4}, {"n": 4}, (transpose.oracle, 1)),
    "gemm": (gemm, {"n": 4}, {"n": 4}, (gemm.oracle, 2)),
    "gemm_shared": (gemm_shared, {"n": 4}, {"n": 4}, (gemm_shared.oracle, 2)),
    "stencil1d": (stencil1d, {"n": 8}, {"n": 8}, (stencil1d.oracle, 1)),
    "conv2d": (conv2d, {"h": 6, "w": 6}, {"h": 6, "w": 6}, (conv2d.oracle, 1)),
    "histogram": (histogram, {"n": 8, "bins": 4}, {"n": 8, "bins": 4},
                  (functools.partial(histogram.oracle, bins=4), 1)),
    "fifo": (fifo, {"depth": 16, "n": 8}, {"n": 8}, (fifo.oracle, 1)),
    "mac": (mac, {}, None, (None, 0)),
    # the traced designs at the sizes of tests/core/test_frontend.py
    "frontend_matmul": (frontend_matmul, {}, {}, (frontend_matmul.oracle, 2)),
    "frontend_softmax_row": (frontend_softmax_row, {}, {}, (frontend_softmax_row.oracle, 2)),
    "frontend_scan": (frontend_scan, {}, {}, (frontend_scan.oracle, 2)),
}
RTL_HIERARCHIES = ("inline", "modules")
RTL_SEED = 7                       # stack_stimulus's base seed in the reference test

# (M, K, N, tiles) of the matmul: the gallery GEMM's own binding, the ragged
# shapes the tests use, and full-width products, square and ragged (padded by
# ops.matmul), on each dtype's own tile: 128x256 with 64 a stage for the
# bfloat16 wgmma kernel, 128x128 with slabs of 32 for the float32 one
BIG_TILES = {torch.bfloat16: dict(bm=128, bn=256, bk=64),
             torch.float32: dict(bm=128, bn=128, bk=32)}
MATMUL_SHAPES = [
    # the binding's float32 tile; bfloat16 takes the smallest wgmma tile
    (16, 16, 16, {torch.float32: dict(bm=16, bn=16, bk=16),
                  torch.bfloat16: dict(bm=64, bn=16, bk=16)}),
    (8, 8, 8, dict(bm=128, bn=128, bk=128)),
    (100, 130, 70, dict(bm=128, bn=128, bk=128)),
    (4096, 4096, 4096, BIG_TILES),
    (4000, 3992, 4104, BIG_TILES),
]


def tiles_of(tiles: dict, dtype) -> dict:
    return tiles.get(dtype, tiles)
MATMUL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # relative to |plain|max

# the served models and their traffic: 8 requests of 32-token prompts and 16
# new tokens over 4 slots of a 1024-position cache
ARCH, MAMBA, RGEMMA = "tinyllama-1.1b", "mamba2-780m", "recurrentgemma-9b"
MOE = "qwen2-moe-a2.7b"
DEEPSEEK, SEAMLESS, VISION = "deepseek-v2-lite-16b", "seamless-m4t-medium", "llama-3.2-vision-90b"
SLOTS, MAX_LEN, REQUESTS, PROMPT, NEW = 4, 1024, 8, 32, 16
# decode steps each served model's profile traces
PROFILE_STEPS = 4
# (batch, tokens) of each model's prefill step and of its consistency check
PREFILL = {ARCH: (4, 1024), MAMBA: (4, 2048), RGEMMA: (2, 4096), MOE: (4, 1024),
           DEEPSEEK: (4, 1024), SEAMLESS: (4, 1024), VISION: (4, 1024)}
# (the consistency check walks one decode step a token on the host: the
# models after tinyllama check 64 tokens, Mamba-2 and RecurrentGemma as many
# as their chunk and window need)
CONSIST = {ARCH: (2, 128), MAMBA: (2, 264), RGEMMA: (2, 160), MOE: (2, 64),
           DEEPSEEK: (2, 64), SEAMLESS: (2, 64), VISION: (2, 64)}
# llama-3.2-vision-90b (87.7 B parameters, 175 GB in bf16) does not fit one
# card: it is served at full width cut in depth to one group of its pattern,
# four attn layers and one cross_attn layer (about 6.4 B parameters)
SERVE_CUT_REPEATS = {VISION: 1}
# tinyllama-1.1b with Gemma-2's attention logit cap (attn.logit_softcap 50):
# no config of the registry sets the field (RecurrentGemma's 30 is its final
# logits' cap), so the script makes this one from tinyllama's, at full width
# and depth; it is served, prefilled, checked for consistency and its first
# layers' gradients taken like the other models, every score through the
# capped instantiations of K3, K4 and S2.  The JAX package has no such config.
SOFTCAP = 50.0
CAPPED = f"{ARCH} softcap {SOFTCAP:g}"
PREFILL[CAPPED], CONSIST[CAPPED] = PREFILL[ARCH], (2, 64)
# With tinyllama's random weights the scaled scores have a standard deviation
# of about 1, where cap 50 moves a score by at most about s^3 / (3 c^2) = 0.02:
# the served model's checks (serve, consistency) run the capped kernels but
# cannot tell them from uncapped ones.  In the capped gradient check the
# query and key weights are this many times larger (scores about 9 times),
# and the check fails unless the cap moves some leaf by more than its limit.
# (Served so, the bf16 consistency check's noise grows to half the logits.)
CAPPED_QK = 3.0
# the models with cross-attention: a fresh model's tanh gates are 0, which
# hides cross-attention and the cross block's ffn, so the served weights get
# gates drawn from a seed; prefill and consistency feed seeded, non-zero
# frontend embeddings (the Engine fills its cross caches from zero ones, as
# the reference's demo engine does)
CROSS_ARCHS = (SEAMLESS, VISION)
PREFILL_B, PREFILL_S = PREFILL[ARCH]
CONSIST_B, CONSIST_S = CONSIST[ARCH]
# Mamba-2's 264 tokens cross a chunk boundary of 256 and end in a ragged
# chunk of 8.  RecurrentGemma's check is cut to one (rglru, rglru, local_attn)
# group with the window cut to 64, so that its 160 tokens wrap the decode's
# ring and the forward's window masks; float32 only.
RG_CUT_WINDOW = 64
# qwen2-moe's check runs at capacity factor 64, as the reference test sets it
# (capacity drops depend on the queue: no drops in either pass), cut to its
# first 8 layers, so that a float32 copy of their weights fits on the card
# beside the served bfloat16 model; bfloat16 and float32, as tinyllama's.
MOE_CUT_LAYERS, MOE_CONSIST_CF = 8, 64.0
# deepseek-v2-lite's check likewise: its dense first layer and the first 7
# MoE layers (a float32 copy of all 27 would be 63 GB beside the 31.4 GB
# served), at capacity factor 64
# The invariant is held twice on the same weights.  In float32 it is held to
# the reference test's own tolerance (2e-3 + 2e-3 |forward|): there both
# paths compute the same numbers up to the order of their sums.  In bfloat16
# the forward and the teacher-forced decode round activations at other places
# (one product over 128 rows against 128 products of one row) through 22
# residual layers, so they drift apart by bf16 rounding noise, which grows
# with width and depth.  The limit is stated in units of that noise, as
# measured in the same run: the bf16 decode may differ from the bf16 forward
# by at most 3x the largest distance of the bf16 forward from the float32
# forward (each bf16 path carries noise of about that size; 3x leaves the
# decode's own noise room to be twice the forward's).
CONSIST_TOL32 = 2e-3
CONSIST_NOISE = 3.0

# the reference kernel tests' _tol: |kernel - plain| <= atol + rtol * |plain|
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Queries drawn this many times larger on the MLA and cross-model rows,
# which average over a thousand keys or more: with queries of unit scale the
# softmax there is nearly flat, |o| is about 0.04 and the absolute term of
# the bfloat16 tolerance is half of it.  Sharper, the softmax peaks on a few
# keys and |o| is of order 1 (each row records its RMS), so a key tile
# dropped or counted twice moves the rows that peak in it by about |v|.
PEAKED_Q = 4.0
# Queries this many times normal put the median query row's largest scaled
# score (head dim 64, keys normal) near 0.9 of the cap of 50: the capped
# checks near the cap
NEAR_CAP_Q = 15.0
# and test_ssd_scan's / test_rglru_scan's, against the step-by-step oracles
SCAN_TOL = 2e-4
# the flash kernel's backward (S2) against its plain version: per tensor,
# max |kernel - plain| <= tol * max |plain| (float32 sums in other orders;
# in bfloat16 one rounding of each output to 8 bits on top)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# training: tinyllama-1.1b at full width and depth, in bfloat16 with
# remat="block" as its config has it, on the synthetic stream; 4 x 2048
# tokens a step, 6 steps, one checkpoint after the last (11.0 GB of state,
# written under the checkout's build/, removed after)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_EVERY = 4, 2048, 6, 6
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, decay_steps=8)
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
# its gradients in bfloat16 through K3 and S2 against float32 plain ones, at
# full width cut to the first layers, as the consistency checks hold bf16
# (each leaf's relative L2 error at most 3x the bf16 plain path's)
GRAD_CUT_LAYERS, GRAD_B, GRAD_S = 2, 2, 1024
# and deepseek-v2-lite's dense MLA layers alike (K3 and S2 at (192, 128)), at
# the MLA S2 row's shape: 2 x 2048 tokens
MLA_GRAD_B, MLA_GRAD_S = 2, 2048
# every other arch trained at full width (phase_train_archs), 2 x 2048 tokens
# a step (Mamba-2 4 x 2048, the S3 row's shape).  The step is functional: as
# it ends the old and the new state are both alive, with the gradients and
# their clipped copy (24 bytes a parameter), and AdamW's float32 temporaries
# of the largest leaf (about 20 bytes an element).  Depth is cut to whole
# repeats of a segment's pattern (0 drops a segment) so that this stays
# under about 65 GB of the card's 80: qwen2-7b 4 of 28 layers,
# qwen2.5-14b 1 of 48 (its 0.78 B-element embedding alone takes 15.6 GB of
# temporaries), qwen2-moe 3 of 24, deepseek-v2-lite its dense layer and 3
# MoE layers, recurrentgemma-9b one (rglru, rglru, local_attn) group (its
# tied 1.05 B-element embedding: 21 GB of temporaries).  mamba2-780m,
# smollm-360m and seamless-m4t-medium run whole.
TRAIN_ARCHS = ("mamba2-780m", "recurrentgemma-9b", "smollm-360m", "qwen2-7b", "qwen2.5-14b",
               MOE, DEEPSEEK, SEAMLESS, VISION)
TRAIN_CUT = {"qwen2-7b": (4,), "qwen2.5-14b": (1,), MOE: (3,), DEEPSEEK: (1, 3),
             RGEMMA: (1, 0), VISION: (1,)}
TRAIN_ARCH_SHAPE = {MAMBA: (4, 2048)}
# llama-3.2-vision-90b: its one serving group (6.39 B parameters) takes its
# gradients only; the step's 24 bytes a parameter would be 153 GB, and even
# one layer (2.97 B) needs some 92 GB with its two 1.05 B-element vocab leaves
GRAD_ONLY = {VISION: "the AdamW step of one group needs over 153 GB (24 bytes a parameter, "
                     "before AdamW's float32 temporaries); one layer alone about 92 GB"}
# the dry-run (launch.dryrun) in a process of its own, which makes its own
# fake process group of 256 ranks where this one holds the one-rank NCCL
# world: two production cells and the train phase's own step on one rank
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"))
DRYRUN_SECONDS = 300
DRYRUN_CODE = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
arch, B, S, cells = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), json.loads(sys.argv[4])
out = {"cells": [dryrun.run_cell(a, s, False, verbose=False) for a, s in cells]}
cfg = get_config(arch)
shape = ShapeCfg("train", S, B, "train")
st, secs, _, _ = dryrun.analyze(cfg, shape, (1, 1), ("data", "model"), num_microbatches=1)
out["one_rank"] = dict(arch=arch, batch=B, seq=S, remat=cfg.remat, trace_s=secs,
                       **dryrun.record(st, cfg, shape, 1))
print("DRYRUN " + json.dumps(out, default=str))
"""
# the examples/train_tinylm_torch.py run: 40 steps, a failure injected at 12
EXAMPLE_STEPS, EXAMPLE_FAIL_AT = 40, 12
# the mesh: one rank, one NCCL process group over an in-process store (NCCL
# takes one rank a card; the multi-rank paths run over gloo in the CPU tests).
# tinyllama's decode under the flash-decode rules, 16 steps from each lane's
# first position, and one int8-compressed train step at the training shape
MESH_SHAPE, MESH_AXES = (1, 1, 1), ("pod", "data", "model")
MESH_DECODE_STEPS, MESH_START = 16, (0, 100, 513, 900)
# qwen2-moe's first MoE layer on 4 x 64 tokens, expert-parallel against local
MESH_MOE_TOKENS = 64


def emit(key: str, value) -> None:
    print(json.dumps({key: value}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5):
    """Device time of one call without the host's part: a CUDA graph holds
    ``calls`` calls, and the mean time of one replay (over ``replays``, after
    one warm-up replay) is divided by ``calls``.  Returns (ms, None), or
    (None, the reason) where the call cannot be captured."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(stream):
            fn()                                   # warm-up on the capturing stream
            with torch.cuda.graph(graph, stream=stream):
                for _ in range(calls):
                    fn()
    except Exception as e:                         # the capture was refused
        torch.cuda.synchronize()
        return None, f"not captured: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return ms, None


def device_times(kernel, library) -> dict:
    """``device_ms`` of the kernel's call and of the library call (``graph_ms``),
    with the reason where one could not be captured."""
    out = {}
    for key, fn in (("device_ms", kernel), ("library_device_ms", library)):
        out[key], why = graph_ms(fn)
        if why:
            out[key + "_note"] = why
    return out


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# -- designs --------------------------------------------------------------------


def n_read_ports(module, name) -> int:
    return sum(1 for a in module.get(name).args if a.type.port == "r")


@contextlib.contextmanager
def no_hls_cache():
    """The HLS schedule caches off (``REPRO_HLS_CACHE=0``), so that a traced
    design's build pays for its schedule as a first build does."""
    old = os.environ.get("REPRO_HLS_CACHE")
    os.environ["REPRO_HLS_CACHE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_HLS_CACHE"]
        else:
            os.environ["REPRO_HLS_CACHE"] = old


def compile_design(gal, size: dict, device, *, cold: bool = False):
    """The user's flow up to the callable: build (for a traced design:
    trace + HLS schedule, cold: the schedule caches off) -> verify ->
    optimize -> lower.  Returns (module, entry, callable, notes): the build's
    seconds and the verifier's diagnostics, which fail the run unless they
    are a traced design's known ones (``TRACED_VERIFY``)."""
    t0 = time.perf_counter()
    with no_hls_cache() if cold else contextlib.nullcontext():
        module, name = gal.build(**size)
    build_s = time.perf_counter() - t0
    diags = verify(module, raise_on_error=False)
    known = TRACED_VERIFY.get(name)
    if diags and not (known and all(known in d.render() for d in diags)):
        fail(f"verifier rejected {name} {size}: {[d.render() for d in diags]}")
    PassManager.from_spec(DEFAULT_PIPELINE_SPEC).run(module)
    notes = {"build_s": build_s,
             "verifier": [" ".join(d.render().split())[:240] for d in diags]}
    return module, name, lower_to_cuda(module, name, device=device), notes


_stimulus_cache: dict = {}


def stimulus(gal, size: dict, lanes: int) -> list[np.ndarray]:
    """``lanes`` seeded stimulus vectors, batch first, one array per argument
    (made once per design and size: the phases share them)."""
    key = (gal.__name__, tuple(sorted(size.items())), lanes)
    if key not in _stimulus_cache:
        takes = inspect.signature(gal.make_inputs).parameters     # not build's tile
        kw = {k: v for k, v in size.items() if k in takes}
        per_lane = [gal.make_inputs(**kw, seed=SEED + s) for s in range(lanes)]
        _stimulus_cache[key] = [np.stack([lane[i] for lane in per_lane])
                                for i in range(len(per_lane[0]))]
    return _stimulus_cache[key]


def oracle(gal, size: dict, ins: list[np.ndarray]) -> np.ndarray:
    extra = {"bins": size["bins"]} if "bins" in size else {}
    return gal.oracle(*ins, **extra)


def as_i64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


# -- phases ---------------------------------------------------------------------


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("env", {"python": sys.version.split()[0], "torch": torch.__version__,
                 "cuda": torch.version.cuda, "nvcc": _build.find_nvcc(),
                 "device": torch.cuda.get_device_name(0),
                 "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


# the hand-written kernels' sources; the attention and scan kernels (all but
# matmul) take nvcc longest and are first needed after the compiler's phases
CSRC = ("matmul.cu", "flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu",
        "ssd_scan.cu", "ssd_scan_bwd.cu", "rglru_scan.cu")
BUILD_T0: list[float] = []


def phase_build(device) -> tuple[dict, list[dict], list, list]:
    """Generate every design's kernels — K1 of each loop nest (and of each
    large one with no room for staging, ``k1_without_staging``), S1 of each
    simulated design — and start one nvcc per source, all at once; then wait
    for all but the attention and scan kernels, which build on beside the
    compiler's phases (``finish_csrc``).  Returns the compiled loop nests,
    the simulator cases, the unstaged loop nests and the pending builds."""
    BUILD_T0.append(time.perf_counter())
    compiled = {}
    csrc = [_build.start_build(*_build.csrc_source(src)) for src in CSRC]
    pending = csrc[:1]
    for dname, gal, paper, large in ALL_DESIGNS:
        for tag, size in (("paper", paper), ("large", large)):
            module, name, fn, _ = compile_design(gal, size, device)
            compiled[(dname, tag)] = (module, name, fn, size)
            pending.append(_build.start_build(fn.stem, fn.source))
    budget = to_cuda.STAGE_BYTES_PER_PAIR
    to_cuda.STAGE_BYTES_PER_PAIR = 0
    try:
        unstaged = [(dname, gal, large) + compile_design(gal, large, device)[:3]
                    for dname, gal, _, large in DESIGNS]
    finally:
        to_cuda.STAGE_BYTES_PER_PAIR = budget
    pending += [_build.start_build(fn.stem, fn.source) for *_, fn in unstaged]
    cases = rtl_cases(compiled, device)
    for case in cases:
        kernel = case["sim"].cuda_kernel()
        pending.append(_build.start_build(kernel.stem, kernel.source))
        case["stem"] = pending[-1].name
    for p in pending:
        _build.finish_build(p)
    return compiled, cases, unstaged, csrc[1:]


def finish_csrc(pending: list) -> None:
    """Wait for the attention and scan kernels' builds; then the ``build``
    line: nvcc's seconds for every library (from its start), and ``_wall``
    from the first build's start to the last one's end."""
    for p in pending:
        _build.finish_build(p)
    secs = dict(_build.build_seconds)
    secs["_wall"] = time.perf_counter() - BUILD_T0[0]
    emit("build", secs)


def element_steps(module, name) -> int:
    """Executions of the innermost bodies of the design's main loop (its
    largest-trip top-level loop): the element steps one lane walks.  (A
    traced design chains several nests of equal trip; this counts one.)"""
    def steps(ops) -> int:
        loops = [op for op in ops if op.opname == "for"]
        return sum(op.trip_count() * max(1, steps(op.region(0).ops)) for op in loops)
    top = [op for op in module.get(name).body.ops if op.opname == "for"]
    main = max(top, key=lambda op: op.trip_count())
    return main.trip_count() * max(1, steps(main.region(0).ops))


def k1_case(dname, tag, module, name, fn, size, ins, lanes, plain=None) -> tuple[dict, dict]:
    """One generated kernel against its plain version, bit-exact: the plain
    version run (and timed) on ``ins``, or its result ``plain`` where the
    caller has it already.  Returns the row and the plain result."""
    got = fn(*ins)
    torch.cuda.synchronize()
    plain_ms = None
    if plain is None:
        plain = {}
        plain_ms = wall_ms(lambda: plain.update(fn.plain(*ins)))
    err = 0
    for k in plain:
        if got[k].shape != plain[k].shape or got[k].dtype != plain[k].dtype:
            fail(f"K1 {dname}/{tag}/{lanes}: shape or dtype differs from plain")
        err = max(err, int((got[k].long() - plain[k].long()).abs().max()))
    if err != 0:
        fail(f"K1 {dname}/{tag}/{lanes} lanes differs from its plain version by {err}")
    ms = time_ms(lambda: fn(*ins), 20)
    library_ms, library_note = None, None
    if dname in DESIGN_LIBRARY:
        lib_call = DESIGN_LIBRARY[dname]
        (kernel_out,) = got.values()
        try:
            lib_out = lib_call(*ins)
        except RuntimeError as e:                  # the library refuses the dtype here
            library_note = f"refused: {str(e).splitlines()[0][:160]}"
        else:
            if not torch.equal(lib_out, kernel_out):
                fail(f"K1 {dname}/{tag}/{lanes}: the library call computes another function")
            library_ms = time_ms(lambda: lib_call(*ins), 20)
    nbytes = lanes * 4 * sum(int(np.prod(a.type.shape)) for a in module.get(name).args)
    threads, pf = fn.launch_shape(lanes, ins[0].device)
    steps = element_steps(module, name)
    row = {
        "name": f"lower_to_cuda[{dname},{tag},{lanes} lanes]", "route": "cuda",
        "source": "src/repro_torch/core/lower/to_cuda.py",
        "replaces": "src/repro/core/lower/to_pallas.py:200",
        "shape": {"design": dname, "size": size or "default", "lanes": lanes},
        "launch": {"lanes_per_block": threads, "prefetch_distance": pf,
                   "staged": fn.kernel.staged, "chunk": fn.kernel.chunk,
                   "shared_allocs": fn.kernel.shared_allocs},
        "launches": 0, "max_abs_err": err, "tolerance": 0,
        "ms": ms, "plain_ms": plain_ms, "element_steps": steps, "ns_per_step": ms * 1e6 / steps,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": library_ms, **({"library_note": library_note} if library_note else {}),
    }
    if plain_ms is None:
        row["plain_ms_note"] = "not run: the LANES row's plain result, lane 0's appended"
    return row, plain


def phase_kernels_k1(compiled, device) -> list[dict]:
    """Each generated kernel against its plain version, bit-exact, at every
    shape the main path runs: both sizes, 1 lane and ``LANES`` lanes; and,
    as a check no main path runs (``launches: null``), at ``LANES + 1``
    lanes, a last block of one lane."""
    rows = []
    for (dname, tag), (module, name, fn, size) in compiled.items():
        gal = next(g for d, g, _, _ in ALL_DESIGNS if d == dname)
        n_in = n_read_ports(module, name)
        batch = stimulus(gal, size, LANES)[:n_in]
        dev_batch = [torch.as_tensor(x).to(device=device, dtype=torch.int32) for x in batch]
        for lanes in (1, LANES):
            ins = dev_batch if lanes > 1 else [x[0] for x in dev_batch]
            row, plain = k1_case(dname, tag, module, name, fn, size, ins, lanes)
            rows.append(row)
        # the plain version works lane by lane: on the batch with lane 0
        # appended, its result is the batch's with lane 0's appended
        ragged = [torch.cat([x, x[:1]]) for x in dev_batch]
        want = {k: torch.cat([v, v[:1]]) for k, v in plain.items()}
        check, _ = k1_case(dname, tag, module, name, fn, size, ragged, LANES + 1, plain=want)
        check["launches"] = None
        rows[-1]["checks"] = [check]
    return rows


def int_operands(M, K, N, dtype, device):
    """Small-integer operands: every product and partial sum is exact in
    float32, so the kernel can be held to an exact reference."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    x = torch.randint(-8, 9, (M, K), generator=g).to(device=device, dtype=dtype)
    y = torch.randint(-8, 9, (K, N), generator=g).to(device=device, dtype=dtype)
    return x, y


def phase_kernels_k2(device) -> list[dict]:
    """The matmul kernel against its plain version on normal-distributed
    operands, within the tolerance of the tests, at every shape."""
    rows = []
    g = torch.Generator(device="cpu").manual_seed(SEED)
    for M, K, N, both in MATMUL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tiles = tiles_of(both, dtype)
            x = torch.randn((M, K), generator=g).to(device=device, dtype=dtype)
            y = torch.randn((K, N), generator=g).to(device=device, dtype=dtype)
            got = ops.matmul(x, y, **tiles)
            torch.cuda.synchronize()
            want = ref.matmul_ref(x, y)
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"K2 {M,K,N} {dtype}: shape or dtype differs from plain")
            err = float((got.float() - want.float()).abs().max())
            # sums run in another order than the library's: tolerance of the
            # tests, scaled by the magnitude of the result
            limit = MATMUL_TOL[dtype] * max(1.0, float(want.float().abs().max()))
            if not err <= limit:
                fail(f"K2 {M,K,N} {dtype}: max |kernel - plain| = {err} > {limit}")
            iters = 10 if M >= 1024 else 50
            flops, nbytes = 2.0 * M * N * K, (M * K + K * N + M * N) * x.element_size()
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
            sched = mm.schedule(tiles["bm"], tiles["bn"], tiles["bk"], dtype)
            rows.append({
                "name": f"matmul[{M}x{K}x{N},{str(dtype).split('.')[-1]}]", "route": "cuda",
                "source": "src/repro_torch/csrc/matmul.cu",
                "replaces": "src/repro/kernels/matmul.py:71",
                "shape": {"M": M, "K": K, "N": N, "dtype": str(dtype)},
                "kernel": sched.pop("kernel"), "launcher": sched.pop("launcher"),
                "tile": sched,
                "launches": 0, "max_abs_err": err, "tolerance": limit,
                "ms": time_ms(lambda: ops.matmul(x, y, **tiles), iters),
                "plain_ms": time_ms(lambda: ref.matmul_ref(x, y), iters),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": time_ms(lambda: torch.matmul(x, y), iters),
            })
    return rows


def phase_k1_without_staging(cases, device) -> None:
    """What staging buys: each large design's kernel generated with no
    room for staging (so its reads known ahead are only prefetched; built
    in ``phase_build``), held bit-exact to its plain version and timed at
    ``LANES`` lanes beside the staged kernel's ``ms`` in the ``kernels``
    line.  Outside every main path: its launches count nowhere."""
    out = []
    for dname, gal, size, module, name, fn in cases:
        if fn.kernel.staged:
            fail(f"{dname}: staged with no room for staging")
        ins = [torch.as_tensor(x).to(device=device, dtype=torch.int32)
               for x in stimulus(gal, size, LANES)[:n_read_ports(module, name)]]
        got, want = fn(*ins), fn.plain(*ins)
        if not all(torch.equal(got[k], want[k]) for k in want):
            fail(f"{dname}: the unstaged kernel differs from its plain version")
        ms = time_ms(lambda: fn(*ins), 20)
        out.append({"design": dname, "size": size, "lanes": LANES, "ms": ms,
                    "ns_per_step": ms * 1e6 / element_steps(module, name),
                    "prefetch_bytes_per_iteration": fn.kernel.prefetch_bytes,
                    "shared_allocs": fn.kernel.shared_allocs})
    emit("k1_without_staging", out)


def k2_binding_check(compiled, device) -> dict:
    """The port's twin of ``test_gemm_binds_to_mxu_kernel`` for the traced
    GEMM: ``frontend_matmul`` at 16^3 (tile 4) through ``lower_to_cuda``
    (K1) equals K2's integer-exact float32 kernel on its 16x16x16 tile and
    the oracle.  A check: no main path counts it."""
    module, name, fn, size = compiled[("frontend_matmul", "large")]
    m, k, n = size["m"], size["k"], size["n"]
    a, b, _ = frontend_matmul.make_inputs(m=m, k=k, n=n, seed=SEED)
    x, y = (torch.as_tensor(v).to(device=device, dtype=F32) for v in (a, b))
    tiles = dict(bm=16, bn=16, bk=16)
    got = ops.matmul(x, y, **tiles)
    traced = fn(*(torch.as_tensor(v).to(device=device, dtype=torch.int32) for v in (a, b)))["out"]
    torch.cuda.synchronize()
    want = frontend_matmul.oracle(a, b)
    if not (np.array_equal(as_i64(got), want) and np.array_equal(as_i64(traced), want)):
        fail("frontend_matmul 16^3: the traced design and its matmul binding differ")
    bound_ms, bound_by = bound(2.0 * m * n * k, (m * k + k * n + m * n) * 4, F32)
    return {
        "name": f"matmul[frontend_matmul binding {m}x{k}x{n},float32]", "route": "cuda",
        "source": "src/repro_torch/csrc/matmul.cu", "replaces": "src/repro/kernels/matmul.py:71",
        "shape": {"M": m, "K": k, "N": n, "dtype": "torch.float32", "design": "frontend_matmul",
                  "tile": size["tile"]},
        "launches": None, "max_abs_err": 0, "tolerance": 0,
        "ms": time_ms(lambda: ops.matmul(x, y, **tiles), 50),
        "traced_design_k1_ms": time_ms(lambda: fn(x.int(), y.int()), 50),
        "plain_ms": time_ms(lambda: ref.matmul_ref(x, y), 50),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: torch.matmul(x, y), 50),
    }


def phase_main_path(device) -> dict:
    """The flow a user runs, through the public entry points only.  Returns
    the launches each kernel case made, keyed like the ``kernels`` rows."""
    launches: dict[str, int] = {}
    report = []
    for dname, gal, paper, large in ALL_DESIGNS:
        traced = dname in TRACED_NAMES
        for tag, size in (("paper", paper), ("large", large)):
            t0 = time.perf_counter()
            module, name, fn, notes = compile_design(gal, size, device, cold=traced)
            n_in = n_read_ports(module, name)
            batch = stimulus(gal, size, LANES)
            out_name = module.get(name).args[-1].name

            # one stimulus vector, as the reference's callable takes it
            before = fn.launches
            one = fn(*[x[0] for x in batch[:n_in]])[out_name]
            launches[f"lower_to_cuda[{dname},{tag},1 lanes]"] = fn.launches - before
            # LANES stimulus vectors at once
            before = fn.launches
            many = fn(*batch[:n_in])[out_name]
            launches[f"lower_to_cuda[{dname},{tag},{LANES} lanes]"] = fn.launches - before
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0

            many_np = as_i64(many)
            if many_np.shape != (LANES,) + tuple(module.get(name).args[-1].type.shape):
                fail(f"{dname}/{tag}: output shape {many_np.shape}")
            if not np.array_equal(as_i64(one), many_np[0]):
                fail(f"{dname}/{tag}: the 1-lane run differs from lane 0 of the batch")
            for s in range(LANES):
                want = oracle(gal, size, [x[s] for x in batch[:n_in]])
                if not np.array_equal(many_np[s], want):
                    fail(f"{dname}/{tag}: lane {s} differs from the NumPy oracle")
            idx = list(SAMPLED_LANES[tag])
            for s in idx:
                sim_args = [np.array(x[s], copy=True) for x in batch]
                simulate(module, name, sim_args)
                if not np.array_equal(sim_args[-1], many_np[s]):
                    fail(f"{dname}/{tag}: lane {s} differs from the simulator")
            functional = lower_to_torch(module, name, device=device)(
                *[x[idx] for x in batch])[out_name]
            if not np.array_equal(as_i64(functional), many_np[idx]):
                fail(f"{dname}/{tag}: differs from lower_to_torch")
            row = {"design": dname, "size": size or "default", "lanes": [1, LANES],
                   "oracle_lanes": LANES, "simulated_lanes": len(idx),
                   "functional_lanes": len(idx), "seconds_to_result": run_s}
            if traced:
                row.update({"trace_s": notes["build_s"], "verifier": notes["verifier"]})
            report.append(row)

    # the GEMM binding: the systolic array of the paper is the matmul kernel
    module, name = gemm.build()
    if verify(module):
        fail("verifier rejected gemm")
    a, b, _ = gemm.make_inputs(seed=SEED)
    for M, K, N, both in MATMUL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tiles = tiles_of(both, dtype)
            key = f"matmul[{M}x{K}x{N},{str(dtype).split('.')[-1]}]"
            before = mm.launches
            if (M, K, N) == a.shape + b.shape[1:] and dtype == torch.float32:
                got = ops.matmul(torch.as_tensor(a).to(device=device, dtype=dtype),
                                 torch.as_tensor(b).to(device=device, dtype=dtype), **tiles)
                if not np.array_equal(as_i64(got), gemm.oracle(a, b)):
                    fail("GEMM binding differs from gemm.oracle")
            else:
                x, y = int_operands(M, K, N, dtype, device)
                got = ops.matmul(x, y, **tiles)
                want = (x.double() @ y.double()).to(dtype)
                if not torch.equal(got, want):
                    fail(f"matmul {M,K,N} {dtype} is not exact on integer operands")
            launches[key] = mm.launches - before
    torch.cuda.synchronize()
    emit("main_path", {"designs": report, "gemm_binding": "exact",
                       "matmul_shapes": [[M, K, N] for M, K, N, _ in MATMUL_SHAPES]})
    return launches


# -- the RTL simulator's kernel (S1) ----------------------------------------------


def rtl_stimulus(dname: str, lanes: int) -> list[np.ndarray]:
    """The reference test's stimulus: ``stack_stimulus`` of the design's
    inputs from seed 7; mac's three scalar columns as its mac test draws
    them."""
    gal, _, ikw, _ = RTL_MATRIX[dname]
    if ikw is None:
        rng = np.random.default_rng(11)
        return [rng.integers(0, 1 << 15, size=lanes).astype(np.int64) for _ in range(3)]
    return rtl_sim.stack_stimulus(gal.make_inputs, lanes, base_seed=RTL_SEED, **ikw)


def rtl_cases(compiled, device) -> list[dict]:
    """Every design the simulator runs on the card, with its simulator and
    stimulus: the reference's matrix (the nine hand-written designs at the
    sizes of its test and the three traced ones at the sizes of the
    frontend's test, x {inline, modules}, unoptimized as the tests build
    them) and the five loop nests at both sizes (inline, after the
    optimizer, as K1 runs them).  The traced designs are sequential nests:
    they run ``drained_cycles``."""
    cases = []
    for dname, (gal, bkw, _, _) in RTL_MATRIX.items():
        batch = rtl_stimulus(dname, LANES)
        for hierarchy in RTL_HIERARCHIES:
            module, entry = gal.build(**bkw)
            sim, prepared = rtl_sim.simulator_for(module, entry, hierarchy=hierarchy,
                                                  device=device)
            count = drained_cycles if dname in TRACED_NAMES else rtl_sim.probe_cycles
            cases.append({"name": f"rtl_sim[{dname},{hierarchy},{LANES} lanes]",
                          "design": dname, "hierarchy": hierarchy, "tag": "matrix",
                          "module": module, "entry": entry, "sim": sim, "batch": batch,
                          "cycles": count(prepared, entry, [c[0] for c in batch])})
    for (dname, tag), (module, name, fn, size) in compiled.items():
        if dname in TRACED_NAMES:
            continue
        gal = next(g for d, g, _, _ in DESIGNS if d == dname)
        batch = stimulus(gal, size, LANES)
        sim, prepared = rtl_sim.simulator_for(module, name, device=device)
        cases.append({"name": f"rtl_sim[{dname},{tag},inline,{LANES} lanes]",
                      "design": dname, "hierarchy": "inline", "tag": tag, "size": size,
                      "module": module, "entry": name, "sim": sim, "batch": batch, "k1": fn,
                      "cycles": drained_cycles(prepared, name, [c[0] for c in batch])})
    return cases


def drained_cycles(prepared, entry, lane0) -> int:
    """Cycles a loop nest runs until its last write has landed: the
    event-driven simulator's count, plus ``probe_cycles``' margin of 16, plus
    a quarter of the count.  The RTL of a sequential loop nest finishes one
    cycle per outer iteration later than the event-driven simulator says
    (ROADMAP R9: transpose n x n, n cycles; conv2d h x w, 2h - 1), which the
    margin of 16 covers only at the reference test's sizes.  Cycles past the
    end leave a finished design's state as it is."""
    event = rtl_sim.probe_cycles(prepared, entry, lane0, margin=0)
    return event + 16 + event // 4


def plain_twin(sim):
    """The same compiled tape on the plain backend (``_TorchOps``), on the
    same device."""
    twin = copy.copy(sim)
    twin.backend, twin._kernel = "torch", None
    return twin


def lanes_of(res, idx):
    """The lanes ``idx`` of a simulator result."""
    return dataclasses.replace(
        res, batch=len(idx), arrays={i: a[idx] for i, a in res.arrays.items()},
        returns=[r[idx] for r in res.returns], returns_valid=[v[idx] for v in res.returns_valid],
        conflicts=res.conflicts[idx],
        trace=None if res.trace is None else {n: y[:, idx] for n, y in res.trace.items()})


def s1_words(sim, lay) -> tuple[int, int]:
    """Words and bytes a lane the run must move at least: each register word
    and each shift-register ring word read once and written once, each
    memory word read once and written once more where the tape writes that
    memory; bytes at each word's own size, 4 or 8."""
    words = nbytes = 0
    for nb in lay.slot_bytes:
        words, nbytes = words + 2, nbytes + 2 * nb
    for p in lay.rings + lay.mems:
        n = p.depth * (2 if p in lay.rings else 1 + p.written)
        words, nbytes = words + n, nbytes + n * p.nbytes
    return words, nbytes


def same_sim_result(a, b) -> bool:
    return (sorted(a.arrays) == sorted(b.arrays)
            and all(np.array_equal(a.arrays[i], b.arrays[i]) for i in a.arrays)
            and all(np.array_equal(x, y) for x, y in zip(a.returns, b.returns))
            and all(np.array_equal(x, y) for x, y in zip(a.returns_valid, b.returns_valid))
            and np.array_equal(a.conflicts, b.conflicts)
            and (a.trace is None) == (b.trace is None)
            and (a.trace is None or (list(a.trace) == list(b.trace) and all(
                np.array_equal(a.trace[n], b.trace[n]) for n in a.trace))))


def s1_case(case, device) -> dict:
    """One simulator kernel, timed at its main-path shape, against the plain
    version (arrays, returns, valid flags, conflict counts and traces): on
    the same card and the same lanes for the matrix and the paper sizes; at
    the large sizes, where the eager plain version on the card would take
    some 10^6 launches, on the CPU on ``PLAIN_LANES``, held to those lanes
    of the kernel's run over the whole batch and to the kernel run on them
    alone with its trace."""
    sim, batch, cycles = case["sim"], case["batch"], case["cycles"]
    kernel = sim.cuda_kernel()
    row = {"name": case["name"], "route": "cuda",
           "source": "src/repro_torch/core/codegen/sim_cuda.py",
           "replaces": "src/repro/core/codegen/sim.py:797 (jit(scan(vmap(step))), "
                       "no TPU kernel)",
           "shape": {"design": case["design"], "hierarchy": case["hierarchy"],
                     "size": case.get("size") or ("test" if case["tag"] == "matrix"
                                                  else "default"),
                     "lanes": LANES},
           "launches": 0, "tolerance": 0}
    kernel.build()                              # the library loaded before any timing
    full = {}
    row["run_ms"] = wall_ms(lambda: full.update(res=sim.run(
        batch, cycles, batched=True, check_conflicts=False)))
    if case["tag"] != "large":
        got = sim.run(batch, cycles, batched=True, trace=True, check_conflicts=False)
        plain = {}
        row["plain_ms"] = wall_ms(lambda: plain.update(res=plain_twin(sim).run(
            batch, cycles, batched=True, trace=True, check_conflicts=False)))
        same = same_sim_result(got, plain["res"])
    else:
        part = [c[PLAIN_LANES] for c in batch]
        got = sim.run(part, cycles, batched=True, trace=True, check_conflicts=False)
        plain, row["plain_ms"] = s1_plain_on_cpu(case["name"])
        row["plain_on"] = (f"cpu, {len(PLAIN_LANES)} of {LANES} lanes, in a process of its "
                           f"own (start_s1_plain)")
        same = (same_sim_result(got, plain) and same_sim_result(
            lanes_of(full["res"], PLAIN_LANES), dataclasses.replace(plain, trace=None)))
    if not same:
        fail(f"{case['name']}: the simulator kernel differs from its plain version")
    row["max_abs_err"] = 0
    row.update(s1_timing(kernel, sim, batch, LANES, cycles, device))
    del full
    return row


def start_host_job(code: str, args: list[str], out_dir: Path) -> dict:
    """Start ``python -c code *args`` on the host in a process of its own,
    which runs beside the card's phases on one core, its standard output
    and error in files under ``out_dir``; the process is killed at exit if
    it is still running."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               OMP_NUM_THREADS="1")
    out, err = (open(out_dir / name, "w+") for name in ("stdout", "stderr"))
    proc = subprocess.Popen([sys.executable, "-c", code, *args], stdout=out, stderr=err,
                            text=True, env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "stdout": out, "stderr": err, "t0": time.perf_counter()}


def finish_host_job(job: dict, limit_s: float, what: str) -> str:
    """Wait for ``job`` until ``limit_s`` after its start; fail unless it
    exits 0.  Returns its standard output."""
    proc = job["proc"]
    try:
        proc.wait(timeout=max(1.0, limit_s - (time.perf_counter() - job["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"{what}: the subprocess ran past {limit_s} s")
    for f in (job["stdout"], job["stderr"]):
        f.seek(0)
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}: {job['stderr'].read()[-2000:]}")
    return job["stdout"].read()


S1_PLAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_s1_plain"
S1_PLAIN_SECONDS = 600
S1_PLAIN_CODE = """
import importlib, pickle, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.core.codegen import sim as rtl_sim
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager
with open(sys.argv[1], "rb") as f:
    jobs = pickle.load(f)
out = {}
for job in jobs:
    module, name = importlib.import_module(job["gallery"]).build(**job["size"])
    PassManager.from_spec(DEFAULT_PIPELINE_SPEC).run(module)
    sim, _ = rtl_sim.simulator_for(module, name, backend="torch", device=torch.device("cpu"))
    t0 = time.perf_counter()
    res = sim.run(job["part"], job["cycles"], batched=True, trace=True, check_conflicts=False)
    out[job["name"]] = (res, (time.perf_counter() - t0) * 1e3)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""
S1_PLAIN: dict = {}


def start_s1_plain(cases) -> None:
    """The plain simulator (``_TorchOps``) of each large loop nest on the
    CPU, on ``PLAIN_LANES`` of its batch, in a process of its own
    (``start_host_job``; tens of seconds of eager CPU ops): the design built
    as ``compile_design`` builds it, then ``simulator_for`` on the CPU.
    ``s1_plain_on_cpu`` reads its results."""
    S1_PLAIN_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [{"name": c["name"], "size": c["size"], "cycles": c["cycles"],
             "gallery": next(g for d, g, _, _ in DESIGNS if d == c["design"]).__name__,
             "part": [x[PLAIN_LANES] for x in c["batch"]]}
            for c in cases if c["tag"] == "large"]
    with open(S1_PLAIN_DIR / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    S1_PLAIN["job"] = start_host_job(S1_PLAIN_CODE, [str(S1_PLAIN_DIR / "jobs.pkl"),
                                                     str(S1_PLAIN_DIR / "out.pkl")], S1_PLAIN_DIR)


def s1_plain_on_cpu(name: str):
    """(result, ms) of the plain simulator on the CPU for the large case
    ``name``, from ``start_s1_plain``'s process (waited for once)."""
    if "out" not in S1_PLAIN:
        finish_host_job(S1_PLAIN["job"], S1_PLAIN_SECONDS, "the plain simulator on the CPU")
        with open(S1_PLAIN_DIR / "out.pkl", "rb") as f:
            S1_PLAIN["out"] = pickle.load(f)
    return S1_PLAIN["out"][name]


def s1_timing(kernel, sim, batch, lanes, cycles, device) -> dict:
    """A simulator kernel's time over ``lanes`` lanes and its byte bound (a
    lane's state at each word's size; at 8 bytes a word, the count before
    the words were narrowed, beside it), with where its state lives."""
    bufs = kernel.buffers(sim, batch, lanes, device)
    iters = 3 if cycles > 1000 else 10
    ms = time_ms(lambda: kernel.launch(bufs, lanes, cycles, None, device), iters)
    device_ms = graph_ms(lambda: kernel.launch(bufs, lanes, cycles, None, device),
                         calls=3 if cycles > 1000 else 20)[0]
    words, nbytes = s1_words(sim, kernel.layout)
    lay = kernel.layout
    del bufs
    return {"ms": ms, "device_ms": device_ms,
            "state_words_moved_per_lane": words, "state_bytes_moved_per_lane": nbytes,
            "bound_ms": nbytes * lanes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_ms_at_8_bytes_a_word": words * lanes * 8 / HBM_BYTES_PER_S * 1e3,
            "library_ms": None, "cycles": cycles, "ns_per_cycle": ms * 1e6 / cycles,
            "placement": lay.placement(), "word_bytes": lay.word_bytes(),
            "shared_bytes_per_lane": lay.smem_lane_bytes,
            "lanes_per_block": sim_cuda.LANES_PER_BLOCK}


def s1_ptxas(case) -> Future:
    """Registers and spills of a simulator kernel's instantiations, from the
    source the build wrote (``build/repro_torch/<stem>_<hash>.cu``)."""
    return ptxas_rows(str(_build.build_dir() / f"{case['stem']}.cu"))


def s1_wide_check(case, device, lanes: int = WIDE_LANES) -> dict:
    """The design of ``case`` on ``lanes`` lanes (2,048 blocks at 65,536),
    against ``_TorchOps`` on the same card: arrays, returns, valid flags,
    conflict counts and traces.  A check no main path runs."""
    sim, cycles = case["sim"], case["cycles"]
    batch = rtl_stimulus(case["design"], lanes)
    kernel = sim.cuda_kernel()
    got = sim.run(batch, cycles, batched=True, trace=True, check_conflicts=False)
    plain = {}
    plain_ms = wall_ms(lambda: plain.update(res=plain_twin(sim).run(
        batch, cycles, batched=True, trace=True, check_conflicts=False)))
    name = f"rtl_sim[{case['design']},{case['hierarchy']},{lanes} lanes]"
    if not same_sim_result(got, plain["res"]):
        fail(f"{name}: the simulator kernel differs from its plain version")
    row = {"name": name, "route": "cuda", "source": "src/repro_torch/core/codegen/sim_cuda.py",
           "replaces": "src/repro/core/codegen/sim.py:797 (jit(scan(vmap(step))), "
                       "no TPU kernel)",
           "shape": {"design": case["design"], "hierarchy": case["hierarchy"], "size": "test",
                     "lanes": lanes},
           "launches": None, "tolerance": 0, "max_abs_err": 0, "plain_ms": plain_ms}
    row.update(s1_timing(kernel, sim, batch, lanes, cycles, device))
    return row


def phase_kernels_s1(cases, device) -> list[dict]:
    """Every simulator kernel at its main-path shape; a loop nest's large
    size is nested under its paper row (``large``).  The gemm and
    gemm_shared rows (inline) and the large rows carry their kernels'
    registers and spills; gemm's also a check on ``WIDE_LANES`` lanes."""
    rows, by_name = [], {}
    for case in cases:
        row = s1_case(case, device)
        if case["tag"] == "large" or (case["design"] in ("gemm", "gemm_shared")
                                      and case["hierarchy"] == "inline"):
            row["ptxas"] = s1_ptxas(case)
        if case["design"] == "gemm" and case["hierarchy"] == "inline":
            row["checks"] = [s1_wide_check(case, device)]
        by_name[(case["design"], case["tag"])] = row
        if case["tag"] == "large":
            by_name[(case["design"], "paper")]["large"] = row
        else:
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


def s1_gap(rows) -> dict:
    """launches x (ms - bound) summed over the simulator rows the main path
    ran, under the byte bound at each word's size and at 8 bytes a word; and
    with ``device_ms`` in place of ``ms`` (the launches' host time left out)."""
    ran = [r for row in rows for r in (row, row.get("large")) if r and r["launches"]]
    out = {"rows": len(ran), "launches": sum(r["launches"] for r in ran)}
    for name, t in (("ms", "ms"), ("device_ms", "device_ms")):
        if all(r[t] is not None for r in ran):
            out[name] = sum(r["launches"] * (r[t] - r["bound_ms"]) for r in ran)
            out[name + "_at_8_bytes_a_word"] = sum(
                r["launches"] * (r[t] - r["bound_ms_at_8_bytes_a_word"]) for r in ran)
    return out


def phase_differential(cases, device) -> dict:
    """The designer's check on the card, through the public entry points:
    ``run_differential`` on 4096 vectors for the reference's matrix (the
    kernel over the whole batch, the event-driven simulator on sample lanes,
    the design's oracle on every lane, every RTL pass on 16 lanes), once
    each; then each loop nest at both sizes through ``simulator_for`` with
    its final arrays held to ``lower_to_cuda`` on every lane.  Returns the
    launches of each case."""
    launches: dict[str, int] = {}
    matrix, nests = [], []
    for case in cases:
        dname, entry, module, batch = case["design"], case["entry"], case["module"], case["batch"]
        before = sim_cuda.launches
        if case["tag"] == "matrix":
            oracle, nargs = RTL_MATRIX[dname][3]
            t0 = time.perf_counter()
            rep = rtl_sim.run_differential(module, entry, batch, kernel=dname,
                                           hierarchy=case["hierarchy"], oracle=oracle,
                                           oracle_nargs=nargs, device=device)
            secs = time.perf_counter() - t0
            if not rep.ok or rep.backend != "cuda" or rep.n_vectors != LANES:
                fail(f"{case['name']}: run_differential {rep.backend}: {rep.mismatches[:4]}")
            if (oracle is not None and rep.oracle_ok is not True) or not (
                    rep.passes_ok and all(rep.passes_ok.values())):
                fail(f"{case['name']}: oracle_ok {rep.oracle_ok}, passes_ok {rep.passes_ok}")
            if dname == "mac":          # the oracle leg of the reference's mac test
                sim, prepared = rtl_sim.simulator_for(module, entry,
                                                      hierarchy=case["hierarchy"], device=device)
                res = sim.run(batch, case["cycles"], batched=True)
                want = np.array([mac.oracle(int(a), int(b), int(c)) for a, b, c in zip(*batch)])
                if not (np.all(res.returns_valid[0] == 1) and np.array_equal(res.returns[0], want)):
                    fail(f"{case['name']}: returns differ from mac.oracle")
            matrix.append({"design": dname, "hierarchy": case["hierarchy"], "ok": rep.ok,
                           "vectors": rep.n_vectors, "cycles": rep.cycles,
                           "event_lanes": rep.event_lanes_checked, "oracle_ok": rep.oracle_ok,
                           "passes_ok": rep.passes_ok,
                           "seconds_to_result": secs,
                           "nvcc_s": _build.build_seconds.get(case["stem"], 0.0)})
        else:
            t0 = time.perf_counter()
            sim, prepared = rtl_sim.simulator_for(module, entry, device=device)
            cycles = drained_cycles(prepared, entry, [c[0] for c in batch])
            res = sim.run(batch, cycles, batched=True)
            out = module.get(entry).args[-1].name
            k1 = as_i64(case["k1"](*batch[:n_read_ports(module, entry)])[out])
            secs = time.perf_counter() - t0
            lanes_equal = int(sum(np.array_equal(res.arrays[len(batch) - 1][s], k1[s])
                                  for s in range(LANES)))
            if lanes_equal != LANES:
                fail(f"{case['name']}: {LANES - lanes_equal} lanes differ from lower_to_cuda")
            nests.append({"design": dname, "size": case["size"] or "default", "lanes": LANES,
                          "cycles": cycles, "lanes_equal_to_lower_to_cuda": lanes_equal,
                          "seconds_to_result": secs})
        launches[case["name"]] = sim_cuda.launches - before
    emit("differential", {"matrix": matrix, "loop_nests": nests})
    return launches


# -- attention kernels ------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def check_close(what: str, got, want, dtype, tol=None) -> float:
    """max |got - want|; fails unless every element is within the reference
    tests' tolerance, atol + rtol * |want| (``tol``, else ``_tol`` of dtype)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = ATTN_TOL[dtype] if tol is None else tol
    if got.shape != want.shape or not bool((diff <= tol + tol * w.abs()).all()):
        fail(f"{what}: max |difference| {float(diff.max())} outside {tol} + {tol} * |plain|")
    return float(diff.max())


def bound(flops: float, nbytes: float, dtype, rate=None, sfu: float = 0.0) -> tuple[float, str]:
    """(ms, what bounds it): the largest of the operations at ``rate`` (the
    dtype's peak unless given), the bytes at the memory's rate and ``sfu``
    special-function operations (exp, tanh) at the MUFU's rate."""
    times = {"operations": flops / (rate or PEAK_FLOPS[dtype]),
             "bytes": nbytes / HBM_BYTES_PER_S, "special functions": sfu / SFU_OPS_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def limit_share(got, want, tol: float) -> float:
    """The largest |got - want| / (tol + tol |want|): an error's share of its limit."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (tol + tol * w.abs())).max())


def capped_name(softcap) -> str:
    return f" softcap {softcap:g}" if softcap is not None else ""


def sees_the_cap(name: str, share: float) -> float:
    """Fail unless the uncapped kernel lands outside the capped row's limit
    (``share`` > 1): else the row could not tell a dropped cap."""
    if not share > 1.0:
        fail(f"{name}: the uncapped kernel is within the capped row's limit "
             f"(share {share}), so the row cannot see the cap")
    return share


def row_max_over_cap(q, k, valid, scale, softcap) -> float:
    """The median over query rows (q (B,H,Sq,D), k (B,KvH,Sk,D)) of the
    largest scaled score that ``valid`` (broadcast to (B,H,Sq,Sk)) lets
    through, over the cap."""
    kk = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = (q.float() @ kk.float().transpose(-1, -2)) * scale
    top = s.masked_fill_(~valid, float("-inf")).amax(-1)
    return float(top[top > float("-inf")].median()) / softcap


# one PyTorch call cannot compute a capped softmax (SDPA takes no cap; a score
# modifier needs flex_attention, which is torch.compile)
NO_CAPPED_LIBRARY = ("none: no single PyTorch call caps the scores "
                     "(flex_attention needs torch.compile)")


def seeded(shape, dtype, device, g) -> torch.Tensor:
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


def k3_case(case: str, B, Sq, Sk, H, KvH, D, dtype, device, g, *, window=None,
            kv_len=None, Dv=None, causal=True, scale=None, q_scale=1.0, softcap=None) -> dict:
    """The flash-attention kernel (causal unless told otherwise; values of
    ``Dv`` head dims where given, under ``scale``; queries ``q_scale`` times
    normal; the scores capped at ``softcap`` where given) against its plain
    version and against SDPA on the same (B,H,S,D) views of model-layout
    tensors.  Where SDPA refuses the call, and under a cap, ``library_ms`` is
    null with the reason.  A capped row's bound counts an exp and a tanh a
    visible pair on the special-function unit, and the uncapped kernel must
    land outside its limit (``sees_the_cap``)."""
    Dv = Dv or D
    q = (seeded((B, Sq, H, D), dtype, device, g) * q_scale).transpose(1, 2)
    k = seeded((B, Sk, KvH, D), dtype, device, g).transpose(1, 2)
    v = seeded((B, Sk, KvH, Dv), dtype, device, g).transpose(1, 2)
    kwargs = dict(causal=causal, window=window, kv_len=kv_len, scale=scale, softcap=softcap)
    got = fa.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, **kwargs)
    dims = f"D{D}" if Dv == D else f"Dqk{D}/Dv{Dv}"
    name = (f"flash_attention[{case} {B}x{Sq}x{Sk} H{H}/{KvH} {dims} {dtype_name(dtype)}"
            f"{'' if causal else ' non-causal'}{capped_name(softcap)}]")
    err = check_close(name, got, want, dtype)
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    valid = (k_pos < (kv_len or Sk)) & (q_pos >= 0)      # (Sq, Sk)
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window is not None:
        valid &= k_pos > q_pos - window
    if softcap is not None:
        library, library_note = None, NO_CAPPED_LIBRARY
    elif window is None and kv_len is None:
        library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                         enable_gqa=True, scale=scale)
    else:
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=valid,
                                                         enable_gqa=True, scale=scale)
    try:
        if library:
            check_close(f"{name}: the library call", library(), want, dtype)
            library_note = None
    except RuntimeError as e:                     # no backend takes the call
        library, library_note = None, f"refused: {str(e).splitlines()[0][:160]}"
    es = q.element_size()
    pairs = int(valid.sum())                      # (query, key) pairs this mask lets through
    flops = 2.0 * B * H * pairs * (D + Dv)        # Q K^T over D, P V over Dv: a multiply-add each
    nbytes = (B * H * Sq * (D + Dv) + B * KvH * (kv_len or Sk) * (D + Dv)) * es
    bound_ms, bound_by = bound(flops, nbytes, dtype,
                               sfu=2.0 * B * H * pairs if softcap is not None else 0.0)
    kernel = lambda: fa.flash_attention(q, k, v, **kwargs)
    row = {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96", "kernel": fa.KERNEL[dtype],
        "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KvH": KvH, "D": D, "Dv": Dv,
                  "dtype": dtype_name(dtype), "causal": causal, "window": window,
                  "kv_len": kv_len, "scale": scale, "q_scale": q_scale, "softcap": softcap},
        "launches": None, "max_abs_err": err, "tolerance": f"{ATTN_TOL[dtype]} + {ATTN_TOL[dtype]}*|plain|",
        "err_share_of_limit": limit_share(got, want, ATTN_TOL[dtype]),
        "rms_plain": float(want.float().square().mean().sqrt()),
        "ms": time_ms(kernel, 20),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kwargs), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(library, 20) if library else None,
    }
    if library:
        row.update(device_times(kernel, library))
    else:
        row.update({"library_note": library_note, "device_ms": graph_ms(kernel)[0]})
    if softcap is not None:
        uncapped = lambda: fa.flash_attention(q, k, v, **dict(kwargs, softcap=None))
        row["uncapped_err_share_of_limit"] = sees_the_cap(
            name, limit_share(uncapped(), want, ATTN_TOL[dtype]))
        row["uncapped_device_ms"] = graph_ms(uncapped)[0]
        row["median_row_max_score_over_cap"] = row_max_over_cap(
            q, k, valid, D ** -0.5 if scale is None else scale, softcap)
    return row


def phase_kernels_k3(device) -> list[dict]:
    """K3 at the two shapes the main paths run it at (the prefill, the
    consistency check), then checks that no main path counts (their rows
    carry ``launches: null``): the prefill shape in float32, where the
    tolerance is tight enough to see a dropped tile, a ragged, a windowed MQA
    and a head dim 128 case."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    a = get_config(ARCH).attn
    H, KvH, D = a.n_heads, a.n_kv_heads, a.d_head
    rows = [k3_case("prefill", PREFILL_B, PREFILL_S, PREFILL_S, H, KvH, D, BF16, device, g),
            k3_case("consistency", CONSIST_B, CONSIST_S, CONSIST_S, H, KvH, D, BF16, device, g)]
    rows[0]["checks"] = [
        k3_case("prefill float32", PREFILL_B, PREFILL_S, PREFILL_S, H, KvH, D, F32, device, g),
        k3_case("ragged", 4, 1000, 1024, H, KvH, D, BF16, device, g, kv_len=1000),
        k3_case("window", 4, 1024, 1024, H, 1, D, BF16, device, g, window=256),
        k3_case("float32", 2, 512, 512, H, KvH, 128, F32, device, g),
        k3_case("C4: head dim 80, padded to 128", 2, 512, 512, H, KvH, 80, BF16, device, g),
    ]
    return rows


def k4_case(case: str, B, L, H, KvH, D, dtype, lengths, device, g, q_scale=1.0,
            softcap=None) -> dict:
    """The decode-attention kernel against its plain version and against SDPA
    with a boolean mask (none under a cap), on one query token per lane
    (``q_scale`` times normal; the scores capped at ``softcap`` where
    given, and then the uncapped kernel must land outside the limit)."""
    q = seeded((B, H, D), dtype, device, g) * q_scale
    k, v = (seeded((B, L, KvH, D), dtype, device, g) for _ in range(2))
    n = torch.tensor(lengths, dtype=torch.int32, device=device) if isinstance(lengths, list) \
        else lengths
    got = ops.decode(q, k, v, n, softcap=softcap)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, k, v, n, softcap=softcap)
    per_lane = torch.broadcast_to(torch.as_tensor(n, device=device), (B,))
    name = (f"decode_attention[{case} {B}x{L} H{H}/{KvH} D{D} {dtype_name(dtype)}"
            f"{capped_name(softcap)}]")
    err = check_close(name, got, want, dtype)
    mask = (torch.arange(L, device=device)[None, :] < per_lane[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    library = None
    if softcap is None:
        library = lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask,
                                                         enable_gqa=True)[:, :, 0]
        check_close(f"{name}: the library call", library(), want, dtype)
    rows_read = int(per_lane.clamp(max=L).sum())  # cache rows the lanes attend to
    es = q.element_size()
    bound_ms, bound_by = bound(4.0 * H * D * rows_read,
                               (2 * B * H * D + 2 * rows_read * KvH * D) * es, dtype,
                               sfu=2.0 * H * rows_read if softcap is not None else 0.0)
    kernel = lambda: ops.decode(q, k, v, n, softcap=softcap)
    groups = B * dec.groups(H, KvH)
    chunk, n_chunks = dec.split(L, groups, D, torch.cuda.get_device_properties(device)
                                .multi_processor_count)
    capped = {}
    if softcap is not None:
        capped = {
            "uncapped_err_share_of_limit": sees_the_cap(
                name, limit_share(ops.decode(q, k, v, n), want, ATTN_TOL[dtype])),
            "median_row_max_score_over_cap": row_max_over_cap(
                q[:, :, None], k.transpose(1, 2), mask, D ** -0.5, softcap)}
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:73", "kernel": dec.KERNEL[dtype],
        "shape": {"B": B, "L": L, "H": H, "KvH": KvH, "D": D, "dtype": dtype_name(dtype),
                  "length": lengths, "q_scale": q_scale, "softcap": softcap},
        "split": {"chunk": chunk, "chunks": n_chunks, "blocks": n_chunks * groups},
        "launches": None, "max_abs_err": err, "tolerance": f"{ATTN_TOL[dtype]} + {ATTN_TOL[dtype]}*|plain|",
        "err_share_of_limit": limit_share(got, want, ATTN_TOL[dtype]),
        "rms_plain": float(want.float().square().mean().sqrt()),
        "ms": time_ms(kernel, 50),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, n, softcap=softcap), 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(library, 50) if library else None,
        **(device_times(kernel, library) if library else
           {"device_ms": graph_ms(kernel)[0], "library_note": NO_CAPPED_LIBRARY,
            "uncapped_device_ms": graph_ms(lambda: ops.decode(q, k, v, n))[0]}),
        **capped,
    }


def partial_merge_check(device, g, softcap=None) -> dict:
    """``decode_partial`` equals its plain version (``normalize=False``) in
    float32, and over 4 sequence shards, merged by ``merge_partials``, equals
    the full decode to 1e-5 (under the cap ``softcap`` where given, the
    queries then 4 times normal)."""
    B, L, S = SLOTS, MAX_LEN, 4
    a = get_config(ARCH).attn
    q = seeded((B, a.n_heads, a.d_head), F32, device, g) * (1.0 if softcap is None else 4.0)
    k, v = (seeded((B, L, a.n_kv_heads, a.d_head), F32, device, g) for _ in range(2))
    n = torch.tensor([1, 100, 513, 1024], dtype=torch.int32, device=device)
    cap = dict(softcap=softcap)
    plain_err = max(check_close(f"decode_partial {B}x{L} float32: {what}", got, want, F32)
                    for what, got, want in zip(("acc", "m", "l"),
                                               ops.decode_partial(q, k, v, n, **cap),
                                               ref.decode_attention_ref(q, k, v, n,
                                                                        normalize=False, **cap)))
    full = ops.decode(q, k, v, n, **cap)
    w = L // S
    parts = [ops.decode_partial(q, k[:, s * w:(s + 1) * w], v[:, s * w:(s + 1) * w],
                                (n - s * w).clamp(0, w), **cap) for s in range(S)]
    merged = ops.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    err = float((merged - full).abs().max())
    if not err <= 1e-5:
        fail(f"decode_partial over {S} shards merged differs from the full decode by {err}")
    return {"case": f"decode_partial vs plain, and x{S} shards + merge_partials, "
                    f"{B}x{L} float32{capped_name(softcap)}",
            "max_abs_err_vs_plain": plain_err, "tolerance_vs_plain": "2e-05 + 2e-05*|plain|",
            "max_abs_err": err, "tolerance": 1e-5}


NO_PARTIAL_LIBRARY = ("none: no single PyTorch call returns a softmax's unnormalised "
                      "partial with its row maximum and sum")


def k4_partial_case(case: str, B, L, H, KvH, D, dtype, lengths, device, g) -> dict:
    """K4 with ``normalize=False`` (``ops.decode_partial``: the sequence-
    sharded decode's partial, the accumulator unnormalised in the inputs'
    dtype and (m, l) in float32) against its plain version, each output
    within the dtype's tolerance."""
    q = seeded((B, H, D), dtype, device, g)
    k, v = (seeded((B, L, KvH, D), dtype, device, g) for _ in range(2))
    n = torch.tensor(lengths, dtype=torch.int32, device=device)
    name = f"decode_attention[{case} partial {B}x{L} H{H}/{KvH} D{D} {dtype_name(dtype)}]"
    got = ops.decode_partial(q, k, v, n)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, k, v, n, normalize=False)
    errs = {what: check_close(f"{name}: {what}", a, b, dtype)
            for what, a, b in zip(("acc", "m", "l"), got, want)}
    rows_read = int(n.clamp(max=L).sum())
    es = q.element_size()
    bound_ms, bound_by = bound(4.0 * H * D * rows_read,
                               (2 * B * H * D + 2 * rows_read * KvH * D) * es + 8 * B * H, dtype)
    kernel = lambda: ops.decode_partial(q, k, v, n)
    groups = B * dec.groups(H, KvH)
    chunk, n_chunks = dec.split(L, groups, D, torch.cuda.get_device_properties(device)
                                .multi_processor_count)
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:73", "kernel": dec.KERNEL[dtype],
        "shape": {"B": B, "L": L, "H": H, "KvH": KvH, "D": D, "dtype": dtype_name(dtype),
                  "length": lengths, "softcap": None, "normalize": False},
        "split": {"chunk": chunk, "chunks": n_chunks, "blocks": n_chunks * groups},
        "launches": None, "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
        "tolerance": f"{ATTN_TOL[dtype]} + {ATTN_TOL[dtype]}*|plain| each output",
        "ms": time_ms(kernel, 50),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, n, normalize=False), 20),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library_note": NO_PARTIAL_LIBRARY, "device_ms": graph_ms(kernel)[0],
    }


def phase_kernels_k4(device) -> list[dict]:
    """K4 at the two shapes the main paths run it at (serving with a length
    per lane, the consistency check), then checks that no main path counts
    (``launches: null``): the serving shape in float32, where the tolerance is
    tight enough to see a dropped chunk, one scalar length, and the partials
    against their plain version and merged across sequence shards."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    a = get_config(ARCH).attn
    H, KvH, D = a.n_heads, a.n_kv_heads, a.d_head
    lanes = [1, 100, 513, 1024]
    rows = [k4_case("serve", SLOTS, MAX_LEN, H, KvH, D, BF16, lanes, device, g),
            k4_case("consistency", CONSIST_B, CONSIST_S, H, KvH, D, BF16,
                    [CONSIST_S] * CONSIST_B, device, g)]
    rows[0]["checks"] = [k4_case("serve float32", SLOTS, MAX_LEN, H, KvH, D, F32, lanes, device, g),
                         k4_case("scalar length", SLOTS, MAX_LEN, H, KvH, D, BF16, 700, device, g),
                         k4_case("C4: 32 query heads a KV head", SLOTS, MAX_LEN, 32, 1, D, BF16,
                                 lanes, device, g),
                         partial_merge_check(device, g)]
    return rows


def phase_kernels_d256(device) -> tuple[list[dict], list[dict]]:
    """K3 and K4 at RecurrentGemma's head dim 256 (16 query heads over one KV
    head): K3 at its 2 x 4096 prefill under the window of 2048 and at the
    cut consistency check (window 64, float32), K4 at its serving cache and
    at the consistency check's ring of 64 slots; the prefill shape in
    float32 and K4 in float32 as checks."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    a = get_config(RGEMMA).attn
    H, KvH, D, w = a.n_heads, a.n_kv_heads, a.d_head, a.window
    (B, S), (cb, cs) = PREFILL[RGEMMA], CONSIST[RGEMMA]
    k3 = [k3_case("prefill", B, S, S, H, KvH, D, BF16, device, g, window=w),
          k3_case("consistency", cb, cs, cs, H, KvH, D, F32, device, g, window=RG_CUT_WINDOW)]
    k3[0]["checks"] = [k3_case("prefill float32", B, S, S, H, KvH, D, F32, device, g, window=w)]
    lanes = [1, 100, 513, 1024]
    k4 = [k4_case("serve", SLOTS, MAX_LEN, H, KvH, D, BF16, lanes, device, g),
          k4_case("consistency", cb, RG_CUT_WINDOW, H, KvH, D, F32, [RG_CUT_WINDOW] * cb,
                  device, g)]
    k4[0]["checks"] = [k4_case("serve float32", SLOTS, MAX_LEN, H, KvH, D, F32, lanes, device, g)]
    return k3, k4


def phase_kernels_moe(device) -> tuple[list[dict], list[dict]]:
    """K3 and K4 at qwen2-moe's head dim 128 with one query head a KV head
    (16/16): K3 at its 4 x 1024 prefill and at the consistency check (2 x
    64), K4 at its serving cache and at the consistency check; the prefill
    and serving shapes in float32 as checks."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    a = get_config(MOE).attn
    H, KvH, D = a.n_heads, a.n_kv_heads, a.d_head
    (B, S), (cb, cs) = PREFILL[MOE], CONSIST[MOE]
    k3 = [k3_case("prefill", B, S, S, H, KvH, D, BF16, device, g),
          k3_case("consistency", cb, cs, cs, H, KvH, D, BF16, device, g)]
    k3[0]["checks"] = [k3_case("prefill float32", B, S, S, H, KvH, D, F32, device, g)]
    lanes = [1, 100, 513, 1024]
    k4 = [k4_case("serve", SLOTS, MAX_LEN, H, KvH, D, BF16, lanes, device, g),
          k4_case("consistency", cb, cs, H, KvH, D, BF16, [cs] * cb, device, g)]
    k4[0]["checks"] = [k4_case("serve float32", SLOTS, MAX_LEN, H, KvH, D, F32, lanes, device, g)]
    return k3, k4


def phase_kernels_mla(device) -> list[dict]:
    """K3 as deepseek-v2-lite's MLA prefill runs it: 16 heads, queries and
    keys of nope 128 + rope 64 = 192 dims against values of 128, causal,
    under the scale 192^-0.5, on the ``<192, 128>`` instantiation: at its
    4 x 1024 prefill and at the cut consistency check (2 x 64); the prefill
    shape in float32 (padded to 256) as a check."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    a = get_config(DEEPSEEK).attn
    H, Dqk, Dv = a.n_heads, a.nope_head_dim + a.rope_head_dim, a.v_head_dim
    mla_dims = dict(Dv=Dv, scale=Dqk ** -0.5, q_scale=PEAKED_Q)
    (B, S), (cb, cs) = PREFILL[DEEPSEEK], CONSIST[DEEPSEEK]
    rows = [k3_case("MLA prefill", B, S, S, H, H, Dqk, BF16, device, g, **mla_dims),
            k3_case("MLA consistency", cb, cs, cs, H, H, Dqk, BF16, device, g, **mla_dims)]
    rows[0]["checks"] = [k3_case("MLA prefill float32", B, S, S, H, H, Dqk, F32, device, g,
                                 **mla_dims)]
    return rows


def phase_kernels_cross(device) -> dict:
    """K3 and K4 at the shapes of the two cross-attention models, bfloat16,
    each with a float32 check.  seamless-m4t (16/16 heads of 64): K3 causal
    over the decoder's 4 x 1024 prefill, and non-causal 1024 against 1024
    (the encoder over 1024 audio frames, and cross-attention from the 1024
    tokens to them: one shape); K4 over the decoder's cache with a length
    per lane, and over the memory (cross decode, length 1024).
    llama-3.2-vision (64/8 heads of 128): K3 causal over its 4 x 1024
    prefill and non-causal from 1024 tokens to 1600 patches (off the key
    tile); K4 over its cache and over the 1600 patches.  Queries are
    ``PEAKED_Q`` times normal throughout."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 10)
    lanes = [1, 100, 513, 1024]
    sharp = dict(q_scale=PEAKED_Q)
    out = {}
    for arch in CROSS_ARCHS:
        cfg = get_config(arch)
        a = cfg.attn
        H, KvH, D, Tm = a.n_heads, a.n_kv_heads, a.d_head, cfg.frontend_tokens
        B, S = PREFILL[arch]
        cross = f"{arch} {'encoder and ' if cfg.encoder_segments else ''}cross prefill"
        k3 = [k3_case(f"{arch} prefill", B, S, S, H, KvH, D, BF16, device, g, **sharp),
              k3_case(cross, B, S, Tm, H, KvH, D, BF16, device, g, causal=False, **sharp)]
        k3[0]["checks"] = [k3_case(f"{arch} prefill float32", B, S, S, H, KvH, D, F32, device, g,
                                   **sharp)]
        k3[1]["checks"] = [k3_case(f"{cross} float32", B, S, Tm, H, KvH, D, F32, device, g,
                                   causal=False, **sharp)]
        k4 = [k4_case(f"{arch} serve", SLOTS, MAX_LEN, H, KvH, D, BF16, lanes, device, g,
                      **sharp),
              k4_case(f"{arch} cross decode", SLOTS, Tm, H, KvH, D, BF16, Tm, device, g, **sharp)]
        k4[1]["checks"] = [k4_case(f"{arch} cross decode float32", SLOTS, Tm, H, KvH, D, F32, Tm,
                                   device, g, **sharp)]
        out[arch] = (k3, k4)
    return out


def ssd_flops(B, S, H, P, N, Q) -> float:
    """Operations the SSD scan's result needs, chunk by chunk (q positions,
    p = q (q + 1) / 2 causal pairs): C B^T over the pairs once per (lane,
    chunk), since B and C are shared by the heads; per head the pairs'
    decay weights and their product with x, C h in every chunk after the
    first (h enters the first as zero), and the state update in every chunk
    before the last (the last state is not an output).  Element-wise terms
    of q P or fewer operations per head are left out, so the count stays a
    lower bound."""
    starts = list(range(0, S, Q))
    total = 0.0
    for i, c0 in enumerate(starts):
        q = min(Q, S - c0)
        pairs = q * (q + 1) / 2
        per_head = pairs * (1 + 2.0 * P)
        if i > 0:
            per_head += 2.0 * q * N * P                     # C h
        if i < len(starts) - 1:
            per_head += 2.0 * q * N * P + N * P             # B^T x weighted, decay of h
        total += B * (2.0 * pairs * N + H * per_head)
    return total


def k5_case(case: str, B, S, H, P, N, Q, device, g, rates=(0.01, 0.5)) -> dict:
    """The SSD scan kernel against its plain version, the recurrence one
    position at a time, run in float64 on the same inputs: normal x, B, C
    and decay logs uniform in [-rates[1], -rates[0]] — the reference test's
    [-0.5, -0.01] unless a case asks for slower decays."""
    lo, hi = rates
    x = seeded((B, S, H, P), F32, device, g)
    dA = -(torch.rand((B, S, H), generator=g) * (hi - lo) + lo).to(device)
    Bc, Cc = (seeded((B, S, N), F32, device, g) for _ in range(2))
    before = ssd_k.launches
    got = ops.ssd_scan(x, dA, Bc, Cc, chunk=Q)
    torch.cuda.synchronize()
    if ssd_k.launches != before + 1:
        fail(f"ssd_scan counted {ssd_k.launches - before} launches for one call")
    want, _ = ref.ssd_scan_ref(*(t.double() for t in (x, dA, Bc, Cc)))
    name = f"ssd_scan[{case} {B}x{S} H{H} P{P} N{N} Q{Q} float32]"
    err = check_close(name, got, want, F32, SCAN_TOL)
    diff = (got.double() - want).abs()
    nbytes = (2 * B * S * H * P + B * S * H + 2 * B * S * N) * 4
    flops = ssd_flops(B, S, H, P, N, min(Q, S))
    bound_ms, bound_by = bound(flops, nbytes, F32, TF32X3_FLOPS)
    kernel = lambda: ops.ssd_scan(x, dA, Bc, Cc, chunk=Q)
    device_ms, why = graph_ms(kernel)
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:71",
        "shape": {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q, "dtype": "float32",
                  "decay_logs": [-hi, -lo]},
        "launches": None,
        "max_abs_err": err, "max_abs_y": float(want.abs().max()),
        "worst_over_tolerance": float((diff / (SCAN_TOL + SCAN_TOL * want.abs())).max()),
        "tolerance": f"{SCAN_TOL} + {SCAN_TOL}*|plain| (plain in float64)",
        "ms": time_ms(kernel, 10),
        "device_ms": device_ms, **({"device_ms_note": why} if why else {}),
        **stage_profile(kernel),
        "plain_ms": time_ms(lambda: ref.ssd_scan_ref(x, dA, Bc, Cc), 1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,                    # no one PyTorch call computes the scan
    }


def stage_profile(fn, stages=ssd_k.STAGES, calls: int = 5) -> dict:
    """K5's kernels (or ``stages``) as ``torch.profiler`` traces ``calls`` calls: each
    kernel's device time and launches a call, and the launches a call in all
    (``cuda_launches_per_call``).  The traced calls follow a step of as many
    calls that the profiler runs and discards (its warm-up), since the first
    kernels after tracing starts may be missed.  A kernel the calls did not
    launch is left out of the times, and every number is ``not measured``
    where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    times = {stage: 0.0 for stage in stages}
    counts = {stage: 0 for stage in stages}
    for e in prof.key_averages():
        for stage in stages:
            if stage in e.key and e.self_device_time_total > 0:
                times[stage] += e.self_device_time_total / calls / 1e3
                counts[stage] += e.count
    if not any(counts.values()):
        return {"stage_device_ms": "not measured", "stage_launches_per_call": "not measured",
                "cuda_launches_per_call": "not measured"}
    return {"stage_device_ms": {k: v for k, v in times.items() if counts[k]},
            "stage_launches_per_call": {k: n / calls for k, n in counts.items()},
            "cuda_launches_per_call": sum(counts.values()) / calls}


# ptxas_usage compiles its source once more: those compiles run in threads
# beside the phases, and each row's result is waited for at the end (resolved)
PTXAS_POOL = ThreadPoolExecutor(max_workers=3)


def ptxas_rows(source: str) -> Future:
    """Registers and spills of each kernel of a source (``tools/ptxas_usage.py``),
    on its way: ``resolved`` waits for it."""
    from tools.ptxas_usage import usage

    def rows():
        return [{"kernel": r["kernel"].split("(")[0].split("::")[-1],
                 "registers": r["registers"], "spill_stores": r["spill_stores"],
                 "spill_loads": r["spill_loads"]} for r in usage(source)]
    return PTXAS_POOL.submit(rows)


def resolved(tree):
    """``tree`` with every ``Future`` in it replaced by its result."""
    if isinstance(tree, Future):
        return tree.result()
    if isinstance(tree, dict):
        return {k: resolved(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [resolved(v) for v in tree]
    return tree


def ssd_model_core_check(device, g) -> dict:
    """The model's dispatch on the card — ``ops.ssd_scan`` on the
    dt-weighted inputs plus ``x * D`` — against the plain chunked core the
    CPU runs, at the reference's test_ssd_kernel_matches_model_core shape.
    (At Mamba-2's widths the float32 chunked core itself strays from the
    recurrence by more than the tolerance; the rows above hold K5 to the
    recurrence there, and the consistency check holds the model.)"""
    B, S, H, P, N, Q = 1, 64, 2, 16, 16, 16
    xh = seeded((B, S, H, P), F32, device, g)
    dt = F.softplus(seeded((B, S, H), F32, device, g))
    A = -torch.exp(seeded((H,), F32, device, g) * 0.2)
    Bc, Cc = (seeded((B, S, N), F32, device, g) for _ in range(2))
    D = seeded((H,), F32, device, g)
    got = ops.ssd_scan(xh * dt[..., None], dt * A, Bc, Cc, chunk=Q)
    got = got + xh * D[None, None, :, None]
    want, _ = ssd.ssd_core_chunked(xh, dt, A, Bc, Cc, D, Q)
    what = f"ops.ssd_scan + x*D against ssd_core_chunked, {B}x{S} H{H} P{P} N{N} Q{Q} float32"
    return {"case": what, "max_abs_err": check_close(what, got, want, F32, SCAN_TOL),
            "tolerance": f"{SCAN_TOL} + {SCAN_TOL}*|plain|"}


def phase_kernels_k5(device) -> list[dict]:
    """K5 at Mamba-2's prefill (4 x 2048, H 48, P 64, N 128, chunk 256) and
    at its consistency check (2 x 264: a ragged second chunk), then checks:
    a ragged S 2000, the prefill and the ragged S with slow decays, the
    reference test's three shapes, and the model's dispatch against its
    plain chunked core."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    cfg = get_config(MAMBA)
    _, H, P, N = ssd.dims(cfg)
    Q = cfg.ssd.chunk
    rows = [k5_case("prefill", *PREFILL[MAMBA], H, P, N, Q, device, g),
            k5_case("consistency", *CONSIST[MAMBA], H, P, N, Q, device, g)]
    per_call = rows[0]["cuda_launches_per_call"]
    if per_call != "not measured" and per_call != ssd_k.CUDA_LAUNCHES_PER_CALL:
        fail(f"{rows[0]['name']}: the trace counts {per_call} kernels a call, expected "
             f"{ssd_k.CUDA_LAUNCHES_PER_CALL} ({', '.join(ssd_k.STAGES)})")
    rows[0]["ptxas"] = ptxas_rows("ssd_scan.cu")
    slow = (0.001, 0.02)        # Mamba-2's dt of 1e-3..1e-1: every tile and the state count
    rows[0]["checks"] = [
        k5_case("ragged", PREFILL[MAMBA][0], 2000, H, P, N, Q, device, g),
        k5_case("prefill slow decays", *PREFILL[MAMBA], H, P, N, Q, device, g, rates=slow),
        k5_case("ragged slow decays", PREFILL[MAMBA][0], 2000, H, P, N, Q, device, g,
                rates=slow),
    ] + [
        k5_case("test_ssd_scan", 2, S, h, p, n, q, device, g)
        for S, h, p, n, q in [(64, 2, 16, 16, 16), (100, 1, 32, 16, 32), (128, 3, 8, 8, 128),
                              (77, 3, 24, 20, 8), (300, 2, 72, 12, 64)]
    ] + [ssd_model_core_check(device, g)]
    return rows


def k6_case(case: str, B, S, D, device, g) -> dict:
    """The RG-LRU scan kernel against its plain version (one step at a time),
    a uniform in [0.5, 0.999], b normal."""
    a = (torch.rand((B, S, D), generator=g) * 0.499 + 0.5).to(device)
    b = seeded((B, S, D), F32, device, g)
    got = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    want, _ = ref.rglru_scan_ref(a, b)
    name = f"rglru_scan[{case} {B}x{S}x{D} float32]"
    err = check_close(name, got, want, F32, SCAN_TOL)
    bound_ms, bound_by = bound(2.0 * B * S * D, 3 * B * S * D * 4, F32)
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:56",
        "shape": {"B": B, "S": S, "D": D, "dtype": "float32"},
        "launches": None, "max_abs_err": err, "tolerance": f"{SCAN_TOL} + {SCAN_TOL}*|plain|",
        "ms": time_ms(lambda: ops.rglru_scan(a, b), 20),
        "plain_ms": time_ms(lambda: ref.rglru_scan_ref(a, b), 1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,                    # no one PyTorch call computes the scan
    }


def phase_kernels_k6(device) -> list[dict]:
    """K6 at RecurrentGemma's prefill (2 x 4096, d_rnn 4096) and at its
    consistency check (2 x 160), then checks: ragged S 1000 and D 4000, the
    reference test's three shapes."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    D = get_config(RGEMMA).rglru.d_rnn
    rows = [k6_case("prefill", *PREFILL[RGEMMA], D, device, g),
            k6_case("consistency", *CONSIST[RGEMMA], D, device, g)]
    rows[0]["checks"] = [k6_case("ragged", 2, 1000, 4000, device, g)] + [
        k6_case("test_rglru_scan", 2, S, d, device, g) for S, d in [(64, 32), (100, 48), (128, 8)]]
    return rows


# -- the scans' backwards (S3, S4) ----------------------------------------------------


def ssd_bwd_flops(B, S, H, P, N, Q) -> float:
    """Operations of the SSD scan's gradients, chunk by chunk (q positions,
    p = q (q + 1) / 2 causal pairs).  Per head: dy x^T over the pairs and the
    pairs' weights times dy into dx (C B^T is the forward's, kept); in every
    chunk after the first the state gradient's increment (C o exp(cum))^T dy
    and exp(cum) dy h_c^T into dC, in every chunk before the last B G into dx
    and x G^T into dB.  Once per chunk, since B and C are shared by the
    heads: the pairs' weights summed over the heads (W) times C into dB and
    times B into dC.  Element-wise terms of q P or fewer operations per head
    are left out, so the count stays a lower bound."""
    starts = list(range(0, S, Q))
    total = 0.0
    for i, c0 in enumerate(starts):
        q = min(Q, S - c0)
        pairs = q * (q + 1) / 2
        per_head = pairs * (2.0 * P + 2.0 * P)
        per_head += 2.0 * q * N * P * (2 * (i > 0) + 2 * (i < len(starts) - 1))
        total += B * (H * per_head + pairs * 4.0 * N)
    return total


def s3_case(case: str, B, S, H, P, N, Q, device, g, rates=(0.001, 0.02)) -> dict:
    """S3 against its plain backward (the recurrence walked back one position
    at a time, in float64) on the same inputs: x, B, C and dy normal, decay
    logs uniform in [-rates[1], -rates[0]] (Mamba-2's slow decays unless a
    case asks otherwise), y and the scratch from K5's forward on the card.
    Each of dx, ddA, dB, dC within ``SCAN_TOL`` of its largest |plain|."""
    lo, hi = rates
    x = seeded((B, S, H, P), F32, device, g)
    dA = -(torch.rand((B, S, H), generator=g) * (hi - lo) + lo).to(device)
    Bc, Cc = (seeded((B, S, N), F32, device, g) for _ in range(2))
    dy = seeded((B, S, H, P), F32, device, g)
    xk, dAk, dyk = x.transpose(1, 2), dA.transpose(1, 2), dy.transpose(1, 2)
    y, scratch = ssd_k._forward(xk, dAk, Bc, Cc, Q)
    kernel = lambda: ssd_k.ssd_scan_bwd(xk, dAk, Bc, Cc, y, dyk, scratch, chunk=Q)
    before = ssd_k.bwd_launches
    got = kernel()
    torch.cuda.synchronize()
    if ssd_k.bwd_launches != before + 1:
        fail(f"ssd_scan_bwd counted {ssd_k.bwd_launches - before} launches for one call")
    want = ref.ssd_scan_bwd_ref(*(t.double() for t in (x, dA, Bc, Cc, dy)))
    name = f"ssd_scan_bwd[{case} {B}x{S} H{H} P{P} N{N} Q{Q} float32]"
    errs, plain = {}, {}
    model_layout = (got[0].transpose(1, 2), got[1].transpose(1, 2), got[2], got[3])
    for part, a, b in zip(("dx", "ddA", "dB", "dC"), model_layout, want):
        errs[part] = float((a.double() - b).abs().max())
        plain[part] = float(b.abs().max())
        limit = SCAN_TOL * plain[part]
        if a.shape != b.shape or not errs[part] <= limit:
            fail(f"{name}: {part} max |difference| {errs[part]} outside "
                 f"{SCAN_TOL} x max |plain| = {limit}")
    del want
    kept = sum(int(np.prod(shape)) for shape in ssd_k.scratch_shapes(B, H, S, P, N, Q).values())
    # x, y, dy, dx; dA, ddA; B, C, dB, dC; the forward's scratch, all float32
    nbytes = (4 * B * S * H * P + 2 * B * S * H + 4 * B * S * N + kept) * 4
    bound_ms, bound_by = bound(ssd_bwd_flops(B, S, H, P, N, min(Q, S)), nbytes, F32,
                               TF32X3_FLOPS)
    device_ms, why = graph_ms(kernel)
    profile = stage_profile(kernel, ssd_k.BWD_STAGES)
    row = {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssd.py:80 (no TPU kernel: XLA's autodiff of the jnp SSD "
                    "core under jax.value_and_grad)",
        "shape": {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q, "dtype": "float32",
                  "decay_logs": [-hi, -lo]},
        "launches": None, "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
        "max_abs_plain_by_output": plain,
        "err_over_limit_by_output": {k: errs[k] / (SCAN_TOL * plain[k]) for k in errs},
        "tolerance": f"{SCAN_TOL} * max|plain| per output (plain in float64)",
        "ms": time_ms(kernel, 5),
        "device_ms": device_ms, **({"device_ms_note": why} if why else {}),
        **profile,
        "plain_ms": time_ms(lambda: ref.ssd_scan_bwd_ref(x, dA, Bc, Cc, dy), 1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,                    # no one PyTorch call computes the gradients
    }
    del got, model_layout, scratch, y
    torch.cuda.empty_cache()
    return row


def phase_kernels_s3(device) -> list[dict]:
    """S3 at Mamba-2's training shape (4 x 2048, H 48, P 64, N 128, chunk
    256) with its slow decays, then checks: one chunk, two chunks, a ragged
    S, the training shape at the reference test's decay logs, and 1 x 8192
    (ddA sums dy.y - dx.x from the end of the sequence, so its error grows
    with S)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 12)
    cfg = get_config(MAMBA)
    _, H, P, N = ssd.dims(cfg)
    Q = cfg.ssd.chunk
    B, S = TRAIN_ARCH_SHAPE[MAMBA]
    rows = [s3_case("train", B, S, H, P, N, Q, device, g)]
    rows[0]["ptxas"] = ptxas_rows("ssd_scan_bwd.cu")
    rows[0]["checks"] = [s3_case("one chunk", B, 200, H, P, N, Q, device, g),
                         s3_case("two chunks", B, 512, H, P, N, Q, device, g),
                         s3_case("ragged", B, 2000, H, P, N, Q, device, g),
                         s3_case("train, fast decays", B, S, H, P, N, Q, device, g,
                                 rates=(0.01, 0.5)),
                         s3_case("long", 1, 8192, H, P, N, Q, device, g)]
    return rows


def s4_case(case: str, B, S, D, device, g) -> dict:
    """S4 against its plain backward in float64 on the kernel's own h: a
    uniform in [0.5, 0.999], b and dh normal; da and db within ``SCAN_TOL``
    of their largest |plain|."""
    a = (torch.rand((B, S, D), generator=g) * 0.499 + 0.5).to(device)
    b, dh = (seeded((B, S, D), F32, device, g) for _ in range(2))
    h = ops.rglru_scan(a, b)
    kernel = lambda: rg.rglru_scan_bwd(a, h, dh)
    before = rg.bwd_launches
    got = kernel()
    torch.cuda.synchronize()
    if rg.bwd_launches != before + 1:
        fail(f"rglru_scan_bwd counted {rg.bwd_launches - before} launches for one call")
    want = ref.rglru_scan_bwd_ref(a.double(), h.double(), dh.double())
    name = f"rglru_scan_bwd[{case} {B}x{S}x{D} float32]"
    errs, plain = {}, {}
    for part, x, w in zip(("da", "db"), got, want):
        errs[part] = float((x.double() - w).abs().max())
        plain[part] = float(w.abs().max())
        if not errs[part] <= SCAN_TOL * plain[part]:
            fail(f"{name}: {part} max |difference| {errs[part]} outside "
                 f"{SCAN_TOL} x max |plain|")
    bound_ms, bound_by = bound(3.0 * B * S * D, 5 * B * S * D * 4, F32)
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/models/rglru.py:94 (no TPU kernel: XLA's autodiff of the "
                    "reference's associative_scan)",
        "kernel": "rglru_bwd_kernel", "shape": {"B": B, "S": S, "D": D, "dtype": "float32"},
        "segment_steps": rg.BWD_SEGMENT,
        "launches": None, "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
        "max_abs_plain_by_output": plain,
        "err_over_limit_by_output": {k: errs[k] / (SCAN_TOL * plain[k]) for k in errs},
        "tolerance": f"{SCAN_TOL} * max|plain| per output (plain in float64)",
        "ms": time_ms(kernel, 20), "device_ms": graph_ms(kernel)[0],
        "plain_ms": time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, dh), 1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,                    # no one PyTorch call computes the gradients
    }


def phase_kernels_s4(device) -> list[dict]:
    """S4 at RecurrentGemma's training shape (2 x 2048, d_rnn 4096), then
    checks: its prefill's 2 x 4096, ragged S and D, one round."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 13)
    D = get_config(RGEMMA).rglru.d_rnn
    rows = [s4_case("train", *TRAIN_ARCH_SHAPE.get(RGEMMA, (2, 2048)), D, device, g)]
    rows[0]["checks"] = [s4_case("2 x 4096", *PREFILL[RGEMMA], D, device, g),
                         s4_case("ragged", 2, 1000, 4000, device, g),
                         s4_case("one round", 2, 100, 48, device, g)]
    rows[0]["ptxas"] = ptxas_rows("rglru_scan.cu")
    return rows


# -- the flash kernel's backward (S2) ------------------------------------------------


def s2_case(case: str, B, Sq, Sk, H, KvH, D, dtype, device, g, *, causal=True,
            window=None, Dv=None, softcap=None, q_scale=PEAKED_Q) -> dict:
    """S2 (``flash_attention_bwd``: three launches a call) against its plain
    version and against the backward of SDPA on the same inputs: q, k, v as
    (B,H,S,·) views of model-layout tensors, v of ``Dv`` head dims (D unless
    given), the queries ``q_scale`` times normal; o and lse from K3's
    forward; dO normal.  Under a cap (``softcap``) both the forward and the
    backward take it, there is no library call, the bound counts the exp
    and the tanh that the gradient needs a visible pair (S2's two passes
    form them twice: a cost of its design, not of the work), and the
    uncapped kernels must land outside the limit."""
    Dv = D if Dv is None else Dv
    q = (seeded((B, Sq, H, D), dtype, device, g) * q_scale).transpose(1, 2)
    k = seeded((B, Sk, KvH, D), dtype, device, g).transpose(1, 2)
    v = seeded((B, Sk, KvH, Dv), dtype, device, g).transpose(1, 2)
    do = seeded((B, Sq, H, Dv), dtype, device, g).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = fa._forward(q, k, v, causal, window, D ** -0.5, None, softcap, with_lse=True)
    route = fa.bwd_route(D, Dv, dtype)[0]
    got = fab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    name = (f"flash_attention_bwd[{case} {B}x{Sq}x{Sk} H{H}/{KvH} D{D}"
            f"{f' Dv{Dv}' if Dv != D else ''} {dtype_name(dtype)}"
            f"{'' if causal else ' non-causal'}{f' window {window}' if window else ''}"
            f"{capped_name(softcap)}]")

    plain_max = {p: float(w.float().abs().max()) for p, w in zip(("dq", "dk", "dv"), want)}

    def held(what: str, parts) -> dict:
        errs = {}
        for part, a, b in zip(("dq", "dk", "dv"), parts, want):
            errs[part] = float((a.float() - b.float()).abs().max())
            limit = BWD_TOL[dtype] * float(b.float().abs().max())
            if a.shape != b.shape or not errs[part] <= limit:
                fail(f"{what}: {part} max |difference| {errs[part]} outside "
                     f"{BWD_TOL[dtype]} x max |plain| = {limit}")
        return errs

    errs = held(name, got)
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    pairs = int(valid.sum())
    # five products over the pairs the masks leave, a multiply-add each: S, dK
    # and dQ of depth or width D, dP and dV of Dv; q, k, dq, dk of D and v, o,
    # dO, dv of Dv, and lse, read or written once
    flops = 2.0 * B * H * pairs * (3 * D + 2 * Dv)
    es = q.element_size()
    nbytes = ((2 * B * H * Sq + 2 * B * KvH * Sk) * D
              + (2 * B * H * Sq + 2 * B * KvH * Sk) * Dv) * es + 4 * B * H * Sq
    bound_ms, bound_by = bound(flops, nbytes, dtype,
                               sfu=2.0 * B * H * pairs if softcap is not None else 0.0)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    out = None
    try:
        if softcap is not None:
            raise RuntimeError(NO_CAPPED_LIBRARY)
        if window is None:
            out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
        else:
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=valid, enable_gqa=True)
        library = lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)
        held(f"{name}: the library call", library())
        library_note = None
    except RuntimeError as e:                     # no backend takes the call
        library, library_note = None, (NO_CAPPED_LIBRARY if softcap is not None else
                                       f"refused: {str(e).splitlines()[0][:160]}")
    if softcap is not None:
        o0, lse0 = fa._forward(q, k, v, causal, window, D ** -0.5, None, with_lse=True)
        uncapped = lambda: fab.flash_attention_bwd(q, k, v, o0, lse0, do,
                                                   **dict(kw, softcap=None))
        share = max(float((a.float() - b.float()).abs().max()) / (BWD_TOL[dtype] * plain_max[p])
                    for p, a, b in zip(("dq", "dk", "dv"), uncapped(), want))
        capped = {"uncapped_err_share_of_limit": sees_the_cap(name, share),
                  "median_row_max_score_over_cap": row_max_over_cap(q, k, valid, D ** -0.5,
                                                                    softcap)}
    del want
    torch.cuda.empty_cache()
    kernel = lambda: fab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    row = {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:63 (no TPU kernel: XLA's autodiff of the "
                    "plain flash_attention)",
        "kernel": "/".join(fa.BWD_KERNELS[route]), "kernel_route": route,
        "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KvH": KvH, "D": D, "Dv": Dv,
                  "dtype": dtype_name(dtype), "causal": causal, "window": window,
                  "q_scale": q_scale, "softcap": softcap},
        "launches": None, "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
        "err_share_of_limit": max(errs[p] / (BWD_TOL[dtype] * mx) for p, mx in plain_max.items()),
        "tolerance": f"{BWD_TOL[dtype]} * max|plain| per output",
        "ms": time_ms(kernel, 10),
        "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw), 1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(library, 10) if library else None,
        "device_ms": graph_ms(kernel)[0],
        # the library's backward runs through autograd, whose capture in a
        # CUDA graph is refused; a refused capture has left memory reserved
        "library_device_ms": None,
        "library_device_ms_note": "not measured: the library call is an autograd backward",
    }
    if library_note:
        row["library_note"] = library_note
    if softcap is not None:
        row.update(capped, uncapped_device_ms=graph_ms(uncapped)[0])
        del o0, lse0, uncapped
    del out, library
    torch.cuda.empty_cache()
    return row


def s2_shape_key(row: dict) -> tuple:
    """The ``by_shape`` key of the calls an S2 row stands for."""
    sh = row["shape"]
    return (sh["B"], sh["H"], sh["KvH"], sh["Sq"], sh["Sk"], sh["D"], sh["Dv"], sh["causal"],
            sh["softcap"])


def phase_kernels_s2(device) -> list[dict]:
    """S2 at the shapes the training paths run it at — tinyllama-1.1b's
    step in bfloat16, the example's TINYLM in float32, deepseek-v2-lite's
    MLA (192, 128) in bfloat16 — then checks no main path counts: head dims
    128 and 256 (the latter on the CUDA cores), groups 1 and 16, a window, a
    non-causal call with Sq != Sk, D != Dv in float32 (padded)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    a = get_config(ARCH).attn
    t = train_example().TINYLM.attn
    m = get_config(DEEPSEEK).attn
    dqk = m.nope_head_dim + m.rope_head_dim
    rows = [s2_case("train", TRAIN_B, TRAIN_S, TRAIN_S, a.n_heads, a.n_kv_heads, a.d_head,
                    BF16, device, g),
            s2_case("example", 4, 128, 128, t.n_heads, t.n_kv_heads, t.d_head, F32, device, g),
            s2_case("MLA train", MLA_GRAD_B, MLA_GRAD_S, MLA_GRAD_S, m.n_heads, m.n_kv_heads,
                    dqk, BF16, device, g, Dv=m.v_head_dim)]
    rows[0]["checks"] = [
        s2_case("D 128", 2, 512, 512, 16, 2, 128, BF16, device, g),
        s2_case("D 256, group 16", 2, 512, 512, 16, 1, 256, BF16, device, g),
        s2_case("group 1", 2, 512, 512, 16, 16, 64, BF16, device, g),
        s2_case("window", 2, 1024, 1024, 16, 2, 64, BF16, device, g, window=256),
        s2_case("non-causal", 2, 384, 640, 8, 2, 64, F32, device, g, causal=False),
        s2_case("D 80, padded to 128", 2, 2, 130, 4, 2, 80, BF16, device, g, causal=False),
        s2_case("D != Dv, padded to 64", 1, 64, 96, 4, 2, 48, F32, device, g, causal=False,
                Dv=32),
    ]
    return rows


def capped_pair_refusal(device) -> dict:
    """A capped call at MLA's (192, 128) in bfloat16 raises ``ValueError``
    in K3 and in S2 before any launch (no capped instantiation of the pair
    is built; the reference's MLA ignores the cap)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 13)
    q, k = (seeded((1, 16, 128, 192), BF16, device, g) for _ in range(2))
    v = seeded((1, 16, 128, 128), BF16, device, g)
    lse = torch.zeros((1, 16, 128), device=device)
    before = (fa.launches, fab.launches)
    said = []
    for call in (lambda: fa.flash_attention(q, k, v, softcap=SOFTCAP),
                 lambda: fab.flash_attention_bwd(q, k, v, v, lse, v, softcap=SOFTCAP)):
        try:
            call()
        except ValueError as e:
            said.append(str(e)[:120])
        else:
            fail("a capped call at (192, 128) in bfloat16 ran")
    if (fa.launches, fab.launches) != before:
        fail("a refused capped call at (192, 128) launched a kernel")
    return {"case": "capped (192, 128) bfloat16: K3 and S2 raise ValueError, no launch",
            "said": said}


def phase_kernels_softcap(device) -> tuple[list[dict], list[dict], list[dict]]:
    """K3, K4 and S2 under the cap (``SOFTCAP``) at the shapes the capped
    tinyllama's paths run them at: K3 in bfloat16 at its 4 x 1024 prefill
    and its 4 x 2048 gradient, in float32 at its consistency check; K4 in
    bfloat16 at its serving cache and in float32 at its consistency check
    (a length a lane); S2 on the tensor cores at its gradient's shape.  Then
    checks no main path counts (``launches: null``): K3 at RecurrentGemma's
    2 x 4096 prefill (head dim 256, 16/1, window 2048), the capped partials
    and their merge, S2 on the CUDA cores (head dim 256 and float32), the
    three bfloat16 routes (``tanh.approx``) with queries ``NEAR_CAP_Q`` times
    normal, and the refusal at (192, 128).  Queries ``PEAKED_Q`` times
    normal elsewhere, so that the cap bends the scores."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 12)
    a = get_config(ARCH).attn
    H, KvH, D = a.n_heads, a.n_kv_heads, a.d_head
    cap = dict(softcap=SOFTCAP, q_scale=PEAKED_Q)
    cap_b, cap_s = CONSIST[CAPPED]
    k3 = [k3_case("capped prefill", PREFILL_B, PREFILL_S, PREFILL_S, H, KvH, D, BF16, device, g,
                  **cap),
          k3_case("capped train", TRAIN_B, TRAIN_S, TRAIN_S, H, KvH, D, BF16, device, g, **cap),
          k3_case("capped consistency", cap_b, cap_s, cap_s, H, KvH, D, F32, device, g, **cap)]
    r = get_config(RGEMMA).attn
    (rb, rs) = PREFILL[RGEMMA]
    near = dict(softcap=SOFTCAP, q_scale=NEAR_CAP_Q)
    k3[0]["checks"] = [k3_case("capped RecurrentGemma prefill", rb, rs, rs, r.n_heads,
                               r.n_kv_heads, r.d_head, BF16, device, g, window=r.window, **cap),
                       k3_case("near the cap", 2, 1024, 1024, H, KvH, D, BF16, device, g, **near)]
    lanes = [1, 100, 513, 1024]
    k4 = [k4_case("capped serve", SLOTS, MAX_LEN, H, KvH, D, BF16, lanes, device, g, **cap),
          k4_case("capped consistency", cap_b, cap_s, H, KvH, D, F32, [cap_s] * cap_b, device,
                  g, **cap)]
    k4[0]["checks"] = [partial_merge_check(device, g, softcap=SOFTCAP),
                       k4_case("near the cap", SLOTS, MAX_LEN, H, KvH, D, BF16, lanes, device, g,
                               **near)]
    s2 = [s2_case("capped train", TRAIN_B, TRAIN_S, TRAIN_S, H, KvH, D, BF16, device, g,
                  softcap=SOFTCAP)]
    s2[0]["checks"] = [
        s2_case("capped D 256, group 16", 2, 512, 512, 16, 1, 256, BF16, device, g,
                softcap=SOFTCAP),
        s2_case("capped float32", 2, 512, 512, H, KvH, D, F32, device, g, softcap=SOFTCAP),
        s2_case("near the cap", 2, 1024, 1024, H, KvH, D, BF16, device, g, **near),
        capped_pair_refusal(device)]
    return k3, k4, s2


# -- serving ------------------------------------------------------------------------

# each kernel's launch counter: the module that counts it and the attribute
# (S3 and S4 count on the module of their forward)
KERNELS = {"lower_to_cuda": (to_cuda, "launches"), "matmul": (mm, "launches"),
           "flash_attention": (fa, "launches"), "flash_attention_bwd": (fab, "launches"),
           "decode_attention": (dec, "launches"), "ssd_scan": (ssd_k, "launches"),
           "ssd_scan_bwd": (ssd_k, "bwd_launches"), "rglru_scan": (rg, "launches"),
           "rglru_scan_bwd": (rg, "bwd_launches"), "rtl_sim": (sim_cuda, "launches")}


def zero_counts() -> None:
    for module, attr in KERNELS.values():
        setattr(module, attr, 0)
    fa.by_shape.clear()
    fab.by_shape.clear()
    dec.by_shape.clear()
    dec.partial_by_shape.clear()


def counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in KERNELS.items()}


def shape_counts() -> dict:
    """K3's and K4's launches by the shape of the call (their ``by_shape``)."""
    return {"flash_attention": dict(fa.by_shape), "decode_attention": dict(dec.by_shape)}


def shape_key(row: dict) -> tuple:
    """The ``by_shape`` key of the calls a K3 or K4 row stands for."""
    sh = row["shape"]
    if "Sq" in sh:
        return (sh["B"], sh["H"], sh["KvH"], sh["Sq"], sh["Sk"], sh["D"], sh["Dv"], sh["causal"],
                sh["softcap"])
    return (sh["B"], sh["H"], sh["KvH"], sh["L"], sh["D"], isinstance(sh["length"], list),
            sh["softcap"])


def printable(by_shape: dict) -> dict:
    return {" ".join(map(str, key)): n for key, n in by_shape.items()}


def layers(cfg) -> dict:
    """Blocks of the model that run each kernel: self-attention and
    cross-attention (K3 in a forward, K4 in a decode step), MLA (K3 in a
    forward; its latent decode is eager torch), the encoder's bidirectional
    attention (K3 each time the memory is made), SSD (K5 in a forward),
    RG-LRU (K6 in a forward)."""
    kinds = [k for s in cfg.segments for k in s.pattern * s.repeats]
    return {"attn": sum(k in ("attn", "local_attn") for k in kinds),
            "cross": kinds.count("cross_attn"), "mla": kinds.count("mla"),
            "enc": sum(len(s.pattern) * s.repeats for s in cfg.encoder_segments),
            "ssd": kinds.count("ssd"), "rglru": kinds.count("rglru")}


def decode_launches(cfg, calls: int) -> int:
    """K4 launches of ``calls`` decode steps: one a self- or cross-attention layer."""
    n = layers(cfg)
    return (n["attn"] + n["cross"]) * calls


def expect(what: str, n: dict, **want) -> None:
    """Fail unless the launch counts are ``want``, every other count 0."""
    full = {k: want.get(k, 0) for k in KERNELS}
    if n != full:
        fail(f"{what}: launches {n}, expected {full}")


def forward_launches(cfg, passes: int = 1) -> dict:
    n = layers(cfg)
    return {"flash_attention": passes * (n["attn"] + n["cross"] + n["mla"] + n["enc"]),
            "ssd_scan": passes * n["ssd"], "rglru_scan": passes * n["rglru"]}


def served_config(arch: str):
    """The arch's config as served: full width, cut in depth where it must
    be (``SERVE_CUT_REPEATS``); ``CAPPED`` is tinyllama's under the cap."""
    if arch == CAPPED:
        cfg = get_config(ARCH)
        return cfg.scaled(name=CAPPED, attn=dataclasses.replace(cfg.attn, logit_softcap=SOFTCAP))
    cfg = get_config(arch)
    if arch in SERVE_CUT_REPEATS:
        cfg = cfg.scaled(segments=tuple(Segment(s.pattern, SERVE_CUT_REPEATS[arch], s.ffn)
                                        for s in cfg.segments))
    return cfg


def sharpen(params) -> None:
    """Every attention block's query and key weights ``CAPPED_QK`` times
    larger, in place: the capped gradient check's, so that the cap bites."""
    with torch.no_grad():
        for seg in params["segments"]:
            for block in seg:
                for name in ("wq", "wk"):
                    if name in block["mixer"]:
                        block["mixer"][name].mul_(CAPPED_QK)


def open_gates(params, seed: int) -> None:
    """Every cross layer's tanh gates set, in place, to values drawn from
    ``seed`` in [0.3, 1.3) (a fresh model's are 0)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    for seg in params["segments"]:
        for block in seg:
            for name in ("gate_attn", "gate_ffn"):
                if name in block["mixer"]:
                    t = block["mixer"][name]
                    t.copy_(0.3 + torch.rand(t.shape, generator=g))


def frontend_batch(cfg, B: int, device, seed: int) -> dict:
    """Seeded, non-zero frontend embeddings (B, Tm, Fd), or nothing for a
    model without a frontend."""
    if cfg.frontend is None:
        return {}
    g = torch.Generator(device="cpu").manual_seed(seed)
    fe = torch.randn((B, cfg.frontend_tokens, cfg.frontend_dim), generator=g)
    return {"frontend_embeds": fe.to(device)}


def phase_serve(arch: str, device):
    """The Engine at full width answers the requests; K4 runs in every decode
    step, prefill's included, once per attention layer.  The recurrent
    models refill in waves: 2 waves of PROMPT positions and NEW steps."""
    cfg = served_config(arch)
    free, total = torch.cuda.mem_get_info(device)
    outside = total - free - torch.cuda.memory_reserved(device)   # context, local memory
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    eng = Engine(cfg, SLOTS, MAX_LEN, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(device)
    if arch in CROSS_ARCHS:
        open_gates(eng.params, SEED + 5)
    queue = make_requests(REQUESTS, PROMPT, NEW, cfg.vocab, seed=SEED)
    zero_counts()
    t0 = time.perf_counter()
    done, steps = serve_requests(eng, queue)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n, shapes = counts(), shape_counts()
    tokens = sum(len(r.out) for r in done)
    if len(done) != REQUESTS or any(len(r.out) != NEW for r in done):
        fail(f"serve {arch}: {len(done)} requests done, new tokens {[len(r.out) for r in done]}")
    if not all(0 <= tok < cfg.padded_vocab for r in done for tok in r.out):
        fail(f"serve {arch}: a token outside the model's output vocabulary")
    if eng.wave and eng.decode_calls != REQUESTS // SLOTS * (PROMPT + NEW):
        fail(f"serve {arch}: {eng.decode_calls} decode calls for waves of {SLOTS} requests")
    expect(f"serve {arch}", n, decode_attention=decode_launches(cfg, eng.decode_calls))
    emit("serve", {"arch": arch, "params": transformer.param_count(eng.params),
                   "layers": layers(cfg), "waves": eng.wave,
                   "cut": {"repeats": SERVE_CUT_REPEATS[arch]} if arch in SERVE_CUT_REPEATS
                   else None,
                   "gates": "seeded, non-zero" if arch in CROSS_ARCHS else None,
                   "slots": SLOTS, "max_len": MAX_LEN, "requests": len(done),
                   "prompt_tokens": PROMPT, "tokens": tokens, "decode_steps": steps,
                   "decode_calls": eng.decode_calls, "seconds": secs,
                   "tokens_per_s": tokens / secs,
                   "ms_per_decode_call": secs * 1e3 / eng.decode_calls,
                   "init_seconds": init_s, "launches": n,
                   "launches_by_shape": printable(shapes["decode_attention"]),
                   "param_bytes": param_bytes(eng.params),
                   "peak_bytes_init": init_peak, "bytes_outside_the_allocator": outside,
                   "peak_bytes_serving": torch.cuda.max_memory_allocated(device),
                   "first_outputs": [r.out[:8] for r in done[:2]]})
    return eng, n, shapes


def phase_prefill(eng, device):
    """The prefill step on the served weights: each forward kernel once per
    layer that runs it."""
    cfg = eng.cfg
    B, S = PREFILL[cfg.name]
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=g)
    batch = {"tokens": tokens, **frontend_batch(cfg, B, device, SEED + 6)}
    step = make_prefill_step(cfg, device=device)
    zero_counts()
    t0 = time.perf_counter()
    logits = step(eng.params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n, shapes = counts(), shape_counts()
    if logits.shape != (B, S, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill {cfg.name}: logits {tuple(logits.shape)} not finite or of the wrong shape")
    expect(f"prefill {cfg.name}", n, **forward_launches(cfg))
    emit("prefill", {"arch": cfg.name, "batch": B, "seq": S, "seconds": secs,
                     "tokens_per_s": B * S / secs, "launches": n,
                     "launches_by_shape": printable(shapes["flash_attention"]),
                     "max_abs_logit": float(logits.float().abs().max())})
    return n, shapes


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def as_float32(tree):
    if isinstance(tree, dict):
        return {k: as_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_float32(v) for v in tree]
    return tree.float()


def teacher_forced(params, cfg, tokens, device, memory: dict):
    """(forward logits, teacher-forced decode logits) over ``tokens``, with
    the cross caches filled from ``memory`` (frontend embeddings) first."""
    fwd, _ = transformer.lm_forward(params, {"tokens": tokens, **memory}, cfg)
    cache = transformer.init_lm_cache(cfg, tokens.shape[0], tokens.shape[1], device=device)
    if memory:
        cache = transformer.lm_prepare_decode_cache(params, cache, memory, cfg)
    steps = []
    for t in range(tokens.shape[1]):
        logits, cache = transformer.lm_decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
        steps.append(logits[:, 0])
    torch.cuda.synchronize()
    return fwd.float(), torch.stack(steps, 1).float()


def phase_consistency(eng, device):
    """The reference's invariant at full width: teacher-forced decode steps
    (no kernel in a recurrent step; K4 in an attention step) reproduce the
    forward pass's logits (K3, K5, K6) over the same tokens.  tinyllama and
    Mamba-2: in bfloat16, as served, and on the same weights in float32.
    RecurrentGemma: cut to the first group of its pattern with the window
    cut to 64, in float32.  qwen2-moe and deepseek: their first 8 layers at
    capacity factor 64, both dtypes.  The cross models: both dtypes, their
    cross caches filled from seeded embeddings and their gates open."""
    cfg, params = eng.cfg, eng.params
    B, S = CONSIST[cfg.name]
    cuts = {}
    if cfg.name in (MOE, DEEPSEEK):
        # the first MOE_CUT_LAYERS layers, segment by segment
        segs, seg_params, left = [], [], MOE_CUT_LAYERS
        for seg, sp in zip(cfg.segments, params["segments"]):
            r = min(seg.repeats, left)
            if r:
                segs.append(Segment(seg.pattern, r, seg.ffn))
                seg_params.append([first_repeats(b, r) for b in sp])
                left -= r
        cfg = cfg.scaled(segments=tuple(segs),
                         moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CONSIST_CF))
        params = dict(params, segments=seg_params)
        cuts = {"segments": [[list(s.pattern), s.repeats, s.ffn] for s in segs],
                "weights": f"the first {MOE_CUT_LAYERS} layers'",
                "capacity_factor": MOE_CONSIST_CF}
        print(f"consistency {cfg.name}: cut to {cuts}", flush=True)
    elif cfg.name == RGEMMA:
        first = cfg.segments[0]
        cfg = cfg.scaled(segments=(Segment(first.pattern, 1, first.ffn),),
                         attn=dataclasses.replace(cfg.attn, window=RG_CUT_WINDOW))
        params = dict(params, segments=[[first_repeats(b, 1) for b in params["segments"][0]]])
        cuts = {"pattern": list(first.pattern), "repeats": 1, "weights": "the first repeat's",
                "window": RG_CUT_WINDOW}
        print(f"consistency {RGEMMA}: cut to {cuts}", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=g).to(device)
    memory = frontend_batch(cfg, B, device, SEED + 7)
    out = {"arch": eng.cfg.name, "batch": B, "tokens": S, "cuts": cuts or None,
           "memory": "seeded frontend embeddings, gates open" if memory else None}
    # K3: the forward, and the encoder again where the decode's memory is made
    want = dict(forward_launches(cfg), decode_attention=decode_launches(cfg, S))
    want["flash_attention"] += layers(cfg)["enc"]
    n16 = None
    if cfg.name != RGEMMA:                        # RecurrentGemma's cut check: float32 only
        zero_counts()
        fwd16, dec16 = teacher_forced(params, cfg, tokens, device, memory)
        n16 = counts()
        expect(f"consistency {cfg.name} bf16", n16, **want)
    zero_counts()
    cfg32 = cfg.scaled(dtype="float32")
    fwd32, dec32 = teacher_forced(as_float32(params), cfg32, tokens, device, memory)
    n32 = counts()
    expect(f"consistency {cfg.name} f32", n32, **want)
    gap32 = (dec32 - fwd32).abs()
    if not bool((gap32 <= CONSIST_TOL32 + CONSIST_TOL32 * fwd32.abs()).all()):
        fail(f"consistency {cfg.name}: float32 decode differs from forward by {float(gap32.max())}")
    out.update({"max_abs_logit_f32": float(fwd32.abs().max()),
                "f32_decode_vs_forward": float(gap32.max()),
                "f32_limit": f"{CONSIST_TOL32} + {CONSIST_TOL32}*|forward|", "launches_f32": n32})
    if n16 is not None:
        gap16 = float((dec16 - fwd16).abs().max())
        noise = float((fwd16 - fwd32).abs().max())
        if not gap16 <= CONSIST_NOISE * noise:
            fail(f"consistency {cfg.name}: bfloat16 decode differs from forward by {gap16} > "
                 f"{CONSIST_NOISE} x {noise}, the bf16 forward's distance from float32")
        out.update({"max_abs_logit": float(fwd16.abs().max()),
                    "bf16_decode_vs_forward": gap16, "bf16_forward_vs_f32_forward": noise,
                    "bf16_decode_vs_f32_forward": float((dec16 - fwd32).abs().max()),
                    "bf16_limit": CONSIST_NOISE * noise, "launches_bf16": n16})
    emit("consistency", out)
    return {"bf16": n16, "f32": n32}


def first_repeats(tree, n: int):
    """A block's stacked parameters cut to their first ``n`` repeats (views)."""
    if isinstance(tree, dict):
        return {k: first_repeats(v, n) for k, v in tree.items()}
    return tree[:n]


def phase_profile(eng) -> None:
    """Where a serving decode step's time goes: device time by kernel and the
    device's idle share over ``PROFILE_STEPS`` steps at the served shape,
    the device's activity alone traced (host ops unrecorded: their events
    cost more to parse than the steps take); for an MoE the experts' read
    bound, for MLA the latent decode's device time."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.ones((SLOTS, 1), dtype=torch.int32)
    pos = torch.full((SLOTS,), PROMPT + NEW, dtype=torch.int32)

    def step():
        transformer.lm_decode_step(eng.params, eng.cache, toks, pos, eng.cfg)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    by_kernel = sorted(((e.key, e.self_device_time_total / PROFILE_STEPS) for e in device_events),
                       key=lambda kv: -kv[1])
    busy_us = sum(t for _, t in by_kernel)
    cfg = eng.cfg
    # a step reads every weight once, bar the embedding table, of which it
    # gathers one row a lane (a tied table is the head too, read whole)
    embed = eng.params["embed"]
    step_bytes = param_bytes(eng.params) - (0 if cfg.tie_embeddings else param_bytes(embed))
    bounds = {"weights_read_per_step_bytes": step_bytes,
              "weights_read_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}
    if cfg.moe is not None:
        # the dispatch runs every expert's three products over its (E, cap, D)
        # buffer, cap 1 included: each step reads all experts of all layers
        expert_bytes = sum(param_bytes([b["ffn"][w] for w in ("w_gate", "w_up", "w_down")])
                           for seg in eng.params["segments"] for b in seg
                           if "router" in b.get("ffn", {}))
        bounds.update({"expert_bytes_per_step": expert_bytes,
                       "expert_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3})
    if layers(cfg)["mla"]:
        bounds.update(mla_decode_times(eng))
    emit("profile", {
        "arch": eng.cfg.name,
        "what": f"lm_decode_step, {SLOTS} lanes at position {PROMPT + NEW}, "
                f"{PROFILE_STEPS} steps, device activity traced",
        "wall_ms_per_step": wall_us / PROFILE_STEPS / 1e3,
        "device_ms_per_step": busy_us / 1e3 if busy_us else "not measured",
        "device_idle_share": (1 - busy_us * PROFILE_STEPS / wall_us if busy_us
                              else "not measured"),
        **bounds,
        "decode_attention_ms_per_step": sum(t for k, t in by_kernel
                                            if any(name in k for name in dec.KERNEL.values())) / 1e3,
        "top_kernels_ms_per_step": [[k[:80], t / 1e3] for k, t in by_kernel[:8]]})


def mla_decode_times(eng) -> dict:
    """The latent decode (eager torch, no kernel of its own) of one MLA layer
    at the profiled shape, as one replay of a CUDA graph of 20 calls over 20
    (``graph_ms``), and over the model's MLA layers: the device time a
    step spends in it."""
    cfg = eng.cfg
    p = transformer._take(eng.params["segments"][-1][0]["mixer"], 0)
    cache = transformer._take(eng.cache["segments"][-1][0], 0)
    x1 = torch.randn((SLOTS, 1, cfg.d_model), generator=torch.Generator(device="cpu")
                     .manual_seed(SEED + 8)).to(eng.device, torch.bfloat16)
    pos = torch.full((SLOTS,), PROMPT + NEW, dtype=torch.int32, device=eng.device)
    ms, why = graph_ms(lambda: mla.mla_decode_step(p, x1, cache, pos, cfg))
    out = {"mla_decode_layer_device_ms": ms,
           "mla_decode_device_ms_per_step": ms * layers(cfg)["mla"] if ms else None}
    if why:
        out["mla_decode_note"] = why
    return out


def phase_mesh_decode(eng, mesh, device) -> dict:
    """The served tinyllama's decode on the one-rank mesh under
    ``rules_for(cfg, mesh, "decode", flash_decode=True)``: the caches made
    under the rules hold the rank's slots of the length, and every attention
    layer takes ``_sharded_flash_decode`` — K4's partial (``normalize=False``),
    the all-gather of (acc, m, l) over ``model`` (NCCL) and ``merge_partials``.
    ``MESH_DECODE_STEPS`` steps of seeded tokens from ``MESH_START`` (a
    position per lane) in bfloat16, the counts at 0 just before and read
    just after.  Then the same steps on the same weights sharded in float32,
    and unsharded in both dtypes, each on a fresh cache, held as the
    consistency check holds the decode: in float32 within 2e-3 + 2e-3
    |unsharded| of the unsharded logits (one sum's order apart in each
    layer); in bfloat16 within ``CONSIST_NOISE`` times the unsharded bf16
    logits' distance from the float32 ones (the partial's accumulator is
    rounded to bfloat16 before it is normalised, one rounding the
    unsharded kernel does not make, and 22 layers carry that apart).  One
    step timed both ways (CUDA events, 20 calls)."""
    cfg, a = eng.cfg, eng.cfg.attn
    rules = rules_for(cfg, mesh, "decode", batch=SLOTS, flash_decode=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 13)
    toks = torch.randint(1, cfg.vocab, (MESH_DECODE_STEPS, SLOTS, 1), generator=g).to(device)
    start = torch.tensor(MESH_START, dtype=torch.int32, device=device)

    def run(params, c, sharded: bool):
        with contextlib.ExitStack() as stack:
            if sharded:
                stack.enter_context(use_rules(rules, mesh))
            cache = transformer.init_lm_cache(c, SLOTS, MAX_LEN, device=device)
            out = [transformer.lm_decode_step(params, cache, toks[t], start + t, c)[0].float()
                   for t in range(MESH_DECODE_STEPS)]
        return torch.stack(out), cache

    zero_counts()
    t0 = time.perf_counter()
    got16, sharded_cache = run(eng.params, cfg, True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n, partial = counts(), dict(dec.partial_by_shape)
    calls = cfg.n_layers * MESH_DECODE_STEPS
    expect("mesh decode", n, decode_attention=calls)
    key = (SLOTS, a.n_heads, a.n_kv_heads, MAX_LEN, a.d_head, True, None)
    if partial != {key: calls}:
        fail(f"mesh decode: K4 partial launches {printable(partial)}, expected {calls} at {key}")
    want16, plain_cache = run(eng.params, cfg, False)
    cfg32 = cfg.scaled(dtype="float32")
    params32 = as_float32(eng.params)
    got32, _ = run(params32, cfg32, True)
    want32, _ = run(params32, cfg32, False)
    del params32
    torch.cuda.empty_cache()
    err32 = check_close("mesh decode float32: logits against the unsharded step", got32, want32,
                        F32, tol=CONSIST_TOL32)
    err16 = float((got16 - want16).abs().max())
    noise = float((want16 - want32).abs().max())
    if not err16 <= CONSIST_NOISE * noise:
        fail(f"mesh decode bf16: logits {err16} from the unsharded step's, over {CONSIST_NOISE} x "
             f"{noise}, the unsharded bf16 logits' distance from float32")
    idx = start + MESH_DECODE_STEPS

    def sharded_step():
        with use_rules(rules, mesh):
            transformer.lm_decode_step(eng.params, sharded_cache, toks[0], idx, cfg)

    out = {"arch": cfg.name, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
           "rules": "rules_for(cfg, mesh, 'decode', flash_decode=True)",
           "slots": SLOTS, "max_len": MAX_LEN, "start": list(MESH_START),
           "steps": MESH_DECODE_STEPS, "seconds": secs, "launches": n,
           "partial_launches_by_shape": printable(partial),
           "max_abs_logit": float(want32.abs().max()),
           "f32_vs_unsharded": err32, "f32_limit": f"{CONSIST_TOL32} + {CONSIST_TOL32}*|unsharded|",
           "bf16_vs_unsharded": err16, "bf16_unsharded_vs_f32": noise,
           "bf16_limit": CONSIST_NOISE * noise,
           "sharded_step_ms": time_ms(sharded_step, 20),
           "unsharded_step_ms": time_ms(lambda: transformer.lm_decode_step(
               eng.params, plain_cache, toks[0], idx, cfg), 20)}
    emit("mesh_decode", out)
    return {"launches": n, "partial_shapes": partial}


def first_moe_layer(params, cfg):
    """The first MoE ffn's parameters of a served model (its first repeat)."""
    for seg_p, seg in zip(params["segments"], cfg.segments):
        for pos in range(len(seg.pattern)):
            if seg.ffn_at(pos) == "moe":
                return transformer._take(seg_p[pos]["ffn"], 0)
    fail(f"{cfg.name} has no MoE layer")


def phase_mesh_moe(eng, mesh, device) -> dict:
    """qwen2-moe's first MoE layer at full width under ``moe_ep=True`` rules
    on the one-rank mesh (``moe_forward_ep``: the rank's shard of the 60
    experts, the FSDP gathers, the sum over ``model`` and the aux mean over
    the dp axes, through NCCL) against ``moe_forward_local`` on the same
    seeded bfloat16 tokens: the outputs within the bfloat16 tolerance (the
    token sums are atomic on the card), the aux losses to 1e-6."""
    cfg = eng.cfg
    p = first_moe_layer(eng.params, cfg)
    g = torch.Generator(device="cpu").manual_seed(SEED + 14)
    x = seeded((SLOTS, MESH_MOE_TOKENS, cfg.d_model), BF16, device, g)
    rules = rules_for(cfg, mesh, "train", batch=SLOTS, moe_ep=True)
    y0, aux0 = mlp.moe_forward_local(p, x, cfg)

    def ep():
        with use_rules(rules, mesh):
            return mlp.moe_forward(p, x, cfg)

    y1, aux1 = ep()
    err = check_close("mesh moe: moe_ep against moe_forward_local", y1, y0, BF16)
    if not abs(float(aux1) - float(aux0)) <= 1e-6 * abs(float(aux0)):
        fail(f"mesh moe: aux {float(aux1)} against the local {float(aux0)}")
    out = {"arch": cfg.name, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
           "rules": "rules_for(cfg, mesh, 'train', moe_ep=True)",
           "tokens": [SLOTS, MESH_MOE_TOKENS], "experts": cfg.moe.n_routed,
           "max_abs_err": err, "tolerance": f"{ATTN_TOL[BF16]} + {ATTN_TOL[BF16]}*|local|",
           "aux": float(aux1), "aux_local": float(aux0),
           "ep_ms": time_ms(ep, 10), "local_ms": time_ms(lambda: mlp.moe_forward_local(p, x, cfg),
                                                         10)}
    emit("mesh_moe", out)
    return out


def serve_model(arch: str, device, mesh=None) -> dict:
    """Serve, prefill, consistency and profile of one model, and for
    tinyllama and qwen2-moe their paths on the one-rank ``mesh``; frees it
    after.  Returns the launches of each phase, and those of serving and the
    prefill by shape."""
    eng, served, served_shapes = phase_serve(arch, device)
    prefilled, prefill_shapes = phase_prefill(eng, device)
    consistent = phase_consistency(eng, device)
    phase_profile(eng)
    out = {"serve": served, "prefill": prefilled, "consistency": consistent,
           "serve_shapes": served_shapes, "prefill_shapes": prefill_shapes}
    if mesh is not None and arch == ARCH:
        out["mesh_decode"] = phase_mesh_decode(eng, mesh, device)
    if mesh is not None and arch == MOE:
        phase_mesh_moe(eng, mesh, device)
    del eng
    torch.cuda.empty_cache()
    return out


# -- training ------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def train_example():
    """examples/train_tinylm_torch.py as a module (its model is ``TINYLM``)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / "train_tinylm_torch.py"
    spec = importlib.util.spec_from_file_location("train_tinylm_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_launches(cfg) -> dict:
    """Launches of one gradient: K3 over every self-attention, MLA,
    cross-attention and encoder layer's forward, again in the backward under
    remat="block", and S2 once a layer; K5 and S3 over the SSD layers, K6
    and S4 over the RG-LRU layers, alike."""
    n = layers(cfg)
    attn, remat = n["attn"] + n["mla"] + n["cross"] + n["enc"], 2 if cfg.remat == "block" else 1
    out = {"flash_attention": attn * remat, "flash_attention_bwd": attn,
           "ssd_scan": n["ssd"] * remat, "ssd_scan_bwd": n["ssd"],
           "rglru_scan": n["rglru"] * remat, "rglru_scan_bwd": n["rglru"]}
    return {k: v for k, v in out.items() if v}


def states_equal(a, b) -> bool:
    la, lb = _tree.with_paths(a), _tree.with_paths(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape and torch.equal(la[k], lb[k])
        for k in la)


def phase_train(device) -> dict:
    """The training path (``launch.train``) at tinyllama-1.1b's full width
    and depth: AdamW steps on the synthetic stream with checkpoints, every
    attention layer's forward through K3 (twice a step under remat) and its
    backward through S2.  Then: every gradient leaf finite and non-zero; the
    last checkpoint restored equal to the live state, bit for bit."""
    cfg = get_config(ARCH)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    free_disk = shutil.disk_usage(TRAIN_DIR.parent).free
    per_step, last = [], {}

    def on_step(i, m):
        now = counts()
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)

    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    run = train_driver.train(cfg, OptCfg(**TRAIN_OPT), steps=TRAIN_STEPS, batch=TRAIN_B,
                             seq=TRAIN_S, ckpt_dir=TRAIN_DIR, ckpt_every=TRAIN_CKPT_EVERY,
                             device=device, on_step=on_step)
    n, shapes = counts(), {"flash_attention": dict(fa.by_shape),
                           "flash_attention_bwd": dict(fab.by_shape)}
    peak = torch.cuda.max_memory_allocated(device)
    if run.report.steps_completed != TRAIN_STEPS or len(per_step) != TRAIN_STEPS:
        fail(f"train: {run.report.steps_completed} steps completed, {len(per_step)} reported")
    for i, step_n in enumerate(per_step):
        expect(f"train step {i}", step_n, **train_launches(cfg))
    for m in run.metrics:
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm", "xent")):
            fail(f"train: a step's metrics are not finite: {m}")
    times = run.monitor.times
    step_s = float(np.median(times[2:TRAIN_STEPS]))
    # the last checkpoint (the last step's) against the live state
    t0 = time.perf_counter()
    restored, at = restore(TRAIN_DIR, run.state)
    restore_s = time.perf_counter() - t0
    if at != TRAIN_STEPS - 1 or not states_equal(restored, run.state):
        fail(f"train: the checkpoint of step {at} differs from the live state")
    ckpt_bytes = sum(f.stat().st_size for f in TRAIN_DIR.rglob("*") if f.is_file())
    del restored
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    # the gradients of the trained state on the first batch: each leaf finite
    # and non-zero (a kernel that dropped a gradient would leave zeros)
    batch = {k: torch.as_tensor(v, device=device) for k, v in make_batch(
        cfg, ShapeCfg("train", TRAIN_S, TRAIN_B, "train"), step=0).items()}
    _, _, grads = make_grad_fn(cfg)(run.state["params"], batch)
    for key, gl in _tree.with_paths(grads).items():
        if not bool(torch.isfinite(gl).all()) or float(gl.float().abs().max()) == 0.0:
            fail(f"train: gradient {key} is not finite or all zero")
    del grads
    profile = train_step_profile(cfg, run.state, device)
    params = run.state["params"]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_B, "seq": TRAIN_S,
           "steps": TRAIN_STEPS, "opt": TRAIN_OPT, "ckpt_every": TRAIN_CKPT_EVERY,
           "params": transformer.param_count(params), "param_bytes": param_bytes(params),
           "state_bytes": param_bytes(run.state), "checkpoint_bytes_on_disk": ckpt_bytes,
           "free_disk_bytes_before": free_disk, "restore_seconds": restore_s,
           "losses": run.losses,
           "grad_norms": [m["grad_norm"] for m in run.metrics],
           "lrs": [m["lr"] for m in run.metrics],
           "step_seconds": times, "step_seconds_median_2_5": step_s,
           "tokens_per_s": TRAIN_B * TRAIN_S / step_s, "seconds": run.seconds,
           "restarts": run.report.restarts, "peak_bytes": peak,
           "launches": n, "launches_per_step": per_step,
           "launches_by_shape": {k: printable(v) for k, v in shapes.items()},
           "gradients": "every leaf finite and non-zero",
           "checkpoint": f"step {at} restored equal to the live state, bit for bit",
           "profile": profile}
    del run, params
    torch.cuda.empty_cache()
    emit("train", out)
    return {"launches": n, "shapes": shapes, "step_seconds": step_s, "peak_bytes": peak}


def train_step_profile(cfg, state, device) -> dict:
    """Where one more train step's time goes, under ``torch.profiler``:
    device time by kernel, K3's and S2's share, the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    step = make_train_step(cfg, OptCfg(**TRAIN_OPT), device=device)
    batch = make_batch(cfg, ShapeCfg("train", TRAIN_S, TRAIN_B, "train"), step=TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new_state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del new_state
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3) for e in events),
                       key=lambda kv: -kv[1])
    busy = sum(t for _, t in by_kernel)
    of = lambda names: sum(t for k, t in by_kernel if any(n in k for n in names))
    s2_names = {n for ns in fa.BWD_KERNELS.values() for n in ns}
    s2_ms = of(s2_names)
    return {"wall_ms": wall_ms, "device_ms": busy if busy else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy else "not measured",
            "s2_ms": s2_ms, "s2_share": s2_ms / busy if busy else "not measured",
            "s2_ms_by_kernel": {n: sum(t for k, t in by_kernel if re.search(rf"\b{n}[<(]", k))
                                for n in sorted(s2_names)},
            "k3_ms": of(["flash_bf16_wgmma", "flash_f32"]),
            "top_kernels_ms": [[k[:80], t] for k, t in by_kernel[:10]]}


def phase_train_card_vs_cpu(device, arch: str) -> dict:
    """One train step of the arch's smoke config (float32) on the card (K3
    ``flash_f32`` and S2, K5 and S3, K6 and S4, by its layers) against the
    CPU (the plain versions) from one state made on the host, every leaf
    float32 (the config's bfloat16 projection weights too: a bfloat16 leaf
    rounds apart by one unit where the two sides' float32 gradients straddle
    a rounding boundary), in ``make_train_step``'s two halves, each side from
    its own gradients: the loss (rtol 1e-5) and the gradients, each leaf
    within 1e-5 of its largest magnitude; then each parameter leaf within
    1e-4 of its largest magnitude at every element whose step the gradient
    check fixes (``adamw.fixed_by_gradients``; at most 1 % are left out).
    The row gives the count left out by leaf and the left-out element that
    stepped furthest apart, with its gradient on both sides."""
    cfg = get_smoke_config(arch)
    state = _tree.map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                      init_train_state(SEED, cfg, device="cpu"))
    batch = {k: torch.as_tensor(v) for k, v in make_batch(
        cfg, ShapeCfg("smoke", 64, 4, "train"), step=0).items()}
    opt = OptCfg(**TRAIN_OPT)
    on_card = _tree.map(lambda t: t.to(device), state)
    zero_counts()
    loss_card, _, g_card = make_grad_fn(cfg)(on_card["params"],
                                              {k: v.to(device) for k, v in batch.items()})
    card, _, _ = adamw_update(g_card, on_card["opt"], on_card["params"], opt)
    torch.cuda.synchronize()
    n = counts()
    expect(f"train card vs cpu {arch}", n, **train_launches(cfg))
    loss_cpu, _, g_cpu = make_grad_fn(cfg)(state["params"], batch)
    cpu, _, _ = adamw_update(g_cpu, state["opt"], state["params"], opt)
    if not abs(float(loss_card) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu)):
        fail(f"train card vs cpu {arch}: loss {float(loss_card)} against {float(loss_cpu)}")
    fixed = _tree.with_paths(fixed_by_gradients(g_cpu, state["opt"], state["params"], opt))
    left_out = {key: int((~m).sum()) for key, m in fixed.items() if not m.all()}
    n_params = sum(m.numel() for m in fixed.values())
    if not sum(left_out.values()) <= 0.01 * n_params:
        fail(f"train card vs cpu {arch}: the step check leaves out {sum(left_out.values())} "
             f"of {n_params} elements (limit 1 %)")
    worst = {"gradient": 0.0, "param": 0.0}
    apart = {"step_err_over_max": 0.0}
    g_card, g_cpu = _tree.with_paths(g_card), _tree.with_paths(g_cpu)
    for key, want in g_cpu.items():
        scale = float(want.abs().max())
        err = float((g_card[key].cpu() - want).abs().max())
        if not err <= 1e-5 * scale:
            fail(f"train card vs cpu {arch}: gradient {key} differs by {err} against a "
                 f"largest magnitude of {scale} (limit 1e-5 of it)")
        worst["gradient"] = max(worst["gradient"], err / scale if scale else 0.0)
    card = _tree.with_paths(card)
    for key, want in _tree.with_paths(cpu).items():
        scale = float(want.abs().max())
        diff = (card[key].cpu() - want).abs()
        err = float((diff * fixed[key]).max())
        if not err <= 1e-4 * scale:
            fail(f"train card vs cpu {arch}: param {key} differs by {err} against a largest "
                 f"magnitude of {scale} where the gradient check fixes its step (limit 1e-4 "
                 f"of it)")
        if not scale:
            continue
        worst["param"] = max(worst["param"], err / scale)
        out = diff * ~fixed[key] / scale
        if float(out.max()) > apart["step_err_over_max"]:
            i = int(out.argmax())
            apart = {"leaf": key, "step_err_over_max": float(out.max()),
                     "g_card": float(g_card[key].flatten()[i]),
                     "g_cpu": float(g_cpu[key].flatten()[i]),
                     "leaf_max_abs_g_cpu": float(g_cpu[key].abs().max())}
    out = {"arch": cfg.name, "dtype": cfg.dtype, "batch": 4, "seq": 64,
           "loss_card": float(loss_card), "loss_cpu": float(loss_cpu),
           "worst_gradient_err_over_max": worst["gradient"], "gradient_limit": 1e-5,
           "worst_param_err_over_max": worst["param"], "limit": 1e-4,
           "step_left_out": sum(left_out.values()), "step_elements": n_params,
           "step_left_out_by_leaf": left_out, "step_left_out_furthest_apart": apart,
           "launches": n}
    emit(f"train_card_vs_cpu[{arch}]", out)
    return out


def train_config(arch: str):
    """The arch's config as ``phase_train_archs`` trains it: full width, its
    depth cut where ``TRAIN_CUT`` says (repeats per segment, 0 drops one),
    and the cut in words (None for the whole model)."""
    cfg = get_config(arch)
    if arch not in TRAIN_CUT:
        return cfg, None
    segs = tuple(Segment(s.pattern, r, s.ffn) for s, r in zip(cfg.segments, TRAIN_CUT[arch]) if r)
    kept = cfg.scaled(segments=segs)
    return kept, (f"{kept.n_layers} of {cfg.n_layers} layers: "
                  + ", ".join(f"{r} x {'+'.join(s.pattern)}" for s, r in
                              zip(cfg.segments, TRAIN_CUT[arch])))


def step_shares(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the device's
    busy time and idle share, its six largest kernels, and the device time of
    each kernel family (S2, K3, K5, S3, K6, S4) and its share; ``not
    measured`` where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
              if e.self_device_time_total > 0]
    busy = sum(t for _, t in events)
    if not busy:
        return {"wall_ms": wall, "device_ms": "not measured"}
    # each family's kernel names as patterns (a template argument as the
    # profiler may spell it: <true> or <(bool)1>)
    families = {"s2": sorted({n for ns in fa.BWD_KERNELS.values() for n in ns}),
                "k3": ["flash_bf16_wgmma", "flash_f32"],
                "k5": ["ssd_chunk_cb", r"ssd_chunk_state<(false|\(bool\)0)>", "ssd_state_pass",
                       "ssd_chunk_scan"],
                "s3": [r"ssd_chunk_state<(true|\(bool\)1)>", r"ssd_bwd_\w+"],
                "k6": ["rglru_kernel"], "s4": ["rglru_bwd_kernel"]}
    out = {"wall_ms": wall, "device_ms": busy, "device_idle_share": 1 - busy / wall,
           "top_kernels_ms": [[k[:80], t] for k, t in sorted(events, key=lambda e: -e[1])[:6]]}
    for fam, names in families.items():
        pattern = re.compile(rf"(?<!\w)(?:{'|'.join(names)})(?!\w)")
        ms = sum(t for k, t in events if pattern.search(k))
        out[f"{fam}_ms"], out[f"{fam}_share"] = ms, ms / busy
    return out


def phase_train_archs(device) -> dict:
    """Every arch but tinyllama (whose ``train`` phase runs it whole) at full
    width, bfloat16 with remat as its config has it, its depth cut where
    ``TRAIN_CUT`` says: a warm-up gradient (every leaf checked finite and
    non-zero), then two timed AdamW steps (``make_train_step``) on the
    synthetic stream, no checkpoints; the launches by kernel, and a profiled
    step's device time by kernel family.  ``GRAD_ONLY`` archs run the
    gradient three times and no step.  Returns each arch's launches."""
    ran = {}
    for arch in TRAIN_ARCHS:
        cfg, cut = train_config(arch)
        B, S = TRAIN_ARCH_SHAPE.get(arch, (2, 2048))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state = ({"params": transformer.init_lm(SEED, cfg, device=device)} if arch in GRAD_ONLY
                 else init_train_state(SEED, cfg, device=device))
        if arch in CROSS_ARCHS:
            open_gates(state["params"], SEED + 1)
        init_s = time.perf_counter() - t0
        batches = [{k: torch.as_tensor(v, device=device) for k, v in make_batch(
            cfg, ShapeCfg("train", S, B, "train"), step=i).items()} for i in range(3)]
        grad_fn = make_grad_fn(cfg)
        zero_counts()
        t0 = time.perf_counter()
        loss, _, grads = grad_fn(state["params"], batches[0])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if not bool(torch.isfinite(loss)):
            fail(f"train {arch}: the loss {float(loss)} is not finite")
        leaves = _tree.with_paths(grads)
        for key, gl in leaves.items():
            if not bool(torch.isfinite(gl).all()) or float(gl.float().abs().max()) == 0.0:
                fail(f"train {arch}: gradient {key} is not finite or all zero")
        del grads
        if arch in GRAD_ONLY:
            step = lambda st, b: (st, {"loss": grad_fn(st["params"], b)[0]})
        else:
            step = make_train_step(cfg, OptCfg(**TRAIN_OPT), device=device)
        times, losses = [], [float(loss)]
        for b in batches[1:]:
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        n = counts()
        expect(f"train {arch}", n, **{k: 3 * v for k, v in train_launches(cfg).items()})
        if not all(np.isfinite(losses)):
            fail(f"train {arch}: losses {losses}")
        peak = torch.cuda.max_memory_allocated(device)
        shares = step_shares(lambda: step(state, batches[2]))
        row = {"arch": arch, "layers": cfg.n_layers, "cut": cut or "none (whole model)",
               "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
               "batch": B, "seq": S, "params": transformer.param_count(state["params"]),
               "state_bytes": param_bytes(state), "init_seconds": init_s,
               "warm_gradient_seconds": warm_s,
               "timed": "gradients only" if arch in GRAD_ONLY else "AdamW steps",
               "step_seconds": times, "step_seconds_mean": float(np.mean(times)),
               "tokens_per_s": B * S / float(np.mean(times)), "losses": losses,
               "peak_bytes": peak, "launches": n,
               "gradients": f"{len(leaves)} leaves, each finite and non-zero",
               "profiled_step": shares}
        if arch in GRAD_ONLY:
            row["why_gradients_only"] = GRAD_ONLY[arch]
        emit(f"train[{arch}]", row)
        ran[arch] = {"launches": n, "shape": (B, S)}
        del state, batches, step
    torch.cuda.empty_cache()
    return ran


@contextlib.contextmanager
def plain_attention():
    """``ops.mha`` through the plain version on the card (autograd through
    ``ref.flash_attention_ref``): the yardstick of a gradient check only."""
    real = ops.mha

    def mha(q, k, v, *, causal=True, window=None, scale=None, softcap=None):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       causal=causal, window=window, scale=scale,
                                       softcap=softcap).transpose(1, 2)

    ops.mha = mha
    try:
        yield
    finally:
        ops.mha = real


def phase_train_grads(device, arch: str = ARCH, B: int = GRAD_B, S: int = GRAD_S) -> dict:
    """``arch`` at full width, cut to its first segment's first layers
    (tinyllama-1.1b's attention, capped or not; deepseek-v2-lite's dense MLA
    layers, K3 and S2 at (192, 128)): the bfloat16 gradients through K3 and
    S2 against float32 plain ones on the same weights and batch.  Each leaf's
    relative L2 error may be at most 3x the bfloat16 plain path's (the rule
    of the consistency checks).  The capped model's query and key weights
    are sharpened (``sharpen``), and its check fails unless the float32
    plain gradients without the cap lie outside that limit on some leaf: a
    dropped cap would fail it."""
    full = served_config(arch)
    cfg = full.scaled(segments=(Segment(full.segments[0].pattern, GRAD_CUT_LAYERS,
                                        full.segments[0].ffn),))
    params = init_train_state(SEED + 10, cfg, device=device)["params"]
    if arch == CAPPED:
        sharpen(params)
    batch = {k: torch.as_tensor(v, device=device) for k, v in make_batch(
        cfg, ShapeCfg("grads", S, B, "train"), step=1).items()}
    zero_counts()
    _, _, kernel = make_grad_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    n, shapes = counts(), {"flash_attention": dict(fa.by_shape),
                           "flash_attention_bwd": dict(fab.by_shape)}
    expect(f"train grads {arch}, kernel path", n, **train_launches(cfg))
    with plain_attention():
        _, _, plain16 = make_grad_fn(cfg)(params, batch)
        _, _, plain32 = make_grad_fn(cfg.scaled(dtype="float32"))(as_float32(params), batch)
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    leaves = {}
    for key, want in _tree.with_paths(plain32).items():
        k_err = rel(_tree.with_paths(kernel)[key], want)
        p_err = rel(_tree.with_paths(plain16)[key], want)
        leaves[key] = {"kernel_bf16_vs_plain_f32": k_err, "plain_bf16_vs_plain_f32": p_err}
        if not k_err <= CONSIST_NOISE * p_err:
            fail(f"train grads {arch}: {key}: the kernel's bf16 gradient is {k_err} from "
                 f"float32, > {CONSIST_NOISE} x the bf16 plain path's {p_err}")
    dropped = {}
    if cfg.attn.logit_softcap is not None:
        uncapped = cfg.scaled(dtype="float32",
                              attn=dataclasses.replace(cfg.attn, logit_softcap=None))
        with plain_attention():
            _, _, plain32u = make_grad_fn(uncapped)(as_float32(params), batch)
        for key, want in _tree.with_paths(plain32).items():
            d = rel(_tree.with_paths(plain32u)[key], want)
            leaves[key]["plain_f32_uncapped_vs_capped"] = d
            dropped[key] = d / (CONSIST_NOISE * leaves[key]["plain_bf16_vs_plain_f32"])
        del plain32u
        if not max(dropped.values()) > 1.0:
            fail(f"train grads {arch}: no leaf of the uncapped gradient lies outside the "
                 f"limit (at most {max(dropped.values())} of it): the check cannot see the cap")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
           "cut": f"the first {GRAD_CUT_LAYERS} layers, full width", "launches": n,
           "launches_by_shape": {k: printable(v) for k, v in shapes.items()},
           "limit": f"{CONSIST_NOISE} x the bf16 plain path's relative L2 error",
           "worst_ratio": max(v["kernel_bf16_vs_plain_f32"] / v["plain_bf16_vs_plain_f32"]
                              for v in leaves.values()),
           **({"qk_weights": f"x{CAPPED_QK:g}",
               "uncapped_over_limit": max(dropped.values())} if dropped else {}),
           "leaves": leaves}
    del kernel, plain16, plain32, params
    torch.cuda.empty_cache()
    emit(f"train_grads[{arch}]", out)
    return {"launches": n, "shapes": shapes}


def phase_train_example(device) -> dict:
    """examples/train_tinylm_torch.py as a user runs it: TINYLM in float32
    (K3 ``flash_f32`` and S2 in float32), a failure injected, one restart
    from a checkpoint; the example asserts that the loss falls."""
    module = train_example()
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(["--steps", str(EXAMPLE_STEPS), "--fail-at", str(EXAMPLE_FAIL_AT),
                          "--device", str(device)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n, shapes = counts(), {"flash_attention": dict(fa.by_shape),
                           "flash_attention_bwd": dict(fab.by_shape)}
    text = buf.getvalue()
    last = text.strip().splitlines()[-1]
    if rc != 0 or f"completed {EXAMPLE_STEPS} steps, 1 restarts" not in last:
        fail(f"train example: exit {rc}, {last!r}")
    cfg = module.TINYLM
    # a checkpoint every 10 steps: the failure at 12 reruns steps 10 and 11
    runs = EXAMPLE_STEPS + EXAMPLE_FAIL_AT % 10
    expect("train example", n, **{k: v * runs for k, v in train_launches(cfg).items()})
    out = {"example": "examples/train_tinylm_torch.py", "steps": EXAMPLE_STEPS,
           "fail_at": EXAMPLE_FAIL_AT, "step_runs": runs, "seconds": secs,
           "last_line": last, "launches": n,
           "launches_by_shape": {k: printable(v) for k, v in shapes.items()}}
    emit("train_example", out)
    return {"launches": n, "shapes": shapes}


def phase_mesh_train(mesh, device) -> dict:
    """One int8-compressed gradient at the training phase's shape
    (tinyllama-1.1b, full width and depth, 4 x 2048 tokens) over the
    one-rank ``pod`` axis (``pod_grads_compressed``: the data mean, the int8
    payload and its scale all-gathered over ``pod`` through NCCL, the
    dequantised sum), the counts at 0 just before and read just after;
    against the plain gradients of the same state and batch: the loss equal,
    each leaf within max|g| / 254 (the rounding's half step, plus 2^-21
    max|g| for float32's rounding of the quotient, the scale and the
    product) of the gradients it compressed, and of the plain ones within
    that plus their run-to-run difference (0 where the backward is
    deterministic).  Then the int8 ``make_train_step`` and the plain one,
    timed twice each, alternately."""
    cfg = get_config(ARCH)
    state = init_train_state(SEED, cfg, device=device)
    params = state["params"]
    batch = {k: torch.as_tensor(v, device=device) for k, v in make_batch(
        cfg, ShapeCfg("train", TRAIN_S, TRAIN_B, "train"), step=0).items()}
    grad_fn = make_grad_fn(cfg)
    seen = {}

    def recording(p, b):
        seen["raw"] = grad_fn(p, b)
        return seen["raw"]

    zero_counts()
    loss_c, _, g_c = compression.pod_grads_compressed(recording, params, batch, mesh)
    torch.cuda.synchronize()
    n = counts()
    expect("mesh train", n, **train_launches(cfg))
    loss_r, _, g_r = seen.pop("raw")
    loss_p, _, g_p = grad_fn(params, batch)
    if not float(loss_c) == float(loss_r) == float(loss_p):
        fail(f"mesh train: loss {float(loss_c)} (int8) against {float(loss_p)} (plain)")
    worst, worst_plain, noise = 0.0, 0.0, 0.0
    for key, c, r, pl in zip(_tree.with_paths(g_c), _tree.leaves(g_c), _tree.leaves(g_r),
                             _tree.leaves(g_p)):
        top = float(r.float().abs().max())
        limit = top * (1 / 254 + 2.0 ** -21)
        run_diff = float((r.float() - pl.float()).abs().max())
        err_raw = float((c - r.float()).abs().max())
        err_plain = float((c - pl.float()).abs().max())
        if not (err_raw <= limit and err_plain <= limit + run_diff):
            fail(f"mesh train: gradient {key} off by {err_raw} (of what it compressed) and "
                 f"{err_plain} (of the plain step's), limit {limit} + {run_diff}")
        worst = max(worst, err_raw / limit if limit else 0.0)
        worst_plain = max(worst_plain, err_plain / (limit + run_diff) if limit else 0.0)
        noise = max(noise, run_diff / top if top else 0.0)
    del g_c, g_r, g_p
    torch.cuda.empty_cache()
    steps = {"int8": make_train_step(cfg, OptCfg(**TRAIN_OPT), grad_compression="int8",
                                     mesh=mesh, device=device),
             "plain": make_train_step(cfg, OptCfg(**TRAIN_OPT), device=device)}
    times, losses = {"int8": [], "plain": []}, {}
    for which in ("plain", "int8", "plain", "int8"):
        out = {}
        times[which].append(wall_ms(lambda: out.update(r=steps[which](state, batch))))
        losses[which] = float(out["r"][1]["loss"])
        del out
        torch.cuda.empty_cache()
    if losses["int8"] != losses["plain"]:
        fail(f"mesh train: the int8 step's loss {losses['int8']} against {losses['plain']}")
    res = {"arch": cfg.name, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)), "batch": TRAIN_B,
           "seq": TRAIN_S, "launches": n, "loss": float(loss_c),
           "worst_err_share_of_limit": worst, "worst_err_share_vs_plain": worst_plain,
           "plain_run_to_run_max_rel": noise,
           "limit": "max|g| / 254 + 2^-21 max|g| (float32 rounding of the quotient, "
                    "the scale and the product), a leaf",
           "int8_step_ms": times["int8"], "plain_step_ms": times["plain"]}
    del state, params
    torch.cuda.empty_cache()
    emit("mesh_train", res)
    return res


def phase_serve_example(device) -> dict:
    """examples/serve_batched_torch.py as a user runs it on the card (no
    ``--device``): its smoke defaults, 10 requests over 4 slots, every
    decode step through K4 and nothing else; its ``served 10 requests, 120
    tokens, ...`` line is checked."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batched_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = counts()
    lines = buf.getvalue().strip().splitlines()
    m = re.match(r"served 10 requests, 120 tokens, (\d+) decode steps in ", lines[0]) \
        if lines else None
    if rc != 0 or m is None:
        fail(f"serve example: exit {rc}, {lines[:1]!r}")
    layers_n = get_smoke_config(ARCH).n_layers
    if n["decode_attention"] <= 0 or n["decode_attention"] % layers_n:
        fail(f"serve example: {n['decode_attention']} decode-attention launches, not a "
             f"positive multiple of its {layers_n} layers")
    expect("serve example", n, decode_attention=n["decode_attention"])
    out = {"example": "examples/serve_batched_torch.py", "seconds": secs, "lines": lines,
           "decode_steps": int(m.group(1)), "launches": n}
    emit("serve_example", out)
    return out


def softcap_launches(dense, capped, k3_rows, k4_rows, k3_cap, k4_cap) -> dict:
    """Every uncapped row keeps its launch count: tinyllama's prefill and
    serving launched K3 and K4 only uncapped (every ``by_shape`` key's cap
    None), as many times as before (a layer a pass or a decode call), and the
    capped model's the same counts, every one capped."""
    cfg = get_config(ARCH)
    calls = dense["serve"]["decode_attention"] // cfg.n_layers
    out = {"config": f"{ARCH} with attn.logit_softcap {SOFTCAP:g}, full width and depth "
                     "(cfg.scaled; not in the registry)"}
    for which, ran, (k3, k4) in (("uncapped", dense, (k3_rows[0], k4_rows[0])),
                                 ("capped", capped, (k3_cap[0], k4_cap[0]))):
        cap = SOFTCAP if which == "capped" else None
        for phase, kernel in (("prefill", "flash_attention"), ("serve", "decode_attention")):
            keys = ran[phase + "_shapes"][kernel]
            if any(key[-1] != cap for key in keys):
                fail(f"{which} tinyllama {phase}: {kernel} launched at {printable(keys)}")
        n = (ran["prefill_shapes"]["flash_attention"].get(shape_key(k3), 0),
             ran["serve_shapes"]["decode_attention"].get(shape_key(k4), 0))
        if n != (cfg.n_layers, cfg.n_layers * calls):
            fail(f"{which} tinyllama: K3 and K4 launches {n}, expected "
                 f"{(cfg.n_layers, cfg.n_layers * calls)}")
        out[which] = {"prefill K3": n[0], "serve K4": n[1]}
    return out


PHASE_SECONDS: dict[str, float] = {}


DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_dryrun"


def start_dryrun() -> dict:
    """Start the dry-run on the host (``start_host_job``: it traces, and
    launches nothing)."""
    return start_host_job(DRYRUN_CODE, [ARCH, str(TRAIN_B), str(TRAIN_S),
                                        json.dumps(DRYRUN_CELLS)], DRYRUN_OUT)


def phase_dryrun(run: dict, trained: dict, smi: str) -> dict:
    """The dry-run's result (``start_dryrun``), within its own time limit
    from its start: ``DRYRUN_CELLS`` on the 256-rank production mesh, and
    the train phase's step (tinyllama-1.1b whole, 4 x 2048, remat) on one
    rank, whose predicted FLOPs, bytes, H100 bound and peak bytes stand
    beside what the train phase measured: its step seconds and peak bytes,
    and ``model_flops / (step_s x 989e12)``.  Every cell must end ``ok``
    with FLOPs, bytes and a bottleneck; the one-rank cell must move no
    collective bytes."""
    from repro_torch.launch import trace_analysis

    stdout = finish_host_job(run, DRYRUN_SECONDS, "dryrun")
    line = next((ln for ln in stdout.splitlines() if ln.startswith("DRYRUN ")), None)
    if line is None:
        fail(f"dryrun: no result line in its output: {stdout[-2000:]}")
    res = json.loads(line[len("DRYRUN "):])
    keep = ("status", "error", "chips", "num_microbatches", "trace_s", "memory", "cost",
            "collectives", "roofline", "model_flops", "useful_flops_frac")
    cells = [{"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
              **{k: c.get(k) for k in keep}} for c in res["cells"]]
    for c in cells + [res["one_rank"]]:
        if c.get("status", "ok") != "ok" or not (c["cost"]["flops_per_chip"] > 0
                                                 and c["cost"]["bytes_per_chip"] > 0):
            fail(f"dryrun: a cell did not end ok with FLOPs and bytes: {c}")
        if c["roofline"]["bottleneck"] not in ("compute", "memory", "collective"):
            fail(f"dryrun: no bottleneck named: {c['roofline']}")
    one = res["one_rank"]
    if one["collectives"]["operand_bytes"] != 0:
        fail(f"dryrun: one rank moved collective bytes: {one['collectives']}")
    step_s = trained["step_seconds"]
    one["measured"] = {
        "step_seconds": step_s, "peak_bytes": trained["peak_bytes"],
        "predicted_over_measured_peak": one["memory"]["peak_bytes"] / trained["peak_bytes"],
        "bound_over_step": one["roofline"]["bound_step_time_s"] / step_s,
        "mfu": one["model_flops"] / (step_s * trace_analysis.PEAK_FLOPS)}
    out = {"card": smi, "wall_s_from_start": time.perf_counter() - run["t0"],
           "peaks": {"flops": trace_analysis.PEAK_FLOPS,
                                  "hbm_bytes_per_s": trace_analysis.HBM_BW,
                                  "link_bytes_per_s": trace_analysis.LINK_BW},
           "cells": cells, "one_rank": one}
    emit("dryrun", out)
    return out


@contextlib.contextmanager
def timed(name: str):
    """Host seconds of a group of phases (``phases`` line)."""
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t0


def main() -> None:
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False     # the library yardstick is float32 too
    smi = phase_env()
    with timed("build"):
        compiled, cases, unstaged, csrc = phase_build(device)
    start_s1_plain(cases)
    with timed("kernels K1, K2"):
        rows = phase_kernels_k1(compiled, device) + phase_kernels_k2(device)
        k2_binding = next(r for r in rows if r["name"] == "matmul[16x16x16,float32]")
        k2_binding["checks"] = [k2_binding_check(compiled, device)]
    with timed("kernels S1"):
        s1_rows = phase_kernels_s1(cases, device)
    with timed("k1_without_staging"):
        phase_k1_without_staging(unstaged, device)
    with timed("build, attention and scans"):
        finish_csrc(csrc)
    # the dry-run: on the host, in a process of its own (no card), beside
    # the phases that follow; its result is read after the train phase
    dry = start_dryrun()
    with timed("kernels K3-K6"):
        k3_rows, k4_rows = phase_kernels_k3(device), phase_kernels_k4(device)
        a = get_config(ARCH).attn
        k4_partial = [k4_partial_case("mesh decode", SLOTS, MAX_LEN, a.n_heads, a.n_kv_heads,
                                      a.d_head, BF16, [s + 1 for s in MESH_START], device,
                                      torch.Generator().manual_seed(SEED + 15))]
        k5_rows, k6_rows = phase_kernels_k5(device), phase_kernels_k6(device)
        k3_256, k4_256 = phase_kernels_d256(device)
        k3_moe, k4_moe = phase_kernels_moe(device)
        k3_mla = phase_kernels_mla(device)
        cross_rows = phase_kernels_cross(device)
    with timed("kernels S3, S4"):
        s3_rows, s4_rows = phase_kernels_s3(device), phase_kernels_s4(device)
    with timed("kernels S2"):
        s2_rows = phase_kernels_s2(device)
        a = get_config(ARCH).attn
        k3_train = k3_case("train", TRAIN_B, TRAIN_S, TRAIN_S, a.n_heads, a.n_kv_heads,
                           a.d_head, BF16, device, torch.Generator().manual_seed(SEED + 11))
    with timed("kernels softcap"):
        k3_cap, k4_cap, s2_cap = phase_kernels_softcap(device)
    torch.cuda.empty_cache()

    # every count to 0, then the compiler's main path, then read the counts
    zero_counts()
    with timed("main_path"):
        per_case = phase_main_path(device)
    totals = {"lower_to_cuda": to_cuda.launches, "matmul": mm.launches}
    for kernel, n in totals.items():
        if n <= 0:
            fail(f"the main path never launched {kernel}")
        if n != sum(v for k, v in per_case.items() if k.startswith(kernel + "[")):
            fail(f"{kernel}: launches per case do not add up to the wrapper's count {n}")
    for row in rows:
        row["launches"] = per_case.get(row["name"], 0)

    # the designer's differential check, the counts at 0 just before it
    zero_counts()
    with timed("differential"):
        per_case = phase_differential(cases, device)
    if sim_cuda.launches != sum(per_case.values()):
        fail(f"rtl_sim: launches per case do not add up to the wrapper's count")
    for row in s1_rows:
        row["launches"] = per_case.get(row["name"], 0)
        if "large" in row:
            row["large"]["launches"] = per_case.get(row["large"]["name"], 0)
            if row["large"]["launches"] <= 0:
                fail(f"the main path never launched {row['large']['name']}")
    emit("s1_gap", s1_gap(s1_rows))

    # the mesh: one rank, NCCL (its own process group where none exists)
    with timed("mesh setup"):
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, device_type="cuda")
    # the serving paths, each phase with the counts at 0 just before it
    # (tinyllama's and qwen2-moe's with their mesh paths)
    with timed(ARCH):
        dense = serve_model(ARCH, device, mesh)
    with timed(MAMBA):
        mamba = serve_model(MAMBA, device)
    with timed(RGEMMA):
        rgemma = serve_model(RGEMMA, device)
    with timed(MOE):
        moe = serve_model(MOE, device, mesh)
    with timed(DEEPSEEK):
        deepseek = serve_model(DEEPSEEK, device)
    cross = {}
    for arch in CROSS_ARCHS:
        with timed(arch):
            cross[arch] = serve_model(arch, device)
    with timed(CAPPED):
        capped = serve_model(CAPPED, device)
    with timed("serve example"):
        phase_serve_example(device)
    # the training paths, each with the counts at 0 just before it
    with timed("train"):
        trained = phase_train(device)
        for arch in list_archs():
            phase_train_card_vs_cpu(device, arch)
        phase_train_grads(device)
        mla_grads = phase_train_grads(device, DEEPSEEK, MLA_GRAD_B, MLA_GRAD_S)
        capped_grads = phase_train_grads(device, CAPPED, TRAIN_B, TRAIN_S)
        example = phase_train_example(device)
    with timed("mesh train"):
        phase_mesh_train(mesh, device)
    torch.distributed.destroy_process_group()
    # every other arch at full width, each with the counts at 0 just before it
    with timed("train archs"):
        archs = phase_train_archs(device)
    with timed("dryrun, what is left of it"):
        phase_dryrun(dry, trained, smi)
    # S3's and S4's rows: the full-width Mamba-2 and RecurrentGemma steps'
    # launches, every one at the row's shape
    for row, arch, kernel in ((s3_rows[0], MAMBA, "ssd_scan_bwd"),
                              (s4_rows[0], RGEMMA, "rglru_scan_bwd")):
        if archs[arch]["shape"] != (row["shape"]["B"], row["shape"]["S"]):
            fail(f"{row['name']}: {arch} trained at {archs[arch]['shape']}")
        row["launches"] = archs[arch]["launches"][kernel]
    # S2's rows: the full-width step's calls, the example's calls and
    # deepseek's MLA gradients', each all of its phase's; K3 at the training
    # shape: the full-width step's
    for row, ran in ((s2_rows[0], trained), (s2_rows[1], example), (s2_rows[2], mla_grads)):
        by_shape = ran["shapes"]["flash_attention_bwd"]
        row["launches"] = by_shape.get(s2_shape_key(row), 0)
        if row["launches"] != ran["launches"]["flash_attention_bwd"]:
            fail(f"{row['name']}: {row['launches']} launches at its shape of "
                 f"{ran['launches']['flash_attention_bwd']} in its phase")
    k3_train["launches"] = trained["shapes"]["flash_attention"].get(shape_key(k3_train), 0)
    if k3_train["launches"] != trained["launches"]["flash_attention"]:
        fail(f"{k3_train['name']}: launches by shape do not add up to the phase's count")
    k3_rows[0]["launches"] = dense["prefill"]["flash_attention"]
    # the consistency rows' cases: tinyllama's in bfloat16; Mamba-2's scan
    # runs in float32 under both of its passes; RecurrentGemma's cut check in float32
    k3_rows[1]["launches"] = dense["consistency"]["bf16"]["flash_attention"]
    k4_rows[0]["launches"] = dense["serve"]["decode_attention"]
    # the sharded decode's partials: all of its phase's K4 launches
    k4_partial[0]["launches"] = dense["mesh_decode"]["partial_shapes"].get(
        shape_key(k4_partial[0]), 0)
    if k4_partial[0]["launches"] != dense["mesh_decode"]["launches"]["decode_attention"]:
        fail(f"{k4_partial[0]['name']}: launches at its shape do not add up to its phase's")
    k4_rows[1]["launches"] = dense["consistency"]["bf16"]["decode_attention"]
    k5_rows[0]["launches"] = mamba["prefill"]["ssd_scan"]
    k5_rows[1]["launches"] = sum(n["ssd_scan"] for n in mamba["consistency"].values())
    k6_rows[0]["launches"] = rgemma["prefill"]["rglru_scan"]
    k6_rows[1]["launches"] = rgemma["consistency"]["f32"]["rglru_scan"]
    k3_256[0]["launches"] = rgemma["prefill"]["flash_attention"]
    k3_256[1]["launches"] = rgemma["consistency"]["f32"]["flash_attention"]
    k4_256[0]["launches"] = rgemma["serve"]["decode_attention"]
    k4_256[1]["launches"] = rgemma["consistency"]["f32"]["decode_attention"]
    # qwen2-moe's: its cut consistency check in bfloat16
    k3_moe[0]["launches"] = moe["prefill"]["flash_attention"]
    k3_moe[1]["launches"] = moe["consistency"]["bf16"]["flash_attention"]
    k4_moe[0]["launches"] = moe["serve"]["decode_attention"]
    k4_moe[1]["launches"] = moe["consistency"]["bf16"]["decode_attention"]
    # deepseek-v2-lite's MLA: its prefill (27 layers) and its cut consistency check in bf16
    k3_mla[0]["launches"] = deepseek["prefill"]["flash_attention"]
    k3_mla[1]["launches"] = deepseek["consistency"]["bf16"]["flash_attention"]
    # the cross models: each row's count is the main path's launches at the
    # row's shape; those must be all the wrapper's, and one kind of layer each
    for arch, (k3, k4) in cross_rows.items():
        n, ran = layers(served_config(arch)), cross[arch]
        calls = ran["serve"]["decode_attention"] // (n["attn"] + n["cross"])
        want = {"prefill": [n["attn"], n["enc"] + n["cross"]],   # self; encoder and cross
                "serve": [n["attn"] * calls, n["cross"] * calls]}  # self; cross, length Tm
        for phase, kernel, pair in (("prefill", "flash_attention", k3),
                                    ("serve", "decode_attention", k4)):
            by_shape = ran[phase + "_shapes"][kernel]
            for row in pair:
                row["launches"] = by_shape.get(shape_key(row), 0)
            if sum(by_shape.values()) != ran[phase][kernel]:
                fail(f"{arch}: {kernel}'s launches by shape do not add up to its count")
            if [row["launches"] for row in pair] != want[phase]:
                fail(f"{arch} {phase}: {kernel} launches by shape "
                     f"{printable(by_shape)}, expected {want[phase]} at "
                     f"{[shape_key(row) for row in pair]}")
        rows += k3 + k4
    # the capped tinyllama's: each row's count is its phase's launches at the
    # row's shape under the cap, and (where the phase runs one shape) all of them
    k3_cap[0]["launches"] = capped["prefill_shapes"]["flash_attention"].get(shape_key(k3_cap[0]), 0)
    k3_cap[1]["launches"] = capped_grads["shapes"]["flash_attention"].get(shape_key(k3_cap[1]), 0)
    k3_cap[2]["launches"] = capped["consistency"]["f32"]["flash_attention"]
    k4_cap[0]["launches"] = capped["serve_shapes"]["decode_attention"].get(shape_key(k4_cap[0]), 0)
    k4_cap[1]["launches"] = capped["consistency"]["f32"]["decode_attention"]
    s2_cap[0]["launches"] = capped_grads["shapes"]["flash_attention_bwd"].get(
        s2_shape_key(s2_cap[0]), 0)
    for row, total in ((k3_cap[0], capped["prefill"]["flash_attention"]),
                       (k3_cap[1], capped_grads["launches"]["flash_attention"]),
                       (k4_cap[0], capped["serve"]["decode_attention"]),
                       (s2_cap[0], capped_grads["launches"]["flash_attention_bwd"])):
        if row["launches"] != total:
            fail(f"{row['name']}: {row['launches']} launches at its shape under the cap, of "
                 f"{total} in its phase")
    emit("softcap", softcap_launches(dense, capped, k3_rows, k4_rows, k3_cap, k4_cap))
    rows += (k3_rows + k4_rows + k4_partial + k5_rows + k6_rows + k3_256 + k4_256 + k3_moe + k4_moe
             + k3_mla + s1_rows + [k3_train] + s2_rows + s3_rows + s4_rows
             + k3_cap + k4_cap + s2_cap)
    for row in rows:
        if row["launches"] <= 0:
            fail(f"the main path never launched {row['name']}")
    emit("phases", PHASE_SECONDS)
    emit("kernels", resolved(rows))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
