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
* serving four models at full width (random weights from a seed) — the
  dense tinyllama-1.1b, the attention-free mamba2-780m, the hybrid
  recurrentgemma-9b and the MoE qwen2-moe-a2.7b (60 routed experts, top-4,
  head dim 128 with a KV head a query head), one after another, each freed
  before the next: the continuous-batching ``Engine`` answers 8 requests
  over 4 slots (the recurrent two refill in waves), every decode step through
  the decode-attention kernel where the model has attention;
* each model's prefill step: flash attention for tinyllama and qwen2-moe,
  the SSD scan for Mamba-2, the RG-LRU scan and windowed flash attention
  (head dim 256) for RecurrentGemma;
* the reference's decode-consistency invariant: teacher-forced decode steps
  against the forward pass over the same tokens, at full width (RecurrentGemma
  cut to one group of its pattern, its window cut to 64; qwen2-moe cut to 8
  layers, at capacity factor 64);
* the designer's differential check (``differential``): the design lowered
  to RTL (``generate_verilog``) and run on the cycle-accurate simulator's
  kernel generated per design, on 4096 stimulus vectors — the reference's
  own matrix (nine designs at the sizes of its test, and the three traced
  designs at the sizes of the frontend's test, x {inline, modules})
  through ``run_differential`` (event-driven simulator on sample lanes, the
  design's oracle on every lane, every RTL pass), cold and warm, and the
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
carry ``cycles``, ``ns_per_cycle``, ``run_ms`` (a whole ``sim.run``, the
stimulus copied to the card and laid out there, the results copied back)
and the state words a lane their byte bound counts; a loop nest's large
size is nested under its paper row, held to its plain version on 16 lanes
spread over the batch, on the CPU (``plain_on``).  Output: one JSON object per line (``env``,
``build``, ``k1_without_staging``, ``main_path``, ``differential``, then
``serve``, ``prefill``, ``consistency`` and ``profile`` for each model,
``kernels``), the card's
name and power limit as ``nvidia-smi`` gives them, and a last line
``{"ok": true, "device": {...}}``.  Any mismatch or failure exits non-zero
before that line.  A ``phases`` line gives the host seconds of each group of
phases.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import inspect
import json
import os
import subprocess
import sys
import time
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
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch.launch.serve import Engine, make_requests, serve_requests  # noqa: E402
from repro_torch.models import ssd, transformer  # noqa: E402
from repro_torch.train.steps import make_prefill_step  # noqa: E402

SEED = 0
LANES = 4096
SAMPLED_LANES = (0, 1, LANES // 2, LANES - 1)
# the lanes a large loop nest's simulator kernel is held to its plain version
# on, on the CPU: 16 spread over the batch, every block's warp a different one
PLAIN_LANES = np.linspace(0, LANES - 1, 16).astype(np.int64)

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,        # float32 outside the tensor cores
              torch.bfloat16: 989e12}      # bf16 tensor cores
# K5's products run on the TF32 tensor cores (494.7 TFLOP/s) in three passes
TF32X3_FLOPS = 494.7e12 / 3

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

# the served models and their traffic: 8 requests of 64-token prompts and 32
# new tokens over 4 slots of a 1024-position cache
ARCH, MAMBA, RGEMMA = "tinyllama-1.1b", "mamba2-780m", "recurrentgemma-9b"
MOE = "qwen2-moe-a2.7b"
SLOTS, MAX_LEN, REQUESTS, PROMPT, NEW = 4, 1024, 8, 64, 32
# (batch, tokens) of each model's prefill step and of its consistency check
PREFILL = {ARCH: (4, 1024), MAMBA: (4, 2048), RGEMMA: (2, 4096), MOE: (4, 1024)}
CONSIST = {ARCH: (2, 128), MAMBA: (2, 300), RGEMMA: (2, 160), MOE: (2, 128)}
PREFILL_B, PREFILL_S = PREFILL[ARCH]
CONSIST_B, CONSIST_S = CONSIST[ARCH]
# Mamba-2's 300 tokens cross a chunk boundary of 256 and end in a ragged
# chunk.  RecurrentGemma's check is cut to one (rglru, rglru, local_attn)
# group with the window cut to 64, so that its 160 tokens wrap the decode's
# ring and the forward's window masks; float32 only.
RG_CUT_WINDOW = 64
# qwen2-moe's check runs at capacity factor 64, as the reference test sets it
# (capacity drops depend on the queue: no drops in either pass), cut to its
# first 8 layers, so that a float32 copy of their weights fits on the card
# beside the served bfloat16 model; bfloat16 and float32, as tinyllama's.
MOE_CUT_LAYERS, MOE_CONSIST_CF = 8, 64.0
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
# and test_ssd_scan's / test_rglru_scan's, against the step-by-step oracles
SCAN_TOL = 2e-4


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


def phase_build(device) -> tuple[dict, list[dict]]:
    """Generate every design's kernels — K1 of each loop nest, S1 of each
    simulated design — and start one nvcc per source, all at once; then wait
    for them.  Returns the compiled loop nests and the simulator cases."""
    t0 = time.perf_counter()
    compiled = {}
    pending = [_build.start_build(*_build.csrc_source(src))
               for src in ("matmul.cu", "flash_attention.cu", "decode_attention.cu",
                           "ssd_scan.cu", "rglru_scan.cu")]
    for dname, gal, paper, large in ALL_DESIGNS:
        for tag, size in (("paper", paper), ("large", large)):
            module, name, fn, _ = compile_design(gal, size, device)
            compiled[(dname, tag)] = (module, name, fn, size)
            pending.append(_build.start_build(fn.stem, fn.source))
    cases = rtl_cases(compiled, device)
    for case in cases:
        kernel = case["sim"].cuda_kernel()
        pending.append(_build.start_build(kernel.stem, kernel.source))
        case["stem"] = pending[-1].name
    for p in pending:
        _build.finish_build(p)
    secs = dict(_build.build_seconds)
    secs["_wall"] = time.perf_counter() - t0
    emit("build", secs)
    return compiled, cases


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


def k1_case(dname, tag, module, name, fn, size, ins, lanes) -> dict:
    """One generated kernel against its plain version, bit-exact."""
    got = fn(*ins)
    torch.cuda.synchronize()
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
    return {
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
            rows.append(k1_case(dname, tag, module, name, fn, size, ins, lanes))
        ragged = [torch.cat([x, x[:1]]) for x in dev_batch]
        check = k1_case(dname, tag, module, name, fn, size, ragged, LANES + 1)
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


def phase_k1_without_staging(device) -> None:
    """What staging buys: each large design's kernel generated with no
    room for staging (so its reads known ahead are only prefetched), held
    bit-exact to its plain version and timed at ``LANES`` lanes beside the
    staged kernel's ``ms`` in the ``kernels`` line.  Outside every main
    path: its launches count nowhere."""
    budget = to_cuda.STAGE_BYTES_PER_PAIR
    to_cuda.STAGE_BYTES_PER_PAIR = 0
    try:
        cases = [(dname, gal, large) + compile_design(gal, large, device)[:3]
                 for dname, gal, _, large in DESIGNS]
    finally:
        to_cuda.STAGE_BYTES_PER_PAIR = budget
    for p in [_build.start_build(fn.stem, fn.source) for *_, fn in cases]:
        _build.finish_build(p)
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
            for s in SAMPLED_LANES:
                sim_args = [np.array(x[s], copy=True) for x in batch]
                simulate(module, name, sim_args)
                if not np.array_equal(sim_args[-1], many_np[s]):
                    fail(f"{dname}/{tag}: lane {s} differs from the simulator")
            idx = list(SAMPLED_LANES)
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


def plain_twin(sim, device=None):
    """The same compiled tape on the plain backend (``_TorchOps``), on the
    same device or on ``device``."""
    twin = copy.copy(sim)
    twin.backend, twin._kernel = "torch", None
    if device is not None:
        twin.device = device
    return twin


def lanes_of(res, idx):
    """The lanes ``idx`` of a simulator result."""
    return dataclasses.replace(
        res, batch=len(idx), arrays={i: a[idx] for i, a in res.arrays.items()},
        returns=[r[idx] for r in res.returns], returns_valid=[v[idx] for v in res.returns_valid],
        conflicts=res.conflicts[idx],
        trace=None if res.trace is None else {n: y[:, idx] for n, y in res.trace.items()})


def s1_words(sim, lay) -> int:
    """Words a lane the run must move at least: each ``st`` word and each
    shift-register ring word read once and written once, each memory word
    read once and written once more where the tape writes that memory."""
    written = {ent[1] for ent in sim.clocked if ent[0] == "memwr"}
    return (2 * (len(lay.slots) + lay.ring_rows)
            + sum(d * (1 + (key in written)) for key, _, d in lay.mems))


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
        t0 = time.perf_counter()
        plain = plain_twin(sim, torch.device("cpu")).run(
            part, cycles, batched=True, trace=True, check_conflicts=False)
        row["plain_ms"] = (time.perf_counter() - t0) * 1e3
        row["plain_on"] = f"cpu, {len(PLAIN_LANES)} of {LANES} lanes"
        same = (same_sim_result(got, plain) and same_sim_result(
            lanes_of(full["res"], PLAIN_LANES), dataclasses.replace(plain, trace=None)))
    if not same:
        fail(f"{case['name']}: the simulator kernel differs from its plain version")
    row["max_abs_err"] = 0
    bufs = kernel.buffers(sim, batch, LANES, device)
    iters = 3 if cycles > 1000 else 10
    row["ms"] = time_ms(lambda: kernel.launch(bufs, LANES, cycles, None, device), iters)
    words = s1_words(sim, kernel.layout)
    row.update({"state_words_moved_per_lane": words,
                "bound_ms": words * LANES * 8 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": None, "cycles": cycles, "ns_per_cycle": row["ms"] * 1e6 / cycles})
    del bufs, full
    return row


def phase_kernels_s1(cases, device) -> list[dict]:
    """Every simulator kernel at its main-path shape; a loop nest's large
    size is nested under its paper row (``large``)."""
    rows, by_name = [], {}
    for case in cases:
        row = s1_case(case, device)
        by_name[(case["design"], case["tag"])] = row
        if case["tag"] == "large":
            by_name[(case["design"], "paper")]["large"] = row
        else:
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


def phase_differential(cases, device) -> dict:
    """The designer's check on the card, through the public entry points:
    ``run_differential`` on 4096 vectors for the reference's matrix (the
    kernel over the whole batch, the event-driven simulator on sample lanes,
    the design's oracle on every lane, every RTL pass on 16 lanes), cold and
    warm; then each loop nest at both sizes through ``simulator_for`` with
    its final arrays held to ``lower_to_cuda`` on every lane.  Returns the
    launches of each case."""
    launches: dict[str, int] = {}
    matrix, nests = [], []
    for case in cases:
        dname, entry, module, batch = case["design"], case["entry"], case["module"], case["batch"]
        before = sim_cuda.launches
        if case["tag"] == "matrix":
            oracle, nargs = RTL_MATRIX[dname][3]
            seconds = []
            for _ in ("cold", "warm"):
                t0 = time.perf_counter()
                rep = rtl_sim.run_differential(module, entry, batch, kernel=dname,
                                               hierarchy=case["hierarchy"], oracle=oracle,
                                               oracle_nargs=nargs, device=device)
                seconds.append(time.perf_counter() - t0)
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
                           "seconds_to_result_cold": seconds[0],
                           "nvcc_s": _build.build_seconds.get(case["stem"], 0.0),
                           "seconds_to_result_warm": seconds[1]})
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


def bound(flops: float, nbytes: float, dtype, rate=None) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the operations at ``rate`` (the
    dtype's peak unless given) and the bytes at the memory's rate."""
    t_ops, t_bytes = flops / (rate or PEAK_FLOPS[dtype]), nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def seeded(shape, dtype, device, g) -> torch.Tensor:
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


def k3_case(case: str, B, Sq, Sk, H, KvH, D, dtype, device, g, *, window=None,
            kv_len=None) -> dict:
    """The flash-attention kernel, causal, against its plain version and
    against SDPA on the same (B,H,S,D) views of model-layout tensors."""
    q = seeded((B, Sq, H, D), dtype, device, g).transpose(1, 2)
    k, v = (seeded((B, Sk, KvH, D), dtype, device, g).transpose(1, 2) for _ in range(2))
    kwargs = dict(causal=True, window=window, kv_len=kv_len)
    got = fa.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, **kwargs)
    name = f"flash_attention[{case} {B}x{Sq}x{Sk} H{H}/{KvH} D{D} {dtype_name(dtype)}]"
    err = check_close(name, got, want, dtype)
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    valid = (k_pos <= q_pos) & (k_pos < (kv_len or Sk))
    if window is not None:
        valid &= k_pos > q_pos - window
    if window is None and kv_len is None:
        library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=valid, enable_gqa=True)
    check_close(f"{name}: the library call", library(), want, dtype)
    es = q.element_size()
    pairs = int(valid.sum())                      # (query, key) pairs this mask lets through
    flops = 4.0 * B * H * pairs * D               # two products, a multiply and an add each
    nbytes = (2 * B * H * Sq * D + 2 * B * KvH * (kv_len or Sk) * D) * es
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    kernel = lambda: fa.flash_attention(q, k, v, **kwargs)
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96", "kernel": fa.KERNEL[dtype],
        "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KvH": KvH, "D": D,
                  "dtype": dtype_name(dtype), "causal": True, "window": window, "kv_len": kv_len},
        "launches": None, "max_abs_err": err, "tolerance": f"{ATTN_TOL[dtype]} + {ATTN_TOL[dtype]}*|plain|",
        "ms": time_ms(kernel, 20),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kwargs), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(library, 20),
        **device_times(kernel, library),
    }


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


def k4_case(case: str, B, L, H, KvH, D, dtype, lengths, device, g) -> dict:
    """The decode-attention kernel against its plain version and against SDPA
    with a boolean mask, on one query token per lane."""
    q = seeded((B, H, D), dtype, device, g)
    k, v = (seeded((B, L, KvH, D), dtype, device, g) for _ in range(2))
    n = torch.tensor(lengths, dtype=torch.int32, device=device) if isinstance(lengths, list) \
        else lengths
    got = ops.decode(q, k, v, n)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, k, v, n)
    per_lane = torch.broadcast_to(torch.as_tensor(n, device=device), (B,))
    name = f"decode_attention[{case} {B}x{L} H{H}/{KvH} D{D} {dtype_name(dtype)}]"
    err = check_close(name, got, want, dtype)
    mask = (torch.arange(L, device=device)[None, :] < per_lane[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    library = lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt, attn_mask=mask,
                                                     enable_gqa=True)[:, :, 0]
    check_close(f"{name}: the library call", library(), want, dtype)
    rows_read = int(per_lane.clamp(max=L).sum())  # cache rows the lanes attend to
    es = q.element_size()
    bound_ms, bound_by = bound(4.0 * H * D * rows_read,
                               (2 * B * H * D + 2 * rows_read * KvH * D) * es, dtype)
    kernel = lambda: ops.decode(q, k, v, n)
    groups = B * dec.groups(H, KvH)
    chunk, n_chunks = dec.split(L, groups, D, torch.cuda.get_device_properties(device)
                                .multi_processor_count)
    return {
        "name": name, "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:73", "kernel": dec.KERNEL[dtype],
        "shape": {"B": B, "L": L, "H": H, "KvH": KvH, "D": D, "dtype": dtype_name(dtype),
                  "length": lengths},
        "split": {"chunk": chunk, "chunks": n_chunks, "blocks": n_chunks * groups},
        "launches": None, "max_abs_err": err, "tolerance": f"{ATTN_TOL[dtype]} + {ATTN_TOL[dtype]}*|plain|",
        "ms": time_ms(kernel, 50),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, n), 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(library, 50),
        **device_times(kernel, library),
    }


def partial_merge_check(device, g) -> dict:
    """``decode_partial`` equals its plain version (``normalize=False``) in
    float32, and over 4 sequence shards, merged by ``merge_partials``, equals
    the full decode to 1e-5."""
    B, L, S = SLOTS, MAX_LEN, 4
    a = get_config(ARCH).attn
    q = seeded((B, a.n_heads, a.d_head), F32, device, g)
    k, v = (seeded((B, L, a.n_kv_heads, a.d_head), F32, device, g) for _ in range(2))
    n = torch.tensor([1, 100, 513, 1024], dtype=torch.int32, device=device)
    plain_err = max(check_close(f"decode_partial {B}x{L} float32: {what}", got, want, F32)
                    for what, got, want in zip(("acc", "m", "l"), ops.decode_partial(q, k, v, n),
                                               ref.decode_attention_ref(q, k, v, n,
                                                                        normalize=False)))
    full = ops.decode(q, k, v, n)
    w = L // S
    parts = [ops.decode_partial(q, k[:, s * w:(s + 1) * w], v[:, s * w:(s + 1) * w],
                                (n - s * w).clamp(0, w)) for s in range(S)]
    merged = ops.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    err = float((merged - full).abs().max())
    if not err <= 1e-5:
        fail(f"decode_partial over {S} shards merged differs from the full decode by {err}")
    return {"case": f"decode_partial vs plain, and x{S} shards + merge_partials, "
                    f"{B}x{L} float32",
            "max_abs_err_vs_plain": plain_err, "tolerance_vs_plain": "2e-05 + 2e-05*|plain|",
            "max_abs_err": err, "tolerance": 1e-5}


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
    128), K4 at its serving cache and at the consistency check; the prefill
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
        "plain_ms": time_ms(lambda: ref.ssd_scan_ref(x, dA, Bc, Cc), 2),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,                    # no one PyTorch call computes the scan
    }


def stage_profile(fn, calls: int = 5) -> dict:
    """K5's kernels as ``torch.profiler`` traces ``calls`` calls: each
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
    times = {stage: 0.0 for stage in ssd_k.STAGES}
    counts = {stage: 0 for stage in ssd_k.STAGES}
    for e in prof.key_averages():
        for stage in ssd_k.STAGES:
            if stage in e.key and e.self_device_time_total > 0:
                times[stage] += e.self_device_time_total / calls / 1e3
                counts[stage] += e.count
    if not any(counts.values()):
        return {"stage_device_ms": "not measured", "stage_launches_per_call": "not measured",
                "cuda_launches_per_call": "not measured"}
    return {"stage_device_ms": {k: v for k, v in times.items() if counts[k]},
            "stage_launches_per_call": {k: n / calls for k, n in counts.items()},
            "cuda_launches_per_call": sum(counts.values()) / calls}


def ptxas_rows(source: str) -> list[dict]:
    """Registers and spills of each kernel of a source (``tools/ptxas_usage.py``)."""
    from tools.ptxas_usage import usage

    return [{"kernel": r["kernel"].split("(")[0].split("::")[-1], "registers": r["registers"],
             "spill_stores": r["spill_stores"], "spill_loads": r["spill_loads"]}
            for r in usage(source)]


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
    at its consistency check (2 x 300: a ragged second chunk), then checks:
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
        "plain_ms": time_ms(lambda: ref.rglru_scan_ref(a, b), 2),
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


# -- serving ------------------------------------------------------------------------

KERNELS = {"lower_to_cuda": to_cuda, "matmul": mm, "flash_attention": fa,
           "decode_attention": dec, "ssd_scan": ssd_k, "rglru_scan": rg, "rtl_sim": sim_cuda}


def zero_counts() -> None:
    for module in KERNELS.values():
        module.launches = 0


def counts() -> dict:
    return {name: module.launches for name, module in KERNELS.items()}


def layers(cfg) -> dict:
    """Blocks of the model that run each kernel: attention (K3 in a forward,
    K4 in a decode step), SSD (K5 in a forward), RG-LRU (K6 in a forward)."""
    kinds = [k for s in cfg.segments for k in s.pattern * s.repeats]
    return {"attn": sum(k in ("attn", "local_attn") for k in kinds),
            "ssd": kinds.count("ssd"), "rglru": kinds.count("rglru")}


def expect(what: str, n: dict, **want) -> None:
    """Fail unless the launch counts are ``want``, every other count 0."""
    full = {k: want.get(k, 0) for k in KERNELS}
    if n != full:
        fail(f"{what}: launches {n}, expected {full}")


def forward_launches(cfg, passes: int = 1) -> dict:
    n = layers(cfg)
    return {"flash_attention": passes * n["attn"], "ssd_scan": passes * n["ssd"],
            "rglru_scan": passes * n["rglru"]}


def phase_serve(arch: str, device):
    """The Engine at full width answers the requests; K4 runs in every decode
    step, prefill's included, once per attention layer.  The recurrent
    models refill in waves: 2 waves of 64 prompt positions and 32 steps."""
    cfg = get_config(arch)
    free, total = torch.cuda.mem_get_info(device)
    outside = total - free - torch.cuda.memory_reserved(device)   # context, local memory
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    eng = Engine(cfg, SLOTS, MAX_LEN, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(device)
    queue = make_requests(REQUESTS, PROMPT, NEW, cfg.vocab, seed=SEED)
    zero_counts()
    t0 = time.perf_counter()
    done, steps = serve_requests(eng, queue)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = counts()
    tokens = sum(len(r.out) for r in done)
    if len(done) != REQUESTS or any(len(r.out) != NEW for r in done):
        fail(f"serve {arch}: {len(done)} requests done, new tokens {[len(r.out) for r in done]}")
    if not all(0 <= tok < cfg.padded_vocab for r in done for tok in r.out):
        fail(f"serve {arch}: a token outside the model's output vocabulary")
    if eng.wave and eng.decode_calls != REQUESTS // SLOTS * (PROMPT + NEW):
        fail(f"serve {arch}: {eng.decode_calls} decode calls for waves of {SLOTS} requests")
    expect(f"serve {arch}", n, decode_attention=layers(cfg)["attn"] * eng.decode_calls)
    emit("serve", {"arch": arch, "params": transformer.param_count(eng.params),
                   "layers": layers(cfg), "waves": eng.wave,
                   "slots": SLOTS, "max_len": MAX_LEN, "requests": len(done),
                   "prompt_tokens": PROMPT, "tokens": tokens, "decode_steps": steps,
                   "decode_calls": eng.decode_calls, "seconds": secs,
                   "tokens_per_s": tokens / secs,
                   "ms_per_decode_call": secs * 1e3 / eng.decode_calls,
                   "init_seconds": init_s, "launches": n,
                   "param_bytes": param_bytes(eng.params),
                   "peak_bytes_init": init_peak, "bytes_outside_the_allocator": outside,
                   "peak_bytes_serving": torch.cuda.max_memory_allocated(device),
                   "first_outputs": [r.out[:8] for r in done[:2]]})
    return eng, n


def phase_prefill(eng, device):
    """The prefill step on the served weights: each forward kernel once per
    layer that runs it."""
    cfg = eng.cfg
    B, S = PREFILL[cfg.name]
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=g)
    step = make_prefill_step(cfg, device=device)
    zero_counts()
    t0 = time.perf_counter()
    logits = step(eng.params, {"tokens": tokens})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = counts()
    if logits.shape != (B, S, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill {cfg.name}: logits {tuple(logits.shape)} not finite or of the wrong shape")
    expect(f"prefill {cfg.name}", n, **forward_launches(cfg))
    emit("prefill", {"arch": cfg.name, "batch": B, "seq": S, "seconds": secs,
                     "tokens_per_s": B * S / secs, "launches": n,
                     "max_abs_logit": float(logits.float().abs().max())})
    return n


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


def teacher_forced(params, cfg, tokens, device):
    """(forward logits, teacher-forced decode logits) over ``tokens``."""
    fwd, _ = transformer.lm_forward(params, {"tokens": tokens}, cfg)
    cache = transformer.init_lm_cache(cfg, tokens.shape[0], tokens.shape[1], device=device)
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
    cut to 64, in float32."""
    cfg, params = eng.cfg, eng.params
    B, S = CONSIST[cfg.name]
    cuts = {}
    if cfg.name == MOE:
        seg = cfg.segments[0]
        cfg = cfg.scaled(segments=(Segment(seg.pattern, MOE_CUT_LAYERS, seg.ffn),),
                         moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CONSIST_CF))
        params = dict(params, segments=[[first_repeats(b, MOE_CUT_LAYERS)
                                         for b in params["segments"][0]]])
        cuts = {"pattern": list(seg.pattern), "repeats": MOE_CUT_LAYERS,
                "weights": f"the first {MOE_CUT_LAYERS} layers'",
                "capacity_factor": MOE_CONSIST_CF}
        print(f"consistency {MOE}: cut to {cuts}", flush=True)
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
    out = {"arch": eng.cfg.name, "batch": B, "tokens": S, "cuts": cuts or None}
    n16 = None
    if cfg.name != RGEMMA:                        # RecurrentGemma's cut check: float32 only
        zero_counts()
        fwd16, dec16 = teacher_forced(params, cfg, tokens, device)
        n16 = counts()
        expect(f"consistency {cfg.name} bf16", n16, **forward_launches(cfg),
               decode_attention=layers(cfg)["attn"] * S)
    zero_counts()
    cfg32 = cfg.scaled(dtype="float32")
    fwd32, dec32 = teacher_forced(as_float32(params), cfg32, tokens, device)
    n32 = counts()
    expect(f"consistency {cfg.name} f32", n32, **forward_launches(cfg),
           decode_attention=layers(cfg)["attn"] * S)
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
    device's idle share over 8 steps at the served shape."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.ones((SLOTS, 1), dtype=torch.int32)
    pos = torch.full((SLOTS,), PROMPT + NEW, dtype=torch.int32)

    def step():
        transformer.lm_decode_step(eng.params, eng.cache, toks, pos, eng.cfg)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    by_kernel = sorted(((e.key, e.self_device_time_total / 8) for e in device_events),
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
        m = cfg.moe
        expert_bytes = (layers(cfg)["attn"] * m.n_routed * 3 * cfg.d_model * m.d_ff_expert
                        * eng.params["segments"][0][0]["ffn"]["w_gate"].element_size())
        bounds.update({"expert_bytes_per_step": expert_bytes,
                       "expert_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3})
    emit("profile", {
        "arch": eng.cfg.name,
        "what": f"lm_decode_step, {SLOTS} lanes at position {PROMPT + NEW}, 8 steps",
        "wall_ms_per_step": wall_us / 8e3,
        "device_ms_per_step": busy_us / 1e3 if busy_us else "not measured",
        "device_idle_share": 1 - busy_us * 8 / wall_us if busy_us else "not measured",
        **bounds,
        "decode_attention_ms_per_step": sum(t for k, t in by_kernel
                                            if any(name in k for name in dec.KERNEL.values())) / 1e3,
        "top_kernels_ms_per_step": [[k[:80], t / 1e3] for k, t in by_kernel[:8]]})


def serve_model(arch: str, device) -> dict:
    """Serve, prefill, consistency and profile of one model; frees it after.
    Returns the launches of each phase."""
    eng, served = phase_serve(arch, device)
    prefilled = phase_prefill(eng, device)
    consistent = phase_consistency(eng, device)
    phase_profile(eng)
    del eng
    torch.cuda.empty_cache()
    return {"serve": served, "prefill": prefilled, "consistency": consistent}


PHASE_SECONDS: dict[str, float] = {}


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
        compiled, cases = phase_build(device)
    with timed("kernels K1, K2"):
        rows = phase_kernels_k1(compiled, device) + phase_kernels_k2(device)
        k2_binding = next(r for r in rows if r["name"] == "matmul[16x16x16,float32]")
        k2_binding["checks"] = [k2_binding_check(compiled, device)]
    with timed("kernels S1"):
        s1_rows = phase_kernels_s1(cases, device)
    with timed("k1_without_staging"):
        phase_k1_without_staging(device)
    with timed("kernels K3-K6"):
        k3_rows, k4_rows = phase_kernels_k3(device), phase_kernels_k4(device)
        k5_rows, k6_rows = phase_kernels_k5(device), phase_kernels_k6(device)
        k3_256, k4_256 = phase_kernels_d256(device)
        k3_moe, k4_moe = phase_kernels_moe(device)
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

    # the serving paths, each phase with the counts at 0 just before it
    with timed(ARCH):
        dense = serve_model(ARCH, device)
    with timed(MAMBA):
        mamba = serve_model(MAMBA, device)
    with timed(RGEMMA):
        rgemma = serve_model(RGEMMA, device)
    with timed(MOE):
        moe = serve_model(MOE, device)
    k3_rows[0]["launches"] = dense["prefill"]["flash_attention"]
    # the consistency rows' cases: tinyllama's in bfloat16; Mamba-2's scan
    # runs in float32 under both of its passes; RecurrentGemma's cut check in float32
    k3_rows[1]["launches"] = dense["consistency"]["bf16"]["flash_attention"]
    k4_rows[0]["launches"] = dense["serve"]["decode_attention"]
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
    rows += (k3_rows + k4_rows + k5_rows + k6_rows + k3_256 + k4_256 + k3_moe + k4_moe
             + s1_rows)
    for row in rows:
        if row["launches"] <= 0:
            fail(f"the main path never launched {row['name']}")
    emit("phases", PHASE_SECONDS)
    emit("kernels", rows)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
