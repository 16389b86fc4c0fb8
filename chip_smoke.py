#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them.  It builds
every kernel from the sources in this checkout, holds each against its plain
PyTorch version on the card, then drives:

* the flow a user of the compiler runs — build an HIR design, verify it,
  optimize it, lower it to a generated CUDA kernel, run it on one stimulus
  vector and on 4096 of them, and check the results against the NumPy
  oracle, the cycle-accurate simulator and the functional lowering — and the
  GEMM binding through the hand-written matmul, whose bfloat16 kernel runs on
  wgmma and whose float32 kernel stays exact on integer operands (every
  shape, 4096^3 and a ragged 4000x3992x4104 included);
* serving three models at full width (random weights from a seed) — the
  dense tinyllama-1.1b, the attention-free mamba2-780m and the hybrid
  recurrentgemma-9b: the continuous-batching ``Engine`` answers 8 requests
  over 4 slots (the recurrent two refill in waves), every decode step through
  the decode-attention kernel where the model has attention;
* each model's prefill step: flash attention for tinyllama, the SSD scan for
  Mamba-2, the RG-LRU scan and windowed flash attention (head dim 256) for
  RecurrentGemma;
* the reference's decode-consistency invariant: teacher-forced decode steps
  against the forward pass over the same tokens, at full width (RecurrentGemma
  cut to one group of its pattern, its window cut to 64).

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
and spills (``tools/ptxas_usage.py``).  Output: one JSON object per line (``env``,
``build``, ``k1_without_staging``, ``main_path``, then ``serve``, ``prefill``,
``consistency`` and ``profile`` for each model, ``kernels``), the card's
name and power limit as ``nvidia-smi`` gives them, and a last line
``{"ok": true, "device": {...}}``.  Any mismatch or failure exits non-zero
before that line.
"""

from __future__ import annotations

import dataclasses
import json
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

from repro_torch.core.gallery import (array_add, conv2d, gemm, histogram,  # noqa: E402
                                      stencil1d, transpose)
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

# the one PyTorch call that computes a design's function on the lanes batch,
# where there is one: timed as ``library_ms`` and used nowhere in the port
DESIGN_LIBRARY = {
    "array_add": lambda a, b: torch.add(a, b),                  # int32 wraps alike
    "transpose": lambda a: a.transpose(-1, -2).contiguous(),
}

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
SLOTS, MAX_LEN, REQUESTS, PROMPT, NEW = 4, 1024, 8, 64, 32
# (batch, tokens) of each model's prefill step and of its consistency check
PREFILL = {ARCH: (4, 1024), MAMBA: (4, 2048), RGEMMA: (2, 4096)}
CONSIST = {ARCH: (2, 128), MAMBA: (2, 300), RGEMMA: (2, 160)}
PREFILL_B, PREFILL_S = PREFILL[ARCH]
CONSIST_B, CONSIST_S = CONSIST[ARCH]
# Mamba-2's 300 tokens cross a chunk boundary of 256 and end in a ragged
# chunk.  RecurrentGemma's check is cut to one (rglru, rglru, local_attn)
# group with the window cut to 64, so that its 160 tokens wrap the decode's
# ring and the forward's window masks; float32 only.
RG_CUT_WINDOW = 64
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


def compile_design(gal, size: dict, device):
    """The user's flow up to the callable: build -> verify -> optimize ->
    lower.  Returns (module, entry, callable)."""
    module, name = gal.build(**size)
    diags = verify(module)
    if diags:
        fail(f"verifier rejected {name} {size}: {diags}")
    PassManager.from_spec(DEFAULT_PIPELINE_SPEC).run(module)
    return module, name, lower_to_cuda(module, name, device=device)


_stimulus_cache: dict = {}


def stimulus(gal, size: dict, lanes: int) -> list[np.ndarray]:
    """``lanes`` seeded stimulus vectors, batch first, one array per argument
    (made once per design and size: the phases share them)."""
    key = (gal.__name__, tuple(sorted(size.items())), lanes)
    if key not in _stimulus_cache:
        per_lane = [gal.make_inputs(**size, seed=SEED + s) for s in range(lanes)]
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


def phase_build(device) -> dict:
    """Generate every design's kernel and start one nvcc per source, all at
    once; then wait for them."""
    t0 = time.perf_counter()
    compiled = {}
    pending = [_build.start_build(*_build.csrc_source(src))
               for src in ("matmul.cu", "flash_attention.cu", "decode_attention.cu",
                           "ssd_scan.cu", "rglru_scan.cu")]
    for dname, gal, paper, large in DESIGNS:
        for tag, size in (("paper", paper), ("large", large)):
            module, name, fn = compile_design(gal, size, device)
            compiled[(dname, tag)] = (module, name, fn, size)
            pending.append(_build.start_build(fn.stem, fn.source))
    for p in pending:
        _build.finish_build(p)
    secs = dict(_build.build_seconds)
    secs["_wall"] = time.perf_counter() - t0
    emit("build", secs)
    return compiled


def element_steps(module, name) -> int:
    """Executions of the innermost bodies of the design's main loop (its
    largest-trip top-level loop): the element steps one lane walks."""
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
    library_ms = None
    if dname in DESIGN_LIBRARY:
        lib_call = DESIGN_LIBRARY[dname]
        (kernel_out,) = got.values()
        if not torch.equal(lib_call(*ins), kernel_out):
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
        "library_ms": library_ms,
    }


def phase_kernels_k1(compiled, device) -> list[dict]:
    """Each generated kernel against its plain version, bit-exact, at every
    shape the main path runs: both sizes, 1 lane and ``LANES`` lanes; and,
    as a check no main path runs (``launches: null``), at ``LANES + 1``
    lanes, a last block of one lane."""
    rows = []
    for (dname, tag), (module, name, fn, size) in compiled.items():
        gal = next(g for d, g, _, _ in DESIGNS if d == dname)
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
        cases = [(dname, gal, large) + compile_design(gal, large, device)
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


def phase_main_path(device) -> dict:
    """The flow a user runs, through the public entry points only.  Returns
    the launches each kernel case made, keyed like the ``kernels`` rows."""
    launches: dict[str, int] = {}
    report = []
    for dname, gal, paper, large in DESIGNS:
        for tag, size in (("paper", paper), ("large", large)):
            t0 = time.perf_counter()
            module, name, fn = compile_design(gal, size, device)
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
            report.append({"design": dname, "size": size or "default", "lanes": [1, LANES],
                           "oracle_lanes": LANES, "simulated_lanes": len(idx),
                           "functional_lanes": len(idx), "seconds_to_result": run_s})

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
           "decode_attention": dec, "ssd_scan": ssd_k, "rglru_scan": rg}


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
    t0 = time.perf_counter()
    eng = Engine(cfg, SLOTS, MAX_LEN, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
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
    if cfg.name == RGEMMA:
        first = cfg.segments[0]
        cfg = cfg.scaled(segments=(Segment(first.pattern, 1, first.ffn),),
                         attn=dataclasses.replace(cfg.attn, window=RG_CUT_WINDOW))
        params = dict(params, segments=[[first_repeat(b) for b in params["segments"][0]]])
        cuts = {"pattern": list(first.pattern), "repeats": 1, "weights": "the first repeat's",
                "window": RG_CUT_WINDOW}
        print(f"consistency {RGEMMA}: cut to {cuts}", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=g).to(device)
    out = {"arch": eng.cfg.name, "batch": B, "tokens": S, "cuts": cuts or None}
    n16 = None
    if not cuts:
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


def first_repeat(tree):
    """A block's stacked parameters cut to their first repeat (views)."""
    if isinstance(tree, dict):
        return {k: first_repeat(v) for k, v in tree.items()}
    return tree[:1]


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
    emit("profile", {
        "arch": eng.cfg.name,
        "what": f"lm_decode_step, {SLOTS} lanes at position {PROMPT + NEW}, 8 steps",
        "wall_ms_per_step": wall_us / 8e3,
        "device_ms_per_step": busy_us / 1e3 if busy_us else "not measured",
        "device_idle_share": 1 - busy_us * 8 / wall_us if busy_us else "not measured",
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


def main() -> None:
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False     # the library yardstick is float32 too
    smi = phase_env()
    compiled = phase_build(device)
    rows = phase_kernels_k1(compiled, device) + phase_kernels_k2(device)
    phase_k1_without_staging(device)
    k3_rows, k4_rows = phase_kernels_k3(device), phase_kernels_k4(device)
    k5_rows, k6_rows = phase_kernels_k5(device), phase_kernels_k6(device)
    k3_256, k4_256 = phase_kernels_d256(device)
    torch.cuda.empty_cache()

    # every count to 0, then the compiler's main path, then read the counts
    zero_counts()
    per_case = phase_main_path(device)
    totals = {"lower_to_cuda": to_cuda.launches, "matmul": mm.launches}
    for kernel, n in totals.items():
        if n <= 0:
            fail(f"the main path never launched {kernel}")
        if n != sum(v for k, v in per_case.items() if k.startswith(kernel + "[")):
            fail(f"{kernel}: launches per case do not add up to the wrapper's count {n}")
    for row in rows:
        row["launches"] = per_case.get(row["name"], 0)

    # the serving paths, each phase with the counts at 0 just before it
    dense = serve_model(ARCH, device)
    mamba = serve_model(MAMBA, device)
    rgemma = serve_model(RGEMMA, device)
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
    rows += k3_rows + k4_rows + k5_rows + k6_rows + k3_256 + k4_256
    for row in rows:
        if row["launches"] <= 0:
            fail(f"the main path never launched {row['name']}")
    emit("kernels", rows)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
