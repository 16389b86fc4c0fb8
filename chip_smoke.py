#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them.  It builds
every kernel from the sources in this checkout, holds each against its plain
PyTorch version on the card, then drives the flow a user of the compiler
runs — build an HIR design, verify it, optimize it, lower it to a generated
CUDA kernel, run it on one stimulus vector and on 4096 of them, and check
the results against the NumPy oracle, the cycle-accurate simulator and the
functional lowering — and the GEMM binding through the hand-written matmul.

Output: one JSON object per line (``env``, ``build``, ``kernels``,
``main_path``), the card's name and power limit as ``nvidia-smi`` gives
them, and a last line ``{"ok": true, "device": {...}}``.  Any mismatch or
failure exits non-zero before that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.gallery import (array_add, conv2d, gemm, histogram,  # noqa: E402
                                      stencil1d, transpose)
from repro_torch.core.lower import lower_to_cuda, lower_to_torch, simulate  # noqa: E402
from repro_torch.core.lower import to_cuda  # noqa: E402
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager  # noqa: E402
from repro_torch.core.verifier import verify  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

SEED = 0
LANES = 4096
SAMPLED_LANES = (0, 1, LANES // 2, LANES - 1)

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,        # float32 outside the tensor cores
              torch.bfloat16: 989e12}      # bf16 tensor cores

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
# shapes the tests use, and a full-width product
MATMUL_SHAPES = [
    (16, 16, 16, dict(bm=16, bn=16, bk=16)),
    (8, 8, 8, dict(bm=128, bn=128, bk=128)),
    (100, 130, 70, dict(bm=128, bn=128, bk=128)),
    (4096, 4096, 4096, dict(bm=128, bn=128, bk=16)),
]
MATMUL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # relative to |plain|max


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
    pending = [_build.start_build(*_build.csrc_source("matmul.cu"))]
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


def phase_kernels_k1(compiled, device) -> list[dict]:
    """Each generated kernel against its plain version, bit-exact, at every
    shape the main path runs: both sizes, 1 lane and ``LANES`` lanes."""
    rows = []
    for (dname, tag), (module, name, fn, size) in compiled.items():
        gal = next(g for d, g, _, _ in DESIGNS if d == dname)
        n_in = n_read_ports(module, name)
        batch = stimulus(gal, size, LANES)[:n_in]
        dev_batch = [torch.as_tensor(x).to(device=device, dtype=torch.int32) for x in batch]
        for lanes in (1, LANES):
            ins = dev_batch if lanes > 1 else [x[0] for x in dev_batch]
            got = fn(*ins)
            torch.cuda.synchronize()
            plain = {}
            plain_ms = wall_ms(lambda: plain.update(fn.plain(*ins)))
            want = plain
            err = 0
            for k in want:
                if got[k].shape != want[k].shape or got[k].dtype != want[k].dtype:
                    fail(f"K1 {dname}/{tag}/{lanes}: shape or dtype differs from plain")
                err = max(err, int((got[k].long() - want[k].long()).abs().max()))
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
            nbytes = lanes * 4 * sum(int(np.prod(a.type.shape))
                                     for a in module.get(name).args)
            rows.append({
                "name": f"lower_to_cuda[{dname},{tag},{lanes} lanes]", "route": "cuda",
                "source": "src/repro_torch/core/lower/to_cuda.py",
                "replaces": "src/repro/core/lower/to_pallas.py:200",
                "shape": {"design": dname, "size": size or "default", "lanes": lanes},
                "launches": 0, "max_abs_err": err, "tolerance": 0,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": library_ms,
            })
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
    for M, K, N, tiles in MATMUL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
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
            iters = 5 if M >= 1024 else 50
            flops, nbytes = 2.0 * M * N * K, (M * K + K * N + M * N) * x.element_size()
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
            rows.append({
                "name": f"matmul[{M}x{K}x{N},{str(dtype).split('.')[-1]}]", "route": "cuda",
                "source": "src/repro_torch/csrc/matmul.cu",
                "replaces": "src/repro/kernels/matmul.py:71",
                "shape": {"M": M, "K": K, "N": N, "dtype": str(dtype), **tiles},
                "launches": 0, "max_abs_err": err, "tolerance": limit,
                "ms": time_ms(lambda: ops.matmul(x, y, **tiles), iters),
                "plain_ms": time_ms(lambda: ref.matmul_ref(x, y), iters),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": time_ms(lambda: torch.matmul(x, y), iters),
            })
    return rows


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
    for M, K, N, tiles in MATMUL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
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


def main() -> None:
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False     # the library yardstick is float32 too
    smi = phase_env()
    compiled = phase_build(device)
    rows = phase_kernels_k1(compiled, device) + phase_kernels_k2(device)

    # every count to 0, then the main path, then read the counts
    to_cuda.launches = 0
    mm.launches = 0
    per_case = phase_main_path(device)
    totals = {"lower_to_cuda": to_cuda.launches, "matmul": mm.launches}
    for kernel, n in totals.items():
        if n <= 0:
            fail(f"the main path never launched {kernel}")
        if n != sum(v for k, v in per_case.items() if k.startswith(kernel + "[")):
            fail(f"{kernel}: launches per case do not add up to the wrapper's count {n}")
    for row in rows:
        row["launches"] = per_case.get(row["name"], 0)
        if row["launches"] <= 0:
            fail(f"the main path never launched {row['name']}")
    emit("kernels", rows)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
