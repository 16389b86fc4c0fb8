"""S4 (``rglru_bwd_kernel``) built with other tile depths, timed in turns on
the card against the shipped build: how the depth ``BWD_STEPS`` (steps a
warp takes in one tile; a tile is 8 warps, its double buffer 2 x 3 x 8 x
STEPS x 32 floats, so STEPS sets the blocks an SM) was chosen.

Each variant is ``csrc/rglru_scan.cu`` with ``BWD_STEPS`` replaced, built
under a stem of its own.  Every variant's da and db must equal the shipped
kernel's within 2e-4 of their largest |value| (the sums are composed in
another grouping).  Times: one replay of a CUDA graph of 20 calls, over 20,
in the order shipped, variants, variants reversed, shipped.  Prints one JSON
line per (variant, shape) and the card's name and power limit.

Run on the machine with the card:
    PYTHONPATH=src python tools/rglru_bwd_variants.py [STEPS ...]
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rglru_scan as rg
from ptxas_usage import usage   # beside this script

SHAPES = [(2, 2048, 4096), (2, 4096, 4096), (2, 1000, 4000), (2, 100, 48)]


def variant(steps: int):
    """(launcher, workspace bytes) of S4 built with ``steps`` a warp."""
    stem, text = _build.csrc_source("rglru_scan.cu")
    old = f"constexpr int BWD_STEPS = {rg.BWD_STEPS};"
    if old not in text:
        raise SystemExit(f"{old!r} not in rglru_scan.cu")
    text = text.replace(old, f"constexpr int BWD_STEPS = {steps};")
    name = f"{stem}_steps{steps}"
    lib = _build.load_library(name, text)
    regs = [r for r in usage(str(_build.build_dir() / f"{name}_{_build.source_hash(text)}.cu"))
            if "rglru_bwd_kernel" in r["kernel"]]
    print(json.dumps({"steps": steps, "registers": regs[0]["registers"],
                      "spill_stores": regs[0]["spill_stores"]}), flush=True)
    fn = _build.bind(lib, "launch_rglru_scan_bwd_f32", rg._ARGTYPES[rg._BWD_SYMBOL])
    work = _build.bind(lib, "rglru_scan_bwd_workspace_bytes", rg._ARGTYPES[rg._WORK_SYMBOL])
    work.restype = ctypes.c_longlong
    return fn, work


def call(fn, work, a, h, dh):
    B, S, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    strides = (ctypes.c_longlong * 10)(*(s for t in (a, h, dh, da, db) for s in t.stride()[:2]))
    n = work(B, S, D)
    ws = torch.empty(n, dtype=torch.uint8, device=a.device)
    rc = _build.on_device(a.device, fn, a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                          da.data_ptr(), db.data_ptr(), B, S, D, strides, ws.data_ptr(), n)
    _build.check_launch(rc, "launch_rglru_scan_bwd_f32")
    return da, db


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def main() -> None:
    steps = [int(x) for x in sys.argv[1:]] or [8, 16]
    dev = torch.device("cuda", 0)
    shipped = (rg.BWD_STEPS, *variant(rg.BWD_STEPS))
    others = [(s, *variant(s)) for s in steps]
    g = torch.Generator(device="cpu").manual_seed(5)
    for B, S, D in SHAPES:
        a = (torch.rand((B, S, D), generator=g) * 0.499 + 0.5).to(dev)
        b, dh = (torch.randn((B, S, D), generator=g).to(dev) for _ in range(2))
        h = rg.rglru_scan(a, b)
        want = call(*shipped[1:], a, h, dh)
        for st, fn, work in others:
            got = call(fn, work, a, h, dh)
            for x, w in zip(got, want):
                err = float((x - w).abs().max())
                if not err <= 2e-4 * float(w.abs().max()):
                    raise SystemExit(f"{st} at {(B, S, D)}: differs by {err}")
        order = [shipped] + others + others[::-1] + [shipped]
        times: dict[int, list[float]] = {}
        for st, fn, work in order:
            times.setdefault(st, []).append(graph_ms(lambda: call(fn, work, a, h, dh)))
        for st, ts in times.items():
            print(json.dumps({"shape": [B, S, D], "steps": st, "shipped": st == rg.BWD_STEPS,
                              "device_ms": ts, "bound_ms": 20 * B * S * D / 3.35e12 * 1e3}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)


if __name__ == "__main__":
    main()
