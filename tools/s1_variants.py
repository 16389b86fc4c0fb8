"""S1 (the simulator's generated kernel) built in other ways, timed in turns
on the card against the shipped source.

Variants (named on the command line; ``i64`` by default):

* ``i64``: the same 4-byte state words, every expression node computed in
  64 bits (each 4-byte load widened where it is read, each store narrowed):
  what the generator's 32-bit node typing is worth on its own;
* ``unroll<N>``: the cycle loop unrolled N times (``#pragma unroll N``):
  whether letting the compiler see several simulated cycles at once hides
  the global-memory round trip of the designs whose arrays stay there.

Each variant is built under a stem of its own, on the five loop nests at
their large sizes (after the optimizer, as ``chip_smoke.py`` builds them)
and on array_add, histogram, gemm, gemm_shared, conv2d and frontend_matmul
at the sizes of the tests (unoptimized), over 4096 lanes; with ``small``
on the command line, on the test sizes alone.  Every variant's final state
equals the shipped kernel's, word for word.  Times, in the order shipped,
variants, variants reversed, shipped: ``ms`` by CUDA events over 10
launches (3 for runs over 1000 cycles), the host's launch work included,
as ``chip_smoke.py`` times a row; ``host_us``, the host's time to issue
one of those launches (``SimKernel.launch`` returning); ``device_ms`` by
one replay of a CUDA graph of as many launches.  Prints one JSON line per
(design, variant) and the card's name and power limit.

Run on the machine with the card:
    PYTHONPATH=src python tools/s1_variants.py [small] [i64] [unroll2 ...]
With no variant named (``shipped`` or ``small`` alone) it times the shipped
kernel alone, so that two trees can be compared with the same script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import gallery
from repro_torch.core.codegen import sim as rtl_sim
from repro_torch.core.codegen import sim_cuda
from repro_torch.core.codegen.sim_cuda import SimKernel
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager
from repro_torch.kernels import _build

LANES = 4096
# design, sizes, whether the optimizer runs first
DESIGNS = [("array_add", {"n": 4096}, True), ("transpose", {"n": 64}, True),
           ("stencil1d", {"n": 4096}, True), ("histogram", {"n": 4096, "bins": 256}, True),
           ("conv2d", {"h": 64, "w": 64}, True),
           ("array_add", {"n": 8}, False), ("histogram", {"n": 8, "bins": 4}, False),
           ("gemm", {"n": 4}, False), ("gemm_shared", {"n": 4}, False),
           ("conv2d", {"h": 6, "w": 6}, False), ("frontend_matmul", {}, False)]
LOOP = "  for (int t = 0; t < T; ++t) {"


def copy_of(kernel: SimKernel, source: str, suffix: str) -> SimKernel:
    k = SimKernel.__new__(SimKernel)
    k.__dict__.update(kernel.__dict__)
    k.source, k.stem = source, f"{kernel.stem}_{suffix}"
    k._launcher, k.launches = None, 0
    return k


def variant(sim, kernel: SimKernel, name: str) -> SimKernel:
    """A copy of ``kernel`` built as the variant ``name``."""
    if name == "i64":
        typed = sim_cuda._Graph.settle

        def settle(self, roots):
            typed(self, roots)
            for n in self.nodes:
                if id(n) in self.live and n.code is None:     # a load keeps its word
                    n.ty = "i64"

        sim_cuda._Graph.settle = settle
        try:
            source = SimKernel(sim).source
        finally:
            sim_cuda._Graph.settle = typed
        return copy_of(kernel, source, name)
    if name.startswith("unroll"):
        if LOOP not in kernel.source:
            raise SystemExit("the cycle loop is not where this tool looks for it")
        return copy_of(kernel, kernel.source.replace(
            LOOP, f"#pragma unroll {int(name[6:])}\n{LOOP}"), name)
    raise SystemExit(f"unknown variant {name!r}")


def time_ms(fn, iters: int) -> tuple[float, float]:
    """(ms a call by CUDA events, µs the host takes to issue a call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e6 / iters


def graph_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return time_ms(g.replay, 1)[0] / calls


def main() -> None:
    args = sys.argv[1:]
    names = [a for a in args if a not in ("shipped", "small")] if args else ["i64"]
    dev = torch.device("cuda", 0)
    for name, size, optimize in DESIGNS:
        if "small" in args and optimize:
            continue
        gal = gallery.GALLERY[name]
        module, entry = gal.build(**size)
        if optimize:
            PassManager.from_spec(DEFAULT_PIPELINE_SPEC).run(module)
        sim, prepared = rtl_sim.simulator_for(module, entry, device=dev)
        batch = rtl_sim.stack_stimulus(gal.make_inputs, LANES, base_seed=7, **size)
        cycles = rtl_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
        shipped = sim.cuda_kernel()
        kernels = [("shipped", shipped)] + [(v, variant(sim, shipped, v)) for v in names]
        for _, k in kernels:
            _build.start_build(k.stem, k.source)
        finals = {}
        for v, k in kernels:
            bufs = k.buffers(sim, batch, LANES, dev)
            k.launch(bufs, LANES, cycles, None, dev)
            finals[v] = {n: b.cpu().numpy() for n, b in bufs.items()}
        for v in names:
            if any(not np.array_equal(finals[v][n], finals["shipped"][n]) for n in finals[v]):
                raise SystemExit(f"{name}: {v} differs from the shipped kernel")
        iters = 3 if cycles > 1000 else 10
        times: dict[str, dict[str, list[float]]] = {}
        for v, k in kernels + kernels[::-1]:
            bufs = k.buffers(sim, batch, LANES, dev)
            fn = lambda: k.launch(bufs, LANES, cycles, None, dev)   # noqa: E731
            t = times.setdefault(v, {"ms": [], "host_us": [], "device_ms": []})
            ms, host_us = time_ms(fn, iters)
            t["ms"].append(ms)
            t["host_us"].append(host_us)
            t["device_ms"].append(graph_ms(fn, iters))
        lay = getattr(shipped, "layout", None)
        place = (sorted(set(lay.placement().values())) if hasattr(lay, "placement")
                 else "not given by this tree")
        for v, t in times.items():
            print(json.dumps({"design": name, "size": size, "cycles": cycles, "variant": v,
                              **t, "ns_per_cycle": [x * 1e6 / cycles for x in t["ms"]],
                              "placement": place}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)


if __name__ == "__main__":
    main()
