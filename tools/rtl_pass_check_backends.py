"""Host time of the RTL pass check (``sim.verify_rtl_passes``) on its two
host tapes: the NumPy tape (``_NumpyOps``, the check's default backend) and
the plain PyTorch tape (``_TorchOps``) on the CPU, bit for bit the same
results.

For each of the nine hand-written designs at the sizes of the simulator's
matrix, x {inline, modules}: 16 stimulus vectors (``stack_stimulus``, seed
7), every RTL pass checked; the mean of two calls on each tape, alternated.
Runs on the CPU only, one thread.  Prints one line per pair and the totals.

Run:  PYTHONPATH=src python tools/rtl_pass_check_backends.py
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.codegen import sim
from repro_torch.core.gallery import (array_add, conv2d, fifo, gemm, gemm_shared, histogram,
                                      mac, stencil1d, transpose)

LANES = 16
# design -> (gallery module, build kwargs, make_inputs kwargs); mac takes three scalars
MATRIX = {
    "array_add": (array_add, {"n": 8}, {"n": 8}),
    "transpose": (transpose, {"n": 4}, {"n": 4}),
    "gemm": (gemm, {"n": 4}, {"n": 4}),
    "gemm_shared": (gemm_shared, {"n": 4}, {"n": 4}),
    "stencil1d": (stencil1d, {"n": 8}, {"n": 8}),
    "conv2d": (conv2d, {"h": 6, "w": 6}, {"h": 6, "w": 6}),
    "histogram": (histogram, {"n": 8, "bins": 4}, {"n": 8, "bins": 4}),
    "fifo": (fifo, {"depth": 16, "n": 8}, {"n": 8}),
    "mac": (mac, {}, None),
}


_NUMPY_SIMULATOR = sim.RTLSimulator


class _CpuTorchSimulator(sim.RTLSimulator):
    """The simulator the pass check builds, on the plain PyTorch tape on the
    CPU whatever backend it names."""

    def __init__(self, *args, backend="auto", **kwargs):
        super().__init__(*args, backend="torch", device="cpu")


def check_seconds(prepared, entry, batch, cycles, hierarchy, tape: str) -> float:
    sim.RTLSimulator = _CpuTorchSimulator if tape == "torch" else _NUMPY_SIMULATOR
    t0 = time.perf_counter()
    ok, mism = sim.verify_rtl_passes(prepared, entry, batch, cycles, hierarchy=hierarchy,
                                     backend="numpy")
    seconds = time.perf_counter() - t0
    sim.RTLSimulator = _NUMPY_SIMULATOR
    if not all(ok.values()):
        raise SystemExit(f"{entry} {hierarchy} {tape}: {mism[:4]}")
    return seconds


def main() -> None:
    torch.set_num_threads(1)
    totals = {"numpy": 0.0, "torch": 0.0}
    for dname, (gal, bkw, ikw) in MATRIX.items():
        if ikw is None:
            rng = np.random.default_rng(11)
            batch = [rng.integers(0, 1 << 15, size=LANES).astype(np.int64) for _ in range(3)]
        else:
            batch = sim.stack_stimulus(gal.make_inputs, LANES, base_seed=7, **ikw)
        for hierarchy in ("inline", "modules"):
            module, entry = gal.build(**bkw)
            _, prepared = sim.simulator_for(module, entry, hierarchy=hierarchy, device="cpu")
            cycles = sim.probe_cycles(prepared, entry, [c[0] for c in batch])
            secs = {"numpy": [], "torch": []}
            for tape in ("numpy", "torch", "numpy", "torch"):
                secs[tape].append(check_seconds(prepared, entry, batch, cycles, hierarchy, tape))
            row = {k: sum(v) / len(v) for k, v in secs.items()}
            for k in totals:
                totals[k] += row[k]
            print(f"{dname:12s} {hierarchy:8s} numpy {row['numpy']:.3f} s   "
                  f"torch {row['torch']:.3f} s   ratio {row['torch'] / row['numpy']:.2f}",
                  flush=True)
    print(f"total        numpy {totals['numpy']:.3f} s   torch {totals['torch']:.3f} s   "
          f"ratio {totals['torch'] / totals['numpy']:.2f}", flush=True)


if __name__ == "__main__":
    main()
