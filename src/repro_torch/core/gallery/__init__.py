"""The paper's benchmark kernels (§8, Tables 5–6) written in HIR:

  matrix transpose, 1-d stencil, histogram, GEMM (systolic array),
  2-d convolution, FIFO — plus the paper's two running examples
  (array-add, multiply-accumulate) in correct and deliberately-broken
  versions for the verifier tests (Figs. 1 and 2).

Each module exposes ``build()`` -> (Module, entry_name) and ``oracle(...)``
(NumPy reference).  ``GALLERY`` maps kernel name -> module.

The ``frontend_*`` entries are not hand-written: they are PyTorch
programs traced into HIR by ``core.frontend`` (matmul, masked fixed-point
softmax row, gated cumulative sum) and registered here so every downstream
harness — differential RTL sim, backend conformance, DSE — exercises the
traced path alongside the hand-scheduled kernels.
"""

from . import (array_add, conv2d, fifo, gemm, gemm_shared, histogram, mac,
               stencil1d, transpose)
from ..frontend.workloads import (frontend_matmul, frontend_scan,
                                  frontend_softmax_row)

GALLERY = {
    "transpose": transpose,
    "stencil1d": stencil1d,
    "histogram": histogram,
    "gemm": gemm,
    "gemm_shared": gemm_shared,
    "conv2d": conv2d,
    "fifo": fifo,
    "array_add": array_add,
    "mac": mac,
    "frontend_matmul": frontend_matmul,
    "frontend_softmax_row": frontend_softmax_row,
    "frontend_scan": frontend_scan,
}

PAPER_BENCHMARKS = ["transpose", "stencil1d", "histogram", "gemm", "conv2d", "fifo"]
