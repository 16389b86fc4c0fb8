"""The paper's benchmark kernels (§8, Tables 5–6) written in HIR:

  matrix transpose, 1-d stencil, histogram, GEMM (systolic array),
  2-d convolution, FIFO — plus the paper's two running examples
  (array-add, multiply-accumulate) in correct and deliberately-broken
  versions for the verifier tests (Figs. 1 and 2).

Each module exposes ``build()`` -> (Module, entry_name) and ``oracle(...)``
(NumPy reference).  ``GALLERY`` maps kernel name -> module.

Only the nine hand-written designs are registered here; the traced
``frontend_*`` entries of the reference arrive with the frontend.
"""

from . import (array_add, conv2d, fifo, gemm, gemm_shared, histogram, mac,
               stencil1d, transpose)

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
}

PAPER_BENCHMARKS = ["transpose", "stencil1d", "histogram", "gemm", "conv2d", "fifo"]
