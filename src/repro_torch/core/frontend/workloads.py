"""Traced gallery workloads: real PyTorch programs compiled to hardware
through the frontend tracer.

Each program is the reference's jax.numpy program written in torch so that
its aten graph is the jaxpr's equation sequence: ``sum`` and ``cumsum`` take
``dtype=torch.int32`` (they would promote to int64), ``clamp`` stands for
``minimum``/``maximum`` with a constant, ``torch.div(..., rounding_mode=
"floor")`` for ``lax.div`` and ``expand`` for ``broadcast_to``.

Each workload follows the gallery module protocol — ``build(**kw)`` ->
``(Module, entry)``, ``oracle(*inputs)`` (NumPy reference), and
``make_inputs(seed=..., **kw)`` — so the differential harness, the
backend conformance suites, and the DSE explorer all pick them up
unchanged.  The PyTorch source *is* the specification: every oracle below is
the same arithmetic re-written in NumPy int64, and the differential tests
check the traced hardware against it on hundreds of stimulus vectors.

All three kernels are integer/fixed-point (the frontend's dtype policy):

  ``frontend_matmul``       A @ B through ``mm`` -> the tiled
                            mac-calling PE nest;
  ``frontend_softmax_row``  a masked fixed-point base-2 softmax row
                            (exact in int32: weights are ``FP >> shift``)
                            -> where/reduce/expand nests;
  ``frontend_scan``         a gated cumulative sum -> the sequential
                            register-accumulator recurrence.
"""

from __future__ import annotations

import numpy as np

_FP_BITS = 12          # fixed-point fraction bits of the softmax weights
_NEG_INF = -(1 << 20)  # masked-score sentinel (far below any real score)
_SH_MAX = 24           # clamp on the weight shift (2**-24 underflows to 0)


# --------------------------------------------------------------------------
# frontend_matmul


class frontend_matmul:
    """int32 matmul, traced from ``torch.matmul`` (tile = accumulator bank)."""

    @staticmethod
    def build(m: int = 4, k: int = 4, n: int = 4, tile: int = 2):
        import torch

        from .tracer import trace

        def fn(a, b):
            return torch.matmul(a, b)

        return trace(fn, [(m, k), (k, n)], name="frontend_matmul",
                     tile=tile, arg_names=["A", "B"])

    @staticmethod
    def oracle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int64)

    @staticmethod
    def make_inputs(m: int = 4, k: int = 4, n: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        a = rng.integers(-(2 ** 9), 2 ** 9, size=(m, k), dtype=np.int64)
        b = rng.integers(-(2 ** 9), 2 ** 9, size=(k, n), dtype=np.int64)
        return [a, b, np.zeros((m, n), dtype=np.int64)]


# --------------------------------------------------------------------------
# frontend_softmax_row


class frontend_softmax_row:
    """Masked fixed-point softmax over one row of scores.

    Base-2, integer-exact: each weight is ``FP >> min(max - s, 24)`` (a
    power-of-two approximation of ``exp2(s - max)`` in Q12), normalized by
    the masked weight sum.  Masked-out lanes produce exactly 0; an all-
    masked row produces all-zeros (the ``max(total, 1)`` guard).  Every
    intermediate fits comfortably in int32, so the NumPy int64 oracle and
    the int32 hardware agree bit-for-bit.
    """

    @staticmethod
    def build(n: int = 8):
        import torch

        from .tracer import trace

        fp = 1 << _FP_BITS

        def fn(s, mask):
            sm = torch.where(mask > 0, s, _NEG_INF)
            m = torch.amax(sm)
            sh = torch.clamp(m - sm, max=_SH_MAX)
            w = torch.where(mask > 0, fp >> sh, 0)
            total = torch.clamp(torch.sum(w, dtype=torch.int32), min=1)
            return torch.div(w * fp, total.expand(w.shape), rounding_mode="floor")

        return trace(fn, [(n,), (n,)], name="frontend_softmax_row",
                     arg_names=["S", "MASK"])

    @staticmethod
    def oracle(s: np.ndarray, mask: np.ndarray) -> np.ndarray:
        fp = 1 << _FP_BITS
        s = s.astype(np.int64)
        sm = np.where(mask > 0, s, _NEG_INF)
        m = sm.max()
        sh = np.minimum(m - sm, _SH_MAX)
        w = np.where(mask > 0, fp >> sh, 0)
        total = max(int(w.sum()), 1)
        return (w * fp) // total

    @staticmethod
    def make_inputs(n: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        s = rng.integers(-(2 ** 10), 2 ** 10, size=n, dtype=np.int64)
        mask = (rng.random(n) < 0.75).astype(np.int64)
        if seed % 7 == 0:
            mask[:] = 0  # exercise the all-masked row regularly
        return [s, mask, np.zeros(n, dtype=np.int64)]


# --------------------------------------------------------------------------
# frontend_scan


class frontend_scan:
    """Gated running sum: ``cumsum(where(g > 0, x, 0))`` — the associative-
    scan idiom traced into a sequential register recurrence."""

    @staticmethod
    def build(n: int = 8):
        import torch

        from .tracer import trace

        def fn(x, g):
            return torch.cumsum(torch.where(g > 0, x, 0), dim=0, dtype=torch.int32)

        return trace(fn, [(n,), (n,)], name="frontend_scan",
                     arg_names=["X", "G"])

    @staticmethod
    def oracle(x: np.ndarray, g: np.ndarray) -> np.ndarray:
        return np.cumsum(np.where(g > 0, x.astype(np.int64), 0))

    @staticmethod
    def make_inputs(n: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        x = rng.integers(-(2 ** 10), 2 ** 10, size=n, dtype=np.int64)
        g = (rng.random(n) < 0.5).astype(np.int64)
        return [x, g, np.zeros(n, dtype=np.int64)]


FRONTEND_WORKLOADS = {
    "frontend_matmul": frontend_matmul,
    "frontend_softmax_row": frontend_softmax_row,
    "frontend_scan": frontend_scan,
}
