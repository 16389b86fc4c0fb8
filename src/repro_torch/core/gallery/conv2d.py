"""3x3 2-d convolution with line buffers (paper §8 "Convolution").

Streaming design: one input pixel per cycle, two line buffers (LUTRAM) hold
the previous two rows, a 3x2 register file holds the previous two columns of
the current 3-row window.  Constant weights [[1,2,1],[2,4,2],[1,2,1]] are
multiplications by constants — the strength-reduction pass turns them into
shifts/adds, which is how the paper's conv uses 0 DSPs.

Loop structure avoids conditionals: explicit prologue loops fill the line
buffers (first two rows) and the column registers (first two columns of each
row); the steady-state loop then writes one output per cycle at II=1.
"""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder

WGT = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]


def _tap_row(b: Builder, col_vals, wcol):
    """Sum of one window *column* against one weight column (combinational)."""
    acc = None
    for v, w in zip(col_vals, wcol):
        m = b.mult(v, w)
        acc = m if acc is None else b.add(acc, m)
    return acc


def build(h: int = 12, w: int = 12):
    b = Builder(ir.Module("conv2d"))
    rmem = ir.MemrefType((h, w), ir.i32, ir.PORT_R)
    wmem = ir.MemrefType((h - 2, w - 2), ir.i32, ir.PORT_W)
    with b.func("conv2d", [rmem, wmem], ["Img", "Out"]) as f:
        Img, Out = f.args
        lb_t = ir.MemrefType((w,), ir.i32, kind=ir.KIND_LUTRAM)
        L0r, L0w = b.alloc(lb_t, names=["L0r", "L0w"])  # row r-1
        L1r, L1w = b.alloc(lb_t, names=["L1r", "L1w"])  # row r-2
        # previous two window columns for the current 3 rows: 3x2 registers
        p_t = ir.MemrefType((3, 2), ir.i32, packed=[], kind=ir.KIND_REG)
        Pr, Pw = b.alloc(p_t, names=["Pr", "Pw"])

        def shift_and_fill(c_loop, with_output: bool, row_iv=None):
            """Common loop body: read pixel + line buffers, rotate the column
            registers, update line buffers, optionally emit an output."""
            tc = c_loop.time
            c = c_loop.iv
            v = b.read(Img, [row_iv, c] if row_iv is not None else [0, c], at=tc)  # row r
            a = b.read(L1r, [c], at=tc)        # row r-2 value at column c
            bm = b.read(L0r, [c], at=tc)       # row r-1 value
            c1 = b.delay(c, 1, at=tc)
            # rotate rows in the line buffers
            b.write(bm, L1w, [c1], at=tc + 1)
            b.write(v, L0w, [c1], at=tc + 1)
            # rotate the column registers: col0 <- col1, col1 <- fresh column
            col1 = [b.read(Pr, [r, 1], at=tc + 1) for r in range(3)]
            for r in range(3):
                b.write(col1[r], Pw, [r, 0], at=tc + 1)
            for r, val in enumerate([a, bm, v]):
                b.write(val, Pw, [r, 1], at=tc + 1)
            if with_output:
                col0 = [b.read(Pr, [r, 0], at=tc + 1) for r in range(3)]
                s0 = _tap_row(b, col0, [WGT[r][0] for r in range(3)])
                s1 = _tap_row(b, col1, [WGT[r][1] for r in range(3)])
                s2 = _tap_row(b, [a, bm, v], [WGT[r][2] for r in range(3)])
                s = b.add(b.add(s0, s1), s2)     # combinational at tc+1
                sreg = b.delay(s, 1, at=tc + 1)  # register, valid tc+2
                c2 = b.delay(c, 2, at=tc)
                cm2 = b.sub(c2, 2)
                rm2 = b.sub(row_iv, 2)           # row IV: sequential loop, always valid
                b.write(sreg, Out, [rm2, cm2], at=tc + 2)

        # ---- fill the first two rows into the line buffers ----
        with b.for_(0, 2, 1, at=f.t + 1, iv_name="r0", tv_name="tr0") as lr0:
            with b.for_(0, w, 1, at=lr0.time + 1, iv_name="c0", tv_name="tc0") as lc0:
                b.yield_(at=lc0.time + 1)
                v = b.read(Img, [lr0.iv, lc0.iv], at=lc0.time)
                bm = b.read(L0r, [lc0.iv], at=lc0.time)
                c1 = b.delay(lc0.iv, 1, at=lc0.time)
                b.write(bm, L1w, [c1], at=lc0.time + 1)
                b.write(v, L0w, [c1], at=lc0.time + 1)
            b.yield_(at=lc0.end + 1)

        # ---- main rows ----
        with b.for_(2, h, 1, at=lr0.end + 1, iv_name="r", tv_name="tr") as lr:
            # column prologue: fill the first two window columns
            with b.for_(0, 2, 1, at=lr.time + 1, iv_name="cp", tv_name="tcp") as lcp:
                b.yield_(at=lcp.time + 1)
                shift_and_fill(lcp, with_output=False, row_iv=lr.iv)
            # steady state: one output per cycle
            with b.for_(2, w, 1, at=lcp.end + 2, iv_name="c", tv_name="tcs") as lcs:
                b.yield_(at=lcs.time + 1)
                shift_and_fill(lcs, with_output=True, row_iv=lr.iv)
            b.yield_(at=lcs.end + 2)
        b.ret()
    return b.module, "conv2d"


def oracle(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    out = np.zeros((h - 2, w - 2), dtype=np.int64)
    for r in range(3):
        for c in range(3):
            out += WGT[r][c] * img[r:h - 2 + r, c:w - 2 + c]
    return out


def make_inputs(h: int = 12, w: int = 12, seed: int = 0):
    rng = np.random.default_rng(seed)
    img = rng.integers(-(2**12), 2**12, size=(h, w), dtype=np.int64)
    return [img, np.zeros((h - 2, w - 2), dtype=np.int64)]
