"""1-d stencil (paper Listing 2): a 3-tap weighted window over a streaming
array, with a 2-element register window buffer and a fully pipelined (II=1)
loop.  The weighted reduction is an internal HIR function called with a
declared 1-cycle result delay — the schedule lives in the signature (§5.4)."""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder

W0, W1, W2 = 1, 2, 1  # integer weights (FIR-style)


def build(n: int = 64):
    b = Builder(ir.Module("stencil1d"))

    # the stencil compute op: out = w0*v0 + w1*v1 + w2*v2, registered (delay 1)
    with b.func(
        "stencil_op",
        [ir.i32, ir.i32, ir.i32],
        ["v0", "v1", "v2"],
        result_types=[ir.i32],
        result_delays=[1],
    ) as g:
        v0, v1, v2 = g.args
        m0 = b.mult(v0, W0, at=g.t)
        m1 = b.mult(v1, W1, at=g.t)
        m2 = b.mult(v2, W2, at=g.t)
        s = b.add(b.add(m0, m1), m2)
        r = b.delay(s, 1, at=g.t)  # register the combinational chain
        b.ret([r])

    rmem = ir.MemrefType((n,), ir.i32, ir.PORT_R)
    wmem = ir.MemrefType((n - 2,), ir.i32, ir.PORT_W)
    with b.func("stencil1d", [rmem, wmem], ["Ai", "Bw"]) as f:
        Ai, Bw = f.args
        # 2-register window: fully distributed (packing=[]) register bank
        win = ir.MemrefType((2,), ir.i32, ir.PORT_RW, packed=[], kind=ir.KIND_REG)
        Wr, Ww = b.alloc(win, names=["W1r", "W1w"])

        # prologue: preload the first two elements
        vA = b.read(Ai, [0], at=f.t)                      # valid t+1
        vA1 = b.delay(vA, 1, at=f.t + 1)                  # valid t+2
        vB = b.read(Ai, [1], at=f.t + 1)                  # valid t+2
        b.write(vA1, Ww, [0], at=f.t + 2)
        b.write(vB, Ww, [1], at=f.t + 2)

        # pipelined main loop, II=1: i in [1, n-1) computes out[i-1]
        with b.for_(1, n - 1, 1, at=f.t + 3, iv_name="i", tv_name="ti") as li:
            b.yield_(at=li.time + 1)
            v0 = b.read(Wr, [0], at=li.time + 1)          # registers: valid ti+1
            v1 = b.read(Wr, [1], at=li.time + 1)
            ip1 = b.add(li.iv, 1)                         # inferred at ti
            v = b.read(Ai, [ip1], at=li.time)             # valid ti+1
            b.write(v1, Ww, [0], at=li.time + 1)
            b.write(v, Ww, [1], at=li.time + 1)
            r = b.call("stencil_op", [v0, v1, v], at=li.time + 1)  # valid ti+2
            i2 = b.delay(li.iv, 2, at=li.time)
            im1 = b.sub(i2, 1)                            # out index i-1, at ti+2
            b.write(r, Bw, [im1], at=li.time + 2)
        b.ret()
    return b.module, "stencil1d"


def oracle(a: np.ndarray) -> np.ndarray:
    return W0 * a[:-2] + W1 * a[1:-1] + W2 * a[2:]


def make_inputs(n: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2**18), 2**18, size=(n,), dtype=np.int64)
    return [a, np.zeros((n - 2,), dtype=np.int64)]
