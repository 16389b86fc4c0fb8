"""Synchronous FIFO (paper §8, the Verilog-baseline benchmark).

``fifo_step`` is a one-cycle FIFO tick: predicated (write-enable) push,
show-ahead pop, pointer registers updated every cycle.  The schedule lives in
the function signature (dout has declared delay 1), so the caller composes it
at II=1 with no handshake logic (paper §5.4).  ``fifo_top`` is a driver that
pushes N values then pops them back out to the output interface.
"""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder


def build(depth: int = 16, n: int = 16):
    assert depth & (depth - 1) == 0, "depth must be a power of two"
    assert n <= depth
    b = Builder(ir.Module("fifo"))

    buf_t = ir.MemrefType((depth,), ir.i32, kind=ir.KIND_LUTRAM)
    st_t = ir.MemrefType((2,), ir.i32, packed=[], kind=ir.KIND_REG)

    with b.func(
        "fifo_step",
        [ir.IntType(1, signed=False), ir.IntType(1, signed=False), ir.i32,
         buf_t.with_port(ir.PORT_R), buf_t.with_port(ir.PORT_W),
         st_t.with_port(ir.PORT_R), st_t.with_port(ir.PORT_W)],
        ["push", "pop", "din", "BufR", "BufW", "SR", "SW"],
        result_types=[ir.i32],
        result_delays=[1],
    ) as g:
        push, pop, din, BufR, BufW, SR, SW = g.args
        wp = b.read(SR, [0], at=g.t)            # registers: same-cycle
        rp = b.read(SR, [1], at=g.t)
        dout = b.read(BufR, [rp], at=g.t)       # show-ahead head, valid t+1
        b.write(din, BufW, [wp], at=g.t, pred=push)
        wp1 = b.add(wp, b.zext(push, ir.i32))
        rp1 = b.add(rp, b.zext(pop, ir.i32))
        b.write(b.and_(wp1, depth - 1), SW, [0], at=g.t)
        b.write(b.and_(rp1, depth - 1), SW, [1], at=g.t)
        b.ret([dout])

    rmem = ir.MemrefType((n,), ir.i32, ir.PORT_R)
    wmem = ir.MemrefType((n,), ir.i32, ir.PORT_W)
    with b.func("fifo_top", [rmem, wmem], ["In", "Out"]) as f:
        In, Out = f.args
        BufR, BufW = b.alloc(buf_t, names=["BufR", "BufW"])
        SR, SW = b.alloc(st_t, names=["SR", "SW"])
        b.write(0, SW, [0], at=f.t)
        b.write(0, SW, [1], at=f.t)
        one = b.const(1, ir.IntType(1, signed=False))
        zero = b.const(0, ir.IntType(1, signed=False))
        z32 = b.const(0, ir.i32)

        with b.for_(0, n, 1, at=f.t + 2, iv_name="i", tv_name="ti") as li:
            b.yield_(at=li.time + 1)
            v = b.read(In, [li.iv], at=li.time)
            b.call("fifo_step", [one, zero, v, BufR, BufW, SR, SW], at=li.time + 1)

        with b.for_(0, n, 1, at=li.end + 3, iv_name="j", tv_name="tj") as lj:
            b.yield_(at=lj.time + 1)
            d = b.call("fifo_step", [zero, one, z32, BufR, BufW, SR, SW], at=lj.time)
            j1 = b.delay(lj.iv, 1, at=lj.time)
            b.write(d, Out, [j1], at=lj.time + 1)
        b.ret()
    return b.module, "fifo_top"


def oracle(inp: np.ndarray) -> np.ndarray:
    return inp.copy()


def make_inputs(n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2**20), 2**20, size=(n,), dtype=np.int64)
    return [a, np.zeros((n,), dtype=np.int64)]
