"""Matrix transpose (paper Listing 1): sequential outer row loop, pipelined
(II=1) inner column loop; the column index crosses one pipeline stage and is
delayed to stay schedule-valid."""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder


def build(n: int = 16):
    b = Builder(ir.Module("transpose"))
    rmem = ir.MemrefType((n, n), ir.i32, ir.PORT_R)
    wmem = ir.MemrefType((n, n), ir.i32, ir.PORT_W)
    with b.func("transpose", [rmem, wmem], ["Ai", "Co"]) as f:
        Ai, Co = f.args
        with b.for_(0, n, 1, at=f.t + 1, iv_name="i", tv_name="ti") as li:
            with b.for_(0, n, 1, at=li.time + 1, iv_name="j", tv_name="tj") as lj:
                v = b.read(Ai, [li.iv, lj.iv], at=lj.time)           # valid at tj+1
                j1 = b.delay(lj.iv, 1, at=lj.time)                    # j survives II=1
                b.write(v, Co, [j1, li.iv], at=lj.time + 1)
                b.yield_(at=lj.time + 1)                              # II = 1
            b.yield_(at=lj.end + 1)                                   # sequential outer
        b.ret()
    return b.module, "transpose"


def oracle(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def make_inputs(n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2**20), 2**20, size=(n, n), dtype=np.int64)
    out = np.zeros((n, n), dtype=np.int64)
    return [a, out]
