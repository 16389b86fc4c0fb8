"""Array-add — the paper's Figure 1 example.  ``build()`` is the corrected
design; ``build_broken()`` reproduces Fig. 1a exactly: with II=1 the write at
``%ti offset 1`` consumes the induction variable one cycle after it has
already been re-generated — the verifier must report the Fig. 1b error."""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder


def _body(b: Builder, f, n: int, fix: bool):
    A, B, C = f.args
    with b.for_(0, n, 1, at=f.t + 1, iv_type=ir.i8 if n <= 127 else ir.i32, iv_name="i", tv_name="ti") as li:
        b.yield_(at=li.time + 1)  # II = 1 (textual position irrelevant, §4.2)
        a = b.read(A, [li.iv], at=li.time)
        v = b.read(B, [li.iv], at=li.time)
        c = b.add(a, v)  # combinational, inferred at ti+1
        if fix:
            i1 = b.delay(li.iv, 1, at=li.time)
            b.write(c, C, [i1], at=li.time + 1)
        else:
            b.write(c, C, [li.iv], at=li.time + 1)  # Fig. 1 bug: %i stale at ti+1
    b.ret()


def build(n: int = 128):
    b = Builder(ir.Module("array_add"))
    r = ir.MemrefType((n,), ir.i32, ir.PORT_R)
    w = ir.MemrefType((n,), ir.i32, ir.PORT_W)
    with b.func("array_add", [r, r, w], ["A", "B", "C"]) as f:
        _body(b, f, n, fix=True)
    return b.module, "array_add"


def build_broken(n: int = 128):
    b = Builder(ir.Module("array_add_broken"))
    r = ir.MemrefType((n,), ir.i32, ir.PORT_R)
    w = ir.MemrefType((n,), ir.i32, ir.PORT_W)
    with b.func("array_add", [r, r, w], ["A", "B", "C"]) as f:
        _body(b, f, n, fix=False)
    return b.module, "array_add"


def oracle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a + b


def make_inputs(n: int = 128, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2**20), 2**20, size=(n,), dtype=np.int64)
    bb = rng.integers(-(2**20), 2**20, size=(n,), dtype=np.int64)
    return [a, bb, np.zeros((n,), dtype=np.int64)]
