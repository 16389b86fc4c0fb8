"""Histogram (paper §8): data-dependent addressing into a local bin buffer.
The read-modify-write on the bin RAM is a loop-carried dependence through
memory, so the main loop runs at II=2 (read bin at ti+1, write back at ti+2;
the next iteration's read then observes the committed update)."""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder


def build(n: int = 64, bins: int = 16):
    b = Builder(ir.Module("histogram"))
    rmem = ir.MemrefType((n,), ir.i32, ir.PORT_R)
    wmem = ir.MemrefType((bins,), ir.i32, ir.PORT_W)
    with b.func("histogram", [rmem, wmem], ["Img", "Out"]) as f:
        Img, Out = f.args
        hist_t = ir.MemrefType((bins,), ir.i32, kind=ir.KIND_BRAM)
        Hr, Hw = b.alloc(hist_t, names=["Hr", "Hw"])

        # clear the bins (II=1)
        with b.for_(0, bins, 1, at=f.t + 1, iv_name="c", tv_name="tc") as lc:
            b.yield_(at=lc.time + 1)
            b.write(0, Hw, [lc.iv], at=lc.time)

        # main loop: II=2 because of the RMW recurrence through the bin RAM
        with b.for_(0, n, 1, at=lc.end + 1, iv_name="i", tv_name="ti") as li:
            b.yield_(at=li.time + 2)
            v = b.read(Img, [li.iv], at=li.time)          # bin index, valid ti+1
            h = b.read(Hr, [v], at=li.time + 1)           # bin value, valid ti+2
            h1 = b.add(h, 1)                              # ti+2
            v1 = b.delay(v, 1, at=li.time + 1)            # bin index again at ti+2
            b.write(h1, Hw, [v1], at=li.time + 2)
        # drain bins to the output interface (II=1)
        with b.for_(0, bins, 1, at=li.end + 2, iv_name="d", tv_name="td") as ld:
            b.yield_(at=ld.time + 1)
            hv = b.read(Hr, [ld.iv], at=ld.time)
            d1 = b.delay(ld.iv, 1, at=ld.time)
            b.write(hv, Out, [d1], at=ld.time + 1)
        b.ret()
    return b.module, "histogram"


def oracle(img: np.ndarray, bins: int = 16) -> np.ndarray:
    return np.bincount(img, minlength=bins).astype(np.int64)


def make_inputs(n: int = 64, bins: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, bins, size=(n,), dtype=np.int64)
    return [img, np.zeros((bins,), dtype=np.int64)]
