"""GEMM scheduled for cross-instance time-multiplexing (paper §4.4 taken to
module granularity).

Same 16x16 int32 matmul as ``gemm``, but the compute phase trades latency
for resources: the k-loop runs at II=n (one MAC issue per PE every n
cycles) and the PE columns are staggered by one cycle, so PE(i,j) fires its
``mac`` call exactly at cycles ``{COMPUTE + j + n*m + 1}``.  Within one PE
row the n column schedules are pairwise disjoint (distinct residues mod n),
which is precisely what the ``activation-intervals`` analysis proves — so
``rtl-share-instances`` folds each row's n ``mac`` instances onto a single
physical instance behind a time-division operand mux: 256 instances become
16 at n=16 (a 16x reduction, 768 -> 48 DSPs), with zero arbitration logic
because the disjointness is static.

Memory legality is unchanged from ``gemm``: each A bank is read at
pairwise-distinct cycles (the same disjoint schedule), and the B banks keep
the §4.4 same-address broadcast across rows.
"""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder
from .gemm import make_inputs, oracle  # noqa: F401  (same interface/reference)


def build(n: int = 16):
    b = Builder(ir.Module("gemm_shared"))
    rmem = ir.MemrefType((n, n), ir.i32, ir.PORT_R)
    wmem = ir.MemrefType((n, n), ir.i32, ir.PORT_W)

    load_inner = n + 2
    LOAD = n * load_inner
    COMPUTE_START = 1 + LOAD + 1
    # k-loop: trip n at II=n, plus the column stagger and the +1 mac cycle
    DRAIN_START = COMPUTE_START + n * n + n + 2

    with b.func(
        "mac",
        [ir.i32, ir.i32, ir.i32],
        ["a", "bb", "c"],
        result_types=[ir.i32],
        result_delays=[0],
    ) as g:
        ga, gb, gc = g.args
        gm = b.mult(ga, gb, at=g.t)
        b.ret([b.add(gm, gc)])

    with b.func("gemm_shared", [rmem, rmem, wmem], ["A", "B", "C"]) as f:
        A, B, C = f.args
        abuf_t = ir.MemrefType((n, n), ir.i32, packed=[1], kind=ir.KIND_LUTRAM)
        Abr, Abw = b.alloc(abuf_t, names=["Abr", "Abw"])
        bbuf_t = ir.MemrefType((n, n), ir.i32, packed=[0], kind=ir.KIND_LUTRAM)
        Bbr, Bbw = b.alloc(bbuf_t, names=["Bbr", "Bbw"])
        acc_t = ir.MemrefType((n, n), ir.i32, packed=[], kind=ir.KIND_REG)
        AccR, AccW = b.alloc(acc_t, names=["AccR", "AccW"])

        # ---- load phases: identical to gemm ----
        with b.for_(0, n, 1, at=f.t + 1, unroll=True, iv_name="li", tv_name="tla") as la:
            b.yield_(at=la.time + load_inner)
            with b.for_(0, n, 1, at=la.time, iv_name="lj", tv_name="tja") as lja:
                b.yield_(at=lja.time + 1)
                v = b.read(A, [la.iv, lja.iv], at=lja.time)
                j1 = b.delay(lja.iv, 1, at=lja.time)
                b.write(v, Abw, [la.iv, j1], at=lja.time + 1)

        with b.for_(0, n, 1, at=f.t + 1, unroll=True, iv_name="bi", tv_name="tlb") as lb:
            b.yield_(at=lb.time + load_inner)
            with b.for_(0, n, 1, at=lb.time, iv_name="bk", tv_name="tkb") as lkb:
                b.yield_(at=lkb.time + 1)
                v = b.read(B, [lkb.iv, lb.iv], at=lkb.time)
                k1 = b.delay(lkb.iv, 1, at=lkb.time)
                b.write(v, Bbw, [k1, lb.iv], at=lkb.time + 1)

        with b.for_(0, n, 1, at=f.t + 1, unroll=True, iv_name="zi", tv_name="tzi") as zi:
            b.yield_(at=zi.time)
            with b.for_(0, n, 1, at=zi.time, unroll=True, iv_name="zj", tv_name="tzj") as zj:
                b.yield_(at=zj.time)
                b.write(0, AccW, [zi.iv, zj.iv], at=zj.time)

        # ---- compute: column-staggered PEs, one MAC issue per n cycles ----
        with b.for_(0, n, 1, at=f.t + COMPUTE_START, unroll=True, iv_name="pi", tv_name="tpi") as pi:
            b.yield_(at=pi.time)
            with b.for_(0, n, 1, at=pi.time, unroll=True, iv_name="pj", tv_name="tpj") as pj:
                b.yield_(at=pj.time + 1)  # column stagger: disjoint residues
                with b.for_(0, n, 1, at=pj.time, iv_name="k", tv_name="tk") as lk:
                    b.yield_(at=lk.time + n)  # II=n: one firing per slot
                    a = b.read(Abr, [pi.iv, lk.iv], at=lk.time)
                    bv = b.read(Bbr, [lk.iv, pj.iv], at=lk.time)
                    old = b.read(AccR, [pi.iv, pj.iv], at=lk.time + 1)
                    s = b.call("mac", [a, bv, old], at=lk.time + 1)
                    b.write(s, AccW, [pi.iv, pj.iv], at=lk.time + 1)

        # ---- drain: identical to gemm ----
        with b.for_(0, n, 1, at=f.t + DRAIN_START, unroll=True, iv_name="di", tv_name="tdi") as di:
            b.yield_(at=di.time + n)
            with b.for_(0, n, 1, at=di.time, unroll=True, iv_name="dj", tv_name="tdj") as dj:
                b.yield_(at=dj.time + 1)
                v = b.read(AccR, [di.iv, dj.iv], at=dj.time)
                b.write(v, C, [di.iv, dj.iv], at=dj.time)
        b.ret()
    return b.module, "gemm_shared"
