"""GEMM on a fully-pipelined 2-D systolic array (paper §7.3, §8).

16x16 x 16x16 int32 matmul:
  * load phase — A is staged into a row-banked local buffer (distributed dim
    0), B into a column-banked buffer (distributed dim 1); bank selection uses
    unroll_for constants (paper Fig. 3 memory banking).
  * compute phase — a 16x16 grid of PEs (nested ``unroll_for``) each runs a
    pipelined II=1 k-loop: every PE row broadcasts A[i,k] (same-address
    parallel reads are legal, §4.4), every PE column broadcasts B[k,j];
    accumulators live in a fully-distributed register bank.
  * drain phase — accumulators stream out through the single C port, one per
    cycle, staggered by unroll_for iteration times.

All phase offsets are compile-time constants, so the entire design is
scheduled on the function's root time variable.
"""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder


def build(n: int = 16):
    b = Builder(ir.Module("gemm"))
    rmem = ir.MemrefType((n, n), ir.i32, ir.PORT_R)
    wmem = ir.MemrefType((n, n), ir.i32, ir.PORT_W)

    load_inner = n + 2          # per-bank load loop latency (II=1 + pipeline drain)
    LOAD = n * load_inner       # staggered across banks (single A/B input port)
    COMPUTE_START = 1 + LOAD + 1
    DRAIN_START = COMPUTE_START + n + 3

    # the PE compute op: one multiply-accumulate step, combinational
    # (result delay 0) — every PE of the systolic grid calls it, so in
    # hierarchical emission the grid is 256 instances of this one module
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

    with b.func("gemm", [rmem, rmem, wmem], ["A", "B", "C"]) as f:
        A, B, C = f.args
        # row-banked A buffer: dim0 distributed (16 banks), dim1 packed
        abuf_t = ir.MemrefType((n, n), ir.i32, packed=[1], kind=ir.KIND_LUTRAM)
        Abr, Abw = b.alloc(abuf_t, names=["Abr", "Abw"])
        # column-banked B buffer: dim1 distributed, dim0 packed
        bbuf_t = ir.MemrefType((n, n), ir.i32, packed=[0], kind=ir.KIND_LUTRAM)
        Bbr, Bbw = b.alloc(bbuf_t, names=["Bbr", "Bbw"])
        # PE accumulators: fully distributed register bank
        acc_t = ir.MemrefType((n, n), ir.i32, packed=[], kind=ir.KIND_REG)
        AccR, AccW = b.alloc(acc_t, names=["AccR", "AccW"])

        # ---- load A (banks staggered: one element/cycle on the A port) ----
        with b.for_(0, n, 1, at=f.t + 1, unroll=True, iv_name="li", tv_name="tla") as la:
            b.yield_(at=la.time + load_inner)  # stagger = inner latency
            with b.for_(0, n, 1, at=la.time, iv_name="lj", tv_name="tja") as lja:
                b.yield_(at=lja.time + 1)
                v = b.read(A, [la.iv, lja.iv], at=lja.time)
                j1 = b.delay(lja.iv, 1, at=lja.time)
                b.write(v, Abw, [la.iv, j1], at=lja.time + 1)

        # ---- load B (parallel with A: separate input port) ----
        with b.for_(0, n, 1, at=f.t + 1, unroll=True, iv_name="bi", tv_name="tlb") as lb:
            b.yield_(at=lb.time + load_inner)
            with b.for_(0, n, 1, at=lb.time, iv_name="bk", tv_name="tkb") as lkb:
                b.yield_(at=lkb.time + 1)
                v = b.read(B, [lkb.iv, lb.iv], at=lkb.time)
                k1 = b.delay(lkb.iv, 1, at=lkb.time)
                b.write(v, Bbw, [k1, lb.iv], at=lkb.time + 1)

        # ---- zero the accumulators (all banks in parallel at t+1) ----
        with b.for_(0, n, 1, at=f.t + 1, unroll=True, iv_name="zi", tv_name="tzi") as zi:
            b.yield_(at=zi.time)
            with b.for_(0, n, 1, at=zi.time, unroll=True, iv_name="zj", tv_name="tzj") as zj:
                b.yield_(at=zj.time)
                b.write(0, AccW, [zi.iv, zj.iv], at=zj.time)

        # ---- systolic compute: 16x16 PEs, pipelined k-loop (II=1) ----
        with b.for_(0, n, 1, at=f.t + COMPUTE_START, unroll=True, iv_name="pi", tv_name="tpi") as pi:
            b.yield_(at=pi.time)
            with b.for_(0, n, 1, at=pi.time, unroll=True, iv_name="pj", tv_name="tpj") as pj:
                b.yield_(at=pj.time)
                with b.for_(0, n, 1, at=pj.time, iv_name="k", tv_name="tk") as lk:
                    b.yield_(at=lk.time + 1)
                    a = b.read(Abr, [pi.iv, lk.iv], at=lk.time)      # bank pi, addr k
                    bv = b.read(Bbr, [lk.iv, pj.iv], at=lk.time)     # bank pj, addr k
                    old = b.read(AccR, [pi.iv, pj.iv], at=lk.time + 1)
                    s = b.call("mac", [a, bv, old], at=lk.time + 1)  # comb, at tk+1
                    b.write(s, AccW, [pi.iv, pj.iv], at=lk.time + 1)

        # ---- drain: one result per cycle through the C port ----
        with b.for_(0, n, 1, at=f.t + DRAIN_START, unroll=True, iv_name="di", tv_name="tdi") as di:
            b.yield_(at=di.time + n)  # row stagger
            with b.for_(0, n, 1, at=di.time, unroll=True, iv_name="dj", tv_name="tdj") as dj:
                b.yield_(at=dj.time + 1)  # element stagger
                v = b.read(AccR, [di.iv, dj.iv], at=dj.time)  # registers: same cycle
                b.write(v, C, [di.iv, dj.iv], at=dj.time)
        b.ret()
    return b.module, "gemm"


def oracle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int64)


def make_inputs(n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2**10), 2**10, size=(n, n), dtype=np.int64)
    bb = rng.integers(-(2**10), 2**10, size=(n, n), dtype=np.int64)
    return [a, bb, np.zeros((n, n), dtype=np.int64)]
