"""Multiply-accumulate — the paper's Figure 2 pipeline-imbalance example.
``build(mult_stages=2)`` is balanced; ``build(mult_stages=3)`` reproduces the
retiming bug: the multiplier gains a pipeline stage but the delayed addend
still arrives after 2 cycles, so the adder's operands mismatch (2 vs 3)."""

from __future__ import annotations

import numpy as np

from .. import ir
from ..builder import Builder


def build(mult_stages: int = 2, delay_c: int = 2):
    b = Builder(ir.Module("mac"))
    with b.func(
        "mac",
        [ir.i32, ir.i32, ir.i32],
        ["a", "bb", "c"],
        arg_delays=[0, 0, 0],
        result_types=[ir.i32],
        result_delays=[max(mult_stages, delay_c)],
    ) as f:
        a, bb, c = f.args
        m = b.mult(a, bb, at=f.t, stages=mult_stages)  # valid at t+stages
        c2 = b.delay(c, delay_c, at=f.t)               # valid at t+delay_c
        res = b.add(m, c2)                             # schedule inferred; Fig. 2 check
        b.ret([res])
    return b.module, "mac"


def build_broken():
    return build(mult_stages=3, delay_c=2)


def oracle(a: int, b: int, c: int) -> int:
    return a * b + c
