"""Strength reduction (paper §6.2), as worklist rewrite patterns.

  * ``x * 2^k``   -> ``x << k``                       (free in hardware)
  * ``x * c``     -> shift-add decomposition when c has <= 3 set bits
                    (marked ``impl="shift_add"`` — costed as adders, 0 DSPs;
                    this is how the paper's convolution uses no DSP blocks)
  * ``iv * c``    -> marked ``impl="counter"``: the loop controller maintains
                    a scaled running counter (adder) instead of a multiplier —
                    the paper's "multiplication between loop induction
                    variables and constants" rewrite.
  * ``x / 2^k``   -> ``x >> k``
"""

from __future__ import annotations

from .. import ir
from ..ir import ForOp, FuncOp, Module, Operation, const_value
from ..passmgr import PatternRewritePass, register_pass
from ..rewrite import PatternRewriter, RewritePattern, RewritePatternSet


def _popcount(c: int) -> int:
    return bin(c).count("1")


class MultStrengthReducePattern(RewritePattern):
    """mult-by-constant: counter (IVs), shift (powers of two) or shift-add
    (few set bits).  Needs the function's loop-IV set as context."""

    ops = ("mult",)

    def __init__(self, ivs: set):
        self.ivs = ivs

    def match_and_rewrite(self, op: Operation, rewriter: PatternRewriter) -> bool:
        if op.attrs.get("impl"):
            return False
        for i in (0, 1):
            c = const_value(op.operands[i])
            x = op.operands[1 - i]
            if c is None or not isinstance(c, int) or c <= 0:
                continue
            if x in self.ivs and x.type != ir.CONST:
                op.attrs["impl"] = "counter"  # scaled loop counter
                rewriter.notify_modified(op)
                return True
            if c & (c - 1) == 0:  # power of two -> shl
                k = c.bit_length() - 1
                cst = ir.constant(k, ir.CONST)
                rewriter.insert_before(op, cst)
                op.opname = "shl"
                rewriter.set_operands(op, [x, cst.result])
                return True
            if _popcount(c) <= 3:  # few-term shift-add
                op.attrs["impl"] = "shift_add"
                op.attrs["terms"] = _popcount(c)
                rewriter.notify_modified(op)
                return True
        return False


class DivStrengthReducePattern(RewritePattern):
    """div-by-power-of-two -> shr."""

    ops = ("div",)

    def match_and_rewrite(self, op: Operation, rewriter: PatternRewriter) -> bool:
        if op.attrs.get("impl"):
            return False
        c = const_value(op.operands[1])
        if isinstance(c, int) and c > 0 and c & (c - 1) == 0:
            k = c.bit_length() - 1
            cst = ir.constant(k, ir.CONST)
            rewriter.insert_before(op, cst)
            op.opname = "shr"
            rewriter.set_operands(op, [op.operands[0], cst.result])
            return True
        return False


@register_pass
class StrengthReduce(PatternRewritePass):
    name = "strength-reduce"
    # in-place opname/attr rewrites of comb ops at unchanged schedules
    preserves = ("loop-info", "port-accesses")

    def __init__(self):
        self._mult = MultStrengthReducePattern(set())
        self._set = RewritePatternSet([self._mult, DivStrengthReducePattern()])

    def patterns(self, func: FuncOp) -> RewritePatternSet:
        # the IV set is per-function context; the pattern set itself is reused
        self._mult.ivs = {op.iv for op in func.body.walk() if isinstance(op, ForOp)}
        return self._set


def strength_reduce(module: Module) -> int:
    return StrengthReduce().run(module)
