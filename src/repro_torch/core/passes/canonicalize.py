"""Canonicalization, constant propagation and DCE (paper §6.2), expressed as
rewrite patterns on the worklist driver (``core.rewrite``).

  * ``CanonicalizePattern`` — commutative operands ordered constants-last
    (LLVM-style), then by SSA id — the stable form is what enables CSE —
    plus the identity folds (x+0, x-0, x<<0, x>>0, x|0, x^0, x*1), which
    forward their operand and erase themselves;
  * ``ConstFoldPattern``    — pure arith over all-constant operands folds
    to an ``hir.constant``; the driver then revisits exactly the users of
    the folded value, so constant chains collapse in one worklist drain
    instead of the seed's repeated full-region walks;
  * ``dce``                 — use-count driven erasure of dead pure ops
    (O(#ops), not the seed's O(#ops²) re-walk loop).
"""

from __future__ import annotations

from typing import Optional

from .. import ir
from ..ir import FuncOp, Module, Operation, Region, Value, const_value
from ..passmgr import Pass, PatternRewritePass, register_pass
from ..rewrite import PatternRewriter, RewritePattern, RewritePatternSet


def _fold(opname: str, vals: list) -> Optional[int]:
    try:
        if opname == "add":
            return vals[0] + vals[1]
        if opname == "sub":
            return vals[0] - vals[1]
        if opname == "mult":
            return vals[0] * vals[1]
        if opname == "div":
            return vals[0] // vals[1]
        if opname == "and":
            return vals[0] & vals[1]
        if opname == "or":
            return vals[0] | vals[1]
        if opname == "xor":
            return vals[0] ^ vals[1]
        if opname == "shl":
            return vals[0] << vals[1]
        if opname == "shr":
            return vals[0] >> vals[1]
        if opname.startswith("cmp_"):
            import operator

            f = {"lt": operator.lt, "le": operator.le, "eq": operator.eq,
                 "ne": operator.ne, "gt": operator.gt, "ge": operator.ge}[opname[4:]]
            return int(f(vals[0], vals[1]))
        if opname == "select":
            return vals[1] if vals[0] else vals[2]
        if opname in ("trunc", "zext", "sext", "not"):
            return ~vals[0] if opname == "not" else vals[0]
    except (ZeroDivisionError, OverflowError, TypeError, ValueError):
        # arithmetic on the literal operands failed (e.g. div by const 0,
        # or a non-integer attr leaked in) — simply decline to fold
        return None
    return None


_IDENTITY_ZERO_OPS = ("add", "sub", "shl", "shr", "or", "xor")


class CanonicalizePattern(RewritePattern):
    """The canonicalization rules, bundled into one pattern so each visit
    computes the operand constants once:

      * commutative operand order — constants last, then by SSA id;
      * x+0 / x-0 / x<<0 / x>>0 / x|0 / x^0 -> x;  x*1 -> x.

    One rule fires per visit (the driver revisits until quiescent), so
    rewrite counts match applying the rules separately."""

    ops = tuple(set(ir.COMMUTATIVE_OPS) | set(_IDENTITY_ZERO_OPS))

    def match_and_rewrite(self, op: Operation, rewriter: PatternRewriter) -> bool:
        if len(op.operands) != 2:
            return False
        opname = op.opname
        a, b = op.operands
        ca, cb = const_value(a), const_value(b)
        if opname in ir.COMMUTATIVE_OPS:
            if ((ca is not None, a.id)) > ((cb is not None, b.id)):
                rewriter.set_operands(op, [b, a])
                return True
        if not op.results:
            return False
        if opname == "mult":
            if cb == 1:
                rewriter.replace_op(op, [a])
                return True
            if ca == 1:
                rewriter.replace_op(op, [b])
                return True
        elif opname in _IDENTITY_ZERO_OPS and cb == 0:
            rewriter.replace_op(op, [a])
            return True
        return False


class ConstFoldPattern(RewritePattern):
    """Fold pure arith ops whose operands are all compile-time constants."""

    ops = tuple(ir.ARITH_OPS)
    benefit = 2  # fold before reordering/identity rules bother

    def match_and_rewrite(self, op: Operation, rewriter: PatternRewriter) -> bool:
        if not op.results:
            return False
        vals = [const_value(v) for v in op.operands]
        if any(v is None for v in vals):
            return False
        folded = _fold(op.opname, vals)
        if folded is None:
            return False
        cst = ir.constant(folded, ir.CONST)
        rewriter.insert_before(op, cst)
        rewriter.replace_op(op, [cst.result])
        return True


# pattern sets are stateless: built once at import, shared by every run
_CANONICALIZE_SET = RewritePatternSet([CanonicalizePattern()])
_CONSTFOLD_SET = RewritePatternSet([ConstFoldPattern()])


@register_pass
class Canonicalize(PatternRewritePass):
    name = "canonicalize"
    # folded pure ops always complete no later than their consumers start, so
    # loop spans / IIs and the port congruence classes are untouched
    preserves = ("loop-info", "port-accesses")

    def patterns(self, func: FuncOp) -> RewritePatternSet:
        return _CANONICALIZE_SET


@register_pass
class ConstProp(PatternRewritePass):
    name = "constprop"
    preserves = ("loop-info", "port-accesses")

    def patterns(self, func: FuncOp) -> RewritePatternSet:
        return _CONSTFOLD_SET


def _is_pure(op: Operation) -> bool:
    return op.opname in ir.ARITH_OPS or op.opname in ("constant", "delay")


@register_pass
class DCE(Pass):
    """Remove pure ops whose results are unused — worklist over the use-def
    chains: erasing an op may make its operands' defining ops dead, and only
    those are revisited."""

    name = "dce"

    def run(self, module: Module) -> int:
        n = 0
        for f in self.each_func(module):
            work = [op for op in f.body.walk() if _is_pure(op)]
            dead_by_region: dict[int, Region] = {}
            while work:
                op = work.pop()
                if op.is_erased or not op.results:
                    continue
                if any(r.has_uses() for r in op.results):
                    continue
                producers = {v.defining_op for v in op.operands if v.defining_op is not None}
                region = op.parent_region
                op.drop_all_uses()  # lazy: compact each region once at the end
                if region is not None:
                    dead_by_region[id(region)] = region
                n += 1
                work.extend(p for p in producers if _is_pure(p) and not p.is_erased)
            for region in dead_by_region.values():
                region.ops[:] = [o for o in region.ops if not o.is_erased]
        return n


# -- legacy callable forms (same names/signatures as the seed) --------------


def canonicalize(module: Module) -> int:
    """Order commutative operands + identity folds; returns rewrites."""
    return Canonicalize().run(module)


def constprop(module: Module) -> int:
    """Fold pure ops whose operands are all compile-time constants."""
    return ConstProp().run(module)


def dce(module: Module) -> int:
    """Remove pure ops whose results are unused."""
    return DCE().run(module)
