"""Precision optimization (paper §6.3, Table 4).

Interval (range) analysis over the SSA graph: constant loop bounds bound the
induction variables; ranges propagate through arithmetic; every integer value
is then narrowed to the minimal signed/unsigned width that holds its range.
The codegen sizes wires, registers, shift registers and address buses from
these narrowed types, which is where the paper's Table 4 LUT/FF savings come
from (transpose: i32 loop counters -> i5)."""

from __future__ import annotations

from typing import Optional

from .. import ir
from ..ir import ForOp, FuncOp, Module, Operation, Value, const_value

Range = tuple[int, int]  # inclusive


def _width_for(lo: int, hi: int) -> tuple[int, bool]:
    """Minimal (width, signed) holding [lo, hi]."""
    if lo >= 0:
        w = max(1, hi.bit_length())
        return w, False
    w = max(lo.bit_length() + 1 if lo < 0 else 1, hi.bit_length() + 1, 2)
    # need w st -2^(w-1) <= lo and hi <= 2^(w-1)-1
    while -(1 << (w - 1)) > lo or hi > (1 << (w - 1)) - 1:
        w += 1
    return w, True


def _type_range(t: ir.Type) -> Optional[Range]:
    if isinstance(t, ir.IntType):
        if t.signed:
            return (-(1 << (t.width - 1)), (1 << (t.width - 1)) - 1)
        return (0, (1 << t.width) - 1)
    return None


def _prop(opname: str, rs: list[Optional[Range]]) -> Optional[Range]:
    if any(r is None for r in rs):
        return None
    (a_lo, a_hi) = rs[0]
    if opname in ("zext", "sext", "trunc", "delay"):
        return rs[0]
    if opname == "not":
        return (~a_hi, ~a_lo)
    (b_lo, b_hi) = rs[1] if len(rs) > 1 else (0, 0)
    if opname == "add":
        return (a_lo + b_lo, a_hi + b_hi)
    if opname == "sub":
        return (a_lo - b_hi, a_hi - b_lo)
    if opname == "mult":
        cands = [a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi]
        return (min(cands), max(cands))
    if opname == "shl":
        if b_lo < 0 or b_hi > 63:
            return None
        return (min(a_lo << b_lo, a_lo << b_hi), max(a_hi << b_lo, a_hi << b_hi))
    if opname == "shr":
        if b_lo < 0 or b_hi > 63 or a_lo < 0:
            return None
        return (a_lo >> b_hi, a_hi >> b_lo)
    if opname == "and":
        if a_lo >= 0 and b_lo >= 0:
            return (0, min(a_hi, b_hi))
        return None
    if opname == "or" or opname == "xor":
        if a_lo >= 0 and b_lo >= 0:
            m = max(a_hi, b_hi)
            bits = m.bit_length()
            return (0, (1 << bits) - 1)
        return None
    if opname.startswith("cmp_"):
        return (0, 1)
    if opname == "select":
        return (min(rs[1][0], rs[2][0]), max(rs[1][1], rs[2][1]))
    if opname == "div":
        if b_lo > 0 and a_lo >= 0:
            return (a_lo // b_hi, a_hi // b_lo)
        return None
    return None


def precision_opt(module: Module) -> int:
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        ranges: dict[Value, Optional[Range]] = {}

        # seeds: constants, typed args, loop bounds
        for a in f.args:
            ranges[a] = _type_range(a.type)

        def visit(region) -> None:
            for op in region.ops:
                if op.opname == "constant":
                    v = op.attrs["value"]
                    ranges[op.result] = (v, v) if isinstance(v, int) else None
                elif isinstance(op, ForOp):
                    lb, ub, st = const_value(op.lb), const_value(op.ub), const_value(op.step)
                    if lb is not None and ub is not None and st is not None and st > 0:
                        ranges[op.iv] = (lb, max(lb, ub - 1))
                    else:
                        ranges[op.iv] = _type_range(op.iv.type)
                    for r in op.regions:
                        visit(r)
                elif op.opname == "mem_read":
                    ranges[op.result] = _type_range(op.result.type)
                elif op.opname == "call":
                    for r in op.results:
                        ranges[r] = _type_range(r.type)
                elif op.opname == "delay":
                    ranges[op.result] = ranges.get(op.operands[0], _type_range(op.result.type))
                elif op.opname in ir.ARITH_OPS:
                    rs = [ranges.get(v) for v in op.operands]
                    ranges[op.result] = _prop(op.opname, rs) or _type_range(op.result.type)
                else:
                    for r in op.regions:
                        visit(r)

        visit(f.body)

        # narrow integer-typed values (never const/float): signedness follows
        # the proven range (non-negative values become unsigned — sound, and
        # exactly what a hand-written RTL design would use)
        for v, rng in ranges.items():
            if rng is None or not isinstance(v.type, ir.IntType):
                continue
            w, signed = _width_for(*rng)
            if w < v.type.width:
                v.type = ir.IntType(w, signed)
                n += 1
    return n


from ..passmgr import Pass, register_pass  # noqa: E402


@register_pass
class PrecisionOpt(Pass):
    """Interval analysis + bitwidth narrowing (whole-function analysis; not
    a local pattern)."""

    name = "precision-opt"
    preserves_all = True  # narrows types in place; schedules/IR shape untouched

    def run(self, module: Module) -> int:
        return precision_opt(module)
