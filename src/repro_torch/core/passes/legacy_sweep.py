"""The seed's original fixpoint-sweep optimizer *algorithm*, preserved as the
measured baseline for ``benchmarks/codegen_speed.py``.

Every rewrite query here re-walks the whole function region
(``_replace_all_uses_in_region`` and the repeated full walks in constprop /
dce), making the sweep O(region²); the worklist driver + maintained use-def
chains in ``core.rewrite`` / ``core.passmgr`` replace it.

Benchmark-fidelity note: this baseline runs on the *current* IR substrate —
its operand writes pay the same OperandList chain bookkeeping and it gets
the same eager ``Region.walk`` as the new driver.  Both flows therefore pay
identical per-mutation constants, and the measured gap isolates the
algorithmic difference (blind O(region) sweeps vs O(#uses) worklist
rewriting) rather than incidental substrate changes.

Do not use this module outside benchmarking — it may leave use-def chains
stale (it removes ops from regions without erasing them)."""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Optional

from .. import ir
from ..ir import ForOp, Module, Operation, Region, const_value, _replace_all_uses_in_region
from .precision_opt import precision_opt
from .port_demotion import port_demotion


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


def _each_func(module: Module):
    for f in module.funcs.values():
        if not f.attrs.get("external"):
            yield f


def legacy_canonicalize(module: Module) -> int:
    n = 0
    for f in _each_func(module):
        for op in f.body.walk():
            if op.opname in ir.COMMUTATIVE_OPS and len(op.operands) == 2:
                a, b = op.operands
                ka = (const_value(a) is not None, a.id)
                kb = (const_value(b) is not None, b.id)
                if ka > kb:
                    op.operands[0], op.operands[1] = b, a
                    n += 1
            if op.opname in ("add", "sub", "shl", "shr", "or", "xor") and len(op.operands) == 2:
                cb = const_value(op.operands[1])
                if cb == 0 and op.results:
                    _replace_all_uses_in_region(f.body, op.result, op.operands[0])
                    n += 1
            elif op.opname == "mult" and op.results:
                for i in (0, 1):
                    c = const_value(op.operands[i])
                    if c == 1:
                        _replace_all_uses_in_region(f.body, op.result, op.operands[1 - i])
                        n += 1
                        break
    return n


def legacy_constprop(module: Module) -> int:
    n = 0
    for f in _each_func(module):
        changed = True
        while changed:
            changed = False
            for op in list(f.body.walk()):
                if op.opname not in ir.ARITH_OPS or not op.results:
                    continue
                vals = [const_value(v) for v in op.operands]
                if any(v is None for v in vals):
                    continue
                folded = _fold(op.opname, vals)
                if folded is None:
                    continue
                cst = ir.constant(folded, ir.CONST)
                region = op.parent_region or f.body
                region.ops.insert(region.ops.index(op), cst)
                cst.parent_region = region
                _replace_all_uses_in_region(f.body, op.result, cst.result)
                region.ops.remove(op)
                changed = True
                n += 1
    return n


def _is_pure(op: Operation) -> bool:
    return op.opname in ir.ARITH_OPS or op.opname in ("constant", "delay")


def legacy_dce(module: Module) -> int:
    n = 0
    for f in _each_func(module):
        changed = True
        while changed:
            changed = False
            used: set[int] = set()
            for op in f.body.walk():
                for v in op.operands:
                    used.add(v.id)

            def sweep(region: Region) -> None:
                nonlocal n, changed
                keep = []
                for op in region.ops:
                    if _is_pure(op) and op.results and all(r.id not in used for r in op.results):
                        changed = True
                        n += 1
                        continue
                    for r in op.regions:
                        sweep(r)
                    keep.append(op)
                region.ops[:] = keep

            sweep(f.body)
    return n


def _cse_key(op: Operation):
    if op.opname in ir.ARITH_OPS:
        stages = op.attrs.get("stages", 0)
        if stages:
            st = (op.start.tv.id, op.start.offset) if op.start is not None else None
            return ("arith", op.opname, tuple(v.id for v in op.operands), stages, st)
        return ("arith", op.opname, tuple(v.id for v in op.operands), 0, None)
    if op.opname == "delay":
        return ("delay", op.operands[0].id, op.attrs["by"])
    if op.opname == "constant":
        return ("const", str(op.result.type), op.attrs["value"])
    return None


def legacy_cse(module: Module) -> int:
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue

        def run(region: Region, seen: dict) -> None:
            nonlocal n
            keep = []
            for op in region.ops:
                k = _cse_key(op)
                if k is not None and op.results:
                    if k in seen:
                        _replace_all_uses_in_region(f.body, op.result, seen[k])
                        n += 1
                        continue
                    seen[k] = op.result
                for r in op.regions:
                    run(r, dict(seen))
                keep.append(op)
            region.ops[:] = keep

        run(f.body, {})
    return n


def _popcount(c: int) -> int:
    return bin(c).count("1")


def legacy_strength_reduce(module: Module) -> int:
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        ivs = set()
        for op in f.body.walk():
            if isinstance(op, ForOp):
                ivs.add(op.iv)
        for op in f.body.walk():
            if op.opname == "mult" and not op.attrs.get("impl"):
                for i in (0, 1):
                    c = const_value(op.operands[i])
                    x = op.operands[1 - i]
                    if c is None or not isinstance(c, int) or c <= 0:
                        continue
                    if x in ivs and x.type != ir.CONST:
                        op.attrs["impl"] = "counter"
                        n += 1
                        break
                    if c & (c - 1) == 0:
                        k = c.bit_length() - 1
                        op.opname = "shl"
                        cst = ir.constant(k, ir.CONST)
                        region = op.parent_region or f.body
                        region.ops.insert(region.ops.index(op), cst)
                        cst.parent_region = region
                        op.operands[:] = [x, cst.result]
                        n += 1
                        break
                    if _popcount(c) <= 3:
                        op.attrs["impl"] = "shift_add"
                        op.attrs["terms"] = _popcount(c)
                        n += 1
                        break
            elif op.opname == "div" and not op.attrs.get("impl"):
                c = const_value(op.operands[1])
                if isinstance(c, int) and c > 0 and c & (c - 1) == 0:
                    k = c.bit_length() - 1
                    op.opname = "shr"
                    cst = ir.constant(k, ir.CONST)
                    region = op.parent_region or f.body
                    region.ops.insert(region.ops.index(op), cst)
                    cst.parent_region = region
                    op.operands[:] = [op.operands[0], cst.result]
                    n += 1
    return n


def legacy_delay_elim(module: Module) -> int:
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue

        for op in list(f.body.walk()):
            if op.opname == "delay" and op.attrs["by"] == 0:
                _replace_all_uses_in_region(f.body, op.result, op.operands[0])
                n += 1

        def share(region: Region) -> None:
            nonlocal n
            by_src: dict[int, list[Operation]] = defaultdict(list)
            for op in region.ops:
                if op.opname == "delay" and op.attrs["by"] > 0 and not op.attrs.get("shared"):
                    by_src[op.operands[0].id].append(op)
                for r in op.regions:
                    share(r)
            order = {id(op): i for i, op in enumerate(region.ops)}
            for _, group in by_src.items():
                if len(group) < 2:
                    continue
                group.sort(key=lambda o: o.attrs["by"])
                for prev, cur in zip(group, group[1:]):
                    if cur.attrs["by"] > prev.attrs["by"] and order.get(id(prev), 1 << 30) < order.get(id(cur), -1):
                        cur.operands[0] = prev.result
                        cur.attrs["by"] = cur.attrs["by"] - prev.attrs["by"]
                        cur.attrs["shared"] = True
                        n += 1

        share(f.body)
    return n


LEGACY_PIPELINE: list[Callable[[Module], int]] = [
    legacy_canonicalize,
    legacy_constprop,
    legacy_cse,
    legacy_strength_reduce,
    precision_opt,
    legacy_delay_elim,
    port_demotion,
    legacy_dce,
]


def run_legacy_sweep(module: Module, max_iters: int = 3) -> dict[str, int]:
    """The seed's ``run_pipeline``: blind bounded-fixpoint sweep over the
    whole pipeline, every pass re-walking the whole region."""
    stats: dict[str, int] = {}
    for _ in range(max_iters):
        changed = 0
        for p in LEGACY_PIPELINE:
            n = p(module)
            stats[p.__name__] = stats.get(p.__name__, 0) + n
            changed += n
        if changed == 0:
            break
    return stats
