"""Full expansion of ``hir.unroll_for`` (paper §7.3): the loop body is
replicated in hardware once per iteration, with the induction variable
substituted by a compile-time constant and each replica's schedule shifted by
the iteration stagger (the yield offset).

Runs before Verilog codegen and before resource estimation — after this pass
every distributed-dim bank index is a literal constant, so banked RAMs and PE
arrays become static structure."""

from __future__ import annotations

from typing import Optional

from .. import ir
from ..ir import ForOp, FuncOp, Module, Operation, Region, Time, Value


def _clone_op(op: Operation, vmap: dict[Value, Value], tmap: dict[Value, tuple[Value, int]],
              extra_shift: int = 0) -> Operation:
    """Clone ``op`` remapping operand values via ``vmap`` and rebasing its
    schedule via ``tmap`` (time var -> (new tv, added offset))."""

    def mv(v: Value) -> Value:
        return vmap.get(v, v)

    start: Optional[Time] = None
    if op.start is not None:
        tv, add = tmap.get(op.start.tv, (op.start.tv, 0))
        start = Time(mv(tv) if tv in vmap else tv, op.start.offset + add + extra_shift)

    if op.opname == "time":
        # derived time variables: rebase the referenced tv through tmap
        tv0 = op.operands[0]
        base_tv, add0 = tmap.get(tv0, (tv0, 0))
        new = Operation(
            "time",
            [mv(base_tv)],
            [op.results[0].type],
            attrs={"offset": op.attrs.get("offset", 0) + add0 + extra_shift},
            loc=op.loc,
            result_names=[op.results[0].name],
        )
        new.results[0].birth = None
        new.results[0].validity_end = None
        vmap[op.results[0]] = new.results[0]
        return new

    if isinstance(op, ForOp):
        new = ForOp(
            mv(op.lb), mv(op.ub), mv(op.step),
            start=start,
            iv_type=op.iv.type,
            iter_arg_offset=op.attrs.get("iter_arg_offset", 0),
            unroll=(op.opname == "unroll_for"),
            iv_name=op.iv.name,
            tv_name=op.time_var.name,
            loc=op.loc,
        )
        inner_vmap = dict(vmap)
        inner_vmap[op.iv] = new.iv
        inner_vmap[op.time_var] = new.time_var
        inner_vmap[op.end_time] = new.end_time
        for b in op.region(0).ops:
            c = _clone_op(b, inner_vmap, tmap)
            new.region(0).add(c)
        _remap_operands(new.region(0).ops, inner_vmap)  # forward refs in body
        vmap[op.end_time] = new.end_time
        return new

    new = Operation(
        op.opname,
        [mv(v) for v in op.operands],
        [r.type for r in op.results],
        attrs=dict(op.attrs),
        start=start,
        loc=op.loc,
        result_names=[r.name for r in op.results],
    )
    for old_r, new_r in zip(op.results, new.results):
        vmap[old_r] = new_r
        new_r.birth = old_r.birth
        new_r.validity_end = old_r.validity_end
    return new


def _remap_operands(ops: list[Operation], vmap: dict[Value, Value]) -> None:
    """Second pass after cloning: resolve forward references (an op may use a
    value whose defining op appears later in the region — textual order is not
    semantic in HIR)."""
    for op in ops:
        for i, v in enumerate(op.operands):
            if v in vmap:
                op.operands[i] = vmap[v]
        for r in op.regions:
            _remap_operands(r.ops, vmap)


def _expand_unroll(func: FuncOp, region: Region) -> int:
    n = 0
    new_ops: list[Operation] = []
    for op in region.ops:
        # expand innermost-first
        for r in op.regions:
            n += _expand_unroll(func, r)
        if isinstance(op, ForOp) and op.opname == "unroll_for":
            trip = op.trip_count()
            assert trip is not None, "unroll_for requires constant bounds"
            y = op.yield_op()
            stagger = 0
            if y is not None and y.start is not None and y.start.tv is op.time_var:
                stagger = y.start.offset
            lb = ir.const_value(op.lb) or 0
            step = ir.const_value(op.step) or 1
            assert op.start is not None
            for m in range(trip):
                ivv = lb + m * step
                cst = ir.constant(ivv, op.iv.type, name=f"{op.iv.name}{ivv}")
                cst.parent_region = region
                new_ops.append(cst)
                vmap: dict[Value, Value] = {op.iv: cst.result}
                tmap = {op.time_var: (op.start.tv, op.start.offset + m * stagger)}
                clones = []
                for b in op.region(0).ops:
                    if b.opname == "yield":
                        continue
                    c = _clone_op(b, vmap, tmap)
                    c.parent_region = region
                    clones.append(c)
                _remap_operands(clones, vmap)  # resolve forward references
                new_ops.extend(clones)
            # rebind the end time: a derived time op at start + trip*stagger
            endt = ir.time_offset(Time(op.start.tv, op.start.offset + trip * stagger),
                                  name=op.end_time.name)
            endt.parent_region = region
            new_ops.append(endt)
            op.end_time.replace_all_uses_with(endt.result)
            op.drop_all_uses()  # the loop (and its body) is replaced by clones
            n += 1
        else:
            new_ops.append(op)
    region.ops[:] = new_ops
    return n


def unroll_loops(module: Module) -> int:
    """Expand every unroll_for in every function; returns loops expanded."""
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        # fixpoint: nested unrolls
        while True:
            k = _expand_unroll(f, f.body)
            n += k
            if k == 0:
                break
    return n


from ..passmgr import Pass, register_pass  # noqa: E402


@register_pass
class Unroll(Pass):
    """Full unroll_for expansion (pre-codegen)."""

    name = "unroll"

    def run(self, module: Module) -> int:
        return unroll_loops(module)
