"""Common-subexpression elimination (paper §6.2).

Combinational ops are time-free wires, so two arith ops with identical
(opname, operands, attrs) compute the same signal regardless of their
schedule annotation and can share hardware.  Delays additionally require the
same source *and* the same depth (partial sharing of shift-register chains is
done by ``delay_elim``).

CSE is inherently a scoped-hash-table pass, not a local pattern: it runs as a
single region walk, but replacement now goes through the maintained use-def
chains (O(#uses) per merged op instead of O(region))."""

from __future__ import annotations

from .. import ir
from ..ir import Module, Operation, Region
from ..passmgr import Pass, register_pass


def _key(op: Operation):
    if op.opname in ir.ARITH_OPS:
        stages = op.attrs.get("stages", 0)
        if stages:
            # pipelined units also need identical schedules to share
            st = (op.start.tv.id, op.start.offset) if op.start is not None else None
            return ("arith", op.opname, tuple(v.id for v in op.operands), stages, st)
        return ("arith", op.opname, tuple(v.id for v in op.operands), 0, None)
    if op.opname == "delay":
        return ("delay", op.operands[0].id, op.attrs["by"])
    if op.opname == "constant":
        return ("const", str(op.result.type), op.attrs["value"])
    return None


@register_pass
class CSE(Pass):
    name = "cse"
    # only pure ops merge (never memory accesses); merged ops share identical
    # completion times, so schedules and port tables are unchanged
    preserves = ("loop-info", "port-accesses")

    def run(self, module: Module) -> int:
        n = 0
        for f in self.each_func(module):

            def run_region(region: Region, seen: dict) -> int:
                m = 0
                keep = []
                for op in region.ops:
                    k = _key(op)
                    if k is not None and op.results:
                        if k in seen:
                            op.result.replace_all_uses_with(seen[k])
                            op.drop_all_uses()
                            m += 1
                            continue
                        seen[k] = op.result
                    for r in op.regions:
                        # nested scopes may reuse outer expressions but not
                        # vice versa: pass a child view of the map
                        m += run_region(r, dict(seen))
                    keep.append(op)
                region.ops[:] = keep
                return m

            n += run_region(f.body, {})
        return n


def cse(module: Module) -> int:
    return CSE().run(module)
