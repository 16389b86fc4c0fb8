"""Schedule-aware RAM port demotion (paper §2 "Ease of optimization"):

    "if a distributed RAM is defined as simple dual port but the read and
     write operation's schedules do not overlap, we can replace it with a
     single port RAM to save resources."

For every ``hir.alloc`` with both a read and a write port we prove, from the
explicit schedule, that no read and write can ever land in the same cycle:

  * same pipelined loop: disjoint congruence classes (offset mod II);
  * same root, no pipelining: distinct constant offsets;
  * different roots: one root's chain passes through the other loop's end
    time (phases are sequentially ordered, e.g. a drain loop scheduled at
    ``%loop_end offset k``).

Provably-disjoint allocs get ``attrs["single_port"] = True``; the resource
model then costs one RAM port instead of two."""

from __future__ import annotations

from typing import Optional

from .. import ir
from ..analysis import MemAccess
from ..ir import ForOp, FuncOp, Module, Value


def _roots_ordered(func: FuncOp, a_root: Value, b_root: Value) -> bool:
    """True if every instant under one root is provably after every instant
    under the other (chain passes through the other's loop end_time)."""
    loop_of_root: dict[Value, ForOp] = {}
    parent: dict[Value, Value] = {}
    for op in func.body.walk():
        if isinstance(op, ForOp):
            loop_of_root[op.time_var] = op
            if op.start is not None:
                parent[op.time_var] = op.start.tv
                parent[op.end_time] = op.start.tv
        elif op.opname == "time":
            parent[op.result] = op.operands[0]

    def chain(tv: Value) -> list[Value]:
        out = [tv]
        seen = {tv}
        while tv in parent:
            tv = parent[tv]
            if tv in seen:
                break
            seen.add(tv)
            out.append(tv)
        return out

    def passes_through_end_of(tv: Value, other_root: Value) -> bool:
        other_loop = loop_of_root.get(other_root)
        if other_loop is None:
            return False
        # does tv's derivation chain include other_loop.end_time, or the end
        # time of any loop enclosing other_root?
        ends = {other_loop.end_time}
        cur = other_root
        while cur in parent:
            cur = parent[cur]
            if cur in loop_of_root:
                ends.add(loop_of_root[cur].end_time)
        return any(v in ends for v in chain(tv))

    return passes_through_end_of(a_root, b_root) or passes_through_end_of(b_root, a_root)


def _disjoint(func: FuncOp, a: MemAccess, b: MemAccess) -> bool:
    if a.root is b.root:
        if a.offsets_mod and b.offsets_mod and a.offsets_mod[1] == b.offsets_mod[1]:
            return a.offsets_mod[0] != b.offsets_mod[0]
        if not a.offsets_mod and not b.offsets_mod and a.offset is not None and b.offset is not None:
            return a.offset != b.offset
        return False
    return _roots_ordered(func, a.root, b.root)


def _demote_func(f: FuncOp, accesses: dict[Value, list[MemAccess]]) -> int:
    n = 0
    for op in f.body.walk():
        if op.opname != "alloc" or op.attrs.get("single_port") or len(op.results) < 2:
            continue
        reads: list[MemAccess] = []
        writes: list[MemAccess] = []
        for port in op.results:
            for acc in accesses.get(port, []):
                (writes if acc.is_write else reads).append(acc)
        if not reads or not writes:
            continue
        if all(_disjoint(f, r, w) for r in reads for w in writes):
            op.attrs["single_port"] = True
            n += 1
    return n


from ..passmgr import Pass, register_pass  # noqa: E402
from ..analysis import PortAccessAnalysis  # noqa: E402


@register_pass
class PortDemotion(Pass):
    """Schedule-disjointness proof over whole functions (not a local
    pattern); the schedule/port tables come from the shared analysis cache
    (computed by the verifier or a prior pass, reused here)."""

    name = "port-demotion"
    preserves_all = True  # attribute-only rewrite (alloc "single_port")

    def run(self, module: Module) -> int:
        n = 0
        for f in self.each_func(module):
            n += _demote_func(f, self.get_analysis(PortAccessAnalysis, f))
        return n


def port_demotion(module: Module) -> int:
    return PortDemotion().run(module)
