"""Schedule eraser: strips all scheduling information from an HIR design,
producing the *algorithm-only* input an HLS compiler starts from.

  * every op's ``at``-clause is dropped,
  * ``hir.delay`` ops (pure schedule artifacts) are removed and forwarded,
  * ``hir.yield`` times are dropped (the scheduler will pick the II),
  * loop ``iter_time`` offsets are dropped.

Used by the codegen-speed benchmark (paper Table 6): the HIR pipeline only
*verifies* the explicit schedule, while the HLS pipeline must *search* for
one starting from the erased design."""

from __future__ import annotations

import heapq

from .. import ir
from ..ir import ForOp, Module, Operation, Region
from ..parser import parse
from ..printer import print_module


def _topo_stable(region: Region) -> None:
    """Refine the schedule-order sort into a valid def-before-use order.

    The schedule sort alone can place a ``mem_read`` textually before the
    arith op computing its index (same cycle, reads tie-break first), which
    is fine for in-memory SSA objects but makes the printed form unparsable
    and breaks the invariant that distance-0 dependence edges point forward
    in program order.  A stable Kahn pass (ready op with the smallest
    current position wins) keeps the relative order of every pair of ops
    not transitively SSA-ordered — in particular all memory-op pairs."""
    ops = region.ops
    pos = {op: i for i, op in enumerate(ops)}
    prod: dict = {}
    for op in ops:
        for r in op.results:
            prod[r] = op

    def uses(op: Operation, acc: list) -> None:
        acc.extend(op.operands)
        if op.start is not None:
            acc.append(op.start.tv)
        for r in op.regions:
            for c in r.ops:
                uses(c, acc)

    indeg = {op: 0 for op in ops}
    succs: dict = {op: [] for op in ops}
    for op in ops:
        acc: list = []
        uses(op, acc)
        seen: set = set()
        for v in acc:
            p = prod.get(v)
            if p is not None and p is not op and id(p) not in seen:
                seen.add(id(p))
                succs[p].append(op)
                indeg[op] += 1
    heap = [pos[op] for op in ops if indeg[op] == 0]
    heapq.heapify(heap)
    out = []
    while heap:
        i = heapq.heappop(heap)
        op = ops[i]
        out.append(op)
        for s in succs[op]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, pos[s])
    if len(out) == len(ops):  # SSA graphs are acyclic; guard regardless
        region.ops[:] = out


def erase_schedule(module: Module) -> Module:
    """Returns a fresh unscheduled copy (the original is untouched)."""
    m = parse(print_module(module))  # deep copy via round-trip
    for f in m.funcs.values():
        if f.attrs.get("external"):
            continue

        def order_key(op: Operation):
            # Textual order becomes the semantic (sequential-C) order the HLS
            # compiler starts from, so first rewrite each region into the
            # original *schedule* order: reads before writes on cycle ties
            # (the hardware read-phase samples pre-write state).
            if op.opname in ("constant", "alloc"):
                return (-1, 0)
            if op.start is None:
                return (1 << 30, 0)
            return (op.start.offset, 0 if op.opname == "mem_read" else 1)

        def strip(region: Region) -> None:
            region.ops.sort(key=order_key)
            _topo_stable(region)
            keep = []
            for op in region.ops:
                if op.opname == "delay":
                    src = op.operands[0]
                    op.result.replace_all_uses_with(src)
                    op.drop_all_uses()
                    continue
                op.start = None
                for r in op.results:
                    r.birth = None
                if isinstance(op, ForOp):
                    op.attrs["iter_arg_offset"] = 0
                for r in op.regions:
                    strip(r)
                keep.append(op)
            region.ops[:] = keep

        strip(f.body)
    return m
