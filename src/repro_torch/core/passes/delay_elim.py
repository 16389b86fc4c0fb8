"""Delay elimination / shift-register sharing (paper §6.4).

  * ``delay %v by 0``            -> forwarded to %v (worklist pattern)
  * two delays of the same source with depths a < b: the deeper one re-taps
    the shallower chain — ``delay %v by b`` becomes ``delay (delay %v by a)
    by b-a`` — so codegen emits one shared shift-register chain with taps
    instead of two parallel chains (a+b-a registers instead of a+b).
  * exact duplicates are removed by ``cse``; this pass handles partial overlap.

Zero-delay forwarding is a local pattern on the greedy driver; chain sharing
needs to see all delays of a region at once and stays a region walk."""

from __future__ import annotations

from collections import defaultdict

from .. import ir
from ..ir import FuncOp, Module, Operation, Region
from ..passmgr import Pass, register_pass
from ..rewrite import PatternRewriter, RewritePattern, RewritePatternSet, apply_patterns_greedily


class ZeroDelayForwardPattern(RewritePattern):
    """delay %v by 0 -> %v."""

    ops = ("delay",)

    def match_and_rewrite(self, op: Operation, rewriter: PatternRewriter) -> bool:
        if op.attrs["by"] != 0:
            return False
        rewriter.replace_op(op, [op.operands[0]])
        return True


def _share_chains(region: Region) -> int:
    n = 0
    by_src: dict[int, list[Operation]] = defaultdict(list)
    for op in region.ops:
        if op.opname == "delay" and op.attrs["by"] > 0 and not op.attrs.get("shared"):
            by_src[op.operands[0].id].append(op)
        for r in op.regions:
            n += _share_chains(r)
    order = {id(op): i for i, op in enumerate(region.ops)}
    for _, group in by_src.items():
        if len(group) < 2:
            continue
        group.sort(key=lambda o: o.attrs["by"])
        for prev, cur in zip(group, group[1:]):
            # preserve SSA textual dominance: only re-tap when the
            # shallower chain is defined first
            if cur.attrs["by"] > prev.attrs["by"] and order.get(id(prev), 1 << 30) < order.get(id(cur), -1):
                cur.set_operand(0, prev.result)
                cur.attrs["by"] = cur.attrs["by"] - prev.attrs["by"]
                cur.attrs["shared"] = True
                n += 1
    return n


_ZERO_DELAY_SET = RewritePatternSet([ZeroDelayForwardPattern()])


@register_pass
class DelayElim(Pass):
    name = "delay-elim"
    # re-tapped chains keep every tap's absolute completion time; no memory
    # ops are touched
    preserves = ("loop-info", "port-accesses")

    def run(self, module: Module) -> int:
        n = 0
        for f in self.each_func(module):
            n += apply_patterns_greedily(f.body, _ZERO_DELAY_SET)
            n += _share_chains(f.body)
        return n


def delay_elim(module: Module) -> int:
    return DelayElim().run(module)
