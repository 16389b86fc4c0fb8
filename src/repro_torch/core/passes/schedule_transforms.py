"""First-class schedule transforms (the paper's actual pitch: "optimizations
such as retiming and pipelining" expressed as ordinary IR transformations
over the explicit schedule):

  * ``pipeline-loop``  — rewrite a sequential ``hir.for``'s schedule to a
    legal minimum-II pipeline.  Candidates are innermost loops whose yield
    fires at II = body span (e.g. the output of
    ``hls_schedule(pipeline_loops=False)`` or any conservatively scheduled
    design).  The pass strips the old balancing delays, rebuilds the body
    schedule with the shared modulo engine at the smallest feasible II
    (bounded below by the recurrence and port-bank resource constraints,
    from the cached dependence/touch analyses), then re-inserts the
    ``hir.delay`` balancing so every operand arrives exactly at its
    consumption cycle.

  * ``retime``         — hoist delays across combinational ops to shorten
    critical chains and shrink shift-register depth: when every non-constant
    operand of a comb op is a single-use ``hir.delay`` arriving exactly at
    the op's cycle, the op moves k cycles earlier and a single output delay
    replaces the input chains.  Fires only when it strictly reduces shift
    register bits (several input chains merge into one output chain, or a
    narrowing op moves ahead of its delay); the saving shows up in the
    ``Netlist`` resource model.

Both passes are driven by the AnalysisManager-cached analyses declared in
``core.analysis`` and preserve/invalidate them accordingly.
"""

from __future__ import annotations

from typing import Optional

from .. import ir
from ..analysis import (DependenceAnalysis, MemTouchAnalysis,
                        scheduled_op_latency)
from ..ir import ForOp, FuncOp, Module, Operation, Time
from ..passmgr import Pass, PatternRewritePass, register_pass
from ..rewrite import PatternRewriter, RewritePattern, RewritePatternSet
from ..schedule import (CLOCK_NS, COMB_DELAY, access_bank_key, balance_delays,
                        try_modulo_schedule)

# ---------------------------------------------------------------------------
# pipeline-loop
# ---------------------------------------------------------------------------


def _body_latency(op: Operation) -> int:
    """Latency of an innermost-loop body op (no loop children, so the shared
    timing model needs no loop-latency table)."""
    return scheduled_op_latency(op, {})


def _pipeline_candidate(loop: ForOp) -> Optional[int]:
    """Current (sequential) II if ``loop`` is an innermost hir.for whose
    whole body is scheduled on its own time variable; None otherwise."""
    if loop.opname != "for":
        return None
    y = loop.yield_op()
    if y is None or y.start is None or y.start.tv is not loop.time_var:
        return None
    if loop.attrs.get("pipelined_ii") == y.start.offset:
        return None  # already at the II this pass found; don't re-churn
    for op in loop.region(0).ops:
        if isinstance(op, ForOp):
            return None
        if op.opname in ("constant", "yield"):
            continue
        if op.start is None or op.start.tv is not loop.time_var:
            return None
    return y.start.offset


def _strip_delays(loop: ForOp) -> int:
    """Remove pure balancing delays from the loop body (forward sources);
    the fresh schedule re-balances from scratch.  One pass suffices: SSA
    dominance orders a delay-of-delay after its source, whose own RAUW has
    already rewritten the outer delay's operand."""
    n = 0
    for op in list(loop.region(0).ops):
        if op.opname == "delay":
            op.result.replace_all_uses_with(op.operands[0])
            op.erase()
            n += 1
    return n


@register_pass
class PipelineLoop(Pass):
    """Minimum-II modulo pipelining of sequential innermost loops."""

    name = "pipeline-loop"
    # schedules move: loop info, port congruence classes and the dependence
    # graph all change; nothing is preserved.
    preserves: tuple[str, ...] = ()

    def run(self, module: Module) -> int:
        n = 0
        for f in self.each_func(module):
            n += self.run_on_func(f)
        return n

    def run_on_func(self, f: FuncOp) -> int:
        # candidates, prefiltered by the resource lower bound — one access
        # per cycle per port bank, computable before stripping delays (bank
        # keys never involve delay results: distributed indices are
        # compile-time constants)
        candidates: list[tuple[ForOp, int, int]] = []  # (loop, cur_ii, res_mii)
        for loop in f.body.walk():
            if not isinstance(loop, ForOp):
                continue
            cur_ii = _pipeline_candidate(loop)
            if cur_ii is None or cur_ii < 2:
                continue
            per_bank: dict[tuple, int] = {}
            for o in loop.region(0).ops:
                if o.opname in ("mem_read", "mem_write"):
                    k = access_bank_key(o)
                    per_bank[k] = per_bank.get(k, 0) + 1
            res_mii = max(per_bank.values(), default=1)
            if res_mii >= cur_ii:
                loop.attrs["pipelined_ii"] = cur_ii  # provably no better II
                continue
            candidates.append((loop, cur_ii, res_mii))
        if not candidates:
            return 0

        # strip every candidate's balancing delays up front, then compute
        # the cached analyses once for the whole function
        stripped = {loop: _strip_delays(loop) for loop, _, _ in candidates}
        if self.am is not None:
            self.am.invalidate(func=f)  # stripped delays: op operands changed
        touches = self.get_analysis(MemTouchAnalysis, f)
        dep = self.get_analysis(DependenceAnalysis, f)

        rewrites = churn = 0
        for loop, cur_ii, res_mii in candidates:
            if self._pipeline(loop, cur_ii, res_mii, dep, touches):
                rewrites += 1
            else:
                # infeasible probe: its stripped delays are churn that the
                # final balance pass re-inserts
                churn += stripped[loop]
        # schedules changed (or balancing delays were stripped while probing
        # an infeasible candidate): refresh the cached analyses, then
        # re-balance — the repeated verification inside reuses the fresh
        # loop info across its fixpoint iterations.
        if self.am is not None:
            self.am.invalidate(func=f)
        balance_delays(f, am=self.am)
        if self.am is not None:
            self.am.invalidate(func=f)
        # churn counts as rewrites: the IR did change, and the PassManager's
        # clean-pass bookkeeping must not treat the module as untouched.
        return rewrites + churn

    @staticmethod
    def _pipeline(loop: ForOp, cur_ii: int, res_mii: int, dep, touches) -> bool:
        """Re-schedule one candidate at the smallest feasible II < cur_ii;
        True iff the loop was pipelined."""
        tv = loop.time_var
        ops = [o for o in loop.region(0).ops
               if o.opname not in ("constant", "alloc", "yield", "return", "time")]
        edges = dep.for_loop(loop)
        for ii in range(max(1, res_mii), cur_ii):
            t = try_modulo_schedule(ops, edges, ii, _body_latency, touches.of)
            if t is None:
                continue
            for op, cyc in t.items():
                op.start = Time(tv, cyc)
                for r in op.results:
                    if ir.is_primitive(r.type):
                        r.birth = Time(tv, cyc + _body_latency(op))
            loop.yield_op().start = Time(tv, ii)
            loop.attrs["pipelined_ii"] = ii
            return True
        # infeasible below cur_ii: remember so later runs don't re-probe
        loop.attrs["pipelined_ii"] = cur_ii
        return False


def pipeline_loops(module: Module) -> int:
    return PipelineLoop().run(module)


# ---------------------------------------------------------------------------
# retime
# ---------------------------------------------------------------------------


def _width(t: ir.Type) -> int:
    if isinstance(t, (ir.IntType, ir.FloatType)):
        return t.width
    return 32  # !hir.const: placeholder width, never materialised


def _chain_arrival_ns(v, tv, off) -> float:
    """Worst-case combinational arrival time (ns) of ``v`` within cycle
    ``(tv, off)``: 0 for registered / other-cycle producers, else the
    producer's own chain plus its gate delay — the scheduler's operator
    chaining model (``core.schedule``)."""
    d = v.defining_op
    if d is None or d.opname not in ir.ARITH_OPS or d.attrs.get("stages", 0):
        return 0.0
    if d.start is None or d.start.tv is not tv or d.start.offset != off:
        return 0.0
    depth = max((_chain_arrival_ns(o, tv, off) for o in d.operands), default=0.0)
    return depth + COMB_DELAY.get(d.opname, 0.0)


class HoistDelayPattern(RewritePattern):
    """``op(delay(a, k), delay(b, k'), ...) at t`` — when every non-constant
    operand is a single-use delay arriving exactly at ``t`` — becomes
    ``delay(op(a', b', ...) at t-k, k)`` with the input chains shortened by
    ``k = min depth``.  Sound because each stripped operand is, by
    construction, valid exactly at the op's new earlier cycle; the output
    delay reproduces the original result timing bit-for-bit."""

    ops = tuple(ir.ARITH_OPS)

    def match_and_rewrite(self, op: Operation, rewriter: PatternRewriter) -> bool:
        if op.start is None or op.attrs.get("stages", 0) or not op.results:
            return False
        use = Time(op.start.tv, op.start.offset)
        delays: list[Operation] = []
        for v in op.operands:
            d = v.defining_op
            if d is not None and d.opname == "delay" and d.attrs["by"] >= 1 \
                    and v.num_uses == 1 and v.birth is not None \
                    and v.birth.tv is use.tv and v.birth.offset == use.offset:
                delays.append(d)
            elif ir.const_value(v) is not None:
                continue  # constants are always valid, at any cycle
            else:
                return False
        if not delays:
            return False
        k = min(d.attrs["by"] for d in delays)
        if op.start.offset - k < 0:
            return False
        # strict register saving: input chain bits removed > output bits added
        if sum(_width(d.result.type) for d in delays) <= _width(op.result.type):
            return False
        # clock budget: fully folding a delay (by == k) merges the op into
        # its source's cycle — the combinational chain through the source
        # must still fit the 200 MHz budget the scheduler enforced when it
        # split them.  Shortened delays (by > k) stay registered: arrival 0.
        new_off = op.start.offset - k
        arrival = max((_chain_arrival_ns(d.operands[0], use.tv, new_off)
                       for d in delays if d.attrs["by"] == k), default=0.0)
        if arrival + COMB_DELAY.get(op.opname, 0.0) > CLOCK_NS:
            return False

        # shorten (or fold away) each input chain
        for d in delays:
            i = op.operands.index(d.result)
            if d.attrs["by"] == k:
                rewriter.set_operand(op, i, d.operands[0])
                rewriter.erase_op(d)
            else:
                d.attrs["by"] -= k
                src = d.operands[0]
                d.result.birth = (src.birth + d.attrs["by"] if src.birth is not None
                                  else (d.start + d.attrs["by"] if d.start is not None else None))
                rewriter.notify_modified(d)
        # move the op k cycles earlier
        op.start = Time(use.tv, use.offset - k)
        op.result.birth = op.start
        rewriter.notify_modified(op)
        # one shared output delay restores the original timing
        users = [u for u in op.result.uses]
        nd = ir.delay(op.result, k, start=op.start, loc=op.loc)
        rewriter.insert_after(op, nd)
        for u in users:
            rewriter.set_operand(u.op, u.index, nd.result)
        return True


_RETIME_SET = RewritePatternSet([HoistDelayPattern()])


@register_pass
class Retime(PatternRewritePass):
    """Delay hoisting across combinational ops (shift-register sharing).
    Completion times are bit-for-bit preserved, so the loop analysis and the
    port congruence classes stay valid."""

    name = "retime"
    preserves = ("loop-info", "port-accesses")

    def patterns(self, func: FuncOp) -> RewritePatternSet:
        return _RETIME_SET


def retime(module: Module) -> int:
    return Retime().run(module)
