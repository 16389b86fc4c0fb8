"""Schedule verification (paper §6.1).

The verifier exploits HIR's two sources of static information — the explicit
schedule of every operation and the validity time of every SSA value — to
detect, at compile time, bugs that an HDL cannot express and an HLS compiler
hides inside its scheduler:

  * *mismatched delay* — an operation consumes a value in a cycle where it is
    not valid (paper Fig. 1: a pipelined loop's induction variable used one
    cycle too late; paper Fig. 2: pipeline imbalance after a retiming).
  * *port conflicts* — two accesses on the same memref port that can occur in
    the same cycle at (potentially) different addresses; with pipelining this
    includes congruence-class overlap (offset mod II).
  * structural errors — unscheduled ops, yields missing, time variables used
    outside their lexical scope, distributed dims indexed dynamically.

Diagnostics carry source locations and a "prior definition here" note, in the
style of the paper's Figure 1b/2b listings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import ir
from .analysis import (LoopAnalysis, LoopInfo, PortAccessAnalysis,
                       analyze_loops, collect_port_accesses,
                       span_completion_offset)
from .ir import CONST, ForOp, FuncOp, Module, Operation, Region, Time, Value
from .passmgr import AnalysisManager


@dataclass
class Diagnostic:
    severity: str  # "error" | "warning"
    loc: ir.Loc
    message: str
    notes: list[tuple[ir.Loc, str]] = field(default_factory=list)

    def render(self) -> str:
        out = f"{self.loc}: {self.severity}:\n{self.message}"
        for loc, msg in self.notes:
            out += f"\n{loc}: note: {msg}"
        return out


class VerifyError(Exception):
    def __init__(self, diags: list[Diagnostic]):
        self.diags = diags
        super().__init__("\n\n".join(d.render() for d in diags))


OPERAND_DESC = {0: "left operand", 1: "right operand", 2: "third operand"}


class Verifier:
    def __init__(self, func: FuncOp, strict_schedule: bool = True,
                 am: Optional[AnalysisManager] = None):
        self.func = func
        self.strict = strict_schedule
        self.am = am  # shared analysis cache (loop info, port accesses)
        self.diags: list[Diagnostic] = []
        self.loops: dict[ForOp, LoopInfo] = {}
        # validity windows: value -> (root tv, birth offset, window len | None=inf)
        self.windows: dict[Value, Optional[tuple[Value, int, Optional[int]]]] = {}

    # ------------------------------------------------------------------
    def error(self, loc: ir.Loc, msg: str, notes: Optional[list[tuple[ir.Loc, str]]] = None) -> None:
        self.diags.append(Diagnostic("error", loc, msg, notes or []))

    def warn(self, loc: ir.Loc, msg: str, notes: Optional[list[tuple[ir.Loc, str]]] = None) -> None:
        self.diags.append(Diagnostic("warning", loc, msg, notes or []))

    # ------------------------------------------------------------------
    def run(self) -> list[Diagnostic]:
        self.loops = (self.am.get(LoopAnalysis, self.func) if self.am is not None
                      else analyze_loops(self.func))
        self._iv_loop = {l.iv: li for l, li in self.loops.items()}
        self._build_root_tree()
        self._compute_windows()
        self._verify_region(self.func.body, scope_tvs={self.func.time_var})
        self._verify_ports()
        return self.diags

    # -- time-variable hierarchy -------------------------------------------
    def _build_root_tree(self) -> None:
        """parent link + minimum start offset for every time variable, so that
        always-valid values (infinite windows) can be consumed inside
        descendant scopes (e.g. a sequential loop's IV used in a nested
        pipelined loop, as in the paper's transpose listing)."""
        self.root_parent: dict[Value, tuple[Value, int]] = {}
        for op in self.func.body.walk():
            if isinstance(op, ForOp) and op.start is not None:
                self.root_parent[op.time_var] = (op.start.tv, op.start.offset)
                self.root_parent[op.end_time] = (op.start.tv, op.start.offset)
            elif op.opname == "time":
                self.root_parent[op.result] = (op.operands[0], op.attrs.get("offset", 0))

    def _min_abs_offset(self, tv: Value, ancestor: Value) -> Optional[int]:
        """Lower bound on (tv's instant - ancestor's instant); None if tv is
        not a descendant of ancestor."""
        off = 0
        cur = tv
        for _ in range(1000):
            if cur is ancestor:
                return off
            nxt = self.root_parent.get(cur)
            if nxt is None:
                return None
            cur, step = nxt[0], nxt[1]
            off += step
        return None  # pragma: no cover

    # -- validity windows ------------------------------------------------
    def _compute_windows(self) -> None:
        w = self.windows
        # function arguments
        for a, d in zip(self.func.args, self.func.attrs["arg_delays"]):
            if ir.is_primitive(a.type):
                w[a] = (self.func.time_var, d, 1)
            else:
                w[a] = None  # memrefs: always valid
        for op in self.func.body.walk():
            if op.opname == "constant":
                w[op.result] = None
            elif op.opname == "alloc":
                for r in op.results:
                    w[r] = None
            elif op.opname == "time":
                w[op.result] = None
            elif isinstance(op, ForOp):
                li = self.loops[op]
                if op.opname == "unroll_for":
                    # unroll IVs are compile-time constants: always valid
                    w[op.iv] = None
                elif li.ii is not None and op.yield_op() is not None and \
                        op.yield_op().start is not None and op.yield_op().start.tv is op.time_var:
                    # pipelined loop: IV regenerated every II cycles
                    w[op.iv] = (op.time_var, 0, max(1, li.ii))
                else:
                    # sequential loop: IV persists across the whole iteration
                    w[op.iv] = (op.time_var, 0, None)
                w[op.time_var] = None
                w[op.end_time] = None
            elif op.opname == "mem_read":
                lat = op.operands[0].type.read_latency()
                if op.start is not None:
                    w[op.result] = (op.start.tv, op.start.offset + lat, 1)
            elif op.opname == "delay":
                src = w.get(op.operands[0])
                if src is not None:
                    tv, off, ln = src
                    w[op.result] = (tv, off + op.attrs["by"], ln)
                elif op.start is not None:
                    w[op.result] = (op.start.tv, op.start.offset + op.attrs["by"], 1)
                else:
                    w[op.result] = None
            elif op.opname == "call":
                if op.start is not None:
                    for r, d in zip(op.results, op.attrs["result_delays"]):
                        w[r] = (op.start.tv, op.start.offset + d, 1)
            elif op.opname in ir.ARITH_OPS:
                stages = op.attrs.get("stages", 0)
                if op.start is not None:
                    w[op.result] = (op.start.tv, op.start.offset + stages, 1)
                else:
                    # Combinational op without explicit schedule: its result is
                    # valid on the *intersection* of the operand windows.  An
                    # empty intersection is the paper's Fig. 2 pipeline
                    # imbalance (reported in _verify_op).
                    w[op.result] = self._intersect_windows(op, stages)

    def _intersect_windows(self, op: Operation, stages: int):
        wins = [self.windows.get(v) for v in op.operands]
        wins = [x for x in wins if x is not None]
        if not wins:
            return None  # all operands always-valid => result always-valid
        # pick the deepest root; ancestors with infinite windows impose no
        # constraint (they are valid throughout the descendant scope).
        deepest = wins[0][0]
        for tv, _, _ in wins[1:]:
            if tv is deepest:
                continue
            if self._min_abs_offset(tv, deepest) is not None:
                deepest = tv
        lo, hi = 0, None
        ok = True
        for tv, off, ln in wins:
            if tv is deepest:
                lo = max(lo, off)
                if ln is not None:
                    hi = off + ln if hi is None else min(hi, off + ln)
            elif ln is None and self._min_abs_offset(deepest, tv) is not None:
                continue  # infinite-window ancestor value
            else:
                ok = False  # cross-root finite window: flagged at use sites
        if not ok:
            return wins[0]
        if hi is not None and hi <= lo:
            return (deepest, lo, 0)  # empty window -> imbalance
        if stages:
            return (deepest, lo + stages, 1)
        return (deepest, lo, None if hi is None else hi - lo)

    # -- per-op checks -----------------------------------------------------
    def _check_use(self, op: Operation, v: Value, use_time: Time, desc: str) -> None:
        win = self.windows.get(v, None)
        if win is None:
            return  # always-valid (const, memref, time)
        tv, off, ln = win
        if tv is not use_time.tv:
            if ln is None:
                # persistent value (e.g. sequential-loop IV): legal inside any
                # descendant scope that starts no earlier than its birth.
                d = self._min_abs_offset(use_time.tv, tv)
                if d is not None and d + use_time.offset >= off:
                    return
            else:
                # sequential loop IV (II >= body span, HLS-style yield on the
                # loop's own time variable): iterations never overlap and
                # every nested scope completes within the iteration window,
                # so descendant-scope uses after the birth are safe.  Only
                # sound when the span actually bounds the whole body — a
                # nested scope whose latency is not statically derivable is
                # silently absent from body_span and may outlive the window.
                li = self._iv_loop.get(v)
                if li is not None and li.ii is not None and li.ii >= li.body_span \
                        and self._body_statically_bounded(li.op):
                    d = self._min_abs_offset(use_time.tv, tv)
                    if d is not None and d + use_time.offset >= off:
                        return
            self.error(
                op.loc,
                f"Schedule error: operand {desc} is defined under time variable "
                f"%{tv.name} but used under %{use_time.tv.name}; insert hir.delay "
                f"or reschedule.",
                notes=self._def_note(v),
            )
            return
        u = use_time.offset
        end = None if ln is None else off + ln
        if u < off or (end is not None and u >= end):
            self.error(
                op.loc,
                f"Schedule error: mismatched delay ({off} vs {u}) in {desc}!",
                notes=self._def_note(v),
            )

    def _body_statically_bounded(self, loop: ForOp) -> bool:
        """True iff every scheduled child of ``loop``'s body has a completion
        offset that ``analyze_loops`` could derive (and therefore included in
        ``body_span``) — the precondition for treating II >= span as "the
        iteration window contains everything"."""
        cached = getattr(self, "_bounded_cache", None)
        if cached is None:
            cached = self._bounded_cache = {}
        if loop in cached:
            return cached[loop]
        root = loop.time_var
        ok = True
        for op in loop.region(0).ops:
            if op.opname in ("constant", "alloc", "time", "return"):
                continue
            if op.start is None and not isinstance(op, ForOp):
                continue  # unscheduled comb op: anchored via its consumers
            if span_completion_offset(op, root, self.loops) is None:
                ok = False
                break
        cached[loop] = ok
        return ok

    def _def_note(self, v: Value) -> list[tuple[ir.Loc, str]]:
        d = v.defining_op
        if d is not None:
            return [(d.loc, "Prior definition here.")]
        if v in self.func.args:
            return [(self.func.loc, "Function argument defined here.")]
        # loop induction variable / time var
        for op in self.func.body.walk():
            if isinstance(op, ForOp) and (v is op.iv or v is op.time_var):
                return [(op.loc, "Prior definition here.")]
        return []

    def _verify_region(self, region: Region, scope_tvs: set[Value]) -> None:
        seen_yield = False
        parent = region.parent_op
        for op in region.ops:
            # scheduling root must be lexically visible (paper §4.2: ops in a
            # loop body only see the iteration time variable).
            if op.start is not None and op.start.tv not in scope_tvs:
                self.error(
                    op.loc,
                    f"Schedule error: time variable %{op.start.tv.name} is not "
                    f"visible in this scope.",
                )
            if op.start is None and self.strict and op.opname not in (
                "constant", "alloc", "return", "time",
            ) and op.opname not in ir.ARITH_OPS:
                self.error(op.loc, f"unscheduled operation hir.{op.opname} in strict mode")

            self._verify_op(op, scope_tvs)

            if op.opname == "yield":
                seen_yield = True
            # derived time variables become visible after their defining op
            if op.opname == "time":
                scope_tvs = scope_tvs | {op.result}
            if isinstance(op, ForOp):
                scope_tvs = scope_tvs | {op.end_time}
                self._verify_region(op.region(0), {op.time_var})

        if parent is not None and isinstance(parent, ForOp) and not seen_yield:
            self.error(parent.loc, "hir.for body must contain hir.yield")

    def _verify_op(self, op: Operation, scope_tvs: set[Value]) -> None:
        o = op.opname
        if o in ir.ARITH_OPS and op.start is not None:
            for i, v in enumerate(op.operands):
                self._check_use(op, v, op.start, OPERAND_DESC.get(i, f"operand {i}"))
        elif o in ir.ARITH_OPS and op.start is None:
            # empty validity intersection => mismatched operand births (Fig. 2)
            win = self.windows.get(op.result)
            if win is not None and win[2] == 0:
                births = [(v, self.windows.get(v)) for v in op.operands]
                births = [(v, b) for v, b in births if b is not None and b[0] is win[0]]
                offs = sorted(b[1][1] for b in births)
                worst = max(births, key=lambda b: b[1][1])[0]
                self.error(
                    op.loc,
                    f"Schedule error: mismatched delay ({offs[0]} vs {offs[-1]}) in right operand!",
                    notes=self._def_note(worst),
                )
        elif o == "mem_read":
            mem, idx = ir.mem_read_parts(op)
            self._check_indices(op, mem, idx)
        elif o == "mem_write":
            val, mem, idx, pred = ir.mem_write_parts(op)
            if op.start is not None:
                self._check_use(op, val, op.start, "written value")
                if pred is not None:
                    self._check_use(op, pred, op.start, "write predicate")
            self._check_indices(op, mem, idx)
        elif o == "alloc":
            if op.parent_region is not self.func.body:
                self.error(op.loc, "hir.alloc must be at function scope (hardware is statically instantiated)")
        elif o == "delay":
            pass  # delay is precisely the op that legalises cross-cycle moves
        elif o == "call":
            if op.start is not None:
                for i, v in enumerate(op.operands):
                    self._check_use(op, v, op.start, f"argument {i}")
        elif isinstance(op, ForOp):
            for i, v in enumerate((op.lb, op.ub, op.step)):
                if op.start is not None and self.windows.get(v) is not None:
                    self._check_use(op, v, op.start, ("lower bound", "upper bound", "step")[i])
            if op.opname == "unroll_for" and op.trip_count() is None:
                self.error(op.loc, "hir.unroll_for requires compile-time constant bounds")

    def _check_indices(self, op: Operation, mem: Value, idx: list[Value]) -> None:
        mt = mem.type
        if not isinstance(mt, ir.MemrefType):
            self.error(op.loc, f"memory access on non-memref value %{mem.name}")
            return
        for pos, v in enumerate(idx):
            if pos in mt.distributed and not isinstance(v.type, ir.ConstType):
                self.error(
                    op.loc,
                    f"Schedule error: distributed dimension {pos} of %{mem.name} "
                    f"must be indexed by a compile-time constant (!hir.const).",
                    notes=self._def_note(v),
                )
            if op.start is not None:
                self._check_use(op, v, op.start, f"address {pos}")

    # -- memory port conflicts ------------------------------------------------
    def _verify_ports(self) -> None:
        accesses = (self.am.get(PortAccessAnalysis, self.func) if self.am is not None
                    else collect_port_accesses(self.func, self.loops))
        for port, accs in accesses.items():
            for i in range(len(accs)):
                for j in range(i + 1, len(accs)):
                    a, b = accs[i], accs[j]
                    if a.root is not b.root:
                        continue  # cross-root overlap: runtime assertion territory
                    conflict = False
                    if a.offsets_mod and b.offsets_mod and a.offsets_mod[1] == b.offsets_mod[1]:
                        conflict = a.offsets_mod[0] == b.offsets_mod[0]
                    elif a.offset is not None and b.offset is not None and not (a.offsets_mod or b.offsets_mod):
                        conflict = a.offset == b.offset
                    if not conflict:
                        continue
                    if self._same_addresses(a.op, b.op):
                        continue
                    # distinct distributed-dim constants => different banks
                    if self._distinct_banks(a.op, b.op):
                        continue
                    self.error(
                        b.op.loc,
                        f"Schedule error: two accesses on memref port %{port.name} "
                        f"in the same cycle with different addresses (UB §4.5).",
                        notes=[(a.op.loc, "Conflicting access here.")],
                    )

    @staticmethod
    def _indices(op: Operation) -> list[Value]:
        return ir.mem_op_indices(op)

    def _same_addresses(self, a: Operation, b: Operation) -> bool:
        ia, ib = self._indices(a), self._indices(b)
        return all(x is y or (ir.const_value(x) is not None and ir.const_value(x) == ir.const_value(y))
                   for x, y in zip(ia, ib))

    def _distinct_banks(self, a: Operation, b: Operation) -> bool:
        mem = a.operands[0] if a.opname == "mem_read" else a.operands[1]
        mt: ir.MemrefType = mem.type  # type: ignore[assignment]
        ia, ib = self._indices(a), self._indices(b)
        for pos in mt.distributed:
            ca, cb = ir.const_value(ia[pos]), ir.const_value(ib[pos])
            if ca is not None and cb is not None and ca != cb:
                return True
        return False


def verify_func(func: FuncOp, strict_schedule: bool = True,
                am: Optional[AnalysisManager] = None) -> list[Diagnostic]:
    return Verifier(func, strict_schedule, am=am).run()


def validity_windows(func: FuncOp, am: Optional[AnalysisManager] = None) -> Verifier:
    """Compute only the value-validity windows (loop analysis + time-variable
    root tree + window propagation) without running the quadratic op/port
    legality checks.  Linear in the function size; this is what pipeline
    balancing (``core.schedule.balance_delays``) iterates on, where the full
    ``Verifier.run`` would dominate the whole HLS search."""
    v = Verifier(func, strict_schedule=False, am=am)
    v.loops = (am.get(LoopAnalysis, func) if am is not None else analyze_loops(func))
    v._iv_loop = {l.iv: li for l, li in v.loops.items()}
    v._build_root_tree()
    v._compute_windows()
    return v


def verify(module_or_func, strict_schedule: bool = True, raise_on_error: bool = True,
           am: Optional[AnalysisManager] = None) -> list[Diagnostic]:
    """Verify a module or function.  ``am`` shares the cached loop/port
    analyses with the optimizer and codegen (see ``core.passmgr``)."""
    funcs = (
        [module_or_func]
        if isinstance(module_or_func, FuncOp)
        else [f for f in module_or_func.funcs.values() if not f.attrs.get("external")]
    )
    diags: list[Diagnostic] = []
    for f in funcs:
        diags.extend(verify_func(f, strict_schedule, am=am))
    errs = [d for d in diags if d.severity == "error"]
    if errs and raise_on_error:
        raise VerifyError(errs)
    return diags
