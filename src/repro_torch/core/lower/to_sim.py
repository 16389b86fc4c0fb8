"""Cycle-accurate simulator for scheduled HIR (the semantic oracle).

The simulator realises exactly the hardware semantics of §4.6 / Table 3:

  * every op fires at its scheduled absolute cycle,
  * RAM reads sample the address in cycle ``c`` and deliver data valid at
    ``c + latency`` (1 for LUTRAM/BRAM, 0 for registers),
  * writes commit at the *end* of their cycle (visible from ``c+1``),
  * pipelined loop iterations genuinely overlap in time,
  * memref port conflicts (two same-cycle accesses at different addresses on
    one port) raise ``SimulationError`` — these are the runtime assertions the
    Verilog backend emits for the paper's §4.5 UB rules.

Pure (combinational) scalar ops are evaluated lazily by SSA identity, which is
sound because the schedule verifier has already proven every value is consumed
within its validity window.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from .. import ir
from ..ir import ForOp, FuncOp, MemrefType, Module, Operation, Region, Time, Value


class SimulationError(Exception):
    pass


def _mask(val: int, t: ir.Type) -> Union[int, float]:
    if isinstance(t, ir.FloatType):
        return float(val)
    if isinstance(t, ir.ConstType):
        return val
    assert isinstance(t, ir.IntType)
    w = t.width
    v = int(val) & ((1 << w) - 1)
    if t.signed and v >= (1 << (w - 1)):
        v -= 1 << w
    return v


_ARITH_EVAL: dict[str, Callable[..., Any]] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mult": lambda a, b: a * b,
    "div": lambda a, b: (a // b if isinstance(a, int) and isinstance(b, int) else a / b),
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "not": lambda a: ~a,
    "shl": lambda a, b: a << b,
    "shr": lambda a, b: a >> b,
    "cmp_lt": lambda a, b: int(a < b),
    "cmp_le": lambda a, b: int(a <= b),
    "cmp_eq": lambda a, b: int(a == b),
    "cmp_ne": lambda a, b: int(a != b),
    "cmp_gt": lambda a, b: int(a > b),
    "cmp_ge": lambda a, b: int(a >= b),
    "select": lambda c, a, b: a if c else b,
    "trunc": lambda a: a,
    "zext": lambda a: a,
    "sext": lambda a: a,
}


@dataclass
class _Storage:
    """Backing store for one allocated tensor (all banks)."""

    array: np.ndarray
    memref: MemrefType


class _Ctx:
    """One dynamic scope instance: binds SSA values to concrete values/thunks
    and time variables to absolute cycles."""

    __slots__ = ("vals", "times", "parent", "id")
    _ids = itertools.count()

    def __init__(self, parent: Optional["_Ctx"] = None):
        self.vals: dict[Value, Any] = {}
        self.times: dict[Value, int] = {}
        self.parent = parent
        self.id = next(self._ids)

    def lookup(self, v: Value) -> Any:
        c: Optional[_Ctx] = self
        while c is not None:
            if v in c.vals:
                return c.vals[v]
            c = c.parent
        raise SimulationError(f"unbound value %{v.name}")

    def lookup_time(self, tv: Value) -> int:
        c: Optional[_Ctx] = self
        while c is not None:
            if tv in c.times:
                return c.times[tv]
            c = c.parent
        raise SimulationError(f"unbound time variable %{tv.name}")


class Simulator:
    READ_PHASE = 0
    WRITE_PHASE = 1

    def __init__(self, module: Module, externals: Optional[dict[str, Callable]] = None,
                 check_conflicts: bool = True, max_cycles: int = 10_000_000):
        self.module = module
        self.externals = externals or {}
        self.check_conflicts = check_conflicts
        self.max_cycles = max_cycles
        self._heap: list[tuple[int, int, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._port_access: dict[tuple, dict] = {}  # (storage, port, cycle) -> {bank: packed_addr}
        self.final_cycle = 0
        self.events_executed = 0

    # -- event queue -------------------------------------------------------
    def _at(self, cycle: int, phase: int, fn: Callable[[], None]) -> None:
        if cycle > self.max_cycles:
            raise SimulationError(f"simulation exceeded {self.max_cycles} cycles")
        heapq.heappush(self._heap, (cycle, phase, next(self._seq), fn))

    def _abs_time(self, ctx: _Ctx, t: Time) -> int:
        return ctx.lookup_time(t.tv) + t.offset

    # -- value evaluation ----------------------------------------------------
    def _eval(self, ctx: _Ctx, v: Value) -> Any:
        x = ctx.lookup(v)
        if callable(x) and not isinstance(x, (_Storage,)):
            x = x()
        return x

    # -- main entry -----------------------------------------------------------
    def run(self, func_name: str, args: Sequence[Any], start_cycle: int = 0) -> dict[str, Any]:
        func = self.module.get(func_name)
        ctx = _Ctx()
        self._bind_call(func, args, ctx, start_cycle)
        self._schedule_region(func.body, ctx)
        while self._heap:
            cycle, phase, _, fn = heapq.heappop(self._heap)
            self.final_cycle = max(self.final_cycle, cycle)
            self.events_executed += 1
            fn()
        rets = {}
        for op in func.body.ops:
            if op.opname == "return" and op.operands:
                rets = {f"ret{i}": self._eval(ctx, v) for i, v in enumerate(op.operands)}
        return {"cycles": self.final_cycle - start_cycle, "returns": rets, "events": self.events_executed}

    # -- binding ---------------------------------------------------------------
    def _bind_call(self, func: FuncOp, args: Sequence[Any], ctx: _Ctx, cycle: int) -> None:
        assert len(args) == len(func.args), (func.name, len(args), len(func.args))
        ctx.times[func.time_var] = cycle
        for formal, actual in zip(func.args, args):
            if isinstance(formal.type, MemrefType):
                if isinstance(actual, _Storage):
                    ctx.vals[formal] = actual
                else:
                    arr = np.asarray(actual)
                    assert arr.shape == formal.type.shape, (arr.shape, formal.type.shape)
                    ctx.vals[formal] = _Storage(arr, formal.type)
            else:
                ctx.vals[formal] = actual

    # -- region scheduling --------------------------------------------------------
    def _schedule_region(self, region: Region, ctx: _Ctx) -> None:
        for op in region.ops:
            self._schedule_op(op, ctx)

    def _schedule_op(self, op: Operation, ctx: _Ctx) -> None:
        o = op.opname

        if o == "constant":
            ctx.vals[op.result] = op.attrs["value"]
            return

        if o == "alloc":
            base: MemrefType = op.attrs["base"]
            init = np.full(base.shape, 0, dtype=np.int64 if isinstance(base.elem, ir.IntType) else np.float64)
            st = _Storage(init, base)
            for r in op.results:
                ctx.vals[r] = st
            return

        if o == "time":
            base = ctx.lookup_time(op.operands[0]) + op.attrs.get("offset", 0)
            ctx.times[op.result] = base
            return

        if o in ir.ARITH_OPS:
            def thunk(op=op, ctx=ctx):
                vals = [self._eval(ctx, v) for v in op.operands]
                raw = _ARITH_EVAL[op.opname](*vals)
                return _mask(raw, op.result.type) if isinstance(raw, int) else raw

            ctx.vals[op.result] = thunk
            return

        if o == "delay":
            ctx.vals[op.result] = lambda op=op, ctx=ctx: self._eval(ctx, op.operands[0])
            return

        if o == "mem_read":
            cycle = self._abs_time(ctx, op.start)
            cell: dict[str, Any] = {}

            def do_read(op=op, ctx=ctx, cycle=cycle, cell=cell):
                st: _Storage = self._eval(ctx, op.operands[0])
                idx = tuple(int(self._eval(ctx, v)) for v in op.operands[1:])
                self._check_bounds(op, st, idx)
                self._check_port(op, ctx, cycle, idx)
                cell["v"] = st.array[idx].item()

            self._at(cycle, self.READ_PHASE, do_read)

            def result(cell=cell, op=op):
                if "v" not in cell:
                    raise SimulationError(f"{op.loc}: read value consumed before it was sampled")
                return cell["v"]

            ctx.vals[op.result] = result
            return

        if o == "mem_write":
            cycle = self._abs_time(ctx, op.start)

            def do_write(op=op, ctx=ctx, cycle=cycle):
                value_v, mem_v, idx_vs, pred_v = ir.mem_write_parts(op)
                if pred_v is not None and not int(self._eval(ctx, pred_v)):
                    return  # write-enable low: no port activity
                st: _Storage = self._eval(ctx, mem_v)
                idx = tuple(int(self._eval(ctx, v)) for v in idx_vs)
                self._check_bounds(op, st, idx)
                self._check_port(op, ctx, cycle, idx, is_write=True)
                val = self._eval(ctx, value_v)
                st.array[idx] = _mask(val, st.memref.elem) if isinstance(val, int) else val

            self._at(cycle, self.WRITE_PHASE, do_write)
            return

        if o == "yield" or o == "return":
            return  # handled by the loop/func drivers

        if o == "call":
            cycle = self._abs_time(ctx, op.start)
            callee_name = op.attrs["callee"]
            callee = self.module.funcs.get(callee_name)
            if callee is None or callee.attrs.get("external"):
                fn = self.externals.get(callee_name)
                if fn is None:
                    raise SimulationError(f"no model registered for external @{callee_name}")
                cell: dict[str, Any] = {}

                def do_call(op=op, ctx=ctx, cell=cell, fn=fn):
                    vals = [self._eval(ctx, v) for v in op.operands]
                    out = fn(*vals)
                    cell["v"] = out if isinstance(out, tuple) else (out,)

                self._at(cycle, self.READ_PHASE, do_call)
                for i, r in enumerate(op.results):
                    ctx.vals[r] = (lambda cell=cell, i=i: cell["v"][i])
            else:
                sub = _Ctx(None)
                self._bind_args_lazy(callee, op, ctx, sub, cycle)
                self._schedule_region(callee.body, sub)
                for bop in callee.body.ops:
                    if bop.opname == "return" and bop.operands:
                        for r, v in zip(op.results, bop.operands):
                            ctx.vals[r] = (lambda v=v, sub=sub: self._eval(sub, v))
            return

        if isinstance(op, ForOp):
            self._schedule_loop(op, ctx)
            return

        raise SimulationError(f"simulator: unknown op hir.{o}")

    def _bind_args_lazy(self, callee: FuncOp, call_op: Operation, caller_ctx: _Ctx, sub: _Ctx, cycle: int) -> None:
        sub.times[callee.time_var] = cycle
        for formal, actual in zip(callee.args, call_op.operands):
            if isinstance(formal.type, MemrefType):
                sub.vals[formal] = caller_ctx.lookup(actual)
            else:
                sub.vals[formal] = (lambda a=actual, c=caller_ctx: self._eval(c, a))

    # -- loops -----------------------------------------------------------------
    def _schedule_loop(self, op: ForOp, ctx: _Ctx) -> None:
        lb = int(self._eval(ctx, op.lb))
        ub = int(self._eval(ctx, op.ub))
        step = int(self._eval(ctx, op.step))
        if step <= 0:
            raise SimulationError(f"{op.loc}: non-positive loop step {step}")
        start_cycle = self._abs_time(ctx, op.start) + op.attrs.get("iter_arg_offset", 0)
        y = op.yield_op()
        if y is None:
            raise SimulationError(f"{op.loc}: loop without yield")

        if op.opname == "unroll_for":
            # spatial replication: iteration m starts at start + m*stagger
            stagger = y.start.offset if (y.start is not None and y.start.tv is op.time_var) else 0
            cyc = start_cycle
            last_end = start_cycle
            for ivv in range(lb, ub, step):
                it = _Ctx(ctx)
                it.vals[op.iv] = ivv
                it.times[op.time_var] = cyc
                self._schedule_region_loop_body(op, it)
                last_end = cyc + stagger
                cyc += stagger
            ctx.times[op.end_time] = last_end
            return

        # hir.for: iterations may overlap (pipelining).  The next iteration's
        # start is the yield's absolute time in the current iteration context.
        # Nested loops schedule recursively and resolve their end-times during
        # scheduling, so data-dependent (sequential) IIs are resolvable here.
        cyc = start_cycle
        ivv = lb
        while ivv < ub:
            it = _Ctx(ctx)
            it.vals[op.iv] = ivv
            it.times[op.time_var] = cyc
            self._schedule_region_loop_body(op, it)
            if y.start.tv is op.time_var:
                nxt = cyc + y.start.offset
                if nxt <= cyc:
                    raise SimulationError(f"{op.loc}: loop II must be >= 1")
            else:
                nxt = self._abs_time(it, y.start)
            cyc = nxt
            ivv += step
        ctx.times[op.end_time] = cyc

    def _schedule_region_loop_body(self, op: ForOp, it: _Ctx) -> None:
        for inner in op.region(0).ops:
            if inner.opname in ("yield",):
                continue
            self._schedule_op(inner, it)

    # -- checks -------------------------------------------------------------------
    def _check_bounds(self, op: Operation, st: _Storage, idx: tuple[int, ...]) -> None:
        for d, (i, n) in enumerate(zip(idx, st.array.shape)):
            if not (0 <= i < n):
                raise SimulationError(f"{op.loc}: out-of-bounds access dim {d}: {i} not in [0,{n}) (UB §4.5)")

    def _check_port(self, op: Operation, ctx: _Ctx, cycle: int, idx: tuple[int, ...], is_write: bool = False) -> None:
        if not self.check_conflicts:
            return
        port_v = op.operands[1] if is_write else op.operands[0]
        # identify the *physical* port: (storage id, port value id) so two
        # memrefs on one tensor are distinct ports (paper §4.4)
        key = (id(ctx.lookup(port_v)), port_v.id, cycle)
        mt: MemrefType = port_v.type  # type: ignore[assignment]
        # bank-select part of the address: accesses to different banks never
        # conflict (paper Fig. 3)
        bank = tuple(idx[d] for d in mt.distributed)
        packed = tuple(idx[d] for d in mt.packed)
        banks = self._port_access.setdefault(key, {})
        prev = banks.get(bank)
        if prev is not None and prev != packed:
            raise SimulationError(
                f"{op.loc}: port conflict on %{port_v.name} at cycle {cycle}: "
                f"addresses {prev} vs {packed} on bank {bank} (UB §4.5)"
            )
        banks[bank] = packed


def simulate(
    module: Module,
    func: str,
    args: Sequence[Any],
    externals: Optional[dict[str, Callable]] = None,
    check_conflicts: bool = True,
) -> dict[str, Any]:
    """Simulate ``module.func(*args)``; numpy-array arguments are mutated in
    place (they model the external memory interfaces).  Returns dict with
    cycle count and scalar returns."""
    return Simulator(module, externals, check_conflicts).run(func, args)


def simulate_batch(
    module: Module,
    func: str,
    args_batch: Sequence[Any],
    check_conflicts: bool = True,
) -> tuple[list[dict], list[Optional[np.ndarray]]]:
    """Event-driven baseline over a batch-first stimulus set: one
    ``simulate`` call per lane.  This is the per-vector reference path the
    vectorized RTL simulator (``codegen.sim``) is measured against — and the
    slow half of the differential harness.

    ``args_batch`` holds one ``(B, *shape)`` array per memref argument and
    ``(B,)`` arrays (or plain ints, broadcast) for scalar arguments.
    Returns ``(results, finals)``: the per-lane ``simulate`` result dicts and
    the final batch-first contents of each memref argument (None for
    scalars).  Unlike ``simulate``, the stimulus arrays are never mutated."""
    f = module.get(func)
    cols = [np.asarray(a) for a in args_batch]
    B = int(cols[0].shape[0]) if cols else 1
    results: list[dict] = []
    finals: list[list] = [[] for _ in cols]
    for k in range(B):
        lane: list[Any] = []
        for a, col in zip(f.args, cols):
            if isinstance(a.type, MemrefType):
                lane.append(np.array(col[k], copy=True))
            else:
                lane.append(int(col[k]) if col.ndim else int(col))
        results.append(
            simulate(module, func, lane, check_conflicts=check_conflicts))
        for i, (a, v) in enumerate(zip(f.args, lane)):
            if isinstance(a.type, MemrefType):
                finals[i].append(v)
    stacked = [np.stack(c) if c else None for c in finals]
    return results, stacked
