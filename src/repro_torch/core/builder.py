"""Ergonomic builder for HIR programs.

The builder keeps an insertion point (a Region) and a current scope so that
gallery kernels and tests can construct IR close to the paper's textual form:

    b = Builder("transpose", ...)
    with b.func([...]) as f:
        with b.for_(0, 16, 1, at=f.t + 1) as i_loop:
            ...

All builder methods attach source locations from the caller's frame so the
verifier's diagnostics mimic the paper's Figure 1/2 error listings.
"""

from __future__ import annotations

import inspect
from contextlib import contextmanager
from typing import Optional, Sequence, Union

from . import ir
from .ir import (
    CONST,
    ConstType,
    FuncOp,
    Loc,
    MemrefType,
    Module,
    Operation,
    Region,
    Time,
    Type,
    Value,
)

ValueLike = Union[Value, int, float]


def _caller_loc(depth: int = 2) -> Loc:
    try:
        fr = inspect.stack()[depth]
        return Loc(fr.filename.split("/")[-1], fr.lineno, 0)
    except (IndexError, OSError):  # pragma: no cover - shallow/exotic stacks
        return ir.UNKNOWN_LOC


class LoopHandle:
    def __init__(self, op: ir.ForOp):
        self.op = op

    @property
    def iv(self) -> Value:
        return self.op.iv

    @property
    def time(self) -> Time:
        return Time(self.op.time_var, 0)

    @property
    def end(self) -> Time:
        return Time(self.op.end_time, 0)


class FuncHandle:
    def __init__(self, op: FuncOp):
        self.op = op

    @property
    def t(self) -> Time:
        return Time(self.op.time_var, 0)

    @property
    def args(self) -> list[Value]:
        return self.op.args

    def arg(self, name: str) -> Value:
        for a in self.op.args:
            if a.name == name:
                return a
        raise KeyError(name)


class Builder:
    def __init__(self, module: Optional[Module] = None):
        self.module = module or Module()
        self._region_stack: list[Region] = []
        self._const_cache: dict[tuple, Value] = {}
        self._n_prelude = 0

    # -- region / insertion management -------------------------------------
    @property
    def region(self) -> Region:
        return self._region_stack[-1]

    def insert(self, op: Operation) -> Operation:
        self.region.add(op)
        return op

    # -- functions ----------------------------------------------------------
    @contextmanager
    def func(
        self,
        name: str,
        arg_types: Sequence[Type],
        arg_names: Sequence[str] = (),
        arg_delays: Optional[Sequence[int]] = None,
        result_types: Sequence[Type] = (),
        result_delays: Optional[Sequence[int]] = None,
    ):
        f = FuncOp(
            name,
            arg_types,
            arg_names,
            arg_delays,
            result_types,
            result_delays,
            loc=_caller_loc(3),
        )
        self.module.add(f)
        self._region_stack.append(f.body)
        self._const_cache = {}
        self._n_prelude = 0
        try:
            yield FuncHandle(f)
        finally:
            self._region_stack.pop()

    def external_func(
        self,
        name: str,
        arg_types: Sequence[Type],
        result_types: Sequence[Type],
        result_delays: Sequence[int],
        arg_delays: Optional[Sequence[int]] = None,
    ) -> FuncOp:
        """Declare an external (blackbox Verilog) module: signature only
        (paper §5.4 — schedule captured in the signature, no handshake)."""
        f = FuncOp(
            name,
            arg_types,
            arg_delays=arg_delays,
            result_types=result_types,
            result_delays=result_delays,
            loc=_caller_loc(2),
        )
        f.attrs["external"] = True
        self.module.add(f)
        return f

    # -- values --------------------------------------------------------------
    def _as_value(self, v: ValueLike, type: Optional[Type] = None) -> Value:
        if isinstance(v, Value):
            return v
        return self.const(v, type or CONST)

    def const(self, value: Union[int, float], type: Type = CONST, name: str = "") -> Value:
        key = (value, str(type))
        # cache constants per function for readable IR + free CSE of consts
        if not name and key in self._const_cache:
            return self._const_cache[key]
        op = ir.constant(value, type, name=name, loc=_caller_loc(2))
        # constants are always-valid and scope-free: hoist to the function
        # prelude so they dominate every use in nested regions
        froot = self._region_stack[0]
        froot.ops.insert(self._n_prelude, op)
        op.parent_region = froot
        self._n_prelude += 1
        if not name:
            self._const_cache[key] = op.result
        return op.result

    # -- arithmetic -----------------------------------------------------------
    def _arith(self, opname: str, *vs: ValueLike, at: Optional[Time] = None, result_type: Optional[Type] = None,
               stages: int = 0) -> Value:
        ops = [self._as_value(v) for v in vs]
        return self.insert(
            ir.arith(opname, ops, start=at, result_type=result_type, stages=stages, loc=_caller_loc(3))
        ).result

    def add(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None, result_type: Optional[Type] = None) -> Value:
        return self._arith("add", a, b, at=at, result_type=result_type)

    def sub(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None, result_type: Optional[Type] = None) -> Value:
        return self._arith("sub", a, b, at=at, result_type=result_type)

    def mult(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None, result_type: Optional[Type] = None,
             stages: int = 0) -> Value:
        return self._arith("mult", a, b, at=at, result_type=result_type, stages=stages)

    def select(self, c: ValueLike, a: ValueLike, b: ValueLike, at: Optional[Time] = None) -> Value:
        return self._arith("select", c, a, b, at=at)

    def cmp(self, kind: str, a: ValueLike, b: ValueLike, at: Optional[Time] = None) -> Value:
        return self._arith(f"cmp_{kind}", a, b, at=at)

    def and_(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None) -> Value:
        return self._arith("and", a, b, at=at)

    def or_(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None) -> Value:
        return self._arith("or", a, b, at=at)

    def xor_(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None) -> Value:
        return self._arith("xor", a, b, at=at)

    def shl(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None,
            result_type: Optional[Type] = None) -> Value:
        return self._arith("shl", a, b, at=at, result_type=result_type)

    def shr(self, a: ValueLike, b: ValueLike, at: Optional[Time] = None) -> Value:
        return self._arith("shr", a, b, at=at)

    def zext(self, v: ValueLike, t: Type, at: Optional[Time] = None) -> Value:
        return self._arith("zext", v, at=at, result_type=t)

    def sext(self, v: ValueLike, t: Type, at: Optional[Time] = None) -> Value:
        return self._arith("sext", v, at=at, result_type=t)

    def trunc(self, v: ValueLike, t: Type, at: Optional[Time] = None) -> Value:
        return self._arith("trunc", v, at=at, result_type=t)

    # -- memory -----------------------------------------------------------------
    def alloc(self, memref: MemrefType, ports: Sequence[str] = (ir.PORT_R, ir.PORT_W), names: Sequence[str] = ()):
        op = self.insert(ir.alloc(memref, ports, names, loc=_caller_loc(2)))
        if len(op.results) == 1:
            return op.results[0]
        return tuple(op.results)

    def read(self, mem: Value, indices: Sequence[ValueLike], at: Time) -> Value:
        idx = [self._as_value(i) for i in indices]
        return self.insert(ir.mem_read(mem, idx, at, loc=_caller_loc(2))).result

    def write(self, value: ValueLike, mem: Value, indices: Sequence[ValueLike], at: Time,
              pred: Optional[Value] = None) -> Operation:
        idx = [self._as_value(i) for i in indices]
        mt = mem.type
        val = self._as_value(value, mt.elem if isinstance(mt, MemrefType) else None)
        return self.insert(ir.mem_write(val, mem, idx, at, pred=pred, loc=_caller_loc(2)))

    def delay(self, v: Value, by: int, at: Optional[Time] = None) -> Value:
        # default schedule: the instant the source becomes valid (paper form
        # ``hir.delay %v by k at %t``)
        if at is None and isinstance(v, Value) and v.birth is not None:
            at = v.birth
        return self.insert(ir.delay(v, by, at, loc=_caller_loc(2))).result

    def time_at(self, t: Time, name: str = "") -> Time:
        op = self.insert(ir.time_offset(t, name=name, loc=_caller_loc(2)))
        return Time(op.result, 0)

    # -- control flow -------------------------------------------------------------
    @contextmanager
    def for_(
        self,
        lb: ValueLike,
        ub: ValueLike,
        step: ValueLike,
        at: Time,
        iter_offset: int = 0,
        iv_type: Optional[Type] = None,
        unroll: bool = False,
        iv_name: str = "i",
        tv_name: str = "ti",
    ):
        if iv_type is None:
            # unroll_for IVs are compile-time constants (they select banks of
            # distributed memrefs — paper Fig. 3); dynamic loops default i32.
            iv_type = ir.CONST if unroll else ir.i32
        op = ir.ForOp(
            self._as_value(lb),
            self._as_value(ub),
            self._as_value(step),
            start=at,
            iv_type=iv_type,
            iter_arg_offset=iter_offset,
            unroll=unroll,
            iv_name=iv_name,
            tv_name=tv_name,
            loc=_caller_loc(3),
        )
        self.insert(op)
        self._region_stack.append(op.region(0))
        try:
            yield LoopHandle(op)
        finally:
            self._region_stack.pop()

    def yield_(self, at: Time) -> Operation:
        return self.insert(ir.yield_op(at, loc=_caller_loc(2)))

    def call(
        self,
        callee: Union[str, FuncOp],
        operands: Sequence[ValueLike],
        at: Time,
        result_types: Sequence[Type] = (),
        result_delays: Sequence[int] = (),
    ):
        if isinstance(callee, str):
            callee = self.module.get(callee)
        ops = [self._as_value(v) for v in operands]
        op = self.insert(ir.call(callee, ops, at, result_types, result_delays, loc=_caller_loc(2)))
        if len(op.results) == 1:
            return op.results[0]
        return tuple(op.results)

    def ret(self, values: Sequence[Value] = ()) -> Operation:
        return self.insert(ir.return_op(values, loc=_caller_loc(2)))
