"""Textual printer for HIR (paper §4: round-trippable, human readable form).

The printed syntax follows the paper's listings, e.g.::

    hir.func @transpose at %t (%Ai : !hir.memref<16*16*i32, r>, ...) {
      %c0 = hir.constant 0 : !hir.const
      %tf = hir.for %i : i32 = %c0 to %c16 step %c1 iter_time(%ti = %t offset 1) {
        %v = hir.mem_read %Ai[%i, %j] at %tj : i32
        hir.mem_write %v to %Co[%j1, %i] at %tj offset 1
        hir.yield at %tj offset 1
      }
      hir.return
    }

``core.parser.parse`` reads this form back; round-tripping is property-tested.
"""

from __future__ import annotations

from typing import Optional

from . import ir
from .ir import FuncOp, Module, Operation, Region, Time, Value


class _Namer:
    def __init__(self):
        self.names: dict[Value, str] = {}
        self.used: set[str] = set()

    def name(self, v: Value) -> str:
        if v in self.names:
            return self.names[v]
        base = v.name or f"v{v.id}"
        nm, k = base, 0
        while nm in self.used:
            k += 1
            nm = f"{base}_{k}"
        self.used.add(nm)
        self.names[v] = nm
        return nm

    def ref(self, v: Value) -> str:
        return "%" + self.name(v)


def _time_str(n: _Namer, t: Optional[Time]) -> str:
    if t is None:
        return ""
    s = f" at {n.ref(t.tv)}"
    if t.offset:
        s += f" offset {t.offset}"
    return s


def print_op(op: Operation, n: _Namer, indent: int = 0) -> str:
    pad = "  " * indent
    rs = ", ".join(n.ref(r) for r in op.results)
    eq = f"{rs} = " if rs else ""
    o = op.opname

    if o == "constant":
        return f"{pad}{eq}hir.constant {op.attrs['value']} : {op.result.type}"

    if o == "alloc":
        types = ", ".join(str(r.type) for r in op.results)
        return f"{pad}{eq}hir.alloc() : {types}"

    if o == "mem_read":
        mem, idx = op.operands[0], op.operands[1:]
        ix = ", ".join(n.ref(i) for i in idx)
        return f"{pad}{eq}hir.mem_read {n.ref(mem)}[{ix}]{_time_str(n, op.start)} : {op.result.type}"

    if o == "mem_write":
        val, mem, idx, pred = ir.mem_write_parts(op)
        ix = ", ".join(n.ref(i) for i in idx)
        pr = f" if {n.ref(pred)}" if pred is not None else ""
        return f"{pad}hir.mem_write {n.ref(val)} to {n.ref(mem)}[{ix}]{pr}{_time_str(n, op.start)}"

    if o == "delay":
        return (
            f"{pad}{eq}hir.delay {n.ref(op.operands[0])} by {op.attrs['by']}"
            f"{_time_str(n, op.start)} : {op.result.type}"
        )

    if o == "time":
        s = f"{pad}{eq}hir.time {n.ref(op.operands[0])}"
        if op.attrs.get("offset"):
            s += f" offset {op.attrs['offset']}"
        return s

    if o in ("for", "unroll_for"):
        f: ir.ForOp = op  # type: ignore[assignment]
        iv, tv = f.iv, f.time_var
        # unscheduled loops (erased IR) have no start: round-trippable form
        it = (f"{n.ref(tv)} = {n.ref(f.start.tv)} offset "
              f"{f.start.offset + f.attrs.get('iter_arg_offset', 0)}"
              if f.start is not None else f"{n.ref(tv)} unscheduled")
        hdr = (
            f"{pad}{eq}hir.{o} {n.ref(iv)} : {iv.type} = {n.ref(f.lb)} to {n.ref(f.ub)} "
            f"step {n.ref(f.step)} iter_time({it})"
        )
        body = "\n".join(print_op(x, n, indent + 1) for x in f.region(0).ops)
        return f"{hdr} {{\n{body}\n{pad}}}"

    if o == "yield":
        return f"{pad}hir.yield{_time_str(n, op.start)}"

    if o == "return":
        vals = ", ".join(n.ref(v) for v in op.operands)
        return f"{pad}hir.return {vals}".rstrip()

    if o == "call":
        args = ", ".join(n.ref(v) for v in op.operands)
        outs = ", ".join(
            f"{r.type} delay {d}" for r, d in zip(op.results, op.attrs["result_delays"])
        )
        sig = f" : ({outs})" if outs else ""
        return f"{pad}{eq}hir.call @{op.attrs['callee']}({args}){_time_str(n, op.start)}{sig}"

    if o in ir.ARITH_OPS:
        args = ", ".join(n.ref(v) for v in op.operands)
        st = f" stages {op.attrs['stages']}" if op.attrs.get("stages") else ""
        return f"{pad}{eq}hir.{o}({args}){st}{_time_str(n, op.start)} : {op.result.type}"

    raise NotImplementedError(f"printer: unknown op {o}")  # pragma: no cover


def print_func(f: FuncOp, indent: int = 0, namer: Optional[_Namer] = None) -> str:
    """Print one function.  ``namer`` lets callers substitute a different
    naming policy — e.g. the structural (positional) namer the HLS search
    cache uses for build-independent function fingerprints."""
    n = namer if namer is not None else _Namer()
    pad = "  " * indent
    tv = n.ref(f.time_var)
    args = []
    for a, d in zip(f.args, f.attrs["arg_delays"]):
        s = f"{n.ref(a)} : {a.type}"
        if ir.is_primitive(a.type) and d:
            s += f" delay {d}"
        args.append(s)
    outs = ", ".join(
        f"{t} delay {d}" for t, d in zip(f.attrs["result_types"], f.attrs["result_delays"])
    )
    sig = f" -> ({outs})" if outs else ""
    ext = "external " if f.attrs.get("external") else ""
    hdr = f"{pad}hir.func {ext}@{f.name} at {tv} ({', '.join(args)}){sig}"
    if f.attrs.get("external"):
        return hdr
    body = "\n".join(print_op(op, n, indent + 1) for op in f.body.ops)
    return f"{hdr} {{\n{body}\n{pad}}}"


def print_module(m: Module) -> str:
    funcs = "\n\n".join(print_func(f, 1) for f in m.funcs.values())
    return f"hir.module @{m.name} {{\n{funcs}\n}}\n"
