"""Recursive-descent parser for the HIR textual form emitted by
``core.printer`` — gives the dialect the MLIR property of a round-trippable
representation (paper §4).  Grammar mirrors the printer exactly.
"""

from __future__ import annotations

import re
from typing import Optional, Union

from . import ir
from .ir import (
    CONST,
    TIME,
    FloatType,
    FuncOp,
    IntType,
    MemrefType,
    Module,
    Operation,
    Time,
    Type,
    Value,
)

_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|//[^\n]*)
    | (?P<memref>!hir\.memref<[^>]*>)
    | (?P<const_t>!hir\.const|!hir\.time)
    | (?P<num>-?\d+\.\d+|-?\d+)
    | (?P<sym>@[A-Za-z_][\w.]*)
    | (?P<val>%[A-Za-z_][\w.]*|%\d[\w.]*)
    | (?P<kw>[A-Za-z_][\w.]*)
    | (?P<punct>->|[{}()\[\],:=<>*])
    """,
    re.VERBOSE,
)


class ParseError(Exception):
    pass


class _Lexer:
    def __init__(self, text: str):
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m:
                raise ParseError(f"lex error at: {text[pos:pos+40]!r}")
            pos = m.end()
            kind = m.lastgroup
            if kind == "ws":
                continue
            self.toks.append((kind, m.group()))
        self.i = 0

    def peek(self, k: int = 0) -> tuple[str, str]:
        if self.i + k >= len(self.toks):
            return ("eof", "")
        return self.toks[self.i + k]

    def next(self) -> tuple[str, str]:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, text: str) -> str:
        kind, tok = self.next()
        if tok != text:
            raise ParseError(f"expected {text!r}, got {tok!r} (context: {self._ctx()})")
        return tok

    def accept(self, text: str) -> bool:
        if self.peek()[1] == text:
            self.next()
            return True
        return False

    def _ctx(self) -> str:
        return " ".join(t for _, t in self.toks[max(0, self.i - 5): self.i + 5])


def _parse_type(tok: str) -> Type:
    if tok == "!hir.const":
        return CONST
    if tok == "!hir.time":
        return TIME
    if tok.startswith("!hir.memref<"):
        inner = tok[len("!hir.memref<"):-1]
        parts = [p.strip() for p in inner.split(",")]
        dims_elem = parts[0].split("*")
        elem = _parse_type(dims_elem[-1])
        shape = [int(d) for d in dims_elem[:-1]]
        port = ir.PORT_RW
        packed = None
        kind = ir.KIND_BRAM
        for p in parts[1:]:
            if p in (ir.PORT_R, ir.PORT_W, ir.PORT_RW):
                port = p
            elif p.startswith("packing=["):
                body = p[len("packing=["):-1]
                packed = [int(x) for x in body.split(",") if x.strip() != ""]
            elif p.startswith("kind="):
                kind = p[len("kind="):]
        return MemrefType(shape, elem, port, packed, kind)
    m = re.fullmatch(r"([iuf])(\d+)", tok)
    if m:
        k, w = m.group(1), int(m.group(2))
        if k == "f":
            return FloatType(w)
        return IntType(w, signed=(k == "i"))
    raise ParseError(f"unknown type {tok!r}")


class Parser:
    def __init__(self, text: str):
        self.lx = _Lexer(text)
        self.scope: dict[str, Value] = {}

    # ---------------------------------------------------------------
    def _val(self, name: str) -> Value:
        if name not in self.scope:
            raise ParseError(f"use of undefined value %{name}")
        return self.scope[name]

    def _def(self, name: str, v: Value) -> Value:
        v.name = name
        self.scope[name] = v
        return v

    def _parse_value_ref(self) -> Value:
        kind, tok = self.lx.next()
        if kind != "val":
            raise ParseError(f"expected value ref, got {tok!r}")
        return self._val(tok[1:])

    def _parse_time_suffix(self) -> Optional[Time]:
        """Parse optional ``at %t [offset k]``."""
        if self.lx.peek()[1] != "at":
            return None
        self.lx.expect("at")
        tv = self._parse_value_ref()
        off = 0
        if self.lx.accept("offset"):
            off = int(self.lx.next()[1])
        return Time(tv, off)

    def _parse_type_tok(self) -> Type:
        kind, tok = self.lx.next()
        if kind not in ("memref", "const_t", "kw"):
            raise ParseError(f"expected type, got {tok!r}")
        return _parse_type(tok)

    # ---------------------------------------------------------------
    def parse_module(self) -> Module:
        self.lx.expect("hir.module")
        name = self.lx.next()[1][1:]
        mod = Module(name)
        self.lx.expect("{")
        while self.lx.peek()[1] == "hir.func":
            self.scope = {}
            mod.add(self.parse_func())
        self.lx.expect("}")
        return mod

    def parse_func(self) -> FuncOp:
        self.lx.expect("hir.func")
        external = self.lx.accept("external")
        fname = self.lx.next()[1][1:]
        self.lx.expect("at")
        tname = self.lx.next()[1][1:]
        self.lx.expect("(")
        arg_names, arg_types, arg_delays = [], [], []
        while not self.lx.accept(")"):
            an = self.lx.next()[1][1:]
            self.lx.expect(":")
            at = self._parse_type_tok()
            d = 0
            if self.lx.accept("delay"):
                d = int(self.lx.next()[1])
            arg_names.append(an)
            arg_types.append(at)
            arg_delays.append(d)
            self.lx.accept(",")
        result_types, result_delays = [], []
        if self.lx.accept("->"):
            self.lx.expect("(")
            while not self.lx.accept(")"):
                result_types.append(self._parse_type_tok())
                self.lx.expect("delay")
                result_delays.append(int(self.lx.next()[1]))
                self.lx.accept(",")
        f = FuncOp(fname, arg_types, arg_names, arg_delays, result_types, result_delays)
        if external:
            f.attrs["external"] = True
            return f
        f.time_var.name = tname
        for a in f.args:
            self.scope[a.name] = a
        self.scope[tname] = f.time_var
        self.lx.expect("{")
        while not self.lx.accept("}"):
            f.body.add(self.parse_op())
        return f

    # ---------------------------------------------------------------
    def parse_op(self) -> Operation:
        # optional results
        result_names: list[str] = []
        save = self.lx.i
        while self.lx.peek()[0] == "val":
            result_names.append(self.lx.next()[1][1:])
            if not self.lx.accept(","):
                break
        if result_names:
            if not self.lx.accept("="):
                self.lx.i = save
                result_names = []
        kind, opname = self.lx.next()
        if not opname.startswith("hir."):
            raise ParseError(f"expected op name, got {opname!r}")
        o = opname[4:]
        return self._parse_op_body(o, result_names)

    def _parse_op_body(self, o: str, rnames: list[str]) -> Operation:
        lx = self.lx
        if o == "constant":
            v = lx.next()[1]
            val: Union[int, float] = float(v) if "." in v else int(v)
            lx.expect(":")
            t = self._parse_type_tok()
            op = ir.constant(val, t)
            self._def(rnames[0], op.result)
            return op

        if o == "alloc":
            lx.expect("(")
            lx.expect(")")
            lx.expect(":")
            types: list[MemrefType] = []
            while True:
                types.append(self._parse_type_tok())  # type: ignore[arg-type]
                if not lx.accept(","):
                    break
            base = types[0].with_port(ir.PORT_RW)
            op = ir.alloc(base, [t.port for t in types])
            for nm, r in zip(rnames, op.results):
                self._def(nm, r)
            return op

        if o == "mem_read":
            mem = self._parse_value_ref()
            lx.expect("[")
            idx = []
            while not lx.accept("]"):
                idx.append(self._parse_value_ref())
                lx.accept(",")
            t = self._parse_time_suffix()
            lx.expect(":")
            self._parse_type_tok()
            op = ir.mem_read(mem, idx, t)
            self._def(rnames[0], op.result)
            return op

        if o == "mem_write":
            val = self._parse_value_ref()
            lx.expect("to")
            mem = self._parse_value_ref()
            lx.expect("[")
            idx = []
            while not lx.accept("]"):
                idx.append(self._parse_value_ref())
                lx.accept(",")
            pred = None
            if lx.accept("if"):
                pred = self._parse_value_ref()
            t = self._parse_time_suffix()
            return ir.mem_write(val, mem, idx, t, pred=pred)

        if o == "delay":
            v = self._parse_value_ref()
            lx.expect("by")
            by = int(lx.next()[1])
            t = self._parse_time_suffix()
            lx.expect(":")
            self._parse_type_tok()
            op = ir.delay(v, by, t)
            self._def(rnames[0], op.result)
            return op

        if o == "time":
            tv = self._parse_value_ref()
            off = 0
            if lx.accept("offset"):
                off = int(lx.next()[1])
            op = ir.time_offset(Time(tv, off))
            self._def(rnames[0], op.result)
            return op

        if o in ("for", "unroll_for"):
            ivn = lx.next()[1][1:]
            lx.expect(":")
            ivt = self._parse_type_tok()
            lx.expect("=")
            lb = self._parse_value_ref()
            lx.expect("to")
            ub = self._parse_value_ref()
            lx.expect("step")
            step = self._parse_value_ref()
            lx.expect("iter_time")
            lx.expect("(")
            tvn = lx.next()[1][1:]
            if lx.accept("unscheduled"):  # erased IR: loop has no start yet
                start = None
            else:
                lx.expect("=")
                base_tv = self._parse_value_ref()
                lx.expect("offset")
                off = int(lx.next()[1])
                start = Time(base_tv, off)
            lx.expect(")")
            op = ir.ForOp(lb, ub, step, start=start, iv_type=ivt, unroll=(o == "unroll_for"),
                          iv_name=ivn, tv_name=tvn)
            self._def(ivn, op.iv)
            self._def(tvn, op.time_var)
            if rnames:
                self._def(rnames[0], op.end_time)
            lx.expect("{")
            while not lx.accept("}"):
                op.region(0).add(self.parse_op())
            return op

        if o == "yield":
            t = self._parse_time_suffix()
            return ir.yield_op(t)

        if o == "return":
            vals = []
            while self.lx.peek()[0] == "val":
                vals.append(self._parse_value_ref())
                lx.accept(",")
            return ir.return_op(vals)

        if o == "call":
            callee = lx.next()[1][1:]
            lx.expect("(")
            args = []
            while not lx.accept(")"):
                args.append(self._parse_value_ref())
                lx.accept(",")
            t = self._parse_time_suffix()
            rtypes, rdelays = [], []
            if lx.accept(":"):
                lx.expect("(")
                while not lx.accept(")"):
                    rtypes.append(self._parse_type_tok())
                    lx.expect("delay")
                    rdelays.append(int(lx.next()[1]))
                    lx.accept(",")
            op = ir.call(callee, args, t, rtypes, rdelays)
            for nm, r in zip(rnames, op.results):
                self._def(nm, r)
            return op

        if o in ir.ARITH_OPS:
            lx.expect("(")
            args = []
            while not lx.accept(")"):
                args.append(self._parse_value_ref())
                lx.accept(",")
            stages = 0
            if lx.accept("stages"):
                stages = int(lx.next()[1])
            t = self._parse_time_suffix()
            lx.expect(":")
            rt = self._parse_type_tok()
            op = ir.arith(o, args, start=t, result_type=rt, stages=stages)
            self._def(rnames[0], op.result)
            return op

        raise ParseError(f"unknown op hir.{o}")


def parse(text: str) -> Module:
    return Parser(text).parse_module()


def parse_func(text: str) -> FuncOp:
    p = Parser(text)
    return p.parse_func()
