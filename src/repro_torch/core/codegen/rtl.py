"""Structured RTL netlist IR — the layer between scheduled HIR and Verilog.

Scheduled HIR is lowered (``core.codegen.verilog``) into an ``RTLModule`` per
``hir.func``: typed nets, combinational assigns, shift registers, clocked
register writes, loop-controller FSMs, memory primitives (reg / lutram / bram
banks) and **module instances**.  Verilog text is then a thin printer over
this IR (``print_rtl``), and the resource model reads the same structure —
nothing below the HIR level is a string anymore.

The module also hosts the RTL pass pipeline, registered on the same
``core.passmgr`` infrastructure as the HIR-level passes:

  * ``net-fanout``     (analysis)  — per-net reader/writer item indices;
  * ``rtl-dce``        — dead-net elimination: removes items (and their
                         declared nets) that cannot reach an output port,
                         a memory with a live reader, an instance input or
                         an assertion;
  * ``rtl-merge-srl``  — shift-register merging: equal-source chains are
                         shared; a deeper chain re-taps the tail of a
                         shallower equal-source chain instead of keeping a
                         full-depth private copy;
  * ``rtl-share-comb`` — duplicate-comb-expression sharing: structurally
                         identical combinational assigns collapse onto one
                         driver net.

``RTL_PIPELINE_SPEC`` is the default post-lowering pipeline;
``PassManager.from_spec(RTL_PIPELINE_SPEC)`` runs it over an ``RTLDesign``
(the pass classes accept either an ``RTLDesign`` or a plain dict of
``RTLModule``), with per-pass rewrite/wall statistics flowing into
``benchmarks/codegen_speed.py`` exactly like the HIR-level passes.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Optional, Union

from ..ir import Loc, UNKNOWN_LOC
from ..passmgr import (AnalysisManager, FunctionAnalysis, Pass,
                       register_analysis, register_pass)

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


#: Global intern table: flat structural tuple -> small int.  Structurally
#: identical expression trees — across modules and designs — map to the same
#: integer, so ``key()`` equality is O(1) and keys hash as plain ints in the
#: sharing passes' dictionaries.  Bounded per compilation:
#: ``clear_key_intern`` releases it (``generate_verilog`` does so before
#: each lowering), and because ids are allocated from the monotonic
#: ``_key_ids`` counter — never from the table size — a stale key cached on
#: a node from before a clear can never alias a freshly interned structure;
#: the only effect of clearing is that sharing is not detected *across* the
#: clear boundary.
_KEY_TABLE: dict[tuple, int] = {}
_key_ids = itertools.count()


def clear_key_intern() -> int:
    """Drop the intern table (memory bound for long-lived processes).
    Returns the number of released entries.  Safe at any point — see the
    monotonic-id note on ``_KEY_TABLE``."""
    n = len(_KEY_TABLE)
    _KEY_TABLE.clear()
    return n

#: Counters for the hash-consing contract: ``computed`` increments once per
#: node whose structural key is actually derived (the seed recursive path);
#: ``hits`` counts cached O(1) returns.  ``tests/core/test_perf_infra.py``
#: asserts no pass recomputes keys per item.
KEY_STATS = {"computed": 0, "hits": 0}


def reset_key_stats() -> None:
    KEY_STATS["computed"] = 0
    KEY_STATS["hits"] = 0


def _ensure_recursion_headroom(limit: int = 20_000) -> None:
    """Deep expression trees (e.g. the drain-phase bus mux of a 32x32-PE gemm
    is a ~1024-deep ``Mux`` chain) exceed CPython's default recursion limit
    in ``refs()``/``map_refs``/the printers; raise it once, generously."""
    import sys

    if sys.getrecursionlimit() < limit:
        sys.setrecursionlimit(limit)


class Expr:
    """Base class of RTL expressions.  Expressions are immutable trees over
    net *names* (``Ref``) and literals; ``refs()`` yields referenced nets and
    ``key()`` is a structural identity used by CSE-style sharing.

    **Hash-consing invariant** — expression nodes are immutable once
    constructed; every rewrite builds new nodes (``map_refs`` is
    copy-on-write).  ``key()`` is therefore computed at most once per node
    and *interned*: structurally identical trees return the same small
    integer, so key equality/hashing is O(1) instead of O(tree).  Anyone
    adding a new ``Expr`` kind must implement ``_key_parts`` (flat tuple
    over child ``key()`` ints), ``structural_key`` (the uncached recursive
    form, kept for tests/debugging) and ``_children``, and must never mutate
    a node after construction."""

    __slots__ = ("_key",)

    def refs(self) -> Iterator[str]:
        """Referenced net names, in source order.  Iterative: a chain of
        nested ``yield from`` generators costs O(depth) per yielded leaf
        (O(size^2) on the deep bus-mux chains of large designs); the
        explicit stack keeps a full traversal O(size)."""
        stack = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, Ref):
                yield e.name
                continue
            cs = e._children()
            if cs:
                stack.extend(reversed(cs))

    def key(self) -> int:
        """Interned structural identity (small int), cached per node."""
        try:
            k = self._key
        except AttributeError:
            pass
        else:
            KEY_STATS["hits"] += 1
            return k
        # iterative post-order over the uncached subtree: immune to deep
        # chains and O(nodes) total even on first touch
        stack = [self]
        table = _KEY_TABLE
        while stack:
            node = stack[-1]
            if hasattr(node, "_key"):
                stack.pop()
                continue
            pending = [c for c in node._children() if not hasattr(c, "_key")]
            if pending:
                stack.extend(pending)
                continue
            KEY_STATS["computed"] += 1
            parts = node._key_parts()
            k = table.get(parts)
            if k is None:
                k = table[parts] = next(_key_ids)
            node._key = k
            stack.pop()
        return self._key

    def _children(self) -> tuple:
        return ()

    def _key_parts(self) -> tuple:
        """Flat structural tuple over child ``key()`` ints (children must be
        keyed already — ``key()`` guarantees post-order)."""
        raise NotImplementedError

    def structural_key(self) -> tuple:
        """The seed-path fully-recursive structural key (uncached nested
        tuples).  Production code uses the interned ``key()``; this form is
        retained for the hash-consing property tests."""
        raise NotImplementedError

    def map_refs(self, ren: dict[str, str]) -> "Expr":
        """A copy with net names substituted per ``ren`` (identity if no
        referenced name is renamed)."""
        return self


class Const(Expr):
    """A literal: ``32'd5`` when sized, a bare integer when not."""

    __slots__ = ("value", "width", "signed")

    def __init__(self, value: Union[int, float], width: Optional[int] = None,
                 signed: bool = False):
        self.value = value
        self.width = width
        self.signed = signed

    def _key_parts(self) -> tuple:
        return ("c", self.value, self.width, self.signed)

    def structural_key(self) -> tuple:
        return ("c", self.value, self.width, self.signed)

    def __str__(self) -> str:
        if self.width is None or not isinstance(self.value, int):
            return str(self.value)
        if self.signed and self.value < 0:
            return f"-{self.width}'sd{-self.value}"
        if self.value < 0:
            return f"-{self.width}'d{-self.value}"
        return f"{self.width}'d{self.value}"


class Ref(Expr):
    """A reference to a net or port by name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def refs(self) -> Iterator[str]:
        yield self.name

    def _key_parts(self) -> tuple:
        return ("r", self.name)

    def structural_key(self) -> tuple:
        return ("r", self.name)

    def map_refs(self, ren: dict[str, str]) -> "Expr":
        return Ref(ren[self.name]) if self.name in ren else self

    def __str__(self) -> str:
        return self.name


class Signed(Expr):
    """``$signed(a)`` — arithmetic reinterpretation, zero hardware."""

    __slots__ = ("a",)

    def __init__(self, a: Expr):
        self.a = a

    def _children(self) -> tuple:
        return (self.a,)

    def _key_parts(self) -> tuple:
        return ("s", self.a.key())

    def structural_key(self) -> tuple:
        return ("s", self.a.structural_key())

    def map_refs(self, ren: dict[str, str]) -> "Expr":
        a = self.a.map_refs(ren)
        return self if a is self.a else Signed(a)

    def __str__(self) -> str:
        return f"$signed({self.a})"


class Unop(Expr):
    __slots__ = ("op", "a", "width")

    def __init__(self, op: str, a: Expr, width: int = 1):
        self.op = op
        self.a = a
        self.width = width  # cost width (resource model)

    def _children(self) -> tuple:
        return (self.a,)

    def _key_parts(self) -> tuple:
        return ("u", self.op, self.a.key())

    def structural_key(self) -> tuple:
        return ("u", self.op, self.a.structural_key())

    def map_refs(self, ren: dict[str, str]) -> "Expr":
        a = self.a.map_refs(ren)
        return self if a is self.a else Unop(self.op, a, self.width)

    def __str__(self) -> str:
        return f"{self.op}({self.a})"


class Binop(Expr):
    """A binary operator.  ``width`` is the cost width for the resource
    model; ``impl`` carries the HIR binding for multiplies (``dsp`` /
    ``shift_add`` / ``counter`` / ``div``); ``free=True`` marks wiring-only
    nodes (constant-stride address scaling, shifts by constants) that consume
    no logic."""

    __slots__ = ("op", "a", "b", "width", "impl", "free")

    def __init__(self, op: str, a: Expr, b: Expr, width: int = 32,
                 impl: str = "", free: bool = False):
        self.op = op
        self.a = a
        self.b = b
        self.width = width
        self.impl = impl
        self.free = free

    def _children(self) -> tuple:
        return (self.a, self.b)

    def _key_parts(self) -> tuple:
        return ("b", self.op, self.a.key(), self.b.key())

    def structural_key(self) -> tuple:
        return ("b", self.op, self.a.structural_key(), self.b.structural_key())

    def map_refs(self, ren: dict[str, str]) -> "Expr":
        a, b = self.a.map_refs(ren), self.b.map_refs(ren)
        if a is self.a and b is self.b:
            return self
        return Binop(self.op, a, b, self.width, self.impl, self.free)

    def __str__(self) -> str:
        return f"({self.a} {self.op} {self.b})"


class Mux(Expr):
    """``cond ? a : b`` (one 2:1 mux of ``width`` bits)."""

    __slots__ = ("cond", "a", "b", "width")

    def __init__(self, cond: Expr, a: Expr, b: Expr, width: int = 1):
        self.cond = cond
        self.a = a
        self.b = b
        self.width = width

    def _children(self) -> tuple:
        return (self.cond, self.a, self.b)

    def _key_parts(self) -> tuple:
        return ("m", self.cond.key(), self.a.key(), self.b.key())

    def structural_key(self) -> tuple:
        return ("m", self.cond.structural_key(), self.a.structural_key(),
                self.b.structural_key())

    def map_refs(self, ren: dict[str, str]) -> "Expr":
        c, a, b = (self.cond.map_refs(ren), self.a.map_refs(ren),
                   self.b.map_refs(ren))
        if c is self.cond and a is self.a and b is self.b:
            return self
        return Mux(c, a, b, self.width)

    def __str__(self) -> str:
        return f"(({self.cond}) ? ({self.a}) : ({self.b}))"


class Repeat(Expr):
    """``{n{a}}`` — replication (wiring only)."""

    __slots__ = ("n", "a")

    def __init__(self, n: int, a: Expr):
        self.n = n
        self.a = a

    def _children(self) -> tuple:
        return (self.a,)

    def _key_parts(self) -> tuple:
        return ("rep", self.n, self.a.key())

    def structural_key(self) -> tuple:
        return ("rep", self.n, self.a.structural_key())

    def map_refs(self, ren: dict[str, str]) -> "Expr":
        a = self.a.map_refs(ren)
        return self if a is self.a else Repeat(self.n, a)

    def __str__(self) -> str:
        return f"{{{self.n}{{{self.a}}}}}"


def zeros(width: int) -> Expr:
    return Repeat(width, Const(0, 1)) if width > 1 else Const(0, 1)


def walk_expr(e: Expr) -> Iterator[Expr]:
    """Preorder walk (node before subtrees, ``a``/``b``/``cond`` attribute
    order — the historical ordering ``netlist_of`` depends on).  Iterative
    for the same O(size) reason as ``Expr.refs``."""
    stack = [e]
    while stack:
        cur = stack.pop()
        yield cur
        subs = [getattr(cur, attr, None) for attr in ("a", "b", "cond")]
        stack.extend(s for s in reversed(subs) if isinstance(s, Expr))


# ---------------------------------------------------------------------------
# Nets and items
# ---------------------------------------------------------------------------

WIRE = "wire"
REG = "reg"


@dataclass
class Net:
    """A declared identifier: a wire (driven by one ``CombAssign``) or a reg
    (written by clocked items).  ``origin`` tags special roles for the
    resource model (``"regbank"`` cells) without subclassing."""

    name: str
    width: int
    kind: str = WIRE  # WIRE | REG
    signed: bool = False
    origin: str = ""
    comment: str = ""


@dataclass
class Port:
    name: str
    dir: str  # "input" | "output"
    width: int


class Item:
    """Base class of RTL statements.  ``reads()``/``writes()`` are the net
    names this item consumes/drives — the hooks every RTL pass is built on."""

    loc: Loc = UNKNOWN_LOC

    def reads(self) -> Iterator[str]:
        return iter(())

    def writes(self) -> Iterator[str]:
        return iter(())

    def exprs(self) -> Iterator[Expr]:
        return iter(())

    def map_refs(self, ren: dict[str, str]) -> None:
        """Rename read references in place (dest names are never renamed)."""


class CombAssign(Item):
    """``assign dest = expr;`` (dest is a wire or an output port)."""

    __slots__ = ("dest", "expr", "loc")

    def __init__(self, dest: str, expr: Expr, loc: Loc = UNKNOWN_LOC):
        self.dest = dest
        self.expr = expr
        self.loc = loc

    def reads(self) -> Iterator[str]:
        return self.expr.refs()

    def writes(self) -> Iterator[str]:
        yield self.dest

    def exprs(self) -> Iterator[Expr]:
        yield self.expr

    def map_refs(self, ren: dict[str, str]) -> None:
        self.expr = self.expr.map_refs(ren)


class ShiftReg(Item):
    """``dest`` = ``src`` delayed by ``depth`` cycles (depth >= 1).  Prints
    as an SRL-style chain; ``reset_zero`` chains (pulse networks) clear on
    ``rst``."""

    __slots__ = ("dest", "src", "width", "depth", "reset_zero", "loc")

    def __init__(self, dest: str, src: Expr, width: int, depth: int,
                 reset_zero: bool = False, loc: Loc = UNKNOWN_LOC):
        assert depth >= 1, depth
        self.dest = dest
        self.src = src
        self.width = width
        self.depth = depth
        self.reset_zero = reset_zero
        self.loc = loc

    def reads(self) -> Iterator[str]:
        return self.src.refs()

    def writes(self) -> Iterator[str]:
        yield self.dest

    def exprs(self) -> Iterator[Expr]:
        yield self.src

    def map_refs(self, ren: dict[str, str]) -> None:
        self.src = self.src.map_refs(ren)


class RegAssign(Item):
    """``always @(posedge clk) if (en) dest <= src;`` — one clocked register
    write (en=None writes every cycle)."""

    __slots__ = ("dest", "src", "en", "loc")

    def __init__(self, dest: str, src: Expr, en: Optional[Expr] = None,
                 loc: Loc = UNKNOWN_LOC):
        self.dest = dest
        self.src = src
        self.en = en
        self.loc = loc

    def reads(self) -> Iterator[str]:
        yield from self.src.refs()
        if self.en is not None:
            yield from self.en.refs()

    def writes(self) -> Iterator[str]:
        yield self.dest

    def exprs(self) -> Iterator[Expr]:
        yield self.src
        if self.en is not None:
            yield self.en

    def map_refs(self, ren: dict[str, str]) -> None:
        self.src = self.src.map_refs(ren)
        if self.en is not None:
            self.en = self.en.map_refs(ren)


class Memory(Item):
    """A banked on-chip memory (lutram / bram).  Declares
    ``{name}_ram{bk}[0:depth-1]`` per bank; accessed by MemRead/MemWrite."""

    __slots__ = ("name", "banks", "depth", "width", "kind", "ports", "loc")

    def __init__(self, name: str, banks: int, depth: int, width: int,
                 kind: str, ports: int = 2, loc: Loc = UNKNOWN_LOC):
        self.name = name
        self.banks = banks
        self.depth = depth
        self.width = width
        self.kind = kind  # "lutram" | "bram"
        self.ports = ports
        self.loc = loc


class MemRead(Item):
    """Synchronous read: ``if (en) dest <= mem_ram{bank}[addr];``."""

    __slots__ = ("dest", "mem", "bank", "addr", "en", "loc")

    def __init__(self, dest: str, mem: str, bank: int, addr: Expr, en: Expr,
                 loc: Loc = UNKNOWN_LOC):
        self.dest = dest
        self.mem = mem
        self.bank = bank
        self.addr = addr
        self.en = en
        self.loc = loc

    def reads(self) -> Iterator[str]:
        yield from self.addr.refs()
        yield from self.en.refs()

    def writes(self) -> Iterator[str]:
        yield self.dest

    def exprs(self) -> Iterator[Expr]:
        yield self.addr
        yield self.en

    def map_refs(self, ren: dict[str, str]) -> None:
        self.addr = self.addr.map_refs(ren)
        self.en = self.en.map_refs(ren)


class MemWrite(Item):
    """Synchronous write: ``if (en) mem_ram{bank}[addr] <= data;``."""

    __slots__ = ("mem", "bank", "addr", "data", "en", "loc")

    def __init__(self, mem: str, bank: int, addr: Expr, data: Expr, en: Expr,
                 loc: Loc = UNKNOWN_LOC):
        self.mem = mem
        self.bank = bank
        self.addr = addr
        self.data = data
        self.en = en
        self.loc = loc

    def reads(self) -> Iterator[str]:
        yield from self.addr.refs()
        yield from self.data.refs()
        yield from self.en.refs()

    def exprs(self) -> Iterator[Expr]:
        yield self.addr
        yield self.data
        yield self.en

    def map_refs(self, ren: dict[str, str]) -> None:
        self.addr = self.addr.map_refs(ren)
        self.data = self.data.map_refs(ren)
        self.en = self.en.map_refs(ren)


class LoopController(Item):
    """The counter-based FSM of one ``hir.for``: drives the induction
    variable ``iv``, the per-iteration pulse ``iter``, the completion pulse
    ``endp`` and the ``active`` flag.  ``ii`` is the constant initiation
    interval; ``inner_end`` (sequential loops) launches the next iteration
    from an inner completion pulse instead."""

    __slots__ = ("prefix", "iv", "ivw", "active", "iter_net", "endp",
                 "iicnt", "start", "lb", "ub", "step", "ii", "inner_end",
                 "loc")

    def __init__(self, prefix: str, iv: str, ivw: int, active: str,
                 iter_net: str, endp: str, start: Expr, lb: Expr, ub: Expr,
                 step: Expr, ii: Optional[int] = None,
                 inner_end: Optional[Expr] = None, iicnt: str = "",
                 loc: Loc = UNKNOWN_LOC):
        assert (ii is None) != (inner_end is None), "constant II xor sequential"
        self.prefix = prefix
        self.iv = iv
        self.ivw = ivw
        self.active = active
        self.iter_net = iter_net
        self.endp = endp
        self.iicnt = iicnt
        self.start = start
        self.lb = lb
        self.ub = ub
        self.step = step
        self.ii = ii
        self.inner_end = inner_end
        self.loc = loc

    def reads(self) -> Iterator[str]:
        for e in self.exprs():
            yield from e.refs()

    def writes(self) -> Iterator[str]:
        yield self.iv
        yield self.active
        yield self.iter_net
        if self.endp:  # pruned to "" by rtl-dce when the pulse is unread
            yield self.endp
        if self.iicnt:
            yield self.iicnt

    def exprs(self) -> Iterator[Expr]:
        yield self.start
        yield self.lb
        yield self.ub
        yield self.step
        if self.inner_end is not None:
            yield self.inner_end

    def map_refs(self, ren: dict[str, str]) -> None:
        self.start = self.start.map_refs(ren)
        self.lb = self.lb.map_refs(ren)
        self.ub = self.ub.map_refs(ren)
        self.step = self.step.map_refs(ren)
        if self.inner_end is not None:
            self.inner_end = self.inner_end.map_refs(ren)


class Instance(Item):
    """A module instantiation.  ``conns`` is an ordered list of
    ``(port_name, expr, is_output)``: inputs take arbitrary expressions,
    outputs must be ``Ref`` to a net this instance drives.

    ``share_meta`` is stamped by the hierarchical lowering when the callee
    module is a pure feed-forward pipeline with an all-scalar interface:
    ``(result_delays, scalar_input_ports)`` with ports as ``(name, width)``
    pairs.  Only stamped instances are candidates for
    ``rtl-share-instances``/``rtl-arbitrate``; ``share`` lists the instance
    names a merged (time-multiplexed) instance absorbed, so printers and the
    resource model can surface the sharing degree."""

    __slots__ = ("module", "inst", "conns", "share", "share_meta", "loc")

    def __init__(self, module: str, inst: str,
                 conns: list[tuple[str, Expr, bool]], loc: Loc = UNKNOWN_LOC,
                 share: tuple = (), share_meta: Optional[tuple] = None):
        self.module = module
        self.inst = inst
        self.conns = list(conns)
        self.share = tuple(share)
        self.share_meta = share_meta
        self.loc = loc

    def reads(self) -> Iterator[str]:
        for _p, e, is_out in self.conns:
            if not is_out:
                yield from e.refs()

    def writes(self) -> Iterator[str]:
        for _p, e, is_out in self.conns:
            if is_out:
                assert isinstance(e, Ref), (self.inst, _p)
                yield e.name

    def exprs(self) -> Iterator[Expr]:
        for _p, e, _o in self.conns:
            yield e

    def map_refs(self, ren: dict[str, str]) -> None:
        self.conns = [(p, e if is_out else e.map_refs(ren), is_out)
                      for p, e, is_out in self.conns]


class PortConflictAssert(Item):
    """The §4.5 UB guard: simulation-only ``$error`` when two enables of one
    bus fire in the same cycle."""

    __slots__ = ("bus", "ens", "loc")

    def __init__(self, bus: str, ens: list[Expr], loc: Loc = UNKNOWN_LOC):
        self.bus = bus
        self.ens = list(ens)
        self.loc = loc

    def reads(self) -> Iterator[str]:
        for e in self.ens:
            yield from e.refs()

    def exprs(self) -> Iterator[Expr]:
        return iter(self.ens)

    def map_refs(self, ren: dict[str, str]) -> None:
        self.ens = [e.map_refs(ren) for e in self.ens]


def clone_item(it: Item, ren: Optional[dict[str, str]] = None) -> Item:
    """Copy one item, renaming *both* read references and destination names
    through ``ren``.  Expressions are immutable and shared where unchanged;
    memory and instance names go through the same map as nets, so a single
    ``ren`` built from a module's full namespace relocates the whole item."""
    ren = ren or {}

    def nn(name: str) -> str:
        return ren.get(name, name)

    def ee(e: Expr) -> Expr:
        return e.map_refs(ren) if ren else e

    if isinstance(it, CombAssign):
        return CombAssign(nn(it.dest), ee(it.expr), it.loc)
    if isinstance(it, ShiftReg):
        return ShiftReg(nn(it.dest), ee(it.src), it.width, it.depth,
                        it.reset_zero, it.loc)
    if isinstance(it, RegAssign):
        return RegAssign(nn(it.dest), ee(it.src),
                         None if it.en is None else ee(it.en), it.loc)
    if isinstance(it, Memory):
        return Memory(nn(it.name), it.banks, it.depth, it.width, it.kind,
                      it.ports, it.loc)
    if isinstance(it, MemRead):
        return MemRead(nn(it.dest), nn(it.mem), it.bank, ee(it.addr),
                       ee(it.en), it.loc)
    if isinstance(it, MemWrite):
        return MemWrite(nn(it.mem), it.bank, ee(it.addr), ee(it.data),
                        ee(it.en), it.loc)
    if isinstance(it, LoopController):
        return LoopController(
            nn(it.prefix), nn(it.iv), it.ivw, nn(it.active), nn(it.iter_net),
            nn(it.endp) if it.endp else "", ee(it.start), ee(it.lb),
            ee(it.ub), ee(it.step), it.ii,
            None if it.inner_end is None else ee(it.inner_end),
            nn(it.iicnt) if it.iicnt else "", it.loc)
    if isinstance(it, Instance):
        # output connections are Refs into the surrounding namespace: rename
        # them like any other name (Instance.map_refs deliberately skips them
        # because passes only rewrite *reads*; cloning relocates everything).
        conns = [(p, Ref(nn(e.name)) if is_out else ee(e), is_out)
                 for p, e, is_out in it.conns]
        return Instance(it.module, nn(it.inst), conns, it.loc,
                        share=tuple(nn(s) for s in it.share),
                        share_meta=it.share_meta)
    if isinstance(it, PortConflictAssert):
        return PortConflictAssert(it.bus, [ee(e) for e in it.ens], it.loc)
    raise NotImplementedError(type(it).__name__)


# ---------------------------------------------------------------------------
# Modules and designs
# ---------------------------------------------------------------------------


class RTLModule:
    """One hardware module: ports, net declarations and an ordered item
    list.  ``arg_ports``/``result_ports`` record the interface-port names of
    the originating ``hir.func``'s arguments/results, so callers can build
    ``Instance`` connections without re-deriving naming."""

    def __init__(self, name: str, loc: Loc = UNKNOWN_LOC):
        self.name = name
        self.loc = loc
        self.ports: list[Port] = []
        self.nets: dict[str, Net] = {}
        self.items: list[Item] = []
        # hir.func interface map, filled by the lowering: per argument index,
        # the interface ports as (port_name, dir, role, bank) tuples — role in
        # {"scalar", "rd_addr", "rd_en", "rd_data", "wr_addr", "wr_en",
        # "wr_data"}, bank -1 for non-banked ports.  Callers build Instance
        # connections from this instead of re-deriving the naming scheme.
        self.arg_ports: dict[int, list[tuple[str, str, str, int]]] = {}
        self.result_ports: list[tuple[str, str]] = []  # (data, valid)
        self.source_func: str = name

    # -- construction ------------------------------------------------------
    def add_port(self, name: str, dir: str, width: int = 1) -> str:
        assert not any(p.name == name for p in self.ports), name
        self.ports.append(Port(name, dir, width))
        return name

    def new_net(self, name: str, width: int, kind: str = WIRE,
                signed: bool = False, origin: str = "",
                comment: str = "") -> str:
        assert name not in self.nets, name
        self.nets[name] = Net(name, width, kind, signed, origin, comment)
        return name

    def add(self, item: Item) -> Item:
        self.items.append(item)
        return item

    # -- queries -----------------------------------------------------------
    def port_names(self) -> set[str]:
        return {p.name for p in self.ports}

    def output_ports(self) -> set[str]:
        return {p.name for p in self.ports if p.dir == "output"}

    def memories(self) -> dict[str, Memory]:
        return {it.name: it for it in self.items if isinstance(it, Memory)}

    def instances(self) -> list[Instance]:
        return [it for it in self.items if isinstance(it, Instance)]

    # -- mutation helpers used by the passes ---------------------------------
    def replace_net(self, old: str, new: str) -> int:
        """Rewrite every *read* reference to ``old`` into ``new``; the net
        declaration and its drivers are untouched.  Returns #items touched."""
        ren = {old: new}
        n = 0
        for it in self.items:
            before = list(it.reads())
            if old in before:
                it.map_refs(ren)
                n += 1
        return n

    def drop_items(self, dead: set[int]) -> None:
        self.items = [it for i, it in enumerate(self.items) if i not in dead]

    def prune_nets(self) -> int:
        """Drop net declarations that no remaining item reads or writes and
        that are not ports.  Returns the number removed."""
        used: set[str] = set()
        for it in self.items:
            used.update(it.reads())
            used.update(it.writes())
        used.update(self.port_names())
        dead = [n for n in self.nets if n not in used]
        for n in dead:
            del self.nets[n]
        return len(dead)

    def copy(self, name: Optional[str] = None) -> "RTLModule":
        """Structural copy: fresh ports/nets/items, expressions shared (they
        are immutable).  Snapshotting a module before a pass pipeline costs
        O(items), not a deepcopy of the expression DAG."""
        m = RTLModule(name or self.name, self.loc)
        m.ports = [Port(p.name, p.dir, p.width) for p in self.ports]
        m.nets = {n: Net(v.name, v.width, v.kind, v.signed, v.origin,
                         v.comment) for n, v in self.nets.items()}
        m.items = [clone_item(it) for it in self.items]
        m.arg_ports = {i: list(v) for i, v in self.arg_ports.items()}
        m.result_ports = list(self.result_ports)
        m.source_func = self.source_func
        return m


class RTLDesign:
    """A set of RTL modules with a designated entry — what the RTL pass
    pipeline runs on (duck-typing the PassManager's ``Module``)."""

    def __init__(self, modules: Optional[dict[str, RTLModule]] = None,
                 entry: Optional[str] = None):
        self.modules: dict[str, RTLModule] = modules or {}
        self.entry = entry

    def add(self, m: RTLModule) -> RTLModule:
        self.modules[m.name] = m
        return m

    def __iter__(self) -> Iterator[RTLModule]:
        return iter(self.modules.values())

    def instance_counts(self) -> dict[str, int]:
        """Total instantiation multiplicity per module name, entry-rooted
        (an instance inside a module instantiated k times counts k)."""
        counts: dict[str, int] = {}
        roots = [self.entry] if self.entry in self.modules else list(self.modules)

        def visit(name: str, mult: int, stack: tuple) -> None:
            if name in stack or name not in self.modules:
                return
            for inst in self.modules[name].instances():
                counts[inst.module] = counts.get(inst.module, 0) + mult
                visit(inst.module, mult, stack + (name,))

        for r in roots:
            visit(r, 1, ())
        return counts

    def copy(self) -> "RTLDesign":
        return RTLDesign({n: m.copy() for n, m in self.modules.items()},
                         self.entry)

    def flatten(self, entry: Optional[str] = None) -> RTLModule:
        """Inline every ``Instance`` reachable from ``entry`` into one flat
        module.  Callee nets/memories get an ``{inst}__`` prefix per
        instantiation path; input-port connections become ``CombAssign``s
        into the prefixed port net, output connections alias the parent net
        to the callee's driver.  ``clk``/``rst`` are implicit in the item
        semantics and dropped.  The flat module is what the vectorized
        simulator (``codegen.sim``) interprets."""
        entry = entry or self.entry
        assert entry in self.modules, entry
        flat = self.modules[entry].copy()
        guard = 0
        while True:
            idx = next((i for i, it in enumerate(flat.items)
                        if isinstance(it, Instance)), None)
            if idx is None:
                return flat
            guard += 1
            if guard > 100_000:  # cyclic instantiation would loop forever
                raise RecursionError(f"flatten: instance explosion in {entry}")
            inst = flat.items.pop(idx)
            callee = self.modules[inst.module]
            prefix = f"{inst.inst}__"
            ren: dict[str, str] = {}
            for nname in callee.nets:
                ren[nname] = prefix + nname
            for p in callee.ports:
                if p.name not in ("clk", "rst"):
                    ren.setdefault(p.name, prefix + p.name)
            for mem in callee.memories():
                ren.setdefault(mem, prefix + mem)
            for sub in callee.instances():
                ren.setdefault(sub.inst, prefix + sub.inst)
            for v in callee.nets.values():
                nn = ren[v.name]
                assert nn not in flat.nets, nn
                flat.nets[nn] = Net(nn, v.width, v.kind, v.signed,
                                    v.origin or f"inline:{inst.inst}",
                                    v.comment)
            for p in callee.ports:
                if p.name in ("clk", "rst"):
                    continue
                nn = ren[p.name]
                if nn not in flat.nets:
                    flat.nets[nn] = Net(nn, p.width, WIRE, False,
                                        f"inline:{inst.inst}", "")
            pre: list[Item] = []
            post: list[Item] = []
            conn_map = {p: (e, is_out) for p, e, is_out in inst.conns}
            for p in callee.ports:
                if p.name in ("clk", "rst"):
                    continue
                if p.name in conn_map:
                    e, is_out = conn_map[p.name]
                    if is_out:
                        assert isinstance(e, Ref), (inst.inst, p.name)
                        post.append(CombAssign(e.name, Ref(ren[p.name])))
                    else:
                        pre.append(CombAssign(ren[p.name], e))
                elif p.dir == "input":
                    pre.append(CombAssign(ren[p.name], zeros(p.width)))
            body = [clone_item(it, ren) for it in callee.items]
            flat.items[idx:idx] = pre + body + post


# ---------------------------------------------------------------------------
# Verilog printer (the thin layer the old string emitter became)
# ---------------------------------------------------------------------------


def print_rtl(m: RTLModule) -> str:
    """Print one RTLModule as synthesizable Verilog (the default backend).

    Kept as the historical entry point; it now delegates to the backend
    printer layer (``core.codegen.backends``) — ``VerilogPrinter`` produces
    byte-identical output, and sibling printers emit SystemVerilog, VHDL and
    CIRCT ``hw``-dialect MLIR from the same structure."""
    from .backends import VerilogPrinter

    return VerilogPrinter().print_module(m)


def print_design(d: RTLDesign) -> str:
    from .backends import VerilogPrinter

    return VerilogPrinter().print_design(d)


# ---------------------------------------------------------------------------
# Net fan-out analysis (on the shared AnalysisManager)
# ---------------------------------------------------------------------------


@dataclass
class NetFanout:
    """Reader/writer item indices per net of one RTLModule."""

    readers: dict[str, list[int]] = field(default_factory=dict)
    writers: dict[str, list[int]] = field(default_factory=dict)

    def fanout(self, net: str) -> int:
        return len(self.readers.get(net, ()))


@register_analysis
class NetFanoutAnalysis(FunctionAnalysis):
    """Per-module net fan-out — keyed on the RTLModule through the same
    AnalysisManager cache the HIR analyses use (the manager only relies on
    object identity, so RTL modules slot in beside FuncOps)."""

    name = "net-fanout"

    @staticmethod
    def run(func: Any, am: AnalysisManager) -> NetFanout:
        m: RTLModule = func
        fo = NetFanout()
        for i, it in enumerate(m.items):
            for r in it.reads():
                fo.readers.setdefault(r, []).append(i)
            for w in it.writes():
                fo.writers.setdefault(w, []).append(i)
        return fo


# ---------------------------------------------------------------------------
# RTL passes
# ---------------------------------------------------------------------------


class NetReaderIndex:
    """Per-run reader index: net name -> set of items whose ``reads()``
    include it.  ``replace(old, new)`` applies one rename in O(#readers of
    old) instead of ``RTLModule.replace_net``'s O(items x expr-size) full
    scan — the asymptotic fix that makes the sharing passes linear.  The
    index is keyed on item *objects*, so ``drop_items`` compaction never
    invalidates it (renaming an already-dropped item is a harmless no-op,
    exactly like the full-scan path before compaction)."""

    __slots__ = ("readers",)

    def __init__(self, m: RTLModule):
        readers: dict[str, set[Item]] = {}
        for it in m.items:
            for r in it.reads():
                s = readers.get(r)
                if s is None:
                    s = readers[r] = set()
                s.add(it)
        self.readers = readers

    def replace(self, old: str, new: str) -> int:
        """Rewrite every read of ``old`` into ``new`` and migrate the index
        entries.  Returns the number of items touched."""
        its = self.readers.pop(old, None)
        if not its:
            return 0
        ren = {old: new}
        for it in its:
            it.map_refs(ren)
        tgt = self.readers.get(new)
        if tgt is None:
            self.readers[new] = its
        else:
            tgt.update(its)
        return len(its)

    def note_reads(self, it: Item, names: Iterable[str]) -> None:
        """Register reads added by an in-place item mutation done outside
        ``replace`` (stale entries for removed reads are harmless)."""
        for nm in names:
            self.readers.setdefault(nm, set()).add(it)


class RTLPass(Pass):
    """Base of passes running over an ``RTLDesign`` (or a plain dict of
    RTLModules).  Subclasses implement ``run_module``.

    RTL passes only touch ``RTLModule`` netlists, never HIR functions, so
    every HIR-level analysis cached on a shared ``AnalysisManager`` stays
    valid across them (``preserves``).  ``net-fanout`` is also declared
    preserved *globally* because each pass already invalidates it per
    mutated module (``am.invalidate(func=m)``) — modules the pass did not
    change keep their cached fan-out."""

    preserves = ("loop-info", "port-accesses", "mem-touch", "dependence",
                 "net-fanout")

    def run(self, design) -> int:
        _ensure_recursion_headroom()
        mods = design.modules if isinstance(design, RTLDesign) else dict(design)
        n = 0
        for m in mods.values():
            n += self.run_module(m)
        return n

    def run_module(self, m: RTLModule) -> int:
        raise NotImplementedError


@register_pass
class DeadNetElim(RTLPass):
    """Dead-net elimination.  Liveness roots: output ports, instances (their
    inputs feed other modules) and UB assertions.  Memory writes are live
    only while some live item reads the memory; everything else must
    transitively feed a root to survive."""

    name = "rtl-dce"

    def run_module(self, m: RTLModule) -> int:
        n_pruned = self._prune_controller_outputs(m)
        if n_pruned and self.am is not None:
            self.am.invalidate(func=m)
        fo = self.get_analysis(NetFanoutAnalysis, m)
        items = m.items
        needed: set[str] = set(m.output_ports())
        live: set[int] = set()
        live_mems: set[str] = set()

        def mark(i: int) -> None:
            if i in live:
                return
            live.add(i)
            it = items[i]
            for r in it.reads():
                if r not in needed:
                    needed.add(r)
                    for w in fo.writers.get(r, ()):  # drivers become relevant
                        pending.append(w)
            if isinstance(it, MemRead):
                live_mems.add(it.mem)

        pending: list[int] = []
        for i, it in enumerate(items):
            if isinstance(it, (Instance, PortConflictAssert)):
                pending.append(i)
            elif any(w in needed for w in it.writes()):
                pending.append(i)
        while True:
            while pending:
                i = pending.pop()
                if i in live:
                    continue
                it = items[i]
                if isinstance(it, MemWrite) and it.mem not in live_mems:
                    continue  # revisited below if the memory becomes live
                mark(i)
            # memory writes whose memory just became live
            again = [i for i, it in enumerate(items)
                     if i not in live and isinstance(it, MemWrite)
                     and it.mem in live_mems]
            # memory declarations for live memories
            again += [i for i, it in enumerate(items)
                      if i not in live and isinstance(it, Memory)
                      and it.name in live_mems]
            # drivers of newly-needed nets
            again += [w for n in needed for w in fo.writers.get(n, ())
                      if w not in live]
            if not again:
                break
            pending = again

        dead = {i for i in range(len(items)) if i not in live}
        if not dead:
            self._audit_dangling(m)
            return n_pruned
        m.drop_items(dead)
        removed = n_pruned + len(dead) + m.prune_nets()
        self._invalidate(m)
        self._audit_dangling(m)
        return removed

    @staticmethod
    def _audit_dangling(m: RTLModule) -> None:
        """``REPRO_RTL_AUDIT=1``: assert no pass left a read-but-undriven net
        or an undriven output port (the ``ControllerMerge`` ``iicnt`` bug
        class).  The vectorized simulator deliberately ties undriven reads
        to zero, which silently masks such bugs — this audit makes them loud
        in debug/CI runs.  Runs after DCE so legitimately dead logic never
        trips it."""
        import os

        if os.environ.get("REPRO_RTL_AUDIT", "0") in ("", "0"):
            return
        driven = {p.name for p in m.ports if p.dir == "input"}
        driven.update(("clk", "rst"))
        mems: set[str] = set()
        for it in m.items:
            driven.update(it.writes())
            if isinstance(it, Memory):
                mems.add(it.name)
        dangling = sorted({r for it in m.items for r in it.reads()
                           if r not in driven})
        undriven_out = sorted(p.name for p in m.ports
                              if p.dir == "output" and p.name not in driven)
        if dangling or undriven_out:
            raise AssertionError(
                f"rtl-dce audit: module {m.name!r} reads undriven nets "
                f"{dangling}; undriven output ports {undriven_out}")

    def _invalidate(self, m: RTLModule) -> None:
        if self.am is not None:
            self.am.invalidate(func=m)

    @staticmethod
    def _prune_controller_outputs(m: RTLModule) -> int:
        """A controller's completion pulse (``endp``) is a register even
        when nothing consumes it (the last loop of a function with no
        results); drop the unread register from the FSM."""
        read: set[str] = set()
        for it in m.items:
            read.update(it.reads())
        n = 0
        for it in m.items:
            if isinstance(it, LoopController) and it.endp and it.endp not in read:
                m.nets.pop(it.endp, None)
                it.endp = ""
                n += 1
        return n


@register_pass
class ShiftRegMerge(RTLPass):
    """Shift-register merging/sharing.  Chains with the same source
    expression, width and reset behaviour share hardware: equal depths
    collapse to one chain; a deeper chain re-taps the tail of the deepest
    shallower chain (delay d2 becomes d2-d1 cycles after the shared d1
    tail)."""

    name = "rtl-merge-srl"

    def run_module(self, m: RTLModule) -> int:
        groups: dict[tuple, list[tuple[int, ShiftReg]]] = {}
        multi_written = self._multi_written(m)
        for i, it in enumerate(m.items):
            if isinstance(it, ShiftReg) and it.dest not in multi_written:
                key = (it.src.key(), it.width, it.reset_zero)
                groups.setdefault(key, []).append((i, it))
        if not any(len(c) > 1 for c in groups.values()):
            return 0
        idx = NetReaderIndex(m)
        n = 0
        drop: set[int] = set()
        for chain in groups.values():
            if len(chain) < 2:
                continue
            chain.sort(key=lambda s: s[1].depth)
            kept = chain[0][1]
            kept_total = kept.depth  # cumulative delay of kept.dest from the source
            for di, dup in chain[1:]:
                total = dup.depth
                if total == kept_total:
                    idx.replace(dup.dest, kept.dest)
                    drop.add(di)
                    m.nets.pop(dup.dest, None)
                else:
                    # re-tap: source the deeper chain from the current tail,
                    # keeping only the residual depth beyond it
                    dup.src = Ref(kept.dest)
                    idx.note_reads(dup, (kept.dest,))
                    dup.depth = total - kept_total
                    kept, kept_total = dup, total
                n += 1
        if drop:
            m.drop_items(drop)
        if n:
            m.prune_nets()
            if self.am is not None:
                self.am.invalidate(func=m)
        return n

    @staticmethod
    def _multi_written(m: RTLModule) -> set[str]:
        seen: set[str] = set()
        multi: set[str] = set()
        for it in m.items:
            for w in it.writes():
                (multi if w in seen else seen).add(w)
        return multi


@register_pass
class CombShare(RTLPass):
    """Duplicate-comb-expression sharing: structurally identical
    ``CombAssign`` right-hand sides collapse onto the first driver.  An
    output-port duplicate keeps its assign but re-points it at the shared
    net (ports must stay driven)."""

    name = "rtl-share-comb"

    def run_module(self, m: RTLModule) -> int:
        n = 0
        idx: Optional[NetReaderIndex] = None  # built on the first rewrite
        changed = True
        while changed:  # sharing can make further items structurally equal
            changed = False
            seen: dict[int, CombAssign] = {}
            ports = m.port_names()
            drop: set[int] = set()
            for i, it in enumerate(m.items):
                if not isinstance(it, CombAssign):
                    continue
                key = it.expr.key()
                first = seen.get(key)
                if first is None:
                    seen[key] = it
                    continue
                if isinstance(it.expr, Ref) or it.dest == first.dest:
                    continue  # plain aliases gain nothing
                if idx is None:
                    idx = NetReaderIndex(m)
                if it.dest in ports:
                    it.expr = Ref(first.dest)
                    idx.note_reads(it, (first.dest,))
                else:
                    idx.replace(it.dest, first.dest)
                    m.nets.pop(it.dest, None)
                    drop.add(i)
                n += 1
                changed = True
            if drop:
                m.drop_items(drop)
        if n:
            m.prune_nets()
            if self.am is not None:
                self.am.invalidate(func=m)
        return n


@register_pass
class ControllerMerge(RTLPass):
    """Merge structurally identical loop controllers.  After full unrolling,
    replicated loop nests (e.g. the 256 PE k-loops of the gemm systolic
    array) produce byte-identical counter FSMs: same start pulse, bounds,
    step and II.  Two such FSMs are deterministic machines with identical
    inputs, so their outputs (``iv``/``iter``/``endp``/``active``) are
    cycle-for-cycle equal and one copy can drive every consumer."""

    name = "rtl-merge-ctrl"

    def run_module(self, m: RTLModule) -> int:
        groups: dict[tuple, LoopController] = {}
        n = 0
        drop: set[int] = set()
        idx: Optional[NetReaderIndex] = None  # built on the first merge
        for i, it in enumerate(m.items):
            if not isinstance(it, LoopController):
                continue
            key = (it.start.key(), it.lb.key(), it.ub.key(), it.step.key(),
                   it.ii, it.inner_end.key() if it.inner_end is not None else None,
                   it.ivw)
            kept = groups.get(key)
            if kept is None:
                groups[key] = it
                continue
            if idx is None:
                idx = NetReaderIndex(m)
            if it.endp and not kept.endp:
                kept.endp = it.endp  # keep driving the consumed pulse
            else:
                for old, new in (((it.endp, kept.endp),) if it.endp else ()):
                    idx.replace(old, new)
                    m.nets.pop(old, None)
            for old, new in ((it.iv, kept.iv), (it.iter_net, kept.iter_net),
                             (it.active, kept.active)):
                idx.replace(old, new)
                m.nets.pop(old, None)
            if it.iicnt:
                # same ii (part of the key) implies the kept FSM has an
                # iicnt too — redirect the II-phase readers to it
                idx.replace(it.iicnt, kept.iicnt)
                m.nets.pop(it.iicnt, None)
            drop.add(i)
            n += 1
        if drop:
            m.drop_items(drop)
            m.prune_nets()
            if self.am is not None:
                self.am.invalidate(func=m)
        return n


@register_pass
class MemReadShare(RTLPass):
    """Share duplicate synchronous memory reads: identical (memory, bank,
    address, enable) reads return the same data — the paper's §4.4 broadcast
    (same-address parallel reads are one physical port access), so one read
    register can feed every consumer."""

    name = "rtl-share-mem"

    def run_module(self, m: RTLModule) -> int:
        seen: dict[tuple, MemRead] = {}
        n = 0
        drop: set[int] = set()
        idx: Optional[NetReaderIndex] = None  # built on the first share
        for i, it in enumerate(m.items):
            if not isinstance(it, MemRead):
                continue
            key = (it.mem, it.bank, it.addr.key(), it.en.key())
            kept = seen.get(key)
            if kept is None:
                seen[key] = it
                continue
            if idx is None:
                idx = NetReaderIndex(m)
            idx.replace(it.dest, kept.dest)
            m.nets.pop(it.dest, None)
            drop.add(i)
            n += 1
        if drop:
            m.drop_items(drop)
            m.prune_nets()
            if self.am is not None:
                self.am.invalidate(func=m)
        return n


def _instance_conn_maps(it: Instance) -> tuple[dict, dict]:
    """(inputs, outputs) port-name -> expr maps of one instance."""
    ins: dict[str, Expr] = {}
    outs: dict[str, Expr] = {}
    for p, e, is_out in it.conns:
        (outs if is_out else ins)[p] = e
    return ins, outs


class _InstanceMergeBase(RTLPass):
    """Shared machinery of ``rtl-share-instances`` / ``rtl-arbitrate``: merge
    k instances of one feed-forward callee into a single physical instance
    behind a time-division mux tree.  Operands are selected by the firing
    member's activation pulse (first member in program order wins on the
    priority chain), the shared activation is the OR of the member pulses,
    and every member keeps its *own* result/valid nets: results alias the
    shared output (the member only samples it at its own firing time),
    valids are re-derived from the member's own pulse delayed by the
    callee's declared result latency through the existing ``ShiftReg``
    machinery.

    Both passes are **entry-module only**: the design entry is invoked
    exactly once, so instance pulse sets are absolute cycle schedules.  A
    non-entry module can be re-invoked while a previous invocation is still
    in flight (e.g. a pipelined caller at II=1), which would overlay the
    relative pulse sets unpredictably — sharing there is unsound."""

    #: name prefix of the nets the merge introduces (per subclass, so a
    #: share-merged lead can later be arbitrate-merged without collisions)
    net_tag = "sh"
    #: arbitrated merges add the §4.5 ``PortConflictAssert`` residual guard
    arbitrated = False

    def run(self, design) -> int:
        _ensure_recursion_headroom()
        if not isinstance(design, RTLDesign) or not design.entry:
            return 0  # no proven single-invocation root: nothing to share
        m = design.modules.get(design.entry)
        return 0 if m is None else self.run_module(m)

    def run_module(self, m: RTLModule) -> int:
        from ..analysis import ActivationIntervalsAnalysis

        cands: dict[str, list[tuple[int, Instance]]] = {}
        for i, it in enumerate(m.items):
            if isinstance(it, Instance) and it.share_meta is not None:
                cands.setdefault(it.module, []).append((i, it))
        n = 0
        drop: set[int] = set()
        ai = None
        for _callee, insts in cands.items():
            if len(insts) < 2:
                continue
            if ai is None:
                ai = self.get_analysis(ActivationIntervalsAnalysis, m)
            for group in self._group(ai, insts):
                if len(group) < 2:
                    continue
                self._merge(m, group)
                drop.update(i for i, _ in group[1:])
                n += len(group) - 1
        if n:
            m.drop_items(drop)
            m.prune_nets()
            if self.am is not None:
                self.am.invalidate(func=m)
        return n

    @staticmethod
    def _pulse_of(ai, it: Instance):
        ts = _instance_conn_maps(it)[0].get("t_start")
        return None if ts is None else ai.of_expr(ts)

    def _group(self, ai, insts: list) -> list[list]:
        raise NotImplementedError

    def _merge(self, m: RTLModule, group: list[tuple[int, Instance]]) -> None:
        lead = group[0][1]
        delays, in_ports, out_widths = lead.share_meta
        members = [it for _, it in group]
        cmaps = [_instance_conn_maps(it) for it in members]
        ts_exprs = [c[0]["t_start"] for c in cmaps]
        base, tag = lead.inst, self.net_tag

        def fold_first_wins(values: list, width: int) -> Expr:
            v = values[-1]
            for te, mv in zip(reversed(ts_exprs[:-1]), reversed(values[:-1])):
                v = Mux(te, mv, v, width)
            return v

        ts = ts_exprs[0]
        for e in ts_exprs[1:]:
            ts = Binop("|", ts, e, width=1, free=True)
        tsnet = m.new_net(f"{base}_{tag}_ts", 1)
        new_items: list[Item] = [CombAssign(tsnet, ts, loc=lead.loc)]
        conns: list[tuple[str, Expr, bool]] = [
            ("clk", Ref("clk"), False), ("rst", Ref("rst"), False),
            ("t_start", Ref(tsnet), False)]
        for pname, width in in_ports:
            pnet = m.new_net(f"{base}_{tag}_{pname}", width)
            new_items.append(CombAssign(
                pnet, fold_first_wins([c[0][pname] for c in cmaps], width),
                loc=lead.loc))
            conns.append((pname, Ref(pnet), False))
        for ri, d in enumerate(delays):
            rnet = m.new_net(f"{base}_{tag}_r{ri}", out_widths[ri])
            vnet = m.new_net(f"{base}_{tag}_v{ri}", 1)
            conns.append((f"result_{ri}", Ref(rnet), True))
            conns.append((f"result_{ri}_valid", Ref(vnet), True))
            for c, te in zip(cmaps, ts_exprs):
                mr = c[1][f"result_{ri}"].name
                mv = c[1][f"result_{ri}_valid"].name
                new_items.append(CombAssign(mr, Ref(rnet), loc=lead.loc))
                if d > 0:
                    new_items.append(ShiftReg(mv, te, 1, d, reset_zero=True,
                                              loc=lead.loc))
                else:
                    new_items.append(CombAssign(mv, te, loc=lead.loc))
        lead.conns = conns
        lead.share = lead.share + tuple(
            s for it in members[1:] for s in (it.inst,) + it.share)
        if self.arbitrated:
            new_items.append(PortConflictAssert(tsnet, list(ts_exprs),
                                                loc=lead.loc))
        m.items.extend(new_items)


@register_pass
class ShareInstances(_InstanceMergeBase):
    """Cross-instance time-multiplexing (the paper's §4.4 resource story at
    module granularity): instances of one callee whose ``activation-intervals``
    pulse sets are finite and pairwise disjoint provably never compute in the
    same cycle, so they fold onto one physical instance.  Deterministic
    first-fit greedy packing in program order."""

    name = "rtl-share-instances"
    net_tag = "sh"

    def _group(self, ai, insts: list) -> list[list]:
        groups: list[list] = []  # [union_pulses, members...]
        for i, it in insts:
            p = self._pulse_of(ai, it)
            if p is None:
                continue  # unknown schedule: rtl-arbitrate's problem
            for g in groups:
                if not (g[0] & p):
                    g[0] = g[0] | p
                    g.append((i, it))
                    break
            else:
                groups.append([p, (i, it)])
        return [g[1:] for g in groups]


@register_pass
class ArbitrateInstances(_InstanceMergeBase):
    """II-aware arbitration — sharing that degrades gracefully when pulses
    *can* coincide.  Two jobs:

    1. prune ``PortConflictAssert`` guards whose enables are finite and
       pairwise disjoint (the analysis discharged the §4.5 obligation
       statically, so the runtime monitor is dead weight);
    2. merge same-callee instances whose pulse schedules the analysis could
       *not* bound (TOP) behind a static-priority arbiter (first instance in
       program order wins the operand mux) with a ``PortConflictAssert`` on
       the shared activation guarding the residual §4.5 condition.
       Instances with structurally identical activation pulses provably
       coincide every firing and are left alone."""

    name = "rtl-arbitrate"
    net_tag = "arb"
    arbitrated = True

    def run_module(self, m: RTLModule) -> int:
        return self._prune_proven_asserts(m) + super().run_module(m)

    def _prune_proven_asserts(self, m: RTLModule) -> int:
        from ..analysis import ActivationIntervalsAnalysis

        drop: set[int] = set()
        ai = None
        for i, it in enumerate(m.items):
            if not isinstance(it, PortConflictAssert):
                continue
            if ai is None:
                ai = self.get_analysis(ActivationIntervalsAnalysis, m)
            sets = [ai.of_expr(e) for e in it.ens]
            if any(s is None for s in sets):
                continue
            union: frozenset = frozenset()
            total = 0
            for s in sets:
                union |= s
                total += len(s)
            if total == len(union):  # pairwise disjoint: can never trip
                drop.add(i)
        if drop:
            m.drop_items(drop)
            m.prune_nets()
            if self.am is not None:
                self.am.invalidate(func=m)
        return len(drop)

    def _group(self, ai, insts: list) -> list[list]:
        group: list = []
        keys: set[int] = set()
        for i, it in insts:
            if self._pulse_of(ai, it) is not None:
                continue  # bounded schedules are rtl-share-instances' job
            ts = _instance_conn_maps(it)[0].get("t_start")
            k = ts.key() if ts is not None else None
            if k is None or k in keys:
                continue  # identical pulse nets fire together: never share
            keys.add(k)
            group.append((i, it))
        return [group]


#: Default post-lowering RTL pipeline.  Controller merging first (it unifies
#: induction-variable nets, which makes address/compute expressions
#: structurally equal), then comb-expression sharing, then the broadcast
#: read share (now that addresses are unified), shift-register merging, then
#: cross-instance time-multiplexing (proven-disjoint pulses) and the
#: II-aware arbitration fallback, and a final dead-net sweep.  The
#: PassManager's fixpoint loop re-runs the sequence while any pass still
#: fires.
RTL_PIPELINE_SPEC = ("rtl-merge-ctrl,rtl-share-comb,rtl-share-mem,"
                     "rtl-merge-srl,rtl-share-instances,rtl-arbitrate,"
                     "rtl-dce")
