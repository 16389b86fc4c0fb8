"""HIR core IR: SSA values, time variables, operations, regions, functions.

This module reproduces the HIR dialect of Majumder & Bondhugula (2021) as an
in-Python MLIR-style IR.  The three orthogonal components of a hardware design
(paper §4) map to:

  * algorithm  -> the SSA dataflow graph (ops + values),
  * schedule   -> every op carries a ``Time`` (time-variable + constant offset),
  * binding    -> memref kinds (``reg``/``lutram``/``bram``) and banking
                  (packed vs. distributed dims).

Nothing here depends on JAX; lowering lives in ``core.lower``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional, Sequence, Union

# --------------------------------------------------------------------------
# Source locations (used by the verifier for paper-style diagnostics)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Loc:
    file: str = "<unknown>"
    line: int = 0
    col: int = 0

    def __str__(self) -> str:
        return f"{self.file}:{self.line}:{self.col}"


UNKNOWN_LOC = Loc()


# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------


class Type:
    """Base class for HIR types."""

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self) -> int:
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items(), key=lambda kv: kv[0]))))

    def __repr__(self) -> str:
        return str(self)


class IntType(Type):
    """Arbitrary bit-width integer (paper §4.3)."""

    def __init__(self, width: int, signed: bool = True):
        assert width >= 1, f"integer width must be >=1, got {width}"
        self.width = int(width)
        self.signed = bool(signed)

    def __str__(self) -> str:
        return f"i{self.width}" if self.signed else f"u{self.width}"

    def __hash__(self) -> int:
        return hash(("IntType", self.width, self.signed))


class FloatType(Type):
    def __init__(self, width: int = 32):
        assert width in (16, 32, 64), f"unsupported float width {width}"
        self.width = int(width)

    def __str__(self) -> str:
        return f"f{self.width}"

    def __hash__(self) -> int:
        return hash(("FloatType", self.width))


class ConstType(Type):
    """Compile-time constant integer (``!hir.const``).  Always-valid, consumes
    no hardware; used for loop bounds, bank indices and delays."""

    def __str__(self) -> str:
        return "!hir.const"

    def __hash__(self) -> int:
        return hash("ConstType")


class TimeType(Type):
    """A time variable (``!hir.time``): a specific cycle within a lexical
    scope, the paper's key abstraction (§4.2)."""

    def __str__(self) -> str:
        return "!hir.time"

    def __hash__(self) -> int:
        return hash("TimeType")


# memref port kinds
PORT_R = "r"
PORT_W = "w"
PORT_RW = "rw"

# memref storage kinds (binding component)
KIND_REG = "reg"
KIND_LUTRAM = "lutram"  # distributed RAM
KIND_BRAM = "bram"  # block RAM


class MemrefType(Type):
    """Multi-dimensional memory reference (paper §4.4).

    ``shape``        tensor dims.
    ``elem``         element type.
    ``port``         access permission of *this* memref value: r / w / rw.
    ``packed``       indices of the *packed* dims (same buffer, linearised
                     layout).  Every other dim is *distributed* (banked):
                     distinct indices go to distinct physical buffers and may
                     be accessed in parallel (paper Fig. 3).
    ``kind``         physical binding: registers, distributed RAM, block RAM.
    """

    def __init__(
        self,
        shape: Sequence[int],
        elem: Type,
        port: str = PORT_RW,
        packed: Optional[Sequence[int]] = None,
        kind: str = KIND_BRAM,
    ):
        assert port in (PORT_R, PORT_W, PORT_RW), port
        assert kind in (KIND_REG, KIND_LUTRAM, KIND_BRAM), kind
        self.shape = tuple(int(d) for d in shape)
        assert all(d >= 1 for d in self.shape), self.shape
        self.elem = elem
        self.port = port
        self.packed = tuple(sorted(int(i) for i in (packed if packed is not None else range(len(self.shape)))))
        assert all(0 <= i < len(self.shape) for i in self.packed), (self.packed, self.shape)
        self.kind = kind

    # -- helpers ----------------------------------------------------------
    @property
    def distributed(self) -> tuple[int, ...]:
        return tuple(i for i in range(len(self.shape)) if i not in self.packed)

    @property
    def num_banks(self) -> int:
        n = 1
        for i in self.distributed:
            n *= self.shape[i]
        return n

    @property
    def bank_elems(self) -> int:
        n = 1
        for i in self.packed:
            n *= self.shape[i]
        return n

    def elem_bits(self) -> int:
        if isinstance(self.elem, (IntType, FloatType)):
            return self.elem.width
        raise TypeError(f"memref of non-primitive elem {self.elem}")

    def read_latency(self) -> int:
        """Registers read combinationally; RAMs take one cycle (paper §4.1)."""
        return 0 if self.kind == KIND_REG else 1

    def with_port(self, port: str) -> "MemrefType":
        return MemrefType(self.shape, self.elem, port, self.packed, self.kind)

    def __str__(self) -> str:
        dims = "*".join(str(d) for d in self.shape)
        extra = ""
        if self.packed != tuple(range(len(self.shape))):
            extra += f", packing=[{','.join(str(i) for i in self.packed)}]"
        if self.kind != KIND_BRAM:
            extra += f", kind={self.kind}"
        return f"!hir.memref<{dims}*{self.elem}, {self.port}{extra}>"

    def __hash__(self) -> int:
        return hash(("MemrefType", self.shape, self.elem, self.port, self.packed, self.kind))


# Singletons / helpers
CONST = ConstType()
TIME = TimeType()
i1 = IntType(1)
i8 = IntType(8)
i16 = IntType(16)
i32 = IntType(32)
i64 = IntType(64)
f32 = FloatType(32)


def IntT(width: int, signed: bool = True) -> IntType:
    return IntType(width, signed)


def is_primitive(t: Type) -> bool:
    return isinstance(t, (IntType, FloatType))


# --------------------------------------------------------------------------
# SSA values and time expressions
# --------------------------------------------------------------------------

_value_ids = itertools.count()


class Use(NamedTuple):
    """A single operand slot referencing a value (MLIR's OpOperand)."""

    op: "Operation"
    index: int


class Value:
    """An SSA value.  ``birth`` is the schedule information: for primitive
    values it records when the value becomes valid (paper §4.3: each SSA
    variable of primitive type is defined only at a specific time instant).
    Constants and memrefs have ``birth is None`` (always valid).

    Every value maintains its *use-def chain*: ``_use_ops`` is a multiset of
    the operations currently holding this value as an operand, kept up to
    date by the ``OperandList`` mutation hooks.  Use queries (``uses``,
    ``users``, ``replace_all_uses_with``) are therefore O(#uses) instead of
    O(region) — the asymptotic difference that makes the worklist rewriter
    in ``core.rewrite`` fast."""

    __slots__ = ("id", "type", "name", "defining_op", "birth", "validity_end", "_use_ops")

    def __init__(self, type: Type, name: str = "", defining_op: Optional["Operation"] = None):
        self.id = next(_value_ids)
        self.type = type
        self.name = name or f"v{self.id}"
        self.defining_op = defining_op
        # ``birth``: Optional[Time] — cycle at which the value becomes valid.
        self.birth: Optional[Time] = None
        # validity window length in cycles; None => valid forever after birth
        # (e.g. a sequential loop's induction variable), 1 => single cycle.
        self.validity_end: Optional[int] = 1
        # op -> number of operand slots of that op holding this value
        self._use_ops: dict["Operation", int] = {}

    # -- use-def chain ------------------------------------------------------
    @property
    def uses(self) -> list[Use]:
        """All (op, operand_index) slots currently holding this value."""
        out: list[Use] = []
        for op in self._use_ops:
            for i, o in enumerate(op.operands):
                if o is self:
                    out.append(Use(op, i))
        return out

    def users(self) -> list["Operation"]:
        """Operations using this value (each listed once)."""
        return list(self._use_ops)

    @property
    def num_uses(self) -> int:
        return sum(self._use_ops.values())

    def has_uses(self) -> bool:
        return bool(self._use_ops)

    def replace_all_uses_with(self, new: "Value") -> int:
        """Replace *every* use of this value, anywhere in the IR, with
        ``new``.  O(#uses).  Returns the number of replaced operand slots.

        The use-def bookkeeping is batched: all of one user's slots move in
        a single counter transfer instead of an unregister/register pair per
        slot (the per-slot ``OperandList.__setitem__`` path)."""
        if new is self:
            return 0
        n = 0
        new_uses = new._use_ops
        for op, cnt in list(self._use_ops.items()):
            ol = op.operands
            for i, o in enumerate(ol):
                if o is self:
                    list.__setitem__(ol, i, new)
            if ol._live:
                del self._use_ops[op]
                new_uses[op] = new_uses.get(op, 0) + cnt
            n += cnt
        return n

    def __repr__(self) -> str:
        return f"%{self.name}: {self.type}"

    def __hash__(self) -> int:
        return self.id

    def __eq__(self, other: Any) -> bool:
        return self is other


@dataclass(frozen=True)
class Time:
    """A time expression: ``tv + offset`` where ``tv`` is a time variable
    (an SSA Value of TimeType) and ``offset`` a compile-time constant."""

    tv: Value
    offset: int = 0

    def __post_init__(self):
        assert isinstance(self.tv.type, TimeType), self.tv
        assert self.offset >= 0, f"negative time offset {self.offset}"

    def __add__(self, k: int) -> "Time":
        return Time(self.tv, self.offset + int(k))

    def __str__(self) -> str:
        if self.offset == 0:
            return f"%{self.tv.name}"
        return f"%{self.tv.name} offset {self.offset}"


# --------------------------------------------------------------------------
# Operations and regions
# --------------------------------------------------------------------------


class Region:
    """A lexical scope: a list of operations plus block arguments (e.g. the
    loop induction variable and the iteration time variable)."""

    __slots__ = ("args", "ops", "parent_op")

    def __init__(self, args: Sequence[Value] = ()):  # block args
        self.args: list[Value] = list(args)
        self.ops: list[Operation] = []
        self.parent_op: Optional[Operation] = None

    def add(self, op: "Operation") -> "Operation":
        op.parent_region = self
        self.ops.append(op)
        return op

    def insert(self, index: int, op: "Operation") -> "Operation":
        op.parent_region = self
        self.ops.insert(index, op)
        return op

    def insert_before(self, anchor: "Operation", op: "Operation") -> "Operation":
        return self.insert(self.ops.index(anchor), op)

    def remove(self, op: "Operation") -> None:
        self.ops.remove(op)
        op.parent_region = None

    def walk(self) -> Iterator["Operation"]:
        """Preorder walk (op before its nested regions).  Eager: snapshots
        the op tree, so callers may mutate region op-lists while iterating;
        nested ``yield from`` generator chains were a measurable per-op cost
        in the optimizer hot loop."""
        out: list[Operation] = []
        _collect_ops(self, out)
        return iter(out)


def _collect_ops(region: "Region", out: list) -> None:
    for op in region.ops:
        out.append(op)
        for r in op.regions:
            _collect_ops(r, out)


class OperandList(list):
    """The operand list of one operation.  Every mutation — indexed or sliced
    assignment, append/insert/remove/pop/clear/extend — keeps the operands'
    use-def chains (``Value._use_ops``) consistent, so legacy code that
    mutates ``op.operands`` in place remains correct under the maintained
    invariant."""

    __slots__ = ("owner", "_live")

    def __init__(self, owner: "Operation", values: Sequence[Value] = ()):
        super().__init__(values)
        self.owner = owner
        self._live = True
        for v in values:
            self._register(v)

    # -- chain bookkeeping --------------------------------------------------
    def _register(self, v: Value) -> None:
        if self._live:
            u = v._use_ops
            u[self.owner] = u.get(self.owner, 0) + 1

    def _unregister(self, v: Value) -> None:
        if self._live:
            u = v._use_ops
            k = u.get(self.owner, 0) - 1
            if k <= 0:
                u.pop(self.owner, None)
            else:
                u[self.owner] = k

    def _drop_all(self) -> None:
        """Detach this list from the chains (the op is being erased).  The
        list contents are kept so accessors on dead ops still read, but no
        further mutation touches the chains.  Idempotent."""
        if self._live:
            for v in self:
                self._unregister(v)
            self._live = False

    # -- intercepted mutations ---------------------------------------------
    def __setitem__(self, i, v):
        if isinstance(i, slice):
            for old in self[i]:
                self._unregister(old)
            v = list(v)
            for new in v:
                self._register(new)
        else:
            self._unregister(self[i])
            self._register(v)
        super().__setitem__(i, v)

    def __delitem__(self, i):
        if isinstance(i, slice):
            for old in self[i]:
                self._unregister(old)
        else:
            self._unregister(self[i])
        super().__delitem__(i)

    def append(self, v):
        self._register(v)
        super().append(v)

    def extend(self, vs):
        vs = list(vs)
        for v in vs:
            self._register(v)
        super().extend(vs)

    def __iadd__(self, vs):
        self.extend(vs)
        return self

    def insert(self, i, v):
        self._register(v)
        super().insert(i, v)

    def remove(self, v):
        super().remove(v)
        self._unregister(v)

    def pop(self, i=-1):
        v = super().pop(i)
        self._unregister(v)
        return v

    def clear(self):
        for v in self:
            self._unregister(v)
        super().clear()

    def __reduce_ex__(self, protocol):
        # deepcopy/pickle: rebuild through Operation.__init__'s wrapping is
        # impossible here, so reconstruct the raw state (owner backref is
        # restored by copying the owner op's attribute graph).
        return (_rebuild_operand_list, (self.owner, list(self), self._live))


def _rebuild_operand_list(owner, values, live):
    ol = OperandList.__new__(OperandList)
    list.__init__(ol, values)
    ol.owner = owner
    ol._live = live
    return ol


class Operation:
    """Generic HIR operation.

    ``start``: Optional[Time] — the op's scheduled start (``at %t offset k``).
    ``None`` means *unscheduled*; unscheduled functions are valid input to the
    HLS auto-scheduler (``core.hls``) but are rejected by the strict verifier
    used ahead of Verilog codegen.
    """

    __slots__ = ("opname", "operands", "results", "attrs", "regions", "start", "loc",
                 "parent_region", "_dead")

    def __init__(
        self,
        opname: str,
        operands: Sequence[Value] = (),
        result_types: Sequence[Type] = (),
        attrs: Optional[dict[str, Any]] = None,
        regions: Sequence[Region] = (),
        start: Optional[Time] = None,
        loc: Loc = UNKNOWN_LOC,
        result_names: Sequence[str] = (),
    ):
        self.opname = opname
        self._dead = False
        self.operands: OperandList = OperandList(self, list(operands))
        self.results: list[Value] = []
        for i, rt in enumerate(result_types):
            nm = result_names[i] if i < len(result_names) else ""
            self.results.append(Value(rt, nm, defining_op=self))
        self.attrs: dict[str, Any] = dict(attrs or {})
        self.regions: list[Region] = list(regions)
        for r in self.regions:
            r.parent_op = self
        self.start = start
        self.loc = loc
        self.parent_region: Optional[Region] = None

    # convenience -----------------------------------------------------------
    @property
    def result(self) -> Value:
        assert len(self.results) == 1, f"{self.opname} has {len(self.results)} results"
        return self.results[0]

    def region(self, i: int = 0) -> Region:
        return self.regions[i]

    # -- mutation API (keeps use-def chains consistent) ---------------------
    def set_operand(self, i: int, v: Value) -> None:
        self.operands[i] = v

    @property
    def is_erased(self) -> bool:
        return self._dead

    def drop_all_uses(self) -> None:
        """Unregister every operand use held by this op and (recursively) by
        the ops of its nested regions, and mark them erased.  Called when the
        op is discarded; idempotent."""
        self._dead = True
        self.operands._drop_all()
        for r in self.regions:
            for op in r.ops:
                op.drop_all_uses()

    def erase(self) -> None:
        """Erase this op: drop all operand uses (recursively through nested
        regions) and unlink it from its parent region's op list.  The op's
        results must be dead or already replaced — erasing an op whose
        results still have uses leaves dangling references."""
        self.drop_all_uses()
        if self.parent_region is not None:
            try:
                self.parent_region.ops.remove(self)
            except ValueError:
                pass  # already unlinked (e.g. batch compaction)
            self.parent_region = None

    def __repr__(self) -> str:
        rs = ", ".join(f"%{r.name}" for r in self.results)
        eq = f"{rs} = " if rs else ""
        at = f" at {self.start}" if self.start is not None else ""
        return f"{eq}hir.{self.opname}(...){at}"


# --------------------------------------------------------------------------
# Concrete op constructors.  Each returns the Operation; results carry their
# birth times per the paper's latency model:
#   * combinational arith (add/sub/and/...)       : birth = start + 0
#   * hir.mult (DSP)                              : combinational by default,
#       or pipelined with attrs["stages"]=k        : birth = start + k
#   * hir.mem_read                                : birth = start + latency
#       (0 for registers, 1 for RAMs)
#   * hir.delay %v by k                           : birth = v.birth + k
#   * hir.call                                    : per-result declared delay
# --------------------------------------------------------------------------

ARITH_OPS = {
    # name -> (n_operands, default latency)
    "add": (2, 0),
    "sub": (2, 0),
    "mult": (2, 0),
    "div": (2, 0),
    "and": (2, 0),
    "or": (2, 0),
    "xor": (2, 0),
    "not": (1, 0),
    "shl": (2, 0),
    "shr": (2, 0),
    "cmp_lt": (2, 0),
    "cmp_le": (2, 0),
    "cmp_eq": (2, 0),
    "cmp_ne": (2, 0),
    "cmp_gt": (2, 0),
    "cmp_ge": (2, 0),
    "select": (3, 0),
    "trunc": (1, 0),
    "zext": (1, 0),
    "sext": (1, 0),
}

COMMUTATIVE_OPS = {"add", "mult", "and", "or", "xor", "cmp_eq", "cmp_ne"}


def _arith_result_type(opname: str, operands: Sequence[Value], result_type: Optional[Type]) -> Type:
    if result_type is not None:
        return result_type
    if opname.startswith("cmp_"):
        return IntType(1, signed=False)
    for v in operands:  # first primitive operand wins; consts adapt
        if is_primitive(v.type):
            return v.type
    return operands[0].type


def arith(
    opname: str,
    operands: Sequence[Value],
    start: Optional[Time] = None,
    result_type: Optional[Type] = None,
    stages: int = 0,
    loc: Loc = UNKNOWN_LOC,
) -> Operation:
    assert opname in ARITH_OPS, opname
    nops, _lat = ARITH_OPS[opname]
    assert len(operands) == nops, (opname, len(operands))
    rt = _arith_result_type(opname, operands, result_type)
    op = Operation(opname, operands, [rt], attrs={"stages": stages}, start=start, loc=loc)
    if start is not None:
        op.result.birth = start + stages
    return op


def constant(value: Union[int, float], type: Type = CONST, name: str = "", loc: Loc = UNKNOWN_LOC) -> Operation:
    op = Operation("constant", [], [type], attrs={"value": value}, loc=loc, result_names=[name])
    op.result.birth = None  # constants are always valid
    op.result.validity_end = None
    return op


def alloc(
    memref: MemrefType,
    ports: Sequence[str] = (PORT_R, PORT_W),
    names: Sequence[str] = (),
    loc: Loc = UNKNOWN_LOC,
) -> Operation:
    """Allocate an on-chip tensor; one result memref per requested port
    (paper: each memref pointing to a tensor is a memory port)."""
    rts = [memref.with_port(p) for p in ports]
    op = Operation("alloc", [], rts, attrs={"base": memref, "ports": tuple(ports)}, loc=loc, result_names=names)
    for r in op.results:
        r.birth = None
        r.validity_end = None
    return op


def mem_read(mem: Value, indices: Sequence[Value], start: Time, loc: Loc = UNKNOWN_LOC) -> Operation:
    mt = mem.type
    assert isinstance(mt, MemrefType), mem
    assert mt.port in (PORT_R, PORT_RW), f"mem_read on write-only memref {mem}"
    assert len(indices) == len(mt.shape), (len(indices), mt.shape)
    op = Operation("mem_read", [mem, *indices], [mt.elem], start=start, loc=loc)
    if start is not None:  # unscheduled (erased) reads have no birth yet
        op.result.birth = start + mt.read_latency()
    return op


def mem_write(
    value: Value,
    mem: Value,
    indices: Sequence[Value],
    start: Time,
    pred: Optional[Value] = None,
    loc: Loc = UNKNOWN_LOC,
) -> Operation:
    mt = mem.type
    assert isinstance(mt, MemrefType), mem
    assert mt.port in (PORT_W, PORT_RW), f"mem_write on read-only memref {mem}"
    assert len(indices) == len(mt.shape), (len(indices), mt.shape)
    operands = [value, mem, *indices] + ([pred] if pred is not None else [])
    return Operation("mem_write", operands, [], attrs={"predicated": pred is not None}, start=start, loc=loc)


def mem_write_parts(op: Operation) -> tuple[Value, Value, list[Value], Optional[Value]]:
    """(value, mem, indices, predicate) of a mem_write op."""
    assert op.opname == "mem_write"
    if op.attrs.get("predicated"):
        return op.operands[0], op.operands[1], list(op.operands[2:-1]), op.operands[-1]
    return op.operands[0], op.operands[1], list(op.operands[2:]), None


def mem_read_parts(op: Operation) -> tuple[Value, list[Value]]:
    """(mem, indices) of a mem_read op."""
    assert op.opname == "mem_read"
    return op.operands[0], list(op.operands[1:])


def mem_op_indices(op: Operation) -> list[Value]:
    return mem_read_parts(op)[1] if op.opname == "mem_read" else mem_write_parts(op)[2]


def delay(v: Value, by: int, start: Optional[Time] = None, loc: Loc = UNKNOWN_LOC) -> Operation:
    assert is_primitive(v.type), f"delay of non-primitive {v}"
    assert by >= 0
    op = Operation("delay", [v], [v.type], attrs={"by": int(by)}, start=start, loc=loc)
    if v.birth is not None:
        op.result.birth = v.birth + by
    elif start is not None:
        op.result.birth = start + by
    return op


def time_offset(t: Time, name: str = "", loc: Loc = UNKNOWN_LOC) -> Operation:
    """Materialise a new time variable at ``t`` (used for task-level
    parallelism: several calls scheduled relative to one event)."""
    op = Operation("time", [t.tv], [TIME], attrs={"offset": t.offset}, loc=loc, result_names=[name])
    op.result.birth = None
    op.result.validity_end = None
    return op


class ForOp(Operation):
    """``hir.for %i = lb to ub step s iter_time(%ti = %t offset k) {body}``.

    Results: ``%tf`` — the time at which the *last* iteration's yield fires
    (i.e. loop completion).  Region args: [%i, %ti].
    The loop II is defined by the body's ``hir.yield`` (paper §4.2).
    """

    def __init__(
        self,
        lb: Value,
        ub: Value,
        step: Value,
        start: Time,
        iv_type: Type = i32,
        iter_arg_offset: int = 0,
        unroll: bool = False,
        iv_name: str = "i",
        tv_name: str = "ti",
        loc: Loc = UNKNOWN_LOC,
    ):
        iv = Value(iv_type, iv_name)
        tv = Value(TIME, tv_name)
        tv.birth = None
        tv.validity_end = None
        body = Region([iv, tv])
        super().__init__(
            "unroll_for" if unroll else "for",
            [lb, ub, step],
            [TIME],
            attrs={"iter_arg_offset": int(iter_arg_offset)},
            regions=[body],
            start=start,
            loc=loc,
            result_names=["tf"],
        )
        # induction variable is born at the iteration start; its validity
        # window is [ti, ti+II) — II is fixed later by the verifier from the
        # yield op.  Until then validity_end=None is refined by analysis.
        iv.birth = Time(tv, 0)
        iv.validity_end = None
        self.results[0].birth = None
        self.results[0].validity_end = None

    # -- accessors ---------------------------------------------------------
    @property
    def lb(self) -> Value:
        return self.operands[0]

    @property
    def ub(self) -> Value:
        return self.operands[1]

    @property
    def step(self) -> Value:
        return self.operands[2]

    @property
    def iv(self) -> Value:
        return self.regions[0].args[0]

    @property
    def time_var(self) -> Value:
        return self.regions[0].args[1]

    @property
    def end_time(self) -> Value:
        return self.results[0]

    def yield_op(self) -> Optional[Operation]:
        for op in self.regions[0].ops:
            if op.opname == "yield":
                return op
        return None

    def initiation_interval(self) -> Optional[int]:
        """Constant II if the yield is scheduled on the iteration time var,
        else None (sequential / data-dependent II)."""
        y = self.yield_op()
        if y is None or y.start is None:
            return None
        if y.start.tv is self.time_var:
            return y.start.offset
        return None

    def trip_count(self) -> Optional[int]:
        def cval(v: Value) -> Optional[int]:
            if v.defining_op is not None and v.defining_op.opname == "constant":
                return int(v.defining_op.attrs["value"])
            return None

        lb, ub, st = cval(self.lb), cval(self.ub), cval(self.step)
        if lb is None or ub is None or st is None or st == 0:
            return None
        return max(0, -(-(ub - lb) // st))


def yield_op(start: Time, loc: Loc = UNKNOWN_LOC) -> Operation:
    return Operation("yield", [], [], start=start, loc=loc)


def return_op(values: Sequence[Value] = (), loc: Loc = UNKNOWN_LOC) -> Operation:
    return Operation("return", list(values), [], loc=loc)


class FuncOp(Operation):
    """``hir.func @name at %t (args...) -> (results...)``.

    The function's schedule interface (paper §5.4): every primitive argument
    carries an input delay (cycles after %t at which the caller supplies it)
    and every result a declared output delay.  This is what makes calls to
    external Verilog modules handshake-free.
    """

    def __init__(
        self,
        name: str,
        arg_types: Sequence[Type],
        arg_names: Sequence[str] = (),
        arg_delays: Optional[Sequence[int]] = None,
        result_types: Sequence[Type] = (),
        result_delays: Optional[Sequence[int]] = None,
        loc: Loc = UNKNOWN_LOC,
    ):
        tv = Value(TIME, "t")
        tv.birth = None
        tv.validity_end = None
        args = []
        for i, at in enumerate(arg_types):
            nm = arg_names[i] if i < len(arg_names) else f"arg{i}"
            v = Value(at, nm)
            if is_primitive(at):
                d = (arg_delays or [0] * len(arg_types))[i]
                v.birth = Time(tv, d)
            else:
                v.birth = None
                v.validity_end = None
            args.append(v)
        body = Region([*args, tv])
        super().__init__(
            "func",
            [],
            [],
            attrs={
                "sym_name": name,
                "arg_delays": tuple(arg_delays or [0] * len(arg_types)),
                "result_types": tuple(result_types),
                "result_delays": tuple(result_delays or [0] * len(result_types)),
            },
            regions=[body],
            loc=loc,
        )

    @property
    def name(self) -> str:
        return self.attrs["sym_name"]

    @property
    def args(self) -> list[Value]:
        return self.regions[0].args[:-1]

    @property
    def time_var(self) -> Value:
        return self.regions[0].args[-1]

    @property
    def body(self) -> Region:
        return self.regions[0]


def call(
    callee: Union[str, FuncOp],
    operands: Sequence[Value],
    start: Time,
    result_types: Sequence[Type] = (),
    result_delays: Sequence[int] = (),
    loc: Loc = UNKNOWN_LOC,
) -> Operation:
    name = callee if isinstance(callee, str) else callee.name
    if isinstance(callee, FuncOp):
        result_types = list(callee.attrs["result_types"])
        result_delays = list(callee.attrs["result_delays"])
    op = Operation(
        "call",
        operands,
        result_types,
        attrs={"callee": name, "result_delays": tuple(result_delays)},
        start=start,
        loc=loc,
    )
    if start is not None:  # unscheduled (erased) calls have no birth yet
        for r, d in zip(op.results, result_delays):
            r.birth = start + d
    return op


class Module:
    """Top-level container of HIR functions (an MLIR module)."""

    def __init__(self, name: str = "module"):
        self.name = name
        self.funcs: dict[str, FuncOp] = {}

    def add(self, f: FuncOp) -> FuncOp:
        assert f.name not in self.funcs, f"duplicate func @{f.name}"
        self.funcs[f.name] = f
        return f

    def get(self, name: str) -> FuncOp:
        return self.funcs[name]

    def walk(self) -> Iterator[Operation]:
        for f in self.funcs.values():
            yield f
            yield from f.body.walk()

    def clone(self) -> "Module":
        """A structurally identical deep copy built by rebuilding ops, values
        and use-def chains directly — an order of magnitude faster than
        ``copy.deepcopy`` (which walks every ``_use_ops`` backref and slot
        through the generic memo machinery).  Value names, op order, attrs,
        schedules (``start``/``birth`` remapped onto the cloned time
        variables) and region structure are preserved; the returned module
        shares no ``Operation``/``Value``/``Region`` objects with the
        original, so both sides can be mutated independently."""
        new = Module(self.name)
        for name, f in self.funcs.items():
            new.funcs[name] = clone_func(f)
        return new


def clone_func(f: FuncOp) -> FuncOp:
    """Clone one function (any ``Operation`` subtree rooted at a FuncOp) with
    fresh Values/Operations and rebuilt use-def chains."""
    return _clone_op(f, {})


def _mapped_value(v: Value, vmap: dict) -> Value:
    """The clone of ``v``.  Values defined inside the cloned subtree are
    already in ``vmap``; anything else (e.g. a ``birth`` time variable left
    dangling by inlining, whose defining op is gone) is cloned fresh on
    first sight — the same fresh-disjoint-object semantics ``deepcopy``
    gave such stragglers."""
    nv = vmap.get(v)
    if nv is None:
        nv = Value(v.type, v.name)
        nv.validity_end = v.validity_end
        vmap[v] = nv
        nv.birth = _clone_time(v.birth, vmap)
    return nv


def _clone_time(t: Optional[Time], vmap: dict) -> Optional[Time]:
    if t is None:
        return None
    return Time(_mapped_value(t.tv, vmap), t.offset)


def _clone_op(op: Operation, vmap: dict) -> Operation:
    """Recursive structural clone.  ``vmap`` maps original Values to their
    clones; SSA dominance guarantees every operand / time variable has been
    cloned by the time it is referenced (region args are created in a first
    pass so intra-region-arg references — e.g. a ForOp's iv born on its own
    time variable — resolve)."""
    c = Operation.__new__(type(op))
    c.opname = op.opname
    c._dead = op._dead
    c.attrs = dict(op.attrs)
    c.loc = op.loc
    c.parent_region = None
    c.start = _clone_time(op.start, vmap)
    c.operands = OperandList(c, [_mapped_value(o, vmap) for o in op.operands])
    c.results = []
    for r in op.results:
        nr = Value(r.type, r.name, defining_op=c)
        nr.validity_end = r.validity_end
        vmap[r] = nr
        c.results.append(nr)
    c.regions = []
    for reg in op.regions:
        nreg = Region.__new__(Region)
        nreg.parent_op = c
        nreg.args = []
        nreg.ops = []
        for a in reg.args:
            na = Value(a.type, a.name)
            na.validity_end = a.validity_end
            vmap[a] = na
            nreg.args.append(na)
        for a, na in zip(reg.args, nreg.args):
            na.birth = _clone_time(a.birth, vmap)
        for inner in reg.ops:
            ic = _clone_op(inner, vmap)
            ic.parent_region = nreg
            nreg.ops.append(ic)
        c.regions.append(nreg)
    # result births last: they may (in principle) reference time variables
    # defined inside the op's own regions
    for r, nr in zip(op.results, c.results):
        nr.birth = _clone_time(r.birth, vmap)
    return c


# --------------------------------------------------------------------------
# Misc IR utilities shared by passes
# --------------------------------------------------------------------------


def const_value(v: Value) -> Optional[Union[int, float]]:
    """The compile-time value of ``v`` if it is defined by hir.constant."""
    if v.defining_op is not None and v.defining_op.opname == "constant":
        return v.defining_op.attrs["value"]
    return None


def _replace_all_uses_in_region(region: Region, old: Value, new: Value) -> int:
    """O(region) region-scoped replacement — retained only as the baseline
    the legacy sweep benchmark measures (and it is scope-limited: uses held
    by sibling scopes are silently missed).  New code wants
    ``old.replace_all_uses_with(new)`` (global, O(#uses))."""
    n = 0
    for op in region.walk():
        for i, o in enumerate(op.operands):
            if o is old:
                op.operands[i] = new
                n += 1
    return n
