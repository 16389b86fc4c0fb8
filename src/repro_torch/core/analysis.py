"""Schedule analyses shared by the verifier, the codegen, the HLS baseline
and the schedule-transform passes: initiation intervals, iteration latencies,
loop/function latency bounds, access tables per memref port, memory-touch /
banking analysis, and the dependence graph (SSA + memory edges with
distances).

Each analysis is registered with the ``core.passmgr`` AnalysisManager
(``loop-info``, ``port-accesses``, ``mem-touch``, ``dependence``) so
consumers share one cached computation per function instead of re-deriving
private copies; passes declare which analyses they preserve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

from . import ir
from .ir import ForOp, FuncOp, MemrefType, Operation, Region, Time, Value
from .passmgr import AnalysisManager, FunctionAnalysis, register_analysis


@dataclass
class LoopInfo:
    op: ForOp
    ii: Optional[int]  # constant initiation interval, None if data-dependent
    trip: Optional[int]  # constant trip count, None if dynamic
    body_span: int  # max completion offset of body ops relative to %ti
    total_latency: Optional[int]  # cycles from loop start to %tf, if static

    @property
    def pipelined(self) -> bool:
        return self.ii is not None and self.ii < self.body_span


def op_completion_offset(op: Operation, root: Value, loops: dict[ForOp, "LoopInfo"]) -> Optional[int]:
    """Completion cycle of ``op`` relative to time variable ``root``; None if
    it is not statically tied to ``root``."""
    if op.start is None or op.start.tv is not root:
        return None
    base = op.start.offset
    if op.opname == "mem_read":
        mt = op.operands[0].type
        return base + mt.read_latency()
    if op.opname == "mem_write":
        return base + 1  # writes take one cycle (paper §4.1)
    if op.opname == "delay":
        return base + op.attrs["by"]
    if op.opname == "call":
        ds = op.attrs.get("result_delays", ())
        return base + (max(ds) if ds else 0)
    if op.opname in ("for", "unroll_for"):
        li = loops.get(op)  # type: ignore[arg-type]
        if li is None or li.total_latency is None:
            return None
        return base + li.total_latency
    if op.opname in ir.ARITH_OPS:
        return base + op.attrs.get("stages", 0)
    return base


def span_completion_offset(op: Operation, root: Value,
                           loops: dict[ForOp, "LoopInfo"]) -> Optional[int]:
    """Completion cycle of ``op`` relative to ``root`` as counted into a
    loop's body span: directly scheduled on ``root``, or chained off an inner
    loop's end time whose latency is statically derivable.  None when the
    completion cannot be bounded."""
    c = op_completion_offset(op, root, loops)
    if c is not None:
        return c
    if op.start is not None and isinstance(op.start.tv.defining_op, ForOp):
        fop: ForOp = op.start.tv.defining_op  # type: ignore[assignment]
        li = loops.get(fop)
        if li is not None and li.total_latency is not None \
                and fop.start is not None and fop.start.tv is root:
            c2 = op_completion_offset(op, op.start.tv, loops)
            if c2 is not None:
                return fop.start.offset + li.total_latency + c2
    return None


def analyze_loops(func: FuncOp) -> dict[ForOp, LoopInfo]:
    """Bottom-up loop analysis: II, trip count, body span, total latency."""
    loops: dict[ForOp, LoopInfo] = {}

    def visit_region(region: Region) -> None:
        for op in region.ops:
            for r in op.regions:
                visit_region(r)
            if isinstance(op, ForOp):
                loops[op] = _analyze_loop(op, loops)

    def _analyze_loop(op: ForOp, loops: dict[ForOp, LoopInfo]) -> LoopInfo:
        root = op.time_var
        trip = op.trip_count()
        span = 0
        for inner in op.region(0).ops:
            c = span_completion_offset(inner, root, loops)
            if c is not None:
                span = max(span, c)
        y = op.yield_op()
        ii: Optional[int] = None
        seq_iter_len: Optional[int] = None
        if y is not None and y.start is not None:
            if y.start.tv is root:
                ii = y.start.offset
            else:
                # sequential loop: yield chained off an inner loop's end time
                d = y.start.tv.defining_op
                if isinstance(d, ForOp) and d in loops and d.start is not None and d.start.tv is root:
                    li = loops[d]
                    if li.total_latency is not None:
                        seq_iter_len = d.start.offset + li.total_latency + y.start.offset
        if op.opname == "unroll_for":
            # all iterations replicated in space; ii is the per-iteration time
            # stagger (0 = fully parallel).
            ii = ii if ii is not None else 0
            total = None if trip is None else (trip * ii + span if trip else 0)
            return LoopInfo(op, ii, trip, span, total)
        total: Optional[int] = None
        if trip is not None:
            if ii is not None:
                total = trip * ii
            elif seq_iter_len is not None:
                total = trip * seq_iter_len
        return LoopInfo(op, ii if ii is not None else seq_iter_len, trip, span, total)

    visit_region(func.body)
    return loops


def func_latency(func: FuncOp, loops: Optional[dict[ForOp, LoopInfo]] = None) -> Optional[int]:
    """Static latency (cycles from %t to all effects complete), if derivable."""
    loops = loops if loops is not None else analyze_loops(func)
    root = func.time_var
    worst = 0
    derived_roots: dict[Value, Optional[int]] = {root: 0}

    # two passes to resolve chains of derived time variables
    for _ in range(2):
        for op in func.body.walk():
            if op.opname == "time":
                base = derived_roots.get(op.operands[0])
                if base is not None:
                    derived_roots[op.result] = base + op.attrs.get("offset", 0)
            if isinstance(op, ForOp):
                li = loops[op]
                if op.start is not None and op.start.tv in derived_roots and li.total_latency is not None:
                    b = derived_roots[op.start.tv]
                    if b is not None:
                        derived_roots[op.end_time] = b + op.start.offset + li.total_latency

    for op in func.body.walk():
        if op.start is None:
            continue
        base = derived_roots.get(op.start.tv)
        if base is None:
            # op scheduled relative to a loop-local or unknown time var;
            # loop spans are already accounted for via total_latency.
            continue
        local_root = op.start.tv
        c = op_completion_offset(op, local_root, loops)
        if c is None:
            return None
        # for loops: completion already includes total; body spans beyond II
        if isinstance(op, ForOp):
            li = loops[op]
            if li.total_latency is None:
                return None
            extra = max(0, li.body_span - (li.ii or 0))
            worst = max(worst, base + op.start.offset + li.total_latency + extra)
        else:
            worst = max(worst, base + c)
    return worst


@dataclass
class MemAccess:
    op: Operation
    is_write: bool
    port_value: Value  # the memref SSA value (= the port)
    offsets_mod: Optional[tuple[int, int]]  # (offset mod II, II) within pipelined loop
    offset: Optional[int]  # absolute offset under its root tv
    root: Value


def collect_port_accesses(func: FuncOp, loops: dict[ForOp, LoopInfo]) -> dict[Value, list[MemAccess]]:
    """Group memory accesses by memref port value, annotated with their
    schedule congruence class (offset mod II inside pipelined loops)."""
    out: dict[Value, list[MemAccess]] = {}

    def visit(region: Region, encl: Optional[ForOp]) -> None:
        for op in region.ops:
            if op.opname in ("mem_read", "mem_write"):
                port = op.operands[0] if op.opname == "mem_read" else op.operands[1]
                acc = MemAccess(
                    op,
                    op.opname == "mem_write",
                    port,
                    None,
                    op.start.offset if op.start is not None else None,
                    op.start.tv if op.start is not None else func.time_var,
                )
                if encl is not None and op.start is not None and op.start.tv is encl.time_var:
                    li = loops[encl]
                    if li.ii is not None and li.ii > 0 and li.pipelined:
                        acc.offsets_mod = (op.start.offset % li.ii, li.ii)
                out.setdefault(port, []).append(acc)
            for r in op.regions:
                visit(r, op if isinstance(op, ForOp) else encl)

    visit(func.body, None)
    return out


# --------------------------------------------------------------------------
# Memory-touch / banking analysis (lifted out of the HLS scheduler so the
# scheduler, the unroll-legality check and the schedule-transform passes all
# share one definition of "which storage does this op touch, and how").
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Touch:
    """One storage access (or the summary of a nested region's accesses).

    ``banked_by``   region-arg values (loop IVs, including compile-time
                    ``!hir.const`` unroll IVs) indexing *distributed* dims:
                    distinct IV values select physically distinct banks.
    ``addr_ivs``    region-arg values appearing anywhere in the address —
                    iterations with different IV values touch different
                    addresses.
    ``private_to``  dynamic (non-const) IVs making the access
                    iteration-private (no loop-carried memory dependence).
    ``bank_consts`` literal constant indices of the distributed dims
                    (``None`` where dynamic): two touches with a differing
                    pair address provably distinct banks."""

    storage: object          # alloc op or arg Value
    is_write: bool
    banked_by: frozenset     # IVs appearing in distributed dims
    addr_ivs: frozenset      # IVs appearing anywhere in the address
    private_to: frozenset    # IVs making the access iteration-private
    bank_consts: tuple = ()  # constant distributed-dim indices (None if dyn)

    def distinct_bank(self, other: "Touch") -> bool:
        return any(
            a is not None and b is not None and a != b
            for a, b in zip(self.bank_consts, other.bank_consts)
        )


def storage_of(mem: Value):
    """The physical storage a memref port belongs to: its defining alloc, or
    the argument value itself for interface memrefs."""
    d = mem.defining_op
    return d if d is not None and d.opname == "alloc" else mem


class MemTouches:
    """Per-op memory-touch query with a memo for every op (``ForOp`` touches
    are the union of their bodies').  Registered as the ``mem-touch``
    analysis; also usable standalone on unscheduled IR.  The memo matters:
    the dependence builders query the same ops many times, and recomputing a
    leaf ``Touch`` involves type/banking introspection per call."""

    def __init__(self):
        self._cache: dict[Operation, list[Touch]] = {}

    def of(self, op: Operation) -> list[Touch]:
        cached = self._cache.get(op)
        if cached is not None:
            return cached
        out = self._compute(op)
        self._cache[op] = out
        return out

    def _compute(self, op: Operation) -> list[Touch]:
        if op.opname in ("mem_read", "mem_write"):
            mem = op.operands[0] if op.opname == "mem_read" else op.operands[1]
            mt: MemrefType = mem.type  # type: ignore[assignment]
            idx = ir.mem_op_indices(op)
            region_args = [v for v in idx if v.defining_op is None]
            # every region-arg index in a distributed dim selects a distinct
            # bank per iteration — including compile-time-constant unroll IVs
            # (the seed's dead `and False` clause dropped those, pessimizing
            # legal unroll parallelism to staggered execution)
            banked = frozenset(idx[d] for d in mt.distributed if idx[d].defining_op is None)
            ivs = frozenset(region_args)
            private = frozenset(v for v in region_args if not isinstance(v.type, ir.ConstType))
            bank_consts = tuple(ir.const_value(idx[d]) for d in mt.distributed)
            return [Touch(storage_of(mem), op.opname == "mem_write", banked, ivs,
                          private, bank_consts)]
        if op.opname == "call":
            out = []
            for v in op.operands:
                if isinstance(v.type, MemrefType):
                    out.append(Touch(storage_of(v), True, frozenset(), frozenset(), frozenset()))
            return out
        if isinstance(op, ForOp):
            out = []
            for b in op.region(0).ops:
                out.extend(self.of(b))
            return out
        return []


# --------------------------------------------------------------------------
# Dependence graph: SSA dataflow + memory edges with iteration distances
# (lifted out of the HLS scheduler; shared with the pipeline-loop pass).
# --------------------------------------------------------------------------


class DepEdge(NamedTuple):
    """``dst`` must start at least ``latency`` cycles after ``src`` (minus
    ``distance`` * II when the edge is loop-carried)."""

    src: Operation
    dst: Operation
    latency: int
    distance: int


def _tuples_conflict(a: tuple, b: tuple) -> bool:
    """Inverse of ``Touch.distinct_bank`` on bare bank-const tuples: two
    accesses conflict unless some distributed dim is constant on both sides
    with different values."""
    return not any(x is not None and y is not None and x != y
                   for x, y in zip(a, b))


class _BankGroup:
    """Per (storage, exact bank-const tuple) serialization frontier."""

    __slots__ = ("last_write", "reads")

    def __init__(self):
        self.last_write: Optional[Operation] = None
        self.reads: list[Operation] = []


class _StorageChain:
    """Per-storage chained serialization state: the last non-plain toucher
    (``barrier`` — a loop/call child conflicts with *every* access on the
    storage) plus one :class:`_BankGroup` per exact bank-const tuple.  Fully
    constant tuples conflict only with equal tuples (dict hit); tuples with
    dynamic dims (``dyn``) must be checked pairwise."""

    __slots__ = ("barrier", "groups", "dyn")

    def __init__(self):
        self.barrier: Optional[Operation] = None
        self.groups: dict[tuple, _BankGroup] = {}
        self.dyn: list[tuple] = []

    def conflicting(self, key: tuple) -> list[_BankGroup]:
        out = []
        if None in key:
            for k, g in self.groups.items():
                if _tuples_conflict(key, k):
                    out.append(g)
            return out
        g = self.groups.get(key)
        if g is not None:
            out.append(g)
        for k in self.dyn:
            if _tuples_conflict(key, k):
                out.append(self.groups[k])
        return out

    def group(self, key: tuple) -> _BankGroup:
        g = self.groups.get(key)
        if g is None:
            g = self.groups[key] = _BankGroup()
            if None in key:
                self.dyn.append(key)
        return g


def _chained_memory_edges(
    ops: list[Operation],
    touches_of: Callable[[Operation], list[Touch]],
    latency_of: Callable[[Operation], int],
    edges: list[DepEdge],
) -> None:
    """Memory serialization edges for a non-pipelined region, transitively
    reduced: instead of the all-pairs scan (every later access vs every
    earlier conflicting access), each access depends only on the current
    *frontier* of its storage — the reads since the last conflicting write,
    the last write itself, and the last non-plain (loop/call) toucher.  Every
    dropped all-pairs edge is implied by a frontier chain with total latency
    at least as large (latencies are non-negative), so the least fixpoint of
    the difference constraints — and therefore the schedule — is identical;
    the edge count drops from quadratic to near-linear in the region size.
    """
    state: dict[object, _StorageChain] = {}
    for o in ops:
        to = touches_of(o)
        if not to:
            continue
        if o.opname in ("mem_read", "mem_write"):
            tch = to[0]
            s = state.get(tch.storage)
            if s is None:
                s = state[tch.storage] = _StorageChain()
            targets: list[Operation] = []
            if s.barrier is not None:
                targets.append(s.barrier)
            key = tch.bank_consts
            if tch.is_write:
                for g in s.conflicting(key):
                    if g.reads:
                        targets.extend(g.reads)
                    elif g.last_write is not None:
                        targets.append(g.last_write)
                g = s.group(key)
                g.last_write = o
                g.reads.clear()
            else:
                for g in s.conflicting(key):
                    if g.last_write is not None:
                        targets.append(g.last_write)
                s.group(key).reads.append(o)
            for p in targets:
                edges.append(DepEdge(p, o, latency_of(p), 0))
        else:
            # loop/call child: conflicts with everything on every storage it
            # touches — collect each storage's frontier, then become its
            # barrier
            for storage in {tc.storage for tc in to}:
                s = state.get(storage)
                if s is None:
                    s = state[storage] = _StorageChain()
                targets = []
                if s.barrier is not None:
                    targets.append(s.barrier)
                for g in s.groups.values():
                    if g.reads:
                        targets.extend(g.reads)
                    elif g.last_write is not None:
                        targets.append(g.last_write)
                s.groups.clear()
                s.dyn.clear()
                s.barrier = o
                for p in targets:
                    edges.append(DepEdge(p, o, latency_of(p), 0))


def build_dependence_edges(
    ops: list[Operation],
    touches_of: Callable[[Operation], list[Touch]],
    latency_of: Callable[[Operation], int],
    loop: Optional[ForOp] = None,
    carried: bool = False,
) -> list[DepEdge]:
    """Dependence edges among the ops of one region, in program order:

      * SSA edges (producer -> consumer, weighted by the producer latency),
        including uses held by ops nested inside a consumer's regions;
      * memory edges per shared storage — conservative serialization, with
        read-read pairs and provably-distinct banks exempt; non-pipelined
        regions use the transitively-reduced frontier chains
        (``_chained_memory_edges``, same least fixpoint, near-linear size);
      * distance-1 carried edges for non-iteration-private accesses and for
        loop/call children that reoccupy their resources (``carried=True``;
        pipelining candidates are innermost loops, small enough for the
        exact all-pairs scan the carried analysis needs).
    """
    edges: list[DepEdge] = []
    producer: dict[Value, Operation] = {}
    for o in ops:
        for r in o.results:
            producer[r] = o

    def ssa_deps(o: Operation):
        for v in o.operands:
            if v in producer:
                edges.append(DepEdge(producer[v], o, latency_of(producer[v]), 0))
        if isinstance(o, ForOp):
            for b in o.region(0).walk():
                for v in b.operands:
                    if v in producer and producer[v] is not o:
                        edges.append(DepEdge(producer[v], o, latency_of(producer[v]), 0))

    if not carried:
        for o in ops:
            ssa_deps(o)
        _chained_memory_edges(ops, touches_of, latency_of, edges)
        return edges

    seen: list[Operation] = []
    for o in ops:
        ssa_deps(o)
        to = touches_of(o)
        if to:
            for prev in seen:
                tp = touches_of(prev)
                for a in tp:
                    for b in to:
                        if a.storage is not b.storage:
                            continue
                        plain = (o.opname in ("mem_read", "mem_write")
                                 and prev.opname in ("mem_read", "mem_write"))
                        if plain and not a.is_write and not b.is_write:
                            continue  # same-region read-read: MRT handles
                        if plain and a.distinct_bank(b):
                            continue  # physically parallel banks
                        edges.append(DepEdge(prev, o, latency_of(prev), 0))
                        if carried and plain and loop is not None:
                            private = (loop.iv in a.private_to and loop.iv in b.private_to)
                            if not private:
                                edges.append(DepEdge(o, prev, latency_of(o), 1))
                        break
                    else:
                        continue
                    break
            seen.append(o)
        # sequential outer loops: a loop child reoccupies its resources
        if carried and isinstance(o, ForOp):
            edges.append(DepEdge(o, o, latency_of(o), 1))
        if carried and o.opname == "call":
            edges.append(DepEdge(o, o, 1, 1))
    return edges


def scheduled_op_latency(op: Operation, loops: dict[ForOp, LoopInfo]) -> int:
    """Result latency of ``op`` under the standard timing model (RAM reads 1,
    writes 1, delays their depth, calls their declared delay, loops their
    statically-derived total latency)."""
    if op.opname == "mem_read":
        return op.operands[0].type.read_latency()
    if op.opname == "mem_write":
        return 1
    if op.opname == "delay":
        return op.attrs["by"]
    if op.opname == "call":
        ds = op.attrs.get("result_delays", ())
        return max(ds) if ds else 0
    if isinstance(op, ForOp):
        li = loops.get(op)
        return li.total_latency if li is not None and li.total_latency is not None else 1
    if op.opname in ir.ARITH_OPS:
        return op.attrs.get("stages", 0)
    return 0


@dataclass
class DependenceInfo:
    """Per-region dependence edges for the whole function; regions are keyed
    by their owning op (the ``FuncOp`` for the body).  Innermost loop bodies
    carry distance-1 edges (the pipelining candidates)."""

    edges: dict[Operation, list[DepEdge]]
    touches: MemTouches

    def for_loop(self, loop: ForOp) -> list[DepEdge]:
        return self.edges.get(loop, [])


# --------------------------------------------------------------------------
# Registered analyses
# --------------------------------------------------------------------------


@register_analysis
class LoopAnalysis(FunctionAnalysis):
    """``analyze_loops``: II / trip / body span / total latency per loop."""

    name = "loop-info"

    @staticmethod
    def run(func: FuncOp, am: AnalysisManager) -> dict[ForOp, LoopInfo]:
        return analyze_loops(func)


@register_analysis
class PortAccessAnalysis(FunctionAnalysis):
    """``collect_port_accesses`` keyed on the cached loop analysis."""

    name = "port-accesses"

    @staticmethod
    def run(func: FuncOp, am: AnalysisManager) -> dict[Value, list[MemAccess]]:
        return collect_port_accesses(func, am.get(LoopAnalysis, func))


@register_analysis
class MemTouchAnalysis(FunctionAnalysis):
    """Lazy memory-touch/banking table (see ``MemTouches``)."""

    name = "mem-touch"

    @staticmethod
    def run(func: FuncOp, am: AnalysisManager) -> MemTouches:
        return MemTouches()


@register_analysis
class DependenceAnalysis(FunctionAnalysis):
    """Dependence edges for every region of the function, with carried
    (distance-1) edges in innermost loop bodies."""

    name = "dependence"

    @staticmethod
    def run(func: FuncOp, am: AnalysisManager) -> DependenceInfo:
        touches = am.get(MemTouchAnalysis, func)
        loops = am.get(LoopAnalysis, func)

        def latency_of(op: Operation) -> int:
            return scheduled_op_latency(op, loops)

        edges: dict[Operation, list[DepEdge]] = {}

        def visit(owner: Operation, region: Region) -> None:
            loop = owner if isinstance(owner, ForOp) else None
            inner = [o for o in region.ops
                     if o.opname not in ("constant", "alloc", "yield", "return", "time")]
            innermost = loop is not None and not any(isinstance(o, ForOp) for o in inner)
            edges[owner] = build_dependence_edges(
                inner, touches.of, latency_of, loop, carried=innermost)
            for o in region.ops:
                for r in o.regions:
                    visit(o, r)

        visit(func, func.body)
        return DependenceInfo(edges, touches)


# ---------------------------------------------------------------------------
# Activation intervals (RTL-level pulse schedules)
# ---------------------------------------------------------------------------

#: Lattice top: "may be nonzero at any cycle" (unknown pulse schedule).
PULSES_TOP = None

#: Finite pulse sets larger than this collapse to ``PULSES_TOP`` so the
#: fixpoint stays bounded on pathological schedules.
PULSE_SET_CAP = 4096


def _pulse_join(a, b):
    """Join of two pulse sets (``frozenset`` of cycle offsets, or TOP)."""
    if a is PULSES_TOP or b is PULSES_TOP:
        return PULSES_TOP
    u = a | b
    return PULSES_TOP if len(u) > PULSE_SET_CAP else u


def _pulse_shift(s, d):
    if s is PULSES_TOP:
        return PULSES_TOP
    return frozenset(t + d for t in s)


_EMPTY_PULSES = frozenset()


@dataclass
class ActivationIntervals:
    """Result of the ``activation-intervals`` analysis over one RTL module.

    ``pulses[net]`` is the *sound superset* of cycle offsets — relative to
    the module's ``t_start`` pulse — at which ``net`` can be nonzero, or
    ``PULSES_TOP`` (``None``) when unknown.  Only single-bit pulse networks
    get finite sets (activation pulses derived from ``t_start`` through
    ``ShiftReg`` delay taps, ``LoopController`` iteration pulses with
    constant bounds, and the boolean algebra over them); datapath nets are
    TOP.  ``rtl-share-instances`` proves two instances may share one body by
    showing their ``t_start`` pulse sets are finite and disjoint."""

    pulses: "dict[str, Optional[frozenset]]" = field(default_factory=dict)

    def of_net(self, name: str):
        return self.pulses.get(name, PULSES_TOP)

    def of_expr(self, e):
        """Pulse set of an arbitrary RTL expression under this solution."""
        return _pulses_of_expr(e, self.pulses)


#: expr operators through which a pulse on either operand propagates
#: (output can only be nonzero when some operand is)
_PULSE_UNION_OPS = frozenset({"|", "||", "^", "+", "-"})
#: operators whose output is zero whenever *either* operand is zero
_PULSE_MEET_OPS = frozenset({"&", "&&", "*"})


def _pulses_of_expr(e, env):
    """Evaluate the pulse set of expression ``e`` under net solution ``env``
    (missing nets are TOP — reads of undriven nets stay unknown).  Iterative
    post-order so ~256-deep bus-mux chains don't recurse."""
    from .codegen import rtl

    memo: dict[int, object] = {}
    stack = [e]
    while stack:
        cur = stack[-1]
        if id(cur) in memo:
            stack.pop()
            continue
        if isinstance(cur, rtl.Const):
            memo[id(cur)] = _EMPTY_PULSES if cur.value == 0 else PULSES_TOP
            stack.pop()
            continue
        if isinstance(cur, rtl.Ref):
            memo[id(cur)] = env.get(cur.name, PULSES_TOP)
            stack.pop()
            continue
        kids = cur._children()
        pending = [c for c in kids if id(c) not in memo]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        if isinstance(cur, rtl.Binop):
            a, b = memo[id(cur.a)], memo[id(cur.b)]
            if cur.op in _PULSE_UNION_OPS:
                r = _pulse_join(a, b)
            elif cur.op in _PULSE_MEET_OPS:
                if a == _EMPTY_PULSES or b == _EMPTY_PULSES:
                    r = _EMPTY_PULSES
                elif a is PULSES_TOP:
                    r = b
                elif b is PULSES_TOP:
                    r = a
                else:
                    r = a & b
            elif cur.op in ("<<", ">>", ">>>"):
                # a shifted by zero/any amount is zero iff a is zero
                r = memo[id(cur.a)]
            else:  # comparisons etc. can be nonzero when operands are zero
                r = PULSES_TOP
        elif isinstance(cur, rtl.Mux):
            # cond only *selects*; output nonzero => a or b nonzero
            r = _pulse_join(memo[id(cur.a)], memo[id(cur.b)])
        elif isinstance(cur, (rtl.Signed, rtl.Repeat)):
            r = memo[id(cur.a)]
        elif isinstance(cur, rtl.Unop):
            r = memo[id(cur.a)] if cur.op == "-" else PULSES_TOP
        else:
            r = PULSES_TOP
        memo[id(cur)] = r
    return memo[id(e)]


def _controller_pulses(it, env):
    """(iter_pulses, endp_pulses) for one ``LoopController`` under ``env``.

    For a pipelined controller started at cycle ``s`` with constant bounds,
    the iteration pulse fires at ``{s + m*ii : 0 <= m < trip}`` with
    ``trip = max(1, ceil((ub-lb)/step))`` and the completion pulse at
    ``s + trip*ii + 1`` (registered).  Sequential controllers advance on the
    inner loop's completion pulse instead.  Everything non-constant is TOP."""
    from .codegen import rtl

    start = _pulses_of_expr(it.start, env)
    if it.ii is None:  # sequential: advances on inner_end
        inner = (_pulses_of_expr(it.inner_end, env)
                 if it.inner_end is not None else PULSES_TOP)
        return _pulse_join(start, inner), _pulse_shift(inner, 1)
    if start is PULSES_TOP:
        return PULSES_TOP, PULSES_TOP
    consts = []
    for b in (it.lb, it.ub, it.step):
        if not isinstance(b, rtl.Const) or not isinstance(b.value, int):
            return PULSES_TOP, PULSES_TOP
        consts.append(b.value)
    lb, ub, step = consts
    if step <= 0 or ub > (1 << it.ivw):  # iv wrap would extend the trip
        return PULSES_TOP, PULSES_TOP
    trip = max(1, -((lb - ub) // step)) if ub > lb else 1
    if trip * max(1, len(start)) > PULSE_SET_CAP:
        return PULSES_TOP, PULSES_TOP
    iters = frozenset(s + m * it.ii for s in start for m in range(trip))
    endp = frozenset(s + trip * it.ii + 1 for s in start)
    return iters, endp


@register_analysis
class ActivationIntervalsAnalysis(FunctionAnalysis):
    """Per-net activation pulse schedules of one ``RTLModule`` (keyed on the
    module object, like ``net-fanout``).  Worklist fixpoint from bottom
    (``frozenset()``); every transfer is monotone w.r.t. the
    join-semilattice ``∅ ⊑ finite ⊑ TOP``, and finite sets are capped, so
    the fixpoint terminates.  Nets driven by data-dependent state
    (registers, memories, instance results, loop induction variables) are
    TOP; the interesting finite sets are the ``t_start``-derived pulse
    networks the lowering builds for operand/result timing."""

    name = "activation-intervals"

    @staticmethod
    def run(func, am: AnalysisManager) -> ActivationIntervals:
        from .codegen import rtl

        m = func  # an RTLModule
        env: dict[str, object] = {}
        readers: dict[str, list] = {}
        for it in m.items:
            for r in it.reads():
                readers.setdefault(r, []).append(it)
        for p in m.ports:
            if p.dir == "input":
                env[p.name] = _EMPTY_PULSES if p.name == "t_start" else PULSES_TOP
        # nets written by clocked/data items are TOP from the start; pulse
        # networks (CombAssign / 1-bit reset_zero ShiftReg / controller
        # iter+endp) start at bottom and grow monotonically
        pulse_driven: set = set()
        for it in m.items:
            if isinstance(it, rtl.CombAssign):
                pulse_driven.add(it.dest)
            elif isinstance(it, rtl.ShiftReg):
                if it.width == 1 and it.reset_zero:
                    pulse_driven.add(it.dest)
                else:
                    env[it.dest] = PULSES_TOP
            elif isinstance(it, rtl.LoopController):
                pulse_driven.add(it.iter_net)
                if it.endp:
                    pulse_driven.add(it.endp)
                for n in (it.iv, it.active, it.iicnt):
                    if n:
                        env[n] = PULSES_TOP
            else:
                for w in it.writes():
                    env[w] = PULSES_TOP
        # t_start seeds the input-port entry {0}; multi-driven pulse nets
        # join all driver contributions (env entries above win as TOP)
        if "t_start" in env and env["t_start"] is not PULSES_TOP:
            env["t_start"] = frozenset((0,))
        for n in pulse_driven:
            env.setdefault(n, _EMPTY_PULSES)

        def contribution(it):
            if isinstance(it, rtl.CombAssign):
                return ((it.dest, _pulses_of_expr(it.expr, env)),)
            if isinstance(it, rtl.ShiftReg):
                return ((it.dest, _pulse_shift(_pulses_of_expr(it.src, env),
                                               it.depth)),)
            if isinstance(it, rtl.LoopController):
                iters, endp = _controller_pulses(it, env)
                out = [(it.iter_net, iters)]
                if it.endp:
                    out.append((it.endp, endp))
                return out
            return ()

        work = list(m.items)
        seen = set(map(id, work))
        while work:
            it = work.pop()
            seen.discard(id(it))
            for dest, val in contribution(it):
                if dest not in pulse_driven:
                    continue  # also written by a TOP item: stays TOP
                old = env.get(dest, _EMPTY_PULSES)
                new = _pulse_join(old, val)
                if new != old:
                    env[dest] = new
                    for rd in readers.get(dest, ()):
                        if id(rd) not in seen:
                            seen.add(id(rd))
                            work.append(rd)
        return ActivationIntervals(pulses=env)
