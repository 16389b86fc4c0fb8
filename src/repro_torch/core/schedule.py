"""Shared schedule math: the 200 MHz timing model, SDC-style difference
constraint relaxation, the modulo-reservation scheduling engine, and pipeline
balancing (``hir.delay`` insertion).

Two consumers share this module:

  * the HLS baseline (``core.hls.scheduler``) — the paper's Vivado stand-in,
    which must *search* for a schedule starting from erased IR;
  * the schedule-transform passes (``core.passes.schedule_transforms``) —
    which re-schedule already-legal HIR (pipeline-loop / retime) as ordinary
    IR transformations over the cached analyses, the paper's actual pitch.

The engine is built around :class:`SearchState`, which caches everything
about one region that is *independent of the II being probed*: adjacency
lists, per-op latencies, reservation-table bank keys, the classical MII
lower bounds (resMII/recMII) and — crucially — the least fixpoint of the
distance-0 difference constraints.  Carried (distance ≥ 1) constraints only
*tighten* as II shrinks, so that fixpoint is a sound lower bound on the
schedule at every II; each probe seeds its worklist relaxation from it
instead of re-running Bellman–Ford from zero.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional, Sequence

from . import ir
from .analysis import DepEdge, Touch
from .ir import ForOp, FuncOp, MemrefType, Operation, Region, Time, Value

# 200 MHz timing model: 5 ns budget per cycle, combinational delays in ns
CLOCK_NS = 5.0
COMB_DELAY = {
    "add": 2.0, "sub": 2.0, "mult": 4.5, "div": 8.0,
    "and": 0.5, "or": 0.5, "xor": 0.6, "not": 0.3,
    "shl": 0.2, "shr": 0.2,
    "cmp_lt": 1.6, "cmp_le": 1.6, "cmp_eq": 1.2, "cmp_ne": 1.2,
    "cmp_gt": 1.6, "cmp_ge": 1.6,
    "select": 0.9, "trunc": 0.0, "zext": 0.0, "sext": 0.1,
}
MAX_II = 256


def access_bank_key(op: Operation):
    """(port id, distributed-dim bank selector) of a memory access: two
    accesses with different keys use physically distinct ports/banks and
    never conflict in the modulo reservation table."""
    port = op.operands[0] if op.opname == "mem_read" else op.operands[1]
    mt: MemrefType = port.type  # type: ignore[assignment]
    idx = ir.mem_op_indices(op)
    bank = tuple(
        ir.const_value(idx[d]) if ir.const_value(idx[d]) is not None
        else (idx[d].name if idx[d].defining_op is None else "?")
        for d in mt.distributed
    )
    return port.id, bank


def resource_mii(ops: Sequence[Operation]) -> int:
    """resMII: every memref port bank admits one access per cycle, so a loop
    issuing k accesses to the same bank per iteration cannot beat II = k."""
    per_bank: dict[tuple, int] = {}
    for o in ops:
        if o.opname in ("mem_read", "mem_write"):
            k = access_bank_key(o)
            per_bank[k] = per_bank.get(k, 0) + 1
    return max(per_bank.values(), default=1)


def recurrence_mii(ops: Sequence[Operation], edges: Sequence[DepEdge]) -> int:
    """recMII: for every dependence cycle closed by a carried edge,
    II >= ceil(cycle latency / cycle distance).  Distance-0 edges form a DAG
    (program order), so each cycle is one carried edge ``dst -> src`` plus
    the longest distance-0 path ``src .. dst``; we take the max over carried
    edges of ceil((carried latency + longest path) / distance)."""
    carried = [e for e in edges if e.distance]
    if not carried:
        return 1
    index = {o: i for i, o in enumerate(ops)}
    # forward distance-0 adjacency + in-degrees for Kahn topological order
    out0: dict[Operation, list[tuple[Operation, int]]] = {o: [] for o in ops}
    for e in edges:
        if not e.distance and e.src in index and e.dst in index:
            out0[e.src].append((e.dst, e.latency))
    topo = sorted(ops, key=lambda o: index[o])  # program order is topological
    rec = 1
    for ce in carried:
        # longest distance-0 path from the carried edge's *dst* (= the cycle
        # re-entry point) to its *src*, by DP over the program-order DAG
        start = ce.dst
        if start not in index or ce.src not in index:
            continue
        dist: dict[Operation, int] = {start: 0}
        for o in topo:
            if index[o] < index[start]:
                continue
            d = dist.get(o)
            if d is None:
                continue
            for (v, lat) in out0[o]:
                if dist.get(v, -1) < d + lat:
                    dist[v] = d + lat
        path = dist.get(ce.src)
        if path is None:
            continue  # carried edge closes no distance-0 cycle
        cyc_lat = ce.latency + path
        rec = max(rec, -(-cyc_lat // ce.distance))
    return rec


class SearchState:
    """II-independent state for scheduling one region, shared across every
    ``try_modulo_schedule`` probe during the II search:

      * ``out``:      adjacency lists of the dependence edges (src-indexed);
      * ``lat``:      cached ``latency_of`` per op;
      * ``t0``:       least fixpoint of the distance-0 constraints — the seed
                      every probe starts from (carried constraints only add
                      lower bounds on top, so this is sound at any II);
      * ``mem_like``/``bank_key``: reservation-table participants and keys;
      * ``res_mii``:  resource MII (``recurrence_mii`` needs the edges and is
                      exposed as the module-level helper).
    """

    __slots__ = ("ops", "edges", "index", "out", "lat", "horizon", "clock_ns",
                 "t0", "infeasible", "mem_like", "bank_key", "res_mii",
                 "carried_srcs", "occupiers", "touch_storages", "comb")

    def __init__(self, ops: Sequence[Operation], edges: Sequence[DepEdge],
                 latency_of: Callable[[Operation], int],
                 touches_of: Callable[[Operation], list[Touch]],
                 clock_ns: float = CLOCK_NS):
        self.ops = list(ops)
        self.edges = list(edges)
        self.clock_ns = clock_ns
        self.index = {o: i for i, o in enumerate(self.ops)}
        self.lat = {o: latency_of(o) for o in self.ops}
        self.comb = {o: COMB_DELAY.get(o.opname, 0.0) for o in self.ops}
        # horizon scales with total child latency (long-running loop children
        # are legitimately serialized hundreds of cycles apart)
        self.horizon = 4 * sum(max(1, l) for l in self.lat.values()) + 512
        self.out = {o: [] for o in self.ops}
        for e in self.edges:
            if e.src in self.index and e.dst in self.index:
                self.out[e.src].append(e)
        self.carried_srcs = [e.src for e in self.edges
                             if e.distance and e.src in self.index]
        self.mem_like = [o for o in self.ops
                         if o.opname in ("mem_read", "mem_write")]
        self.bank_key = {o: access_bank_key(o) for o in self.mem_like}
        per_bank: dict[tuple, int] = {}
        for o in self.mem_like:
            k = self.bank_key[o]
            per_bank[k] = per_bank.get(k, 0) + 1
        self.res_mii = max(per_bank.values(), default=1)
        # loop/call children and the storages they occupy (sequential-region
        # interval serialization)
        self.occupiers = [o for o in self.ops
                          if isinstance(o, ForOp) or o.opname == "call"]
        self.touch_storages = {o: {tc.storage for tc in touches_of(o)}
                               for o in self.occupiers}
        self.infeasible = False
        self.t0 = self._asap0()

    def _asap0(self) -> dict[Operation, int]:
        """Least fixpoint of the distance-0 constraints via Kahn longest-path
        (program order is topological for distance-0 edges).  Falls back to
        bounded Bellman–Ford if a distance-0 cycle sneaks in (sets
        ``infeasible`` when divergent, matching the old relax() behavior)."""
        t = {o: 0 for o in self.ops}
        ordered = self.ops  # program order; distance-0 edges point forward
        acyclic = all(
            self.index[e.src] < self.index[e.dst]
            for e in self.edges if not e.distance
            if e.src in self.index and e.dst in self.index)
        if acyclic:
            for o in ordered:
                base = t[o]
                for e in self.out[o]:
                    if e.distance:
                        continue
                    lo = base + e.latency
                    if t[e.dst] < lo:
                        t[e.dst] = lo
            if any(v > self.horizon for v in t.values()):
                self.infeasible = True
            return t
        for _ in range(len(self.ops) + 2):  # pragma: no cover - defensive
            changed = False
            for e in self.edges:
                if e.distance:
                    continue
                lo = t[e.src] + e.latency
                if t[e.dst] < lo:
                    t[e.dst] = lo
                    changed = True
                    if lo > self.horizon:
                        self.infeasible = True
                        return t
            if not changed:
                return t
        self.infeasible = True
        return t


def _relax_from(state: SearchState, t: dict[Operation, int], ii: int,
                seeds: Sequence[Operation]) -> bool:
    """Monotone worklist longest-path relaxation: propagate lower-bound
    increases from ``seeds`` until fixpoint.  Equivalent to re-running the
    full Bellman–Ford from the current ``t`` (which is a fixpoint everywhere
    except at the seeds), but only touches the affected cone.  Returns False
    when any bound exceeds the horizon (infeasible at this II)."""
    out = state.out
    horizon = state.horizon
    dq = deque(s for s in seeds if s in out)
    in_dq = set(dq)
    while dq:
        u = dq.popleft()
        in_dq.discard(u)
        tu = t[u]
        for e in out[u]:
            if e.distance and not ii:
                continue  # carried deps inactive outside pipelining
            lo = tu + e.latency - (e.distance * ii if ii else 0)
            if t[e.dst] < lo:
                if lo > horizon:
                    return False
                t[e.dst] = lo
                if e.dst not in in_dq:
                    dq.append(e.dst)
                    in_dq.add(e.dst)
    return True


def try_modulo_schedule(
    ops: list[Operation],
    edges: Sequence[DepEdge],
    ii: int,
    latency_of: Callable[[Operation], int],
    touches_of: Callable[[Operation], list[Touch]],
    state: Optional[SearchState] = None,
) -> Optional[dict[Operation, int]]:
    """Resource-constrained list scheduling at a fixed ``ii`` (0 = no
    pipelining): worklist longest-path relaxation of the dependence
    difference constraints (seeded from the shared distance-0 fixpoint when a
    ``SearchState`` is supplied), operator chaining under the clock budget,
    and a modulo reservation table (one access per congruence class per
    memref port bank).  Returns op -> cycle, or None if infeasible."""
    if state is None:
        state = SearchState(ops, edges, latency_of, touches_of)
    if state.infeasible:
        return None
    horizon = state.horizon
    t = dict(state.t0)
    if ii and state.carried_srcs:
        if not _relax_from(state, t, ii, state.carried_srcs):
            return None

    # operator chaining under the clock budget
    lat = state.lat
    comb = state.comb
    clock_ns = state.clock_ns
    arrival: dict[Operation, float] = {}
    for o in sorted(ops, key=lambda o: t[o]):
        start_ns = 0.0
        for v in o.operands:
            p = v.defining_op
            if p in arrival and t.get(p) == t[o] and lat[p] == 0:
                start_ns = max(start_ns, arrival[p])
        d = comb[o]
        if start_ns + d > clock_ns:
            t[o] += 1
            if not _relax_from(state, t, ii, (o,)):
                return None
            start_ns = 0.0
        arrival[o] = start_ns + d

    # modulo reservation table: one access per congruence class per port
    # *bank* (distinct distributed-dim banks are physically parallel)
    mem_like = state.mem_like
    bank_key = state.bank_key
    if ii and state.res_mii > ii:
        return None  # more same-bank accesses than congruence classes

    index = state.index
    for _sweep in range(16 * len(ops) + 64):
        moved: list[Operation] = []
        # (a) reservation sweep in program order; a conflicting access jumps
        # to the next free congruence class instead of bumping one cycle at
        # a time (each +1 bump used to cost a full relaxation round)
        taken: dict[tuple, set[int]] = {}
        for o in mem_like:
            kk = bank_key[o]
            s = taken.get(kk)
            if s is None:
                s = taken[kk] = set()
            if ii:
                c = t[o]
                cls = c % ii
                if cls in s:
                    c += 1
                    while (c % ii) in s:
                        c += 1
                    if c > horizon:
                        return None
                    t[o] = c
                    moved.append(o)
                    cls = c % ii
                s.add(cls)
            else:
                c = t[o]
                if c in s:
                    c += 1
                    while c in s:
                        c += 1
                    if c > horizon:
                        return None
                    t[o] = c
                    moved.append(o)
                s.add(c)
        # (b) loop/call children occupy their ports for their whole latency:
        # serialize overlapping [t, t+lat) intervals on shared storage (one
        # ordered sweep per storage replaces the old all-pairs scan)
        if not ii and not moved and state.occupiers:
            placed: set[Operation] = set()
            for a in state.occupiers:
                if a in placed:
                    continue
                group = [b for b in state.occupiers
                         if b is a or (state.touch_storages[a]
                                       & state.touch_storages[b])]
                if len(group) < 2:
                    placed.add(a)
                    continue
                group.sort(key=lambda o: (t[o], index[o]))
                end: Optional[int] = None
                for o in group:
                    if end is not None and t[o] < end:
                        if end > horizon:
                            return None
                        t[o] = end
                        moved.append(o)
                    end = t[o] + max(1, lat[o])
                placed.update(group)
        if not moved:
            break
        if not _relax_from(state, t, ii, moved):
            return None
    else:
        return None

    for (u, v, elat, dist) in edges:
        if dist and not ii:
            continue
        if t[v] < t[u] + elat - (dist * ii if ii else 0):
            return None
    return t


def balance_delays(func: FuncOp, am=None) -> int:
    """Pipeline balancing: insert ``hir.delay`` ops so every operand arrives
    exactly at its consumption cycle (the transformation that legalises a
    freshly computed schedule).  Uses the verifier's validity windows
    (windows-only pass — no quadratic legality checks) and inserts every
    violating operand's delay in one batch per sweep; delays never interfere
    with each other's windows, so the sweep converges in a couple of
    iterations instead of one full verification per delay.  ``am`` (an
    AnalysisManager) lets repeated sweeps re-use the cached loop analysis.
    Returns the number of delays inserted."""
    from .verifier import validity_windows

    inserted = 0
    for _ in range(256):
        v = validity_windows(func, am=am)
        # collect every (op, operand index, window) violation in one pass
        to_fix: list[tuple[Operation, int, Value, tuple]] = []
        for op in list(func.body.walk()):
            if op.start is None or op.opname in ("constant", "alloc", "time", "yield", "return"):
                continue
            if isinstance(op, ForOp):
                continue
            for i, val in enumerate(list(op.operands)):
                win = v.windows.get(val)
                if win is None:
                    continue
                tv, off, ln = win
                use_off = op.start.offset
                if tv is op.start.tv and use_off > off and (ln is not None and use_off >= off + ln):
                    to_fix.append((op, i, val, win))
        if not to_fix:
            return inserted
        # batch-splice the delays, rebuilding each touched region once
        by_region: dict[Region, dict[Operation, list[Operation]]] = {}
        for op, i, val, (tv, off, ln) in to_fix:
            d = ir.delay(val, op.start.offset - off, Time(tv, off))
            region = op.parent_region or func.body
            d.parent_region = region
            by_region.setdefault(region, {}).setdefault(op, []).append(d)
            op.operands[i] = d.result
            inserted += 1
        for region, before in by_region.items():
            new_ops: list[Operation] = []
            for op in region.ops:
                new_ops.extend(before.get(op, ()))
                new_ops.append(op)
            region.ops[:] = new_ops
    return inserted
