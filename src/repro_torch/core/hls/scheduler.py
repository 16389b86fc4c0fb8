"""HLS-style automatic scheduler — the in-repo stand-in for the paper's
Vivado HLS comparison point (Tables 5 and 6).

Given *unscheduled* HIR (see ``eraser``), this pipeline performs what a
high-level synthesis compiler performs between its IR and RTL:

  1. dependence analysis — the shared ``core.analysis`` edge builder: SSA
     dataflow edges with operation latencies; memory dependence edges per
     tensor (conservative serialization of scopes that share storage,
     distance-1 carried dependences for data-dependent addresses, none for
     iteration-private affine accesses);
  2. operator chaining under a 200 MHz timing model (combinational delays
     accumulate along same-cycle chains up to the clock budget; the clock is
     a :class:`SchedulerOptions` knob so the DSE can trade latency for FF);
  3. modulo scheduling of innermost loops with the shared ``core.schedule``
     engine.  The II search starts at the classical lower bound
     MII = max(resMII, recMII) — resMII from the per-bank access counts,
     recMII from the carried dependence cycles — and probes by galloping +
     binary search between the bound and the first feasible II instead of a
     linear scan from 1 (``SchedulerOptions.linear_scan`` restores the
     reference scan; both produce byte-identical schedules).  Outer loops
     run sequentially (II = iteration latency), Vivado-style;
     ``pipeline_loops=False`` disables the modulo search and emits a fully
     sequential schedule — the input the ``pipeline-loop`` transform pass
     starts from;
  4. unroll-parallelism legality — an ``unroll_for``'s iterations run fully
     parallel (stagger 0) only if every touched storage is either banked by
     the unroll IV (distributed-dim index, including compile-time-constant
     IVs) or broadcast (address independent of the IV); otherwise iterations
     are staggered by the body span;
  5. SDC-style refinement — difference constraints relaxed to fixpoint
     (worklist longest-path over the shared ``SearchState``, seeded from the
     II-independent distance-0 fixpoint instead of from zero);
  6. pipeline balancing — ``hir.delay`` ops inserted so every operand arrives
     exactly at its consumption cycle (shared ``core.schedule.balance_delays``);
  7. emission — yields/iter offsets written back; the result is ordinary
     scheduled HIR consumed by the standard verifier + Verilog backend.

Steps 1–5 are the *search* that HIR's explicit schedules make unnecessary —
the codegen-time gap measured in the Table 6 benchmark is the cost of this
search (no artificial sleeps).

``hls_schedule``/``hls_compile`` additionally memoize whole-function search
results keyed by a structural fingerprint of the unscheduled function (see
``core.hls.dse``), with ``AnalysisManager``-style hit/miss counters on the
returned :class:`HLSResult`."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from .. import ir
from ..analysis import (MemTouches, analyze_loops, build_dependence_edges,
                        op_completion_offset)
from ..ir import ForOp, FuncOp, Module, Operation, Region, Time, Value
from ..schedule import (CLOCK_NS, MAX_II, SearchState, balance_delays,
                        recurrence_mii, try_modulo_schedule)


@dataclass(frozen=True)
class SchedulerOptions:
    """Knobs of one scheduling run — also the per-candidate axes the design
    space explorer (``core.hls.dse``) sweeps.

    ``pipeline_loops``   modulo-pipeline innermost loops (False = fully
                         sequential schedule, the ``pipeline-loop`` pass
                         input);
    ``min_ii``           lower bound imposed on every pipelined loop's II on
                         top of the computed MII (throttling a loop trades
                         latency for ports/banking pressure);
    ``clock_ns``         clock budget for operator chaining — a faster clock
                         breaks chains into more pipeline stages (FF) but
                         shrinks the cycle time;
    ``unroll_parallel``  allow stagger-0 unrolled iterations when banking
                         proves them legal (False = always stagger);
    ``linear_scan``      probe II = MII, MII+1, ... linearly instead of
                         galloping + binary search (reference mode; both
                         find the minimal feasible II of the monotone probe
                         and produce byte-identical schedules)."""

    pipeline_loops: bool = True
    min_ii: int = 1
    clock_ns: float = CLOCK_NS
    unroll_parallel: bool = True
    linear_scan: bool = False

    def __post_init__(self):
        if self.clock_ns <= 0:
            raise ValueError(f"clock_ns must be positive, got {self.clock_ns}")
        if self.min_ii < 1:
            raise ValueError(f"min_ii must be >= 1, got {self.min_ii}")

    def key(self) -> tuple:
        """Hashable identity used in search-cache fingerprints."""
        return (self.pipeline_loops, self.min_ii, round(self.clock_ns, 6),
                self.unroll_parallel, self.linear_scan)


@dataclass
class HLSResult:
    module: Module
    iis: dict[str, int] = field(default_factory=dict)
    search_iters: int = 0
    sched_ops: int = 0
    delays_inserted: int = 0
    # MII lower bound and the actual II probe sequence per pipelined loop IV
    miis: dict[str, int] = field(default_factory=dict)
    ii_probes: dict[str, list[int]] = field(default_factory=dict)
    # body span (end cycle) per scheduled function — the entry's span is the
    # design latency in cycles, which the DSE halving rung scores against
    func_spans: dict[str, int] = field(default_factory=dict)
    # search-cache statistics (AnalysisManager-style): functions whose
    # schedule came from the fingerprint cache vs freshly searched
    search_cache_hits: int = 0
    search_cache_misses: int = 0
    # True when the whole compile was served from the compile-level cache
    from_cache: bool = False
    # the PassManager that optimized the scheduled module (hls_compile only);
    # read .stats_dict() for per-pass timing/rewrite statistics
    pass_manager: Optional[object] = None

    def search_cache_stats(self) -> dict:
        return {"hits": self.search_cache_hits,
                "misses": self.search_cache_misses,
                "from_cache": self.from_cache}


class HLSScheduler:
    def __init__(self, module: Module, pipeline_loops: bool = True,
                 options: Optional[SchedulerOptions] = None):
        self.module = module
        self.opts = (options if options is not None
                     else SchedulerOptions(pipeline_loops=pipeline_loops))
        self.result = HLSResult(module)
        self.loop_latency: dict[ForOp, int] = {}
        self.touches = MemTouches()

    @property
    def pipeline_loops(self) -> bool:  # back-compat accessor
        return self.opts.pipeline_loops

    # ------------------------------------------------------------------
    def run(self) -> HLSResult:
        funcs = [f for f in self.module.funcs.values()
                 if not f.attrs.get("external")]
        for f in _callee_first(funcs):
            sync_call_delays(self.module, f)
            self.schedule_func(f)
        return self.result

    def schedule_func(self, f: FuncOp) -> HLSResult:
        """Schedule one function in place (search + pipeline balancing +
        result-delay reconciliation)."""
        span, _ = self._schedule_region(f, f.body, f.time_var, None)
        self.result.func_spans[f.name] = span
        self.result.delays_inserted += balance_delays(f)
        self.result.delays_inserted += reconcile_result_delays(self.module, f)
        return self.result

    def _latency(self, op: Operation) -> int:
        if op.opname == "mem_read":
            return op.operands[0].type.read_latency()
        if op.opname == "mem_write":
            return 1
        if op.opname == "call":
            ds = op.attrs.get("result_delays", ())
            return max(ds) if ds else 0
        if isinstance(op, ForOp):
            return self.loop_latency.get(op, 1)
        if op.opname in ir.ARITH_OPS:
            return op.attrs.get("stages", 0)
        return 0

    # -- II search ------------------------------------------------------
    def _search_ii(self, f: FuncOp, ops, edges, state: SearchState,
                   mii: int) -> tuple[int, dict, list[int]]:
        """Find the minimal feasible II >= mii.  Feasibility of the list-
        scheduling probe is monotone in II on everything we generate (more
        congruence classes and looser carried bounds never hurt), so instead
        of the linear scan we gallop upward from the MII bound (+1, +2, +4,
        ...) to bracket the first feasible II, then binary-search the
        bracket.  ``linear_scan`` keeps the reference scan for A/B tests —
        the probe count changes, the resulting schedule does not."""
        probes: list[int] = []

        def probe(ii: int):
            self.result.search_iters += 1
            probes.append(ii)
            return try_modulo_schedule(ops, edges, ii, self._latency,
                                       self.touches.of, state=state)

        if self.opts.linear_scan:
            ii = mii
            while True:
                got = probe(ii)
                if got is not None:
                    return ii, got, probes
                ii += 1
                if ii > MAX_II:
                    raise RuntimeError(
                        f"HLS: no feasible II <= {MAX_II} for loop in @{f.name}")

        got = probe(mii)
        if got is not None:
            return mii, got, probes
        # gallop: bracket the first feasible II in (last_bad, hi]
        last_bad, step = mii, 1
        while True:
            cand = min(last_bad + step, MAX_II)
            got = probe(cand)
            if got is not None:
                hi, t_hi = cand, got
                break
            last_bad = cand
            if cand >= MAX_II:
                raise RuntimeError(
                    f"HLS: no feasible II <= {MAX_II} for loop in @{f.name}")
            step *= 2
        # binary search the bracket for the minimal feasible II
        while hi - last_bad > 1:
            mid = (hi + last_bad) // 2
            got = probe(mid)
            if got is not None:
                hi, t_hi = mid, got
            else:
                last_bad = mid
        return hi, t_hi, probes

    # -- region scheduling ----------------------------------------------------
    def _schedule_region(self, f: FuncOp, region: Region, root: Value,
                         loop: Optional[ForOp]) -> tuple[int, int]:
        """Returns (span, ii_or_stagger)."""
        # bottom-up: nested loops first
        has_loop_child = False
        for op in region.ops:
            if isinstance(op, ForOp):
                has_loop_child = True
                span_c, ii_c = self._schedule_region(f, op.region(0), op.time_var, op)
                trip = op.trip_count() or 1
                if op.opname == "unroll_for":
                    self.loop_latency[op] = trip * ii_c + (span_c if ii_c == 0 else max(0, span_c - ii_c))
                else:
                    self.loop_latency[op] = trip * ii_c + max(0, span_c - ii_c)

        ops = [o for o in region.ops
               if o.opname not in ("constant", "alloc", "yield", "return", "time")]

        pipeline = (self.opts.pipeline_loops and loop is not None
                    and loop.opname == "for" and not has_loop_child)
        edges = build_dependence_edges(ops, self.touches.of, self._latency,
                                       loop, carried=pipeline)
        state = SearchState(ops, edges, self._latency, self.touches.of,
                            clock_ns=self.opts.clock_ns)

        if pipeline:
            mii = max(1, self.opts.min_ii, state.res_mii,
                      recurrence_mii(ops, edges))
            ii, t, probes = self._search_ii(f, ops, edges, state, mii)
            if loop is not None:
                self.result.miis[loop.iv.name] = mii
                self.result.ii_probes[loop.iv.name] = probes
        else:
            # sequential region: ii = 0 (carried edges inactive); escalate
            # linearly on the (rare) horizon failure, as the seed did
            ii = 0
            while True:
                self.result.search_iters += 1
                t = try_modulo_schedule(ops, edges, ii, self._latency,
                                        self.touches.of, state=state)
                if t is not None:
                    break
                ii += 1
                if ii > MAX_II:
                    raise RuntimeError(
                        f"HLS: no feasible II <= {MAX_II} for loop in @{f.name}")
        self.result.sched_ops += len(t)

        span = max((t[o] + self._latency(o) for o in ops), default=0)

        # write back starts
        for op, cyc in t.items():
            op.start = Time(root, cyc)
            for r in op.results:
                if ir.is_primitive(r.type):
                    r.birth = Time(root, cyc + self._latency(op))

        # yields / II
        if loop is None:
            return span, 0
        y = next((o for o in region.ops if o.opname == "yield"), None)
        if loop.opname == "unroll_for":
            stagger = self._unroll_stagger(loop, ops, span)
            ytime = Time(root, stagger)
            ii_out = stagger
        else:
            ii_final = ii if pipeline else span
            ii_final = max(1, ii_final)
            ytime = Time(root, ii_final)
            ii_out = ii_final
            self.result.iis[loop.iv.name] = ii_final
        if y is None:
            region.add(ir.yield_op(ytime))
        else:
            y.start = ytime
        return span, ii_out

    def _unroll_stagger(self, loop: ForOp, ops: list[Operation], span: int) -> int:
        """Iterations run in parallel only if every storage touch is banked by
        the unroll IV or broadcast (IV-independent address).  Touches of
        nested loops and calls are their bodies' summaries (``MemTouches``),
        so the same two tests decide them — the seed duplicated both tests in
        an unreachable ``isinstance(o, ForOp)`` branch after already
        ``continue``-ing on them."""
        if not self.opts.unroll_parallel:
            return max(1, span)
        for o in ops:
            for tch in self.touches.of(o):
                if loop.iv in tch.banked_by:
                    continue  # distinct banks per iteration
                if loop.iv not in tch.addr_ivs and not tch.is_write:
                    continue  # broadcast read: same address every iteration
                return max(1, span)
        return 0


def _callee_first(funcs: list[FuncOp]) -> list[FuncOp]:
    """Topological order over the intra-module call graph (callees before
    callers), so every caller is scheduled against its callees' *final*
    declared result delays.  Cycles (recursion) fall back to input order."""
    names = {f.name for f in funcs}
    by_name = {f.name: f for f in funcs}
    callees = {
        f.name: sorted({op.attrs["callee"] for op in f.body.walk()
                        if op.opname == "call"
                        and op.attrs.get("callee") in names})
        for f in funcs}
    order: list[FuncOp] = []
    done: set[str] = set()

    def visit(name: str, path: frozenset) -> None:
        if name in done or name in path:
            return
        for c in callees[name]:
            visit(c, path | {name})
        done.add(name)
        order.append(by_name[name])

    for f in funcs:
        visit(f.name, frozenset())
    return order


def sync_call_delays(module: Module, f: FuncOp,
                     only_callee: Optional[str] = None) -> int:
    """Refresh ``call`` ops in ``f`` whose callee's declared ``result_delays``
    changed after the call was built (a reschedule may legitimately bump
    them — see :func:`reconcile_result_delays`).  Scheduled calls also get
    their result birth times moved to the new delays.  Returns the number
    of call sites updated."""
    n = 0
    for op in f.body.walk():
        if op.opname != "call":
            continue
        name = op.attrs.get("callee")
        if only_callee is not None and name != only_callee:
            continue
        callee = module.funcs.get(name)
        if callee is None:
            continue
        ds = tuple(callee.attrs.get("result_delays", ()))
        if ds and tuple(op.attrs.get("result_delays", ())) != ds:
            op.attrs["result_delays"] = ds
            if op.start is not None:
                for r, d in zip(op.results, ds):
                    r.birth = op.start + d
            n += 1
    return n


def reconcile_result_delays(module: Module, f: FuncOp) -> int:
    """Make a freshly scheduled function honour its declared result delays.

    A signature's ``result_delays`` are a hardware interface contract:
    every call site latches each result exactly ``delay`` cycles after
    issuing the call.  The schedule search places the body for latency
    alone, so a returned value can complete *earlier* than declared (the
    emitted design would stream data ahead of the caller's latch — splice
    a trailing ``hir.delay`` holding it to the contract) or *later* (the
    declaration is unachievable at this clock — bump it and refresh every
    call site in the module; callers scheduled afterwards consume the new
    delay).  Returns the number of delays inserted."""
    declared = list(f.attrs.get("result_delays", ()))
    if not declared:
        return 0
    ret = next((op for op in f.body.ops if op.opname == "return"), None)
    if ret is None or not ret.operands:
        return 0
    loops = analyze_loops(f)
    inserted, bumped = 0, False
    splice: list[Operation] = []
    for i, val in enumerate(list(ret.operands)):
        if i >= len(declared):
            break
        dop = val.defining_op
        ach = (None if dop is None
               else op_completion_offset(dop, f.time_var, loops))
        if ach is None:
            continue
        if ach < declared[i]:
            d = ir.delay(val, declared[i] - ach, Time(f.time_var, ach))
            d.parent_region = f.body
            splice.append(d)
            ret.operands[i] = d.result
            inserted += 1
        elif ach > declared[i]:
            declared[i] = ach
            bumped = True
    if splice:
        pos = f.body.ops.index(ret)
        f.body.ops[pos:pos] = splice
    if bumped:
        f.attrs["result_delays"] = tuple(declared)
        for g in module.funcs.values():
            if g is not f and not g.attrs.get("external"):
                sync_call_delays(module, g, only_callee=f.name)
    return inserted


def _cache_enabled() -> bool:
    return os.environ.get("REPRO_HLS_CACHE", "1") != "0"


def hls_schedule(module: Module, pipeline_loops: bool = True,
                 options: Optional[SchedulerOptions] = None,
                 cache=None, max_workers: int = 1) -> HLSResult:
    """Schedule an unscheduled module in place.  ``pipeline_loops=False``
    skips the modulo-II search: every loop runs sequentially (II = body
    span), the natural input for the ``pipeline-loop`` transform pass.

    ``options`` overrides all knobs (see :class:`SchedulerOptions`);
    ``cache`` is a ``core.hls.dse.ScheduleCache`` (or ``True`` for the
    process-wide default) memoizing whole-function searches by structural
    fingerprint — default off, so benchmarks measuring the cold search stay
    honest; ``max_workers > 1`` schedules independent functions in parallel
    on a process pool (degrading gracefully to serial when the pool is
    unavailable or the worker count is 1 — output is deterministic and
    identical either way)."""
    from . import dse

    opts = (options if options is not None
            else SchedulerOptions(pipeline_loops=pipeline_loops))
    result = HLSResult(module)
    cache_obj = None
    if cache is not None and cache is not False and _cache_enabled():
        cache_obj = dse.SCHEDULE_CACHE if cache is True else cache

    funcs = [f for f in module.funcs.values() if not f.attrs.get("external")]
    names = {f.name for f in funcs}
    cross_calls = any(op.attrs.get("callee") in names
                      for f in funcs for op in f.body.walk()
                      if op.opname == "call")

    if max_workers > 1 and len(funcs) > 1 and not cross_calls:
        # flat call graph: no result-delay propagation between these
        # functions, so the fingerprint pass and the process-pool search
        # are both safe to run on the pre-schedule module wholesale
        todo: list[tuple[FuncOp, Optional[str]]] = []
        for f in funcs:
            key = None
            if cache_obj is not None:
                key = dse.fingerprint_func(f, extra=opts.key())
                hit = cache_obj.get(key)
                if hit is not None:
                    dse.apply_cached_schedule(module, f, hit)
                    _merge_func_meta(result, hit.meta)
                    result.search_cache_hits += 1
                    continue
                result.search_cache_misses += 1
            todo.append((f, key))
        scheduled = (dse.schedule_funcs_parallel(
            module, [f.name for f, _ in todo], opts, max_workers)
            if len(todo) > 1 else None)
        if scheduled is not None:
            for (f, key), (text, meta) in zip(todo, scheduled):
                dse.splice_func_text(module, f.name, text)
                _merge_func_meta(result, meta)
                if cache_obj is not None and key is not None:
                    cache_obj.put(key, text, meta)
            return result
        # pool unavailable (or a single miss): fall through serially with
        # the cache lookups above already resolved
        work = todo
    else:
        # serial path: callee-first so each caller is fingerprinted and
        # scheduled only after its callees' declared delays are final
        work = None

    for item in (work if work is not None else _callee_first(funcs)):
        if work is not None:
            f, key = item
        else:
            f = item
            sync_call_delays(module, f)
            key = None
            if cache_obj is not None:
                key = dse.fingerprint_func(f, extra=opts.key())
                hit = cache_obj.get(key)
                if hit is not None:
                    dse.apply_cached_schedule(module, f, hit)
                    _merge_func_meta(result, hit.meta)
                    result.search_cache_hits += 1
                    continue
                result.search_cache_misses += 1
        s = HLSScheduler(module, options=opts)
        s.schedule_func(f)
        meta = _func_meta(s.result)
        _merge_func_meta(result, meta)
        if cache_obj is not None and key is not None:
            from ..printer import print_func
            cache_obj.put(key, print_func(f), meta, f)
    return result


def _func_meta(r: HLSResult) -> dict:
    return {"iis": dict(r.iis), "miis": dict(r.miis),
            "ii_probes": {k: list(v) for k, v in r.ii_probes.items()},
            "search_iters": r.search_iters, "sched_ops": r.sched_ops,
            "delays_inserted": r.delays_inserted,
            "func_spans": dict(r.func_spans)}


def _merge_func_meta(result: HLSResult, meta: dict) -> None:
    result.iis.update(meta["iis"])
    result.miis.update(meta["miis"])
    result.ii_probes.update(meta["ii_probes"])
    result.search_iters += meta["search_iters"]
    result.sched_ops += meta["sched_ops"]
    result.delays_inserted += meta["delays_inserted"]
    # .get: disk-cache entries written by older builds lack func_spans
    result.func_spans.update(meta.get("func_spans", {}))


def hls_compile(module: Module, entry: Optional[str] = None,
                pipeline: Optional[str] = None, backend: str = "verilog",
                pipeline_loops: bool = True,
                options: Optional[SchedulerOptions] = None,
                cache: bool = True, max_workers: int = 1,
                hierarchy: str = "inline"):
    """Full HLS pipeline: schedule + verify + optimize + netlist codegen.
    Returns (HLSResult, {name: VerilogModule}).

    ``pipeline`` is a textual PassManager spec (default: the paper-benchmark
    optimization pipeline); pass ``""`` to skip optimization.  ``backend``
    selects the netlist printer (``"verilog"`` | ``"systemverilog"`` |
    ``"vhdl"`` | ``"circt"``); the resource summaries are backend-invariant.
    ``pipeline_loops=False`` (or a full :class:`SchedulerOptions` via
    ``options``, which takes precedence) reaches the scheduler, so callers
    can drive the sequential-schedule + ``pipeline-loop``-pass path
    end-to-end.  The PassManager used is exposed on the returned HLSResult
    as ``result.pass_manager`` for per-pass statistics (and its
    ``.analysis_manager`` for analysis-cache statistics).

    Repeated compiles of a structurally-identical module are served from the
    process-wide compile cache (scheduled HIR + netlists keyed by module
    fingerprint, ``result.from_cache``); when ``REPRO_HLS_CACHE_DIR`` is
    set, misses also consult a persistent on-disk cache so warm compiles
    survive process restarts (size-capped, see ``dse.DiskCompileCache``).
    Below the whole-module layer, codegen is *per-function incremental*:
    whole-module misses still reuse every untouched function's lowered RTL
    and printed text from ``dse.FUNC_CODEGEN_CACHE``, so editing one
    ``hir.func`` recompiles only that function (PR 8).  Set ``cache=False``
    or ``REPRO_HLS_CACHE=0`` to disable every cache layer.

    ``hierarchy`` selects flattened (``"inline"``) or modular
    (``"modules"``) emission, forwarded to ``generate_verilog``."""
    from ..codegen import generate_verilog
    from ..passmgr import DEFAULT_PIPELINE_SPEC, AnalysisManager, PassManager
    from ..verifier import verify
    from . import dse

    opts = (options if options is not None
            else SchedulerOptions(pipeline_loops=pipeline_loops))
    spec = DEFAULT_PIPELINE_SPEC if pipeline is None else pipeline
    use_cache = cache and _cache_enabled()
    ckey = None
    if use_cache:
        ckey = dse.fingerprint_module(
            module, extra=(entry, spec, backend, opts.key(), hierarchy))
        hit = dse.COMPILE_CACHE.get(ckey)
        if hit is not None:
            dse.replace_module_contents(module, hit.module)
            res = HLSResult(module, from_cache=True,
                            search_cache_hits=len(hit.meta["funcs"]))
            for meta in hit.meta["funcs"]:
                _merge_func_meta(res, meta)
            return res, dict(hit.netlists)
        disk = dse.disk_cache()
        if disk is not None:
            dhit = disk.get(ckey)
            if dhit is not None:
                dmod, dnets, dmeta = dhit
                # promote to the in-memory cache so later compiles in this
                # process skip the disk round trip too
                dse.COMPILE_CACHE.put(ckey, dmod, dnets, dmeta)
                dse.replace_module_contents(module, dmod)
                res = HLSResult(module, from_cache=True,
                                search_cache_hits=len(dmeta["funcs"]))
                for meta in dmeta["funcs"]:
                    _merge_func_meta(res, meta)
                return res, dnets

    am = AnalysisManager()
    res = hls_schedule(module, options=opts,
                       cache=(True if use_cache else None),
                       max_workers=max_workers)
    verify(module, strict_schedule=False, raise_on_error=False, am=am)
    pm = None
    if spec:
        pm = PassManager.from_spec(spec, analysis_manager=am)
        pm.run(module)
        res.pass_manager = pm
    vs = generate_verilog(module, entry=entry, am=am, backend=backend,
                          hierarchy=hierarchy,
                          func_cache=(dse.FUNC_CODEGEN_CACHE if use_cache
                                      else None),
                          cache_key_extra=(spec, opts.key()),
                          max_workers=max_workers)
    if use_cache and ckey is not None:
        meta = {"funcs": [_func_meta(res)]}
        dse.COMPILE_CACHE.put(ckey, module, vs, meta)
        disk = dse.disk_cache()
        if disk is not None:
            disk.put(ckey, module, vs, meta)
    return res, vs
