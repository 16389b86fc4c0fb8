"""Design-space exploration + search memoization for the HLS baseline
(ScaleHLS-style autotuning on top of the paper's scheduler stand-in).

Three related facilities live here:

**Structural fingerprints** — a stable hash of a function/module printed
with a *positional* value namer, so two structurally identical builds hash
equal even though anonymous SSA values carry build-dependent global ids.
The fingerprint is purely textual: it never incorporates the process-global
interned RTL expression keys (PR 5), which are not stable across processes,
so cache entries stay valid regardless of interning state.

**Search caches** — ``ScheduleCache`` memoizes whole-function schedule
searches (scheduled HIR text + result metadata, LRU) and ``CompileCache``
memoizes whole ``hls_compile`` runs (final module text + netlist objects).
Both are in-memory, per-process, and expose ``AnalysisManager``-style
hit/miss stats; ``REPRO_HLS_CACHE=0`` disables them globally.

**The explorer** — ``explore_design(module, space)`` sweeps
:class:`DSEConfig` candidates (pipeline on/off, min II, clock budget,
unroll stagger, bank merging, instance sharing) on a ``concurrent.futures``
process pool (gracefully serial at ``max_workers=1`` — deterministic output
either way), scores each point with the simulator's cycle count against
``report_design``'s LUT/FF/DSP, verifies each candidate's simulation output
against an expected oracle array, and returns the Pareto frontier over
(latency_ns, LUT, FF, DSP).
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle
import re
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .. import ir
from ..ir import FuncOp, Module, clone_func
from ..pool import pool_map
from ..printer import _Namer, print_func, print_module
from ..schedule import CLOCK_NS
from .scheduler import HLSScheduler, SchedulerOptions, _func_meta

# ---------------------------------------------------------------------------
# Structural fingerprints
# ---------------------------------------------------------------------------


_AUTO_NAME = re.compile(r"v\d+")


class _StructuralNamer(_Namer):
    """Names auto-generated values positionally (``_s0``, ``_s1``, ...)
    instead of by global ``Value.id``, so the printed text — and its hash —
    depends only on the function's structure, not on how many values the
    process allocated before building it.  Values carry ``v{id}`` default
    names from construction (or from parsing previously printed text), so
    any ``v<digits>`` name is treated as positional; human-chosen names
    (args, induction vars) are kept since they surface in backend output."""

    def name(self, v) -> str:
        if v not in self.names and _AUTO_NAME.fullmatch(v.name or ""):
            nm = f"_s{len(self.names)}"
            self.names[v] = nm
            self.used.add(nm)
            return nm
        return super().name(v)


# Bump whenever scheduling or codegen *semantics* change: fingerprints are
# the keys of the persistent DiskCompileCache, so entries produced by an
# older compiler must miss rather than resurrect its output (e.g. the
# result-delay reconciliation fix changed every schedule containing calls;
# schema 3: the instance-sharing RTL passes rewrite hierarchical netlists).
CACHE_SCHEMA = 3


def fingerprint_func(f: FuncOp, extra: tuple = ()) -> str:
    """Structural hash of one function (plus scheduler-option identity)."""
    h = hashlib.sha256()
    h.update(b"schema%d:" % CACHE_SCHEMA)
    h.update(print_func(f, namer=_StructuralNamer()).encode())
    h.update(repr(extra).encode())
    return h.hexdigest()


def fingerprint_module(m: Module, extra: tuple = ()) -> str:
    """Structural hash of a whole module: per-function fingerprints in
    definition order (module name excluded — identity is the content)."""
    h = hashlib.sha256()
    h.update(b"schema%d:" % CACHE_SCHEMA)
    for f in m.funcs.values():
        h.update(f.name.encode())
        h.update(print_func(f, namer=_StructuralNamer()).encode())
    h.update(repr(extra).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


@dataclass
class CacheEntry:
    text: str   # printed scheduled function
    meta: dict  # HLSResult fragment (iis / miis / probes / counters)
    #: scheduled FuncOp (private clone).  The serial scheduler stores it so
    #: hits splice a clone instead of re-parsing ``text`` — the print/parse
    #: round trip drops source locations, which surface in emitted netlist
    #: comments and would break warm-vs-cold byte-identity.  Pool workers
    #: can only ship text, so parallel-path entries leave this None.
    func: Optional[FuncOp] = None


@dataclass
class CompileEntry:
    module: Module  # final (post-optimize, post-unroll) module, private copy
    netlists: dict  # {name: VerilogModule} — process-local objects
    meta: dict


class ScheduleCache:
    """LRU memo of schedule-search results keyed by structural fingerprint,
    with ``AnalysisManager``-style statistics."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._d: OrderedDict[str, object] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str):
        e = self._d.get(key)
        if e is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return e

    def put(self, key: str, *args) -> None:
        self._d[key] = self._make_entry(*args)
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    @staticmethod
    def _make_entry(text: str, meta: dict,
                    func: Optional[FuncOp] = None) -> CacheEntry:
        from ..ir import clone_func

        return CacheEntry(text, meta,
                          None if func is None else clone_func(func))

    def clear(self) -> None:
        self._d.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def stats_dict(self) -> dict:
        return {"entries": len(self._d), "hits": self.hits,
                "misses": self.misses}


class CompileCache(ScheduleCache):
    @staticmethod
    def _make_entry(module: Module, netlists: dict, meta: dict) -> CompileEntry:
        # Clone at insert time so later caller mutations can't corrupt the
        # entry; hits hand out fresh clones (an order of magnitude cheaper
        # than re-parsing the post-unroll module text).  Functions flagged
        # ``_cache_owned`` are already immutable clones owned by the
        # per-function codegen cache (spliced in on incremental hits, shared
        # under the read-only compiled-module contract) — sharing them keeps
        # the warm re-edit put cost proportional to the *edited* functions
        # instead of the whole post-unroll design.
        m = Module(module.name)
        for name, f in module.funcs.items():
            m.funcs[name] = (f if getattr(f, "_cache_owned", False)
                             else clone_func(f))
        return CompileEntry(m, dict(netlists), meta)


@dataclass
class FuncCodegenEntry:
    func: FuncOp    # post-pipeline (inlined/unrolled) function, private copy
    rtl: object     # lowered RTLModule, private copy (exprs shared, immutable)
    text: str       # printed backend text under the design's legalized names
    netlist: object  # Netlist summary consumed by resource reporting


class FuncCodegenCache(ScheduleCache):
    """Per-function codegen memo (incremental recompilation, PR 8): entries
    carry everything downstream of the pass pipeline for one function — the
    post-pipeline HIR, its lowered ``RTLModule``, and the printed backend
    text + netlist — keyed by the function's structural fingerprint *plus*
    the full codegen context (pipeline spec, hierarchy, backend, RTL spec,
    scheduler options and the design's module-name list, which pins the
    printer's first-come name legalization).  Hits are handed out shared:
    compiled functions are consumed read-only downstream, mirroring
    :func:`replace_module_contents`; ``_make_entry`` clones at insert so
    later caller mutations can't corrupt the entry."""

    @staticmethod
    def _make_entry(func: FuncOp, rtl, text: str, netlist) -> FuncCodegenEntry:
        from ..ir import clone_func

        f = clone_func(func)
        f._cache_owned = True  # see CompileCache._make_entry
        return FuncCodegenEntry(f, rtl.copy(), text, netlist)


#: process-wide default caches (``REPRO_HLS_CACHE=0`` bypasses all three)
SCHEDULE_CACHE = ScheduleCache()
COMPILE_CACHE = CompileCache(capacity=64)
FUNC_CODEGEN_CACHE = FuncCodegenCache(capacity=256)


def apply_cached_schedule(module: Module, f: FuncOp, entry: CacheEntry) -> None:
    """Replace ``f`` with the cached scheduled function: a clone of the
    stored FuncOp when the entry carries one (lossless, keeps source
    locations), else a print/parse round trip of the stored text."""
    if entry.func is not None:
        from ..ir import clone_func

        module.funcs[f.name] = clone_func(entry.func)
    else:
        splice_func_text(module, f.name, entry.text)


def splice_func_text(module: Module, fname: str, text: str) -> None:
    from ..parser import parse_func

    module.funcs[fname] = parse_func(text)


def replace_module_contents(module: Module, src: Module) -> None:
    """Install ``src``'s functions into ``module`` (compile-cache hit path).

    The functions are *shared* with the cache entry, mirroring how netlist
    objects are handed out: compiled modules are consumed read-only
    (``simulate``/``report_design``/printing never mutate IR), and a deep
    clone per hit would cost more than the whole warm compile.  Callers who
    want to mutate a cache-served module must ``module.clone()`` it first."""
    module.funcs.clear()
    module.funcs.update(src.funcs)


# ---------------------------------------------------------------------------
# Parallel per-function scheduling (used by hls_schedule(max_workers>1))
# ---------------------------------------------------------------------------


def _schedule_one_func(payload):
    """Pool worker: parse the module text, schedule one function, return its
    printed scheduled form + result metadata.  Top-level by necessity
    (ProcessPoolExecutor pickles the callable by reference)."""
    module_text, fname, opts = payload
    from ..parser import parse

    m = parse(module_text)
    s = HLSScheduler(m, options=opts)
    s.schedule_func(m.get(fname))
    return print_func(m.get(fname)), _func_meta(s.result)


def schedule_funcs_parallel(module: Module, fnames: list[str],
                            opts: SchedulerOptions, max_workers: int):
    """Schedule ``fnames`` concurrently on a process pool; returns
    ``[(scheduled text, meta), ...]`` in input order, or None when no pool
    can be created (sandboxes without semaphores, missing multiprocessing) —
    the caller then falls back to the serial path, which produces the
    byte-identical result."""
    text = print_module(module)
    payloads = [(text, fn, opts) for fn in fnames]
    return pool_map(_schedule_one_func, payloads, max_workers,
                    label="per-function scheduling")


# ---------------------------------------------------------------------------
# Design-space exploration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DSEConfig:
    """One autotuner candidate: scheduler knobs + structural knobs.

    ``tile`` (innermost-loop tiling factor, 0/1 = off), ``interchange``
    (perfect-nest loop swap) and ``partition`` (minimum local-RAM bank
    count, 0/1 = off) are *pre-schedule structural* knobs applied by
    :func:`apply_structural_knobs`; interchange is speculative and relies on
    the sweep's sim-verification to score out illegal swaps.

    ``share_instances`` is a *codegen* knob: emit hierarchically
    (``hierarchy="modules"``) so the ``rtl-share-instances`` /
    ``rtl-arbitrate`` passes can fold schedule-disjoint callee instances
    onto shared physical hardware — trading nothing at the schedule level
    (latency is fixed by the schedule) for fewer DSP/LUT when the
    ``activation-intervals`` analysis proves the pulses disjoint."""

    pipeline: bool = True
    min_ii: int = 1
    clock_ns: float = CLOCK_NS
    unroll_parallel: bool = True
    merge_banks: bool = False
    tile: int = 0
    interchange: bool = False
    partition: int = 0
    share_instances: bool = False

    def scheduler_options(self) -> SchedulerOptions:
        return SchedulerOptions(pipeline_loops=self.pipeline,
                                min_ii=self.min_ii, clock_ns=self.clock_ns,
                                unroll_parallel=self.unroll_parallel)

    def as_dict(self) -> dict:
        return {"pipeline": self.pipeline, "min_ii": self.min_ii,
                "clock_ns": self.clock_ns,
                "unroll_parallel": self.unroll_parallel,
                "merge_banks": self.merge_banks, "tile": self.tile,
                "interchange": self.interchange,
                "partition": self.partition,
                "share_instances": self.share_instances}


def design_space(pipeline: Sequence[bool] = (True, False),
                 min_ii: Sequence[int] = (1,),
                 clock_ns: Sequence[float] = (CLOCK_NS,),
                 unroll_parallel: Sequence[bool] = (True,),
                 merge_banks: Sequence[bool] = (False,),
                 tile: Sequence[int] = (0,),
                 interchange: Sequence[bool] = (False,),
                 partition: Sequence[int] = (0,),
                 share_instances: Sequence[bool] = (False,)) -> list[DSEConfig]:
    """Cartesian product of the knob axes, with redundant points removed
    (``min_ii`` only matters when pipelining; ``partition`` fights
    ``merge_banks``, so the merged+partitioned combination is dropped), in
    deterministic order."""
    out: list[DSEConfig] = []
    seen = set()
    for p in pipeline:
        for mi in (min_ii if p else (1,)):
            for ck in clock_ns:
                for up in unroll_parallel:
                    for mb in merge_banks:
                        for t in tile:
                            for ic in interchange:
                                for pt in (partition if not mb else (0,)):
                                    for sh in share_instances:
                                        c = DSEConfig(p, mi, ck, up, mb, t,
                                                      ic, pt, sh)
                                        if c not in seen:
                                            seen.add(c)
                                            out.append(c)
    return out


def merge_local_banks(module: Module) -> int:
    """Banking knob: fold every *distributed* local LUTRAM/BRAM alloc into a
    single fully-packed bank (fewer physical RAMs -> fewer LUT/FF, but the
    scheduler must serialize the accesses that used to hit distinct banks).
    Register banks are excluded — their FF cost is per element regardless of
    banking, so merging only destroys parallelism for free.  Returns the
    number of ports retyped."""
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        for op in f.body.walk():
            if op.opname != "alloc":
                continue
            for r in op.results:
                mt = r.type
                if (isinstance(mt, ir.MemrefType) and mt.distributed
                        and mt.kind in (ir.KIND_LUTRAM, ir.KIND_BRAM)):
                    r.type = ir.MemrefType(mt.shape, mt.elem, mt.port,
                                           packed=list(range(len(mt.shape))),
                                           kind=mt.kind)
                    n += 1
    return n


def partition_local_banks(module: Module, factor: int) -> int:
    """Array-partitioning knob (the dual of :func:`merge_local_banks`):
    *distribute* leading packed dims of every local LUTRAM/BRAM alloc until
    the memref has at least ``factor`` banks — more physical RAMs, more
    parallel ports, so unrolled access patterns stop serializing on a shared
    bank.  Allocs already banked at ``factor`` or finer are untouched.
    Returns the number of ports retyped."""
    if factor < 2:
        return 0
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        for op in f.body.walk():
            if op.opname != "alloc":
                continue
            for r in op.results:
                mt = r.type
                if not (isinstance(mt, ir.MemrefType)
                        and mt.kind in (ir.KIND_LUTRAM, ir.KIND_BRAM)):
                    continue
                packed = list(mt.packed)
                if mt.num_banks >= factor or not packed:
                    continue
                nt = mt
                while packed and nt.num_banks < factor:
                    packed.pop(0)
                    nt = ir.MemrefType(mt.shape, mt.elem, mt.port,
                                       packed=packed, kind=mt.kind)
                r.type = nt
                n += 1
    return n


def apply_structural_knobs(module: Module, config: DSEConfig) -> None:
    """Apply the candidate's pre-schedule structural transforms, in a fixed
    order (tiling, then interchange, then banking) on erased HIR.  Transforms
    that raise (e.g. a banking the scheduler later rejects) propagate to the
    caller, which scores the candidate out."""
    from ..passes.loop_transforms import interchange_loops, tile_innermost

    if config.tile > 1:
        tile_innermost(module, config.tile)
    if config.interchange:
        interchange_loops(module)
    if config.merge_banks:
        merge_local_banks(module)
    if config.partition > 1:
        partition_local_banks(module, config.partition)


def has_mergeable_banks(module: Module) -> bool:
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        for op in f.body.walk():
            if op.opname == "alloc":
                for r in op.results:
                    mt = r.type
                    if (isinstance(mt, ir.MemrefType) and mt.distributed
                            and mt.kind in (ir.KIND_LUTRAM, ir.KIND_BRAM)):
                        return True
    return False


@dataclass
class DSEPoint:
    config: DSEConfig
    latency_cycles: Optional[int] = None
    latency_ns: Optional[float] = None
    lut: int = 0
    ff: int = 0
    dsp: int = 0
    bram: int = 0
    iis: dict = field(default_factory=dict)
    verified: bool = False
    error: Optional[str] = None
    #: outcome of the batched cycle-accurate sweep (``sim_verify_front``):
    #: None = not swept, otherwise every lane matched the oracle or not.
    batch_verified: Optional[bool] = None
    batch_vectors: int = 0
    #: successive halving: True when the candidate was eliminated at the
    #: cheap-scoring rung and never fully compiled; ``est`` then holds the
    #: schedule-only estimates it was ranked by.
    pruned: bool = False
    est: Optional[dict] = None
    #: logical instances absorbed onto shared physical hardware by
    #: ``rtl-share-instances``/``rtl-arbitrate`` (0 unless the candidate's
    #: ``share_instances`` knob is on and the schedule proved disjointness).
    shared_absorbed: int = 0

    def objectives(self) -> Optional[tuple]:
        if self.latency_ns is None or self.error is not None:
            return None
        return (self.latency_ns, self.lut, self.ff, self.dsp)

    def as_dict(self) -> dict:
        return {"config": self.config.as_dict(),
                "latency_cycles": self.latency_cycles,
                "latency_ns": self.latency_ns,
                "lut": self.lut, "ff": self.ff, "dsp": self.dsp,
                "bram": self.bram, "iis": self.iis,
                "verified": self.verified, "error": self.error,
                "batch_verified": self.batch_verified,
                "batch_vectors": self.batch_vectors,
                "pruned": self.pruned, "est": self.est,
                "shared_absorbed": self.shared_absorbed}


def dominates(a: tuple, b: tuple) -> bool:
    """Pareto dominance on minimization objectives."""
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def pareto_front(points: Sequence[DSEPoint]) -> list[DSEPoint]:
    """Non-dominated verified points over (latency_ns, LUT, FF, DSP), one
    per distinct objective vector, sorted by latency then area.  DSP is a
    first-class objective so a time-multiplexed candidate (same schedule,
    fewer multipliers) survives next to its fully-spatial sibling as a
    genuine latency-vs-DSP tradeoff point."""
    usable = [p for p in points if p.verified and p.objectives() is not None]
    front: list[DSEPoint] = []
    seen_obj = set()
    for p in usable:
        po = p.objectives()
        if po in seen_obj:
            continue
        if any(dominates(q.objectives(), po) for q in usable):
            continue
        seen_obj.add(po)
        front.append(p)
    front.sort(key=lambda p: p.objectives())
    return front


def _evaluate_candidate(payload) -> dict:
    """Pool worker: schedule + optimize + emit + simulate one candidate.
    Returns a plain dict (picklable) — errors become a scored-out point
    rather than killing the sweep."""
    module_text, entry, config, inputs, expected, pipeline_spec = payload
    import numpy as np

    from ..codegen import generate_verilog
    from ..codegen.resources import report_design
    from ..lower import simulate
    from ..parser import parse
    from ..passmgr import DEFAULT_PIPELINE_SPEC, PassManager
    from .scheduler import hls_schedule

    try:
        m = parse(module_text)
        apply_structural_knobs(m, config)
        res = hls_schedule(m, options=config.scheduler_options())
        spec = DEFAULT_PIPELINE_SPEC if pipeline_spec is None else pipeline_spec
        if spec:
            PassManager.from_spec(spec).run(m)
        # share_instances needs the call hierarchy preserved as Instances
        # for rtl-share-instances/rtl-arbitrate to merge; latency is a
        # schedule property and unaffected by the emission policy.
        hier = "modules" if config.share_instances else "inline"
        vs = generate_verilog(m, entry=entry, hierarchy=hier)
        rep = report_design(vs, entry=entry)
        absorbed = 0
        if config.share_instances:
            from ..codegen.resources import sharing_summary
            absorbed = sharing_summary(vs, entry=entry)["absorbed"]
        point = {"config": config, "iis": dict(res.iis),
                 "lut": rep.lut, "ff": rep.ff, "dsp": rep.dsp,
                 "bram": rep.bram, "latency_cycles": None,
                 "latency_ns": None, "verified": False, "error": None,
                 "shared_absorbed": absorbed}
        if inputs is not None:
            args = [np.array(a, copy=True) if isinstance(a, np.ndarray) else a
                    for a in inputs]
            simres = simulate(m, entry, args)
            point["latency_cycles"] = int(simres["cycles"])
            point["latency_ns"] = float(simres["cycles"]) * config.clock_ns
            if expected is not None:
                point["verified"] = bool(np.array_equal(args[-1], expected))
        return point
    except MemoryError:
        raise  # resource exhaustion must abort the sweep, not score a point
    except _expected_sweep_errors() as e:  # scored out, sweep continues
        return {"config": config, "error": f"{type(e).__name__}: {e}",
                "verified": False, "iis": {}, "lut": 0, "ff": 0, "dsp": 0,
                "bram": 0, "latency_cycles": None, "latency_ns": None}
    except Exception as e:  # unexpected: still score out, but loudly
        warnings.warn(
            f"DSE candidate raised unexpected {type(e).__name__}: {e}",
            RuntimeWarning, stacklevel=2)
        return {"config": config, "error": f"{type(e).__name__}: {e}",
                "verified": False, "iis": {}, "lut": 0, "ff": 0, "dsp": 0,
                "bram": 0, "latency_cycles": None, "latency_ns": None}


def _expected_sweep_errors() -> tuple:
    """Failures a DSE candidate can legitimately produce — malformed knob
    combinations, infeasible schedules, verification mismatches — and that
    therefore score the candidate out while the sweep continues.  Resolved
    lazily to keep worker-side imports (pickle-by-reference) cycle-free."""
    from ..lower.to_sim import SimulationError
    from ..parser import ParseError
    from ..verifier import VerifyError
    return (ParseError, VerifyError, SimulationError, ValueError, KeyError,
            IndexError, NotImplementedError, AssertionError, ZeroDivisionError)


def _map_candidates(payloads: list, max_workers: int,
                    fn=_evaluate_candidate) -> list[dict]:
    out = pool_map(fn, payloads, max_workers, label="DSE candidate sweep")
    if out is None:  # no pool (or pointless): serial sweep, identical output
        out = [fn(p) for p in payloads]
    return out


# -- successive halving: cheap schedule-only scoring --------------------------


def estimate_resources(module: Module) -> dict:
    """Pre-unroll LUT/FF/DSP estimate from a walk of the scheduled HIR: each
    op's cost is replicated by the product of enclosing ``unroll_for`` trip
    counts (spatial copies after unrolling), allocs are costed by their
    banking.  Deliberately crude — the halving rung only needs a *ranking*
    consistent with ``report_design``, not its absolute numbers."""

    def width(t) -> int:
        w = getattr(t, "width", None)
        return int(w) if w else 32

    lut = ff = dsp = 0

    def walk(region, repl: int):
        nonlocal lut, ff, dsp
        for op in region.ops:
            if op.opname in ("for", "unroll_for"):
                inner = repl
                if op.opname == "unroll_for":
                    inner *= op.trip_count() or 1
                walk(op.region(0), inner)
            elif op.opname == "mult":
                w = width(op.results[0].type)
                if w > 10:
                    dsp += repl
                else:
                    lut += repl * w
            elif op.opname in ("add", "sub", "cmp", "shl", "shr", "and",
                               "or", "xor", "select", "div"):
                lut += repl * width(op.results[0].type)
            elif op.opname == "delay":
                by = int(op.attrs.get("by", 1) or 1)
                ff += repl * width(op.results[0].type) * by
            elif op.opname == "alloc":
                mt = op.results[0].type
                if isinstance(mt, ir.MemrefType):
                    bits = width(mt.elem)
                    for d in mt.shape:
                        bits *= d
                    if mt.kind == ir.KIND_REG:
                        ff += bits
                    elif mt.kind == ir.KIND_LUTRAM:
                        lut += bits // 2
                    # BRAM is a separate objective; banks add LUT mux glue
                    lut += 4 * mt.num_banks

    for f in module.funcs.values():
        if not f.attrs.get("external"):
            walk(f.body, 1)
    return {"lut": lut, "ff": ff, "dsp": dsp}


def _cheap_score_candidate(payload) -> dict:
    """Pool worker for the halving rung: structural knobs + schedule search
    only — no pass pipeline, no unrolling, no RTL, no simulation.  The
    scheduler's entry-function span *is* the design latency in cycles, so
    the latency estimate is near-exact; area comes from
    :func:`estimate_resources`."""
    module_text, entry, config = payload
    from ..parser import parse
    from .scheduler import hls_schedule

    try:
        m = parse(module_text)
        apply_structural_knobs(m, config)
        res = hls_schedule(m, options=config.scheduler_options())
        span = res.func_spans.get(entry, 0)
        if not span and res.func_spans:
            span = max(res.func_spans.values())
        est = estimate_resources(m)
        return {"config": config, "error": None,
                "est_latency_ns": float(span) * config.clock_ns,
                "est_lut": est["lut"], "est_ff": est["ff"],
                "est_dsp": est["dsp"]}
    except MemoryError:
        raise  # resource exhaustion must abort the rung, not score a point
    except _expected_sweep_errors() as e:
        return {"config": config, "error": f"{type(e).__name__}: {e}"}
    except Exception as e:  # unexpected: still score out, but loudly
        warnings.warn(
            f"DSE cheap-score raised unexpected {type(e).__name__}: {e}",
            RuntimeWarning, stacklevel=2)
        return {"config": config, "error": f"{type(e).__name__}: {e}"}


def _rank_candidates(rows: list[dict]) -> list[float]:
    """Non-dominated-sorting rank of cheap-score rows over
    (est_latency_ns, est_lut, est_ff, est_dsp): rank 0 = estimated Pareto
    front, rank 1 = front after removing rank 0, ...; errored rows rank
    last."""
    objs = {i: (r["est_latency_ns"], r["est_lut"], r["est_ff"],
                r["est_dsp"])
            for i, r in enumerate(rows) if r.get("error") is None}
    rank = [math.inf] * len(rows)
    remaining = set(objs)
    level = 0
    while remaining:
        front = [i for i in remaining
                 if not any(dominates(objs[j], objs[i])
                            for j in remaining if j != i)]
        if not front:  # unreachable (dominance is a strict partial order)
            front = sorted(remaining)
        for i in front:
            rank[i] = level
        remaining -= set(front)
        level += 1
    return rank


@dataclass
class DSEResult:
    points: list[DSEPoint]
    front: list[DSEPoint]
    #: sweep accounting: strategy, candidate counts, evaluations saved by
    #: successive halving (empty dict for pre-PR-8 callers).
    stats: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"points": [p.as_dict() for p in self.points],
                "pareto_front": [p.as_dict() for p in self.front],
                "stats": self.stats}


def _row_to_point(r: dict) -> DSEPoint:
    return DSEPoint(config=r["config"], latency_cycles=r["latency_cycles"],
                    latency_ns=r["latency_ns"], lut=r["lut"], ff=r["ff"],
                    dsp=r["dsp"], bram=r["bram"], iis=r["iis"],
                    verified=r["verified"], error=r["error"],
                    shared_absorbed=r.get("shared_absorbed", 0))


def explore_design(module: Module, space: Sequence[DSEConfig],
                   entry: Optional[str] = None, inputs=None, expected=None,
                   max_workers: int = 1,
                   pipeline_spec: Optional[str] = None,
                   strategy: str = "exhaustive",
                   keep_frac: float = 0.5,
                   device=None) -> DSEResult:
    """Sweep ``space`` over (an erased copy of) ``module``: each candidate is
    scheduled under its knobs, optimized, emitted, resource-scored
    (``report_design``) and — when ``inputs`` are given — simulated for its
    cycle count and verified against ``expected`` (the oracle's output
    array).  When ``inputs`` are given but ``expected`` is not, the oracle
    output is computed once through the memoized jax-oracle cache
    (:func:`oracle_expected`) — structurally identical source modules never
    re-trace.  Candidates run on a process pool when ``max_workers > 1``
    (serial fallback is byte-identical).  Returns every scored point plus
    the Pareto frontier over (latency_ns, LUT, FF, DSP).

    ``strategy="halving"`` enables successive halving: every candidate gets
    a cheap schedule-only score (:func:`_cheap_score_candidate` — the
    scheduler span is the exact latency, area is estimated), then only the
    best ``keep_frac`` fraction by non-dominated rank is fully compiled and
    sim-verified.  Eliminated candidates appear in ``points`` with
    ``pruned=True`` and their estimates in ``est``; ``result.stats`` records
    the evaluations saved.  ``device`` is the oracle's (``oracle_expected``)."""
    from .eraser import erase_schedule

    base = erase_schedule(module.clone())
    if inputs is not None and expected is None:
        expected = oracle_expected(base, entry, inputs, device=device)
    text = print_module(base)
    stats = {"strategy": strategy, "n_candidates": len(space),
             "n_cheap": 0, "n_full": len(space), "evaluations_saved": 0}

    survivors = list(range(len(space)))
    est_rows: list[dict] = []
    if strategy == "halving" and len(space) > 2:
        ename = _entry_name(base, entry)
        est_rows = _map_candidates([(text, ename, cfg) for cfg in space],
                                   max_workers, fn=_cheap_score_candidate)
        ranks = _rank_candidates(est_rows)
        keep = max(1, math.ceil(len(space) * keep_frac))
        order = sorted(range(len(space)), key=lambda i: (ranks[i], i))
        survivors = sorted(order[:keep])
        stats.update(n_cheap=len(space), n_full=len(survivors),
                     evaluations_saved=len(space) - len(survivors))

    payloads = [(text, entry, space[i], inputs, expected, pipeline_spec)
                for i in survivors]
    rows = dict(zip(survivors, _map_candidates(payloads, max_workers)))
    points = []
    for i, cfg in enumerate(space):
        if i in rows:
            points.append(_row_to_point(rows[i]))
        else:
            e = est_rows[i]
            points.append(DSEPoint(
                config=cfg, pruned=True, error=e.get("error"),
                est=None if e.get("error") is not None else {
                    "latency_ns": e["est_latency_ns"], "lut": e["est_lut"],
                    "ff": e["est_ff"], "dsp": e["est_dsp"]}))
    return DSEResult(points, pareto_front(points), stats)


# ---------------------------------------------------------------------------
# Memoized oracle reference outputs (sim-verification support)
# ---------------------------------------------------------------------------

#: lowered-oracle callables keyed by source-module fingerprint — re-running
#: verification for a structurally identical module skips the jax lowering
#: (trace) entirely.
_ORACLE_FN_CACHE: OrderedDict = OrderedDict()
#: reference *outputs* keyed by (fingerprint, input digest) — each Pareto
#: candidate reuses the exact arrays computed for the first one.
_ORACLE_OUT_CACHE: OrderedDict = OrderedDict()
_ORACLE_FN_CAP = 32
_ORACLE_OUT_CAP = 1024
ORACLE_STATS = {"fn_hits": 0, "fn_misses": 0,
                "out_hits": 0, "out_misses": 0}


def clear_oracle_cache() -> None:
    _ORACLE_FN_CACHE.clear()
    _ORACLE_OUT_CACHE.clear()
    for k in ORACLE_STATS:
        ORACLE_STATS[k] = 0


def _entry_name(module: Module, entry: Optional[str]) -> str:
    if entry is not None:
        return entry
    names = [f.name for f in module.funcs.values()
             if not f.attrs.get("external")]
    if len(names) != 1:
        raise ValueError(f"ambiguous entry, specify one of {names}")
    return names[0]


def _digest_inputs(inputs: Sequence) -> str:
    h = hashlib.sha256()
    for a in inputs:
        if isinstance(a, np.ndarray):
            h.update(b"A")
            h.update(str(a.dtype).encode())
            h.update(repr(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            h.update(repr(a).encode())
    return h.hexdigest()


def _lru_put(d: OrderedDict, key, val, cap: int) -> None:
    d[key] = val
    d.move_to_end(key)
    while len(d) > cap:
        d.popitem(last=False)


def oracle_expected(module: Module, entry: Optional[str],
                    inputs: Sequence, result_arg: int = -1,
                    device=None) -> np.ndarray:
    """Reference output of ``module.entry(*inputs)`` for argument
    ``result_arg``, memoized two ways: the lowered oracle callable is cached
    by structural fingerprint and device (no re-lowering for the same source
    module) and the output array by (fingerprint and device, input digest)
    (no re-execution for the same stimulus).  Uses the functional PyTorch
    lowering (``lower.to_torch``) on ``device``: ``None`` means the CUDA
    device and raises where there is none.  Both caches respect
    ``REPRO_HLS_CACHE=0``."""
    from ..._device import resolve_device
    from .scheduler import _cache_enabled

    device = resolve_device(device)

    entry = _entry_name(module, entry)
    f = module.get(entry)
    rname = f.args[result_arg].name
    use_cache = _cache_enabled()
    fp = key = None
    if use_cache:
        fp = fingerprint_module(module, extra=("oracle", entry, result_arg, str(device)))
        key = (fp, _digest_inputs(inputs))
        hit = _ORACLE_OUT_CACHE.get(key)
        if hit is not None:
            _ORACLE_OUT_CACHE.move_to_end(key)
            ORACLE_STATS["out_hits"] += 1
            return np.array(hit, copy=True)
        ORACLE_STATS["out_misses"] += 1

    fn = _ORACLE_FN_CACHE.get(fp) if use_cache else None
    if fn is not None:
        _ORACLE_FN_CACHE.move_to_end(fp)
        ORACLE_STATS["fn_hits"] += 1
    else:
        ORACLE_STATS["fn_misses"] += 1
        fn = _make_oracle_fn(module, entry, rname, device)
        if use_cache:
            _lru_put(_ORACLE_FN_CACHE, fp, fn, _ORACLE_FN_CAP)

    out = np.asarray(fn(inputs))
    if use_cache:
        _lru_put(_ORACLE_OUT_CACHE, key, np.array(out, copy=True),
                 _ORACLE_OUT_CAP)
    return out


def _make_oracle_fn(module: Module, entry: str, rname: str, device):
    """Build the oracle callable on a private clone: the functional PyTorch
    lowering (``lower.to_torch``) on ``device``.  An import error raises:
    there is no second route.  The returned closure takes the raw input
    list (host arrays) and returns the ``rname`` result array (a host
    array)."""
    from ..lower.to_torch import lower_to_torch

    tfn = lower_to_torch(module.clone(), entry, device=device)

    def run_torch(inputs):
        outs = tfn(*[np.array(a, copy=True)
                     if isinstance(a, np.ndarray) else a
                     for a in inputs])
        return outs[rname].cpu().numpy()

    return run_torch


# ---------------------------------------------------------------------------
# Batched (vectorized-simulator) verification of Pareto candidates
# ---------------------------------------------------------------------------


def sim_verify_front(module: Module, result: DSEResult,
                     entry: Optional[str] = None,
                     args_batch: Optional[Sequence[np.ndarray]] = None, *,
                     pipeline_spec: Optional[str] = None,
                     backend: str = "auto", margin: int = 16,
                     device=None) -> int:
    """Run every Pareto-front candidate through the vectorized cycle-accurate
    RTL simulator (``core.codegen.sim``) over a whole stimulus batch and
    check each lane's result array against the memoized oracle of the
    *source* module.  This upgrades DSE verification from the single
    ``inputs`` vector of :func:`explore_design` to hundreds of vectors per
    candidate at batched-simulator throughput.

    ``args_batch`` holds one batch-first array per function argument
    (``(B, ...)`` for memrefs, ``(B,)`` for scalars — see
    ``codegen.sim.stack_stimulus``).  Sets ``batch_verified`` /
    ``batch_vectors`` on each front point and returns the number of
    candidates in which every lane matched.  ``device`` is the simulator's
    and the oracle's: ``None`` means the CUDA device."""
    from ..codegen.sim import probe_cycles, simulator_for
    from ..parser import parse
    from ..passmgr import DEFAULT_PIPELINE_SPEC, PassManager
    from .eraser import erase_schedule
    from .scheduler import hls_schedule

    if args_batch is None or not result.front:
        return 0
    base = erase_schedule(module.clone())
    entry = _entry_name(base, entry)
    nargs = len(base.get(entry).args)
    batch = [np.asarray(a) for a in args_batch]
    if len(batch) != nargs:
        raise ValueError(f"args_batch has {len(batch)} columns, "
                         f"{entry} takes {nargs}")
    n_vec = int(batch[0].shape[0])

    def lane(k):
        return [col[k] if col[k].ndim else int(col[k]) for col in batch]

    expected = np.stack([oracle_expected(base, entry, lane(k), device=device)
                         for k in range(n_vec)])
    text = print_module(base)
    spec = DEFAULT_PIPELINE_SPEC if pipeline_spec is None else pipeline_spec
    n_ok = 0
    ridx = nargs - 1
    for point in result.front:
        m = parse(text)
        apply_structural_knobs(m, point.config)
        hls_schedule(m, options=point.config.scheduler_options())
        if spec:
            PassManager.from_spec(spec).run(m)
        sim, prepared = simulator_for(m, entry, backend=backend,
                                      device=device)
        cycles = probe_cycles(prepared, entry, lane(0), margin=margin)
        res = sim.run(batch, cycles, batched=True)
        got = np.asarray(res.arrays[ridx]).reshape(expected.shape)
        point.batch_verified = bool(np.array_equal(got, expected))
        point.batch_vectors = n_vec
        n_ok += point.batch_verified
    return n_ok


# ---------------------------------------------------------------------------
# Persistent on-disk compile cache
# ---------------------------------------------------------------------------


class DiskCompileCache:
    """Fingerprint-keyed compile cache that survives process restarts.

    Each entry is one pickle file named by the compile fingerprint holding
    the *printed* module text plus the per-function netlist summaries
    ``(name, text, backend, Netlist)`` — never pickled RTL expression trees,
    whose interned keys (PR 5) are process-local.  Loaded netlists are
    rebuilt as ``VerilogModule`` with ``rtl=None``; resource reporting and
    printing only consume ``netlist``/``text``, so warm compiles behave
    identically (callers needing RTL structure, e.g. the RTL simulator,
    regenerate it from the module).

    The directory is size-capped: after each ``put`` the oldest entries (by
    mtime — ``get`` refreshes it, approximating LRU) are evicted until the
    total drops under ``max_bytes``.  All I/O failures degrade to cache
    misses so a broken or read-only directory can never fail a compile."""

    def __init__(self, root: str, max_bytes: int = 256 * 10**6):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.pkl"

    def get(self, key: str):
        """Returns ``(module, {name: VerilogModule}, meta)`` or None."""
        from ..codegen.verilog import VerilogModule
        from ..parser import parse

        from ..parser import ParseError

        p = self._path(key)
        try:
            blob = pickle.loads(p.read_bytes())
            module = parse(blob["module_text"])
            netlists = {name: VerilogModule(name, text, nl, None, bk)
                        for name, text, bk, nl in blob["netlists"]}
            meta = blob["meta"]
        except (OSError, EOFError, pickle.PickleError, KeyError, ValueError,
                TypeError, ParseError):
            # absent, truncated, stale-format, or corrupted entry: a disk
            # cache may always miss; anything else (MemoryError, bugs in
            # parse) propagates
            self.misses += 1
            return None
        try:
            os.utime(p)  # refresh recency for eviction
        except OSError:
            pass
        self.hits += 1
        return module, netlists, meta

    def put(self, key: str, module: Module, netlists: dict,
            meta: dict) -> None:
        blob = {"module_text": print_module(module),
                "netlists": [(v.name, v.text, v.backend, v.netlist)
                             for v in netlists.values()],
                "meta": meta}
        p = self._path(key)
        tmp = p.with_suffix(f".tmp{os.getpid()}")
        try:
            tmp.write_bytes(pickle.dumps(blob, protocol=4))
            os.replace(tmp, p)
        except OSError:
            tmp.unlink(missing_ok=True)
            return
        self._evict()

    #: tmp files older than this are considered abandoned by a crashed
    #: writer and swept during eviction.
    STALE_TMP_S = 300.0

    def _evict(self) -> None:
        """Lock-free LRU eviction tolerant of racing processes: writers from
        an emission/DSE pool may evict, replace or refresh entries while this
        runs, so every ``stat``/``unlink`` tolerates the file vanishing
        underneath us (a racer unlinking first still frees the bytes, so the
        running total is decremented either way).  Abandoned ``.tmp<pid>``
        spill files from crashed writers are swept once they go stale."""
        try:
            listing = list(self.root.glob("*.pkl"))
            tmps = [t for t in self.root.glob("*.tmp*") if t.is_file()]
        except OSError:
            return
        now = time.time()
        for t in tmps:
            try:
                if now - t.stat().st_mtime > self.STALE_TMP_S:
                    t.unlink()
            except OSError:
                pass  # racing writer finished (renamed) or swept it first
        files = []
        for f in listing:
            try:
                st = f.stat()
            except OSError:
                continue  # raced: a concurrent evictor got there first
            files.append((st.st_mtime, st.st_size, str(f)))
        total = sum(sz for _, sz, _ in files)
        for _, sz, f in sorted(files):
            if total <= self.max_bytes:
                break
            try:
                os.unlink(f)
            except OSError:
                pass  # already evicted by a racer — bytes freed regardless
            total -= sz

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.pkl"))

    def stats_dict(self) -> dict:
        return {"entries": len(self), "hits": self.hits,
                "misses": self.misses}


_DISK_CACHE: Optional[DiskCompileCache] = None
_DISK_CACHE_KEY: Optional[tuple] = None


def disk_cache() -> Optional[DiskCompileCache]:
    """The process-wide on-disk compile cache, or None when
    ``REPRO_HLS_CACHE_DIR`` is unset.  ``REPRO_HLS_CACHE_MAX_MB`` (default
    256) caps the directory size.  Re-reads the environment on each call so
    tests can point it at temporary directories."""
    global _DISK_CACHE, _DISK_CACHE_KEY
    root = os.environ.get("REPRO_HLS_CACHE_DIR")
    if not root:
        _DISK_CACHE, _DISK_CACHE_KEY = None, None
        return None
    mb = float(os.environ.get("REPRO_HLS_CACHE_MAX_MB", "256"))
    cfg = (root, mb)
    if _DISK_CACHE is None or _DISK_CACHE_KEY != cfg:
        _DISK_CACHE = DiskCompileCache(root, max_bytes=int(mb * 10**6))
        _DISK_CACHE_KEY = cfg
    return _DISK_CACHE
