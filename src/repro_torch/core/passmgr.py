"""MLIR-style pass manager: ``Pass`` base classes, a registry addressable by
textual pipeline specs, and a ``PassManager`` with per-pass statistics.

The paper's headline codegen-speed result comes from HIR being a *thin,
composable* MLIR pass pipeline instead of a monolithic search; this module
gives the reproduction the same shape:

  * ``Pass``               — unit of transformation, ``run(module) -> int``
                             (number of rewrites applied);
  * ``PatternRewritePass`` — a pass defined as a ``RewritePatternSet``
                             applied by the greedy worklist driver
                             (``core.rewrite``), one driver run per function;
  * ``register_pass``      — adds a pass class to the global registry under
                             its spec name (e.g. ``strength-reduce``);
  * ``PassManager``        — runs an ordered pipeline (optionally iterated to
                             a fixpoint), records per-pass wall time and
                             rewrite counts, and optionally verifies the IR
                             between passes;
  * ``PassManager.from_spec("canonicalize,cse,strength-reduce")`` — builds a
                             pipeline from a declarative textual spec, the
                             form benchmarks and examples use.

Spec names accept ``-`` or ``_`` interchangeably; unknown names raise
``ValueError`` listing the registered passes.

The module also hosts the analysis layer (MLIR's AnalysisManager):

  * ``FunctionAnalysis``   — a named, construct-on-demand per-function
                             analysis (``run(func, am) -> result``);
  * ``register_analysis``  — adds an analysis class to the global registry;
  * ``AnalysisManager``    — caches analysis results per (func, analysis)
                             with hit/miss statistics; passes declare which
                             analyses they *preserve* (``Pass.preserves`` /
                             ``preserves_all``) and the PassManager
                             invalidates everything else after a pass that
                             rewrote the module.  A pass reporting 0 rewrites
                             preserves all analyses implicitly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Type, Union

from .ir import FuncOp, Module
from .rewrite import RewritePatternSet, apply_patterns_greedily

# ---------------------------------------------------------------------------
# Analyses: registry + AnalysisManager
# ---------------------------------------------------------------------------


class FunctionAnalysis:
    """A named per-function analysis.  Subclasses set ``name`` and implement
    ``run(func, am)``; ``am`` lets an analysis pull other cached analyses
    (e.g. the dependence graph consumes loop info and memory touches)."""

    name: str = ""

    @staticmethod
    def run(func: FuncOp, am: "AnalysisManager") -> Any:
        raise NotImplementedError


ANALYSIS_REGISTRY: dict[str, Type[FunctionAnalysis]] = {}


def register_analysis(cls: Type[FunctionAnalysis]) -> Type[FunctionAnalysis]:
    """Class decorator: adds ``cls`` to the analysis registry under its
    ``name``."""
    assert cls.name, f"{cls} needs an analysis name"
    ANALYSIS_REGISTRY[cls.name] = cls
    return cls


def _ensure_analyses_registered() -> None:
    # built-in analyses live in core.analysis; import lazily (cycle-free).
    if "loop-info" not in ANALYSIS_REGISTRY:
        from . import analysis  # noqa: F401


@dataclass
class AnalysisStatistics:
    """Per-analysis cache counters."""

    name: str
    computed: int = 0
    hits: int = 0
    invalidated: int = 0

    def as_dict(self) -> dict:
        return {"computed": self.computed, "hits": self.hits,
                "invalidated": self.invalidated}


class AnalysisManager:
    """Construct-on-demand, per-function analysis cache with explicit
    invalidation (the MLIR AnalysisManager shape).

    ``get(analysis, func)``   returns the cached result or computes it;
    ``invalidate(...)``       drops cached entries, keeping only the analyses
                              named in ``preserve`` (or everything when
                              ``preserve_all``);
    ``stats`` / ``stats_dict()``  cache hit/miss/invalidation counters, the
                              numbers ``benchmarks/codegen_speed.py`` reports.
    """

    def __init__(self):
        self._cache: dict[tuple[int, str], Any] = {}
        self._funcs: dict[int, FuncOp] = {}  # keep keys meaningful for func=
        self.stats: dict[str, AnalysisStatistics] = {}

    @staticmethod
    def _resolve(analysis: Union[str, Type[FunctionAnalysis]]) -> Type[FunctionAnalysis]:
        if isinstance(analysis, str):
            _ensure_analyses_registered()
            if analysis not in ANALYSIS_REGISTRY:
                known = ", ".join(sorted(ANALYSIS_REGISTRY))
                raise ValueError(f"unknown analysis {analysis!r} (registered: {known})")
            return ANALYSIS_REGISTRY[analysis]
        return analysis

    def _stat(self, name: str) -> AnalysisStatistics:
        st = self.stats.get(name)
        if st is None:
            st = self.stats[name] = AnalysisStatistics(name)
        return st

    # -- queries ------------------------------------------------------------
    def get(self, analysis: Union[str, Type[FunctionAnalysis]], func: FuncOp) -> Any:
        cls = self._resolve(analysis)
        key = (id(func), cls.name)
        st = self._stat(cls.name)
        if key in self._cache:
            st.hits += 1
            return self._cache[key]
        result = cls.run(func, self)
        st.computed += 1
        self._cache[key] = result
        self._funcs[id(func)] = func
        return result

    def cached(self, analysis: Union[str, Type[FunctionAnalysis]], func: FuncOp) -> Optional[Any]:
        """The cached result if present (no computation, no hit counted)."""
        cls = self._resolve(analysis)
        return self._cache.get((id(func), cls.name))

    # -- invalidation --------------------------------------------------------
    def invalidate(self, func: Optional[FuncOp] = None,
                   preserve: Sequence[str] = (), preserve_all: bool = False) -> int:
        """Drop cached analyses (all funcs, or just ``func``), keeping those
        named in ``preserve``.  Returns the number of dropped entries."""
        if preserve_all:
            return 0
        keep = set(preserve)
        dropped = 0
        for key in list(self._cache):
            fid, name = key
            if func is not None and fid != id(func):
                continue
            if name in keep:
                continue
            del self._cache[key]
            self._stat(name).invalidated += 1
            dropped += 1
        # release func pins with no remaining cached results (the pin only
        # exists to keep id() stable while a result is cached)
        live = {fid for (fid, _name) in self._cache}
        for fid in list(self._funcs):
            if fid not in live:
                del self._funcs[fid]
        return dropped

    # -- reporting ----------------------------------------------------------
    def stats_dict(self) -> dict:
        """JSON-able counters: per-analysis computed/hits/invalidated plus
        totals (``hits`` > 0 means at least one analysis was reused)."""
        per = {name: st.as_dict() for name, st in sorted(self.stats.items())}
        return {
            "per_analysis": per,
            "computed": sum(st.computed for st in self.stats.values()),
            "hits": sum(st.hits for st in self.stats.values()),
            "invalidated": sum(st.invalidated for st in self.stats.values()),
        }


# ---------------------------------------------------------------------------
# Pass base classes
# ---------------------------------------------------------------------------


class Pass:
    """Base class for all passes.  ``name`` is the spec name; ``run`` applies
    the pass to a module and returns the number of rewrites performed.

    ``preserves`` names the analyses whose cached results remain valid even
    when this pass rewrites the IR (e.g. a pass that never moves schedules
    preserves ``"loop-info"``); ``preserves_all`` marks passes that cannot
    invalidate anything (attribute-only rewrites).  A pass that reports 0
    rewrites implicitly preserves everything.  The PassManager injects its
    ``AnalysisManager`` as ``self.am`` before each run; passes fetch cached
    analyses through ``self.get_analysis``."""

    name: str = ""
    preserves: tuple[str, ...] = ()
    preserves_all: bool = False
    am: Optional[AnalysisManager] = None

    def run(self, module: Module) -> int:
        raise NotImplementedError

    def get_analysis(self, analysis: Union[str, Type[FunctionAnalysis]], func: FuncOp) -> Any:
        """Cached analysis lookup; standalone pass instances (run outside a
        PassManager) get a private AnalysisManager on first use."""
        if self.am is None:
            self.am = AnalysisManager()
        return self.am.get(analysis, func)

    # convenience shared by subclasses
    @staticmethod
    def each_func(module: Module):
        for f in module.funcs.values():
            if not f.attrs.get("external"):
                yield f


class PatternRewritePass(Pass):
    """A pass expressed as rewrite patterns, driven by the greedy worklist
    rewriter over each function body.  Subclasses implement ``patterns``
    (optionally per-function, for patterns that need function-level context
    such as the set of loop induction variables)."""

    def patterns(self, func: FuncOp) -> RewritePatternSet:
        raise NotImplementedError

    def run(self, module: Module) -> int:
        n = 0
        for f in self.each_func(module):
            n += apply_patterns_greedily(f.body, self.patterns(f))
        return n


class ModuleFnPass(Pass):
    """Adapter wrapping a legacy ``Callable[[Module], int]`` as a Pass."""

    def __init__(self, fn: Callable[[Module], int], name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "anonymous")

    def run(self, module: Module) -> int:
        return self.fn(module)


# ---------------------------------------------------------------------------
# Registry + textual pipeline specs
# ---------------------------------------------------------------------------

PASS_REGISTRY: dict[str, Type[Pass]] = {}


def _canon(name: str) -> str:
    return name.strip().replace("_", "-")


def register_pass(cls: Type[Pass]) -> Type[Pass]:
    """Class decorator: adds ``cls`` to the registry under ``cls.name``."""
    assert cls.name, f"{cls} needs a spec name"
    PASS_REGISTRY[_canon(cls.name)] = cls
    return cls


def _ensure_registry_populated() -> None:
    # Pass classes live next to their implementations; importing the passes
    # package registers all of them (lazy to avoid an import cycle).  Keyed
    # on a known HIR pass, not registry emptiness: the RTL passes register
    # themselves when core.codegen.rtl is imported first, and a non-empty
    # registry must not mask the still-unloaded HIR passes.
    if "canonicalize" not in PASS_REGISTRY:
        from . import passes  # noqa: F401


def create_pass(name: str) -> Pass:
    """Instantiate a registered pass by spec name."""
    _ensure_registry_populated()
    key = _canon(name)
    if key not in PASS_REGISTRY:
        known = ", ".join(sorted(PASS_REGISTRY))
        raise ValueError(f"unknown pass {name!r} in pipeline spec (registered: {known})")
    return PASS_REGISTRY[key]()


def parse_pipeline_spec(spec: str) -> list[Pass]:
    """Parse ``"canonicalize,cse,strength-reduce"`` into pass instances.
    Empty segments are rejected; unknown names raise ``ValueError``."""
    names = [s.strip() for s in spec.split(",")]
    if any(not s for s in names) or not names:
        raise ValueError(f"malformed pipeline spec {spec!r}")
    return [create_pass(n) for n in names]


# The default optimization pipeline (paper-benchmark order; matches the
# seed's DEFAULT_PIPELINE).
DEFAULT_PIPELINE_SPEC = ("canonicalize,constprop,cse,strength-reduce,"
                         "precision-opt,delay-elim,port-demotion,dce")

# The pre-codegen lowering pipeline: hierarchy flattening + unroll expansion.
CODEGEN_PIPELINE_SPEC = "inline,unroll"

# The schedule-transform pipeline: pipeline sequential loops to their minimum
# legal II, shrink the combinational chains (strength-reduce before retime:
# const-mults become cheap shifts, so delay hoists fit the clock budget),
# retime the delay chains, then clean up.
SCHEDULE_PIPELINE_SPEC = "pipeline-loop,strength-reduce,canonicalize,retime,cse"


# ---------------------------------------------------------------------------
# PassManager
# ---------------------------------------------------------------------------


@dataclass
class PassStatistics:
    """Per-pass counters accumulated across a PassManager run."""

    name: str
    invocations: int = 0
    rewrites: int = 0
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        return {"invocations": self.invocations, "rewrites": self.rewrites,
                "wall_s": round(self.wall_s, 6)}


class PassManager:
    """Runs an ordered pass pipeline over a module.

    ``fixpoint``        re-run the whole pipeline until no pass reports a
                        rewrite (bounded by ``max_iterations``) — pattern
                        passes converge internally, but one pass can unlock
                        another (constprop feeding cse), so a short outer
                        loop remains useful;
    ``verify_each``     run the IR verifier after every pass and raise on
                        the first error (debugging aid);
    ``statistics``      list of ``PassStatistics``, one per pipeline entry,
                        filled by ``run``;
    ``analysis_manager``  the shared ``AnalysisManager`` injected into every
                        pass (``self.am``) and invalidated per the pass's
                        ``preserves`` declaration after each rewriting run.
                        Pass one in to share cached analyses with the
                        verifier and codegen; a fresh one is created
                        otherwise.
    """

    def __init__(self, passes: Sequence[Union[Pass, str, Callable[[Module], int]]] = (),
                 *, fixpoint: bool = True, max_iterations: int = 3,
                 verify_each: bool = False,
                 analysis_manager: Optional[AnalysisManager] = None):
        self.passes: list[Pass] = [self._as_pass(p) for p in passes]
        self.fixpoint = fixpoint
        self.max_iterations = max_iterations
        self.verify_each = verify_each
        self.analysis_manager = analysis_manager or AnalysisManager()
        self.statistics: list[PassStatistics] = []
        self.iterations_run = 0

    # -- construction -------------------------------------------------------
    @staticmethod
    def _as_pass(p: Union[Pass, str, Callable[[Module], int]]) -> Pass:
        if isinstance(p, Pass):
            return p
        if isinstance(p, str):
            return create_pass(p)
        if callable(p):
            return ModuleFnPass(p)
        raise TypeError(f"not a pass: {p!r}")

    def add(self, p: Union[Pass, str, Callable[[Module], int]]) -> "PassManager":
        self.passes.append(self._as_pass(p))
        return self

    @classmethod
    def from_spec(cls, spec: str, **kwargs) -> "PassManager":
        return cls(parse_pipeline_spec(spec), **kwargs)

    @property
    def spec(self) -> str:
        return ",".join(p.name for p in self.passes)

    # -- running ------------------------------------------------------------
    def run(self, module: Module) -> dict[str, int]:
        """Run the pipeline.  Returns ``{pass_name: rewrites}`` with
        underscored names (the shape the seed's ``run_pipeline`` returned);
        full statistics (timing, invocations) are on ``self.statistics``."""
        self.statistics = [PassStatistics(p.name) for p in self.passes]
        self.iterations_run = 0
        iters = self.max_iterations if self.fixpoint else 1
        # clean-pass skipping: a pass that reported 0 rewrites is a
        # deterministic no-op until some other pass rewrites the module, so
        # re-running it in a later fixpoint iteration is pure waste.
        total = 0                       # module version: rewrites so far
        seen_at: dict[int, int] = {}    # pass idx -> version after last run
        last_n: dict[int, int] = {}     # pass idx -> rewrites of last run
        for _ in range(max(1, iters)):
            self.iterations_run += 1
            changed = 0
            for i, (p, st) in enumerate(zip(self.passes, self.statistics)):
                if seen_at.get(i) == total and last_n.get(i) == 0:
                    continue  # clean and module untouched since: skip
                p.am = self.analysis_manager
                t0 = time.perf_counter()
                n = p.run(module)
                st.wall_s += time.perf_counter() - t0
                st.invocations += 1
                st.rewrites += n
                total += n
                seen_at[i], last_n[i] = total, n
                changed += n
                if n:  # 0 rewrites preserves every cached analysis
                    self.analysis_manager.invalidate(
                        preserve=p.preserves, preserve_all=p.preserves_all)
                if self.verify_each:
                    self._verify(module, after=p.name)
            if changed == 0:
                break
        out: dict[str, int] = {}
        for st in self.statistics:
            key = st.name.replace("-", "_")
            out[key] = out.get(key, 0) + st.rewrites
        return out

    def _verify(self, module: Module, after: str) -> None:
        from .verifier import verify

        diags = verify(module, strict_schedule=False, raise_on_error=False,
                       am=self.analysis_manager)
        errs = [d for d in diags if d.severity == "error"]
        if errs:
            msgs = "\n".join(d.render() for d in errs)
            raise RuntimeError(f"verifier failed after pass '{after}':\n{msgs}")

    # -- reporting ----------------------------------------------------------
    def stats_dict(self) -> dict[str, dict]:
        """JSON-able per-pass statistics of the last ``run``."""
        out: dict[str, dict] = {}
        for st in self.statistics:
            if st.name in out:  # same pass listed twice in one pipeline
                prev = out[st.name]
                prev["invocations"] += st.invocations
                prev["rewrites"] += st.rewrites
                prev["wall_s"] = round(prev["wall_s"] + st.wall_s, 6)
            else:
                out[st.name] = st.as_dict()
        return out

    def render_stats(self) -> str:
        """Human-readable per-pass statistics table."""
        lines = [f"{'pass':18s} {'runs':>5s} {'rewrites':>9s} {'wall(ms)':>9s}"]
        for st in self.statistics:
            lines.append(f"{st.name:18s} {st.invocations:5d} {st.rewrites:9d} "
                         f"{st.wall_s * 1e3:9.2f}")
        return "\n".join(lines)
