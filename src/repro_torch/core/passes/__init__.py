"""HIR optimization passes (paper §6.2–§6.4), on the ``core.passmgr`` /
``core.rewrite`` compiler infrastructure.

Registered passes (spec names in parentheses — use them in
``PassManager.from_spec("...")`` pipeline specs):

  * canonicalize    (``canonicalize``)    — commutative-operand ordering +
                     identity folds (x+0, x*1), as worklist rewrite patterns
  * constprop       (``constprop``)       — compile-time constant folding;
                     the worklist driver cascades through constant chains
  * cse             (``cse``)             — common-subexpression elimination
                     on pure ops (scoped hash table, O(#uses) replacement)
  * strength_reduce (``strength-reduce``) — const-mult -> shift/shift-add;
                     IV*const -> scaled counter; const-div -> shift
  * precision_opt   (``precision-opt``)   — bitwidth narrowing from
                     loop-bound range analysis
  * delay_elim      (``delay-elim``)      — zero-delay forwarding (pattern)
                     + shift-register chain sharing
  * port_demotion   (``port-demotion``)   — dual-port -> single-port RAM
                     when schedules are provably disjoint (paper §2)
  * dce             (``dce``)             — dead pure-op removal driven by
                     the maintained use-def chains
  * inline_calls    (``inline``)          — module-hierarchy flattening
                     (pre-codegen)
  * unroll_loops    (``unroll``)          — full hir.unroll_for expansion
                     (pre-codegen)
  * pipeline_loops  (``pipeline-loop``)   — minimum-II modulo pipelining of
                     sequential innermost loops (schedule transform)
  * tile_innermost  (``tile``)            — innermost-loop tiling on erased
                     HIR (DSE structural knob)
  * interchange_loops (``interchange``)   — perfect-nest loop interchange on
                     erased HIR (speculative; DSE sim-verified)
  * retime          (``retime``)          — delay hoisting across
                     combinational ops (shift-register sharing)

Each pass also remains importable as a plain ``Callable[[Module], int]``
(``canonicalize(module)`` etc.) for direct use and unit tests.

``run_pipeline(module)`` is a thin compatibility shim over ``PassManager``:
prefer ``PassManager.from_spec(DEFAULT_PIPELINE_SPEC)``, which exposes
per-pass timing/rewrite statistics and declarative pipeline selection.
``passes.legacy_sweep`` preserves the seed's O(region²) fixpoint sweep purely
as the baseline measured by ``benchmarks/codegen_speed.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..ir import Module
from ..passmgr import (CODEGEN_PIPELINE_SPEC, DEFAULT_PIPELINE_SPEC,
                       SCHEDULE_PIPELINE_SPEC, AnalysisManager,
                       FunctionAnalysis, Pass, PassManager, PassStatistics,
                       create_pass, parse_pipeline_spec, register_analysis)
from .canonicalize import Canonicalize, ConstProp, DCE, canonicalize, constprop, dce
from .cse import CSE, cse
from .delay_elim import DelayElim, delay_elim
from .port_demotion import PortDemotion, port_demotion
from .precision_opt import PrecisionOpt, precision_opt
from .strength_reduce import StrengthReduce, strength_reduce
from .inline import Inline, inline_calls
from .unroll import Unroll, unroll_loops
from .schedule_transforms import PipelineLoop, Retime, pipeline_loops, retime
from .loop_transforms import (Interchange, Tile, interchange_loops,
                              tile_innermost)

#: Legacy list-of-callables form of the default pipeline (kept for direct
#: imports; the declarative form is ``DEFAULT_PIPELINE_SPEC``).
DEFAULT_PIPELINE: list[Callable[[Module], int]] = [
    canonicalize,
    constprop,
    cse,
    strength_reduce,
    precision_opt,
    delay_elim,
    port_demotion,
    dce,
]


def run_pipeline(module: Module, passes: Optional[list[Callable[[Module], int]]] = None,
                 max_iters: int = 3) -> dict[str, int]:
    """Compatibility shim over ``PassManager``: run ``passes`` (default: the
    paper-benchmark pipeline) to a bounded fixpoint; returns per-pass rewrite
    counts keyed by pass function name."""
    if passes is None:
        pm = PassManager.from_spec(DEFAULT_PIPELINE_SPEC, max_iterations=max_iters)
    else:
        pm = PassManager(list(passes), max_iterations=max_iters)
    return pm.run(module)


__all__ = [
    "run_pipeline",
    "DEFAULT_PIPELINE",
    "DEFAULT_PIPELINE_SPEC",
    "CODEGEN_PIPELINE_SPEC",
    "SCHEDULE_PIPELINE_SPEC",
    "AnalysisManager",
    "FunctionAnalysis",
    "register_analysis",
    "Pass",
    "PassManager",
    "PassStatistics",
    "create_pass",
    "parse_pipeline_spec",
    "canonicalize",
    "constprop",
    "cse",
    "strength_reduce",
    "precision_opt",
    "delay_elim",
    "port_demotion",
    "dce",
    "unroll_loops",
    "inline_calls",
    "pipeline_loops",
    "retime",
    "tile_innermost",
    "interchange_loops",
    "Tile",
    "Interchange",
    "Canonicalize",
    "ConstProp",
    "CSE",
    "StrengthReduce",
    "PrecisionOpt",
    "DelayElim",
    "PortDemotion",
    "DCE",
    "Inline",
    "Unroll",
    "PipelineLoop",
    "Retime",
]
