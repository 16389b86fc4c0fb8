"""Call inlining (module-hierarchy flattening).

Internal ``hir.call`` sites are replaced by a clone of the callee body with

  * formals bound to actuals (memrefs alias the caller's storage — so state
    passed by memref stays shared across call instances),
  * the callee's root time variable rebased to the call's start time,
  * results bound to the callee's returned values.

Internal allocs are replicated per call site, which matches the paper's §4.5
semantics (no persistent function-local state across calls).  External
(blackbox Verilog) calls are left intact — they become module instantiations.

This runs before Verilog codegen so memref plumbing across the hierarchy
becomes ordinary same-module wiring.
"""

from __future__ import annotations

from .. import ir
from ..ir import FuncOp, Module, Operation, Region, Time, Value
from .unroll import _clone_op


def _inline_region(module: Module, func: FuncOp, region: Region,
                   only: set[str] | None = None) -> int:
    n = 0
    new_ops: list[Operation] = []
    for op in region.ops:
        for r in op.regions:
            n += _inline_region(module, func, r, only)
        if op.opname == "call":
            callee = module.funcs.get(op.attrs["callee"])
            if (callee is not None and not callee.attrs.get("external")
                    and (only is None or callee.name in only)):
                assert op.start is not None, "call must be scheduled"
                vmap: dict[Value, Value] = {}
                for formal, actual in zip(callee.args, op.operands):
                    vmap[formal] = actual
                tmap = {callee.time_var: (op.start.tv, op.start.offset)}
                ret_vals: list[Value] = []
                clones: list[Operation] = []
                for b in callee.body.ops:
                    if b.opname == "return":
                        ret_vals = list(b.operands)
                        continue
                    c = _clone_op(b, vmap, tmap)
                    c.parent_region = region
                    clones.append(c)
                from .unroll import _remap_operands

                _remap_operands(clones, vmap)
                new_ops.extend(clones)
                # bind call results to the cloned returned values
                for res, rv in zip(op.results, ret_vals):
                    res.replace_all_uses_with(vmap.get(rv, rv))
                op.drop_all_uses()  # the call op is replaced by the clones
                n += 1
                continue
        new_ops.append(op)
    region.ops[:] = new_ops
    return n


def inline_calls(module: Module, entry: str | None = None,
                 only: set[str] | None = None) -> int:
    """Inline internal calls (transitively).  ``only`` restricts inlining to
    the named callees (hierarchical emission uses this to flatten trivial
    functions while keeping non-trivial ones as modules).  Returns call
    sites inlined."""
    total = 0
    for _ in range(16):  # bounded transitive inlining
        n = 0
        for f in module.funcs.values():
            if f.attrs.get("external"):
                continue
            n += _inline_region(module, f, f.body, only)
        total += n
        if n == 0:
            break
    return total


from ..passmgr import Pass, register_pass  # noqa: E402


@register_pass
class Inline(Pass):
    """Module-hierarchy flattening (pre-codegen)."""

    name = "inline"

    def run(self, module: Module) -> int:
        return inline_calls(module)
