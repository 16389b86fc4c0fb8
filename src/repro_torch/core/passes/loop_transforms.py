"""Pre-scheduling loop restructuring: tiling and interchange.

These transforms run on *unscheduled* (erased) HIR — they are design-space
knobs applied before the HLS schedule search (ScaleHLS-style), not schedule
transforms: tiling splits an innermost sequential loop into an outer/inner
nest so the scheduler pipelines a shorter inner body, and interchange swaps
a perfect 2-deep nest to move a different induction variable innermost
(changing which accesses are loop-carried).

Neither transform proves legality from dependence analysis; the DSE
containment does that end-to-end — every candidate's simulation output is
checked against the source-module oracle, and a restructuring that changes
results is scored out of the Pareto front (``verified=False``) instead of
silently shipping.  Tiling is always iteration-order-preserving (hence
always legal); interchange is the speculative one.
"""

from __future__ import annotations

from .. import ir
from ..ir import ForOp, Module, Region

__all__ = ["tile_innermost", "interchange_loops", "Tile", "Interchange"]


# ---------------------------------------------------------------------------
# Tiling
# ---------------------------------------------------------------------------


def tile_innermost(module: Module, factor: int) -> int:
    """Tile every innermost sequential ``hir.for`` whose constant trip count
    divides evenly: ``for i in [lb, ub, s)`` becomes

        for i_o in [0, trip/factor):
          for i_i in [0, factor):
            i = lb + (i_o*factor + i_i)*s

    with the body moved into the inner loop and the induction variable
    recomputed — same iteration order, so semantics are preserved exactly.
    Loops with unknown bounds, non-dividing trips, or trivial outer trips
    are left alone.  Returns the number of loops tiled."""
    if factor < 2:
        return 0
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        n += _tile_region(f.body, factor)
    return n


def _tile_region(region: Region, factor: int) -> int:
    n = 0
    for op in list(region.ops):
        if not isinstance(op, ForOp):
            continue
        if any(isinstance(o, ForOp) for o in op.region(0).ops):
            n += _tile_region(op.region(0), factor)
        elif op.opname == "for":  # unroll_for is a spatial knob, not temporal
            n += _tile_loop(region, op, factor)
    return n


def _tile_loop(parent: Region, loop: ForOp, factor: int) -> int:
    trip = loop.trip_count()
    lb = ir.const_value(loop.lb)
    step = ir.const_value(loop.step)
    if (trip is None or lb is None or step is None
            or trip % factor or trip // factor < 2):
        return 0
    ivt = loop.iv.type

    c0 = ir.constant(0, name=f"{loop.iv.name}_t0")
    c1 = ir.constant(1, name=f"{loop.iv.name}_t1")
    cf = ir.constant(factor, name=f"{loop.iv.name}_tf")
    ct = ir.constant(trip // factor, name=f"{loop.iv.name}_tn")
    outer = ForOp(c0.result, ct.result, c1.result, start=None, iv_type=ivt,
                  iv_name=f"{loop.iv.name}_o", tv_name=f"{loop.time_var.name}_o",
                  loc=loop.loc)
    inner = ForOp(c0.result, cf.result, c1.result, start=None, iv_type=ivt,
                  iv_name=f"{loop.iv.name}_i", tv_name=f"{loop.time_var.name}_i",
                  loc=loop.loc)
    outer.region(0).add(inner)

    # i = lb + (i_o*factor + i_i)*step, computed at the top of the inner body
    t = ir.arith("mult", [outer.iv, cf.result], loc=loop.loc)
    inner.region(0).add(t)
    t2 = ir.arith("add", [t.result, inner.iv], loc=loop.loc)
    inner.region(0).add(t2)
    iv_val = t2.result
    if step != 1:
        t3 = ir.arith("mult", [iv_val, loop.step], loc=loop.loc)
        inner.region(0).add(t3)
        iv_val = t3.result
    if lb != 0:
        t4 = ir.arith("add", [iv_val, loop.lb], loc=loop.loc)
        inner.region(0).add(t4)
        iv_val = t4.result
    iv_val.name = loop.iv.name

    moved = [o for o in loop.region(0).ops if o.opname != "yield"]
    for o in moved:
        inner.region(0).add(o)
    loop.iv.replace_all_uses_with(iv_val)
    loop.time_var.replace_all_uses_with(inner.time_var)
    loop.end_time.replace_all_uses_with(outer.end_time)

    i = parent.ops.index(loop)
    parent.remove(loop)
    # Region.add reparents but does not unlink — scrub the moved ops from the
    # old shell before drop_all_uses recurses into it.
    loop.regions[0].ops = [o for o in loop.regions[0].ops if o not in moved]
    loop.drop_all_uses()
    for k, op in enumerate((c0, c1, cf, ct, outer)):
        parent.insert(i + k, op)
    return 1


# ---------------------------------------------------------------------------
# Interchange
# ---------------------------------------------------------------------------


def interchange_loops(module: Module) -> int:
    """Swap every perfect 2-deep sequential ``hir.for`` nest (outer body =
    constants + one inner loop): the inner induction variable becomes the
    outer one and vice versa.  Rectangular nests only — a nest whose inner
    bounds depend on the outer IV is skipped.  Legality is *not* proven
    here; the DSE sim-verification contains illegal swaps (see module
    docstring).  Returns the number of nests swapped."""
    n = 0
    for f in module.funcs.values():
        if f.attrs.get("external"):
            continue
        n += _interchange_region(f.body)
    return n


def _interchange_region(region: Region) -> int:
    n = 0
    for op in list(region.ops):
        if not isinstance(op, ForOp) or op.opname != "for":
            continue
        inner = _perfect_inner(op)
        if inner is not None and _rectangular(op, inner):
            _swap_nest(region, op, inner)
            n += 1  # the swapped nest is not re-visited (it would swap back)
        else:
            n += _interchange_region(op.region(0))
    return n


def _perfect_inner(outer: ForOp):
    body = [o for o in outer.region(0).ops
            if o.opname not in ("constant", "yield")]
    if len(body) == 1 and isinstance(body[0], ForOp) and body[0].opname == "for":
        return body[0]
    return None


def _rectangular(outer: ForOp, inner: ForOp) -> bool:
    """Inner bounds must not be computed from the outer IV (or anything else
    defined inside the outer body except constants)."""
    for v in (inner.lb, inner.ub, inner.step):
        if v is outer.iv:
            return False
        d = v.defining_op
        if (d is not None and d.opname != "constant"
                and d.parent_region is outer.region(0)):
            return False
    return True


def _swap_nest(parent: Region, outer: ForOp, inner: ForOp) -> None:
    new_outer = ForOp(inner.lb, inner.ub, inner.step, start=None,
                      iv_type=inner.iv.type, iv_name=inner.iv.name,
                      tv_name=inner.time_var.name, loc=inner.loc)
    new_inner = ForOp(outer.lb, outer.ub, outer.step, start=None,
                      iv_type=outer.iv.type, iv_name=outer.iv.name,
                      tv_name=outer.time_var.name, loc=outer.loc)
    new_outer.region(0).add(new_inner)
    moved = [o for o in inner.region(0).ops if o.opname != "yield"]
    for o in moved:
        new_inner.region(0).add(o)
    inner.iv.replace_all_uses_with(new_outer.iv)
    outer.iv.replace_all_uses_with(new_inner.iv)
    inner.time_var.replace_all_uses_with(new_inner.time_var)
    outer.time_var.replace_all_uses_with(new_outer.time_var)
    inner.end_time.replace_all_uses_with(new_inner.end_time)
    outer.end_time.replace_all_uses_with(new_outer.end_time)

    hoisted = [o for o in outer.region(0).ops if o.opname == "constant"]
    i = parent.ops.index(outer)
    parent.remove(outer)
    # Scrub relocated ops from the old shells so drop_all_uses only erases
    # the discarded loop ops and their yields (Region.add does not unlink).
    inner.regions[0].ops = [o for o in inner.regions[0].ops if o not in moved]
    outer.regions[0].ops = [o for o in outer.regions[0].ops
                            if o is not inner and o not in hoisted]
    inner.drop_all_uses()
    outer.drop_all_uses()
    for k, op in enumerate(hoisted + [new_outer]):
        parent.insert(i + k, op)


from ..passmgr import Pass, register_pass  # noqa: E402


@register_pass
class Tile(Pass):
    """Innermost-loop tiling (default factor 2; the DSE drives
    ``tile_innermost`` directly with per-candidate factors)."""

    name = "tile"
    factor = 2

    def run(self, module: Module) -> int:
        return tile_innermost(module, self.factor)


@register_pass
class Interchange(Pass):
    """Perfect-nest loop interchange (speculative; sim-verified by the DSE)."""

    name = "interchange"

    def run(self, module: Module) -> int:
        return interchange_loops(module)
