"""PyTorch -> HIR frontend tracer (the mirror image of ``lower/to_torch.py``).

``trace(fn, in_shapes, name=...)`` traces a restricted integer PyTorch
program into its aten graph (``torch.fx.experimental.proxy_tensor.make_fx``
on int32 example tensors, on the host) and rebuilds it as an ``hir.func``:
every aten node becomes a bounded ``hir.for`` nest over the HIR memref
holding its result —

  * elementwise operators -> one loop nest per node (read operands, one
    arith chain, write the destination buffer);
  * ``sum`` / ``amax`` / ``amin`` -> an init nest plus a read-modify-write
    reduction nest (the histogram idiom);
  * ``cumsum`` -> a sequential recurrence loop through a register
    accumulator (the fifo/mac idiom);
  * ``mm`` (2-D matmul) -> a tiled i/jo/k/ji nest calling a shared
    combinational ``mac`` function, with a ``(tile,)`` register accumulator
    bank — the PE-array idiom of the gallery GEMM, with the column tile as
    the frontend's loop-level design knob;
  * ``expand`` -> a zero-cost index-remapping view.

Each aten node is first rewritten as the equation of the primitive it
computes (``_ATEN``: ``mm`` is ``dot_general``, ``where`` is ``select_n``
with its arms swapped, ``clamp(max=)`` is ``min``, ...), and the equations
go through the same emitters, in the same order and with the same buffer
tags, as a jaxpr's; so a program and its jax.numpy twin give one design.

The tracer emits a *naive* sequential schedule whose only job is to pin the
program order (every op gets a monotone time offset), then hands the design
to the HLS pipeline: ``erase_schedule`` + ``hls_schedule`` produce the real
schedule, so traced designs share the exact verification/codegen path as
the hand-written gallery.  Tracing is a compile step on the CPU; the traced
design then runs wherever the caller lowers it.

Dtype policy: integer-only (int32 data, bools as 0/1 i32).  Anything float
raises ``FrontendError``, and so does an int64 value (write
``torch.sum(x, dtype=torch.int32)``: the reduction would promote to int64).
Division is floor division (``torch.div(..., rounding_mode="floor")`` or
``//``), as HIR ``div`` is; truncating and true division raise.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import ir
from ..builder import Builder


class FrontendError(NotImplementedError):
    """The traced program falls outside the supported PyTorch subset."""


class UnsupportedPrimitiveError(FrontendError):
    """An aten node uses an operator the frontend cannot lower."""


# --------------------------------------------------------------------------
# traced values


class _Const:
    """Rank-0 integer literal."""

    __slots__ = ("v",)
    shape: tuple = ()

    def __init__(self, v):
        self.v = int(v)


class _Buf:
    """A (possibly index-remapped view of a) memref read port."""

    __slots__ = ("rd", "shape", "index")

    def __init__(self, rd, shape, index=None):
        self.rd = rd
        self.shape = tuple(shape)
        self.index = index if index is not None else (lambda ids: list(ids))


class _Alloc:
    """A local buffer: read + write ports plus the memref index mapping
    (rank-0 values live in a shape-(1,) register)."""

    __slots__ = ("rd", "wr", "shape")

    def __init__(self, rd, wr, shape):
        self.rd = rd
        self.wr = wr
        self.shape = tuple(shape)

    def midx(self, ids):
        return list(ids) if self.shape else [0]

    def view(self) -> _Buf:
        return _Buf(self.rd, self.shape, index=self.midx)


# --------------------------------------------------------------------------
# elementwise primitive table: jax primitive name -> emitter(tr, *scalars)

def _ew(opname: str):
    return lambda tr, *xs: tr.arith(opname, *xs)


def _cmp(kind: str):
    def f(tr, a, b):
        return tr.b.zext(tr.b.cmp(kind, a, b, at=tr.tick()), ir.i32,
                         at=tr.tick())
    return f


def _minmax(kind: str):
    def f(tr, a, b):
        c = tr.b.cmp(kind, a, b, at=tr.tick())
        # explicit i32 result: the default type inference picks the first
        # primitive operand, which here is the 1-bit compare
        return tr.b._arith("select", c, a, b, at=tr.tick(),
                           result_type=ir.i32)
    return f


_ELEMENTWISE: dict[str, Callable] = {
    "add": _ew("add"),
    "sub": _ew("sub"),
    "mul": _ew("mult"),
    "div": _ew("div"),
    "and": _ew("and"),
    "or": _ew("or"),
    "xor": _ew("xor"),
    "shift_left": _ew("shl"),
    "shift_right_arithmetic": _ew("shr"),
    "neg": lambda tr, a: tr.b.sub(0, a, at=tr.tick()),
    "max": _minmax("ge"),
    "min": _minmax("le"),
    "lt": _cmp("lt"),
    "le": _cmp("le"),
    "eq": _cmp("eq"),
    "ne": _cmp("ne"),
    "gt": _cmp("gt"),
    "ge": _cmp("ge"),
    # select_n picks cases[pred]; hir.select picks a when cond != 0
    "select_n": lambda tr, p, c0, c1: tr.b._arith(
        "select", p, c1, c0, at=tr.tick(), result_type=ir.i32),
}

#: primitives that are identity at the integer-only level
_IDENTITY = ("convert_element_type", "stop_gradient", "copy")

_REDUCE_INIT = {"reduce_sum": 0, "reduce_max": -(1 << 30),
                "reduce_min": (1 << 30)}


# --------------------------------------------------------------------------
# the aten graph as the reference's equations


class _Aval:
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


class _Var:
    """A value of the aten graph, as a jaxpr variable: ``aval`` holds the
    shape and dtype of the node's ``meta["val"]``."""

    __slots__ = ("aval",)

    def __init__(self, shape, dtype):
        self.aval = _Aval(shape, dtype)


class _Lit:
    """A literal operand: a Python number of an aten call, a
    ``scalar_tensor`` or a tensor constant of the traced module."""

    __slots__ = ("val",)

    def __init__(self, val):
        self.val = val


class _Prim:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


class _Eqn:
    """One primitive application: the reference's ``JaxprEqn`` fields, and
    the aten operator it came from (``op``)."""

    __slots__ = ("primitive", "invars", "outvars", "params", "op")

    def __init__(self, prim: str, invars, outvars, params=None, op: str = ""):
        self.primitive = _Prim(prim)
        self.invars = list(invars)
        self.outvars = list(outvars)
        self.params = params or {}
        self.op = op


def _plain(prim: str, reverse: bool = False):
    """An aten call whose (first two) tensor and number arguments are the
    primitive's operands (``reverse``: in the other order, as ``rsub``)."""
    def make(g, node, out):
        args = [g.atom(a) for a in node.args[:2]]
        if node.kwargs.get("alpha", 1) != 1:
            raise UnsupportedPrimitiveError(
                f"frontend: '{g.op(node)}' with alpha={node.kwargs['alpha']} is not supported")
        return [g.eqn(prim, reversed(args) if reverse else args, out, node)]
    return make


def _where(g, node, out):
    # where(c, x, y) is select_n(c, y, x): select_n picks cases[pred]
    cond, x, y = (g.atom(a) for a in node.args)
    return [g.eqn("select_n", [cond, y, x], out, node)]


def _clamp(g, node, out):
    # clamp(x, min, max) is min(max(x, lo), hi), as jnp.clip; each bound may be absent
    x = g.atom(node.args[0])
    lo = node.args[1] if len(node.args) > 1 else node.kwargs.get("min")
    hi = node.args[2] if len(node.args) > 2 else node.kwargs.get("max")
    if lo is None and hi is None:
        return [g.eqn("copy", [x], out, node)]
    eqns = []
    if lo is not None:
        mid = out if hi is None else _Var(out.aval.shape, out.aval.dtype)
        eqns.append(g.eqn("max", [x, g.atom(lo)], mid, node))
        x = mid
    if hi is not None:
        eqns.append(g.eqn("min", [x, g.atom(hi)], out, node))
    return eqns


def _floor_div(g, node, out):
    mode = node.kwargs.get("rounding_mode", "floor" if "floor_divide" in g.op(node) else None)
    if mode != "floor":
        raise UnsupportedPrimitiveError(
            f"frontend: '{g.op(node)}' with rounding_mode={mode!r} is not supported: HIR "
            "div is floor division, which differs from truncation on negative operands; "
            "write torch.div(a, b, rounding_mode='floor') or a // b")
    return [g.eqn("div", [g.atom(a) for a in node.args[:2]], out, node)]


def _true_div(g, node, out):
    raise FrontendError(
        f"frontend is integer-only (int32 / bool): '{g.op(node)}' is true division and "
        "gives a float; write torch.div(a, b, rounding_mode='floor') or a // b")


def _reduce(prim: str, dim_arg: Optional[int]):
    """``sum``/``amax``/``amin``/``max``/``min``: over ``dim`` (all dims when
    absent or empty), without ``keepdim``."""
    def make(g, node, out):
        x = node.args[0]
        rank = len(g.var(x).aval.shape)
        dims = None
        if dim_arg is not None:
            dims = node.args[dim_arg] if len(node.args) > dim_arg else node.kwargs.get("dim")
        keep = node.args[dim_arg + 1] if dim_arg is not None and len(node.args) > dim_arg + 1 \
            else node.kwargs.get("keepdim", False)
        if keep:
            raise UnsupportedPrimitiveError(
                f"frontend: '{g.op(node)}' with keepdim=True is not supported; "
                "reduce, then expand")
        if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
            axes = tuple(range(rank))
        else:
            dims = dims if isinstance(dims, (list, tuple)) else [dims]
            axes = tuple(sorted(d % rank for d in dims))
        return [g.eqn(prim, [g.atom(x)], out, node, axes=axes)]
    return make


def _cumsum(g, node, out):
    x = node.args[0]
    dim = node.args[1] if len(node.args) > 1 else node.kwargs["dim"]
    rank = len(g.var(x).aval.shape)
    return [g.eqn("cumsum", [g.atom(x)], out, node, axis=dim % max(rank, 1), reverse=False)]


def _mm(g, node, out):
    return [g.eqn("dot_general", [g.atom(a) for a in node.args[:2]], out, node,
                  dimension_numbers=(((1,), (0,)), ((), ())))]


def _expand(g, node, out):
    x = node.args[0]
    src = g.atom(x)
    rank, orank = len(g.var(x).aval.shape) if isinstance(src, _Var) else 0, len(out.aval.shape)
    return [g.eqn("broadcast_in_dim", [src], out, node, shape=out.aval.shape,
                  broadcast_dimensions=tuple(range(orank - rank, orank)))]


#: aten overload (as make_fx spells it) -> the equations of the reference's
#: primitives it computes
_ATEN: dict[str, Callable] = {
    "add.Tensor": _plain("add"), "sub.Tensor": _plain("sub"),
    "rsub.Scalar": _plain("sub", reverse=True),          # 5 - x
    "mul.Tensor": _plain("mul"), "neg.default": _plain("neg"),
    "div.Tensor_mode": _floor_div, "floor_divide.default": _floor_div,
    "div.Tensor": _true_div,
    **{f"bitwise_{op}.{kind}": _plain(op) for op in ("and", "or", "xor")
       for kind in ("Tensor", "Scalar")},
    "__lshift__.Tensor": _plain("shift_left"), "__lshift__.Scalar": _plain("shift_left"),
    "bitwise_left_shift.Scalar_Tensor": _plain("shift_left"),                  # 3 << x
    "__rshift__.Tensor": _plain("shift_right_arithmetic"),
    "__rshift__.Scalar": _plain("shift_right_arithmetic"),
    "bitwise_right_shift.Scalar_Tensor": _plain("shift_right_arithmetic"),
    "maximum.default": _plain("max"), "minimum.default": _plain("min"),
    "clamp.default": _clamp, "clamp.Tensor": _clamp,
    "clamp_min.default": _plain("max"), "clamp_min.Tensor": _plain("max"),
    "clamp_max.default": _plain("min"), "clamp_max.Tensor": _plain("min"),
    **{f"{op}.{kind}": _plain(op) for op in ("lt", "le", "eq", "ne", "gt", "ge")
       for kind in ("Tensor", "Scalar")},
    "where.self": _where,
    "sum.default": _reduce("reduce_sum", None), "sum.dim_IntList": _reduce("reduce_sum", 1),
    "amax.default": _reduce("reduce_max", 1), "amin.default": _reduce("reduce_min", 1),
    "max.default": _reduce("reduce_max", None), "min.default": _reduce("reduce_min", None),
    "cumsum.default": _cumsum,
    "mm.default": _mm,
    "expand.default": _expand,
    "_to_copy.default": _plain("convert_element_type"),
    "clone.default": _plain("copy"), "detach.default": _plain("copy"),
    "lift_fresh_copy.default": _plain("copy"),                         # a tensor constant
}

#: aten overloads that make a literal operand and emit nothing
_LITERALS = ("scalar_tensor.default",)

SUPPORTED_PRIMITIVES = tuple(sorted(set(_ATEN) | set(_LITERALS)))


def _check_int(aval, what: str) -> None:
    dt = aval.dtype
    if isinstance(dt, torch.dtype):
        ok = dt in (torch.int32, torch.bool)
    else:
        ok = np.issubdtype(dt, np.integer) or np.issubdtype(dt, np.bool_)
    if not ok:
        raise FrontendError(
            f"frontend is integer-only (int32 / bool): {what} has dtype "
            f"{dt}; express the kernel in fixed point")


class _Graph:
    """The aten graph of ``fn`` on int32 examples, rewritten as equations."""

    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.vars: dict = {}      # fx node -> _Var
        self.lits: dict = {}      # fx node -> _Lit
        self.invars: list = []
        self.outvars: list = []
        self.eqns: list = []
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                self.invars.append(self.var(node))
            elif node.op == "get_attr":
                t = getattr(gm, node.target).detach().cpu()
                self.lits[node] = _Lit((t.float() if t.dtype == torch.bfloat16 else t).numpy())
            elif node.op == "call_function":
                self.call(node)
            elif node.op == "output":
                outs = torch.utils._pytree.tree_leaves(node.args[0])
                for o in outs:
                    if not isinstance(self.atom(o), _Var):
                        raise FrontendError("frontend: the program returns a constant; "
                                            "return a traced value")
                self.outvars = [self.var(o) for o in outs]

    @staticmethod
    def op(node) -> str:
        return f"{node.target._opname}.{node.target._overloadname}" \
            if hasattr(node.target, "_overloadname") else str(node.target)

    def var(self, node) -> _Var:
        if node not in self.vars:
            val = node.meta["val"]
            self.vars[node] = _Var(val.shape, val.dtype)
        return self.vars[node]

    def atom(self, a):
        if isinstance(a, torch.fx.Node):
            return self.lits[a] if a in self.lits else self.var(a)
        return _Lit(a)

    def eqn(self, prim: str, invars, out: _Var, node, **params) -> _Eqn:
        return _Eqn(prim, invars, [out], params, op=self.op(node))

    def call(self, node) -> None:
        name = self.op(node)
        if name in _LITERALS:
            dt = node.kwargs.get("dtype") or torch.float32
            kind = np.float64 if dt.is_floating_point or dt.is_complex else np.int64
            self.lits[node] = _Lit(np.asarray(node.args[0], dtype=kind))
            return
        if name not in _ATEN:
            raise UnsupportedPrimitiveError(
                f"frontend: unsupported PyTorch operator 'aten.{name}'; supported "
                f"primitives are: {', '.join(SUPPORTED_PRIMITIVES)}")
        out = self.var(node)
        for e in _ATEN[name](self, node, out):
            self.eqns.extend(self.broadcasts(e))

    def broadcasts(self, e: _Eqn) -> list:
        """An elementwise equation's operands of another (non-scalar) shape
        than its result go through a ``broadcast_in_dim`` first, as torch
        broadcasts them implicitly and jax.numpy explicitly."""
        if e.primitive.name not in _ELEMENTWISE:
            return [e]
        oshape = e.outvars[0].aval.shape
        pre = []
        for i, v in enumerate(e.invars):
            if isinstance(v, _Var) and v.aval.shape not in (oshape, ()):
                wide = _Var(oshape, v.aval.dtype)
                rank = len(v.aval.shape)
                pre.append(_Eqn("broadcast_in_dim", [v], [wide], {
                    "shape": oshape,
                    "broadcast_dimensions": tuple(range(len(oshape) - rank, len(oshape)))},
                    op=e.op))
                e.invars[i] = wide
        return pre + [e]


def equations(fn: Callable, in_shapes: Sequence[Sequence[int]]) -> _Graph:
    """The aten graph of ``fn`` over int32 examples of ``in_shapes`` as the
    equations ``trace`` walks (``.invars``, ``.eqns``, ``.outvars``; each
    equation names the reference primitive in ``.primitive.name`` and the
    aten operator it came from in ``.op``).  Runs on the host."""
    from torch.fx.experimental.proxy_tensor import make_fx

    examples = [torch.zeros(tuple(s), dtype=torch.int32) for s in in_shapes]
    # fake tensors: shapes and dtypes only, so no example value can fault
    # (a division by the zeros) and no large product is computed
    return _Graph(make_fx(fn, tracing_mode="fake")(*examples))


class _Tracer:
    def __init__(self, b: Builder, root_time: ir.Time, tile: int):
        self.b = b
        self.tile = tile
        self.clocks: list[list] = [[root_time, 0]]
        self.n = 0          # unique-name counter (ivs, time vars, buffers)
        self.n_buf = 0

    # -- naive-schedule clock ------------------------------------------------
    def now(self) -> ir.Time:
        base, off = self.clocks[-1]
        return base + off

    def tick(self) -> ir.Time:
        t = self.now()
        self.clocks[-1][1] += 1
        return t

    def arith(self, opname: str, *xs) -> ir.Value:
        return self.b._arith(opname, *xs, at=self.tick())

    # -- loops ---------------------------------------------------------------
    @contextmanager
    def loop(self, n: int, unroll: bool = False):
        at = self.tick()
        k = self.n
        self.n += 1
        with self.b.for_(0, n, 1, at=at, unroll=unroll, iv_name=f"i{k}",
                         tv_name=f"t{k}") as lp:
            self.clocks.append([lp.time, 0])
            try:
                yield lp.iv
            finally:
                _, off = self.clocks.pop()
                self.b.yield_(at=lp.time + max(off, 1))

    def nest(self, shape: Sequence[int], body: Callable[[list], None]) -> None:
        """Run ``body(ids)`` inside a loop nest over ``shape`` (no loops for
        rank-0: the body runs in the current region)."""
        def rec(ids):
            if len(ids) == len(shape):
                body(ids)
                return
            with self.loop(shape[len(ids)]) as iv:
                rec(ids + [iv])
        rec([])

    # -- buffers --------------------------------------------------------------
    def new_buf(self, shape: Sequence[int], tag: str = "b",
                reg: bool = False) -> _Alloc:
        """Local buffer: BRAM for arrays, a fully-distributed register bank
        for rank-0 values and ``reg=True`` (parallel-access accumulators)."""
        shape = tuple(shape)
        k = self.n_buf
        self.n_buf += 1
        if shape and not reg:
            mt = ir.MemrefType(shape, ir.i32)
        else:
            mt = ir.MemrefType(shape or (1,), ir.i32, packed=[],
                               kind=ir.KIND_REG)
        rd, wr = self.b.alloc(mt, names=[f"{tag}{k}r", f"{tag}{k}w"])
        return _Alloc(rd, wr, shape)

    def elem(self, val, ids):
        """One scalar element of a traced value at loop indices ``ids``."""
        if isinstance(val, _Const):
            return val.v
        return self.b.read(val.rd, val.index(ids), at=self.tick())

    # -- equation environment --------------------------------------------------
    def lift_const(self, c) -> _Const:
        v = np.asarray(c)
        _check_int(v, "constant")
        if v.ndim == 0:
            return _Const(v)
        raise FrontendError(
            "array-valued constants are not supported; pass the array "
            "as a traced input instead")

    def val(self, env: dict, atom):
        if isinstance(atom, _Lit):
            return self.lift_const(atom.val)
        return env[atom]

    # -- equation handlers ------------------------------------------------------
    def eval_eqns(self, eqns, env: dict) -> None:
        for eqn in eqns:
            self.eval_eqn(eqn, env)

    def eval_eqn(self, eqn, env: dict) -> None:
        p = eqn.primitive.name
        if p in _IDENTITY:
            _check_int(eqn.outvars[0].aval, f"'{p}' result")
            env[eqn.outvars[0]] = self.val(env, eqn.invars[0])
            return
        if p == "broadcast_in_dim":
            self.eval_broadcast(eqn, env)
            return
        if p in _ELEMENTWISE:
            self.eval_elementwise(eqn, env)
            return
        if p in _REDUCE_INIT:
            self.eval_reduce(eqn, env)
            return
        if p == "cumsum":
            self.eval_cumsum(eqn, env)
            return
        if p == "dot_general":
            self.eval_dot_general(eqn, env)
            return
        raise UnsupportedPrimitiveError(
            f"frontend: unsupported primitive '{p}' (from 'aten.{eqn.op}'); "
            f"supported primitives are: {', '.join(SUPPORTED_PRIMITIVES)}")

    def eval_broadcast(self, eqn, env: dict) -> None:
        src = self.val(env, eqn.invars[0])
        oshape = tuple(eqn.params["shape"])
        bdims = tuple(eqn.params["broadcast_dimensions"])
        if isinstance(src, _Const):
            env[eqn.outvars[0]] = src
            return
        sshape = src.shape
        inner = src.index

        def index(ids, _ss=sshape, _bd=bdims, _osh=oshape):
            return inner([ids[d] if _ss[k] == _osh[d] else 0
                          for k, d in enumerate(_bd)])

        env[eqn.outvars[0]] = _Buf(src.rd, oshape, index=index)

    def eval_elementwise(self, eqn, env: dict) -> None:
        out = eqn.outvars[0]
        _check_int(out.aval, f"'{eqn.primitive.name}' result")
        oshape = tuple(out.aval.shape)
        vals = [self.val(env, a) for a in eqn.invars]
        for v in vals:
            if isinstance(v, _Buf) and v.shape not in (oshape, ()):
                raise FrontendError(
                    f"'{eqn.primitive.name}' operand shape {v.shape} does "
                    f"not match result shape {oshape} (missing broadcast?)")
        if eqn.primitive.name == "select_n" and len(vals) != 3:
            raise UnsupportedPrimitiveError(
                "select_n with more than two cases is not supported")
        impl = _ELEMENTWISE[eqn.primitive.name]
        dst = self.new_buf(oshape)

        def body(ids):
            xs = [self.elem(v, ids) for v in vals]
            self.b.write(impl(self, *xs), dst.wr, dst.midx(ids),
                         at=self.tick())

        self.nest(oshape, body)
        env[out] = dst.view()

    def eval_reduce(self, eqn, env: dict) -> None:
        out = eqn.outvars[0]
        _check_int(out.aval, f"'{eqn.primitive.name}' result")
        src = self.val(env, eqn.invars[0])
        axes = set(eqn.params["axes"])
        ishape = tuple(eqn.invars[0].aval.shape)
        oshape = tuple(out.aval.shape)
        dst = self.new_buf(oshape, tag="red")
        init = _REDUCE_INIT[eqn.primitive.name]
        self.nest(oshape, lambda ids: self.b.write(
            init, dst.wr, dst.midx(ids), at=self.tick()))

        def body(ids):
            oids = [iv for d, iv in enumerate(ids) if d not in axes]
            acc = self.b.read(dst.rd, dst.midx(oids), at=self.tick())
            x = self.elem(src, ids)
            if eqn.primitive.name == "reduce_sum":
                r = self.b.add(acc, x, at=self.tick())
            else:
                kind = "ge" if eqn.primitive.name == "reduce_max" else "le"
                c = self.b.cmp(kind, acc, x, at=self.tick())
                r = self.b._arith("select", c, acc, x, at=self.tick(),
                                  result_type=ir.i32)
            self.b.write(r, dst.wr, dst.midx(oids), at=self.tick())

        self.nest(ishape, body)
        env[out] = dst.view()

    def eval_cumsum(self, eqn, env: dict) -> None:
        out = eqn.outvars[0]
        _check_int(out.aval, "'cumsum' result")
        src = self.val(env, eqn.invars[0])
        shape = tuple(eqn.invars[0].aval.shape)
        if len(shape) != 1 or eqn.params.get("reverse"):
            raise UnsupportedPrimitiveError(
                "cumsum is supported on rank-1 arrays, forward only "
                f"(got shape {shape}, reverse={eqn.params.get('reverse')})")
        dst = self.new_buf(shape, tag="scan")
        acc = self.new_buf((), tag="acc")
        self.b.write(0, acc.wr, [0], at=self.tick())

        def body(ids):
            x = self.elem(src, ids)
            a = self.b.read(acc.rd, [0], at=self.tick())
            s = self.b.add(a, x, at=self.tick())
            self.b.write(s, acc.wr, [0], at=self.tick())
            self.b.write(s, dst.wr, dst.midx(ids), at=self.tick())

        self.nest(shape, body)
        env[out] = dst.view()

    def eval_dot_general(self, eqn, env: dict) -> None:
        out = eqn.outvars[0]
        _check_int(out.aval, "'dot_general' result")
        dn = eqn.params["dimension_numbers"]
        a_val = self.val(env, eqn.invars[0])
        b_val = self.val(env, eqn.invars[1])
        ashape = tuple(eqn.invars[0].aval.shape)
        bshape = tuple(eqn.invars[1].aval.shape)
        if (len(ashape), len(bshape)) != (2, 2) or \
                tuple(map(tuple, dn[0])) != ((1,), (0,)) or any(dn[1]):
            raise UnsupportedPrimitiveError(
                "dot_general is supported as plain 2-D matmul "
                f"(contract a.dim1 with b.dim0, no batch dims; got {dn})")
        m, kk = ashape
        n = bshape[1]
        t = self.tile if self.tile and n % self.tile == 0 else 1
        dst = self.new_buf((m, n), tag="mm")
        # per-tile accumulators: a small local RAM cycled read-modify-write
        # (the histogram idiom); A elements are read once per (i, jo, k) and
        # reused across the ji tile — the tile width is the reuse knob
        acc = self.new_buf((t,), tag="acc")

        b = self.b
        with self.loop(m) as i:
            with self.loop(n // t) as jo:
                with self.loop(t) as ji:
                    b.write(0, acc.wr, [ji], at=self.tick())
                with self.loop(kk) as k:
                    a_el = self.elem(a_val, [i, k])
                    with self.loop(t) as ji:
                        col = self.arith(
                            "add", self.arith("mult", jo, t), ji)
                        b_el = self.elem(b_val, [k, col])
                        old = b.read(acc.rd, [ji], at=self.tick())
                        s = b.call("mac", [a_el, b_el, old], at=self.tick())
                        b.write(s, acc.wr, [ji], at=self.tick())
                with self.loop(t) as ji:
                    col = self.arith("add", self.arith("mult", jo, t), ji)
                    v = b.read(acc.rd, [ji], at=self.tick())
                    b.write(v, dst.wr, [i, col], at=self.tick())
        env[out] = dst.view()


def _uses_prim(eqns, name: str) -> bool:
    return any(eqn.primitive.name == name for eqn in eqns)


def trace(fn: Callable, in_shapes: Sequence[Sequence[int]], *,
          name: str, tile: int = 2,
          arg_names: Optional[Sequence[str]] = None,
          schedule: bool = True, cache: bool = True,
          scheduler_options: Any = None):
    """Trace ``fn`` over int32 inputs of ``in_shapes`` into a scheduled HIR
    module.  Returns ``(Module, entry_name)`` — the gallery ``build()``
    contract, so traced kernels drop into every downstream harness
    (``run_differential``, ``hls_compile``, ``explore_design``).

    ``tile`` is the loop-level design knob for ``mm`` (column-tile
    width / accumulator-bank size; must divide N, else falls back to 1).
    ``schedule=False`` returns the *unscheduled* (erased) design for callers
    that schedule themselves; ``cache`` forwards to the process-wide
    ``ScheduleCache`` keyed by structural fingerprint."""
    from ..hls import erase_schedule, hls_schedule

    graph = equations(fn, in_shapes)
    for v in graph.invars:
        _check_int(v.aval, "input")
    for v in graph.outvars:
        _check_int(v.aval, "output")

    b = Builder(ir.Module(name))
    if _uses_prim(graph.eqns, "dot_general"):
        # the shared PE compute op (create it *before* the main func: the
        # builder hoists constants into region_stack[0], which must be the
        # function under construction)
        with b.func("mac", [ir.i32, ir.i32, ir.i32], ["a", "bb", "c"],
                    result_types=[ir.i32], result_delays=[0]) as g:
            ga, gb, gc = g.args
            b.ret([b.add(b.mult(ga, gb, at=g.t), gc)])

    names = list(arg_names or [f"in{i}" for i in range(len(graph.invars))])
    assert len(names) == len(graph.invars), (names, len(graph.invars))
    outs = graph.outvars
    out_names = ["out"] if len(outs) == 1 else [f"out{i}"
                                               for i in range(len(outs))]
    arg_types = [ir.MemrefType(tuple(v.aval.shape) or (1,), ir.i32,
                               ir.PORT_R) for v in graph.invars]
    arg_types += [ir.MemrefType(tuple(v.aval.shape) or (1,), ir.i32,
                                ir.PORT_W) for v in outs]

    with b.func(name, arg_types, names + out_names) as f:
        tr = _Tracer(b, f.t + 1, tile)
        env: dict = {}
        for var, arg in zip(graph.invars, f.args):
            shape = tuple(var.aval.shape)
            env[var] = _Buf(arg, shape,
                            index=None if shape else (lambda ids: [0]))
        tr.eval_eqns(graph.eqns, env)
        for ov, out_arg in zip(outs, f.args[len(names):]):
            val = tr.val(env, ov)
            oshape = tuple(ov.aval.shape)

            def copy(ids, _v=val, _a=out_arg, _sh=oshape):
                x = tr.elem(_v, ids)
                tr.b.write(x, _a, list(ids) if _sh else [0], at=tr.tick())

            tr.nest(oshape, copy)
        b.ret()

    um = erase_schedule(b.module)
    if schedule:
        hls_schedule(um, options=scheduler_options,
                     cache=True if cache else None)
    return um, name
