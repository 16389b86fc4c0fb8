"""HIR -> CUDA C++ lowering (the hardware-adaptation component) for Hopper.

Replaces the TPU kernel of ``repro/core/lower/to_pallas.py`` (the generated
``kernel`` driven by ``_KernelInterp``).  The paper's three design components
map onto a generated ``__global__`` function as:

  algorithm  -> the kernel body: HIR ops emitted as C++ statements over
                per-lane arrays;
  schedule   -> the *main* pipelined loop (the sequential grid of the TPU
                kernel) becomes a ``for (pid ...)`` loop inside the thread;
                ops before/after it form a prologue/epilogue block;
                cross-iteration state (HIR register windows, accumulators)
                lives in per-thread arrays that persist across iterations;
  binding    -> memref arguments are global-memory arrays, one slice per
                lane; ``hir.alloc`` buffers are zero-initialised per-thread
                arrays (registers or local memory).

What bounds it on the card: one design run is a few hundred *dependent*
scalar operations over a few hundred bytes — nothing in it can be spread
over threads.  The card gets its work from **lanes**: independent stimulus
vectors (the differential-verification workload), one thread per lane.  The
kernel is then bound by the bytes of stimulus read and results written.

``generate_cuda_source`` walks the HIR exactly as the reference interpreter
does — effects in ``schedule_key`` order within each region, pure values
resolved lazily and memoised per interpreter — and writes text instead of
executing.  Memoisation per interpreter becomes C++ scoping: a value first
needed inside a loop body is declared inside that body's braces and is
emitted again if it is needed after the loop.  Nested constant-bound loops
are emitted as C++ ``for`` loops, not unrolled.

Arithmetic matches the reference on ``int32``: wrap-around add/sub/mult
(computed in ``uint32_t``; signed overflow is undefined in C++), *floor*
division, arithmetic right shift, shift counts >= 32 defined, compares
yield ``int32`` 0/1, ``select`` tests ``!= 0``.  ``hir.delay`` is identity.

The **plain version** (``_PlainInterp``) is the same phase split interpreted
over torch tensors.  It serves CPU tensors and ``device="cpu"``; on CUDA the
returned callable launches the generated kernel or raises.
"""

from __future__ import annotations

import ctypes
import re
from typing import Any, Optional, Union

import torch

from ..._device import resolve_device
from .. import ir
from ..ir import ForOp, MemrefType, Module, Operation, Region, Value
from .common import EFFECTFUL_OPS as _EFFECTFUL
from .common import cuda_dtype as _dtype
from .common import mem_load, mem_store
from .common import schedule_key as _schedule_key
from .common import torch_arith_table
from .to_torch import as_lane_tensors

_ARITH = torch_arith_table()
_PURE = set(_ARITH) | {"delay", "constant"}

#: kernel launches made by every callable of this module (a run resets it
#: to 0, drives its path, and reads it to show the path used the kernel)
launches = 0

THREADS_PER_BLOCK = 128


# ---------------------------------------------------------------------------
# The walk shared by the plain version and the generator
# ---------------------------------------------------------------------------


class _Interp:
    """Walks HIR effects in schedule order; pure values resolve lazily
    (recursively through arith/delay/constant defs) and are memoised in
    ``env``.  Subclasses say what a read, a write, an arith op and a nested
    loop *do*: compute on tensors, or emit C++."""

    def __init__(self, module: Module, refs: dict[Value, Any], ctx: Any,
                 env: Optional[dict[Value, Any]] = None):
        self.module = module
        self.refs = refs                      # memref Value -> storage
        self.ctx = ctx
        self.env: dict[Value, Any] = dict(env or {})

    def fork(self, env: Optional[dict[Value, Any]] = None) -> "_Interp":
        return type(self)(self.module, self.refs, self.ctx, env)

    # -- what a subclass provides ----------------------------------------
    def arith(self, opname: str, args: list) -> Any:
        raise NotImplementedError

    def read(self, ref: Any, ixs: tuple) -> Any:
        raise NotImplementedError

    def write(self, ref: Any, ixs: tuple, val: Any, pred: Any) -> None:
        raise NotImplementedError

    def loop(self, op: ForOp, trip: int, lb: int, step: int) -> None:
        raise NotImplementedError

    # -- the walk ----------------------------------------------------------
    def value(self, v: Value):
        if v in self.env:
            return self.env[v]
        d = v.defining_op
        if d is None or d.opname not in _PURE:
            raise KeyError(f"%{v.name} unbound in cuda lowering ({d})")
        if d.opname == "constant":
            out = d.attrs["value"]
        elif d.opname == "delay":
            out = self.value(d.operands[0])
        else:
            out = self.arith(d.opname, [self.value(x) for x in d.operands])
        self.env[v] = out
        return out

    def run_effects(self, ops: list[Operation]) -> None:
        for op in sorted((x for x in ops if x.opname in _EFFECTFUL),
                         key=_schedule_key):
            self.run_effect(op)

    def run_region(self, region: Region) -> None:
        self.run_effects(list(region.ops))

    def run_effect(self, op: Operation) -> None:
        o = op.opname
        if o == "mem_read":
            mem, idx = ir.mem_read_parts(op)
            ixs = tuple(self.value(i) for i in idx)
            self.env[op.result] = self.read(self.refs[mem], ixs)
            return
        if o == "mem_write":
            val, mem, idx, pred = ir.mem_write_parts(op)
            ixs = tuple(self.value(i) for i in idx)
            self.write(self.refs[mem], ixs, self.value(val),
                       self.value(pred) if pred is not None else None)
            return
        if o == "call":
            callee = self.module.funcs.get(op.attrs["callee"])
            if callee is None or callee.attrs.get("external"):
                raise NotImplementedError(
                    f"to_cuda: external @{op.attrs['callee']} has no body to lower")
            sub = self.fork()
            for formal, actual in zip(callee.args, op.operands):
                if isinstance(formal.type, MemrefType):
                    sub.refs[formal] = self.refs[actual]
                else:
                    sub.env[formal] = self.value(actual)
            sub.run_region(callee.body)
            for bop in callee.body.ops:
                if bop.opname == "return" and bop.operands:
                    for r, v in zip(op.results, bop.operands):
                        self.env[r] = sub.value(v)
            return
        if isinstance(op, ForOp):
            trip = op.trip_count()
            if trip is None:
                raise NotImplementedError("to_cuda: nested loops need constant bounds")
            self.loop(op, trip, ir.const_value(op.lb), ir.const_value(op.step))
            return
        raise NotImplementedError(f"to_cuda: hir.{o}")


# ---------------------------------------------------------------------------
# Plain version: the walk computes on torch tensors
# ---------------------------------------------------------------------------


class _PlainInterp(_Interp):
    """``ctx`` is whether the tensors carry a leading lanes dimension."""

    def arith(self, opname, args):
        return _ARITH[opname](*args)

    def read(self, ref, ixs):
        return mem_load(ref, ixs, self.ctx)

    def write(self, ref, ixs, val, pred):
        mem_store(ref, ixs, val, pred, self.ctx)

    def loop(self, op, trip, lb, step):
        for t in range(trip):
            body = self.fork(self.env)
            body.env[op.iv] = lb + t * step
            body.run_region(op.region(0))


# ---------------------------------------------------------------------------
# Generator: the walk writes CUDA C++
# ---------------------------------------------------------------------------

_CTYPE = {torch.int32: "int32_t", torch.float16: "__half",
          torch.float32: "float", torch.float64: "double"}
_RANK = {"int32_t": 0, "__half": 1, "float": 2, "double": 3}

_INT_FN = {"add": "hir_add", "sub": "hir_sub", "mult": "hir_mul",
           "div": "hir_floordiv", "shl": "hir_shl", "shr": "hir_shr"}
_INT_INFIX = {"and": "&", "or": "|", "xor": "^"}
_FLOAT_INFIX = {"add": "+", "sub": "-", "mult": "*", "div": "/"}
_CMP = {"cmp_lt": "<", "cmp_le": "<=", "cmp_eq": "==", "cmp_ne": "!=",
        "cmp_gt": ">", "cmp_ge": ">="}

_PREAMBLE = r"""
// int32 arithmetic with the reference's semantics: wrap-around on overflow
// (done in uint32_t, signed overflow being undefined), floor division,
// arithmetic right shift, shift counts taken as unsigned and defined >= 32.
__device__ __forceinline__ int32_t hir_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t hir_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t hir_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t hir_floordiv(int32_t a, int32_t b) {
  if (b == 0) return -1;  // outside the domain the reference defines
  if (b == -1) return hir_sub(0, a);
  int32_t q = a / b;
  int32_t r = a - q * b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int32_t hir_shl(int32_t a, int32_t b) {
  return ((uint32_t)b >= 32u) ? 0 : (int32_t)((uint32_t)a << (uint32_t)b);
}
__device__ __forceinline__ int32_t hir_shr(int32_t a, int32_t b) {
  return ((uint32_t)b >= 32u) ? (a < 0 ? -1 : 0) : (a >> b);
}
"""


class _CVal:
    """A C++ expression (a variable name or a literal) and its type."""

    __slots__ = ("expr", "ctype")

    def __init__(self, expr: str, ctype: str):
        self.expr = expr
        self.ctype = ctype


class _CMem:
    """A per-lane array visible in the kernel body."""

    __slots__ = ("name", "shape", "ctype")

    def __init__(self, name: str, shape: tuple, ctype: str):
        self.name = name
        self.shape = tuple(shape)
        self.ctype = ctype


def _literal(value, ctype: str) -> str:
    """A python number as a literal of ``ctype`` (constants are python
    numbers in the walk and meet the kernel as literals of the operand's
    type)."""
    if ctype == "int32_t":
        v = int(value)
        if -(2 ** 31) < v < 2 ** 31:
            return f"({v})" if v < 0 else str(v)
        return f"((int32_t){v & 0xFFFFFFFF}u)"
    f = float(value)
    if f != f or f in (float("inf"), float("-inf")):
        raise NotImplementedError(f"to_cuda: non-finite constant {value!r}")
    if ctype == "double":
        return f"({f.hex()})"
    if ctype == "float":
        return f"({f.hex()}f)"
    if ctype == "__half":
        return f"__float2half_rn({f.hex()}f)"
    raise TypeError(ctype)


class _Writer:
    """Lines of source, an indent level and a counter for fresh names."""

    def __init__(self):
        self.lines: list[str] = []
        self.depth = 1
        self.counter = 0

    def line(self, text: str) -> None:
        self.lines.append("  " * self.depth + text)

    def fresh(self, hint: str) -> str:
        self.counter += 1
        return f"{hint}{self.counter}"


def _ident(name: str) -> str:
    return re.sub(r"\W", "_", name)


class _Emitter(_Interp):
    """``ctx`` is the ``_Writer``.  A value is a python number (a constant,
    folded in Python as the reference folds it) or a ``_CVal``."""

    def _as(self, x, ctype: str) -> str:
        if not isinstance(x, _CVal):
            return _literal(x, ctype)
        if x.ctype == ctype:
            return x.expr
        return f"static_cast<{ctype}>({x.expr})"

    def _bind(self, ctype: str, expr: str, hint: str = "v") -> _CVal:
        name = self.ctx.fresh(hint)
        self.ctx.line(f"const {ctype} {name} = {expr};")
        return _CVal(name, ctype)

    @staticmethod
    def _common_type(args: list) -> str:
        """Result type as the reference promotes: the widest array type
        wins and python scalars adopt it, except that a python float meeting
        only integers makes float32."""
        best = max((a.ctype for a in args if isinstance(a, _CVal)),
                   key=_RANK.get, default="int32_t")
        if best == "int32_t" and any(isinstance(a, float) for a in args):
            return "float"
        return best

    def arith(self, opname, args):
        if not any(isinstance(a, _CVal) for a in args):
            return _ARITH[opname](*args)          # constants fold in Python
        if opname in ("trunc", "zext", "sext"):
            return args[0]
        if opname == "select":
            c, a, b = args
            t = self._common_type([a, b])
            if isinstance(c, _CVal):
                cond = f"({c.expr} != {_literal(0, c.ctype)})"
            else:
                cond = "true" if c != 0 else "false"
            return self._bind(t, f"{cond} ? {self._as(a, t)} : {self._as(b, t)}")
        t = self._common_type(args)
        xs = [self._as(a, t) for a in args]
        if opname in _CMP:
            return self._bind("int32_t", f"({xs[0]} {_CMP[opname]} {xs[1]}) ? 1 : 0")
        if t == "int32_t":
            if opname in _INT_FN:
                return self._bind(t, f"{_INT_FN[opname]}({xs[0]}, {xs[1]})")
            if opname in _INT_INFIX:
                return self._bind(t, f"{xs[0]} {_INT_INFIX[opname]} {xs[1]}")
            if opname == "not":
                return self._bind(t, f"~{xs[0]}")
        elif opname in _FLOAT_INFIX:
            return self._bind(t, f"{xs[0]} {_FLOAT_INFIX[opname]} {xs[1]}")
        raise TypeError(f"to_cuda: hir.{opname} on {t}")

    def _index(self, ref: _CMem, ixs: tuple) -> str:
        if len(ixs) != len(ref.shape):
            raise ValueError(f"{len(ixs)} indices into {ref.name} of rank {len(ref.shape)}")
        if not any(isinstance(i, _CVal) for i in ixs):
            lin = 0
            for i, d in zip(ixs, ref.shape):
                lin = lin * d + int(i)
            return str(lin)
        expr = ""
        for i, d in zip(ixs, ref.shape):
            term = self._as(i, "int32_t") if isinstance(i, _CVal) else str(int(i))
            expr = term if not expr else f"({expr}) * {d} + {term}"
        return expr

    def read(self, ref, ixs):
        return self._bind(ref.ctype, f"{ref.name}[{self._index(ref, ixs)}]", "r")

    def write(self, ref, ixs, val, pred):
        store = f"{ref.name}[{self._index(ref, ixs)}] = {self._as(val, ref.ctype)};"
        if pred is None:
            self.ctx.line(store)
        elif isinstance(pred, _CVal):
            # read-modify-where of the reference: the old value stays
            self.ctx.line(f"if ({pred.expr} != {_literal(0, pred.ctype)}) {store}")
        elif pred != 0:
            self.ctx.line(store)

    def loop(self, op, trip, lb, step):
        w = self.ctx
        t = w.fresh("t")
        w.line(f"for (int32_t {t} = 0; {t} < {trip}; ++{t}) {{")
        w.depth += 1
        body = self.fork(self.env)
        body.env[op.iv] = body._bind(
            "int32_t", f"{_literal(lb, 'int32_t')} + {t} * {_literal(step, 'int32_t')}",
            _ident(op.iv.name or "iv") + "_")
        body.run_region(op.region(0))
        w.depth -= 1
        w.line("}")


class _Plan:
    """The phase split of one function: prologue, main loop, epilogue."""

    def __init__(self, module: Module, func_name: str):
        self.module = module
        self.func = func = module.get(func_name)
        for a in func.args:
            if not isinstance(a.type, MemrefType):
                raise NotImplementedError(
                    f"to_cuda: scalar argument %{a.name} of @{func_name}")
        self.in_args = [a for a in func.args if a.type.port == ir.PORT_R]
        self.out_args = [a for a in func.args
                         if a.type.port in (ir.PORT_W, ir.PORT_RW)]
        self.allocs = [op for op in func.body.ops if op.opname == "alloc"]
        # the main loop is the largest-trip top-level for
        top = [op for op in func.body.ops if op.opname in _EFFECTFUL]
        loops = [op for op in top if isinstance(op, ForOp)]
        if not loops:
            raise NotImplementedError("to_cuda needs at least one top-level loop")
        self.main = max(loops, key=lambda l: l.trip_count() or 0)
        mi = top.index(self.main)
        self.prologue, self.epilogue = top[:mi], top[mi + 1:]
        self.trip = self.main.trip_count()
        if self.trip is None:
            raise NotImplementedError("to_cuda: main loop needs constant bounds")
        self.lb = ir.const_value(self.main.lb)
        self.step = ir.const_value(self.main.step)


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def generate_cuda_source(module: Module, func_name: str,
                         allow_downcast: bool = False) -> tuple[str, str]:
    """CUDA C++ text for ``@func_name`` and the name of its launcher (see
    ``_generate``).  Needs no compiler and no device."""
    return _generate(_Plan(module, func_name), allow_downcast)


def _generate(plan: _Plan, allow_downcast: bool) -> tuple[str, str]:
    """CUDA C++ text for the planned function and the name of its launcher.

    The launcher is ``extern "C" int <launcher>(in..., out..., int lanes,
    void* stream)``: raw pointers to ``(lanes, *shape)`` arrays, one per
    read-port memref then one per write/rw-port memref; it launches on
    ``stream`` and returns ``cudaGetLastError()``."""
    module, func_name = plan.module, plan.func.name
    sym = _ident(func_name)
    w = _Writer()
    refs: dict[Value, _CMem] = {}
    params, names = [], []
    uses_half = False
    for a in plan.in_args + plan.out_args:
        ct = _CTYPE[_dtype(a.type.elem, allow_downcast)]
        uses_half |= ct == "__half"
        const = "const " if a in plan.in_args else ""
        g = f"g_{_ident(a.name)}"
        params.append(f"{const}{ct}* __restrict__ {g}")
        names.append(g)
        m = _CMem(f"m_{_ident(a.name)}", a.type.shape, ct)
        refs[a] = m
        w.line(f"{const}{ct}* __restrict__ {m.name} = {g} + (size_t)lane * {_size(m.shape)};")
    for k, al in enumerate(plan.allocs):
        base: MemrefType = al.attrs["base"]
        ct = _CTYPE[_dtype(base.elem, allow_downcast)]
        uses_half |= ct == "__half"
        m = _CMem(f"a{k}_{_ident(al.results[0].name or 'buf')}", base.shape, ct)
        for res in al.results:          # every port aliases one buffer
            refs[res] = m
        w.line(f"{ct} {m.name}[{_size(m.shape)}] = {{}};")

    w.line("{  // prologue")
    w.depth += 1
    _Emitter(module, refs, w).run_effects(plan.prologue)
    w.depth -= 1
    w.line("}")
    w.line(f"for (int32_t pid = 0; pid < {plan.trip}; ++pid) {{  // main loop")
    w.depth += 1
    body = _Emitter(module, refs, w)
    body.env[plan.main.iv] = body._bind(
        "int32_t",
        f"{_literal(plan.lb, 'int32_t')} + pid * {_literal(plan.step, 'int32_t')}",
        _ident(plan.main.iv.name or "iv") + "_")
    body.run_region(plan.main.region(0))
    w.depth -= 1
    w.line("}")
    w.line("{  // epilogue")
    w.depth += 1
    _Emitter(module, refs, w).run_effects(plan.epilogue)
    w.depth -= 1
    w.line("}")

    bytes_per_lane = sum(_size(refs[a].shape) * (2 if refs[a].ctype == "__half" else
                                                 8 if refs[a].ctype == "double" else 4)
                         for a in plan.in_args + plan.out_args)
    head = [
        f"// Generated from HIR function @{func_name} by repro_torch.core.lower.to_cuda.",
        "// Replaces: repro/core/lower/to_pallas.py, the generated `kernel` driven by",
        "// `_KernelInterp` (one pallas_call per design, main loop as sequential grid).",
        "// Bound on this card: bytes. One lane is a chain of dependent scalar ops over",
        f"// {bytes_per_lane} bytes of stimulus and results; no parallelism exists inside it.",
        "// Design: one thread runs one lane (an independent stimulus vector) from",
        "// prologue through the main loop to the epilogue; hir.alloc buffers are",
        "// per-thread arrays; the grid covers the lanes.",
        "#include <cstdint>",
        "#include <cuda_runtime.h>",
    ]
    if uses_half:
        head.append("#include <cuda_fp16.h>")
    void_params = [("const void* " if a in plan.in_args else "void* ") + n
                   for a, n in zip(plan.in_args + plan.out_args, names)]
    casts = [f"({'const ' if a in plan.in_args else ''}{refs[a].ctype}*){n}"
             for a, n in zip(plan.in_args + plan.out_args, names)]
    launcher = f"launch_hir_{sym}"
    text = "\n".join(
        head + [_PREAMBLE,
                f'extern "C" __global__ void __launch_bounds__({THREADS_PER_BLOCK})',
                f"hir_{sym}({', '.join(params + ['int lanes'])}) {{",
                "  const int lane = blockIdx.x * blockDim.x + threadIdx.x;",
                "  if (lane >= lanes) return;"]
        + w.lines
        + ["}", "",
           f'extern "C" int {launcher}({", ".join(void_params + ["int lanes", "void* stream"])}) {{',
           f"  const int threads = {THREADS_PER_BLOCK};",
           "  const int blocks = (lanes + threads - 1) / threads;",
           f"  hir_{sym}<<<blocks, threads, 0, (cudaStream_t)stream>>>("
           f"{', '.join(casts + ['lanes'])});",
           "  return (int)cudaGetLastError();",
           "}", ""])
    return text, launcher


# ---------------------------------------------------------------------------
# The callable
# ---------------------------------------------------------------------------


class CudaLowered:
    """What ``lower_to_cuda`` returns: call it with one array per read-port
    memref, each of the memref's shape (one lane) or with one leading
    ``lanes`` dimension; get ``{name: tensor}`` for the write/rw-port
    memrefs, with the same leading dimension.

    Numpy arrays go to the device chosen at lowering; tensors stay where
    they are.  Tensors on a CUDA device run the generated kernel (built at
    first use; a build or launch failure raises); CPU tensors run the plain
    version."""

    def __init__(self, module: Module, func_name: str, device: torch.device,
                 allow_downcast: bool):
        self._plan = _Plan(module, func_name)
        self.device = device
        self.allow_downcast = allow_downcast
        self.source, self._launcher_name = _generate(self._plan, allow_downcast)
        self.stem = f"hir_{_ident(func_name)}"
        self.launches = 0
        self._launcher = None

    # -- building ------------------------------------------------------------
    def build(self):
        """Compile (or find compiled) the generated source and bind its
        launcher.  Called at the first CUDA run; callable ahead of it."""
        if self._launcher is None:
            from ...kernels import _build

            p = self._plan
            lib = _build.load_library(self.stem, self.source)
            self._launcher = _build.bind(
                lib, self._launcher_name,
                [ctypes.c_void_p] * (len(p.in_args) + len(p.out_args))
                + [ctypes.c_int, ctypes.c_void_p])
        return self._launcher

    # -- running -------------------------------------------------------------
    def _inputs(self, arrays) -> tuple[list[torch.Tensor], Optional[int], torch.device]:
        p = self._plan
        if len(arrays) != len(p.in_args):
            raise ValueError(f"@{p.func.name} takes {len(p.in_args)} input arrays "
                             f"(one per read-port memref), got {len(arrays)}")
        devs = {x.device for x in arrays if isinstance(x, torch.Tensor)}
        if len(devs) > 1:
            raise ValueError(f"input tensors lie on different devices: {devs}")
        dev = devs.pop() if devs else self.device
        # inputs are read-port memrefs: neither version writes them
        ins, n = as_lane_tensors(
            arrays, [a.type for a in p.in_args],
            [_dtype(a.type.elem, self.allow_downcast) for a in p.in_args],
            dev, copy=False)
        return ins, n, dev

    def _out_shape(self, a: Value, lanes: Optional[int]) -> tuple:
        shape = tuple(a.type.shape)
        return shape if lanes is None else (lanes,) + shape

    def __call__(self, *arrays) -> dict[str, torch.Tensor]:
        ins, lanes, dev = self._inputs(arrays)
        if dev.type != "cuda":
            return self._run_plain(ins, lanes, dev)
        global launches
        p = self._plan
        launcher = self.build()
        outs = [torch.zeros(self._out_shape(a, lanes), device=dev,
                            dtype=_dtype(a.type.elem, self.allow_downcast))
                for a in p.out_args]
        from ...kernels import _build

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = launcher(*[t.data_ptr() for t in ins + outs],
                          1 if lanes is None else lanes, stream)
        _build.check_launch(rc, self._launcher_name)
        self.launches += 1
        launches += 1
        return {a.name: o for a, o in zip(p.out_args, outs)}

    def plain(self, *arrays) -> dict[str, torch.Tensor]:
        """The plain PyTorch version on the same inputs, wherever they lie."""
        return self._run_plain(*self._inputs(arrays))

    def _run_plain(self, ins, lanes, dev) -> dict[str, torch.Tensor]:
        p = self._plan
        batched = lanes is not None
        ref_of: dict[Value, torch.Tensor] = dict(zip(p.in_args, ins))
        for a in p.out_args:
            ref_of[a] = torch.zeros(self._out_shape(a, lanes), device=dev,
                                    dtype=_dtype(a.type.elem, self.allow_downcast))
        for al in p.allocs:
            base: MemrefType = al.attrs["base"]
            buf = torch.zeros(((lanes,) if batched else ()) + tuple(base.shape),
                              device=dev, dtype=_dtype(base.elem, self.allow_downcast))
            for res in al.results:          # every port aliases one buffer
                ref_of[res] = buf
        _PlainInterp(p.module, ref_of, batched).run_effects(p.prologue)
        for pid in range(p.trip):
            body = _PlainInterp(p.module, ref_of, batched)
            body.env[p.main.iv] = p.lb + pid * p.step
            body.run_region(p.main.region(0))
        _PlainInterp(p.module, ref_of, batched).run_effects(p.epilogue)
        return {a.name: ref_of[a] for a in p.out_args}


def lower_to_cuda(module: Module, func_name: str, *,
                  pipeline: Optional[str] = None,
                  allow_downcast: bool = False,
                  device: Optional[Union[str, torch.device]] = None) -> CudaLowered:
    """Lower ``@func_name`` to a callable mapping input arrays (one per
    read-port memref arg) to a dict of output tensors (write-port args).

    ``pipeline`` optionally names a ``PassManager`` spec run on ``module``
    (in place) before lowering, mirroring ``lower_to_torch``.

    ``device=None`` means the CUDA device, and raises when there is none;
    ``device="cpu"`` runs the plain version.

    Dtype policy (see ``lower.common.cuda_dtype``): every HIR float width is
    native on Hopper, so ``f64`` and ``f16`` memrefs lower as they are;
    ``allow_downcast`` is accepted for parity and changes nothing."""
    dev = resolve_device(device)
    if pipeline:
        from ..passmgr import PassManager

        PassManager.from_spec(pipeline).run(module)
    return CudaLowered(module, func_name, dev, allow_downcast)
