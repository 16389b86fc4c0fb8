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
                arrays (registers), or, where indexed at run time, a thread's
                column of shared memory, or, past ``LOCAL_ALLOC_BYTES``, a
                lane's column of a global scratch buffer the call allocates
                (a per-thread array that large would live in local memory,
                which CUDA reserves for every thread the card can hold
                and keeps: 40 GB for a traced softmax row of 4096).

What bounds it on the card: one design run is a few hundred *dependent*
scalar operations over a few hundred bytes — nothing in it can be spread
over threads.  The card gets its work from **lanes**: independent stimulus
vectors (the differential-verification workload), one thread per lane.  The
kernel's bound is the bytes of stimulus read and results written; what keeps
it from there is that a lane's array lies a whole array away from the next
lane's, so 32 threads reading their own lanes touch 32 cache lines an
instruction, and at 4096 lanes an SM runs a single warp, which waits out
every access.  Three things answer it (``_generate``'s header says which a
kernel uses):

* blocks are sized from the lane count and the SMs, so they cover the card;
* the memrefs the main loop touches at indices known ahead (loop ivs and
  constants) are *staged*: a helper warp beside each compute warp copies the
  boxes that the next chunk of iterations touches into shared memory, one
  lane's consecutive elements an instruction, and copies written boxes back,
  while the compute warp runs the current chunk there — the card's form of
  the Pallas grid's double buffering;
* other reads known ahead are prefetched into L1 some iterations early.

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

#: most lanes a block of the generated kernel runs (with staging, each lane's
#: compute thread has a helper thread beside it)
MAX_THREADS_PER_BLOCK = 128
#: bytes each SM keeps in flight through the main loop's prefetches: Little's
#: law at 3.35 TB/s over 132 SMs and about 700 ns of DRAM latency (17.8 KB)
PREFETCH_BYTES_PER_SM = 16384
#: shared memory one block can use on Hopper (227 KB)
SMEM_BYTES = 232_448
#: largest ``hir.alloc`` buffer kept as a per-thread array; larger ones not
#: in shared memory go to the call's global scratch, element-major
LOCAL_ALLOC_BYTES = 256


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
// A warp's 32 lanes, rows row0.. of a (lanes, size) array, copied between
// global memory and the warp's staging buffer: of each lane's array, seen as
// rows of `cols`, the box of nr rows from r0 and nc columns from c0; element
// e of the box (row e / pitch, column e % pitch) of lane l at st[e * 33 + l].
// A copy instruction moves consecutive elements of one lane's rows, and the
// stride of 33 keeps both sides free of bank conflicts.  Copies in are
// asynchronous (`cp.async`, all in flight at once; 2-byte elements go
// through registers) until hir_stage_wait.  Rows past `last_row` read that
// row instead (inputs of the lanes past the last).
template <typename T>
__device__ __forceinline__ void hir_stage_in(T* st, const T* g, int row0, int last_row,
                                             int size, int cols, int r0, int c0, int nr,
                                             int nc, int pitch) {
  const int t = threadIdx.x & 31;
#pragma unroll 4
  for (int l = 0; l < 32; ++l) {
    const T* src = g + (size_t)min(row0 + l, last_row) * size + r0 * cols + c0;
    for (int e = t; e < nr * pitch; e += 32) {
      const int r = e / pitch, c = e - r * pitch;
      if (c >= nc) continue;
      if constexpr (sizeof(T) >= 4) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"((uint32_t)__cvta_generic_to_shared(st + e * 33 + l)),
                        "l"(src + r * cols + c), "n"(sizeof(T)) : "memory");
      } else {
        st[e * 33 + l] = src[r * cols + c];
      }
    }
  }
}
__device__ __forceinline__ void hir_stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}
template <typename T>
__device__ __forceinline__ void hir_stage_out(const T* st, T* g, int row0, int last_row,
                                              int size, int cols, int r0, int c0, int nr,
                                              int nc, int pitch) {
  const int t = threadIdx.x & 31, n = nr * pitch;
  for (int l = 0; l < 32; ++l) {
    T* dst = g + (size_t)min(row0 + l, last_row) * size + r0 * cols + c0;
    for (int e0 = t; e0 < n; e0 += 4 * 32) {   // four reads in flight, then four writes
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 32 * u;
        if (e < n) v[u] = st[e * 33 + l];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 32 * u, r = e / pitch, c = e - r * pitch;
        if (e < n && c < nc) dst[r * cols + c] = v[u];
      }
    }
  }
}
// A compute warp and its helper meet at barrier pair + 1 (0 is __syncthreads').
__device__ __forceinline__ void hir_pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(pair + 1) : "memory");
}
// Ask L1 for the 32-byte sector that starts at p; other addresses ask for
// nothing, so a stream read element by element prefetches once a sector.
__device__ __forceinline__ void hir_prefetch(const void* p) {
  if (((uintptr_t)p & 31u) == 0) asm volatile("prefetch.global.L1 [%0];" :: "l"(p));
}
"""


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


class _CVal:
    """A C++ expression (a variable name or a literal) and its type."""

    __slots__ = ("expr", "ctype")

    def __init__(self, expr: str, ctype: str):
        self.expr = expr
        self.ctype = ctype


class _CMem:
    """A per-lane array visible in the kernel body: a lane's slice of a
    global memref, a per-thread array, a thread's column of a shared buffer
    (``shared``: element ``i`` at ``name[i * hir_lanes]``) or a lane's column
    of the global scratch (``scratch``: element ``i`` at
    ``name[i * hir_stride]``)."""

    __slots__ = ("name", "shape", "ctype", "shared", "scratch", "read_port", "window")

    def __init__(self, name: str, shape: tuple, ctype: str, shared: bool = False,
                 read_port: bool = False, window: Optional[tuple] = None,
                 scratch: bool = False):
        self.name = name
        self.shape = tuple(shape)
        self.ctype = ctype
        self.shared = shared
        self.scratch = scratch
        self.read_port = read_port
        # staged: (first row, first column, row pitch) of the warp's window,
        # the memref seen as (rows of every dim but the last, last dim)
        self.window = window

    def at(self, lin: str) -> str:
        if self.shared:
            return f"{self.name}[({lin}) * hir_lanes]"
        if self.scratch:
            return f"{self.name}[(size_t)({lin}) * hir_stride]"
        return f"{self.name}[{lin}]"


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
        self.dynamic: set[str] = set()     # arrays indexed by a run-time value
        self.prefetch_bytes = 0            # bytes one main-loop iteration prefetches
        self.trips = 1                     # iterations of the loops being walked

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
        return self._linear(ref.shape, ixs)

    def _linear(self, shape: tuple, ixs: tuple) -> str:
        if not any(isinstance(i, _CVal) for i in ixs):
            lin = 0
            for i, d in zip(ixs, shape):
                lin = lin * d + int(i)
            return str(lin)
        expr = ""
        for i, d in zip(ixs, shape):
            term = self._as(i, "int32_t") if isinstance(i, _CVal) else str(int(i))
            expr = term if not expr else f"({expr}) * {d} + {term}"
        return expr

    def _element(self, ref: _CMem, ixs: tuple) -> str:
        """The C++ element a read or write touches."""
        if not ref.window:
            return ref.at(self._index(ref, ixs))
        if len(ixs) != len(ref.shape):
            raise ValueError(f"{len(ixs)} indices into {ref.name} of rank {len(ref.shape)}")
        row0, col0, pitch = ref.window
        box = f"({self._linear(ref.shape[-1:], ixs[-1:])}) - {col0}"
        if len(ixs) > 1:
            box = f"(({self._linear(ref.shape[:-1], ixs[:-1])}) - {row0}) * {pitch} + {box}"
        return f"{ref.name}[({box}) * 33 + hir_t]"

    def _note(self, ref: _CMem, ixs: tuple) -> None:
        if any(isinstance(i, _CVal) for i in ixs):
            self.ctx.dynamic.add(ref.name)

    def read(self, ref, ixs):
        self._note(ref, ixs)
        return self._bind(ref.ctype, self._element(ref, ixs), "r")

    def write(self, ref, ixs, val, pred):
        self._note(ref, ixs)
        store = f"{self._element(ref, ixs)} = {self._as(val, ref.ctype)};"
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


#: a value read from memory: an index built from it is known only at run time
_DATA = object()


class _Prefetcher(_Emitter):
    """Walks the main loop's body for a later iteration and emits only the
    address arithmetic and the prefetches of its reads: reads of read-port
    memrefs whose index resolves through pure ops from loop ivs and
    constants.  A read's value is ``_DATA``, so an index that depends on
    data (histogram's bins) gets no prefetch; writes emit nothing."""

    def arith(self, opname, args):
        if any(a is _DATA for a in args):
            return _DATA
        return super().arith(opname, args)

    def run_effect(self, op: Operation) -> None:
        if op.opname == "mem_write":
            return
        if op.opname != "mem_read":
            super().run_effect(op)
            return
        mem, idx = ir.mem_read_parts(op)
        ref, ixs = self.refs[mem], tuple(self.value(i) for i in idx)
        self.env[op.result] = _DATA
        if (not ref.read_port or ref.window or any(i is _DATA for i in ixs)
                or not any(isinstance(i, _CVal) for i in ixs)):
            return                  # data-dependent, or the same address every time
        w = self.ctx
        w.prefetch_bytes += w.trips * _ELEM_BYTES[ref.ctype]
        lin = self._bind("int32_t", self._index(ref, ixs), "p")
        w.line(f"if ({lin.expr} >= 0 && {lin.expr} < {_size(ref.shape)}) "
               f"hir_prefetch({ref.name} + {lin.expr});")

    def loop(self, op, trip, lb, step):
        self.ctx.trips *= trip
        super().loop(op, trip, lb, step)
        self.ctx.trips //= trip


_ELEM_BYTES = {"int32_t": 4, "__half": 2, "float": 4, "double": 8}


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


def generate_cuda_source(module: Module, func_name: str,
                         allow_downcast: bool = False) -> tuple[str, str]:
    """CUDA C++ text for ``@func_name`` and the name of its launcher (see
    ``_generate``).  Needs no compiler and no device."""
    k = _generate(_Plan(module, func_name), allow_downcast)
    return k.source, k.launcher


class _Kernel:
    """A generated kernel: its text, its launcher's name, the bytes one
    main-loop iteration prefetches (0: none), the shared memory a lane's
    allocs take and a compute warp's pair takes for staging, the allocs
    placed in shared memory and the memrefs staged, with the chunk of
    main-loop iterations one staging serves (0: none staged), the
    write-port memrefs the kernel writes whole (their outputs need no
    zeros first), and the allocs in the global scratch with its bytes a
    lane (the launcher then takes the scratch after the memrefs)."""

    def __init__(self, source: str, launcher: str, prefetch_bytes: int,
                 smem_per_thread: int, stage_per_pair: int, shared_allocs: list[str],
                 staged: list[str], chunk: int, written_whole: list[str],
                 scratch_allocs: list[str], scratch_bytes: int):
        self.source = source
        self.launcher = launcher
        self.prefetch_bytes = prefetch_bytes
        self.smem_per_thread = smem_per_thread
        self.stage_per_pair = stage_per_pair
        self.shared_allocs = shared_allocs
        self.staged = staged
        self.chunk = chunk
        self.written_whole = written_whole
        self.scratch_allocs = scratch_allocs
        self.scratch_bytes = scratch_bytes

    def smem_bytes(self, lanes_per_block: int) -> int:
        """Dynamic shared memory of a block that runs ``lanes_per_block`` lanes."""
        return (self.smem_per_thread * lanes_per_block
                + self.stage_per_pair * (lanes_per_block // 32))


class _Tracer(_Interp):
    """Walks the main loop's body over Python numbers.  ``ctx`` is a dict:
    ``span`` gets, per memref name, the box (first and last row, first and
    last column; the memref seen as rows of its last dim) this iteration
    touches at indices known ahead (loop ivs and constants alone);
    ``wrote`` the elements it writes unconditionally; ``read`` the memrefs
    it reads; ``data`` the memrefs touched at an index that depends on
    data; ``touches`` counts accesses."""

    def arith(self, opname, args):
        if any(a is _DATA for a in args):
            return _DATA
        return _ARITH[opname](*args)

    def _touch(self, ref: _CMem, ixs: tuple) -> Optional[int]:
        self.ctx["touches"] += 1
        if self.ctx["touches"] > _TRACE_LIMIT:
            raise _TraceTooLong
        if any(i is _DATA for i in ixs):
            self.ctx["data"].add(ref.name)
            return None
        lin = 0
        for i, d in zip(ixs, ref.shape):
            lin = lin * d + int(i)
        r, c = divmod(lin, ref.shape[-1])
        r0, r1, c0, c1 = self.ctx["span"].get(ref.name, (r, r, c, c))
        self.ctx["span"][ref.name] = (min(r0, r), max(r1, r), min(c0, c), max(c1, c))
        return lin

    def read(self, ref, ixs):
        self._touch(ref, ixs)
        self.ctx["read"].add(ref.name)
        return _DATA

    def write(self, ref, ixs, val, pred):
        lin = self._touch(ref, ixs)
        if lin is not None and (pred is None or (pred is not _DATA and pred != 0)):
            self.ctx["wrote"].setdefault(ref.name, set()).add(lin)

    def loop(self, op, trip, lb, step):
        for t in range(trip):
            body = self.fork(self.env)
            body.env[op.iv] = lb + t * step
            body.run_region(op.region(0))


class _TraceTooLong(Exception):
    pass


_TRACE_LIMIT = 200_000          # accesses the generator walks to plan the staging
#: bytes of staging windows (two buffers of each) one compute warp's pair holds
STAGE_BYTES_PER_PAIR = 196608
#: most main-loop iterations a chunk: the first chunk's copy in and the last
#: one's copy out are not hidden behind compute, so chunks stay short
MAX_CHUNK = 128


class _Window:
    """How one memref is staged: its box of ``rows`` x ``cols`` elements
    (the memref seen as rows of its last dim) at ``offset`` in a warp's
    buffer; the box's first row and column in each chunk; whether the main
    loop writes it, and whether the box must be copied in (not when the
    loop only writes it and writes all of every chunk's box)."""

    def __init__(self, offset, rows, cols, row0s, col0s, written, load, elem_bytes):
        self.offset, self.rows, self.cols = offset, rows, cols
        self.row0s, self.col0s = row0s, col0s
        self.written, self.load = written, load
        self.nbytes = 2 * (-(-rows * cols * 33 * elem_bytes // 16) * 16)     # two buffers


class _Staging:
    """Which memrefs the main loop touches through a warp's shared windows:
    ``chunk`` main-loop iterations a staging, a ``_Window`` per memref name;
    and the memrefs whose every element the main loop writes unconditionally
    (``whole``)."""

    def __init__(self, chunk: int, mems: dict, whole: frozenset = frozenset()):
        self.chunk = chunk
        self.mems = mems
        self.whole = whole
        self.per_pair = sum(win.nbytes for win in mems.values())


def _boxes(spans: list, chunk: int) -> tuple[list, list, int, int]:
    """Each chunk's first row and column, and the box that holds every
    chunk's: (row0s, col0s, rows, cols)."""
    row0s, col0s, rows, cols = [], [], 1, 1
    for k0 in range(0, len(spans), chunk):
        part = [sp for sp in spans[k0:k0 + chunk] if sp is not None] or [(0, 0, 0, 0)]
        r0, c0 = min(sp[0] for sp in part), min(sp[2] for sp in part)
        row0s.append(r0)
        col0s.append(c0)
        rows = max(rows, max(sp[1] for sp in part) - r0 + 1)
        cols = max(cols, max(sp[3] for sp in part) - c0 + 1)
    return row0s, col0s, rows, cols


def _covers(wrote: list, shape: tuple, chunk: int, box: tuple) -> bool:
    """Whether each chunk writes every element of its box (clipped to the
    memref) unconditionally."""
    row0s, col0s, rows, cols = box
    n_rows, n_cols = _size(shape[:-1]), shape[-1]
    for k, k0 in enumerate(range(0, len(wrote), chunk)):
        done = set().union(*wrote[k0:k0 + chunk])
        if len(done) != min(rows, n_rows - row0s[k]) * min(cols, n_cols - col0s[k]):
            return False
    return True


def _plan_staging(plan: _Plan, refs: dict) -> _Staging:
    """Stage the memrefs (arguments, not allocs) that the main loop touches
    only at indices known ahead, in as long chunks (a power of two, at most
    256 iterations) as their boxes allow within ``STAGE_BYTES_PER_PAIR``;
    where even one iteration's boxes do not fit, the memref with the widest
    is left out and the rest tried again."""
    spans_of: dict[str, list] = {}
    wrote_of: dict[str, list] = {}
    ctx = {"data": set(), "read": set(), "touches": 0}
    try:
        for pid in range(plan.trip):
            ctx["span"], ctx["wrote"] = {}, {}
            t = _Tracer(plan.module, refs, ctx)
            t.env[plan.main.iv] = plan.lb + pid * plan.step
            t.run_region(plan.main.region(0))
            for name, sp in ctx["span"].items():
                spans_of.setdefault(name, [None] * plan.trip)[pid] = sp
                wrote_of.setdefault(name, [set()] * plan.trip)[pid] = ctx["wrote"].get(name, set())
    except _TraceTooLong:
        return _Staging(0, {})
    args = {refs[a].name: refs[a] for a in plan.in_args + plan.out_args}
    cands = [n for n in args if n in spans_of and n not in ctx["data"]]
    whole = frozenset(n for n in cands
                      if len(set().union(*wrote_of[n])) == _size(args[n].shape))

    def window(n: str, chunk: int, offset: int) -> Optional[_Window]:
        """None where a box is copied in and out and meets the next chunk's:
        the helper copies chunk k + 1 in before chunk k is copied out."""
        m = args[n]
        row0s, col0s, rows, cols = box = _boxes(spans_of[n], chunk)
        written = not m.read_port
        load = not (written and n not in ctx["read"]
                    and _covers(wrote_of[n], m.shape, chunk, box))
        if written and load and any(
                abs(row0s[k + 1] - row0s[k]) < rows and abs(col0s[k + 1] - col0s[k]) < cols
                for k in range(len(row0s) - 1)):
            return None
        return _Window(offset, rows, cols, row0s, col0s, written, load, _ELEM_BYTES[m.ctype])

    chunks = [c for c in (256, 128, 64, 32, 16, 8, 4, 2, 1) if c <= min(plan.trip, MAX_CHUNK)]
    while cands:
        for chunk in chunks:
            mems, off = {}, 0
            for n in cands:
                win = window(n, chunk, off)
                if win is not None:
                    mems[n] = win
                    off += win.nbytes
            if off <= STAGE_BYTES_PER_PAIR:
                return _Staging(chunk, mems, whole)
        cands.remove(max(cands, key=lambda n: _boxes(spans_of[n], 1)[2] * _boxes(spans_of[n], 1)[3]
                         * _ELEM_BYTES[args[n].ctype]))
    return _Staging(0, {}, whole)


def _window_start(name: str, starts: list[int]) -> str:
    """A device function of the chunk giving its box's first row or column."""
    step = starts[1] - starts[0] if len(starts) > 1 else 0
    if all(v == starts[0] + k * step for k, v in enumerate(starts)):
        return (f"__device__ __forceinline__ int32_t {name}(int32_t k) "
                f"{{ return {starts[0]} + k * {step}; }}")
    return (f"__device__ const int32_t {name}_at[{len(starts)}] = "
            f"{{{', '.join(map(str, starts))}}};\n"
            f"__device__ __forceinline__ int32_t {name}(int32_t k) {{ return {name}_at[k]; }}")


def _refs(plan: _Plan, allow_downcast: bool, shared: dict[int, int],
          scratch: frozenset = frozenset()) -> dict[Value, _CMem]:
    """The arrays of the kernel body: a lane's slice of each memref
    argument, and the allocs (those indexed in ``shared`` in a thread's
    shared column, those in ``scratch`` in a lane's scratch column)."""
    refs: dict[Value, _CMem] = {}
    for a in plan.in_args + plan.out_args:
        ct = _CTYPE[_dtype(a.type.elem, allow_downcast)]
        refs[a] = _CMem(f"m_{_ident(a.name)}", a.type.shape, ct, read_port=a in plan.in_args)
    for k, al in enumerate(plan.allocs):
        base: MemrefType = al.attrs["base"]
        ct = _CTYPE[_dtype(base.elem, allow_downcast)]
        m = _CMem(f"a{k}_{_ident(al.results[0].name or 'buf')}", base.shape, ct,
                  shared=k in shared, scratch=k in scratch)
        for res in al.results:          # every port aliases one buffer
            refs[res] = m
    return refs


def _box_args(plan: _Plan, a: Value, m: _CMem, win: _Window, chunk: str) -> str:
    """Arguments of hir_stage_in or hir_stage_out for ``chunk``'s box of
    memref ``a``, in buffer ``chunk & 1``, clipped to the memref."""
    name, rows, cols = _ident(a.name), _size(m.shape[:-1]), m.shape[-1]
    r0, c0 = f"hir_r0_{name}({chunk})", f"hir_c0_{name}({chunk})"
    lanes = "row0, lanes - 1" if a in plan.in_args else "row0, row0 + 31"
    half = win.nbytes // 2 // _ELEM_BYTES[m.ctype]
    return (f"s_{name} + (({chunk}) & 1) * {half}, g_{name}, {lanes}, {_size(m.shape)}, "
            f"{cols}, {r0}, {c0}, min({win.rows}, {rows} - {r0}), "
            f"min({win.cols}, {cols} - {c0}), {win.cols}")


def _helper(plan: _Plan, refs: dict, staging: _Staging) -> list[str]:
    """The helper warp of a pair: stages chunk k + 1 in and copies chunk
    k - 1 out while its compute warp runs chunk k, in two buffers."""
    staged = [(a, refs[a], staging.mems[refs[a].name]) for a in plan.in_args + plan.out_args
              if refs[a].name in staging.mems]
    n = -(-plan.trip // staging.chunk)

    def copy_in(chunk: str) -> list[str]:
        return [f"hir_stage_in({_box_args(plan, a, m, win, chunk)});"
                for a, m, win in staged if win.load] + ["hir_stage_wait();"]

    def copy_out(chunk: str) -> list[str]:
        return [f"hir_stage_out({_box_args(plan, a, m, win, chunk)});"
                for a, m, win in staged if win.written]

    def block(cond: str, lines: list[str]) -> list[str]:
        return [f"      if ({cond}) {{"] + ["        " + x for x in lines] + ["      }"]

    out = copy_out("k - 1")
    return (["  if (hir_helper) {  // stage chunks in and out for the compute warp",
             "    hir_pair_sync(pair);  // the prologue's writes are in memory"]
            + ["    " + x for x in copy_in("0")]
            + ["    hir_pair_sync(pair);  // chunk 0 staged",
               f"    for (int32_t k = 0; k < {n}; ++k) {{"]
            + (block("k > 0", out) if out else []) + block(f"k + 1 < {n}", copy_in("k + 1"))
            + ["      hir_pair_sync(pair);  // chunk k done, chunk k + 1 staged", "    }"]
            + ["    " + x for x in copy_out(f"{n - 1}")]
            + ["    hir_pair_sync(pair);  // the last chunk's results are in memory",
               "    return;", "  }"])


def _emit(plan: _Plan, allow_downcast: bool, shared: dict[int, int], staging: _Staging,
          scratch: Optional[dict[int, int]] = None):
    """The kernel body for the planned function: the helper warp's part
    (when memrefs are staged), then the compute warp's.  ``scratch`` maps
    allocs to their byte offset in a lane's part of the global scratch.
    Returns (writer, refs, file-scope declarations)."""
    module = plan.module
    w = _Writer()
    scratch = scratch or {}
    refs = _refs(plan, allow_downcast, shared, frozenset(scratch))
    staged = [(a, refs[a], staging.mems[refs[a].name]) for a in plan.in_args + plan.out_args
              if refs[a].name in staging.mems]
    decls = []
    main_refs = dict(refs)          # the main loop sees the staged memrefs' windows
    for a, m, win in staged:
        name = _ident(a.name)
        decls += [_window_start(f"hir_r0_{name}", win.row0s),
                  _window_start(f"hir_c0_{name}", win.col0s)]
        w.line(f"{m.ctype}* const s_{name} = reinterpret_cast<{m.ctype}*>"
               f"(hir_stage + {win.offset});")
        main_refs[a] = _CMem(f"b_{name}", m.shape, m.ctype, read_port=m.read_port,
                             window=(f"r0_{name}", f"c0_{name}", win.cols))
    if staged:
        w.lines += _helper(plan, refs, staging)
    for a in plan.in_args + plan.out_args:
        m = refs[a]
        const = "const " if a in plan.in_args else ""
        w.line(f"{const}{m.ctype}* __restrict__ {m.name} = g_{_ident(a.name)} "
               f"+ (size_t){'in_lane' if a in plan.in_args else 'lane'} * {_size(m.shape)};")
    for k, al in enumerate(plan.allocs):
        m = refs[al.results[0]]
        n = _size(m.shape)
        if m.shared:
            w.line(f"{m.ctype}* const {m.name} = reinterpret_cast<{m.ctype}*>("
                   f"hir_smem + {shared[k]} * hir_lanes) + hir_lane;")
            w.line(f"for (int32_t i = 0; i < {n}; ++i) {m.at('i')} = {_literal(0, m.ctype)};")
        elif m.scratch:
            w.line(f"{m.ctype}* const {m.name} = reinterpret_cast<{m.ctype}*>("
                   f"hir_scratch + (size_t){scratch[k]} * hir_stride) + lane;")
            w.line(f"for (int32_t i = 0; i < {n}; ++i) {m.at('i')} = {_literal(0, m.ctype)};")
        else:
            w.line(f"{m.ctype} {m.name}[{n}] = {{}};")

    w.line("{  // prologue")
    w.depth += 1
    _Emitter(module, refs, w).run_effects(plan.prologue)
    w.depth -= 1
    w.line("}")
    if staged:
        C = staging.chunk
        w.line("hir_pair_sync(pair);  // the prologue's writes are in memory")
        w.line("hir_pair_sync(pair);  // chunk 0 staged")
        w.line(f"for (int32_t k = 0; k < {-(-plan.trip // C)}; ++k) {{  "
               f"// main loop, {C} iterations a chunk")
        w.depth += 1
        for a, m, win in staged:
            name = _ident(a.name)
            half = win.nbytes // 2 // _ELEM_BYTES[m.ctype]
            w.line(f"const int32_t r0_{name} = hir_r0_{name}(k), c0_{name} = hir_c0_{name}(k);")
            w.line(f"{m.ctype}* __restrict__ const b_{name} = s_{name} + (k & 1) * {half};")
        w.line(f"for (int32_t pid = k * {C}; pid < min((k + 1) * {C}, {plan.trip}); ++pid) {{")
    else:
        w.line(f"for (int32_t pid = 0; pid < {plan.trip}; ++pid) {{  // main loop")
    w.depth += 1
    iv_name = _ident(plan.main.iv.name or "iv") + "_"
    lb, step = _literal(plan.lb, "int32_t"), _literal(plan.step, "int32_t")
    # the reads of iteration pid + pf, asked for ahead of this iteration's
    start = len(w.lines)
    w.line(f"if (pid + pf < {plan.trip}) {{  // prefetch iteration pid + pf")
    w.depth += 1
    ahead = _Prefetcher(module, main_refs, w)
    ahead.env[plan.main.iv] = ahead._bind("int32_t", f"{lb} + (pid + pf) * {step}", iv_name)
    ahead.run_region(plan.main.region(0))
    w.depth -= 1
    w.line("}")
    if not w.prefetch_bytes:
        del w.lines[start:]
    body = _Emitter(module, main_refs, w)
    body.env[plan.main.iv] = body._bind("int32_t", f"{lb} + pid * {step}", iv_name)
    body.run_region(plan.main.region(0))
    w.depth -= 1
    w.line("}")
    if staged:
        w.line("hir_pair_sync(pair);  // chunk k done, chunk k + 1 staged")
        w.depth -= 1
        w.line("}")
        w.line("hir_pair_sync(pair);  // the last chunk's results are in memory")
    w.line("{  // epilogue")
    w.depth += 1
    _Emitter(module, refs, w).run_effects(plan.epilogue)
    w.depth -= 1
    w.line("}")
    return w, refs, decls


def _place_allocs(plan: _Plan, allow_downcast: bool, dynamic: set[str],
                  room: int) -> dict[int, int]:
    """Allocs that go to shared memory, by index, with their byte offset in a
    thread's column: those indexed by a run-time value somewhere (the rest
    are indexed by constants only and stay in registers), in order, while
    they fit in ``room`` bytes a thread."""
    refs = _refs(plan, allow_downcast, {})
    shared, used = {}, 0
    for k, m in enumerate(refs[al.results[0]] for al in plan.allocs):
        nbytes = -(-_size(m.shape) * _ELEM_BYTES[m.ctype] // 16) * 16
        if m.name in dynamic and used + nbytes <= room:
            shared[k] = used
            used += nbytes
    return shared


def _place_scratch(plan: _Plan, allow_downcast: bool,
                   shared: dict[int, int]) -> dict[int, int]:
    """Allocs that go to the global scratch, by index, with their byte offset
    in a lane's part of it: those not in shared memory that are larger than
    ``LOCAL_ALLOC_BYTES``, in order, each 16-byte aligned."""
    refs = _refs(plan, allow_downcast, shared)
    scratch, used = {}, 0
    for k, m in enumerate(refs[al.results[0]] for al in plan.allocs):
        nbytes = _size(m.shape) * _ELEM_BYTES[m.ctype]
        if k not in shared and nbytes > LOCAL_ALLOC_BYTES:
            scratch[k] = used
            used += -(-nbytes // 16) * 16
    return scratch


def _generate(plan: _Plan, allow_downcast: bool) -> _Kernel:
    """The kernel for the planned function.

    The launcher is ``extern "C" int <launcher>(in..., out..., int lanes,
    int threads, int pf, void* stream)``: raw pointers to ``(lanes, *shape)``
    arrays, one per read-port memref then one per write/rw-port memref (the
    outputs hold a row for every thread of the last block: ``padded_lanes``);
    the threads of a block (``launch_shape``) and the prefetch distance in
    main-loop iterations (``prefetch_distance``).  It launches on ``stream``
    and returns ``cudaGetLastError()``."""
    func_name = plan.func.name
    sym = _ident(func_name)
    staging = _plan_staging(plan, _refs(plan, allow_downcast, {}))
    # a first walk finds the allocs indexed at run time; the second places
    # them, in what a block of one warp (and its helper) leaves beside the
    # staging buffers
    dynamic = _emit(plan, allow_downcast, {}, staging)[0].dynamic
    shared = _place_allocs(plan, allow_downcast, dynamic,
                           (SMEM_BYTES - staging.per_pair) // 32)
    scratch = _place_scratch(plan, allow_downcast, shared)
    w, refs, decls = _emit(plan, allow_downcast, shared, staging, scratch)
    args = plan.in_args + plan.out_args
    uses_half = any(m.ctype == "__half" for m in refs.values())
    alloc_refs = [refs[al.results[0]] for al in plan.allocs]
    smem = sum(-(-_size(alloc_refs[k].shape) * _ELEM_BYTES[alloc_refs[k].ctype] // 16) * 16
               for k in shared)
    shared_names = [alloc_refs[k].name for k in sorted(shared)]
    scratch_names = [alloc_refs[k].name for k in sorted(scratch)]
    scratch_bytes = sum(-(-_size(alloc_refs[k].shape) * _ELEM_BYTES[alloc_refs[k].ctype] // 16)
                        * 16 for k in scratch)
    local_names = [m.name for k, m in enumerate(alloc_refs) if k not in shared and k not in scratch]
    staged_names = [f"m_{_ident(a.name)}" for a in args if refs[a].name in staging.mems]
    per_block = 2 if staged_names else 1         # threads a block per lane it runs

    bytes_per_lane = sum(_size(refs[a].shape) * _ELEM_BYTES[refs[a].ctype] for a in args)
    head = [
        f"// Generated from HIR function @{func_name} by repro_torch.core.lower.to_cuda.",
        "// Replaces: repro/core/lower/to_pallas.py, the generated `kernel` driven by",
        "// `_KernelInterp` (one pallas_call per design, main loop as sequential grid).",
        "// Bound on this card: bytes, reached only if latency is hidden. One lane is a",
        f"// chain of dependent scalar ops over {bytes_per_lane} bytes of stimulus and results;",
        "// no parallelism exists inside it. Design: one thread runs one lane (an",
        "// independent stimulus vector) from prologue through the main loop to the",
        "// epilogue; the launcher gives a block 32..128 lanes so that the blocks cover",
        "// every SM; threads past the last lane run its inputs into spare output rows.",
    ]
    if staged_names:
        head += [
            f"// Staging: {', '.join(staged_names)} are touched in the main loop only at",
            "// indices known ahead (loop ivs and constants), within a box of rows and",
            f"// columns a chunk of {staging.chunk} iterations. Each compute warp has a helper "
            "warp that",
            "// copies its 32 lanes' boxes into shared memory for chunk k + 1, one lane's",
            "// consecutive elements an instruction, and written boxes of chunk k - 1 back,",
            "// while the compute warp runs chunk k on chunk k's copies (two buffers,",
            f"// {staging.per_pair} bytes a pair). The lanes' arrays lie a whole array apart, "
            "so a",
            "// thread reading its own lane would touch 32 cache lines an instruction.",
        ]
    if w.prefetch_bytes:
        head += [
            f"// Prefetch: the unstaged reads of an iteration take {w.prefetch_bytes} bytes at "
            "addresses",
            "// that depend on loop ivs and constants alone; iteration pid asks L1 for those",
            "// of iteration pid + pf (one prefetch per 32-byte sector, inside the memref),",
            f"// with pf = {PREFETCH_BYTES_PER_SM} / (lanes per SM x {w.prefetch_bytes}) "
            "iterations from the launcher,",
            f"// so that each SM keeps about {PREFETCH_BYTES_PER_SM} bytes in flight.",
        ]
    else:
        head.append("// Prefetch: none (no unstaged read's address is known ahead of its "
                    "iteration).")
    if shared_names:
        head.append(f"// Shared memory, element-major ({smem} bytes a lane; element i of a "
                    "lane's buffer")
        head.append("// at [i * hir_lanes + hir_lane], one bank per thread): "
                    + ", ".join(shared_names) + ".")
    if scratch_names:
        head.append(f"// Global scratch, element-major ({scratch_bytes} bytes a lane; element i "
                    "of a lane's buffer")
        head.append("// at [i * hir_stride + lane] over the grid's lanes, each warp's 32 "
                    "lanes adjacent): " + ", ".join(scratch_names) + ".")
    if local_names:
        head.append("// Per-thread arrays: " + ", ".join(local_names) + ".")
    head += ["#include <cstdint>", "#include <cuda_runtime.h>"]
    if uses_half:
        head.append("#include <cuda_fp16.h>")

    params = [f"{'const ' if a in plan.in_args else ''}{refs[a].ctype}* __restrict__ "
              f"g_{_ident(a.name)}" for a in args]
    void_params = [("const void* " if a in plan.in_args else "void* ") + f"g_{_ident(a.name)}"
                   for a in args]
    casts = [f"({'const ' if a in plan.in_args else ''}{refs[a].ctype}*)g_{_ident(a.name)}"
             for a in args]
    if scratch_names:
        params.append("unsigned char* __restrict__ hir_scratch")
        void_params.append("void* scratch")
        casts.append("(unsigned char*)scratch")
    launcher = f"launch_hir_{sym}"
    if staged_names:      # threads 64p..64p+31 compute, 64p+32..64p+63 help them
        entry = ["  const int pair = threadIdx.x / 64;",
                 "  const bool hir_helper = (threadIdx.x & 32) != 0;",
                 "  const int hir_t = threadIdx.x & 31;",
                 "  const int hir_lanes = blockDim.x / 2, hir_lane = pair * 32 + hir_t;"]
    else:
        entry = ["  const int hir_lanes = blockDim.x, hir_lane = threadIdx.x;"]
    entry += ["  const int lane = blockIdx.x * hir_lanes + hir_lane;",
              "  const int in_lane = min(lane, lanes - 1);"]
    if scratch_names:
        entry.append("  const size_t hir_stride = (size_t)gridDim.x * hir_lanes;")
    if shared or staged_names:
        entry.append("  extern __shared__ __align__(16) unsigned char hir_smem[];")
    if staged_names:
        entry += ["  const int row0 = lane - hir_t;",
                  f"  unsigned char* const hir_stage = hir_smem + {smem} * hir_lanes"
                  f" + pair * {staging.per_pair};"]
    max_threads = per_block * MAX_THREADS_PER_BLOCK
    launch = [f'extern "C" int {launcher}('
              f'{", ".join(void_params + ["int lanes", "int threads", "int pf", "void* stream"])}) {{',
              "  // threads: lanes a block runs (a multiple of 32, at most "
              f"{MAX_THREADS_PER_BLOCK})",
              f"  const size_t smem = (size_t){smem} * threads"
              f" + (size_t){staging.per_pair} * (threads / 32);",
              f"  if (threads < 32 || threads > {MAX_THREADS_PER_BLOCK} || threads % 32 || pf < 1"
              f" || smem > {SMEM_BYTES})",
              "    return (int)cudaErrorInvalidValue;"]
    if smem * MAX_THREADS_PER_BLOCK + staging.per_pair * 4 > 48 * 1024:
        launch += ["  static bool attr_set = false;   // once per kernel",
                   "  if (!attr_set) {",
                   f"    const cudaError_t e = cudaFuncSetAttribute(hir_{sym}, "
                   "cudaFuncAttributeMaxDynamicSharedMemorySize,",
                   f"                                               {SMEM_BYTES});",
                   "    if (e != cudaSuccess) return (int)e;",
                   "    attr_set = true;",
                   "  }"]
    launch += ["  const int blocks = (lanes + threads - 1) / threads;",
               f"  hir_{sym}<<<blocks, {per_block} * threads, smem, (cudaStream_t)stream>>>("
               f"{', '.join(casts + ['lanes', 'pf'])});",
               "  return (int)cudaGetLastError();",
               "}", ""]
    text = "\n".join(
        head + [_PREAMBLE] + decls + ([""] if decls else [])
        + [f'extern "C" __global__ void __launch_bounds__({max_threads})',
           f"hir_{sym}({', '.join(params + ['int lanes', 'int pf'])}) {{"]
        + entry + w.lines + ["}", ""] + launch)
    written_whole = [a.name for a in plan.out_args
                     if a.type.port == ir.PORT_W and refs[a].name in staging.whole]
    return _Kernel(text, launcher, w.prefetch_bytes, smem, staging.per_pair, shared_names,
                   staged_names, staging.chunk, written_whole, scratch_names, scratch_bytes)


def block_threads(lanes: int, sm_count: int) -> int:
    """Threads a block of the generated kernel: 128 only when the lanes fill
    every SM with 128-thread blocks, else 64 when they fill it with those,
    else 32 (one warp a block, so the blocks reach as many SMs as there are
    warps of lanes)."""
    for t in (MAX_THREADS_PER_BLOCK, 64):
        if -(-lanes // t) >= sm_count:
            return t
    return 32


def prefetch_distance(lanes: int, sm_count: int, prefetch_bytes: int, trip: int,
                      threads: int = 32) -> int:
    """Main-loop iterations between a prefetch and the read it serves, so that
    each SM keeps about ``PREFETCH_BYTES_PER_SM`` in flight: the lanes an SM
    runs at once times the bytes one iteration reads, times the distance."""
    if not prefetch_bytes:
        return 1
    blocks = -(-lanes // threads)
    per_sm = min(-(-blocks // sm_count) * threads, 2048)    # 2048 threads an SM at most
    return max(1, min(trip, PREFETCH_BYTES_PER_SM // (per_sm * prefetch_bytes)))


# ---------------------------------------------------------------------------
# The callable
# ---------------------------------------------------------------------------


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (read once per device)."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


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
        self.kernel = _generate(self._plan, allow_downcast)
        self.source, self._launcher_name = self.kernel.source, self.kernel.launcher
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
                [ctypes.c_void_p] * (len(p.in_args) + len(p.out_args)
                                     + bool(self.kernel.scratch_allocs))
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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
        n = 1 if lanes is None else lanes
        threads, pf = self.launch_shape(n, dev)
        # a row for every thread of the last block: threads past the last
        # lane write there, and the caller sees the first ``n`` rows
        rows = -(-n // threads) * threads
        outs = [(torch.empty if a.name in self.kernel.written_whole else torch.zeros)(
                    (rows,) + tuple(a.type.shape), device=dev,
                    dtype=_dtype(a.type.elem, self.allow_downcast))
                for a in p.out_args]
        # the scratch of the allocs past LOCAL_ALLOC_BYTES: a column a thread
        scratch = ([torch.empty(self.kernel.scratch_bytes * rows, dtype=torch.uint8, device=dev)]
                   if self.kernel.scratch_allocs else [])
        from ...kernels import _build

        rc = _build.on_device(dev, launcher, *[t.data_ptr() for t in ins + outs + scratch],
                              n, threads, pf)
        _build.check_launch(rc, self._launcher_name)
        self.launches += 1
        launches += 1
        return {a.name: o[0] if lanes is None else o[:n] for a, o in zip(p.out_args, outs)}

    def launch_shape(self, lanes: int, device: torch.device) -> tuple[int, int]:
        """(threads a block, prefetch distance) of a launch over ``lanes`` on
        ``device``, from its count of SMs: blocks cover every SM, and shrink
        until their shared memory fits."""
        sms = _sm_count(device)
        threads = block_threads(lanes, sms)
        while threads > 32 and self.kernel.smem_bytes(threads) > SMEM_BYTES:
            threads //= 2
        return threads, prefetch_distance(lanes, sms, self.kernel.prefetch_bytes,
                                          self._plan.trip, threads)

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
