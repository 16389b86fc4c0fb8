"""The batch simulator's kernel: a design's cycle tape as CUDA C++ (S1).

No TPU kernel stands behind it.  The reference runs one stimulus batch as
``jax.jit(jax.lax.scan(jax.vmap(step)))`` (``repro/core/codegen/sim.py``,
``_run_jax``): XLA fuses each cycle's tape into a few device loops.  Run
eagerly, the same tape costs several launches per tape entry per cycle, so
the port generates one kernel per design from the tape ``RTLSimulator._build``
made — the closed, flattened, topologically sorted ``comb_tape``, the
``clocked`` items, the ``results`` and the ``asserts`` — in the way
``core/lower/to_cuda.py`` generates one per HIR design.  Its plain version
is ``sim._TorchOps`` running the same tape.

Layout, one thread per stimulus lane and every cycle inside the kernel:

* ``t_start`` pulses at cycle 0; ``clk`` and ``rst`` read 0;
* combinational nets are straight-line locals, recomputed every cycle in
  tape order; each expression node is one local, shared by every use of a
  structurally identical node within the cycle;
* registers, controller state, the scalar inputs, return capture and the
  conflict counters are locals (registers), loaded from and written back
  to ``st32`` / ``st64`` lane fastest (``st32[row*B + lane]``);
* a shift register of depth 1 is such a local; a deeper one is a ring of
  ``depth`` words per lane, read and overwritten at ``t % depth``
  (``t & (depth - 1)`` for a power of two), its home rows in
  ``ring32`` / ``ring64``;
* each memory has a buffer of its own, ``(B, depth)``, a lane's words
  side by side (``m[lane*depth + addr]``): a lane walking its array reads
  one cache line for many cycles; addresses clamped to the memory as the
  reference does;
* a memory or a ring whose words for one block fit in shared memory lives
  there during the run, ``sm[(offset + addr)*LPB + tid]``: loaded from its
  buffer at the start, written back at the end where the tape writes it
  (rings always).  Each lane's words are its own, so no placement needs a
  barrier.  The budget (``SMEM_LANE_BYTES`` a lane, smallest first) lets
  two blocks of 32 lanes share an SM.  A memory too big for it is read and
  written in place through a pointer of its own, ``const __restrict__``
  where the tape never writes it;
* nonblocking semantics exactly as ``RTLSimulator._make_step``: every read
  and every next value of a cycle is computed before anything is written
  back; memory reads see the contents from before the cycle; memory writes
  are applied after them, in ``clocked`` order;
* with a trace buffer, each cycle's traced nets are written to a
  ``(cycles, names, B)`` int64 array; without one, nothing is traced.

Word sizes.  Every state word is masked to its width at each assignment, so
a word whose largest value is below 2**32 (a net 32 bits wide or narrower,
a flag, a counter) is stored in 4 bytes (``uint32_t``); only wider ones
keep 8.  A lane's conflict count is held in 32 bits: a run has fewer than
2**31 cycles.  Each expression node is computed in 32 bits where that gives
the tape's exact int64 value: where its range, derived from its operands'
ranges, lies in [0, 2**32), or where every user needs it only modulo 2**32
(``+ - * & | ^ ~``, ``<<`` by a constant, a ``Mux``'s arms, each ending in a
mask of 32 bits or fewer).  Compares, ``>>``, division, clamps and anything
whose full value matters stay 64-bit unless the range proves 32 bits
enough.  Arithmetic in 64 bits matches the tape's int64 math values:
``+ - * <<`` on ``unsigned long long`` and cast back (signed overflow and
shifts of negative values are undefined in C++), *floor* division with
``x / 0 == 0``, shift counts clamped as ``sim._compile_expr`` clamps them,
a negative count giving 0 on the left and the sign on the right as NumPy
does, and every assigned value masked to its net's width (at most 63 bits,
``sim._mask_of``).

Lanes a block: ``LANES_PER_BLOCK`` = 32, one warp.  Every design the port
runs has 4096 lanes, where 32 a block is what still gives each of the
card's 132 SMs a block.

What bounds it on the card: each lane's cycles are a chain of dependent
scalar operations; lanes are the only parallelism.  Its byte bound is the
lane state read once and written once; a cycle's work per lane is the
tape.  The per-lane body is plain C++ (``__host__ __device__``, no
intrinsics): a host build with a C++ compiler runs it over blocks of 32
lanes, shared memory a host array per block, which is how the CPU tests
hold it to ``_TorchOps``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .rtl import (Binop, CombAssign, Const, Expr, LoopController, MemRead,
                  MemWrite, Mux, PortConflictAssert, Ref, Repeat, RegAssign,
                  ShiftReg, Signed, Unop)

#: kernel launches made by every ``SimKernel`` (a run resets it to 0, drives
#: its path, and reads it to show the path used the kernel)
launches = 0

#: lanes (threads) a block
LANES_PER_BLOCK = 32
#: shared memory a block may take so that two share an SM (of 228 KB, 1 KB
#: of it reserved a block)
SMEM_BLOCK_BYTES = 112 * 1024
#: shared memory a lane may take
SMEM_LANE_BYTES = SMEM_BLOCK_BYTES // LANES_PER_BLOCK

_M32 = (1 << 32) - 1
_M64 = (1 << 64) - 1
_I64 = (-(1 << 63), (1 << 63) - 1)

_PRELUDE = r"""#include <stdint.h>
#ifndef __CUDACC__
#include <stdlib.h>
#include <string.h>
#define __host__
#define __device__
#endif
typedef long long i64;
typedef unsigned long long u64;

static __host__ __device__ inline i64 add_(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
static __host__ __device__ inline i64 sub_(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
static __host__ __device__ inline i64 mul_(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }
// floor division; x / 0 == 0; x / -1 wraps like the two's-complement negation
static __host__ __device__ inline i64 fdiv_(i64 a, i64 b) {
  if (b == 0) return 0;
  if (b == -1) return (i64)(0ULL - (u64)a);
  i64 q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}
// a << min(b, 62), 0 from b >= 63 on, 0 for a negative count
static __host__ __device__ inline i64 shl_(i64 a, i64 b) {
  return (b < 0 || b >= 63) ? 0 : (i64)((u64)a << b);
}
// a >> min(b, 63), arithmetic; the sign for a negative count
static __host__ __device__ inline i64 shr_(i64 a, i64 b) {
  if (b < 0) return a < 0 ? -1 : 0;
  return a >> (b < 63 ? b : 63);
}
static __host__ __device__ inline i64 clamp_(i64 a, i64 hi) { return a < 0 ? 0 : (a > hi ? hi : a); }
"""

_CMP = {"<", "<=", ">", ">=", "==", "!="}
#: ops whose value modulo 2**32 follows from their operands' values modulo
#: 2**32 (a ``mux``'s arms; its condition is needed whole)
_MODULAR = {"add", "sub", "mul", "and", "or", "xor", "not", "shlc", "mux", "copy"}
_C_OP = {"add": "+", "sub": "-", "mul": "*", "and": "&", "or": "|", "xor": "^"}
_C_FN = {"add": "add_", "sub": "sub_", "mul": "mul_"}


def _lit(v: int) -> str:
    """A C literal of ``v`` modulo 2**64."""
    if 0 <= v < (1 << 31):
        return f"{v}LL"
    return f"((i64)0x{v & _M64:x}ULL)"


def _wrap64(v: int) -> int:
    return ((v + (1 << 63)) & _M64) - (1 << 63)


def _fit(lo: int, hi: int) -> tuple[int, int]:
    """A range of exact values, or all of int64 where it leaves int64 (the
    C and the tape then wrap alike)."""
    return (lo, hi) if _I64[0] <= lo and hi <= _I64[1] else _I64


def _u32(hi: Optional[int]) -> bool:
    return hi is not None and 0 <= hi <= _M32


# -- where the state lives ----------------------------------------------------------------


@dataclass
class _Part:
    """A memory or a deep shift register: ``depth`` words a lane of
    ``nbytes``, in ``place`` ("shared" or "global"); ``row`` its first row of
    ``ring32``/``ring64`` (a memory has a buffer of its own, ``key``);
    ``sm_row`` its first row of shared words of its size (-1 in global)."""

    key: str
    depth: int
    nbytes: int
    place: str
    row: int = 0
    sm_row: int = -1
    written: bool = False


def _state_bounds(sim) -> dict[str, Optional[int]]:
    """The largest value each state key's words can hold (all are masked,
    so none is negative), or None where the tape does not bound it."""
    hi: dict[str, int] = {}

    def at_least(key: str, v: int) -> None:
        hi[key] = max(hi.get(key, 0), v)

    for key in sim.state_shape:
        hi[key] = 0
    for b in sim.binds:
        m = (1 << b.width) - 1
        if b.kind == "scalar":
            at_least(f"in:{b.port}", m)
        elif b.kind == "ram":
            at_least(b.memkey, m)
        else:
            for row in b.cells:
                for cn in row:
                    at_least(cn, m)
    for ent in sim.clocked:
        if ent[0] != "ctrl":            # sr, reg, memrd, memwr: (tag, key, ..., mask)
            at_least(ent[1], ent[-1])
        else:
            c = ent[1]
            at_least(c["iv"], c["ivmask"])
            at_least(c["active"], 1)
            if c["endp"]:
                at_least(c["endp"], 1)
            if c["iicnt"] and c["ii"] is not None and c["ii"] > 1:
                at_least(c["iicnt"], c["ii"] - 1)
    nets = _net_bounds(sim, hi)
    out: dict[str, Optional[int]] = dict(hi)
    for j, (dp, _vp) in enumerate(sim.results):
        out[f"ret:{j}:val"] = nets.get(dp)
        out[f"ret:{j}:seen"] = 1
    if sim.asserts:
        out["cf"] = (1 << 31) - 1
    return out


def _net_bounds(sim, state_hi: dict[str, int]) -> dict[str, int]:
    """The largest value of each net the cycle reads by name."""
    nets: dict[str, int] = {"t_start": 1, "clk": 0, "rst": 0}
    for pn, key in sim.scalar_inputs:
        nets[pn] = state_hi[key]
    for n in sim.state_nets:
        nets[n] = state_hi[n]
    for dest, key in sim.sr_loads:
        nets[dest] = state_hi[key]
    for dest, kind, payload, _reads in sim.comb_tape:
        nets[dest] = payload[1] if kind == "assign" else 1
    return nets


class _Layout:
    """Where each state key of ``sim.state_shape`` lives.

    ``slots``: (key, column or -1) of every register word, each a row of
    ``st32`` or ``st64`` (``slot_row``, ``slot_bytes``); ``mems`` and
    ``rings``: a ``_Part`` each (``mem_at``/``ring_at`` by key);
    ``buffers``: (name, words a lane, bytes a word) of every global buffer
    the kernel takes, in the order of its arguments: ``st32``, ``st64``,
    ``ring32``, ``ring64`` as (words, B), each memory as (B, words).
    ``place`` forces every memory and ring to "shared" or "global" (a test's
    switch); by default the smallest go to shared memory while a lane's
    words fit ``SMEM_LANE_BYTES``."""

    def __init__(self, sim, place: Optional[str] = None):
        if place not in (None, "shared", "global"):
            raise ValueError(f"place {place!r}: None, 'shared' or 'global'")
        bounds = _state_bounds(sim)
        self.bounds = bounds
        written = {ent[1] for ent in sim.clocked if ent[0] == "memwr"}
        self.slots: list[tuple[str, int]] = []
        self.slot_of: dict[tuple[str, int], int] = {}
        self.slot_bytes: list[int] = []
        self.slot_row: list[int] = []
        self.mems: list[_Part] = []
        self.rings: list[_Part] = []
        rows = {4: 0, 8: 0}
        ring_rows = {4: 0, 8: 0}
        for key, shape in sim.state_shape.items():
            nb = 4 if _u32(bounds.get(key)) else 8
            if key.startswith("mem:"):
                self.mems.append(_Part(key, shape[0], nb, "global", written=key in written))
            elif key.startswith("sr:") and shape[0] > 1:
                self.rings.append(_Part(key, shape[0], nb, "global", row=ring_rows[nb],
                                        written=True))
                ring_rows[nb] += shape[0]
            elif shape == ():
                self._slot(key, -1, nb, rows)
            else:                       # "cf", and shift registers of depth 1
                for col in range(shape[0]):
                    self._slot(key, col, nb, rows)
        self.mem_at = {p.key: p for p in self.mems}
        self.ring_at = {p.key: p for p in self.rings}
        self.sm_rows = {4: 0, 8: 0}
        used = 0
        for p in sorted(self.mems + self.rings, key=lambda p: p.depth * p.nbytes):
            size = p.depth * p.nbytes
            if place == "shared" or (place is None and used + size <= SMEM_LANE_BYTES):
                p.place, p.sm_row = "shared", self.sm_rows[p.nbytes]
                self.sm_rows[p.nbytes] += p.depth
                used += size
        self.smem_lane_bytes = 4 * self.sm_rows[4] + 8 * self.sm_rows[8]
        self.buffers: list[tuple[str, int, int]] = [
            (name, n, nb) for name, n, nb in (
                ("st32", rows[4], 4), ("st64", rows[8], 8),
                ("ring32", ring_rows[4], 4), ("ring64", ring_rows[8], 8)) if n]
        self.buffers += [(p.key, p.depth, p.nbytes) for p in self.mems]

    def _slot(self, key: str, col: int, nb: int, rows: dict) -> None:
        self.slot_of[(key, col)] = len(self.slots)
        self.slots.append((key, col))
        self.slot_bytes.append(nb)
        self.slot_row.append(rows[nb])
        rows[nb] += 1

    def placement(self) -> dict[str, str]:
        """Each memory and shift register: "registers", "shared" or "global"."""
        out = {key: "registers" for key, _ in self.slots if key.startswith("sr:")}
        out.update({p.key: p.place for p in self.mems + self.rings})
        return out

    def word_bytes(self) -> dict[str, int]:
        """A lane's state words by their size in bytes."""
        n = {4: 0, 8: 0}
        for nb in self.slot_bytes:
            n[nb] += 1
        for p in self.mems + self.rings:
            n[p.nbytes] += p.depth
        return {str(k): v for k, v in n.items()}


# -- the cycle as a graph of typed nodes ----------------------------------------------------


class _Node:
    """One value of a cycle: ``op`` over ``args`` (``k`` an op's constant),
    its exact range [lo, hi] and, once typed, ``ty`` "u32" or "i64"."""

    __slots__ = ("op", "args", "k", "lo", "hi", "uses", "root", "ty", "name", "code")

    def __init__(self, op, args=(), k=None, lo=0, hi=0, ty=None, code=None):
        self.op, self.args, self.k = op, tuple(args), k
        self.lo, self.hi = lo, hi
        self.uses: list[tuple[_Node, int]] = []
        self.root = False
        self.ty, self.name, self.code = ty, None, code

    @property
    def fits(self) -> bool:
        return 0 <= self.lo and self.hi <= _M32


def _range(op: str, a: _Node, b: Optional[_Node], k) -> tuple[int, int]:
    """The exact range of ``op`` over operands in the ranges of ``a``, ``b``."""
    if op == "add":
        return _fit(a.lo + b.lo, a.hi + b.hi)
    if op == "sub":
        return _fit(a.lo - b.hi, a.hi - b.lo)
    if op == "mul":
        c = [x * y for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
        return _fit(min(c), max(c))
    if op == "and":
        if a.lo >= 0 or b.lo >= 0:
            return 0, min(x.hi for x in (a, b) if x.lo >= 0)
        return _I64
    if op in ("or", "xor"):
        if a.lo >= 0 and b.lo >= 0:
            return 0, (1 << max(a.hi.bit_length(), b.hi.bit_length())) - 1
        return _I64
    if op == "not":
        return -a.hi - 1, -a.lo - 1
    if op == "copy":
        return a.lo, a.hi
    if op == "shlc":
        return _fit(a.lo << k, a.hi << k)
    if op == "shl":
        if a.lo < 0:
            return _I64
        return _fit(0, a.hi << min(max(b.hi, 0), 62))
    if op == "shrc":
        return a.lo >> k, a.hi >> k
    if op == "sign":
        return (0 if a.lo >= 0 else -1), (-1 if a.hi < 0 else 0)
    if op == "shr":
        return (0, a.hi) if a.lo >= 0 else (min(a.lo, -1), max(a.hi, 0))
    if op == "fdiv":
        if a.lo >= 0 and b.lo >= 0:
            return 0, a.hi
        m = max(abs(a.lo), abs(a.hi))
        return _fit(-m, m)
    if op in _CMP or op in ("land", "lor"):
        return 0, 1
    if op == "clamp":
        return min(max(a.lo, 0), k), min(max(a.hi, 0), k)
    raise ValueError(op)


class _Graph:
    """Builds a cycle's values as hash-consed typed nodes (``expr`` for the
    tape's expressions, ``op`` for the generator's own), then types them
    (``settle``) and writes each as one local (``emit``)."""

    def __init__(self, widths: dict[str, int]):
        self.widths = widths
        self.nodes: list[_Node] = []
        self.env: dict[str, _Node] = {}
        self._memo: dict[tuple, _Node] = {}
        self._lits: dict[int, _Node] = {}
        self._expr: dict[Any, tuple[_Node, int]] = {}

    # building
    def lit(self, v: int) -> _Node:
        n = self._lits.get(v)
        if n is None:
            w = _wrap64(v)
            n = self._lits[v] = _Node("lit", k=v, lo=w, hi=w)
        return n

    def leaf(self, code: str, ty: str, hi: int, op: str = "var", args=(), k=None) -> _Node:
        """A value the cycle reads: a register (``var``), or a load emitted
        as a local (``load``; ``args`` its address)."""
        n = _Node(op, args, k, 0, hi, ty=ty, code=code)
        for i, a in enumerate(n.args):
            a.uses.append((n, i))
        if op == "var":
            n.name = code
        else:
            self.nodes.append(n)
        return n

    def op(self, op: str, *args: _Node, k=None) -> _Node:
        m = args[1].k if op == "and" and args[1].op == "lit" else -1
        if m >= 0 and m & (m + 1) == 0 and 0 <= args[0].lo and args[0].hi <= m:
            return args[0]                      # a mask of all ones that keeps every value
        key = (op, tuple(id(a) for a in args), k)
        n = self._memo.get(key)
        if n is not None:
            return n
        if op == "mux":
            lo, hi = min(args[1].lo, args[2].lo), max(args[1].hi, args[2].hi)
        else:
            lo, hi = _range(op, args[0], args[1] if len(args) > 1 else None, k)
        n = self._memo[key] = _Node(op, args, k, lo, hi)
        for i, a in enumerate(args):
            a.uses.append((n, i))
        self.nodes.append(n)
        return n

    def ne0(self, a: _Node) -> _Node:
        return self.op("!=", a, self.lit(0))

    def expr(self, e: Expr) -> _Node:
        return self._val(e)[0]

    def _val(self, e: Expr) -> tuple[_Node, int]:
        if isinstance(e, Const):
            if not isinstance(e.value, int):
                raise ValueError(f"non-integer constant {e.value!r}")
            v = int(e.value)
            return self.lit(v), (e.width if e.width is not None else max(1, v.bit_length()))
        if isinstance(e, Ref):
            if e.name not in self.env:
                raise KeyError(f"net {e.name!r} is read before it has a value")
            return self.env[e.name], self.widths[e.name]
        k = e.key()
        hit = self._expr.get(k)
        if hit is None:
            hit = self._expr[k] = self._node(e)
        return hit

    def _node(self, e: Expr) -> tuple[_Node, int]:
        op = self.op
        if isinstance(e, Signed):
            a, w = self._val(e.a)
            s = self.lit(1 << (w - 1))
            return op("sub", op("xor", op("and", a, self.lit((1 << w) - 1)), s), s), w
        if isinstance(e, Unop):
            if e.op != "~":
                raise ValueError(f"unop {e.op!r} unsupported")
            a, w = self._val(e.a)
            return op("not", a), w
        if isinstance(e, Mux):
            c, _ = self._val(e.cond)
            a, wa = self._val(e.a)
            b, wb = self._val(e.b)
            return op("mux", c, a, b), max(wa, wb)
        if isinstance(e, Repeat):
            a, wa = self._val(e.a)
            w = e.n * wa
            if w >= 64:
                if isinstance(e.a, Const) and int(e.a.value) == 0:
                    return self.lit(0), 63
                raise ValueError(f"repeat to {w} bits unsupported")
            factor = sum(1 << (i * wa) for i in range(e.n))
            return op("mul", op("and", a, self.lit((1 << wa) - 1)), self.lit(factor)), w
        if isinstance(e, Binop):
            a, wa = self._val(e.a)
            b, wb = self._val(e.b)
            o, w = e.op, max(wa, wb)
            if o in _CMP:
                return op(o, a, b), 1
            if o in ("&&", "||"):
                return op("land" if o == "&&" else "lor", a, b), 1
            name = {"+": "add", "-": "sub", "*": "mul", "&": "and", "|": "or", "^": "xor",
                    "/": "fdiv"}.get(o)
            if name is not None:
                return op(name, a, b), w
            if o == "<<":
                if isinstance(e.b, Const):
                    k = int(e.b.value)
                    if k >= 64 or k < 0:
                        return self.lit(0), w
                    return op("shlc", a, k=k), w
                return op("shl", a, b), w
            if o == ">>":
                if isinstance(e.b, Const):
                    k = min(int(e.b.value), 63)
                    if k < 0:
                        return op("sign", a), w
                    return op("shrc", a, k=k), w
                return op("shr", a, b), w
            raise ValueError(f"binop {o!r} unsupported")
        raise ValueError(f"expression {type(e).__name__} unsupported")

    # typing
    def settle(self, roots: list[_Node]) -> None:
        """Type every live node, users before operands: u32 where its range
        fits 32 bits, or where it is modular and every user takes it modulo
        2**32; i64 elsewhere."""
        for r in roots:
            r.root = True
        live: set[int] = set()
        for n in reversed(self.nodes):
            users = [(u, i) for u, i in n.uses if id(u) in live]
            if not users and not n.root:
                continue
            live.add(id(n))
            if n.ty is not None:                  # a load: its storage's type
                continue
            whole = n.root or any(
                u.ty == "i64" or u.op not in _MODULAR or (u.op == "mux" and i == 0)
                for u, i in users)
            n.ty = "u32" if n.fits or (not whole and n.op in _MODULAR) else "i64"
        self.live = live

    # writing
    def c32(self, n: _Node) -> str:
        """``n`` as a uint32_t expression (modulo 2**32)."""
        if n.op == "lit":
            return f"{n.k & _M32}u"
        return n.name if n.ty == "u32" else f"(uint32_t){n.name}"

    def c64(self, n: _Node) -> str:
        if n.op == "lit":
            return _lit(n.k)
        return n.name if n.ty == "i64" else f"(i64){n.name}"

    def nat(self, n: _Node) -> str:
        return _lit(n.k) if n.op == "lit" else n.name

    @staticmethod
    def exact32(n: _Node) -> bool:
        """``n``'s exact value as a uint32_t (a user that needs it whole)."""
        return (n.op == "lit" and 0 <= n.k <= _M32) or n.ty == "u32"

    def emit(self) -> list[str]:
        lines, i = [], 0
        for n in self.nodes:
            if id(n) not in self.live:
                continue
            n.name = f"e{i}"
            i += 1
            ctype = "uint32_t" if n.ty == "u32" else "i64"
            lines.append(f"    const {ctype} {n.name} = {self._code(n)};")
        return lines

    def _code(self, n: _Node) -> str:
        if n.code is not None:                    # a load
            return n.code.format(*(self.c32(a) for a in n.args))
        return self._code32(n) if n.ty == "u32" else self._code64(n)

    def _code64(self, n: _Node) -> str:
        """``n``'s exact int64 value as the tape computes it."""
        op, args = n.op, n.args
        a, b = args[0], (args[1] if len(args) > 1 else None)
        if op in _C_FN:
            return f"{_C_FN[op]}({self.c64(a)}, {self.c64(b)})"
        if op in _C_OP:
            return f"{self.c64(a)} {_C_OP[op]} {self.c64(b)}"
        if op == "not":
            return f"~{self.c64(a)}"
        if op == "copy":
            return self.c64(a)
        if op == "shlc":
            return f"(i64)((u64){self.c64(a)} << {n.k})"
        if op == "shl":
            return f"shl_({self.c64(a)}, {self.c64(b)})"
        if op == "shrc":
            return f"{self.c64(a)} >> {n.k}"
        if op == "sign":
            return f"({self.c64(a)} < 0 ? -1LL : 0LL)"
        if op == "shr":
            return f"shr_({self.c64(a)}, {self.c64(b)})"
        if op == "fdiv":
            return f"fdiv_({self.c64(a)}, {self.c64(b)})"
        if op in _CMP:
            return f"(i64)({self.c64(a)} {op} {self.c64(b)})"
        if op in ("land", "lor"):
            bit = "&" if op == "land" else "|"
            return f"(i64)(({self.nat(a)} != 0) {bit} ({self.nat(b)} != 0))"
        if op == "mux":
            return f"({self.nat(a)} != 0) ? {self.c64(b)} : {self.c64(args[2])}"
        if op == "clamp":
            return f"clamp_({self.c64(a)}, {_lit(n.k)})"
        raise ValueError(op)

    def _code32(self, n: _Node) -> str:
        """``n`` as a uint32_t: its value modulo 2**32 (exact where its
        range fits)."""
        op, args = n.op, n.args
        a, b = args[0], (args[1] if len(args) > 1 else None)
        if op in _C_OP:
            return f"{self.c32(a)} {_C_OP[op]} {self.c32(b)}"
        if op == "not":
            return f"~{self.c32(a)}"
        if op == "copy":
            return self.c32(a)
        if op == "shlc":
            return "0u" if n.k >= 32 else f"{self.c32(a)} << {n.k}"
        if op == "mux":
            return f"({self.nat(a)} != 0) ? {self.c32(b)} : {self.c32(args[2])}"
        if op in ("land", "lor"):
            bit = "&" if op == "land" else "|"
            return f"(uint32_t)(({self.nat(a)} != 0) {bit} ({self.nat(b)} != 0))"
        both = self.exact32(a) and (b is None or self.exact32(b))
        if op in _CMP:
            if both:
                return f"(uint32_t)({self.c32(a)} {op} {self.c32(b)})"
            return f"(uint32_t)({self.c64(a)} {op} {self.c64(b)})"
        if both and op == "fdiv":
            return f"({self.c32(b)} == 0u ? 0u : {self.c32(a)} / {self.c32(b)})"
        if both and op == "shrc":
            return "0u" if n.k >= 32 else f"{self.c32(a)} >> {n.k}"
        if both and op in ("shr", "shl"):
            sh = ">>" if op == "shr" else "<<"
            return f"({self.c32(b)} >= 32u ? 0u : {self.c32(a)} {sh} {self.c32(b)})"
        if both and op == "clamp":
            return f"({self.c32(a)} > {n.k}u ? {n.k}u : {self.c32(a)})"
        # the exact value in 64 bits, which the range puts in [0, 2**32)
        return f"(uint32_t)({self._code64(n)})"


# -- the source -----------------------------------------------------------------------------


def _tape_items(sim) -> tuple[dict, list, list]:
    """The items behind ``sim``'s tape, found by walking the flattened module
    as ``RTLSimulator._build`` walks it: (comb items by destination, clocked
    items in ``sim.clocked`` order, ``PortConflictAssert`` items)."""
    comb: dict[str, Any] = {}
    clocked, asserts = [], []
    for it in sim.flat.items:
        if isinstance(it, CombAssign):
            comb[it.dest] = it
        elif isinstance(it, LoopController):
            comb[it.iter_net] = it
            clocked.append(it)
        elif isinstance(it, (ShiftReg, RegAssign, MemRead, MemWrite)):
            clocked.append(it)
        elif isinstance(it, PortConflictAssert):
            asserts.append(it)
    tags = {ShiftReg: "sr", RegAssign: "reg", MemRead: "memrd", MemWrite: "memwr",
            LoopController: "ctrl"}
    if [tags[type(it)] for it in clocked] != [ent[0] for ent in sim.clocked]:
        raise ValueError("the clocked items do not follow the simulator's tape")
    if len(asserts) != len(sim.asserts):
        raise ValueError("the asserts do not follow the simulator's tape")
    return comb, clocked, asserts


def _ctype(nbytes: int) -> str:
    return "uint32_t" if nbytes == 4 else "i64"


def _params(lay: _Layout) -> tuple[list[str], list[str]]:
    """The kernel's buffer parameters (declarations) and their C names."""
    decls, names = [], []
    for name, _rows, nb in lay.buffers:
        if name in lay.mem_at:
            i = lay.mems.index(lay.mem_at[name])
            cname = f"m{i}"
            const = "" if lay.mem_at[name].written else "const "
        else:
            cname, const = name, ""
        decls.append(f"{const}{_ctype(nb)}* __restrict__ {cname}")
        names.append(cname)
    return decls, names


def generate_source(sim, place: Optional[str] = None) -> tuple[str, _Layout]:
    """CUDA C++ (and plain C++ under a host compiler) for ``sim``'s design,
    with the layout of its state buffers.  ``place`` forces every memory and
    ring to shared or global memory (tests)."""
    lay = _Layout(sim, place)
    comb, clocked, asserts = _tape_items(sim)
    g = _Graph(sim.widths)
    svar: dict[tuple[str, int], _Node] = {}
    for i, (key, col) in enumerate(lay.slots):
        ty = "u32" if lay.slot_bytes[i] == 4 else "i64"
        hi = lay.bounds.get(key)
        svar[(key, col)] = g.leaf(f"s{i}", ty, hi if hi is not None else _I64[1])
        if hi is None:
            svar[(key, col)].lo = _I64[0]
    slot = {key: svar[(key, -1)] for key, col in lay.slots if col < 0}
    mname = {p.key: f"m{i}" for i, p in enumerate(lay.mems)}

    def where(p: _Part, idx: str) -> str:
        """The lvalue of word ``idx`` of ``p`` (idx a uint32_t expression)."""
        if p.place == "shared":
            return f"sm{8 * p.nbytes}[({p.sm_row}u + {idx}) * LPB + tid]"
        if p.key in mname:
            return f"{mname[p.key]}[{idx}]"
        return f"ring{8 * p.nbytes}[((i64){p.row} + {idx}) * B]"

    depths = sorted({p.depth for p in lay.rings})     # each a ring index ri<depth> a cycle

    g.env.update({"t_start": g.leaf("t_start", "u32", 1), "clk": g.lit(0), "rst": g.lit(0)})
    for pn, key in sim.scalar_inputs:
        g.env[pn] = slot[key]
    for n in sim.state_nets:
        g.env[n] = slot[n]
    for dest, key in sim.sr_loads:
        if key in lay.ring_at:
            p = lay.ring_at[key]
            g.env[dest] = g.leaf(where(p, f"ri{p.depth}"), "u32" if p.nbytes == 4 else "i64",
                                 lay.bounds[key], op="load")
        else:
            g.env[dest] = svar[(key, 0)]

    def iter_pulse(c: LoopController) -> _Node:
        act, iv = slot[c.active], slot[c.iv]
        more = g.op("<", g.op("add", iv, g.expr(c.step)), g.expr(c.ub))
        if c.ii is not None:
            cn = g.op("==", slot[c.iicnt], g.lit(c.ii - 1)) if c.ii > 1 else g.lit(1)
        else:
            cn = g.ne0(g.expr(c.inner_end))
        return g.op("lor", g.expr(c.start), g.op("land", g.op("land", act, cn), more))

    for dest, kind, payload, _reads in sim.comb_tape:
        if kind == "assign":
            it = comb.get(dest)
            value = g.lit(0) if it is None else g.expr(it.expr)
            g.env[dest] = g.op("and", value, g.lit(payload[1]))
        else:
            g.env[dest] = iter_pulse(comb[dest])

    # every next value, from the values at the start of the cycle
    pend: dict[str, _Node] = {}
    mem_writes: list[tuple[_Part, _Node, _Node, _Node]] = []
    pushes: list[tuple[str, _Node]] = []

    def cur(key: str) -> _Node:
        return pend.get(key, slot.get(key))

    for it, ent in zip(clocked, sim.clocked):
        mk = g.lit(ent[-1]) if ent[0] != "ctrl" else None    # the entry's width mask
        if isinstance(it, ShiftReg):
            pushes.append((f"sr:{it.dest}", g.op("and", g.expr(it.src), mk)))
        elif isinstance(it, RegAssign):
            v = g.op("and", g.expr(it.src), mk)
            if it.en is not None:
                v = g.op("mux", g.expr(it.en), v, cur(it.dest))
            pend[it.dest] = v
        elif isinstance(it, MemRead):
            p = lay.mem_at[f"mem:{it.mem}:{it.bank}"]
            addr = g.op("clamp", g.expr(it.addr), k=p.depth - 1)
            word = g.leaf(where(p, "{0}"), "u32" if p.nbytes == 4 else "i64",
                          lay.bounds[p.key], op="load", args=(addr,))
            pend[it.dest] = g.op("mux", g.expr(it.en), g.op("and", word, mk), cur(it.dest))
        elif isinstance(it, MemWrite):
            p = lay.mem_at[f"mem:{it.mem}:{it.bank}"]
            addr = g.op("clamp", g.expr(it.addr), k=p.depth - 1)
            mem_writes.append((p, addr, g.op("and", g.expr(it.data), mk), g.expr(it.en)))
        else:                                   # the controller's clocked half
            c = it
            act, iv = slot[c.active], slot[c.iv]
            sv = g.ne0(g.expr(c.start))
            ubv = g.expr(c.ub)
            step_up = g.op("add", iv, g.expr(c.step))
            if c.ii is not None and c.ii > 1:
                iicnt = slot[c.iicnt]
                cn = g.op("==", iicnt, g.lit(c.ii - 1))
                nxt = g.op("mux", cn, g.lit(0), g.op("add", iicnt, g.lit(1)))
                pend[c.iicnt] = g.op("mux", sv, g.lit(0), g.op("mux", act, nxt, iicnt))
            elif c.ii is not None:
                cn = g.lit(1)
            else:
                cn = g.ne0(g.expr(c.inner_end))
            go = g.op("land", act, cn)
            ivm = g.lit((1 << c.ivw) - 1)
            pend[c.iv] = g.op(
                "mux", sv, g.op("and", g.expr(c.lb), ivm),
                g.op("mux", g.op("land", go, g.op("<", step_up, ubv)),
                     g.op("and", step_up, ivm), iv))
            done = g.op("land", go, g.op(">=", step_up, ubv))
            pend[c.active] = g.op("mux", sv, g.lit(1), g.op("mux", done, g.lit(0), act))
            if c.endp:
                pend[c.endp] = done
    for j, (dp, vp) in enumerate(sim.results):
        val, seen = slot[f"ret:{j}:val"], slot[f"ret:{j}:seen"]
        valid = g.env[vp]
        pend[f"ret:{j}:val"] = g.op("mux", g.op("land", valid, g.op("==", seen, g.lit(0))),
                                    g.env[dp], val)
        pend[f"ret:{j}:seen"] = g.op("mux", valid, g.lit(1), seen)
    cf_updates = []
    for i, it in enumerate(asserts):
        fired = g.lit(0)
        for e in it.ens:
            fired = g.op("add", fired, g.ne0(g.expr(e)))
        s = svar[("cf", i)]
        cf_updates.append((s, g.op("add", s, g.op(">", fired, g.lit(1)))))

    names = sim.trace_names
    traced = [g.env[n] for n in names]
    stores = ([(svar[(key, 0)], v) for key, v in pushes if key not in lay.ring_at]
              + [(slot[key], v) for key, v in pend.items()] + cf_updates)
    # a register takes another's value from the start of the cycle, not the
    # one stored before it
    stores = [(s, g.op("copy", v) if v.op == "var" else v) for s, v in stores]
    ring_pushes = [(lay.ring_at[key], v) for key, v in pushes if key in lay.ring_at]
    roots = (traced + [v for _, v in stores] + [v for _, v in ring_pushes]
             + [x for _, a, d, en in mem_writes for x in (a, d, en)])
    g.settle([r for r in roots if r.op != "lit"])
    body = [f"    const uint32_t ri{d} = (uint32_t)t {'&' if d & (d - 1) == 0 else '%'} "
            f"{d - 1 if d & (d - 1) == 0 else d}u;" for d in depths]
    body += g.emit()

    def stored(n: _Node, nbytes: int, what: str) -> str:
        if nbytes == 8:
            return g.c64(n)
        if not (0 <= n.lo and n.hi <= _M32):
            raise ValueError(f"{what}: a value in [{n.lo}, {n.hi}] stored in 4 bytes")
        return g.c32(n)

    body.append("    if (trace) {")
    body += [f"      trace[((i64)t * {len(names)} + {i}) * B] = {g.c64(n)};"
             for i, n in enumerate(traced)]
    body.append("    }")
    body += [f"    if ({g.nat(en)} != 0) {where(p, g.c32(a))} = {stored(d, p.nbytes, p.key)};"
             for p, a, d, en in mem_writes]
    body += [f"    {where(p, f'ri{p.depth}')} = {stored(v, p.nbytes, p.key)};"
             for p, v in ring_pushes]
    body += [f"    {s.code} = {stored(v, 4 if s.ty == 'u32' else 8, s.code)};" for s, v in stores]

    head = [f"  {_ctype(nb)} s{i} = st{8 * nb}[{lay.slot_row[i]}LL * B];"
            for i, nb in enumerate(lay.slot_bytes)]
    tail = [f"  st{8 * nb}[{lay.slot_row[i]}LL * B] = s{i};"
            for i, nb in enumerate(lay.slot_bytes)]
    for p in lay.mems + lay.rings:
        if p.place != "shared":
            continue
        home = (f"{mname[p.key]}[k]" if p.key in mname
                else f"ring{8 * p.nbytes}[((i64){p.row} + k) * B]")
        here = f"sm{8 * p.nbytes}[({p.sm_row} + k) * LPB + tid]"
        head.append(f"  for (int k = 0; k < {p.depth}; ++k) {here} = {home};")
        if p.written:
            tail.append(f"  for (int k = 0; k < {p.depth}; ++k) {home} = {here};")
    decls, cnames = _params(lay)
    shift = [f"  {c} += lane * {lay.mem_at[name].depth}LL;" if name in lay.mem_at
             else f"  {c} += lane;" for (name, _, _), c in zip(lay.buffers, cnames)]
    shift.append("  if (trace) trace += lane;")
    sm32_at = f"{lay.sm_rows[8]} * 8 * LPB"
    smem = f"({lay.sm_rows[8]} * 8 + {lay.sm_rows[4]} * 4) * (size_t)LPB"
    sig = ", ".join(decls + ["i64* __restrict__ trace"])
    call = ", ".join(cnames + ["trace"])
    place = lay.placement()
    entry = sim.entry
    src = [
        f"// The cycle-accurate simulator of design @{entry}, generated by",
        "// repro_torch/core/codegen/sim_cuda.py from the simulator's tape:",
        f"// {len(sim.comb_tape)} combinational nets, {len(clocked)} clocked items,"
        f" {len(asserts)} conflict asserts; a lane's state words by bytes: {lay.word_bytes()};",
        f"// {lay.smem_lane_bytes} bytes a lane in shared memory; placement:"
        f" {sorted(place.items()) if place else 'none'}.",
        _PRELUDE,
        f"#define LPB {LANES_PER_BLOCK}",
        f"static __host__ __device__ inline void rtlsim_lane(i64 lane, int tid, int B, int T, {sig},",
        "                                                   uint32_t* sm32, i64* sm64) {",
        *shift,
        *head,
        "  for (int t = 0; t < T; ++t) {",
        "    const uint32_t t_start = (t == 0);",
        *body,
        "  }",
        *tail,
        "}",
        "",
        "#ifdef __CUDACC__",
        f"__global__ void __launch_bounds__(LPB) rtlsim_kernel({sig}, int B, int T) {{",
        "  extern __shared__ __align__(16) unsigned char smem_[];",
        "  i64* sm64 = (i64*)smem_;",
        f"  uint32_t* sm32 = (uint32_t*)(smem_ + {sm32_at});",
        "  const int tid = threadIdx.x;",
        "  const i64 lane = (i64)blockIdx.x * LPB + tid;",
        f"  if (lane < B) rtlsim_lane(lane, tid, B, T, {call}, sm32, sm64);",
        "}",
        "",
        f'extern "C" int rtlsim_launch({sig}, int B, int T, void* stream) {{',
        f"  const size_t smem = {smem};",
        "  if (smem > 48 * 1024) {",
        "    cudaError_t e = cudaFuncSetAttribute(rtlsim_kernel,",
        "                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);",
        "    if (e != cudaSuccess) return (int)e;",
        "  }",
        "  rtlsim_kernel<<<(B + LPB - 1) / LPB, LPB, smem, (cudaStream_t)stream>>>("
        f"{call}, B, T);",
        "  return (int)cudaGetLastError();",
        "}",
        "#else",
        f'extern "C" int rtlsim_host({sig}, int B, int T) {{',
        f"  i64* sm64 = (i64*)malloc({lay.sm_rows[8]} * 8 * LPB + 8);",
        f"  uint32_t* sm32 = (uint32_t*)malloc({lay.sm_rows[4]} * 4 * LPB + 4);",
        "  for (i64 b0 = 0; b0 < B; b0 += LPB) {",
        "    // a block's shared memory starts as garbage: every word is loaded before it is read",
        f"    memset(sm64, 0xA5, {lay.sm_rows[8]} * 8 * LPB);",
        f"    memset(sm32, 0xA5, {lay.sm_rows[4]} * 4 * LPB);",
        "    for (int tid = 0; tid < LPB && b0 + tid < B; ++tid)",
        f"      rtlsim_lane(b0 + tid, tid, B, T, {call}, sm32, sm64);",
        "  }",
        "  free(sm64);",
        "  free(sm32);",
        "  return 0;",
        "}",
        "#endif",
        "",
    ]
    return "\n".join(src), lay


def _to_words(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """int64 values in [0, 2**32) as the bits of 4-byte words (int32), or
    int64 as they are."""
    if nbytes == 8:
        return x
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def _from_words(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.int64 else x.to(torch.int64) & _M32


class SimKernel:
    """A design's generated simulator kernel: ``source`` (CUDA C++),
    ``layout`` (where the state lives), ``launches``.  Built at its first
    launch (``_build``, content-hashed); a build or launch failure raises.
    ``place`` forces every memory and ring to "shared" or "global" (tests)."""

    def __init__(self, sim, place: Optional[str] = None):
        self.source, self.layout = generate_source(sim, place)
        self.trace_names = list(sim.trace_names)
        self.stem = "rtlsim_" + "".join(ch if ch.isalnum() else "_" for ch in sim.entry)
        self.launches = 0
        self._launcher = None

    def build(self):
        """Compile (or find compiled) the source and bind its launcher."""
        if self._launcher is None:
            from ...kernels import _build

            lib = _build.load_library(self.stem, self.source)
            self._launcher = _build.bind(
                lib, "rtlsim_launch",
                [ctypes.c_void_p] * (len(self.layout.buffers) + 1)
                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        return self._launcher

    # -- the state buffers -------------------------------------------------------
    def buffers(self, sim, args, B: int, device: torch.device) -> dict[str, torch.Tensor]:
        """Every buffer of ``layout.buffers`` (4-byte words as int32 bits)
        on ``device``, holding the state at cycle 0 as
        ``RTLSimulator._init_state`` makes it: the stimulus masked and laid
        out, every other word 0.  Each argument is copied to the device
        once, and laid out there."""
        from .sim import I64, RTLSimError, _mask_of

        lay = self.layout
        dt = {4: torch.int32, 8: torch.int64}
        bufs = {name: torch.zeros((B, n) if name in lay.mem_at else (n, B), dtype=dt[nb],
                                  device=device)
                for name, n, nb in lay.buffers}

        def put(key: str, col: int, v: torch.Tensor) -> None:
            i = lay.slot_of[(key, col)]
            nb = lay.slot_bytes[i]
            bufs[f"st{8 * nb}"][lay.slot_row[i]] = _to_words(v, nb)

        for b in sim.binds:
            a = args[b.index]
            if b.kind == "scalar":
                v = np.broadcast_to(np.asarray(a, dtype=I64), (B,)) & _mask_of(b.width)
                put(f"in:{b.port}", -1, torch.from_numpy(np.ascontiguousarray(v)).to(device))
                continue
            arr = np.asarray(a, dtype=I64)
            if arr.shape != (B,) + b.mt.shape:
                raise RTLSimError(
                    f"arg {b.index}: expected batch shape {(B,) + b.mt.shape},"
                    f" got {arr.shape}")
            mt = b.mt
            perm = ((0,) + tuple(d + 1 for d in mt.distributed)
                    + tuple(d + 1 for d in mt.packed))
            r = (torch.from_numpy(np.ascontiguousarray(arr)).to(device) & _mask_of(b.width))
            r = r.permute(perm).reshape(B, mt.num_banks, mt.bank_elems)
            if b.kind == "ram":
                p = lay.mem_at[b.memkey]
                bufs[b.memkey].copy_(_to_words(r[:, 0, :], p.nbytes))
            else:
                for bk, row in enumerate(b.cells):
                    for d, cn in enumerate(row):
                        put(cn, -1, r[:, bk, d])
        return bufs

    def pointers(self, bufs: dict[str, torch.Tensor]) -> list[int]:
        """The buffers' addresses in the order of ``layout.buffers``, as the
        launcher takes them."""
        return [bufs[name].data_ptr() for name, _, _ in self.layout.buffers]

    def collect(self, sim, bufs: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """Of the state after the run, what ``RTLSimulator._collect`` reads
        (return captures, conflict counts, the memories and registers bound
        to arguments), batch first, int64, copied back; the rest stays on
        the device."""
        lay = self.layout
        keys = [(f"ret:{j}:{part}", -1) for j in range(len(sim.results))
                for part in ("val", "seen")]
        keys += [(cn, -1) for b in sim.binds if b.kind == "bank" for row in b.cells for cn in row]
        keys += [("cf", col) for col in range(len(sim.asserts))]
        got = {}
        for nb in (4, 8):
            want = [k for k in keys if lay.slot_bytes[lay.slot_of[k]] == nb]
            if want:
                rows = [lay.slot_row[lay.slot_of[k]] for k in want]
                vals = _from_words(bufs[f"st{8 * nb}"][rows]).cpu().numpy()
                got.update({k: vals[i] for i, k in enumerate(want)})
        final = {k: got[(k, -1)] for k, col in keys if col < 0}
        if sim.asserts:
            final["cf"] = np.ascontiguousarray(
                np.stack([got[("cf", c)] for c in range(len(sim.asserts))], axis=1))
        for b in sim.binds:
            if b.kind == "ram":
                final[b.memkey] = _from_words(bufs[b.memkey]).cpu().numpy()
        return final

    # -- running -------------------------------------------------------------------
    def launch(self, bufs: dict[str, torch.Tensor], B: int, T: int,
               trace: Optional[torch.Tensor], device: torch.device) -> None:
        """One launch over device buffers (updated in place) for ``T``
        cycles; ``trace`` is a ``(T, names, B)`` int64 tensor or None."""
        global launches
        from ...kernels import _build

        launcher = self.build()
        rc = _build.on_device(device, launcher, *self.pointers(bufs),
                              0 if trace is None else trace.data_ptr(), B, T)
        _build.check_launch(rc, "rtlsim_launch")
        self.launches += 1
        launches += 1

    def run(self, sim, args, xs: np.ndarray, B: int, trace: bool,
            device: torch.device) -> tuple[dict, dict]:
        """What ``RTLSimulator._collect`` reads of the final state, and the
        traces, as ``RTLSimulator._run_numpy`` gives them, with ``t_start``
        pulsed at cycle 0 of ``len(xs)`` cycles."""
        T = len(xs)
        if T < 1 or xs[0] != 1 or np.any(xs[1:]):
            raise ValueError("the kernel pulses t_start at cycle 0 only")
        if device.type != "cuda":
            raise ValueError(f"the simulator kernel runs on a CUDA device, not {device}")
        bufs = self.buffers(sim, args, B, device)
        tr = (torch.empty((T, len(self.trace_names), B), dtype=torch.int64, device=device)
              if trace else None)
        self.launch(bufs, B, T, tr, device)
        final = self.collect(sim, bufs)
        ys = {} if tr is None else {n: y for n, y in zip(self.trace_names, tr.cpu().numpy().transpose(1, 0, 2))}
        return final, ys
