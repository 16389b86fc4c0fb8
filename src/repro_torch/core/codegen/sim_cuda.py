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
  conflict counters are locals, loaded from and written back to ``st`` lane
  fastest (``st[k*B + lane]``);
* a shift register of depth 1 is such a local; a deeper one is a ring of
  ``depth`` words per lane in ``ring`` (lane fastest), read and overwritten
  at ``t % depth``;
* memories lie lane fastest in ``mem`` (``mem[(offset + addr)*B + lane]``),
  addresses clamped to the memory as the reference does;
* nonblocking semantics exactly as ``RTLSimulator._make_step``: every read
  and every next value of a cycle is computed before anything is written
  back; memory reads see the contents from before the cycle; memory writes
  are applied after them, in ``clocked`` order;
* with a trace buffer, each cycle's traced nets are written to a
  ``(cycles, names, B)`` array; without one, nothing is traced.

Arithmetic matches the tape's int64 math values: ``+ - * <<`` on
``unsigned long long`` and cast back (signed overflow and shifts of negative
values are undefined in C++), *floor* division with ``x / 0 == 0``, shift
counts clamped as ``sim._compile_expr`` clamps them, a negative count giving
0 on the left and the sign on the right as NumPy does, and every assigned
value masked to its net's width (at most 63 bits, ``sim._mask_of``).

What bounds it on the card: each lane's cycles are a chain of dependent
scalar int64 operations; lanes are the only parallelism.  Its byte bound is
the lane state read once and written once; a cycle's work per lane is the
tape.  The per-lane body is plain C++ (``__host__ __device__``, no
intrinsics): a host build with a C++ compiler runs it lane by lane, which is
how the CPU tests hold it to ``_TorchOps``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional

import numpy as np
import torch

from .rtl import (Binop, CombAssign, Const, Expr, LoopController, MemRead,
                  MemWrite, Mux, PortConflictAssert, Ref, Repeat, RegAssign,
                  ShiftReg, Signed, Unop)

#: kernel launches made by every ``SimKernel`` (a run resets it to 0, drives
#: its path, and reads it to show the path used the kernel)
launches = 0

#: lanes a block: one warp, so 4096 lanes spread over 128 SMs
THREADS = 32

_M64 = (1 << 64) - 1

_PRELUDE = r"""#include <stdint.h>
#ifndef __CUDACC__
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


def _lit(v: int) -> str:
    """A C literal of ``v`` modulo 2**64."""
    if 0 <= v < (1 << 31):
        return f"{v}LL"
    return f"((i64)0x{v & _M64:x}ULL)"


class _Layout:
    """Where each state key of ``sim.state_shape`` lives in the kernel's
    buffers: ``slots`` (key, column or -1) rows of ``st``; ``mems`` and
    ``rings`` (key, offset, depth) rows of ``mem`` and ``ring``."""

    def __init__(self, sim):
        self.slots: list[tuple[str, int]] = []
        self.mems: list[tuple[str, int, int]] = []
        self.rings: list[tuple[str, int, int]] = []
        self.slot_of: dict[tuple[str, int], int] = {}
        nmem = nring = 0
        for key, shape in sim.state_shape.items():
            if key.startswith("mem:"):
                self.mems.append((key, nmem, shape[0]))
                nmem += shape[0]
            elif key.startswith("sr:") and shape[0] > 1:
                self.rings.append((key, nring, shape[0]))
                nring += shape[0]
            elif shape == ():
                self._slot(key, -1)
            else:                       # "cf", and shift registers of depth 1
                for col in range(shape[0]):
                    self._slot(key, col)
        self.mem_rows, self.ring_rows = nmem, nring
        self.mem_at = {k: (off, d) for k, off, d in self.mems}
        self.ring_at = {k: (off, d) for k, off, d in self.rings}

    def _slot(self, key: str, col: int) -> None:
        self.slot_of[(key, col)] = len(self.slots)
        self.slots.append((key, col))


class _Emitter:
    """Writes one cycle's statements; ``val(expr)`` returns the C name (or
    literal) of an expression's math value, one local per node."""

    def __init__(self, widths: dict[str, int]):
        self.widths = widths
        self.lines: list[str] = []
        self.env: dict[str, str] = {}
        self._memo: dict[int, tuple[str, int]] = {}
        self._n = 0

    def local(self, expr: str, hint: str = "e") -> str:
        name = f"{hint}{self._n}"
        self._n += 1
        self.lines.append(f"    const i64 {name} = {expr};")
        return name

    def val(self, e: Expr) -> str:
        return self._val(e)[0]

    def _val(self, e: Expr) -> tuple[str, int]:
        if isinstance(e, Const):
            if not isinstance(e.value, int):
                raise ValueError(f"non-integer constant {e.value!r}")
            v = int(e.value)
            return _lit(v), (e.width if e.width is not None else max(1, v.bit_length()))
        if isinstance(e, Ref):
            if e.name not in self.env:
                raise KeyError(f"net {e.name!r} is read before it has a value")
            return self.env[e.name], self.widths[e.name]
        k = e.key()
        hit = self._memo.get(k)
        if hit is None:
            hit = self._memo[k] = self._node(e)
        return hit

    def _node(self, e: Expr) -> tuple[str, int]:
        if isinstance(e, Signed):
            a, w = self._val(e.a)
            m, s = (1 << w) - 1, 1 << (w - 1)
            return self.local(f"((({a}) & {_lit(m)}) ^ {_lit(s)}) - {_lit(s)}"), w
        if isinstance(e, Unop):
            if e.op != "~":
                raise ValueError(f"unop {e.op!r} unsupported")
            a, w = self._val(e.a)
            return self.local(f"~{a}"), w
        if isinstance(e, Mux):
            c, _ = self._val(e.cond)
            a, wa = self._val(e.a)
            b, wb = self._val(e.b)
            return self.local(f"({c} != 0) ? {a} : {b}"), max(wa, wb)
        if isinstance(e, Repeat):
            a, wa = self._val(e.a)
            w = e.n * wa
            if w >= 64:
                if isinstance(e.a, Const) and int(e.a.value) == 0:
                    return "0LL", 63
                raise ValueError(f"repeat to {w} bits unsupported")
            factor = sum(1 << (i * wa) for i in range(e.n))
            return self.local(f"mul_({a} & {_lit((1 << wa) - 1)}, {_lit(factor)})"), w
        if isinstance(e, Binop):
            a, wa = self._val(e.a)
            b, wb = self._val(e.b)
            op, w = e.op, max(wa, wb)
            if op in _CMP:
                return self.local(f"(i64)({a} {op} {b})"), 1
            if op in ("&&", "||"):
                bit = "&" if op == "&&" else "|"
                return self.local(f"(i64)(({a} != 0) {bit} ({b} != 0))"), 1
            if op in ("&", "|", "^"):
                return self.local(f"{a} {op} {b}"), w
            fn = {"+": "add_", "-": "sub_", "*": "mul_", "/": "fdiv_"}.get(op)
            if fn is not None:
                return self.local(f"{fn}({a}, {b})"), w
            if op == "<<":
                if isinstance(e.b, Const):
                    k = int(e.b.value)
                    if k >= 64 or k < 0:
                        return "0LL", w
                    return self.local(f"(i64)((u64){a} << {k})"), w
                return self.local(f"shl_({a}, {b})"), w
            if op == ">>":
                if isinstance(e.b, Const):
                    k = min(int(e.b.value), 63)
                    if k < 0:
                        return self.local(f"({a} < 0 ? -1LL : 0LL)"), w
                    return self.local(f"{a} >> {k}"), w
                return self.local(f"shr_({a}, {b})"), w
            raise ValueError(f"binop {op!r} unsupported")
        raise ValueError(f"expression {type(e).__name__} unsupported")


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


def generate_source(sim) -> tuple[str, _Layout]:
    """CUDA C++ (and plain C++ under a host compiler) for ``sim``'s design,
    with the layout of its state buffers."""
    lay = _Layout(sim)
    comb, clocked, asserts = _tape_items(sim)
    em = _Emitter(sim.widths)
    slot = {key: f"s{i}" for i, (key, col) in enumerate(lay.slots) if col < 0}

    def col_slot(key: str, col: int) -> str:
        return f"s{lay.slot_of[(key, col)]}"

    head = [f"    i64 s{i} = st[{i}LL * B + lane];" for i in range(len(lay.slots))]
    em.env.update({"t_start": "t_start", "clk": "0LL", "rst": "0LL"})
    for pn, key in sim.scalar_inputs:
        em.env[pn] = slot[key]
    for n in sim.state_nets:
        em.env[n] = slot[n]
    for dest, key in sim.sr_loads:
        if key in lay.ring_at:
            off, d = lay.ring_at[key]
            em.env[dest] = em.local(f"ring[({off}LL + t % {d}) * B + lane]", "r")
        else:
            em.env[dest] = col_slot(key, 0)

    def iter_pulse(c: LoopController) -> str:
        act, iv = slot[c.active], slot[c.iv]
        sv = em.val(c.start)
        more = f"(add_({iv}, {em.val(c.step)}) < {em.val(c.ub)})"
        if c.ii is not None:
            cn = f"({slot[c.iicnt]} == {c.ii - 1})" if c.ii > 1 else "1"
        else:
            cn = f"({em.val(c.inner_end)} != 0)"
        return f"(i64)(({sv} != 0) | (({act} != 0) & {cn} & {more}))"

    for dest, kind, payload, _reads in sim.comb_tape:
        if kind == "assign":
            it = comb.get(dest)
            value = "0LL" if it is None else em.val(it.expr)
            em.env[dest] = em.local(f"{value} & {_lit(payload[1])}", "w")
        else:
            em.env[dest] = em.local(iter_pulse(comb[dest]), "w")

    # every next value, from the values at the start of the cycle
    pend: dict[str, str] = {}
    mem_writes: list[tuple[str, str, str, str]] = []
    pushes: list[tuple[str, str]] = []

    def cur(key: str) -> str:
        return pend.get(key, slot.get(key))

    for it, ent in zip(clocked, sim.clocked):
        mk = _lit(ent[-1]) if ent[0] != "ctrl" else ""     # the entry's width mask
        if isinstance(it, ShiftReg):
            v = em.local(f"{em.val(it.src)} & {mk}", "n")
            pushes.append((f"sr:{it.dest}", v))
        elif isinstance(it, RegAssign):
            v = f"{em.val(it.src)} & {mk}"
            if it.en is not None:
                v = f"({em.val(it.en)} != 0) ? ({v}) : {cur(it.dest)}"
            pend[it.dest] = em.local(v, "n")
        elif isinstance(it, MemRead):
            off, depth = lay.mem_at[f"mem:{it.mem}:{it.bank}"]
            addr = f"clamp_({em.val(it.addr)}, {depth - 1})"
            pend[it.dest] = em.local(
                f"({em.val(it.en)} != 0) ? (mem[({off}LL + {addr}) * B + lane] & {mk})"
                f" : {cur(it.dest)}", "n")
        elif isinstance(it, MemWrite):
            off, depth = lay.mem_at[f"mem:{it.mem}:{it.bank}"]
            addr = em.local(f"clamp_({em.val(it.addr)}, {depth - 1})", "a")
            data = em.local(f"{em.val(it.data)} & {mk}", "d")
            mem_writes.append((f"{off}LL", addr, data, em.val(it.en)))
        else:                                   # the controller's clocked half
            c = it
            act, iv = slot[c.active], slot[c.iv]
            sv = em.local(f"(i64)({em.val(c.start)} != 0)", "c")
            ubv = em.val(c.ub)
            step_up = em.local(f"add_({iv}, {em.val(c.step)})", "c")
            if c.ii is not None and c.ii > 1:
                iicnt = slot[c.iicnt]
                cn = em.local(f"(i64)({iicnt} == {c.ii - 1})", "c")
                nxt = f"({cn} ? 0LL : add_({iicnt}, 1LL))"
                pend[c.iicnt] = em.local(
                    f"{sv} ? 0LL : (({act} != 0) ? {nxt} : {iicnt})", "n")
            elif c.ii is not None:
                cn = "1LL"
            else:
                cn = em.local(f"(i64)({em.val(c.inner_end)} != 0)", "c")
            go = em.local(f"(i64)(({act} != 0) & ({cn} != 0))", "c")
            ivm = _lit((1 << c.ivw) - 1)
            pend[c.iv] = em.local(
                f"{sv} ? ({em.val(c.lb)} & {ivm}) : "
                f"(({go} && {step_up} < {ubv}) ? ({step_up} & {ivm}) : {iv})", "n")
            done = em.local(f"(i64)({go} && {step_up} >= {ubv})", "c")
            pend[c.active] = em.local(f"{sv} ? 1LL : ({done} ? 0LL : {act})", "n")
            if c.endp:
                pend[c.endp] = done
    for j, (dp, vp) in enumerate(sim.results):
        val, seen = slot[f"ret:{j}:val"], slot[f"ret:{j}:seen"]
        valid = em.env[vp]
        pend[f"ret:{j}:val"] = em.local(
            f"({valid} != 0 && {seen} == 0) ? {em.env[dp]} : {val}", "n")
        pend[f"ret:{j}:seen"] = em.local(f"({valid} != 0) ? 1LL : {seen}", "n")
    cf_updates = []
    for i, it in enumerate(asserts):
        fired = " + ".join(f"(i64)({em.val(e)} != 0)" for e in it.ens) or "0LL"
        cf_updates.append((col_slot("cf", i), em.local(f"(i64)(({fired}) > 1)", "n")))

    names = sim.trace_names
    body = list(em.lines)
    body.append("    if (trace) {")
    body += [f"      trace[((i64)t * {len(names)} + {i}) * B + lane] = {em.env[n]};"
             for i, n in enumerate(names)]
    body.append("    }")
    body += [f"    if ({en} != 0) mem[({off} + {a}) * B + lane] = {d};"
             for off, a, d, en in mem_writes]
    for key, v in pushes:
        if key in lay.ring_at:
            off, d = lay.ring_at[key]
            body.append(f"    ring[({off}LL + t % {d}) * B + lane] = {v};")
        else:
            body.append(f"    {col_slot(key, 0)} = {v};")
    body += [f"    {slot[key]} = {v};" for key, v in pend.items()]
    body += [f"    {s} = add_({s}, {v});" for s, v in cf_updates]
    tail = [f"  st[{i}LL * B + lane] = s{i};" for i in range(len(lay.slots))]

    entry = sim.entry
    src = [
        f"// The cycle-accurate simulator of design @{entry}, generated by",
        "// repro_torch/core/codegen/sim_cuda.py from the simulator's tape:",
        f"// {len(sim.comb_tape)} combinational nets, {len(clocked)} clocked items,"
        f" {len(asserts)} conflict asserts; state: {len(lay.slots)} words,"
        f" {lay.mem_rows} memory words, {lay.ring_rows} shift-register words a lane.",
        _PRELUDE,
        "static __host__ __device__ void rtlsim_lane(i64 lane, i64 B, int T, i64* st, i64* mem,",
        "                                            i64* ring, i64* trace) {",
        *head,
        "  for (int t = 0; t < T; ++t) {",
        "    const i64 t_start = (t == 0);",
        *body,
        "  }",
        *tail,
        "}",
        "",
        "#ifdef __CUDACC__",
        f"__global__ void __launch_bounds__({THREADS}) rtlsim_kernel(i64* st, i64* mem, i64* ring,",
        "                                                   i64* trace, int B, int T) {",
        "  const i64 lane = (i64)blockIdx.x * blockDim.x + threadIdx.x;",
        "  if (lane < B) rtlsim_lane(lane, B, T, st, mem, ring, trace);",
        "}",
        "",
        'extern "C" int rtlsim_launch(i64* st, i64* mem, i64* ring, i64* trace, int B, int T,',
        "                             void* stream) {",
        f"  rtlsim_kernel<<<(B + {THREADS - 1}) / {THREADS}, {THREADS}, 0, (cudaStream_t)stream>>>(",
        "      st, mem, ring, trace, B, T);",
        "  return (int)cudaGetLastError();",
        "}",
        "#else",
        'extern "C" int rtlsim_host(i64* st, i64* mem, i64* ring, i64* trace, int B, int T) {',
        "  for (i64 lane = 0; lane < B; ++lane) rtlsim_lane(lane, B, T, st, mem, ring, trace);",
        "  return 0;",
        "}",
        "#endif",
        "",
    ]
    return "\n".join(src), lay


class SimKernel:
    """A design's generated simulator kernel: ``source`` (CUDA C++),
    ``layout`` (where the state lives), ``launches``.  Built at its first
    launch (``_build``, content-hashed); a build or launch failure raises."""

    def __init__(self, sim):
        self.source, self.layout = generate_source(sim)
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
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        return self._launcher

    # -- the state buffers -------------------------------------------------------
    def buffers(self, sim, args, B: int, device: torch.device) -> dict[str, torch.Tensor]:
        """``st``, ``mem`` and ``ring`` (rows of ``B`` lanes) on ``device``,
        holding the state at cycle 0 as ``RTLSimulator._init_state`` makes
        it: the stimulus masked and laid out, every other word 0.  Each
        argument is copied to the device once, and laid out there."""
        from .sim import I64, RTLSimError, _mask_of

        lay = self.layout
        st = torch.zeros((len(lay.slots), B), dtype=torch.int64, device=device)
        mem = torch.zeros((lay.mem_rows, B), dtype=torch.int64, device=device)
        ring = torch.zeros((lay.ring_rows, B), dtype=torch.int64, device=device)
        for b in sim.binds:
            a = args[b.index]
            if b.kind == "scalar":
                v = np.broadcast_to(np.asarray(a, dtype=I64), (B,)) & _mask_of(b.width)
                st[lay.slot_of[(f"in:{b.port}", -1)]] = torch.from_numpy(v).to(device)
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
                off, d = lay.mem_at[b.memkey]
                mem[off:off + d] = r[:, 0, :].T
            else:
                for bk, row in enumerate(b.cells):
                    for d, cn in enumerate(row):
                        st[lay.slot_of[(cn, -1)]] = r[:, bk, d]
        return {"st": st, "mem": mem, "ring": ring}

    def collect(self, sim, bufs: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """Of the state after the run, what ``RTLSimulator._collect`` reads
        (return captures, conflict counts, the memories and registers bound
        to arguments), batch first, copied back; the rest stays on the
        device."""
        lay = self.layout
        keys = [f"ret:{j}:{part}" for j in range(len(sim.results)) for part in ("val", "seen")]
        keys += [cn for b in sim.binds if b.kind == "bank" for row in b.cells for cn in row]
        cols = [("cf", col) for col in range(len(sim.asserts))]
        rows = [lay.slot_of[(k, -1)] for k in keys] + [lay.slot_of[c] for c in cols]
        got = bufs["st"][rows].cpu().numpy()
        final = {k: got[i] for i, k in enumerate(keys)}
        if cols:
            final["cf"] = np.ascontiguousarray(got[len(keys):].T)
        for b in sim.binds:
            if b.kind == "ram":
                off, d = lay.mem_at[b.memkey]
                final[b.memkey] = bufs["mem"][off:off + d].T.contiguous().cpu().numpy()
        return final

    # -- running -------------------------------------------------------------------
    def launch(self, bufs: dict[str, torch.Tensor], B: int, T: int,
               trace: Optional[torch.Tensor], device: torch.device) -> None:
        """One launch over device buffers (updated in place) for ``T``
        cycles; ``trace`` is a ``(T, names, B)`` int64 tensor or None."""
        global launches
        from ...kernels import _build

        launcher = self.build()
        ptrs = [bufs[k].data_ptr() for k in ("st", "mem", "ring")]
        ptrs.append(0 if trace is None else trace.data_ptr())
        rc = _build.on_device(device, launcher, *ptrs, B, T)
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
