"""Vectorized cycle-accurate RTL simulation.

Compiles a structured RTL design (``rtl.RTLModule``/``rtl.RTLDesign``) into a
pure array-program step function and runs whole stimulus *batches* through it:

  * the design is flattened (``RTLDesign.flatten``) and its external memref
    interface ports are *closed* — replaced by internal storage models that
    reproduce the interface timing exactly (register banks respond
    combinationally, RAM ports one cycle later);
  * combinational items are topologically sorted and compiled to a linear
    tape of ``int64`` array operations with explicit width masking;
  * ``ShiftReg``/``RegAssign``/``Memory``/``LoopController`` state is
    threaded through the step function with nonblocking (read-old,
    write-new) semantics;
  * on the ``"cuda"`` backend the tape becomes one CUDA kernel generated
    per design (``sim_cuda``): a thread per stimulus lane runs every cycle;
    the ``"torch"`` backend (the kernel's plain version) runs the same tape
    batch-first on int64 tensors with a Python cycle loop, on the CPU or the
    card; the ``"numpy"`` backend runs it on NumPy arrays on the host.

Semantics follow the event-driven oracle (``lower.to_sim``): values are bit
patterns masked to their net width, ``Signed`` sign-extends, division is
floor division (``//``), right shift is arithmetic on signed operands, and
division by zero yields 0 (the event simulator would fault; random stimulus
must not rely on it).  Widths above 63 bits are rejected.

The entry points take ``device=``: ``None`` means the CUDA device and raises
where there is none, ``"cpu"`` runs the torch backend on the host; a CUDA
device never falls back to the CPU.  The ``"numpy"`` backend needs no device.

On top of the simulator, ``run_differential`` is the verification harness:
it checks the vectorized simulator against the event-driven oracle lane by
lane, and ``verify_rtl_passes`` checks every RTL pass in
``RTL_PIPELINE_SPEC`` by comparing per-cycle result-port traces and final
memory/return state of each pass's input design against its output design.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..._device import resolve_device
from .. import ir
from ..ir import FuncOp, IntType, MemrefType, Module
from ..passmgr import PassManager
from . import rtl
from .rtl import (REG, WIRE, Binop, CombAssign, Const, Expr, Instance,
                  LoopController, MemRead, Memory, MemWrite, Mux, Net,
                  PortConflictAssert, Ref, Repeat, RegAssign, RTLDesign,
                  RTLModule, ShiftReg, Signed, Unop)

I64 = np.int64


class RTLSimError(Exception):
    pass


def _clog2(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _mask_of(w: int) -> int:
    """Python-int AND mask for a ``w``-bit pattern."""
    if w >= 64:
        raise RTLSimError(f"width {w} exceeds the 63-bit simulation domain")
    return (1 << w) - 1


def _signed_fix(p: np.ndarray, w: int, signed: bool) -> np.ndarray:
    """Pattern -> math value (sign-extend when the element type is signed)."""
    p = np.asarray(p, dtype=I64)
    if not signed or w >= 64:
        return p
    s = I64(1) << I64(w - 1)
    return ((p & ((I64(1) << I64(w)) - I64(1))) ^ s) - s


# ---------------------------------------------------------------------------
# Array-op backends.  The compiled tape is backend-agnostic: every closure
# takes (env, ops).  Both backends are batch-first: _TorchOps values are (B,)
# int64 tensors, _NumpyOps values (B,) arrays; constant sub-expressions stay
# Python ints and bools on either.
# ---------------------------------------------------------------------------


class _TorchOps:
    """The tape on int64 tensors, batch first, on the CPU or a CUDA device.

    Memories are copied on every write (``write_mem``), as ``_NumpyOps``
    does: nothing is updated in place, so a read in the same cycle always
    sees the old contents."""

    def __init__(self, batch: int, device: torch.device):
        self.B = int(batch)
        self.device = device
        self.zero = 0
        self.one = 1

    def _bcast(self, v):
        if isinstance(v, torch.Tensor) and v.shape == (self.B,):
            return v
        return torch.as_tensor(v, dtype=torch.int64,
                               device=self.device).expand(self.B)

    def where(self, c, a, b):
        if not isinstance(c, torch.Tensor):
            return a if c else b
        return torch.where(c, a, b)

    def minimum(self, a, b):
        if not isinstance(a, torch.Tensor):
            return min(a, b)
        return torch.clamp(a, max=b)

    def b2i(self, c):
        if not isinstance(c, torch.Tensor):
            return int(bool(c))
        return c.to(torch.int64)

    def stack(self, vs):
        return torch.stack([self._bcast(v) for v in vs], dim=-1)

    def sr_out(self, chain):
        return chain[:, -1]

    def sr_push(self, chain, v):
        return torch.cat([self._bcast(v)[:, None], chain[:, :-1]], dim=1)

    def read_mem(self, mem, addr):
        a = torch.clamp(self._bcast(addr), 0, mem.shape[1] - 1)
        return torch.gather(mem, 1, a[:, None])[:, 0]

    def write_mem(self, mem, addr, data, enb):
        a = torch.clamp(self._bcast(addr), 0, mem.shape[1] - 1)
        cur = torch.gather(mem, 1, a[:, None])[:, 0]
        d = self._bcast(self.where(enb, data, cur))
        out = mem.clone()
        out.scatter_(1, a[:, None], d[:, None])
        return out


class _NumpyOps:
    def __init__(self, batch: int):
        self.B = int(batch)
        self.zero = I64(0)
        self.one = I64(1)

    def where(self, c, a, b):
        return np.where(c, a, b)

    def minimum(self, a, b):
        return np.minimum(a, b)

    def b2i(self, c):
        return np.where(c, self.one, self.zero)

    def _bcast(self, v):
        return np.broadcast_to(np.asarray(v, dtype=I64), (self.B,))

    def sr_out(self, chain):
        return chain[:, -1]

    def sr_push(self, chain, v):
        return np.concatenate([self._bcast(v)[:, None], chain[:, :-1]],
                              axis=1)

    def read_mem(self, mem, addr):
        a = np.clip(self._bcast(addr), 0, mem.shape[1] - 1)
        return np.take_along_axis(mem, a[:, None], axis=1)[:, 0]

    def write_mem(self, mem, addr, data, enb):
        a = np.clip(self._bcast(addr), 0, mem.shape[1] - 1)
        cur = np.take_along_axis(mem, a[:, None], axis=1)[:, 0]
        d = self._bcast(np.where(enb, data, cur))
        out = mem.copy()
        np.put_along_axis(out, a[:, None], d[:, None], axis=1)
        return out


# ---------------------------------------------------------------------------
# Expression compiler: Expr -> closure(env, ops) returning the *math* value
# (exact modulo 2**64; patterns are materialized by masking at assignment).
# Static widths mirror backends.NetlistPrinter.expr_width.
# ---------------------------------------------------------------------------

_CMP_FNS = {
    "<": (lambda a, b: a < b), "<=": (lambda a, b: a <= b),
    ">": (lambda a, b: a > b), ">=": (lambda a, b: a >= b),
    "==": (lambda a, b: a == b), "!=": (lambda a, b: a != b),
}
_ARITH_FNS = {
    "+": (lambda a, b: a + b), "-": (lambda a, b: a - b),
    "*": (lambda a, b: a * b), "&": (lambda a, b: a & b),
    "|": (lambda a, b: a | b), "^": (lambda a, b: a ^ b),
}


def _compile_expr(e: Expr, widths: dict[str, int]):
    """Return ``(fn, width)``; ``fn(env, ops)`` evaluates the math value."""
    if isinstance(e, Const):
        if not isinstance(e.value, int):
            raise RTLSimError(f"non-integer constant {e.value!r} unsupported")
        v = int(e.value)
        w = e.width if e.width is not None else max(1, v.bit_length())
        return (lambda env, ops: v), w
    if isinstance(e, Ref):
        nm = e.name
        if nm not in widths:
            raise RTLSimError(f"reference to undeclared net {nm!r}")
        return (lambda env, ops: env[nm]), widths[nm]
    if isinstance(e, Signed):
        fa, w = _compile_expr(e.a, widths)
        m, s = _mask_of(w), 1 << (w - 1)
        return (lambda env, ops: ((fa(env, ops) & m) ^ s) - s), w
    if isinstance(e, Unop):
        if e.op != "~":
            raise RTLSimError(f"unop {e.op!r} unsupported")
        fa, w = _compile_expr(e.a, widths)
        return (lambda env, ops: ~fa(env, ops)), w
    if isinstance(e, Mux):
        fc, _ = _compile_expr(e.cond, widths)
        fa, wa = _compile_expr(e.a, widths)
        fb, wb = _compile_expr(e.b, widths)
        return (lambda env, ops: ops.where(
            fc(env, ops) != 0, fa(env, ops), fb(env, ops))), max(wa, wb)
    if isinstance(e, Repeat):
        fa, wa = _compile_expr(e.a, widths)
        w = e.n * wa
        if w >= 64:
            if isinstance(e.a, Const) and int(e.a.value) == 0:
                return (lambda env, ops: 0), 63
            raise RTLSimError(f"repeat to {w} bits unsupported")
        m = _mask_of(wa)
        factor = sum(1 << (i * wa) for i in range(e.n))
        return (lambda env, ops: (fa(env, ops) & m) * factor), w
    if isinstance(e, Binop):
        fa, wa = _compile_expr(e.a, widths)
        fb, wb = _compile_expr(e.b, widths)
        op = e.op
        if op in _CMP_FNS:
            cf = _CMP_FNS[op]
            return (lambda env, ops: ops.b2i(cf(fa(env, ops),
                                               fb(env, ops)))), 1
        if op == "&&":
            return (lambda env, ops: ops.b2i(
                (fa(env, ops) != 0) & (fb(env, ops) != 0))), 1
        if op == "||":
            return (lambda env, ops: ops.b2i(
                (fa(env, ops) != 0) | (fb(env, ops) != 0))), 1
        w = max(wa, wb)
        if op in _ARITH_FNS:
            af = _ARITH_FNS[op]
            return (lambda env, ops: af(fa(env, ops), fb(env, ops))), w
        if op == "/":
            # floor division, matching the event-driven oracle's `//`;
            # division by zero yields 0 instead of faulting per lane.
            def fdiv(env, ops):
                a, b = fa(env, ops), fb(env, ops)
                z = (b == 0)
                return ops.where(z, 0, a // ops.where(z, 1, b))
            return fdiv, w
        if op == "<<":
            if isinstance(e.b, Const):
                k = int(e.b.value)
                if k >= 64:
                    return (lambda env, ops: 0), w
                return (lambda env, ops: fa(env, ops) << k), w

            def fshl(env, ops):
                a, b = fa(env, ops), fb(env, ops)
                return ops.where(b >= 63, 0, a << ops.minimum(b, 62))
            return fshl, w
        if op == ">>":
            if isinstance(e.b, Const):
                k = min(int(e.b.value), 63)
                return (lambda env, ops: fa(env, ops) >> k), w

            def fshr(env, ops):
                a, b = fa(env, ops), fb(env, ops)
                return a >> ops.minimum(b, 63)
            return fshr, w
        raise RTLSimError(f"binop {op!r} unsupported")
    raise RTLSimError(f"expression {type(e).__name__} unsupported")


# ---------------------------------------------------------------------------
# Closing the external interface: memref argument ports become internal
# storage with the exact interface timing of verilog.FuncLowering.
# ---------------------------------------------------------------------------


@dataclass
class _Bind:
    index: int
    kind: str                      # "scalar" | "bank" | "ram"
    port: str = ""                 # scalar input port
    width: int = 0
    signed: bool = False
    mt: Optional[MemrefType] = None
    cells: list = field(default_factory=list)  # bank: [[net per elem]/bank]
    memkey: str = ""               # ram: state key of the backing array


def close_module(flat: RTLModule, func: FuncOp
                 ) -> tuple[list[_Bind], list[str]]:
    """Convert ``flat``'s memref interface ports into internal storage items
    (mutating ``flat``), returning ``(bindings, traced)``: the argument
    bindings the runner uses to load stimulus and read back final state, and
    the demoted interface-port nets (the design's observable boundary — what
    per-cycle differential checks compare).  Register-bank arguments become
    per-cell registers with combinational (same-cycle) read response and
    address-decoded clocked writes; packed arguments become a ``Memory`` with
    the interface's one-cycle read latency."""
    binds: list[_Bind] = []
    traced: list[str] = []
    port_by = {p.name: p for p in flat.ports}
    for i, a in enumerate(func.args):
        ports = flat.arg_ports.get(i, [])
        if not isinstance(a.type, MemrefType):
            if not ports:
                raise RTLSimError(f"argument {i} has no interface ports")
            pname = ports[0][0]
            w = port_by[pname].width
            signed = isinstance(a.type, IntType) and a.type.signed
            binds.append(_Bind(i, "scalar", port=pname, width=w,
                               signed=signed))
            continue
        mt = a.type
        dw = mt.elem_bits()
        roles: dict[tuple[str, int], str] = {}
        for pname, _pdir, role, bank in ports:
            roles[(role, bank)] = pname
            p = port_by.pop(pname, None)
            if p is not None:
                flat.ports.remove(p)
                traced.append(pname)
                kind = REG if (role == "rd_data" and bank == -1) else WIRE
                if pname not in flat.nets:
                    flat.nets[pname] = Net(pname, p.width, kind, False,
                                           f"extif:{i}", "")
        signed = isinstance(mt.elem, IntType) and mt.elem.signed
        if mt.distributed:
            aw = _clog2(mt.bank_elems)
            cells: list[list[str]] = []
            for bk in range(mt.num_banks):
                row = []
                for d in range(mt.bank_elems):
                    cn = f"__ext{i}_b{bk}_{d}"
                    flat.nets[cn] = Net(cn, dw, REG, False, "extbank", "")
                    row.append(cn)
                cells.append(row)
                rd = roles.get(("rd_data", bk))
                if rd is not None:
                    ra = roles.get(("rd_addr", bk))
                    ex: Expr = Ref(row[0])
                    if ra is not None and mt.bank_elems > 1:
                        for d in range(1, mt.bank_elems):
                            ex = Mux(Binop("==", Ref(ra), Const(d, aw),
                                           free=True), Ref(row[d]), ex, dw)
                    flat.items.append(CombAssign(rd, ex))
                we = roles.get(("wr_en", bk))
                if we is not None:
                    wa = roles.get(("wr_addr", bk))
                    wd = roles[("wr_data", bk)]
                    for d in range(mt.bank_elems):
                        en: Expr = Ref(we)
                        if wa is not None:
                            en = Binop("&&", Ref(we),
                                       Binop("==", Ref(wa), Const(d, aw),
                                             free=True), free=True)
                        flat.items.append(RegAssign(row[d], Ref(wd), en))
            binds.append(_Bind(i, "bank", width=dw, signed=signed, mt=mt,
                               cells=cells))
        else:
            memname = f"__ext{i}"
            flat.items.append(Memory(memname, 1, mt.bank_elems, dw, "bram"))
            rd = roles.get(("rd_data", -1))
            if rd is not None:
                flat.items.append(MemRead(
                    rd, memname, 0, Ref(roles[("rd_addr", -1)]),
                    Ref(roles[("rd_en", -1)])))
            we = roles.get(("wr_en", -1))
            if we is not None:
                flat.items.append(MemWrite(
                    memname, 0, Ref(roles[("wr_addr", -1)]),
                    Ref(roles[("wr_data", -1)]), Ref(we)))
            binds.append(_Bind(i, "ram", width=dw, signed=signed, mt=mt,
                               memkey=f"mem:{memname}:0"))
    return binds, traced


# ---------------------------------------------------------------------------
# The compiled step program and the batched runner
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    """Outcome of one batched run.  All arrays are batch-first numpy int64.

    ``returns[j]``/``returns_valid[j]`` are the captured ``result_j`` values
    (sign-corrected per the function's result types) and whether the valid
    pulse fired; ``arrays[i]`` is the final content of memref argument ``i``
    in its original tensor shape; ``conflicts`` counts §4.5 port-conflict
    cycles per lane; ``trace[p]`` is the per-cycle (T, B) pattern of output
    port ``p`` when tracing was requested."""

    backend: str
    cycles: int
    batch: int
    returns: list[np.ndarray]
    returns_valid: list[np.ndarray]
    arrays: dict[int, np.ndarray]
    conflicts: np.ndarray
    conflict_buses: list[str]
    trace: Optional[dict[str, np.ndarray]] = None


class RTLSimulator:
    """Batched cycle-accurate interpreter for one RTL design entry.

    ``design`` is the (possibly hierarchical) RTL design; ``func`` the
    originating ``hir.func`` (argument/result types and memory layout).
    ``backend`` is ``"cuda"`` (the generated kernel), ``"torch"`` (its
    plain version), ``"numpy"`` or ``"auto"``: ``"cuda"`` on a CUDA device,
    ``"torch"`` on the CPU.  ``device=None`` means the CUDA device and raises
    where there is none; the ``"numpy"`` backend takes no device.
    """

    def __init__(self, design: RTLDesign, func: FuncOp,
                 entry: Optional[str] = None, backend: str = "auto",
                 device: Optional[Any] = None):
        entry = entry or design.entry
        assert entry is not None, "entry module required"
        self.entry = entry
        self.func = func
        flat = design.flatten(entry)
        self.binds, self._ext_traced = close_module(flat, func)
        self.flat = flat
        self.device = None if backend == "numpy" else resolve_device(device)
        self.backend = self._resolve_backend(backend, self.device)
        self._kernel: Optional[Any] = None
        self._build()

    @staticmethod
    def _resolve_backend(backend: str, device: Optional[torch.device]) -> str:
        if backend == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        assert backend in ("cuda", "torch", "numpy"), backend
        if backend == "cuda" and device.type != "cuda":
            raise RTLSimError(f"cuda backend requested on device {device}")
        return backend

    # -- compilation ---------------------------------------------------------
    def _build(self) -> None:
        m = self.flat
        rtl._ensure_recursion_headroom()
        widths = {n: v.width for n, v in m.nets.items()}
        for p in m.ports:
            widths.setdefault(p.name, p.width)
        self.widths = widths

        mems: dict[str, Memory] = {}
        driven: set[str] = set()
        for it in m.items:
            if isinstance(it, Instance):
                raise RTLSimError("flatten left an Instance behind")
            if isinstance(it, Memory):
                mems[it.name] = it
            driven.update(it.writes())
        inputs = {p.name for p in m.ports if p.dir == "input"}
        driven |= inputs | {"clk", "rst"}

        # undriven wires read somewhere float to 0 (Verilog would read X;
        # the lowering never relies on such reads — this keeps the tape total)
        tied: list[tuple[str, int]] = []
        for it in m.items:
            for r in it.reads():
                if r not in driven:
                    driven.add(r)
                    tied.append((r, widths.get(r, 1)))

        self.state_nets: list[str] = []                 # REG nets, per lane
        self.sr_loads: list[tuple[str, str]] = []       # (dest, state key)
        self.scalar_inputs = [(b.port, f"in:{b.port}") for b in self.binds
                              if b.kind == "scalar"]
        state_shape: dict[str, tuple] = {k: () for _, k in self.scalar_inputs}
        seen_state: set[str] = set()

        def mark_state(net: str) -> None:
            if net and net not in seen_state:
                seen_state.add(net)
                self.state_nets.append(net)
                state_shape[net] = ()

        for nm, mem in mems.items():
            for bk in range(mem.banks):
                state_shape[f"mem:{nm}:{bk}"] = (mem.depth,)

        # comb node: (dest, kind, payload, reads) — kind "assign" payload is
        # (fn, mask); kind "ctrl" payload is the controller spec (iter pulse)
        comb_nodes: list[tuple] = []
        clocked: list[tuple] = []
        asserts: list[tuple[str, list]] = []

        for nm, w in tied:
            comb_nodes.append((nm, "assign", ((lambda env, ops: 0),
                                              _mask_of(w)), ()))

        for it in m.items:
            if isinstance(it, CombAssign):
                fn, _ = _compile_expr(it.expr, widths)
                w = widths.get(it.dest)
                if w is None:
                    raise RTLSimError(f"assign to undeclared {it.dest!r}")
                comb_nodes.append((it.dest, "assign", (fn, _mask_of(w)),
                                   tuple(it.reads())))
            elif isinstance(it, ShiftReg):
                key = f"sr:{it.dest}"
                state_shape[key] = (it.depth,)
                self.sr_loads.append((it.dest, key))
                fn, _ = _compile_expr(it.src, widths)
                clocked.append(("sr", key, fn, _mask_of(it.width)))
            elif isinstance(it, RegAssign):
                mark_state(it.dest)
                fn, _ = _compile_expr(it.src, widths)
                en = (None if it.en is None
                      else _compile_expr(it.en, widths)[0])
                clocked.append(("reg", it.dest, fn, en,
                                _mask_of(widths[it.dest])))
            elif isinstance(it, MemRead):
                mark_state(it.dest)
                afn, _ = _compile_expr(it.addr, widths)
                efn, _ = _compile_expr(it.en, widths)
                clocked.append(("memrd", it.dest, f"mem:{it.mem}:{it.bank}",
                                afn, efn, _mask_of(widths[it.dest])))
            elif isinstance(it, MemWrite):
                afn, _ = _compile_expr(it.addr, widths)
                dfn, _ = _compile_expr(it.data, widths)
                efn, _ = _compile_expr(it.en, widths)
                clocked.append(("memwr", f"mem:{it.mem}:{it.bank}", afn, dfn,
                                efn, _mask_of(mems[it.mem].width)))
            elif isinstance(it, LoopController):
                mark_state(it.iv)
                mark_state(it.active)
                if it.endp:
                    mark_state(it.endp)
                if it.iicnt:
                    mark_state(it.iicnt)
                spec = {
                    "iv": it.iv, "active": it.active, "endp": it.endp,
                    "iicnt": it.iicnt, "ii": it.ii,
                    "ivmask": _mask_of(it.ivw),
                    "start": _compile_expr(it.start, widths)[0],
                    "lb": _compile_expr(it.lb, widths)[0],
                    "ub": _compile_expr(it.ub, widths)[0],
                    "step": _compile_expr(it.step, widths)[0],
                    "inner": (None if it.inner_end is None
                              else _compile_expr(it.inner_end, widths)[0]),
                }
                clocked.append(("ctrl", spec))
                deps = tuple(r for e in it.exprs() for r in e.refs())
                comb_nodes.append((it.iter_net, "ctrl", spec, deps))
            elif isinstance(it, Memory):
                pass
            elif isinstance(it, PortConflictAssert):
                ens = [_compile_expr(e, widths)[0] for e in it.ens]
                asserts.append((it.bus, ens))
            else:
                raise RTLSimError(f"item {type(it).__name__} unsupported")

        self.clocked = clocked
        self.asserts = asserts
        self.conflict_buses = [bus for bus, _ in asserts]
        if asserts:
            state_shape["cf"] = (len(asserts),)
        self.results = list(m.result_ports)
        for j in range(len(self.results)):
            state_shape[f"ret:{j}:val"] = ()
            state_shape[f"ret:{j}:seen"] = ()
        self.state_shape = state_shape
        self.trace_names = ([p.name for p in m.ports if p.dir == "output"]
                            + list(self._ext_traced))
        self.comb_tape = self._topo_sort(comb_nodes)

    @staticmethod
    def _topo_sort(nodes: list[tuple]) -> list[tuple]:
        """Order combinational nodes so every read of a comb-driven net
        follows its producer (state nets and input ports are leaves)."""
        producer: dict[str, int] = {}
        for i, (dest, _k, _p, _r) in enumerate(nodes):
            if dest in producer:
                raise RTLSimError(
                    f"multiple combinational drivers of {dest!r}")
            producer[dest] = i
        succs: list[list[int]] = [[] for _ in nodes]
        indeg = [0] * len(nodes)
        for i, (_d, _k, _p, reads) in enumerate(nodes):
            for r in set(reads):
                j = producer.get(r)
                if j is not None and j != i:
                    succs[j].append(i)
                    indeg[i] += 1
        ready = [i for i, d in enumerate(indeg) if d == 0]
        order: list[int] = []
        while ready:
            i = ready.pop()
            order.append(i)
            for j in succs[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != len(nodes):
            cyc = [nodes[i][0] for i, d in enumerate(indeg) if d > 0]
            raise RTLSimError(f"combinational cycle through {cyc[:8]}")
        return [nodes[i] for i in order]

    # -- the per-cycle step --------------------------------------------------
    def _make_step(self, ops, trace: bool):
        comb_tape = self.comb_tape
        clocked = self.clocked
        asserts = self.asserts
        results = self.results
        scalar_inputs = self.scalar_inputs
        state_nets = self.state_nets
        sr_loads = self.sr_loads
        trace_names = self.trace_names if trace else [
            p for pair in results for p in pair]

        def step(state, t_start):
            env: dict[str, Any] = {"t_start": t_start, "clk": 0, "rst": 0}
            for pn, key in scalar_inputs:
                env[pn] = state[key]
            for n in state_nets:
                env[n] = state[n]
            for dest, key in sr_loads:
                env[dest] = ops.sr_out(state[key])
            for dest, kind, payload, _reads in comb_tape:
                if kind == "assign":
                    fn, mk = payload
                    env[dest] = fn(env, ops) & mk
                else:  # controller iter pulse
                    c = payload
                    act = state[c["active"]]
                    iv = state[c["iv"]]
                    sv = c["start"](env, ops) != 0
                    step_up = iv + c["step"](env, ops)
                    more = step_up < c["ub"](env, ops)
                    if c["ii"] is not None:
                        cn = (state[c["iicnt"]] == c["ii"] - 1) \
                            if c["ii"] > 1 else (act == act)
                    else:
                        cn = c["inner"](env, ops) != 0
                    env[dest] = ops.b2i(sv | ((act != 0) & cn & more))
            pend: dict[str, Any] = {}

            def cur(k):
                return pend[k] if k in pend else state[k]

            for ent in clocked:
                tag = ent[0]
                if tag == "sr":
                    _t, key, fn, mk = ent
                    pend[key] = ops.sr_push(cur(key), fn(env, ops) & mk)
                elif tag == "reg":
                    _t, dest, fn, en, mk = ent
                    enb = True if en is None else (en(env, ops) != 0)
                    pend[dest] = ops.where(enb, fn(env, ops) & mk, cur(dest))
                elif tag == "memrd":
                    _t, dest, memkey, afn, efn, mk = ent
                    enb = efn(env, ops) != 0
                    v = ops.read_mem(state[memkey], afn(env, ops)) & mk
                    pend[dest] = ops.where(enb, v, cur(dest))
                elif tag == "memwr":
                    _t, memkey, afn, dfn, efn, mk = ent
                    enb = efn(env, ops) != 0
                    pend[memkey] = ops.write_mem(
                        cur(memkey), afn(env, ops), dfn(env, ops) & mk, enb)
                else:  # controller clocked half
                    c = ent[1]
                    act = state[c["active"]]
                    iv = state[c["iv"]]
                    actb = act != 0
                    sv = c["start"](env, ops) != 0
                    lbv = c["lb"](env, ops)
                    stepv = c["step"](env, ops)
                    ubv = c["ub"](env, ops)
                    step_up = iv + stepv
                    more = step_up < ubv
                    if c["ii"] is not None:
                        if c["ii"] > 1:
                            iicnt = state[c["iicnt"]]
                            cn = iicnt == c["ii"] - 1
                            nxt = ops.where(cn, ops.zero, iicnt + ops.one)
                            pend[c["iicnt"]] = ops.where(
                                sv, ops.zero, ops.where(actb, nxt, iicnt))
                        else:
                            cn = actb | True  # constant true, array-shaped
                    else:
                        cn = c["inner"](env, ops) != 0
                    ivm = c["ivmask"]
                    pend[c["iv"]] = ops.where(
                        sv, lbv & ivm,
                        ops.where(actb & cn & more, step_up & ivm, iv))
                    pend[c["active"]] = ops.where(
                        sv, ops.one,
                        ops.where(actb & cn & (step_up >= ubv), ops.zero,
                                  act))
                    if c["endp"]:
                        pend[c["endp"]] = ops.b2i(
                            actb & cn & (step_up >= ubv))
            for j, (dp, vp) in enumerate(results):
                validb = env[vp] != 0
                seen = state[f"ret:{j}:seen"]
                pend[f"ret:{j}:val"] = ops.where(
                    validb & (seen == 0), env[dp], state[f"ret:{j}:val"])
                pend[f"ret:{j}:seen"] = ops.where(validb, ops.one, seen)
            if asserts:
                viols = [ops.b2i(sum(ops.b2i(en(env, ops) != 0)
                                     for en in ens) > 1)
                         for _bus, ens in asserts]
                cf = state["cf"]
                stacked = (ops.stack(viols) if ops.__class__ is _TorchOps
                           else np.stack(viols, axis=-1))
                pend["cf"] = cf + stacked
            ns = dict(state)
            ns.update(pend)
            outs = tuple(env[p] for p in trace_names)
            return ns, outs

        return step, trace_names

    # -- stimulus packing ----------------------------------------------------
    def _layout(self, b: _Bind, arr: np.ndarray) -> np.ndarray:
        """(B, *shape) tensor -> (B, banks, elems) interface layout."""
        mt = b.mt
        perm = (0,) + tuple(d + 1 for d in mt.distributed) \
            + tuple(d + 1 for d in mt.packed)
        r = np.ascontiguousarray(np.transpose(arr, perm))
        return r.reshape(arr.shape[0], mt.num_banks, mt.bank_elems)

    def _unlayout(self, b: _Bind, r: np.ndarray) -> np.ndarray:
        mt = b.mt
        B = r.shape[0]
        dist_shape = tuple(mt.shape[d] for d in mt.distributed)
        packed_shape = tuple(mt.shape[d] for d in mt.packed)
        r = r.reshape((B,) + dist_shape + packed_shape)
        perm = (0,) + tuple(d + 1 for d in mt.distributed) \
            + tuple(d + 1 for d in mt.packed)
        inv = np.argsort(perm)
        return np.ascontiguousarray(np.transpose(r, inv))

    def _init_state(self, args: Sequence[Any], B: int) -> dict[str, np.ndarray]:
        state: dict[str, np.ndarray] = {}
        for key, shape in self.state_shape.items():
            state[key] = np.zeros((B,) + shape, dtype=I64)
        for b in self.binds:
            a = args[b.index]
            if b.kind == "scalar":
                v = np.broadcast_to(np.asarray(a, dtype=I64), (B,))
                state[f"in:{b.port}"] = (v & _mask_of(b.width)).astype(I64)
                continue
            arr = np.asarray(a, dtype=I64)
            if arr.shape != (B,) + b.mt.shape:
                raise RTLSimError(
                    f"arg {b.index}: expected batch shape {(B,) + b.mt.shape},"
                    f" got {arr.shape}")
            r = self._layout(b, arr & _mask_of(b.width))
            if b.kind == "ram":
                state[b.memkey] = r[:, 0, :].copy()
            else:
                for bk, row in enumerate(b.cells):
                    for d, cn in enumerate(row):
                        state[cn] = r[:, bk, d].copy()
        return state

    # -- execution -----------------------------------------------------------
    def run(self, args: Sequence[Any], cycles: int, batched: bool = False,
            check_conflicts: bool = True, trace: bool = False) -> SimResult:
        """Simulate ``cycles`` cycles of the design over a stimulus batch.

        ``args`` mirrors the hir.func arguments: scalars (python ints or
        (B,) arrays) and numpy arrays of the memref shape ((B, *shape) when
        ``batched``).  ``t_start`` pulses at cycle 0.  Unlike the
        event-driven simulator the input arrays are never mutated."""
        if not batched:
            lifted = []
            for b, a in zip(self.binds, list(args)):
                if b.kind == "scalar":
                    lifted.append(np.asarray([a], dtype=I64))
                else:
                    lifted.append(np.asarray(a, dtype=I64)[None])
            res = self.run(lifted, cycles, batched=True,
                           check_conflicts=check_conflicts, trace=trace)
            return res
        if len(args) != len(self.binds):
            raise RTLSimError(f"expected {len(self.binds)} args")
        B = None
        for b, a in zip(self.binds, args):
            if b.kind != "scalar":
                B = np.asarray(a).shape[0]
                break
            a = np.asarray(a)
            if a.ndim == 1:
                B = a.shape[0]
        if B is None:
            B = 1
        xs = np.zeros(cycles, dtype=I64)
        xs[0] = 1
        if self.backend == "cuda":          # the state is laid out on the card
            final, ys = self._run_cuda(args, xs, B, trace)
        elif self.backend == "torch":
            final, ys = self._run_torch(self._init_state(args, B), xs, B, trace)
        else:
            final, ys = self._run_numpy(self._init_state(args, B), xs, B, trace)
        return self._collect(final, ys, B, cycles, check_conflicts, trace)

    def cuda_kernel(self):
        """The design's generated simulator kernel (``sim_cuda.SimKernel``):
        its source is made here, its library built at its first launch."""
        if self._kernel is None:
            from .sim_cuda import SimKernel

            self._kernel = SimKernel(self)
        return self._kernel

    def _run_cuda(self, args, xs, B: int, trace: bool):
        return self.cuda_kernel().run(self, args, xs, B, trace, self.device)

    def _run_torch(self, state, xs, B: int, trace: bool):
        ops = _TorchOps(B, self.device)
        step, names = self._make_step(ops, trace)
        st = {k: torch.from_numpy(v).to(self.device) for k, v in state.items()}
        recs: list[tuple] = []
        for t in range(len(xs)):
            st, outs = step(st, int(xs[t]))
            recs.append(outs)
        ys = {n: torch.stack([ops._bcast(r[i]) for r in recs]).cpu().numpy()
              for i, n in enumerate(names)}
        final = {k: np.ascontiguousarray(np.broadcast_to(
                     np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v,
                                dtype=I64), state[k].shape))
                 for k, v in st.items()}
        return final, ys

    def _run_numpy(self, state, xs, B: int, trace: bool):
        step, names = self._make_step(_NumpyOps(B), trace)
        recs: list[tuple] = []
        for t in range(len(xs)):
            state, outs = step(state, I64(xs[t]))
            recs.append(outs)
        ys = {n: np.stack([np.broadcast_to(np.asarray(r[i], dtype=I64), (B,))
                           for r in recs])
              for i, n in enumerate(names)}
        return state, ys

    def _collect(self, final, ys, B, cycles, check_conflicts, trace):
        rts = self.func.attrs.get("result_types", [])
        returns, valids = [], []
        for j, (dp, _vp) in enumerate(self.results):
            p = np.asarray(final[f"ret:{j}:val"], dtype=I64)
            w = self.widths[dp]
            signed = (isinstance(rts[j], IntType) and rts[j].signed
                      if j < len(rts) else True)
            returns.append(_signed_fix(p, w, signed))
            valids.append(np.asarray(final[f"ret:{j}:seen"], dtype=I64))
        arrays: dict[int, np.ndarray] = {}
        for b in self.binds:
            if b.kind == "scalar":
                continue
            if b.kind == "ram":
                r = np.asarray(final[b.memkey], dtype=I64)[:, None, :]
            else:
                r = np.zeros((B, b.mt.num_banks, b.mt.bank_elems), dtype=I64)
                for bk, row in enumerate(b.cells):
                    for d, cn in enumerate(row):
                        r[:, bk, d] = np.asarray(final[cn], dtype=I64)
            r = r.reshape(B, b.mt.num_banks, b.mt.bank_elems)
            arr = self._unlayout(b, r)
            arrays[b.index] = _signed_fix(arr, b.width, b.signed)
        if self.asserts:
            per_bus = np.asarray(final["cf"], dtype=I64).reshape(
                B, len(self.asserts))
            conflicts = per_bus.sum(axis=1)
        else:
            conflicts = np.zeros(B, dtype=I64)
        if check_conflicts and conflicts.any():
            lanes = np.nonzero(conflicts)[0][:4].tolist()
            raise RTLSimError(
                f"port conflict (UB 4.5) in lanes {lanes}; "
                f"buses={self.conflict_buses[:4]}")
        tr = None
        if trace:
            tr = {n: np.asarray(y, dtype=I64) for n, y in ys.items()}
        return SimResult(self.backend, cycles, B, returns, valids, arrays,
                         conflicts, list(self.conflict_buses), tr)


# ---------------------------------------------------------------------------
# Convenience drivers
# ---------------------------------------------------------------------------


def design_of(mods: dict[str, Any], entry: str) -> RTLDesign:
    """Rebuild an ``RTLDesign`` from ``generate_verilog``'s output map."""
    d = RTLDesign(entry=entry)
    for name, vm in mods.items():
        m = getattr(vm, "rtl", None) or vm
        if not isinstance(m, RTLModule):
            raise RTLSimError(f"module {name} carries no RTL structure")
        d.add(m)
    return d


def simulator_for(module: Module, entry: str, *, hierarchy: str = "inline",
                  backend: str = "auto", rtl_spec: Optional[str] = "default",
                  device: Optional[Any] = None,
                  ) -> tuple[RTLSimulator, Module]:
    """Clone ``module``, run the codegen pipeline and build a simulator.

    Returns ``(sim, prepared)`` where ``prepared`` is the cloned module
    *after* the pre-codegen pipeline — the exact HIR the event-driven oracle
    (``lower.simulate``) should run for lane-by-lane comparison.
    ``device`` as for ``RTLSimulator``; it is resolved before any work."""
    from .verilog import generate_verilog

    if backend != "numpy":
        device = resolve_device(device)

    prepared = module.clone()
    kw = {} if rtl_spec == "default" else {"rtl_spec": rtl_spec}
    mods = generate_verilog(prepared, entry, hierarchy=hierarchy, **kw)
    design = design_of(mods, entry)
    sim = RTLSimulator(design, prepared.funcs[entry], entry, backend=backend,
                       device=device)
    return sim, prepared


def probe_cycles(prepared: Module, entry: str, args: Sequence[Any],
                 margin: int = 16) -> int:
    """Cycle budget for a batched run: one event-driven simulation on fresh
    zero-filled copies of ``args`` (loop trip counts are static in this flow,
    so the latency is data-independent)."""
    from ..lower.to_sim import simulate

    probe_args = []
    for a in args:
        if isinstance(a, np.ndarray):
            probe_args.append(np.zeros_like(a))
        else:
            probe_args.append(0)
    res = simulate(prepared, entry, probe_args)
    return int(res["cycles"]) + margin


def stack_stimulus(make_inputs: Callable[..., list], n_vectors: int,
                   base_seed: int = 0, **kw) -> list[np.ndarray]:
    """Stack ``n_vectors`` calls of a gallery-style ``make_inputs(seed=k)``
    into batch-first arrays — domain-respecting random stimulus."""
    cols = None
    for k in range(n_vectors):
        row = make_inputs(seed=base_seed + k, **kw)
        if cols is None:
            cols = [[] for _ in row]
        for c, v in zip(cols, row):
            c.append(np.asarray(v))
    return [np.stack(c).astype(I64) for c in cols]


def fold_in_stimulus(widths: Sequence[int], n_lanes: int,
                     seed: int = 0) -> list[np.ndarray]:
    """Per-lane random stimulus from counter-based streams: one scalar per
    (input, lane), each drawn from an independent
    ``numpy.random.SeedSequence(entropy=seed, spawn_key=(input, lane))``
    stream and masked to the input's bit width.  Unlike sequential
    generators, these streams are stable under lane/input reordering —
    adding a lane never perturbs the values the existing lanes see, so
    seed-pinned differential suites stay reproducible as they grow."""
    masks = [(1 << min(int(w), 63)) - 1 for w in widths]
    out: list[np.ndarray] = []
    for i, mask in enumerate(masks):
        lanes = []
        for lane in range(n_lanes):
            rng = np.random.default_rng(
                np.random.SeedSequence(entropy=seed, spawn_key=(i, lane)))
            lanes.append(int(rng.integers(0, 1 << 63, dtype=np.int64)) & mask)
        out.append(np.asarray(lanes, dtype=I64))
    return out


# ---------------------------------------------------------------------------
# Differential verification harness
# ---------------------------------------------------------------------------


@dataclass
class DiffReport:
    kernel: str
    hierarchy: str
    backend: str
    n_vectors: int
    cycles: int
    event_lanes_checked: int
    event_ok: bool
    oracle_ok: Optional[bool]
    passes_ok: Optional[dict[str, bool]]
    mismatches: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (self.event_ok and self.oracle_ok in (None, True)
                and (self.passes_ok is None
                     or all(self.passes_ok.values())))


def _result_args(sim: RTLSimulator, res: SimResult, lane: int,
                 args_batch: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Final memref contents for one lane, in argument order."""
    out = []
    for b in sim.binds:
        if b.kind == "scalar":
            out.append(None)
        else:
            out.append(res.arrays[b.index][lane])
    return out


def run_differential(module: Module, entry: str,
                     args_batch: Sequence[np.ndarray], *,
                     kernel: str = "", hierarchy: str = "inline",
                     backend: str = "auto", event_lanes: int = 2,
                     oracle: Optional[Callable] = None,
                     oracle_nargs: int = 0, result_arg: int = -1,
                     check_passes: bool = True,
                     pass_lanes: int = 16,
                     device: Optional[Any] = None) -> DiffReport:
    """Differentially verify one kernel over a stimulus batch.

    (a) runs the vectorized simulator over the whole batch and re-runs
    ``event_lanes`` sample lanes through the event-driven oracle, comparing
    final memory arrays and scalar returns; (b) when ``oracle`` is given,
    checks the memref written by the design (``result_arg``) against
    ``oracle(*args[:oracle_nargs])`` on every lane; (c) when
    ``check_passes``, re-lowers without RTL passes and replays the pass
    pipeline one pass at a time, asserting per-cycle result-port traces and
    final state match between every pass input and output
    (``verify_rtl_passes``, on its own ``"numpy"`` default).  ``device`` is
    the simulator's (see ``RTLSimulator``)."""
    from ..lower.to_sim import simulate

    mismatches: list[str] = []
    sim, prepared = simulator_for(module, entry, hierarchy=hierarchy,
                                  backend=backend, device=device)
    B = int(np.asarray(args_batch[0]).shape[0]) if args_batch else 1
    single0 = [np.asarray(a)[0] for a in args_batch]
    cycles = probe_cycles(prepared, entry, single0)
    res = sim.run(args_batch, cycles, batched=True)

    # (a) event-driven oracle on sample lanes
    event_ok = True
    lanes = list(range(min(event_lanes, B)))
    for k in lanes:
        ev_args: list[Any] = []
        for b, a in zip(sim.binds, args_batch):
            al = np.asarray(a)[k]
            ev_args.append(int(al) if b.kind == "scalar" else al.copy())
        ev = simulate(prepared, entry, ev_args)
        for b in sim.binds:
            if b.kind == "scalar":
                continue
            got = res.arrays[b.index][k]
            want = ev_args[b.index]
            if not np.array_equal(got, want):
                event_ok = False
                mismatches.append(
                    f"lane {k} arg {b.index}: vectorized != event-driven")
        ev_rets = ev.get("returns") or {}
        for j in range(len(sim.results)):
            if f"ret{j}" not in ev_rets:
                continue
            rv = ev_rets[f"ret{j}"]
            if res.returns_valid[j][k] == 0:
                event_ok = False
                mismatches.append(f"lane {k} result_{j}: no valid pulse")
            elif int(res.returns[j][k]) != int(rv):
                event_ok = False
                mismatches.append(
                    f"lane {k} result_{j}: {int(res.returns[j][k])} != {rv}")

    # (b) functional oracle on every lane
    oracle_ok: Optional[bool] = None
    if oracle is not None:
        oracle_ok = True
        ridx = result_arg if result_arg >= 0 else len(args_batch) - 1
        for k in range(B):
            want = np.asarray(
                oracle(*[np.asarray(args_batch[i])[k]
                         for i in range(oracle_nargs)]))
            got = res.arrays[ridx][k]
            if not np.array_equal(got.astype(I64), want.astype(I64)):
                oracle_ok = False
                mismatches.append(f"lane {k}: vectorized != oracle")
                break

    passes_ok = None
    if check_passes:
        sub = [np.asarray(a)[:min(pass_lanes, B)] for a in args_batch]
        passes_ok, pmism = verify_rtl_passes(
            prepared, entry, sub, cycles, hierarchy=hierarchy)
        mismatches.extend(pmism)

    return DiffReport(kernel or entry, hierarchy, sim.backend, B, cycles,
                      len(lanes), event_ok, oracle_ok, passes_ok, mismatches)


def verify_rtl_passes(prepared: Module, entry: str,
                      args_batch: Sequence[np.ndarray], cycles: int, *,
                      hierarchy: str = "inline",
                      spec: Optional[str] = None,
                      backend: str = "numpy",
                      ) -> tuple[dict[str, bool], list[str]]:
    """Per-pass differential check: starting from the raw lowering, run each
    RTL pass of ``spec`` on a copy of the design and assert the pass output
    is cycle-accurate-equivalent to its input (result-port traces every
    cycle, final memref arrays, captured returns).  ``prepared`` must
    already be through the pre-codegen pipeline (see ``simulator_for``)."""
    from .verilog import RTL_PIPELINE_SPEC, lower_to_rtl

    spec = spec if spec is not None else RTL_PIPELINE_SPEC
    func = prepared.funcs[entry]
    rtl.clear_key_intern()
    emit = [entry] if hierarchy == "inline" else None
    design = lower_to_rtl(prepared, emit or [entry], hierarchy=hierarchy,
                          entry=entry)

    def signature(d: RTLDesign):
        s = RTLSimulator(d.copy(), func, entry, backend=backend)
        r = s.run(args_batch, cycles, batched=True, check_conflicts=False,
                  trace=True)
        return r

    ok: dict[str, bool] = {}
    mism: list[str] = []
    prev = signature(design)
    for name in [p.strip() for p in spec.split(",") if p.strip()]:
        pm = PassManager.from_spec(name)
        pm.run(design)
        cur = signature(design)
        good = True
        for p, tr in prev.trace.items():
            if p not in cur.trace or not np.array_equal(tr, cur.trace[p]):
                good = False
                mism.append(f"{name}: trace of {p} diverged")
        for i, arr in prev.arrays.items():
            if not np.array_equal(arr, cur.arrays[i]):
                good = False
                mism.append(f"{name}: final arg {i} diverged")
        if not np.array_equal(prev.conflicts, cur.conflicts):
            good = False
            mism.append(f"{name}: conflict counts diverged")
        ok[name] = good
        prev = cur
    return ok, mism


__all__ = [
    "RTLSimError", "RTLSimulator", "SimResult", "DiffReport",
    "close_module", "design_of", "simulator_for", "probe_cycles",
    "stack_stimulus", "run_differential", "verify_rtl_passes",
]
