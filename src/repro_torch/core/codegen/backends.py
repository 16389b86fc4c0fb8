"""Multi-backend netlist printers over the structured RTL IR.

Since PR 3 nothing below the HIR level is a string — ``RTLModule`` /
``RTLDesign`` are real data structures and text generation is a *printer*.
This module turns that printer into a backend abstraction:

  * ``NetlistPrinter``        — base class: per-construct emission hooks
                                (one per RTL item kind plus expression
                                printing, declarations, module assembly) and
                                a per-backend **identifier legalizer** that
                                renames nets/ports/modules colliding with the
                                target language's reserved words;
  * ``VerilogPrinter``        — behaviour-preserving port of the historical
                                ``print_rtl`` output (byte-identical for
                                designs without reserved-word collisions);
  * ``SystemVerilogPrinter``  — ``logic`` types, ``always_ff``/``always_comb``,
                                a typed enum per loop-controller FSM and SV
                                immediate assertions for the §4.5 UB
                                port-conflict guards;
  * ``VHDLPrinter``           — entity/architecture pairs, clocked processes,
                                ``numeric_std`` arithmetic (all multi-bit nets
                                are ``unsigned``, 1-bit nets ``std_logic``);
  * ``CIRCTPrinter``          — a CIRCT-style ``hw``/``comb``/``seq``-dialect
                                textual MLIR exporter (SSA form, graph
                                region) for interop with upstream MLIR
                                tooling.

All four read the same optimized ``RTLModule`` — resource summaries
(``verilog.netlist_of``) are derived from the structure *before* printing,
so they are backend-invariant by construction.  ``BACKENDS`` maps backend
name -> printer class; ``get_printer(name)`` instantiates one.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

from ..ir import UNKNOWN_LOC
from .rtl import (Binop, CombAssign, Const, Expr, Instance, Item,
                  LoopController, MemRead, Memory, MemWrite, Mux, Net,
                  PortConflictAssert, Ref, RegAssign, Repeat, RTLDesign,
                  RTLModule, ShiftReg, Signed, Unop,
                  _ensure_recursion_headroom, zeros)

# ---------------------------------------------------------------------------
# Reserved-word tables (shared with core.codegen.lint's dialect rule sets)
# ---------------------------------------------------------------------------

VERILOG_KEYWORDS = frozenset("""
always and assign automatic begin buf bufif0 bufif1 case casex casez cell
cmos config deassign default defparam design disable edge else end endcase
endconfig endfunction endgenerate endmodule endprimitive endspecify endtable
endtask event for force forever fork function generate genvar highz0 highz1
if ifnone incdir include initial inout input instance integer join large
liblist library localparam macromodule medium module nand negedge nmos nor
noshowcancelled not notif0 notif1 or output parameter pmos posedge primitive
pull0 pull1 pulldown pullup rcmos real realtime reg release repeat rnmos
rpmos rtran rtranif0 rtranif1 scalared showcancelled signed small specify
specparam strong0 strong1 supply0 supply1 table task time tran tranif0
tranif1 tri tri0 tri1 triand trior trireg unsigned use vectored wait wand
weak0 weak1 while wire wor xnor xor
""".split())

SV_EXTRA_KEYWORDS = frozenset("""
accept_on alias always_comb always_ff always_latch assert assume before bind
bins binsof bit break byte chandle checker class clocking const constraint
context continue cover covergroup coverpoint cross dist do endchecker
endclass endclocking endgroup endinterface endpackage endprogram endproperty
endsequence enum eventually expect export extends extern final first_match
foreach forkjoin global iff ignore_bins illegal_bins implements implies
import inside int interconnect interface intersect join_any join_none let
local logic longint matches modport nettype new nexttime null package packed
priority program property protected pure rand randc randcase randsequence
ref reject_on restrict return sequence shortint shortreal soft solve static
string strong struct super tagged this throughout timeprecision timeunit
type typedef union unique unique0 until until_with untyped var virtual void
wait_order weak wildcard with within
""".split())

SYSTEMVERILOG_KEYWORDS = VERILOG_KEYWORDS | SV_EXTRA_KEYWORDS

#: VHDL-2008 reserved words plus the std/numeric_std names the printer leans
#: on — renaming a net called ``resize`` is cheaper than qualifying every use.
VHDL_KEYWORDS = frozenset("""
abs access after alias all and architecture array assert attribute begin
block body buffer bus case component configuration constant context
disconnect downto else elsif end entity exit file for force function
generate generic group guarded if impure in inertial inout is label library
linkage literal loop map mod nand new next nor not null of on open or others
out package parameter port postponed procedure process protected pure range
record register reject release rem report return rol ror select severity
shared signal sla sll sra srl subtype then to transport type unaffected
units until use variable wait when while with xnor xor
std_logic std_logic_vector unsigned signed natural integer boolean string
bit bit_vector real time rising_edge falling_edge to_unsigned to_signed
to_integer resize shift_left shift_right true false note warning error
failure work ieee std_logic_1164 numeric_std rtl b2sl b2i u1
""".split())


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------


class NetlistPrinter:
    """Base class of backend printers.  A printer walks one ``RTLModule``
    and emits text through per-construct hooks (``emit_comb``,
    ``emit_shift_reg``, ...); subclasses override the hooks, the expression
    printer and ``assemble`` (header/declarations/footer layout).

    Identifier legalization is shared: ``build_rename_map`` renames any
    port/net/memory/instance name that collides with the backend's
    ``RESERVED`` words (or is not a legal identifier after ``sanitize``),
    and ``module_name_map`` does the same for module names design-wide so
    instance references stay consistent.
    """

    name = ""
    file_ext = ""
    comment_lead = "//"
    RESERVED: frozenset = frozenset()
    case_sensitive = True

    def __init__(self):
        self.m: Optional[RTLModule] = None
        self._ren: dict[str, str] = {}
        self._modmap: dict[str, str] = {}
        self._design: Optional[RTLDesign] = None
        self._callee_ren: dict[str, dict[str, str]] = {}

    # -- identifier legalization -------------------------------------------
    def sanitize(self, nm: str) -> str:
        s = re.sub(r"[^A-Za-z0-9_]", "_", nm) or "n"
        if s[0].isdigit():
            s = "n" + s
        return s

    def _norm(self, nm: str) -> str:
        return nm if self.case_sensitive else nm.lower()

    def is_reserved(self, nm: str) -> bool:
        return self._norm(nm) in self.RESERVED

    def _legal(self, nm: str, used: set) -> str:
        base = self.sanitize(nm)
        cand, k = base, 0
        while self.is_reserved(cand) or self._norm(cand) in used:
            cand = f"{base}_{k}"
            k += 1
        return cand

    def _legalize_names(self, names: Iterable[str]) -> dict[str, str]:
        """First come keeps its own (already-legal) name; everything else —
        reserved words, names needing sanitizing, case-insensitive dups —
        is renamed to a fresh legal identifier."""
        ordered, seen = [], set()
        for nm in names:
            if nm not in seen:
                seen.add(nm)
                ordered.append(nm)
        ren: dict[str, str] = {}
        used: set[str] = set()
        pending: list[str] = []
        for nm in ordered:
            if (self.sanitize(nm) == nm and not self.is_reserved(nm)
                    and self._norm(nm) not in used):
                used.add(self._norm(nm))
            else:
                pending.append(nm)
        for nm in pending:
            new = self._legal(nm, used)
            used.add(self._norm(new))
            ren[nm] = new
        return ren

    def build_rename_map(self, m: RTLModule) -> dict[str, str]:
        names = [p.name for p in m.ports] + list(m.nets)
        for it in m.items:
            if isinstance(it, Memory):
                names.append(it.name)
            elif isinstance(it, Instance):
                names.append(it.inst)
        return self._legalize_names(names)

    def module_name_map(self, names: Iterable[str]) -> dict[str, str]:
        return self._legalize_names(names)

    def n(self, nm: str) -> str:
        """The legalized spelling of a net/port/memory/instance name."""
        return self._ren.get(nm, nm)

    def mod(self, nm: str) -> str:
        """The legalized spelling of a module name."""
        return self._modmap.get(nm, nm)

    def callee_port_name(self, module: str, pname: str) -> str:
        """The spelling of ``pname`` as the callee module itself prints it
        (the callee's own rename map decides)."""
        if self._design is None or module not in self._design.modules:
            return pname
        ren = self._callee_ren.get(module)
        if ren is None:
            ren = self.build_rename_map(self._design.modules[module])
            self._callee_ren[module] = ren
        return ren.get(pname, pname)

    # -- widths -------------------------------------------------------------
    def width_of(self, name: str) -> Optional[int]:
        net = self.m.nets.get(name)
        if net is not None:
            return net.width
        for p in self.m.ports:
            if p.name == name:
                return p.width
        return None

    _CMPS = ("<", "<=", "==", "!=", ">", ">=")

    def expr_width(self, e: Expr) -> Optional[int]:
        if isinstance(e, Const):
            return e.width
        if isinstance(e, Ref):
            return self.width_of(e.name)
        if isinstance(e, Signed):
            return self.expr_width(e.a)
        if isinstance(e, Unop):
            return self.expr_width(e.a) or e.width
        if isinstance(e, Binop):
            if e.op in self._CMPS or e.op in ("&&", "||"):
                return 1
            ws = [w for w in (self.expr_width(e.a), self.expr_width(e.b)) if w]
            return max(ws) if ws else e.width
        if isinstance(e, Mux):
            ws = [w for w in (self.expr_width(e.a), self.expr_width(e.b)) if w]
            return max(ws) if ws else (e.width or 1)
        if isinstance(e, Repeat):
            return e.n * (self.expr_width(e.a) or 1)
        return None

    # -- public API ----------------------------------------------------------
    def print_module(self, m: RTLModule,
                     modmap: Optional[dict[str, str]] = None,
                     design: Optional[RTLDesign] = None) -> str:
        _ensure_recursion_headroom()
        self.m = m
        self._design = design
        if modmap is not None:
            self._modmap = modmap
        else:
            refs = [m.name] + [it.module for it in m.items
                               if isinstance(it, Instance)]
            self._modmap = self.module_name_map(refs)
        self._ren = self.build_rename_map(m)
        self.reset()
        decls: list[str] = []
        lines: list[str] = []
        for it in m.items:
            self.emit_item(it, lines, decls)
        return self.assemble(m, decls, lines)

    def print_modules(self, design: RTLDesign) -> dict[str, str]:
        modmap = self.module_name_map(design.modules)
        return {name: self.print_module(mm, modmap=modmap, design=design)
                for name, mm in design.modules.items()}

    def print_design(self, design: RTLDesign) -> str:
        return "\n".join(self.print_modules(design).values())

    def reset(self) -> None:
        """Per-module printer state; called after the rename map is built."""

    # -- dispatch ------------------------------------------------------------
    def emit_item(self, it: Item, out: list[str], decls: list[str]) -> None:
        if isinstance(it, CombAssign):
            self.emit_comb(it, out, decls)
        elif isinstance(it, ShiftReg):
            self.emit_shift_reg(it, out, decls)
        elif isinstance(it, RegAssign):
            self.emit_reg_assign(it, out, decls)
        elif isinstance(it, Memory):
            self.emit_memory(it, out, decls)
        elif isinstance(it, MemRead):
            self.emit_mem_read(it, out, decls)
        elif isinstance(it, MemWrite):
            self.emit_mem_write(it, out, decls)
        elif isinstance(it, LoopController):
            self.emit_controller(it, out, decls)
        elif isinstance(it, Instance):
            self.emit_instance(it, out, decls)
        elif isinstance(it, PortConflictAssert):
            self.emit_assert(it, out, decls)
        else:  # pragma: no cover - future item kinds
            raise NotImplementedError(type(it).__name__)

    def loc_of(self, it: Item) -> str:
        if it.loc is UNKNOWN_LOC:
            return ""
        return f" {self.comment_lead} {it.loc}"

    # hooks subclasses must provide
    def emit_comb(self, it, out, decls):  # pragma: no cover - abstract
        raise NotImplementedError

    def emit_shift_reg(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def emit_reg_assign(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def emit_memory(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def emit_mem_read(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def emit_mem_write(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def emit_controller(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def emit_instance(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def emit_assert(self, it, out, decls):  # pragma: no cover
        raise NotImplementedError

    def assemble(self, m, decls, lines) -> str:  # pragma: no cover
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Verilog (the historical printer, byte-identical modulo legalization)
# ---------------------------------------------------------------------------


class VerilogPrinter(NetlistPrinter):
    name = "verilog"
    file_ext = ".v"
    RESERVED = VERILOG_KEYWORDS

    # -- expressions ---------------------------------------------------------
    def x(self, e: Expr) -> str:
        if isinstance(e, Const):
            return self.x_const(e)
        if isinstance(e, Ref):
            return self.n(e.name)
        if isinstance(e, Signed):
            return f"$signed({self.x(e.a)})"
        if isinstance(e, Unop):
            return f"{e.op}({self.x(e.a)})"
        if isinstance(e, Binop):
            return f"({self.x(e.a)} {e.op} {self.x(e.b)})"
        if isinstance(e, Mux):
            return f"(({self.x(e.cond)}) ? ({self.x(e.a)}) : ({self.x(e.b)}))"
        if isinstance(e, Repeat):
            return f"{{{e.n}{{{self.x(e.a)}}}}}"
        raise NotImplementedError(type(e).__name__)

    @staticmethod
    def x_const(e: Const) -> str:
        if e.width is None or not isinstance(e.value, int):
            return str(e.value)
        if e.signed and e.value < 0:
            return f"-{e.width}'sd{-e.value}"
        if e.value < 0:
            return f"-{e.width}'d{-e.value}"
        return f"{e.width}'d{e.value}"

    # -- declarations --------------------------------------------------------
    def decl_net(self, net: Net) -> str:
        sgn = " signed" if net.signed else ""
        rng = f" [{net.width - 1}:0]" if net.width > 1 else ""
        c = f" // {net.comment}" if net.comment else ""
        return f"{net.kind}{sgn}{rng} {self.n(net.name)};{c}"

    def port_decl(self, p) -> str:
        rng = f" [{p.width - 1}:0]" if p.width > 1 else ""
        return f"{p.dir} wire{rng} {self.n(p.name)}"

    def reg_kw(self) -> str:
        return "reg"

    def clocked(self) -> str:
        return "always @(posedge clk)"

    # -- items ---------------------------------------------------------------
    def emit_comb(self, it: CombAssign, out, decls) -> None:
        out.append(f"assign {self.n(it.dest)} = {self.x(it.expr)};{self.loc_of(it)}")

    def emit_shift_reg(self, it: ShiftReg, out, decls) -> None:
        nm, d, w = self.n(it.dest), it.depth, it.width
        loc = self.loc_of(it)
        kw, clk = self.reg_kw(), self.clocked()
        rst = "rst ? " if it.reset_zero else ""
        if d == 1:
            decls.append(f"{kw} [{w - 1}:0] {nm}_q;" if w > 1 else f"{kw} {nm}_q;")
            z = self.x(zeros(w))
            src = f"{z} : {self.x(it.src)}" if it.reset_zero else f"{self.x(it.src)}"
            out.append(f"{clk} {nm}_q <= {rst}{src};{loc}")
            out.append(f"assign {nm} = {nm}_q;")
            return
        decls.append(f"{kw} [{w - 1}:0] {nm}_sr [0:{d - 1}];")
        out.append(f"{clk} begin{loc}")
        if it.reset_zero:
            out.append(f"  {nm}_sr[0] <= rst ? {self.x(zeros(w))} : {self.x(it.src)};")
        else:
            out.append(f"  {nm}_sr[0] <= {self.x(it.src)};")
        for s in range(1, d):
            if it.reset_zero:
                out.append(f"  {nm}_sr[{s}] <= rst ? {self.x(zeros(w))} : {nm}_sr[{s - 1}];")
            else:
                out.append(f"  {nm}_sr[{s}] <= {nm}_sr[{s - 1}];")
        out.append("end")
        out.append(f"assign {nm} = {nm}_sr[{d - 1}];")

    def emit_reg_assign(self, it: RegAssign, out, decls) -> None:
        guard = f"if ({self.x(it.en)}) " if it.en is not None else ""
        out.append(f"{self.clocked()} {guard}{self.n(it.dest)} <= "
                   f"{self.x(it.src)};{self.loc_of(it)}")

    def emit_memory(self, it: Memory, out, decls) -> None:
        style = "block" if it.kind == "bram" else "distributed"
        for bk in range(it.banks):
            decls.append(
                f'(* ram_style = "{style}" *) {self.reg_kw()} [{it.width - 1}:0] '
                f"{self.n(it.name)}_ram{bk} [0:{max(it.depth - 1, 1)}];"
            )

    def emit_mem_read(self, it: MemRead, out, decls) -> None:
        out.append(
            f"{self.clocked()} if ({self.x(it.en)}) "
            f"{self.n(it.dest)} <= {self.n(it.mem)}_ram{it.bank}"
            f"[{self.x(it.addr)}];{self.loc_of(it)}"
        )

    def emit_mem_write(self, it: MemWrite, out, decls) -> None:
        out.append(
            f"{self.clocked()} if ({self.x(it.en)}) "
            f"{self.n(it.mem)}_ram{it.bank}[{self.x(it.addr)}] <= "
            f"{self.x(it.data)};{self.loc_of(it)}"
        )

    def emit_controller(self, it: LoopController, out, decls) -> None:
        iv, act, itr = self.n(it.iv), self.n(it.active), self.n(it.iter_net)
        endp = self.n(it.endp) if it.endp else ""
        clk = self.clocked()
        start = self.x(it.start)
        step_up = f"{iv} + {self.x(it.step)}"
        more = f"({step_up} < {self.x(it.ub)})"
        if it.ii is not None:
            ii = it.ii
            iicnt = self.n(it.iicnt) if it.iicnt else ""
            cond_next = f"{iicnt} == {ii - 1}" if ii > 1 else "1'b1"
            out.append(f"// controller: hir.for %{iv} II={ii} {it.loc}")
            out.append(
                f"assign {itr} = {start} | ({act} && ({cond_next}) && {more});")
            out.append(f"{clk} begin")
            if ii > 1:
                out.append(f"  if (rst) begin {act} <= 0; {iicnt} <= 0; end")
            else:
                out.append(f"  if (rst) {act} <= 0;")
            out.append(f"  else if ({start}) begin")
            init_cnt = f" {iicnt} <= 0;" if ii > 1 else ""
            out.append(f"    {act} <= 1; {iv} <= {self.x(it.lb)};{init_cnt}")
            out.append(f"  end else if ({act}) begin")
            if ii > 1:
                out.append(f"    {iicnt} <= ({cond_next}) ? 0 : {iicnt} + 1;")
            out.append(f"    if ({cond_next}) begin")
            out.append(f"      if ({more}) {iv} <= {step_up};")
            out.append(f"      else {act} <= 0;")
            out.append("    end")
            out.append("  end")
            out.append("end")
            if endp:
                out.append(
                    f"{clk} {endp} <= "
                    f"{act} && ({cond_next}) && ({step_up} >= {self.x(it.ub)});")
        else:
            inner = self.x(it.inner_end)
            out.append(f"// controller: sequential hir.for %{iv} {it.loc}")
            out.append(
                f"assign {itr} = {start} | (({inner}) && {act} && {more});")
            out.append(f"{clk} begin")
            out.append(f"  if (rst) {act} <= 0;")
            out.append(f"  else if ({start}) begin {act} <= 1; "
                       f"{iv} <= {self.x(it.lb)}; end")
            out.append(f"  else if (({inner}) && {act}) begin")
            out.append(f"    if ({more}) {iv} <= {step_up};")
            out.append(f"    else {act} <= 0;")
            out.append("  end")
            out.append("end")
            if endp:
                out.append(
                    f"{clk} {endp} <= ({inner}) && {act} && "
                    f"({step_up} >= {self.x(it.ub)});")

    def emit_instance(self, it: Instance, out, decls) -> None:
        if it.share:
            out.append(f"// time-shared x{1 + len(it.share)}: absorbs "
                       f"{', '.join(self.n(s) for s in it.share)}")
        conns = ", ".join(
            f".{self.callee_port_name(it.module, p)}({self.x(e)})"
            for p, e, _o in it.conns)
        out.append(f"{self.mod(it.module)} {self.n(it.inst)} "
                   f"({conns});{self.loc_of(it)}")

    def emit_assert(self, it: PortConflictAssert, out, decls) -> None:
        out.append("`ifndef SYNTHESIS")
        cond = " + ".join(f"(({self.x(e)}) ? 1 : 0)" for e in it.ens)
        out.append(
            f"always @(posedge clk) if (({cond}) > 1) "
            f'$error("port conflict on {self.n(it.bus)} (UB 4.5)");'
        )
        out.append("`endif")

    def assemble(self, m: RTLModule, decls, lines) -> str:
        hdr = f"// generated by repro.core.codegen from @{m.source_func} ({m.loc})\n"
        ports = ",\n    ".join(self.port_decl(p) for p in m.ports)
        hdr += f"module {self.mod(m.name)} (\n    {ports}\n);\n"
        all_decls = [self.decl_net(n) for n in m.nets.values()] + decls
        body = "\n".join("  " + l for l in all_decls + [""] + lines)
        return hdr + body + "\nendmodule\n"


# ---------------------------------------------------------------------------
# SystemVerilog
# ---------------------------------------------------------------------------


class SystemVerilogPrinter(VerilogPrinter):
    """SystemVerilog: every net is ``logic``, clocked blocks are
    ``always_ff``, each loop-controller FSM gets a typed enum state and the
    §4.5 UB guards become SV immediate assertions."""

    name = "systemverilog"
    file_ext = ".sv"
    RESERVED = SYSTEMVERILOG_KEYWORDS

    def decl_net(self, net: Net) -> str:
        sgn = " signed" if net.signed else ""
        rng = f" [{net.width - 1}:0]" if net.width > 1 else ""
        c = f" // {net.comment}" if net.comment else ""
        return f"logic{sgn}{rng} {self.n(net.name)};{c}"

    def port_decl(self, p) -> str:
        rng = f" [{p.width - 1}:0]" if p.width > 1 else ""
        return f"{p.dir} logic{rng} {self.n(p.name)}"

    def reg_kw(self) -> str:
        return "logic"

    def clocked(self) -> str:
        return "always_ff @(posedge clk)"

    def emit_controller(self, it: LoopController, out, decls) -> None:
        iv, act, itr = self.n(it.iv), self.n(it.active), self.n(it.iter_net)
        endp = self.n(it.endp) if it.endp else ""
        p = self.sanitize(it.prefix) or "loop"
        st, ste = f"{p}_state", f"{p}_state_t"
        idle, run = f"{p.upper()}_IDLE", f"{p.upper()}_RUN"
        decls.append(f"typedef enum logic [0:0] {{{idle}, {run}}} {ste};")
        decls.append(f"{ste} {st};")
        start = self.x(it.start)
        step_up = f"{iv} + {self.x(it.step)}"
        more = f"({step_up} < {self.x(it.ub)})"
        out.append(f"assign {act} = ({st} == {run});")
        if it.ii is not None:
            ii = it.ii
            iicnt = self.n(it.iicnt) if it.iicnt else ""
            cond_next = f"{iicnt} == {ii - 1}" if ii > 1 else "1'b1"
            out.append(f"// controller: hir.for %{iv} II={ii} {it.loc}")
            out.append(
                f"assign {itr} = {start} | ({act} && ({cond_next}) && {more});")
            out.append("always_ff @(posedge clk) begin")
            if ii > 1:
                out.append(f"  if (rst) begin {st} <= {idle}; {iicnt} <= 0; end")
            else:
                out.append(f"  if (rst) {st} <= {idle};")
            out.append(f"  else if ({start}) begin")
            init_cnt = f" {iicnt} <= 0;" if ii > 1 else ""
            out.append(f"    {st} <= {run}; {iv} <= {self.x(it.lb)};{init_cnt}")
            out.append(f"  end else if ({st} == {run}) begin")
            if ii > 1:
                out.append(f"    {iicnt} <= ({cond_next}) ? 0 : {iicnt} + 1;")
            out.append(f"    if ({cond_next}) begin")
            out.append(f"      if ({more}) {iv} <= {step_up};")
            out.append(f"      else {st} <= {idle};")
            out.append("    end")
            out.append("  end")
            out.append("end")
            if endp:
                out.append(
                    f"always_ff @(posedge clk) {endp} <= "
                    f"{act} && ({cond_next}) && ({step_up} >= {self.x(it.ub)});")
        else:
            inner = self.x(it.inner_end)
            out.append(f"// controller: sequential hir.for %{iv} {it.loc}")
            out.append(
                f"assign {itr} = {start} | (({inner}) && {act} && {more});")
            out.append("always_ff @(posedge clk) begin")
            out.append(f"  if (rst) {st} <= {idle};")
            out.append(f"  else if ({start}) begin {st} <= {run}; "
                       f"{iv} <= {self.x(it.lb)}; end")
            out.append(f"  else if (({inner}) && {act}) begin")
            out.append(f"    if ({more}) {iv} <= {step_up};")
            out.append(f"    else {st} <= {idle};")
            out.append("  end")
            out.append("end")
            if endp:
                out.append(
                    f"always_ff @(posedge clk) {endp} <= ({inner}) && {act} && "
                    f"({step_up} >= {self.x(it.ub)});")

    def emit_assert(self, it: PortConflictAssert, out, decls) -> None:
        cond = " + ".join(f"(({self.x(e)}) ? 1 : 0)" for e in it.ens)
        out.append("`ifndef SYNTHESIS")
        out.append(
            f"always @(posedge clk) assert (({cond}) <= 1) "
            f'else $error("port conflict on {self.n(it.bus)} (UB 4.5)");'
        )
        out.append("`endif")


# ---------------------------------------------------------------------------
# VHDL
# ---------------------------------------------------------------------------


class VHDLPrinter(NetlistPrinter):
    """VHDL-2008: one entity/architecture pair per module, ``numeric_std``
    arithmetic.  Typing rule: 1-bit nets are ``std_logic``, wider nets are
    ``unsigned``; three helper functions (``b2sl``/``u1``/``b2i``) bridge the
    boolean/std_logic/unsigned worlds.  Expressions that VHDL cannot nest
    (muxes below an assignment's top level, replications) are hoisted onto
    printer-local auxiliary signals — the RTL IR itself is never mutated."""

    name = "vhdl"
    file_ext = ".vhd"
    comment_lead = "--"
    RESERVED = VHDL_KEYWORDS
    case_sensitive = False

    HELPERS = [
        "function b2sl(b : boolean) return std_logic is",
        "begin",
        "  if b then return '1'; end if;",
        "  return '0';",
        "end function;",
        "function u1(s : std_logic) return unsigned is",
        "begin",
        "  if s = '1' then return to_unsigned(1, 1); end if;",
        "  return to_unsigned(0, 1);",
        "end function;",
        "function b2i(s : std_logic) return natural is",
        "begin",
        "  if s = '1' then return 1; end if;",
        "  return 0;",
        "end function;",
    ]

    def sanitize(self, nm: str) -> str:
        s = re.sub(r"[^A-Za-z0-9_]", "_", nm) or "n"
        s = re.sub(r"_+", "_", s).strip("_") or "n"
        if s[0].isdigit():
            s = "n" + s
        return s

    def reset(self) -> None:
        self._aux: list[str] = []
        self._auxdecl: list[str] = []
        self._auxn = 0
        self._ramstyle_declared = False

    def ty(self, w: Optional[int]) -> str:
        if w is None or w <= 1:
            return "std_logic"
        return f"unsigned({w - 1} downto 0)"

    def fresh_aux(self, w: int) -> str:
        self._auxn += 1
        nm = f"vhx{self._auxn}"
        while self.width_of(nm) is not None:
            self._auxn += 1
            nm = f"vhx{self._auxn}"
        self._auxdecl.append(f"signal {nm} : {self.ty(w)};")
        return nm

    # -- expression typing ---------------------------------------------------
    # vx(e) -> (text, kind, width); kind in {"sl","u","s","int","bool"}
    _VCMP = {"<": "<", "<=": "<=", "==": "=", "!=": "/=", ">": ">", ">=": ">="}

    def vx(self, e: Expr) -> tuple[str, str, Optional[int]]:
        if isinstance(e, Const):
            if e.width is None or not isinstance(e.value, int):
                return str(e.value), "int", None
            if e.width == 1:
                return ("'1'" if int(e.value) & 1 else "'0'"), "sl", 1
            if e.signed and e.value < 0:
                return f"to_signed({e.value}, {e.width})", "s", e.width
            return f"to_unsigned({e.value}, {e.width})", "u", e.width
        if isinstance(e, Ref):
            w = self.width_of(e.name)
            if w == 1:
                return self.n(e.name), "sl", 1
            return self.n(e.name), "u", w
        if isinstance(e, Signed):
            t, k, w = self.vx(e.a)
            if k == "u":
                return f"signed({t})", "s", w
            if k == "sl":
                return f"signed(u1({t}))", "s", 1
            return t, k, w
        if isinstance(e, Unop):
            if e.op == "~":
                t, k, w = self.vx(e.a)
                if k in ("sl", "bool"):
                    return f"(not {self.as_sl(e.a)})", "sl", 1
                return f"(not {t})", k, w
            t, k, w = self.vx(e.a)
            return f"{e.op}({t})", k, w
        if isinstance(e, Binop):
            return self.vx_binop(e)
        if isinstance(e, Mux):
            return self.hoist_mux(e)
        if isinstance(e, Repeat):
            if isinstance(e.a, Const) and e.a.value == 0:
                if e.n == 1:
                    return "'0'", "sl", 1
                return f"to_unsigned(0, {e.n})", "u", e.n
            return self.hoist_repeat(e)
        raise NotImplementedError(type(e).__name__)

    # kind coercion on already-printed triples
    @staticmethod
    def _num(tkw) -> tuple[str, str, Optional[int]]:
        t, k, w = tkw
        if k == "sl":
            return f"u1({t})", "u", 1
        if k == "bool":
            return f"u1(b2sl({t}))", "u", 1
        return t, k, w

    @staticmethod
    def _pair(a, b):
        """Make a numeric pair type-compatible (signed wins)."""
        if a[1] == "s" and b[1] == "u":
            b = (f"signed({b[0]})", "s", b[2])
        elif b[1] == "s" and a[1] == "u":
            a = (f"signed({a[0]})", "s", a[2])
        return a, b

    def as_sl(self, e: Expr) -> str:
        t, k, w = self.vx(e)
        if k == "sl":
            return t
        if k == "bool":
            return f"b2sl({t})"
        if k == "int":
            return "'0'" if t in ("0", "-0") else "'1'"
        if w == 1:
            return f"{t}(0)"
        return f"b2sl({t} /= 0)"

    def as_bool(self, e: Expr) -> str:
        t, k, _w = self.vx(e)
        if k == "bool":
            return t
        if k == "sl":
            return f"({t} = '1')"
        if k == "int":
            return "false" if t in ("0", "-0") else "true"
        return f"({t} /= 0)"

    def as_num(self, e: Expr) -> str:
        return self._num(self.vx(e))[0]

    def as_assign(self, e: Expr, dw: Optional[int]) -> str:
        """RHS text for assignment into a destination of width ``dw``."""
        if dw == 1:
            return self.as_sl(e)
        t, k, w = self.vx(e)
        if dw is None:
            return self._num((t, k, w))[0]
        if k == "int":
            if t.lstrip("-").isdigit() and t.startswith("-"):
                return f"unsigned(to_signed({t}, {dw}))"
            return f"to_unsigned({t}, {dw})"
        if k == "sl":
            return f"resize(u1({t}), {dw})"
        if k == "bool":
            return f"resize(u1(b2sl({t})), {dw})"
        if k == "s":
            return f"unsigned(resize({t}, {dw}))"
        if w == dw:
            return t
        return f"resize({t}, {dw})"

    def vx_binop(self, e: Binop) -> tuple[str, str, Optional[int]]:
        op = e.op
        if op in self._VCMP:
            A, B = self.vx(e.a), self.vx(e.b)
            if A[1] == "sl" and B[1] == "sl" and op in ("==", "!="):
                return f"({A[0]} {'=' if op == '==' else '/='} {B[0]})", "bool", 1
            A, B = self._pair(self._num(A), self._num(B))
            return f"({A[0]} {self._VCMP[op]} {B[0]})", "bool", 1
        if op in ("&&", "||"):
            vop = "and" if op == "&&" else "or"
            return f"({self.as_bool(e.a)} {vop} {self.as_bool(e.b)})", "bool", 1
        if op in ("&", "|", "^"):
            vop = {"&": "and", "|": "or", "^": "xor"}[op]
            wa = self.expr_width(e.a) or 1
            wb = self.expr_width(e.b) or 1
            if wa == 1 and wb == 1:
                return f"({self.as_sl(e.a)} {vop} {self.as_sl(e.b)})", "sl", 1
            w = max(wa, wb)
            return (f"({self.as_assign(e.a, w)} {vop} {self.as_assign(e.b, w)})",
                    "u", w)
        if op in ("+", "-", "*", "/"):
            A, B = self._pair(self._num(self.vx(e.a)), self._num(self.vx(e.b)))
            if A[1] == "int" and B[1] == "int":
                kind: str = "int"
            else:
                kind = "s" if "s" in (A[1], B[1]) else "u"
            ws = [w for w in (A[2], B[2]) if w]
            if op == "*":
                w = (A[2] + B[2]) if (A[2] and B[2]) else None
            elif op == "/":
                w = A[2]
            else:
                w = max(ws) if ws else None
            return f"({A[0]} {op} {B[0]})", kind, w
        if op in ("<<", ">>"):
            A = self._num(self.vx(e.a))
            if A[1] == "int":
                A = (f"to_unsigned({A[0]}, 32)", "u", 32)
            if isinstance(e.b, Const) and isinstance(e.b.value, int):
                amt = str(e.b.value)
            else:
                amt = f"to_integer({self.as_num(e.b)})"
            fn = "shift_left" if op == "<<" else "shift_right"
            return f"{fn}({A[0]}, {amt})", A[1], A[2]
        raise NotImplementedError(op)

    def hoist_mux(self, e: Mux) -> tuple[str, str, Optional[int]]:
        w = self.expr_width(e) or 1
        nm = self.fresh_aux(w)
        self._aux.append(self.cond_assign(nm, e, w))
        return nm, ("sl" if w == 1 else "u"), w

    def hoist_repeat(self, e: Repeat) -> tuple[str, str, Optional[int]]:
        wa = self.expr_width(e.a) or 1
        w = e.n * wa
        nm = self.fresh_aux(w)
        if wa == 1:
            self._aux.append(f"{nm} <= (others => {self.as_sl(e.a)});")
        else:
            t = self.as_num(e.a)
            self._aux.append(f"{nm} <= {' & '.join([t] * e.n)};")
        return nm, ("sl" if w == 1 else "u"), w

    def cond_assign(self, dest: str, e: Expr, dw: Optional[int],
                    loc: str = "") -> str:
        """A (possibly conditional) signal assignment; top-level muxes become
        chained ``when/else`` clauses."""
        if isinstance(e, Mux):
            parts = []
            cur: Expr = e
            while isinstance(cur, Mux):
                parts.append((self.as_bool(cur.cond), self.as_assign(cur.a, dw)))
                cur = cur.b
            tail = self.as_assign(cur, dw)
            rhs = " else ".join(f"{v} when {c}" for c, v in parts)
            return f"{dest} <= {rhs} else {tail};{loc}"
        return f"{dest} <= {self.as_assign(e, dw)};{loc}"

    def vidx(self, e: Expr) -> str:
        if isinstance(e, Const) and isinstance(e.value, int):
            return str(e.value)
        return f"to_integer({self.as_num(e)})"

    # -- items ---------------------------------------------------------------
    def emit_comb(self, it: CombAssign, out, decls) -> None:
        dw = self.width_of(it.dest) or self.expr_width(it.expr) or 1
        out.append(self.cond_assign(self.n(it.dest), it.expr, dw,
                                    self.loc_of(it)))

    def emit_shift_reg(self, it: ShiftReg, out, decls) -> None:
        nm, d, w = self.n(it.dest), it.depth, it.width
        loc = self.loc_of(it)
        zero = "'0'" if w == 1 else "(others => '0')"
        src = self.as_assign(it.src, w)
        if d == 1:
            q = f"{nm}_q"
            decls.append(f"signal {q} : {self.ty(w)};")
            out.append(f"process(clk) begin{loc}")
            if it.reset_zero:
                out.append(f"  if rising_edge(clk) then if rst = '1' then "
                           f"{q} <= {zero}; else {q} <= {src}; end if; end if;")
            else:
                out.append(f"  if rising_edge(clk) then {q} <= {src}; end if;")
            out.append("end process;")
            out.append(f"{nm} <= {q};")
            return
        t, s = f"{nm}_sr_t", f"{nm}_sr"
        decls.append(f"type {t} is array (0 to {d - 1}) of {self.ty(w)};")
        decls.append(f"signal {s} : {t};")
        out.append(f"process(clk) begin{loc}")
        out.append("  if rising_edge(clk) then")
        if it.reset_zero:
            out.append(f"    if rst = '1' then {s}(0) <= {zero}; "
                       f"else {s}(0) <= {src}; end if;")
        else:
            out.append(f"    {s}(0) <= {src};")
        for i in range(1, d):
            if it.reset_zero:
                out.append(f"    if rst = '1' then {s}({i}) <= {zero}; "
                           f"else {s}({i}) <= {s}({i - 1}); end if;")
            else:
                out.append(f"    {s}({i}) <= {s}({i - 1});")
        out.append("  end if;")
        out.append("end process;")
        out.append(f"{nm} <= {s}({d - 1});")

    def emit_reg_assign(self, it: RegAssign, out, decls) -> None:
        d = self.n(it.dest)
        w = self.width_of(it.dest)
        src = self.as_assign(it.src, w)
        out.append(f"process(clk) begin{self.loc_of(it)}")
        if it.en is not None:
            out.append(f"  if rising_edge(clk) then if {self.as_bool(it.en)} "
                       f"then {d} <= {src}; end if; end if;")
        else:
            out.append(f"  if rising_edge(clk) then {d} <= {src}; end if;")
        out.append("end process;")

    def emit_memory(self, it: Memory, out, decls) -> None:
        style = "block" if it.kind == "bram" else "distributed"
        if not self._ramstyle_declared:
            decls.append("attribute ram_style : string;")
            self._ramstyle_declared = True
        base = self.n(it.name)
        et = self.ty(it.width)
        for bk in range(it.banks):
            rn = f"{base}_ram{bk}"
            decls.append(f"type {rn}_t is array (0 to {max(it.depth - 1, 1)}) "
                         f"of {et};")
            decls.append(f"signal {rn} : {rn}_t;")
            decls.append(f'attribute ram_style of {rn} : signal is "{style}";')

    def emit_mem_read(self, it: MemRead, out, decls) -> None:
        rn = f"{self.n(it.mem)}_ram{it.bank}"
        out.append(f"process(clk) begin{self.loc_of(it)}")
        out.append(f"  if rising_edge(clk) then if {self.as_bool(it.en)} then "
                   f"{self.n(it.dest)} <= {rn}({self.vidx(it.addr)}); "
                   f"end if; end if;")
        out.append("end process;")

    def emit_mem_write(self, it: MemWrite, out, decls) -> None:
        rn = f"{self.n(it.mem)}_ram{it.bank}"
        w = it.data and self.expr_width(it.data)
        mem = next((m for m in self.m.items
                    if isinstance(m, Memory) and m.name == it.mem), None)
        dw = mem.width if mem is not None else w
        out.append(f"process(clk) begin{self.loc_of(it)}")
        out.append(f"  if rising_edge(clk) then if {self.as_bool(it.en)} then "
                   f"{rn}({self.vidx(it.addr)}) <= "
                   f"{self.as_assign(it.data, dw)}; end if; end if;")
        out.append("end process;")

    def emit_controller(self, it: LoopController, out, decls) -> None:
        iv, act, itr = self.n(it.iv), self.n(it.active), self.n(it.iter_net)
        endp = self.n(it.endp) if it.endp else ""
        w = it.ivw
        start_b = self.as_bool(it.start)
        lb = self.as_assign(it.lb, w)
        ivn = iv if w > 1 else f"u1({iv})"  # 1-bit IVs are std_logic
        su = f"({ivn} + {self.as_num(it.step)})"
        ub = self.as_num(it.ub)
        more = f"({su} < {ub})"
        ivnext = f"resize({su}, {w})" if w > 1 else f"resize({su}, 1)(0)"
        if it.ii is not None:
            ii = it.ii
            cnt = self.n(it.iicnt) if it.iicnt else ""
            cw = self.width_of(it.iicnt) if it.iicnt else 1
            if ii > 1:
                # a 1-bit counter is std_logic (ii == 2): compare with '1'
                cond = (f"({cnt} = {ii - 1})" if cw and cw > 1
                        else f"({cnt} = '1')")
            else:
                cond = "true"
            out.append(f"-- controller: hir.for {iv} II={ii} {it.loc}")
            out.append(f"{itr} <= b2sl(({start_b}) or (({act} = '1') and "
                       f"({cond}) and {more}));")
            out.append("process(clk) begin")
            out.append("  if rising_edge(clk) then")
            czero = f"to_unsigned(0, {cw})" if cw and cw > 1 else "'0'"
            if ii > 1:
                out.append(f"    if rst = '1' then {act} <= '0'; "
                           f"{cnt} <= {czero};")
            else:
                out.append(f"    if rst = '1' then {act} <= '0';")
            out.append(f"    elsif {start_b} then")
            extra = f" {cnt} <= {czero};" if ii > 1 else ""
            out.append(f"      {act} <= '1'; {iv} <= {lb};{extra}")
            out.append(f"    elsif {act} = '1' then")
            if ii > 1:
                if cw and cw > 1:
                    bump = f"resize({cnt} + 1, {cw})"
                else:
                    bump = f"not {cnt}"
                out.append(f"      if {cond} then {cnt} <= {czero}; "
                           f"else {cnt} <= {bump}; end if;")
            out.append(f"      if {cond} then")
            out.append(f"        if {more} then {iv} <= {ivnext}; "
                       f"else {act} <= '0'; end if;")
            out.append("      end if;")
            out.append("    end if;")
            out.append("  end if;")
            out.append("end process;")
            if endp:
                out.append("process(clk) begin")
                out.append(f"  if rising_edge(clk) then {endp} <= "
                           f"b2sl(({act} = '1') and ({cond}) and "
                           f"({su} >= {ub})); end if;")
                out.append("end process;")
        else:
            inner = self.as_bool(it.inner_end)
            out.append(f"-- controller: sequential hir.for {iv} {it.loc}")
            out.append(f"{itr} <= b2sl(({start_b}) or (({inner}) and "
                       f"({act} = '1') and {more}));")
            out.append("process(clk) begin")
            out.append("  if rising_edge(clk) then")
            out.append(f"    if rst = '1' then {act} <= '0';")
            out.append(f"    elsif {start_b} then {act} <= '1'; {iv} <= {lb};")
            out.append(f"    elsif ({inner}) and {act} = '1' then")
            out.append(f"      if {more} then {iv} <= {ivnext}; "
                       f"else {act} <= '0'; end if;")
            out.append("    end if;")
            out.append("  end if;")
            out.append("end process;")
            if endp:
                out.append("process(clk) begin")
                out.append(f"  if rising_edge(clk) then {endp} <= "
                           f"b2sl(({inner}) and ({act} = '1') and "
                           f"({su} >= {ub})); end if;")
                out.append("end process;")

    def emit_instance(self, it: Instance, out, decls) -> None:
        callee = (self._design.modules.get(it.module)
                  if self._design is not None else None)
        pw = {p.name: p.width for p in callee.ports} if callee else {}
        maps = []
        for pname, e, is_out in it.conns:
            formal = self.callee_port_name(it.module, pname)
            w = pw.get(pname) or self.expr_width(e) or 1
            if isinstance(e, Ref):
                actual = self.n(e.name)
            elif isinstance(e, Const) and w == 1:
                actual = "'1'" if int(e.value or 0) & 1 else "'0'"
            else:
                nm = self.fresh_aux(w)
                self._aux.append(self.cond_assign(nm, e, w))
                actual = nm
            maps.append(f"{formal} => {actual}")
        if it.share:
            out.append(f"-- time-shared x{1 + len(it.share)}: absorbs "
                       f"{', '.join(self.n(s) for s in it.share)}")
        out.append(f"{self.n(it.inst)} : entity work.{self.mod(it.module)}"
                   f" port map ({', '.join(maps)});{self.loc_of(it)}")

    def emit_assert(self, it: PortConflictAssert, out, decls) -> None:
        cnt = " + ".join(f"b2i({self.as_sl(e)})" for e in it.ens)
        out.append("-- pragma translate_off")
        out.append("process(clk) begin")
        out.append("  if rising_edge(clk) then")
        out.append(f'    assert ({cnt}) <= 1 report "port conflict on '
                   f'{self.n(it.bus)} (UB 4.5)" severity error;')
        out.append("  end if;")
        out.append("end process;")
        out.append("-- pragma translate_on")

    def assemble(self, m: RTLModule, decls, lines) -> str:
        name = self.mod(m.name)
        out = [f"-- generated by repro.core.codegen from @{m.source_func} "
               f"({m.loc})",
               "library ieee;",
               "use ieee.std_logic_1164.all;",
               "use ieee.numeric_std.all;",
               "",
               f"entity {name} is"]
        if m.ports:
            out.append("  port (")
            pl = [f"    {self.n(p.name)} : "
                  f"{'in' if p.dir == 'input' else 'out'} {self.ty(p.width)}"
                  for p in m.ports]
            out.append(";\n".join(pl))
            out.append("  );")
        out.append(f"end entity {name};")
        out.append("")
        out.append(f"architecture rtl of {name} is")
        out.extend("  " + h for h in self.HELPERS)
        for net in m.nets.values():
            c = f" -- {net.comment}" if net.comment else ""
            out.append(f"  signal {self.n(net.name)} : {self.ty(net.width)};{c}")
        out.extend("  " + d for d in decls + self._auxdecl)
        out.append("begin")
        out.extend("  " + l for l in lines + self._aux)
        out.append("end architecture rtl;")
        out.append("")
        return "\n".join(out)


# ---------------------------------------------------------------------------
# CIRCT hw/comb/seq textual MLIR
# ---------------------------------------------------------------------------


class CIRCTPrinter(NetlistPrinter):
    """CIRCT-style textual MLIR over the ``hw``/``comb``/``seq`` dialects.
    One ``hw.module`` per RTLModule (graph region, so forward references are
    fine), nets become named SSA values, clocked items become
    ``seq.compreg``/``seq.firmem`` ops and each loop-controller FSM is
    expanded into explicit comb next-state logic + state registers.  Printer
    temporaries use a ``_t``/``_c`` prefix, so net names never collide with
    them (``sanitize`` strips leading underscores)."""

    name = "circt"
    file_ext = ".mlir"
    RESERVED = frozenset()

    def sanitize(self, nm: str) -> str:
        s = re.sub(r"[^A-Za-z0-9_]", "_", nm) or "n"
        if s.startswith("_"):
            s = "n" + s.lstrip("_")
        return s

    def reset(self) -> None:
        self._tmp = 0
        self._consts: dict[tuple, str] = {}
        self._outvals: dict[str, str] = {}
        self._reggroups: dict[str, list[RegAssign]] = {}
        self._regdone: set[str] = set()
        self._written: set[str] = set()
        for it in self.m.items:
            if isinstance(it, RegAssign):
                self._reggroups.setdefault(it.dest, []).append(it)
            self._written.update(it.writes())

    # -- SSA helpers ---------------------------------------------------------
    def tmp(self) -> str:
        self._tmp += 1
        return f"%_t{self._tmp}"

    def emit_op(self, text: str, out: list[str]) -> str:
        nm = self.tmp()
        out.append(f"{nm} = {text}")
        return nm

    def kconst(self, v: int, w: int, out: list[str]) -> str:
        key = (v, w)
        got = self._consts.get(key)
        if got is not None:
            return got
        nm = f"%_c{len(self._consts)}"
        out.append(f"{nm} = hw.constant {v} : i{w}")
        self._consts[key] = nm
        return nm

    def fit(self, ssa: str, w: int, tow: int, out: list[str],
            signed: bool = False) -> str:
        if w == tow:
            return ssa
        if w < tow:
            if signed:
                msb = self.emit_op(
                    f"comb.extract {ssa} from {w - 1} : (i{w}) -> i1", out)
                ext = self.emit_op(
                    f"comb.replicate {msb} : (i1) -> i{tow - w}", out)
            else:
                ext = self.kconst(0, tow - w, out)
            return self.emit_op(
                f"comb.concat {ext}, {ssa} : i{tow - w}, i{w}", out)
        return self.emit_op(
            f"comb.extract {ssa} from 0 : (i{w}) -> i{tow}", out)

    def c1(self, e: Expr, out: list[str]) -> str:
        v, w = self.cval(e, out, 1)
        if w == 1:
            return v
        z = self.kconst(0, w, out)
        return self.emit_op(f"comb.icmp ne {v}, {z} : i{w}", out)

    def cmux(self, c: str, a: str, b: str, w: int, out: list[str]) -> str:
        return self.emit_op(f"comb.mux {c}, {a}, {b} : i{w}", out)

    # -- expressions ---------------------------------------------------------
    def cval(self, e: Expr, out: list[str],
             ctxw: Optional[int] = None) -> tuple[str, int]:
        if isinstance(e, Const):
            w = e.width or ctxw or 32
            v = int(e.value) if isinstance(e.value, (int, bool)) else 0
            return self.kconst(v, w, out), w
        if isinstance(e, Ref):
            return f"%{self.n(e.name)}", self.width_of(e.name) or ctxw or 1
        if isinstance(e, Signed):
            return self.cval(e.a, out, ctxw)
        if isinstance(e, Unop):
            a, w = self.cval(e.a, out, ctxw)
            ones = self.kconst(-1, w, out)
            return self.emit_op(f"comb.xor {a}, {ones} : i{w}", out), w
        if isinstance(e, Binop):
            return self.cbinop(e, out, ctxw)
        if isinstance(e, Mux):
            a, wa = self.cval(e.a, out, ctxw)
            b, wb = self.cval(e.b, out, wa)
            w = max(wa, wb)
            a, b = self.fit(a, wa, w, out), self.fit(b, wb, w, out)
            c = self.c1(e.cond, out)
            return self.cmux(c, a, b, w, out), w
        if isinstance(e, Repeat):
            a, wa = self.cval(e.a, out)
            return self.emit_op(
                f"comb.replicate {a} : (i{wa}) -> i{e.n * wa}", out), e.n * wa
        raise NotImplementedError(type(e).__name__)

    _ICMP = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge",
             "==": "eq", "!=": "ne"}

    def cbinop(self, e: Binop, out: list[str],
               ctxw: Optional[int]) -> tuple[str, int]:
        op = e.op
        if op in ("&&", "||"):
            a, b = self.c1(e.a, out), self.c1(e.b, out)
            mnem = "and" if op == "&&" else "or"
            return self.emit_op(f"comb.{mnem} {a}, {b} : i1", out), 1
        # Verilog rule: the operation is signed only when *all* operands are
        # signed; signed ops then widen by sign extension
        def _sgn(x):
            return isinstance(x, Signed) or (isinstance(x, Const) and x.signed)
        sgn = _sgn(e.a) and _sgn(e.b)
        a, wa = self.cval(e.a, out, ctxw)
        b, wb = self.cval(e.b, out, wa or ctxw)
        w = max(wa, wb)
        a = self.fit(a, wa, w, out, signed=sgn)
        b = self.fit(b, wb, w, out, signed=sgn)
        if op in self._ICMP:
            pred = self._ICMP[op]
            if pred not in ("eq", "ne"):
                pred = ("s" if sgn else "u") + pred
            return self.emit_op(f"comb.icmp {pred} {a}, {b} : i{w}", out), 1
        if op == "/":
            mnem = "divs" if sgn else "divu"
        elif op == ">>":
            mnem = "shrs" if sgn else "shru"
        else:
            mnem = {"+": "add", "-": "sub", "*": "mul", "&": "and",
                    "|": "or", "^": "xor", "<<": "shl"}[op]
        return self.emit_op(f"comb.{mnem} {a}, {b} : i{w}", out), w

    # -- items ---------------------------------------------------------------
    def emit_comb(self, it: CombAssign, out, decls) -> None:
        dw = self.width_of(it.dest)
        v, w = self.cval(it.expr, out, dw)
        if dw:
            v = self.fit(v, w, dw, out)
            w = dw
        d = self.n(it.dest)
        out.append(f"%{d} = hw.wire {v} : i{w}{self.loc_of(it)}")
        if it.dest in self.m.output_ports():
            self._outvals[it.dest] = f"%{d}"

    def emit_shift_reg(self, it: ShiftReg, out, decls) -> None:
        w = it.width
        v, w0 = self.cval(it.src, out, w)
        v = self.fit(v, w0, w, out)
        rst = ""
        if it.reset_zero:
            z = self.kconst(0, w, out)
            rst = f" reset %rst, {z}"
        for s in range(it.depth):
            if s == it.depth - 1:
                nm = f"%{self.n(it.dest)}"
                out.append(f"{nm} = seq.compreg {v}, %clk{rst} : "
                           f"i{w}{self.loc_of(it)}")
            else:
                nm = self.emit_op(f"seq.compreg {v}, %clk{rst} : i{w}", out)
            v = nm

    def emit_reg_assign(self, it: RegAssign, out, decls) -> None:
        if it.dest in self._regdone:
            return
        self._regdone.add(it.dest)
        group = self._reggroups[it.dest]
        w = self.width_of(it.dest) or 32
        d = f"%{self.n(it.dest)}"
        if len(group) == 1 and group[0].en is None:
            v, w0 = self.cval(group[0].src, out, w)
            v = self.fit(v, w0, w, out)
            out.append(f"{d} = seq.compreg {v}, %clk : i{w}{self.loc_of(it)}")
            return
        if len(group) == 1:
            g = group[0]
            v, w0 = self.cval(g.src, out, w)
            v = self.fit(v, w0, w, out)
            en = self.c1(g.en, out)
            out.append(f"{d} = seq.compreg.ce {v}, %clk, {en} : "
                       f"i{w}{self.loc_of(it)}")
            return
        # several §4.5-exclusive writers: one register, a mux chain for the
        # next value (hold when no enable fires)
        acc = d
        for g in reversed(group):
            v, w0 = self.cval(g.src, out, w)
            v = self.fit(v, w0, w, out)
            en = self.c1(g.en, out) if g.en is not None else self.kconst(1, 1, out)
            acc = self.cmux(en, v, acc, w, out)
        out.append(f"{d} = seq.compreg {acc}, %clk : i{w}{self.loc_of(it)}")

    def emit_memory(self, it: Memory, out, decls) -> None:
        depth = max(it.depth, 1)
        for bk in range(it.banks):
            out.append(f"%{self.n(it.name)}_ram{bk} = seq.firmem 0, 1, "
                       f"undefined, undefined : <{depth} x {it.width}>"
                       f"{self.loc_of(it)}")

    def _mem_depth_width(self, mem: str) -> tuple[int, int]:
        m = next((i for i in self.m.items
                  if isinstance(i, Memory) and i.name == mem), None)
        if m is None:
            return 1, 32
        return max(m.depth, 1), m.width

    def emit_mem_read(self, it: MemRead, out, decls) -> None:
        depth, w = self._mem_depth_width(it.mem)
        a, _aw = self.cval(it.addr, out)
        en = self.c1(it.en, out)
        out.append(f"%{self.n(it.dest)} = seq.firmem.read_port "
                   f"%{self.n(it.mem)}_ram{it.bank}[{a}], clock %clk "
                   f"enable {en} : <{depth} x {w}>{self.loc_of(it)}")

    def emit_mem_write(self, it: MemWrite, out, decls) -> None:
        depth, w = self._mem_depth_width(it.mem)
        a, _aw = self.cval(it.addr, out)
        v, w0 = self.cval(it.data, out, w)
        v = self.fit(v, w0, w, out)
        en = self.c1(it.en, out)
        out.append(f"seq.firmem.write_port "
                   f"%{self.n(it.mem)}_ram{it.bank}[{a}] = {v}, clock %clk "
                   f"enable {en} : <{depth} x {w}>{self.loc_of(it)}")

    def emit_controller(self, it: LoopController, out, decls) -> None:
        w = it.ivw
        iv = f"%{self.n(it.iv)}"
        act = f"%{self.n(it.active)}"
        tag = f"II={it.ii}" if it.ii is not None else "sequential"
        out.append(f"// controller: hir.for {self.n(it.iv)} {tag} ({it.loc})")
        start = self.c1(it.start, out)
        lb, wlb = self.cval(it.lb, out, w)
        lb = self.fit(lb, wlb, w, out)
        ub, wub = self.cval(it.ub, out, w)
        ub = self.fit(ub, wub, w, out)
        st, wst = self.cval(it.step, out, w)
        st = self.fit(st, wst, w, out)
        su = self.emit_op(f"comb.add {iv}, {st} : i{w}", out)
        more = self.emit_op(f"comb.icmp ult {su}, {ub} : i{w}", out)
        done = self.emit_op(f"comb.icmp uge {su}, {ub} : i{w}", out)
        if it.ii is not None and it.ii > 1:
            cnt = f"%{self.n(it.iicnt)}"
            cw = self.width_of(it.iicnt) or 1
            cm1 = self.kconst(it.ii - 1, cw, out)
            cn = self.emit_op(f"comb.icmp eq {cnt}, {cm1} : i{cw}", out)
        elif it.ii is not None:
            cn = self.kconst(1, 1, out)
        else:
            cn = self.c1(it.inner_end, out)
        live = self.emit_op(f"comb.and {act}, {cn} : i1", out)
        adv = self.emit_op(f"comb.and {live}, {more} : i1", out)
        stop = self.emit_op(f"comb.and {live}, {done} : i1", out)
        out.append(f"%{self.n(it.iter_net)} = comb.or {start}, {adv} : i1")
        one = self.kconst(1, 1, out)
        zero1 = self.kconst(0, 1, out)
        a1 = self.cmux(stop, zero1, act, 1, out)
        a2 = self.cmux(start, one, a1, 1, out)
        out.append(f"{act} = seq.compreg {a2}, %clk reset %rst, {zero1} : i1")
        i1 = self.cmux(adv, su, iv, w, out)
        i2 = self.cmux(start, lb, i1, w, out)
        out.append(f"{iv} = seq.compreg {i2}, %clk : i{w}")
        if it.ii is not None and it.ii > 1:
            cnt = f"%{self.n(it.iicnt)}"
            cw = self.width_of(it.iicnt) or 1
            zc = self.kconst(0, cw, out)
            onec = self.kconst(1, cw, out)
            bump = self.emit_op(f"comb.add {cnt}, {onec} : i{cw}", out)
            cngz = self.cmux(cn, zc, bump, cw, out)
            chold = self.cmux(act, cngz, cnt, cw, out)
            cnext = self.cmux(start, zc, chold, cw, out)
            out.append(f"{cnt} = seq.compreg {cnext}, %clk reset %rst, "
                       f"{zc} : i{cw}")
        if it.endp:
            out.append(f"%{self.n(it.endp)} = seq.compreg {stop}, %clk : i1")

    def emit_instance(self, it: Instance, out, decls) -> None:
        callee = (self._design.modules.get(it.module)
                  if self._design is not None else None)
        pw = {p.name: p.width for p in callee.ports} if callee else {}
        ins: list[tuple[str, str, str]] = []
        outs: list[tuple[str, str, int]] = []
        for pname, e, is_out in it.conns:
            formal = self.callee_port_name(it.module, pname)
            if is_out:
                w = pw.get(pname) or self.width_of(e.name) or 1
                outs.append((formal, f"%{self.n(e.name)}", w))
                continue
            if pname == "clk":
                ins.append((formal, "%clk", "!seq.clock"))
                continue
            v, w = self.cval(e, out, pw.get(pname))
            if pw.get(pname):
                v = self.fit(v, w, pw[pname], out)
                w = pw[pname]
            ins.append((formal, v, f"i{w}"))
        argtxt = ", ".join(f"{p}: {v}: {t}" for p, v, t in ins)
        restxt = ", ".join(f"{p}: i{w}" for p, _v, w in outs)
        lhs = ", ".join(v for _p, v, _w in outs)
        line = f'hw.instance "{self.n(it.inst)}" @{self.mod(it.module)}' \
               f"({argtxt}) -> ({restxt})"
        if lhs:
            line = f"{lhs} = {line}"
        if it.share:
            out.append(f"// time-shared x{1 + len(it.share)}: absorbs "
                       f"{', '.join(self.n(s) for s in it.share)}")
        out.append(line + self.loc_of(it))

    def emit_assert(self, it: PortConflictAssert, out, decls) -> None:
        n = len(it.ens)
        w = max(2, n.bit_length() + 1)
        total = self.kconst(0, w, out)
        for e in it.ens:
            b = self.c1(e, out)
            b = self.fit(b, 1, w, out)
            total = self.emit_op(f"comb.add {total}, {b} : i{w}", out)
        one = self.kconst(1, w, out)
        ok = self.emit_op(f"comb.icmp ule {total}, {one} : i{w}", out)
        out.append(f'verif.assert {ok} label "port conflict on '
                   f'{self.n(it.bus)} (UB 4.5)" : i1')

    def assemble(self, m: RTLModule, decls, lines) -> str:
        name = self.mod(m.name)
        pl = []
        for p in m.ports:
            if p.dir == "input":
                ty = "!seq.clock" if p.name == "clk" else f"i{p.width}"
                pl.append(f"in %{self.n(p.name)} : {ty}")
            else:
                pl.append(f"out {self.n(p.name)} : i{p.width}")
        body = list(lines)
        outs = [p for p in m.ports if p.dir == "output"]
        vals, tys = [], []
        for p in outs:
            v = self._outvals.get(p.name)
            if v is None and p.name in self._written:
                # driven by a clocked item / instance whose result op is
                # already named after the port
                v = f"%{self.n(p.name)}"
            if v is None:
                v = self.kconst(0, p.width, body)  # genuinely undriven
            vals.append(v)
            tys.append(f"i{p.width}")
        final = (f"hw.output {', '.join(vals)} : {', '.join(tys)}"
                 if vals else "hw.output")
        hdr = (f"// generated by repro.core.codegen from @{m.source_func} "
               f"({m.loc})\n")
        return (hdr + f"hw.module @{name}({', '.join(pl)}) {{\n"
                + "\n".join("  " + l for l in body + [final]) + "\n}\n")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

BACKENDS: dict[str, type[NetlistPrinter]] = {
    "verilog": VerilogPrinter,
    "systemverilog": SystemVerilogPrinter,
    "vhdl": VHDLPrinter,
    "circt": CIRCTPrinter,
}


def get_printer(backend: str) -> NetlistPrinter:
    """Instantiate the printer for ``backend`` (one of ``BACKENDS``)."""
    try:
        return BACKENDS[backend]()
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of "
            f"{sorted(BACKENDS)}") from None


# ---------------------------------------------------------------------------
# Parallel per-module emission (PR 8)
# ---------------------------------------------------------------------------


def _walk_ops(m, visit) -> None:
    """Visit every FuncOp/Operation of ``m`` in deterministic print order
    (funcs in module order, ops pre-order through nested regions)."""
    def rec(region):
        for op in region.ops:
            visit(op)
            for r in op.regions:
                rec(r)

    for f in m.funcs.values():
        visit(f)
        if not f.attrs.get("external"):
            rec(f.body)


def _op_values(op) -> list:
    vals = list(op.results)
    for reg in op.regions:
        vals.extend(reg.args)
    return vals


def _module_sidecar(m) -> list:
    """Per-op ``(loc, value-names)`` sidecar, in ``_walk_ops`` order.  The
    HIR printer neither serializes source locations nor preserves raw value
    names (duplicates are legalized ``lj`` -> ``lj_1``, anonymous values
    print as ``v<id>`` with a process-local id), and both feed the RTL
    backends — locs as netlist comments, names through ``FuncLowering``'s
    signal naming.  Parallel-emission payloads carry this sidecar so workers
    reconstruct the parent's exact in-memory module after parsing."""
    out = []

    def visit(op):
        out.append((op.loc, tuple(v.name for v in _op_values(op))))

    _walk_ops(m, visit)
    return out


def _attach_sidecar(m, sidecar) -> None:
    """Re-attach a ``_module_sidecar`` onto a parsed module.  The print/parse
    round trip preserves the op tree exactly, so the same deterministic walk
    pairs ops 1:1 with the sidecar — keeping emitted text byte-identical to
    the serial path."""
    it = iter(sidecar)

    def put(op):
        loc, names = next(it)
        op.loc = loc
        vals = _op_values(op)
        if len(vals) != len(names):  # pragma: no cover - round-trip invariant
            raise RuntimeError(f"sidecar mismatch at {op.opname}")
        for v, nm in zip(vals, names):
            v.name = nm

    _walk_ops(m, put)


def _emit_module_payload(payload) -> tuple:
    """Pool worker: re-lower and print ONE emitted module from printed HIR
    text.  Top-level by necessity (the pool pickles the callable by
    reference); the payload carries text and plain config only — never RTL
    trees, whose interned expression keys (PR 5) are process-local.

    Byte-identity with the serial path holds because (a) ``FuncLowering``'s
    anonymous naming is positional per lowering, (b) the RTL passes are
    strictly per-module, and (c) the design-wide module name map is rebuilt
    from the full ordered name list the parent passes in, so the printer's
    first-come legalization sees the same sequence."""
    (module_text, sidecar, target, order, hierarchy, rtl_spec, backend,
     entry) = payload
    from ..parser import parse
    from ..passmgr import PassManager
    from .verilog import lower_to_rtl, netlist_of

    m = parse(module_text)
    _attach_sidecar(m, sidecar)
    # the entry annotation gates the instance-sharing passes; a worker whose
    # target is not the entry must not see one (its sub-design is rooted at
    # a callee), matching what the serial pipeline does to that module
    design = lower_to_rtl(m, [target], hierarchy=hierarchy,
                          entry=entry if target == entry else None)
    if rtl_spec:
        PassManager.from_spec(rtl_spec).run(design)
    printer = get_printer(backend)
    modmap = printer.module_name_map(order)
    tm = design.modules[target]
    text = printer.print_module(tm, modmap=modmap, design=design)
    return target, text, netlist_of(tm)


def emit_design_parallel(module, order: list, hierarchy: str,
                         rtl_spec, backend: str,
                         max_workers: int, entry=None):
    """Emit the design's modules concurrently, one pool task per emitted
    module: each worker parses the printed post-pipeline module, lowers its
    target (plus, hierarchically, the callees the target instantiates), runs
    the RTL pass pipeline and prints the target.  Results come back as
    ``[(name, text, netlist), ...]`` in ``order`` — the same deterministic
    order the serial loop produces — or ``None`` when no pool is available
    (the caller then falls back to the byte-identical serial path)."""
    from ..pool import pool_map
    from ..printer import print_module

    text = print_module(module)
    sidecar = _module_sidecar(module)
    payloads = [(text, sidecar, t, tuple(order), hierarchy, rtl_spec or "",
                 backend, entry)
                for t in order]
    return pool_map(_emit_module_payload, payloads, max_workers,
                    label="backend emission")
