"""FPGA resource model (paper Table 5 analogue) over the structured netlist.

We cannot run Vivado in this environment, so resource usage is estimated from
the *post-RTL-pipeline* netlist structure with a documented cost model for
Xilinx 7-series (the paper's VC709 = Virtex-7):

  LUTs  — one 6-input LUT per output bit of combinational logic (adders,
          comparators, muxes, bitwise ops); LUTRAM at 1 LUT per 2 bits per
          port-pair (RAM64M-style packing); SRL32 shift registers at 1 LUT
          per bit per 32 stages of depth (Vivado maps deep shift registers
          to SRLs, keeping one output FF per bit).
  FFs   — pipeline/output registers, FSM counters, shallow (depth<=2) delay
          chains, register banks.
  DSPs  — 32x32 multiply = 3 DSP48E1 (this matches the paper's GEMM: 256
          PEs x 3 = 768 DSPs); <=17-bit multiply = 1; shift-add/counter
          strength-reduced multiplies = 0 DSPs.
  BRAM  — RAMB18 blocks: ceil(bits/18Kb) per bank, dual-port within one
          block is free (so port demotion saves LUTs, not BRAMs).

The summary (``Netlist``) is **derived from the RTL IR** by
``verilog.netlist_of`` after the RTL pass pipeline ran, so dead, merged and
shared hardware is counted exactly once.  Hierarchical designs are costed by
``report_design``: every module *definition* is estimated once (memoized)
and then weighted by its instantiation multiplicity — 256 instances of one
``mac`` module cost 256x the mac estimate, without re-deriving it per
instance.

The model's purpose is *relative* comparison between HIR-scheduled and
HLS-baseline-scheduled designs under one consistent cost function, mirroring
how the paper compares HIR vs Vivado HLS under one synthesis flow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

from .verilog import Netlist, VerilogModule


@dataclass
class ResourceReport:
    lut: int = 0
    ff: int = 0
    dsp: int = 0
    bram: int = 0

    def __add__(self, o: "ResourceReport") -> "ResourceReport":
        return ResourceReport(self.lut + o.lut, self.ff + o.ff, self.dsp + o.dsp, self.bram + o.bram)

    def scaled(self, k: int) -> "ResourceReport":
        return ResourceReport(self.lut * k, self.ff * k, self.dsp * k, self.bram * k)

    def as_dict(self) -> dict:
        return {"LUT": self.lut, "FF": self.ff, "DSP": self.dsp, "BRAM": self.bram}


def _dsp_for_mult(width: int) -> int:
    if width <= 17:
        return 1
    if width <= 25:
        return 2
    if width <= 34:
        return 3  # 32x32 on DSP48E1 cascade
    return math.ceil(width / 17) ** 2 // 2 + 1


def estimate_resources(nl: Netlist) -> ResourceReport:
    """Flat (single-module) estimate; instances are *not* included — use
    ``report_design`` for hierarchy-aware totals."""
    r = ResourceReport()

    for w in nl.adders:
        r.lut += w
    for w in nl.cmps:
        r.lut += max(1, w // 2 + 1)
    for w in nl.muxes:
        r.lut += w
    for w in nl.logic:
        r.lut += max(1, w // 2)  # 2 bits/LUT for 2-input bitwise

    for w, impl in nl.mults:
        if impl == "dsp":
            r.dsp += _dsp_for_mult(w)
        elif impl == "shift_add":
            r.lut += 2 * w  # two adder terms typical
        elif impl == "counter":
            r.lut += w
            r.ff += w
        elif impl == "div":
            r.lut += w * max(4, w // 2)

    for w, d in nl.shift_regs:
        if d <= 2:
            r.ff += w * d
        else:
            r.lut += w * math.ceil(d / 32)  # SRL32
            r.ff += w  # output register

    for w in nl.registers:
        r.ff += w
    for w in nl.counters:
        r.ff += w
        r.lut += w  # increment + wrap compare

    for banks, depth, width, ports, kind in nl.rams:
        if kind == "bram":
            r.bram += banks * max(1, math.ceil(depth * width / 18432))
        else:  # distributed RAM
            per_bank = math.ceil(depth / 64) * width
            r.lut += banks * per_bank * max(1, ports - 0)  # per read port
    for nregs, width in nl.reg_banks:
        r.ff += nregs * width

    return r


def report_module(vm: VerilogModule) -> ResourceReport:
    return estimate_resources(vm.netlist)


def report_design(mods: Mapping[str, VerilogModule],
                  entry: Optional[str] = None) -> ResourceReport:
    """Hierarchy-aware estimate rooted at ``entry`` (default: every module
    that is not instantiated by another — the top level(s)).  Each module
    definition is estimated once and cached; instantiation multiplicity then
    weights the shared estimate, so a module instantiated 256 times is
    derived once and counted 256 times."""
    memo: dict[str, ResourceReport] = {}

    def cost(name: str, stack: tuple = ()) -> ResourceReport:
        if name in memo:
            return memo[name]
        vm = mods.get(name)
        if vm is None or name in stack:  # external/blackbox or cycle guard
            return ResourceReport()
        r = estimate_resources(vm.netlist)
        for sub in vm.netlist.instances:
            r = r + cost(sub, stack + (name,))
        memo[name] = r
        return r

    if entry is not None:
        return cost(entry)
    instantiated = {sub for vm in mods.values() for sub in vm.netlist.instances}
    roots = [n for n in mods if n not in instantiated] or list(mods)
    total = ResourceReport()
    for n in roots:
        total = total + cost(n)
    return total


def sharing_summary(mods: Mapping[str, VerilogModule],
                    entry: Optional[str] = None) -> dict:
    """Sharing-degree metadata to read alongside ``report_design``: per
    callee module, how many physical time-multiplexed instances survived and
    how many logical instances they absorbed.  ``report_design`` already
    counts a shared instance once (the absorbed ``Instance`` items are gone
    from the netlist); this surfaces *how much* logical hardware each
    physical instance stands in for.

    Returns ``{"per_module": {callee: {"physical": p, "logical": l,
    "max_degree": d}}, "physical_instances": ..., "logical_instances": ...,
    "absorbed": ...}`` — ``absorbed == 0`` means no sharing fired."""
    names = [entry] if entry is not None else list(mods)
    per: dict[str, dict] = {}
    seen: set[str] = set()

    def visit(name: str) -> None:
        if name in seen:
            return
        seen.add(name)
        vm = mods.get(name)
        if vm is None:
            return
        degrees: dict[str, list[int]] = {}
        for sub in vm.netlist.instances:
            degrees.setdefault(sub, []).append(1)
            visit(sub)
        for sub, deg in vm.netlist.shared:
            degrees[sub][degrees[sub].index(1)] = deg
        for sub, ds in degrees.items():
            row = per.setdefault(sub, {"physical": 0, "logical": 0,
                                       "max_degree": 1})
            row["physical"] += len(ds)
            row["logical"] += sum(ds)
            row["max_degree"] = max(row["max_degree"], max(ds))

    for n in names:
        visit(n)
    return {
        "per_module": per,
        "physical_instances": sum(r["physical"] for r in per.values()),
        "logical_instances": sum(r["logical"] for r in per.values()),
        "absorbed": sum(r["logical"] - r["physical"] for r in per.values()),
    }
