from .rtl import (RTL_PIPELINE_SPEC, RTLDesign, RTLModule, print_design,  # noqa: F401
                  print_rtl)
from .backends import (BACKENDS, CIRCTPrinter, NetlistPrinter,  # noqa: F401
                       SystemVerilogPrinter, VerilogPrinter, VHDLPrinter,
                       get_printer)
from .verilog import (Netlist, VerilogModule, generate_verilog,  # noqa: F401
                      lower_to_rtl, netlist_of)
from .resources import (ResourceReport, estimate_resources,  # noqa: F401
                        report_design, report_module, sharing_summary)
from .lint import (DIALECT_LINTERS, lint_backend, lint_circt,  # noqa: F401
                   lint_systemverilog, lint_verilog, lint_vhdl)
from .sim import (DiffReport, RTLSimError, RTLSimulator,  # noqa: F401
                  SimResult, probe_cycles, run_differential, simulator_for,
                  stack_stimulus, verify_rtl_passes)
