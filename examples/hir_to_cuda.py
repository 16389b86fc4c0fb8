"""The paper -> GPU bridge on the 1-d stencil (paper Listing 2).

Shows the three design components (algorithm / schedule / binding) moving
from the paper's FPGA world to an NVIDIA GPU:

  * the HIR source is identical (explicit II=1 pipelined schedule,
    register-window banking);
  * the FPGA binding emits Verilog (shift registers, FSMs) + a resource
    estimate under the Table-5 cost model, and the RTL runs cycle by cycle
    on the simulator's kernel (generated per design) against the oracle;
  * the GPU binding emits a CUDA kernel generated from the HIR whose loop
    realises the pipelined schedule and whose per-thread arrays realise the
    register window — then a retiming error is introduced and the schedule
    verifier rejects it BEFORE any lowering (paper Fig. 2's class of bug).

    PYTHONPATH=src python examples/hir_to_cuda.py               (on the card)
    PYTHONPATH=src python examples/hir_to_cuda.py --device cpu  (plain versions)
"""

import argparse

import numpy as np

from repro_torch.core import ir, verifier
from repro_torch.core.builder import Builder
from repro_torch.core.codegen.resources import report_module
from repro_torch.core.codegen.sim import probe_cycles, simulator_for, stack_stimulus
from repro_torch.core.codegen.verilog import generate_verilog
from repro_torch.core.gallery import stencil1d
from repro_torch.core.lower import lower_to_cuda
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device (fails without one)")
    args = ap.parse_args()

    module, entry = stencil1d.build(n=64)
    verifier.verify(module)
    print("== schedule verified (II=1 pipelined stencil) ==")

    # FPGA binding: Verilog + resources, and the RTL simulated cycle by cycle
    m2, _ = stencil1d.build(n=64)
    pm = PassManager.from_spec(DEFAULT_PIPELINE_SPEC)
    pm.run(m2)
    vmods = generate_verilog(m2.clone(), entry)
    res = None
    for vm in vmods.values():
        r = report_module(vm)
        res = r if res is None else res + r
    print(f"FPGA binding:  {sum(len(v.text.splitlines()) for v in vmods.values())} "
          f"lines of Verilog, resources {res.as_dict()}")
    sim, prepared = simulator_for(m2, entry, device=args.device)
    batch = stack_stimulus(stencil1d.make_inputs, 64, base_seed=1, n=64)
    cycles = probe_cycles(prepared, entry, [c[0] for c in batch])
    rtl = sim.run(batch, cycles, batched=True)
    want = np.stack([stencil1d.oracle(x) for x in batch[0]])
    np.testing.assert_array_equal(rtl.arrays[1], want)
    print(f"RTL simulated: {cycles} cycles x 64 stimulus vectors ({sim.backend} "
          f"backend) match the oracle")

    # GPU binding: the generated CUDA kernel (the pipelined loop runs inside
    # each thread, the register window in its per-thread arrays), validated
    # against the oracle
    inputs = stencil1d.make_inputs(n=64)
    fn = lower_to_cuda(module, entry, device=args.device)
    out = fn(inputs[0])["Bw"]
    want = stencil1d.oracle(inputs[0])
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64), want)
    where = f"{fn.launches} launch" if fn.launches else "plain version"
    print(f"GPU binding:   generated CUDA kernel ({len(fn.source.splitlines())} lines, "
          f"{where} on {out.device}) matches oracle")

    # now break the schedule the way a retiming would (paper Fig. 2) and
    # watch the verifier refuse it statically
    b = Builder(ir.Module("broken"))
    with b.func("mac", [ir.i32, ir.i32, ir.i32], ["a", "b", "c"],
                result_types=[ir.i32], result_delays=[3]) as f:
        m = b.mult(f.args[0], f.args[1], at=f.t, stages=3)   # 3-stage multiplier
        c2 = b.delay(f.args[2], 2, at=f.t)                   # ...2-stage delay
        s = b.add(m, c2)                                     # imbalance!
        b.ret([s])
    diags = verifier.verify(b.module, raise_on_error=False)
    print("\n== retimed design rejected by the schedule verifier ==")
    for d in diags:
        print(d.render())
    assert any("mismatched delay" in d.message for d in diags)
    print("\nhir_to_cuda OK")


if __name__ == "__main__":
    main()
