"""Quickstart of the PyTorch/CUDA port: the paper's workflow on an NVIDIA GPU.

1. Write a kernel in HIR (explicit schedule).
2. The schedule verifier catches a pipelining bug (paper Fig. 1).
3. Optimize (precision opt etc.), emit Verilog, and check the RTL on the
   cycle-accurate simulator against the event-driven simulator, the oracle
   and every RTL pass, over a batch of stimulus vectors (``run_differential``).
4. Lower the SAME IR to a generated CUDA kernel and execute it — on one
   stimulus vector and on a batch of them — against the NumPy oracle, the
   cycle-accurate simulator and the functional PyTorch lowering.

Run:  PYTHONPATH=src python examples/quickstart_torch.py            (on the card)
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
      (the plain PyTorch version of the kernel; no nvcc needed)
"""

import argparse

import numpy as np

from repro_torch.core import verifier
from repro_torch.core.codegen import generate_verilog, run_differential, stack_stimulus
from repro_torch.core.gallery import array_add
from repro_torch.core.lower import lower_to_cuda, lower_to_torch, simulate
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager
from repro_torch.core.printer import print_module


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device (fails without one)")
    ap.add_argument("--lanes", type=int, default=256,
                    help="stimulus vectors run side by side in steps 3 and 4")
    args = ap.parse_args()

    # -- 1. a fresh HIR kernel: out[i] = a[i] + b[i], pipelined at II=1 ----
    module, entry = array_add.build(n=64)
    print("== HIR (explicit schedule) ==")
    print(print_module(module))

    # -- 2. the paper's Fig. 1 bug is caught statically ---------------------
    broken, _ = array_add.build_broken(n=64)
    diags = verifier.verify(broken, raise_on_error=False)
    print("\n== schedule verifier on the Fig. 1 design ==")
    for d in diags:
        print(d.render())

    # -- 3. optimize ----------------------------------------------------------
    pm = PassManager.from_spec(DEFAULT_PIPELINE_SPEC)
    pm.run(module)
    print(f"\n== optimization pipeline ({pm.spec}) ==")
    print(pm.render_stats())

    vmods = generate_verilog(module.clone(), entry)
    text = vmods[entry].text
    print(f"== Verilog: {len(text.splitlines())} lines ==")
    print("\n".join(text.splitlines()[:6]))
    stim = stack_stimulus(array_add.make_inputs, args.lanes, base_seed=7, n=64)
    rep = run_differential(module, entry, stim, kernel="array_add",
                           oracle=array_add.oracle, oracle_nargs=2, device=args.device)
    assert rep.ok, rep.mismatches[:5]
    print(f"== RTL differential check on {rep.n_vectors} vectors, {rep.cycles} cycles "
          f"({rep.backend} backend): event-driven lanes {rep.event_lanes_checked}, "
          f"oracle {rep.oracle_ok}, RTL passes {sum(rep.passes_ok.values())}/"
          f"{len(rep.passes_ok)} ==")

    # -- 4. same IR -> generated CUDA kernel ---------------------------------
    inputs = array_add.make_inputs(n=64)
    fn = lower_to_cuda(module, entry, device=args.device)
    print(f"== generated CUDA C++: {len(fn.source.splitlines())} lines ==")
    out = fn(inputs[0], inputs[1])["C"]
    want = array_add.oracle(inputs[0], inputs[1])
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64), want)

    lanes = [array_add.make_inputs(n=64, seed=s) for s in range(args.lanes)]
    a, b = (np.stack([lane[i] for lane in lanes]) for i in range(2))
    batch = fn(a, b)["C"]
    np.testing.assert_array_equal(batch.cpu().numpy().astype(np.int64),
                                  array_add.oracle(a, b))
    where = f"{fn.launches} kernel launches" if fn.launches else "plain version"
    print(f"== CUDA lowering matches the NumPy oracle on 1 and {args.lanes} lanes "
          f"({where} on {out.device}) ==")

    # cross-check: cycle-accurate simulation and functional PyTorch lowering
    sim_inputs = array_add.make_inputs(n=64)
    simulate(module, entry, sim_inputs)
    np.testing.assert_array_equal(sim_inputs[-1], want)
    tout = lower_to_torch(module, entry, device=args.device)(*array_add.make_inputs(n=64))
    np.testing.assert_array_equal(tout["C"].cpu().numpy().astype(np.int64), want)
    print("== cycle-accurate sim and functional lowering agree ==")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
