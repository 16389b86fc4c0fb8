"""The port's cycle-accurate RTL simulator against the reference's, on the
CPU — the port twin of ``tests/core/test_rtl_sim.py``'s matrix.

Every hand-written gallery design, at the sizes of the reference test,
emitted inline (here) and as modules (``test_torch_rtl_sim_modules.py``, a
file of its own so that each takes about half a minute), runs 256 stimulus
vectors through the port's plain
backend (``_TorchOps`` on int64 tensors, ``device="cpu"``) and through the
reference's NumPy backend (the one that runs here: the reference's JAX
backend needs ``jax.experimental.enable_x64``, which the installed jax no
longer has — ROADMAP R8).  Final arrays, returns, valid flags, conflict
counts and per-cycle traces must be equal bit for bit, and
``run_differential`` must pass on both sides: the port's with every RTL
pass checked, the reference's on its event-driven and oracle legs (its pass
leg is the reference test's own).  The value-semantics twins, the stimulus
and DSE-oracle twins and the host build of the simulator's kernel are in
``test_torch_rtl_sim_units.py``.
"""

import numpy as np
import pytest

from repro.core import gallery as ref_gallery
from repro.core.codegen import sim as ref_sim

from repro_torch.core.codegen import sim as port_sim
from test_torch_gpu import (RTL_KERNELS, assert_same_sim_result, rtl_design, rtl_oracle,
                            rtl_stimulus)

N_VECTORS = 256


def check_twin(kernel, hierarchy):
    """One design of the matrix on both simulators: bit-exact results and
    ``run_differential`` ok on both sides."""
    batch = rtl_stimulus(kernel, N_VECTORS)
    module, entry = rtl_design(kernel)
    ref_module, _ = ref_gallery.GALLERY[kernel].build(**RTL_KERNELS[kernel][0])
    sim, prepared = port_sim.simulator_for(module, entry, hierarchy=hierarchy, device="cpu")
    ref, ref_prepared = ref_sim.simulator_for(ref_module, entry, hierarchy=hierarchy,
                                              backend="numpy")
    assert sim.backend == "torch" and ref.backend == "numpy"
    assert [n for n, *_ in sim.comb_tape] == [n for n, *_ in ref.comb_tape]
    assert sim.state_shape == ref.state_shape
    cycles = port_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
    assert cycles == ref_sim.probe_cycles(ref_prepared, entry, [c[0] for c in batch])
    got = sim.run(batch, cycles, batched=True, trace=True, check_conflicts=False)
    want = ref.run(batch, cycles, batched=True, trace=True, check_conflicts=False)
    assert got.backend == "torch" and got.trace
    assert_same_sim_result(got, want)
    assert all(a.dtype == np.int64 for a in got.arrays.values())

    oracle, nargs = rtl_oracle(kernel)
    if kernel == "mac":             # scalar arguments: no array for the oracle leg
        oracle, nargs = None, 0
    rep = port_sim.run_differential(module, entry, batch, kernel=kernel, hierarchy=hierarchy,
                                    oracle=oracle, oracle_nargs=nargs, device="cpu")
    ref_rep = ref_sim.run_differential(ref_module, entry, batch, kernel=kernel,
                                       hierarchy=hierarchy, backend="numpy", oracle=oracle,
                                       oracle_nargs=nargs, check_passes=False)
    assert rep.ok, rep.mismatches[:5]
    assert ref_rep.ok, ref_rep.mismatches[:5]
    assert rep.passes_ok and all(rep.passes_ok.values())
    assert (rep.n_vectors, rep.cycles, rep.event_lanes_checked, rep.oracle_ok) == \
        (ref_rep.n_vectors, ref_rep.cycles, ref_rep.event_lanes_checked, ref_rep.oracle_ok)
    if kernel == "mac":             # the oracle leg of the reference's mac test
        mac = rtl_oracle("mac")[0]
        want = np.array([mac(int(a), int(b), int(c)) for a, b, c in zip(*batch)])
        assert np.all(got.returns_valid[0] == 1)
        np.testing.assert_array_equal(got.returns[0], want)


@pytest.mark.parametrize("kernel", sorted(RTL_KERNELS))
def test_torch_backend_is_bit_exact_against_the_reference_inline(kernel):
    check_twin(kernel, "inline")
