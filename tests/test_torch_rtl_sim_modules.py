"""``test_torch_rtl_sim.py``'s matrix with the designs emitted as modules
(``hierarchy="modules"``): the port's plain simulator bit-exact against the
reference's NumPy simulator on 256 vectors, and ``run_differential`` ok on
both sides.  A file of its own so that each half takes about half a minute
under ``--dist loadfile``."""

import pytest

from test_torch_gpu import RTL_KERNELS
from test_torch_rtl_sim import check_twin


@pytest.mark.parametrize("kernel", sorted(RTL_KERNELS))
def test_torch_backend_is_bit_exact_against_the_reference_modules(kernel):
    check_twin(kernel, "modules")
