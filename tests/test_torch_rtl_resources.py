"""The port's resource reports against the reference's, on the CPU: for
every hand-written gallery design in both hierarchy modes, ``report_design``
of the port's emission equals the reference's, per design and rooted at the
entry.  (Kept apart from ``test_torch_rtl.py`` so that each file stays
within about a minute.)"""

import numpy as np
import pytest

from repro.core import gallery as ref_gallery
from repro.core.codegen import generate_verilog as ref_generate_verilog
from repro.core.codegen import report_design as ref_report_design
from repro.core.passes import run_pipeline as ref_run_pipeline

from repro_torch.core import gallery as port_gallery
from repro_torch.core.codegen import generate_verilog, report_design
from repro_torch.core.passes import run_pipeline

# the reference side is built too: its traced designs need the reference's
# tracer, which does not run under the installed jax (ROADMAP R1); the port's
# traced designs are held to the reference's report in test_torch_frontend.py
KERNELS = sorted(k for k in port_gallery.GALLERY if not k.startswith("frontend_"))
MODES = ("inline", "modules")


def _emit(gallery, pipeline, generate, kernel, mode):
    m, entry = gallery.GALLERY[kernel].build()
    pipeline(m)
    return generate(m, entry, hierarchy=mode), entry


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_resource_report_equals_the_reference(kernel, mode):
    ref_mods, entry = _emit(ref_gallery, ref_run_pipeline, ref_generate_verilog, kernel, mode)
    port_mods, _ = _emit(port_gallery, run_pipeline, generate_verilog, kernel, mode)
    assert list(port_mods) == list(ref_mods)
    assert report_design(port_mods).as_dict() == ref_report_design(ref_mods).as_dict()
    assert report_design(port_mods, entry).as_dict() == \
        ref_report_design(ref_mods, entry).as_dict()




def test_report_counts_are_plain_numbers():
    mods, _ = _emit(port_gallery, run_pipeline, generate_verilog, "array_add", "inline")
    rep = report_design(mods).as_dict()
    assert rep and all(isinstance(v, (int, float, np.integer)) for v in rep.values())
