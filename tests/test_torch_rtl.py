"""The RTL half of the port's compiler against the reference, on the CPU:
Verilog, SystemVerilog, VHDL and CIRCT output of every gallery design in
both hierarchy modes equal the committed goldens byte for byte and lint
clean, and the legacy sweep and the pool mapper's serial path give the
reference's results (the resource reports: ``test_torch_rtl_resources.py``).

The traced ``frontend_*`` designs come from the port's own frontend: their
goldens were written by the reference's tracer, which no longer runs under
the installed jax (ROADMAP R1), so the port's output is held to the files
alone; the tests that build the reference side keep to the nine
hand-written designs.
"""

import hashlib
import re
from pathlib import Path

import pytest

from repro.core import gallery as ref_gallery
from repro.core.codegen import generate_verilog as ref_generate_verilog
from repro.core.passes.legacy_sweep import run_legacy_sweep as ref_legacy_sweep
from repro.core.printer import print_module as ref_print_module

from repro_torch.core import gallery as port_gallery
from repro_torch.core import pool as port_pool
from repro_torch.core.codegen import (BACKENDS, RTLDesign, generate_verilog, get_printer,
                                      lint_backend)
from repro_torch.core.passes import run_pipeline
from repro_torch.core.passes.legacy_sweep import run_legacy_sweep
from repro_torch.core.printer import print_module

KERNELS = sorted(port_gallery.GALLERY)
HAND_WRITTEN = [k for k in KERNELS if not k.startswith("frontend_")]
MODES = ("inline", "modules")
BACKEND_NAMES = sorted(BACKENDS)
EXT = {"verilog": "v", "systemverilog": "sv", "vhdl": "vhd", "circt": "mlir"}
GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
BIG = 64 * 1024  # the goldens keep a digest of outputs above this size

_designs: dict = {}


def _design(kernel, mode):
    """One optimized emission per (kernel, mode), as the reference's
    backend test makes it; every backend prints from the same RTL."""
    if (kernel, mode) not in _designs:
        m, entry = port_gallery.GALLERY[kernel].build()
        run_pipeline(m)
        _designs[(kernel, mode)] = generate_verilog(m, entry, hierarchy=mode)
    return _designs[(kernel, mode)]


def _emit(kernel, mode, backend):
    mods = _design(kernel, mode)
    if backend == "verilog":
        return {n: vm.text for n, vm in mods.items()}, list(mods)
    design = RTLDesign({n: vm.rtl for n, vm in mods.items()})
    return get_printer(backend).print_modules(design), list(mods)


def _normalize(text):
    return "\n".join(line.rstrip() for line in text.splitlines()).rstrip() + "\n"


def _canon(text):
    names = {}
    return re.sub(r"%v\d+\b", lambda m: names.setdefault(m.group(0), f"%v{len(names)}"), text)


def test_the_goldens_cover_every_hand_written_design():
    """The goldens are the twelve designs of the gallery, the three traced
    ones included, each in every hierarchy and backend."""
    stems = {p.name.split(".")[0] for p in GOLDEN_DIR.iterdir()}
    assert stems == set(KERNELS) == set(ref_gallery.GALLERY)
    assert len(KERNELS) == 12 and len(HAND_WRITTEN) == 9
    for kernel in KERNELS:
        assert {p.name for p in GOLDEN_DIR.glob(f"{kernel}.*")} == {
            f"{kernel}.{mode}.{ext}" for mode in MODES for ext in EXT.values()}


@pytest.mark.parametrize("backend", BACKEND_NAMES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_port_output_equals_the_golden(kernel, mode, backend):
    texts, _ = _emit(kernel, mode, backend)
    text = _normalize("\n".join(texts.values()))
    stored = (GOLDEN_DIR / f"{kernel}.{mode}.{EXT[backend]}").read_text()
    if stored.startswith("# golden digest="):
        digest = re.match(r"# golden digest=sha256:([0-9a-f]{64})", stored).group(1)
        assert len(text) > BIG
        assert hashlib.sha256(text.encode()).hexdigest() == digest
    else:
        assert text == stored


@pytest.mark.parametrize("backend", BACKEND_NAMES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_port_output_lints_clean(kernel, mode, backend):
    texts, names = _emit(kernel, mode, backend)
    assert lint_backend("\n".join(texts.values()), backend, known_modules=names) == []


@pytest.mark.parametrize("kernel", HAND_WRITTEN)
def test_legacy_sweep_equals_the_reference(kernel):
    """The benchmark's baseline optimizer: same statistics, same IR."""
    rm, _ = ref_gallery.GALLERY[kernel].build()
    pm, _ = port_gallery.GALLERY[kernel].build()
    assert run_legacy_sweep(pm) == ref_legacy_sweep(rm)
    assert _canon(print_module(pm)) == _canon(ref_print_module(rm))


def test_pool_map_without_a_pool_takes_the_serial_path(monkeypatch):
    """Where no process pool can be made, ``pool_map`` returns None with a
    warning, and hierarchical emission with workers asked for gives the
    reference's serial output byte for byte."""
    class NoPool:
        def __init__(self, *a, **k):
            raise OSError("no semaphores here")

    monkeypatch.setattr(port_pool, "ProcessPoolExecutor", NoPool)
    with pytest.warns(RuntimeWarning, match="falling back to serial"):
        assert port_pool.pool_map(len, ["ab", "cde"], max_workers=2) is None
    assert port_pool.pool_map(len, ["ab", "cde"], max_workers=1) is None
    for kernel in ("gemm", "stencil1d"):          # two emitted modules each
        rm, entry = ref_gallery.GALLERY[kernel].build()
        pm, _ = port_gallery.GALLERY[kernel].build()
        want = ref_generate_verilog(rm, entry, hierarchy="modules")
        with pytest.warns(RuntimeWarning, match="backend emission"):
            got = generate_verilog(pm, entry, hierarchy="modules", max_workers=4)
        assert {n: vm.text for n, vm in got.items()} == {n: vm.text for n, vm in want.items()}
