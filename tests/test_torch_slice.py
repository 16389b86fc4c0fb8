"""The first slice of the PyTorch port as a whole, on the CPU: build ->
verify -> optimize -> lower -> oracle, reference and port side by side, plus
the port's ground rules — its compiler core is a faithful copy, it imports
neither ``jax`` nor the reference package, every module imports without a
GPU toolchain, and no entry point falls back to the CPU on its own.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; jax stays on the CPU)
import numpy as np
import pytest
import torch

from repro.core import gallery as ref_gallery
from repro.core import verifier as ref_verifier
from repro.core.lower.to_pallas import lower_to_pallas
from repro.core.passes import DEFAULT_PIPELINE_SPEC as REF_PIPELINE_SPEC
from repro.core.passes import PassManager as RefPassManager
from repro.core.printer import print_module as ref_print_module

import repro_torch
from repro_torch import compat, resolve_device
from repro_torch.core import gallery as port_gallery
from repro_torch.core import verifier
from repro_torch.core.codegen import run_differential, simulator_for, stack_stimulus
from repro_torch.core.lower import lower_to_cuda, lower_to_torch, simulate
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager
from repro_torch.core.printer import print_module
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

LOOP_NESTS = ["array_add", "transpose", "stencil1d", "histogram", "conv2d"]

# the compiler core the port keeps as its own copy, byte for byte
VERBATIM = (
    [f"core/{m}.py" for m in ("ir", "rewrite", "passmgr", "verifier", "schedule",
                              "builder", "printer", "parser", "analysis", "pool")]
    + ["core/lower/to_sim.py"]
    + [f"core/passes/{m}.py" for m in ("__init__", "canonicalize", "cse", "delay_elim",
                                       "port_demotion", "precision_opt", "strength_reduce",
                                       "inline", "unroll", "schedule_transforms",
                                       "loop_transforms", "legacy_sweep")]
    + [f"core/codegen/{m}.py" for m in ("rtl", "backends", "verilog", "resources", "lint")]
    + [f"core/hls/{m}.py" for m in ("__init__", "eraser", "scheduler")]
    + [f"core/gallery/{m}.py" for m in ("array_add", "transpose", "stencil1d", "histogram",
                                        "conv2d", "gemm", "gemm_shared", "mac", "fifo")]
    + [f"configs/{m}.py" for m in ("base", "tinyllama_1_1b", "smollm_360m", "qwen2_7b",
                                   "qwen2_5_14b", "mamba2_780m", "recurrentgemma_9b",
                                   "qwen2_moe_a2_7b", "deepseek_v2_lite_16b",
                                   "seamless_m4t_medium", "llama_3_2_vision_90b")]
    + ["data/pipeline.py"]
)


def _canon(text):
    """IR text with anonymous value names (``%v<id>``, drawn from a counter
    each package keeps per process) renumbered in order of first appearance."""
    names = {}
    return re.sub(r"%v\d+\b", lambda m: names.setdefault(m.group(0), f"%v{len(names)}"), text)


def _n_in(module, name):
    return sum(1 for a in module.get(name).args if a.type.port == "r")


@pytest.mark.parametrize("gal_name", LOOP_NESTS)
def test_slice_end_to_end_matches_reference(gal_name):
    """Both sides: build -> verify -> DEFAULT_PIPELINE_SPEC -> lower -> run.
    The designs stay textually identical through the passes, the pass
    statistics agree, and the outputs are bit-exact and equal the oracle."""
    ref_gal, port_gal = ref_gallery.GALLERY[gal_name], port_gallery.GALLERY[gal_name]
    rmod, rname = ref_gal.build()
    pmod, pname = port_gal.build()
    assert _canon(print_module(pmod)) == _canon(ref_print_module(rmod))
    assert ref_verifier.verify(rmod) == [] and verifier.verify(pmod) == []
    assert DEFAULT_PIPELINE_SPEC == REF_PIPELINE_SPEC
    rstats = RefPassManager.from_spec(REF_PIPELINE_SPEC).run(rmod)
    pstats = PassManager.from_spec(DEFAULT_PIPELINE_SPEC).run(pmod)
    assert pstats == rstats
    assert _canon(print_module(pmod)) == _canon(ref_print_module(rmod))

    inputs = port_gal.make_inputs()
    n_in = _n_in(pmod, pname)
    want = port_gal.oracle(*inputs[:n_in])
    rout = lower_to_pallas(rmod, rname)(*inputs[:n_in])
    pout = lower_to_cuda(pmod, pname, device="cpu")(*inputs[:n_in])
    fout = lower_to_torch(pmod, pname, device="cpu")(*inputs)
    sim_args = [np.array(x, copy=True) for x in inputs]
    simulate(pmod, pname, sim_args)
    for k in rout:
        np.testing.assert_array_equal(pout[k].numpy().astype(np.int64), want)
        np.testing.assert_array_equal(np.asarray(rout[k], np.int64), want)
        np.testing.assert_array_equal(fout[k].numpy().astype(np.int64), want)
    np.testing.assert_array_equal(sim_args[-1], want)


@pytest.mark.parametrize("gal_name", ["array_add", "mac"])
def test_verifier_diagnostics_equal_reference(gal_name):
    """The paper's Fig. 1 and Fig. 2 bugs: same diagnostics, same text."""
    rmod, _ = ref_gallery.GALLERY[gal_name].build_broken()
    pmod, _ = port_gallery.GALLERY[gal_name].build_broken()
    rdiags = ref_verifier.verify(rmod, raise_on_error=False)
    pdiags = verifier.verify(pmod, raise_on_error=False)
    assert rdiags and len(pdiags) == len(rdiags)
    assert [d.render() for d in pdiags] == [d.render() for d in rdiags]
    assert [d.severity for d in pdiags] == [d.severity for d in rdiags]
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pmod)


# -- the copy of the compiler core ------------------------------------------------


@pytest.mark.parametrize("rel", VERBATIM)
def test_core_file_is_a_verbatim_copy(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


def test_ft_runtime_differs_only_in_its_store_import():
    """``ft/runtime.py`` is the reference's restart driver; its one import of
    the checkpoint store may name the port's store, and no other line may
    differ."""
    ref_lines = (REF / "ft/runtime.py").read_text().splitlines()
    port_lines = (PORT / "ft/runtime.py").read_text().splitlines()
    assert len(ref_lines) == len(port_lines)
    differ = [(a, b) for a, b in zip(ref_lines, port_lines) if a != b]
    store_import = re.compile(r"^from \.\.checkpoint\.store import AsyncCheckpointer, "
                              r"latest_step, restore$")
    assert all(store_import.match(b) for _, b in differ), differ
    assert sum(bool(store_import.match(b)) for b in port_lines) == 1
    from repro_torch.checkpoint import store
    from repro_torch.ft import runtime
    assert runtime.restore is store.restore and runtime.AsyncCheckpointer is store.AsyncCheckpointer


def test_rules_differ_from_the_reference_only_in_imports_and_mesh_accessors():
    """``parallel/rules.py`` is the reference's logic byte for byte: only its
    imports (no ``jax.sharding.Mesh``) and the two lines that read the mesh's
    axis sizes and names (``mesh_shape(mesh)``, ``mesh_axis_names(mesh)``,
    which take a DeviceMesh or a shape stand-in) differ."""
    import difflib

    ref_lines = (REF / "parallel/rules.py").read_text().splitlines()
    port_lines = (PORT / "parallel/rules.py").read_text().splitlines()
    imports = re.compile(r"^(from \S+ import .*|import \S+|)$")
    ref_access = re.compile(r"mesh\.shape\[a\]|= mesh\.axis_names$")
    port_access = re.compile(r"mesh_shape\(mesh\)\[a\]|= mesh_axis_names\(mesh\)$")
    pairs = 0
    for op, i0, i1, j0, j1 in difflib.SequenceMatcher(a=ref_lines, b=port_lines,
                                                      autojunk=False).get_opcodes():
        if op == "equal":
            continue
        a, b = ref_lines[i0:i1], port_lines[j0:j1]
        if all(imports.match(x) for x in a + b):
            continue
        assert op == "replace" and len(a) == len(b) == 1, (a, b)
        assert ref_access.search(a[0]) and port_access.search(b[0]), (a, b)
        assert ref_access.sub("", a[0]).replace("mesh.shape", "") == \
            port_access.sub("", b[0]).replace("mesh_shape(mesh)", ""), (a, b)
        pairs += 1
    assert pairs == 2


MESH_MODULES = ["parallel/__init__.py", "parallel/api.py", "parallel/rules.py",
                "parallel/compression.py", "launch/mesh.py"]


def test_the_mesh_modules_and_the_rank_script_import_neither_jax_nor_the_reference():
    """The mesh's modules and the script each rank of the distributed tests
    runs: no import of ``jax`` or ``repro`` in their text, and none pulled
    in when a fresh interpreter imports them."""
    files = [PORT / m for m in MESH_MODULES] + [ROOT / "tests" / "torch_dist_worker.py"]
    for path in files:
        hit = _FORBIDDEN.search(path.read_text())
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0).strip()!r}"
    code = ("import sys\n"
            "import repro_torch.parallel.api, repro_torch.parallel.rules\n"
            "import repro_torch.parallel.compression, repro_torch.launch.mesh\n"
            "import torch_dist_worker\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
                              "PATH": "/nonexistent"})
    assert out.returncode == 0, out.stderr


def test_passes_init_differs_only_by_the_rtl_reexports():
    """``core/passes/__init__.py`` once left out the RTL-level passes; with
    the codegen ported it is the reference's file whole (``VERBATIM``), and
    it re-exports the RTL passes and their pipeline."""
    assert (PORT / "core/passes/__init__.py").read_bytes() == \
        (REF / "core/passes/__init__.py").read_bytes()
    import repro_torch.core.passes as port_passes
    from repro_torch.core.codegen import rtl
    assert all(hasattr(port_passes, n) for n in port_passes.__all__)
    assert port_passes.RTL_PIPELINE_SPEC == rtl.RTL_PIPELINE_SPEC
    for name in ("DeadNetElim", "ShiftRegMerge", "CombShare", "ControllerMerge", "MemReadShare"):
        assert getattr(port_passes, name) is getattr(rtl, name)


def test_dse_differs_from_the_reference_only_in_its_oracle():
    """``core/hls/dse.py`` is the reference's file but for its oracle:
    ``_make_oracle_fn`` lowers with the port's ``lower_to_torch`` and has no
    fallback (no ``try``, no ``except ImportError``, no second route), and
    the functions that reach it (``oracle_expected``, ``explore_design``,
    ``sim_verify_front``) differ from the reference's code only in lines
    that carry the device (docstrings aside)."""
    import ast
    import difflib

    threaded = ("oracle_expected", "explore_design", "sim_verify_front")

    def split(text):
        lines = text.splitlines()
        fns = {n.name: n for n in ast.parse(text).body
               if isinstance(n, ast.FunctionDef) and n.name in threaded + ("_make_oracle_fn",)}
        cut = {i for n in fns.values() for i in range(n.lineno - 1, n.end_lineno)}
        rest = [ln for i, ln in enumerate(lines) if i not in cut]
        return rest, fns, lines

    def code(fn):
        fn = ast.parse(ast.unparse(fn)).body[0]
        if ast.get_docstring(fn) is not None:
            fn.body = fn.body[1:]
        return ast.unparse(fn).splitlines()

    ref_rest, ref_fns, _ = split((REF / "core/hls/dse.py").read_text())
    port_rest, port_fns, port_lines = split((PORT / "core/hls/dse.py").read_text())
    assert port_rest == ref_rest
    for name in threaded:
        ref_code, port_code = code(ref_fns[name]), code(port_fns[name])
        ops = difflib.SequenceMatcher(a=ref_code, b=port_code, autojunk=False).get_opcodes()
        changed = [port_code[j] for tag, _, _, j1, j2 in ops if tag != "equal"
                   for j in range(j1, j2)]
        assert changed, name
        assert all(tag in ("replace", "insert") for tag, *_ in ops if tag != "equal"), name
        assert all("device" in ln for ln in changed), (name, changed)
    fn = port_fns["_make_oracle_fn"]
    body = "\n".join(port_lines[fn.lineno - 1:fn.end_lineno])
    assert "lower_to_torch(module.clone(), entry, device=device)" in body
    assert "lower_to_jax" not in body and '"cpu"' not in body
    assert not any(isinstance(n, ast.Try) for n in ast.walk(ast.parse(body)))
    assert "except" not in body and "simulate" not in body


def test_codegen_init_differs_only_by_the_jax_flag():
    ref_text = (REF / "core/codegen/__init__.py").read_text()
    port_text = (PORT / "core/codegen/__init__.py").read_text()
    assert port_text == ref_text.replace("from .sim import (HAVE_JAX, DiffReport",
                                         "from .sim import (DiffReport")
    assert port_text != ref_text


def test_sim_keeps_the_reference_apart_from_its_backends():
    """``core/codegen/sim.py`` is the reference's file outside what touches
    JAX: every other top-level function, class and ``RTLSimulator`` method
    is the reference's text; ``_NumpyOps`` is kept as it is."""
    import ast

    def defs(text):
        out = {}
        lines = text.splitlines()
        for node in ast.parse(text).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                out[node.name] = "\n".join(lines[node.lineno - 1:node.end_lineno])
                if node.name == "RTLSimulator":
                    for m in node.body:
                        if isinstance(m, ast.FunctionDef):
                            out[f"RTLSimulator.{m.name}"] = "\n".join(
                                lines[m.lineno - 1:m.end_lineno])
        return out

    ref = defs((REF / "core/codegen/sim.py").read_text())
    port = defs((PORT / "core/codegen/sim.py").read_text())
    changed = {"_JaxOps", "_TorchOps", "RTLSimulator", "RTLSimulator.__init__",
               "RTLSimulator._resolve_backend", "RTLSimulator.run", "RTLSimulator._run_jax",
               "RTLSimulator._run_torch", "RTLSimulator._run_cuda",
               "RTLSimulator.cuda_kernel", "RTLSimulator._make_step", "simulator_for",
               "fold_in_stimulus", "run_differential"}
    assert set(ref) - changed == set(port) - changed
    for name in set(ref) - changed:
        assert port[name] == ref[name], name
    # _make_step differs in the one line that stacks the conflict counts
    diff = [(a, b) for a, b in zip(ref["RTLSimulator._make_step"].splitlines(),
                                   port["RTLSimulator._make_step"].splitlines()) if a != b]
    assert len(diff) == 2 and all("stack" in a and "stack" in b for a, b in diff)


def test_registry_differs_only_by_the_archs_not_ported():
    """``configs/registry.py`` lists the ten archs of the reference, all of
    which the port runs (four dense, Mamba-2, RecurrentGemma, the MoE
    qwen2-moe and deepseek-v2-lite, seamless-m4t and llama-3.2-vision): no
    arch's lines leave ``ARCHS`` or ``_ALIASES``, and only the ``KeyError``
    differs, saying an arch may be unknown or not ported yet."""
    ref_lines = (REF / "configs/registry.py").read_text().splitlines()
    port_lines = (PORT / "configs/registry.py").read_text().splitlines()
    ported = {"tinyllama_1_1b", "qwen2_7b", "smollm_360m", "qwen2_5_14b", "mamba2_780m",
              "recurrentgemma_9b", "qwen2_moe_a2_7b", "deepseek_v2_lite_16b",
              "seamless_m4t_medium", "llama_3_2_vision_90b"}
    dropped = {i for i, ln in enumerate(ref_lines) if ln.startswith('    "') and ln.endswith(",")
               and ln.rstrip(",").split('"')[-2] not in ported}
    assert not dropped
    raise_line = next(i for i, ln in enumerate(ref_lines) if "raise KeyError" in ln)
    want = [ln for i, ln in enumerate(ref_lines) if i not in dropped]
    want[want.index(ref_lines[raise_line])] = (
        '        raise KeyError(f"arch {arch!r} is unknown or not ported yet; '
        'ported: {sorted(_ALIASES)}")')
    assert port_lines == want


def test_analysis_copy_leaves_out_only_the_rtl_level_analyses():
    """``core/analysis.py`` once stopped before its RTL-level section
    (activation intervals), which needs the netlist IR of the codegen; with
    the codegen ported it is the reference's file whole (``VERBATIM``), and
    the RTL passes find the analysis they import."""
    assert (PORT / "core/analysis.py").read_bytes() == (REF / "core/analysis.py").read_bytes()
    from repro_torch.core import analysis
    assert "from .codegen import rtl" in (PORT / "core/analysis.py").read_text()
    assert analysis.ActivationIntervalsAnalysis.name == "activation-intervals"


def test_gallery_lists_the_nine_hand_written_designs():
    """The gallery has the reference's twelve entries: the nine hand-written
    designs and the three the frontend traces from PyTorch programs; its
    file is the reference's but for the docstring's word for the programs."""
    assert list(port_gallery.GALLERY) == list(ref_gallery.GALLERY)
    assert len(port_gallery.GALLERY) == 12
    assert sum(not k.startswith("frontend_") for k in port_gallery.GALLERY) == 9
    assert port_gallery.PAPER_BENCHMARKS == ref_gallery.PAPER_BENCHMARKS
    assert (PORT / "core/gallery/__init__.py").read_text() == (
        REF / "core/gallery/__init__.py").read_text().replace(
        "they are jax.numpy\nprograms traced", "they are PyTorch\nprograms traced")


# -- ground rules -------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s]|$)", re.M)


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    return files


def test_port_imports_neither_jax_nor_the_reference_package():
    assert _FORBIDDEN.search("import jax\n") and _FORBIDDEN.search("  from repro.core import ir")
    assert _FORBIDDEN.search("import repro") and not _FORBIDDEN.search("import repro_torch")
    for path in _port_sources():
        hit = _FORBIDDEN.search(path.read_text())
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0).strip()!r}"


def test_every_module_imports_without_a_gpu_toolchain():
    """A fresh interpreter imports the package and every module of it; that
    pulls in neither jax, nor the reference package, nor triton, and needs
    neither nvcc nor a device (kernels build at first use, not at import)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'repro', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/nonexistent"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 35


def _no_cuda_or_skip():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device resolves")


@pytest.mark.parametrize("entry", ["resolve_device", "lower_to_cuda", "lower_to_torch",
                                   "to_tensor", "simulator_for", "run_differential"])
def test_entry_point_without_device_raises_where_there_is_no_cuda(entry):
    """No entry point picks the CPU on the caller's behalf."""
    _no_cuda_or_skip()
    module, name = port_gallery.array_add.build(n=8)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "lower_to_cuda": lambda: lower_to_cuda(module, name),
        "lower_to_torch": lambda: lower_to_torch(module, name),
        "to_tensor": lambda: compat.to_tensor(np.zeros(8), module.get(name).args[0].type.elem),
        "simulator_for": lambda: simulator_for(module, name),
        "run_differential": lambda: run_differential(
            module, name, stack_stimulus(port_gallery.array_add.make_inputs, 4, n=8)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")


def test_building_a_kernel_without_nvcc_raises():
    """No silent substitute for a kernel that cannot be built."""
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load_library("never_built", "// no compiler here\n")
    assert _build.source_hash("a") != _build.source_hash("b")
    assert _build.build_dir() == ROOT / "build" / "repro_torch"


def test_a_source_queued_twice_builds_once(tmp_path, monkeypatch):
    """Two callables of one design may both be queued for a parallel build:
    they share one compiler run and one temporary file."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:/usr/bin:/bin")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "out")
    first = _build.start_build("twice", "// queued twice\n")
    try:
        assert _build.start_build("twice", "// queued twice\n") is first
        assert first.proc is not None and first.proc.wait() == 0
        assert _build.start_build("twice", "// another text\n") is not first
    finally:
        for pending in list(_build._pending.values()):
            pending.proc.wait()
        _build._pending.clear()


def test_chip_smoke_fails_without_a_device_and_prints_no_result():
    _no_cuda_or_skip()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == "" and "no CUDA device" in out.stderr


def test_quickstart_runs_on_the_cpu_when_asked():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--lanes", "4"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "mismatched delay (0 vs 1)" in out.stdout         # the Fig. 1 diagnostic
    assert "RTL differential check on 4 vectors" in out.stdout
    assert out.stdout.rstrip().endswith("quickstart OK")


def test_hir_to_cuda_example_runs_on_the_cpu_when_asked():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "hir_to_cuda.py"), "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "match the oracle" in out.stdout and "mismatched delay (2 vs 3)" in out.stdout
    assert out.stdout.rstrip().endswith("hir_to_cuda OK")


def test_package_states_its_contract():
    assert "raise" in repro_torch.__doc__ and "device=" in repro_torch.__doc__
