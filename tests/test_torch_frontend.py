"""The port's frontend (a restricted integer PyTorch program traced into a
scheduled HIR design) on the CPU: the twin of every test of
``tests/core/test_frontend.py``, run against the port, and three holds on
the live reference, whose own tracer does not run under the installed jax
(ROADMAP R1):

* the aten graph of each workload maps onto the primitive sequence of the
  reference's ``jax.make_jaxpr`` of the same workload;
* the port-traced module, printed and parsed by the *reference's* parser,
  gives the port's results through the reference's simulator, JAX lowering,
  Verilog emission, resource report and ``run_differential``;
* (in ``test_torch_rtl.py``) its netlists equal the committed
  ``tests/goldens/frontend_*`` files byte for byte.
"""

from __future__ import annotations

import ast
import inspect
import re
from pathlib import Path

import jax
import jax.extend.core as jax_core
import numpy as np
import pytest
import torch

from repro.core.codegen import generate_verilog as ref_generate_verilog
from repro.core.codegen import report_design as ref_report_design
from repro.core.codegen import sim as ref_sim
from repro.core.frontend import workloads as ref_workloads
from repro.core.lower import lower_to_jax as ref_lower_to_jax
from repro.core.lower import simulate as ref_simulate
from repro.core.parser import parse as ref_parse
from repro.core.passes import run_pipeline as ref_run_pipeline
from repro.core.printer import print_module as ref_print_module

from repro_torch.core.codegen import generate_verilog, report_design
from repro_torch.core.codegen import sim as rsim
from repro_torch.core.frontend import (
    FRONTEND_WORKLOADS,
    FrontendError,
    SUPPORTED_PRIMITIVES,
    UnsupportedPrimitiveError,
    trace,
)
from repro_torch.core.frontend import tracer
from repro_torch.core.gallery import GALLERY
from repro_torch.core.hls import erase_schedule, hls_compile
from repro_torch.core.hls.dse import (
    DSEConfig,
    explore_design,
    fingerprint_module,
)
from repro_torch.core.lower import lower_to_torch, simulate
from repro_torch.core.parser import parse
from repro_torch.core.passes import run_pipeline
from repro_torch.core.printer import print_module

ROOT = Path(__file__).resolve().parent.parent
N_VECTORS = 256
HIERARCHIES = ["inline", "modules"]


# ---------------------------------------------------------------------------
# structure: build / round-trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FRONTEND_WORKLOADS))
def test_traced_module_prints_and_parses(name):
    mod, entry = FRONTEND_WORKLOADS[name].build()
    assert entry == name
    text = print_module(mod)
    again = parse(text)
    assert print_module(again) == text


@pytest.mark.parametrize("name", sorted(FRONTEND_WORKLOADS))
def test_traced_module_is_scheduled(name):
    # every op the scheduler touches carries a concrete start time
    mod, _ = FRONTEND_WORKLOADS[name].build()
    text = print_module(mod)
    assert "offset ?" not in text


def test_frontend_workloads_registered_in_gallery():
    for name in FRONTEND_WORKLOADS:
        assert name in GALLERY
        assert GALLERY[name] is FRONTEND_WORKLOADS[name]


# ---------------------------------------------------------------------------
# differential: traced hardware vs the program's NumPy oracle
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("hierarchy", HIERARCHIES)
@pytest.mark.parametrize("name", sorted(FRONTEND_WORKLOADS))
def test_traced_differential(name, hierarchy):
    wl = FRONTEND_WORKLOADS[name]
    mod, entry = wl.build()
    batch = rsim.stack_stimulus(wl.make_inputs, N_VECTORS, base_seed=7)
    rep = rsim.run_differential(mod, entry, batch, kernel=name,
                                hierarchy=hierarchy, oracle=wl.oracle,
                                oracle_nargs=len(batch) - 1, device="cpu")
    assert rep.ok, (name, hierarchy, rep.mismatches[:5])
    assert rep.n_vectors == N_VECTORS
    assert rep.oracle_ok is True
    assert rep.passes_ok and all(rep.passes_ok.values()), rep.passes_ok


@pytest.mark.parametrize("name", sorted(FRONTEND_WORKLOADS))
def test_traced_differential_smoke(name):
    # fast-lane version of the matrix above: 16 vectors, inline hierarchy
    wl = FRONTEND_WORKLOADS[name]
    mod, entry = wl.build()
    batch = rsim.stack_stimulus(wl.make_inputs, 16, base_seed=3)
    rep = rsim.run_differential(mod, entry, batch, kernel=name,
                                oracle=wl.oracle,
                                oracle_nargs=len(batch) - 1, device="cpu")
    assert rep.ok and rep.oracle_ok, (name, rep.mismatches[:5])


def test_matmul_tile_knob_preserves_semantics():
    # tile divides n -> banked accumulator; tile=1 -> plain nest; same math
    wl = FRONTEND_WORKLOADS["frontend_matmul"]
    a, b, _ = wl.make_inputs(seed=42)
    want = wl.oracle(a, b)
    for tile in (1, 2, 4):
        mod, entry = wl.build(tile=tile)
        args = [a.copy(), b.copy(), np.zeros_like(want)]
        simulate(mod, entry, args)
        np.testing.assert_array_equal(args[-1], want, err_msg=f"tile {tile}")


# ---------------------------------------------------------------------------
# error contract
# ---------------------------------------------------------------------------


def test_unsupported_primitive_names_itself():
    with pytest.raises(UnsupportedPrimitiveError, match="argmax"):
        trace(lambda x: torch.argmax(x), [(8,)], name="bad")
    with pytest.raises(UnsupportedPrimitiveError, match="sort"):
        trace(lambda x: torch.sort(x).values, [(8,)], name="bad")


def test_unsupported_primitive_lists_supported_set():
    with pytest.raises(UnsupportedPrimitiveError,
                       match="supported primitives are"):
        trace(lambda x: torch.sort(x).values, [(8,)], name="bad")
    assert "mm.default" in SUPPORTED_PRIMITIVES
    assert "sum.default" in SUPPORTED_PRIMITIVES


def test_float_program_rejected_at_trace_time():
    with pytest.raises(FrontendError, match="integer-only"):
        trace(lambda x: x.to(torch.float32) * 1.5, [(8,)], name="bad")


def test_unsupported_error_is_a_not_implemented_error():
    # callers can catch the stdlib category without importing the frontend
    assert issubclass(UnsupportedPrimitiveError, FrontendError)
    assert issubclass(FrontendError, NotImplementedError)


@pytest.mark.parametrize("program, match", [
    (lambda a, b: torch.div(a, b, rounding_mode="trunc"), "floor division"),
    (lambda a, b: a / b, "integer-only"),
    (lambda a, b: torch.sum(a) + b, "integer-only"),            # int64 without dtype=
    (lambda a, b: torch.cumsum(a, 0) + b, "integer-only"),
    (lambda a, b: a + torch.tensor([1, 2, 3, 4, 5, 6, 7, 8], dtype=torch.int32),
     "array-valued constants"),
    (lambda a, b: torch.where(a > b, a, 0.5), "integer-only"),
])
def test_division_and_promotion_are_refused_not_mislowered(program, match):
    """HIR ``div`` is floor division: truncation and true division raise
    rather than lower onto it; a reduction that promotes to int64, a float
    literal and an array constant raise as the reference's float rule does."""
    with pytest.raises(FrontendError, match=match):
        trace(program, [(8,), (8,)], name="bad")


def test_floor_division_and_implicit_broadcast_lower_exactly():
    """``//`` and ``torch.div(..., rounding_mode="floor")`` on negative
    operands, and operands torch broadcasts implicitly (a column against a
    row, a rank-0 reduction against a vector), simulate to the program's
    own result."""
    def fn(a, col, row):
        q = torch.div(a, col, rounding_mode="floor") + (a // row)
        return q - torch.amin(a) + torch.clamp(col * row, -50, 50)

    rng = np.random.default_rng(3)
    a = rng.integers(-1000, 1000, (4, 6))
    col = rng.choice([-7, -3, 2, 5], (4, 1))
    row = rng.choice([-4, -1, 3, 9], (1, 6))
    mod, entry = trace(fn, [(4, 6), (4, 1), (1, 6)], name="floordiv")
    want = fn(*(torch.as_tensor(x, dtype=torch.int32) for x in (a, col, row))).numpy()
    args = [a, col, row, np.zeros((4, 6), np.int64)]
    simulate(mod, entry, args)
    np.testing.assert_array_equal(args[-1], want)
    got = lower_to_torch(mod, entry, device="cpu")(a, col, row, np.zeros((4, 6), np.int64))["out"]
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def _spellings_elementwise(x, y):
    s = torch.clamp_min(x, -3) + torch.clamp_max(y, x) + x.clone() + (x > y).int()
    s = s + torch.tensor(2, dtype=torch.int32) + (5 - x) - torch.maximum(x, y) * torch.minimum(x, y)
    b = (x & 6) ^ (y | 1) ^ (x & y) ^ (x | y) ^ (y ^ 3)
    sh = (x << 3) + (y >> 1) + (x >> (y & 3)) + (x << (y & 3)) + (3 << (y & 3)) + (64 >> (x & 3))
    c = (x < y).int() + (x <= 1).int() + (x == y).int() + (x != 0).int() + (x >= y).int()
    return torch.where(x > 0, s, -b) + sh + c - (-x)


def _spellings_reductions(a, v):
    col = torch.sum(a, 0, dtype=torch.int32)
    return col * torch.amin(a) + torch.max(a) - torch.min(v) + torch.cumsum(v, 0, dtype=torch.int32)


@pytest.mark.parametrize("program, shapes", [
    (_spellings_elementwise, [(8,), (8,)]),
    (_spellings_reductions, [(3, 8), (8,)]),
])
def test_every_aten_spelling_lowers_to_the_program_s_result(program, shapes):
    """Each operator of the table as torch spells it (``.Scalar`` and
    ``.Tensor`` overloads, ``rsub``, ``__lshift__``/``__rshift__``,
    ``clamp_min``/``clamp_max``, comparisons to int, a tensor constant, the
    reductions over all or some dims): the traced design, simulated, gives
    the program's own int32 result."""
    names = {tracer._Graph.op(n) for n in tracer.equations(program, shapes).gm.graph.nodes
             if n.op == "call_function"}
    assert names <= set(SUPPORTED_PRIMITIVES)
    rng = np.random.default_rng(5)
    ins = [rng.integers(-50, 50, s) for s in shapes]
    mod, entry = trace(program, shapes, name="spellings")
    want = program(*(torch.as_tensor(x, dtype=torch.int32) for x in ins)).numpy()
    args = ins + [np.zeros(want.shape, np.int64)]
    simulate(mod, entry, args)
    np.testing.assert_array_equal(args[-1], want)


# ---------------------------------------------------------------------------
# cache keying: fingerprints must separate what the scheduler must not share
# ---------------------------------------------------------------------------


def test_trace_fingerprint_deterministic():
    m1, _ = FRONTEND_WORKLOADS["frontend_scan"].build()
    m2, _ = FRONTEND_WORKLOADS["frontend_scan"].build()
    assert fingerprint_module(erase_schedule(m1)) == \
        fingerprint_module(erase_schedule(m2))


def test_trace_fingerprint_varies_with_shape_and_tile():
    wl = FRONTEND_WORKLOADS["frontend_matmul"]
    base = fingerprint_module(erase_schedule(wl.build()[0]))
    other_shape = fingerprint_module(erase_schedule(wl.build(m=8, k=8, n=8)[0]))
    other_tile = fingerprint_module(erase_schedule(wl.build(tile=4)[0]))
    assert base != other_shape
    assert base != other_tile


def test_gallery_fingerprints_all_distinct():
    prints = {name: fingerprint_module(erase_schedule(gal.build()[0]))
              for name, gal in GALLERY.items()}
    assert len(prints) == 12
    assert len(set(prints.values())) == len(prints), prints


def test_hls_compile_cache_hits_and_misses():
    wl = FRONTEND_WORKLOADS["frontend_scan"]
    um = erase_schedule(wl.build()[0])
    res1, _ = hls_compile(um, entry="frontend_scan")
    res2, _ = hls_compile(erase_schedule(wl.build()[0]),
                          entry="frontend_scan")
    assert res2.from_cache  # identical retrace -> whole-module cache hit
    um3 = erase_schedule(wl.build(n=16)[0])
    res3, _ = hls_compile(um3, entry="frontend_scan")
    assert not res3.from_cache  # different trace shape -> different key


# ---------------------------------------------------------------------------
# downstream integration: compile + DSE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FRONTEND_WORKLOADS))
def test_traced_module_compiles_to_rtl(name):
    wl = FRONTEND_WORKLOADS[name]
    um = erase_schedule(wl.build()[0])
    res, netlists = hls_compile(um, entry=name, cache=False)
    assert name in netlists
    assert netlists[name].text.strip()


@pytest.mark.slow
def test_traced_module_explores_design_space():
    wl = FRONTEND_WORKLOADS["frontend_scan"]
    mod, entry = wl.build()
    ins = wl.make_inputs(seed=5)
    exp = wl.oracle(*ins[:2])
    space = [DSEConfig(clock_ns=10.0), DSEConfig(clock_ns=5.0)]
    res = explore_design(mod, space, entry=entry, inputs=ins, expected=exp, device="cpu")
    assert len(res.points) == len(space)
    assert all(p.verified for p in res.points), \
        [p.error for p in res.points if not p.verified]
    assert res.front


# ---------------------------------------------------------------------------
# against the live reference
# ---------------------------------------------------------------------------


def _reference_program(name):
    """The jax.numpy program and input shapes the reference workload hands
    to its tracer (caught at the call, as the tracer itself cannot run)."""
    from repro.core.frontend import tracer as ref_tracer

    seen = {}

    def catch(fn, in_shapes, **kw):
        seen.update(fn=fn, in_shapes=in_shapes)
        raise StopIteration

    real, ref_tracer.trace = ref_tracer.trace, catch
    try:
        with pytest.raises(StopIteration):
            ref_workloads.FRONTEND_WORKLOADS[name].build()
    finally:
        ref_tracer.trace = real
    return seen["fn"], seen["in_shapes"]


def _jaxpr_primitives(jaxpr, consts):
    """Primitive names of a jaxpr in order, nested ``jit``/``pjit`` calls
    flattened, leaving out equations on constants only (a literal's
    ``convert_element_type`` and ``broadcast_in_dim``), which emit no
    hardware."""
    out = []
    for eqn in jaxpr.eqns:
        ins_const = all(isinstance(v, jax_core.Literal) or v in consts for v in eqn.invars)
        if eqn.primitive.name in ("jit", "pjit"):
            inner = eqn.params["jaxpr"].jaxpr
            inner_consts = {iv for iv, v in zip(inner.invars, eqn.invars)
                            if isinstance(v, jax_core.Literal) or v in consts}
            out += _jaxpr_primitives(inner, inner_consts)
        elif ins_const:
            consts.update(eqn.outvars)
        else:
            out.append(eqn.primitive.name)
    return out


@pytest.mark.parametrize("name", sorted(FRONTEND_WORKLOADS))
def test_aten_graph_maps_onto_the_reference_jaxpr(name):
    """The primitives the port's aten graph maps onto are the reference's
    jaxpr's, one for one and in order."""
    fn, in_shapes = _reference_program(name)
    closed = jax.make_jaxpr(fn)(*[np.zeros(tuple(s), np.int32) for s in in_shapes])
    want = _jaxpr_primitives(closed.jaxpr, set())

    port_fn = {}
    real = tracer.trace
    tracer.trace = lambda fn, in_shapes, **kw: port_fn.update(fn=fn, in_shapes=in_shapes)
    try:
        FRONTEND_WORKLOADS[name].build()
    finally:
        tracer.trace = real
    assert [tuple(s) for s in port_fn["in_shapes"]] == [tuple(s) for s in in_shapes]
    graph = tracer.equations(port_fn["fn"], port_fn["in_shapes"])
    assert [e.primitive.name for e in graph.eqns] == want
    assert len(want) == {"frontend_matmul": 1, "frontend_softmax_row": 13,
                         "frontend_scan": 3}[name]


@pytest.mark.parametrize("name", sorted(FRONTEND_WORKLOADS))
def test_port_traced_module_runs_the_same_through_the_reference(name):
    """``compat.module_from_reference_text`` the other way: the port's traced
    module, parsed by the reference, gives the port's results in the
    reference's simulator, JAX lowering, optimizer, Verilog, resource report
    and ``run_differential`` (its NumPy backend) on the same stimulus."""
    wl = FRONTEND_WORKLOADS[name]
    pm, entry = wl.build()
    text = print_module(pm)
    rm = ref_parse(text)
    assert ref_print_module(rm) == text

    inputs = wl.make_inputs(seed=11)
    n_in = len(inputs) - 1
    want = wl.oracle(*inputs[:n_in])
    port_args = [np.array(x, copy=True) for x in inputs]
    ref_args = [np.array(x, copy=True) for x in inputs]
    simulate(pm, entry, port_args)
    ref_simulate(rm, entry, ref_args)
    np.testing.assert_array_equal(port_args[-1], want)
    np.testing.assert_array_equal(ref_args[-1], want)
    got = lower_to_torch(pm, entry, device="cpu")(*inputs)["out"]
    ref_got = ref_lower_to_jax(rm, entry)(*inputs)["out"]
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(np.asarray(ref_got).astype(np.int64), want)

    batch = rsim.stack_stimulus(wl.make_inputs, 32, base_seed=7)
    rep = rsim.run_differential(pm, entry, batch, kernel=name, oracle=wl.oracle,
                                oracle_nargs=n_in, device="cpu")
    ref_rep = ref_sim.run_differential(rm, entry, batch, kernel=name, backend="numpy",
                                       oracle=wl.oracle, oracle_nargs=n_in)
    assert rep.ok and ref_rep.ok and rep.oracle_ok and ref_rep.oracle_ok
    assert (rep.n_vectors, rep.cycles) == (ref_rep.n_vectors, ref_rep.cycles)
    assert rep.passes_ok == ref_rep.passes_ok and all(rep.passes_ok.values())

    assert run_pipeline(pm) == ref_run_pipeline(rm)
    assert _canon(print_module(pm)) == _canon(ref_print_module(rm))
    for mode in HIERARCHIES:
        mods = generate_verilog(pm, entry, hierarchy=mode)
        ref_mods = ref_generate_verilog(rm, entry, hierarchy=mode)
        assert {n: m.text for n, m in mods.items()} == {n: m.text for n, m in ref_mods.items()}
        assert report_design(mods, entry).as_dict() == ref_report_design(ref_mods, entry).as_dict()


# ---------------------------------------------------------------------------
# what the port keeps of the reference's text
# ---------------------------------------------------------------------------


def _canon(text):
    """IR text with anonymous value names (``%v<id>``, from a counter each
    package keeps per process) renumbered in order of first appearance."""
    names = {}
    return re.sub(r"%v\d+(?:_\d+)?\b",
                  lambda m: names.setdefault(m.group(0), f"%v{len(names)}"), text)


def _defs(path):
    text = path.read_text()
    lines = text.splitlines()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef, ast.Assign, ast.AnnAssign)):
            key = node.name if hasattr(node, "name") else ast.unparse(
                node.targets[0] if isinstance(node, ast.Assign) else node.target)
            out[key] = "\n".join(lines[node.lineno - 1:node.end_lineno])
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, ast.FunctionDef):
                        out[f"{node.name}.{m.name}"] = "\n".join(
                            lines[m.lineno - 1:m.end_lineno])
    return out


def test_tracer_keeps_the_reference_emitters_verbatim():
    """Values, emitters, buffer tags and the schedule hand-off are the
    reference's text: only the jaxpr walk is replaced (``val``,
    ``eval_eqn``, the walkers, ``trace``'s graph side, ``_check_int``)."""
    ref = _defs(ROOT / "src/repro/core/frontend/tracer.py")
    port = _defs(ROOT / "src/repro_torch/core/frontend/tracer.py")
    kept = ["_Const", "_Buf", "_Alloc", "_ew", "_cmp", "_minmax", "_ELEMENTWISE",
            "_IDENTITY", "_REDUCE_INIT", "_Tracer.__init__", "_Tracer.now", "_Tracer.tick",
            "_Tracer.arith", "_Tracer.loop", "_Tracer.nest", "_Tracer.new_buf", "_Tracer.elem",
            "_Tracer.lift_const", "_Tracer.eval_broadcast", "_Tracer.eval_elementwise",
            "_Tracer.eval_reduce", "_Tracer.eval_cumsum", "_Tracer.eval_dot_general"]
    for key in kept:
        assert port[key] == ref[key], key
    assert inspect.signature(trace) == inspect.signature(_reference_trace())
    body = (ROOT / "src/repro_torch/core/frontend/tracer.py").read_text()
    assert "um = erase_schedule(b.module)\n    if schedule:\n        hls_schedule(" in body


def _reference_trace():
    from repro.core.frontend import tracer as ref_tracer
    return ref_tracer.trace


def test_workloads_keep_the_reference_oracles_inputs_and_keywords():
    """``oracle()``, ``make_inputs()``, the constants and ``build()``'s
    keywords are the reference's; only the programs are written in torch."""
    ref = _defs(ROOT / "src/repro/core/frontend/workloads.py")
    port = _defs(ROOT / "src/repro_torch/core/frontend/workloads.py")
    for key in ("_FP_BITS", "_NEG_INF", "_SH_MAX", "FRONTEND_WORKLOADS"):
        assert port[key] == ref[key], key
    for name in FRONTEND_WORKLOADS:
        for fn in ("oracle", "make_inputs"):
            assert port[f"{name}.{fn}"] == ref[f"{name}.{fn}"], (name, fn)
        assert inspect.signature(FRONTEND_WORKLOADS[name].build) == \
            inspect.signature(ref_workloads.FRONTEND_WORKLOADS[name].build)
