"""The port's RTL simulator piece by piece against the reference, on the CPU:
the value semantics of the tape (floor division, x/0, shift clamps, width
limits) on both simulators, the lifting of an unbatched run, the stimulus
streams, the DSE oracle, and the simulator's generated kernel (S1) built for
the host with a C++ compiler and held bit for bit to the plain version.

A CUDA kernel has no CPU mode, but S1's per-lane body is plain C++
(``__host__ __device__``): a host build runs it lane by lane with the state
laid out as on the card.  Those tests skip where there is no ``g++``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro.core import gallery as ref_gallery
from repro.core import ir as ref_ir
from repro.core.codegen import rtl as ref_rtl
from repro.core.codegen import sim as ref_sim
from repro.core.hls import dse as ref_dse

from repro_torch.core import gallery as port_gallery
from repro_torch.core import ir as port_ir
from repro_torch.core.codegen import rtl as port_rtl
from repro_torch.core.codegen import sim as port_sim
from repro_torch.core.codegen.sim_cuda import LANES_PER_BLOCK, SMEM_LANE_BYTES, SimKernel
from repro_torch.core.hls import dse as port_dse
from test_torch_gpu import (RTL_KERNELS, assert_same_sim_result, conflict_probe, rtl_design,
                            rtl_stimulus)

CPU = torch.device("cpu")


# -- value semantics -----------------------------------------------------------------


def _both(expr_of, widths, env, lanes):
    """An expression's value on the port's tape (``_TorchOps``) and on the
    reference's (``_NumpyOps``), the same environment given to each."""
    got, _ = port_sim._compile_expr(expr_of(port_rtl), widths)
    want, _ = ref_sim._compile_expr(expr_of(ref_rtl), widths)
    tenv = {k: torch.as_tensor(v) for k, v in env.items()}
    return (np.asarray(got(tenv, port_sim._TorchOps(lanes, CPU))),
            np.asarray(want(env, ref_sim._NumpyOps(lanes))))


def test_division_is_floor_and_by_zero_is_zero():
    widths = {"a": 8, "b": 8}
    env = {"a": np.array([0xF9, 0xF9, 7, 7], dtype=np.int64),      # -7,-7,7,7
           "b": np.array([2, 0, 2, 0xFE], dtype=np.int64)}         # 2,0,2,-2
    got, want = _both(lambda r: r.Binop("/", r.Signed(r.Ref("a")), r.Signed(r.Ref("b")),
                                        width=8), widths, env, 4)
    assert (got & 0xFF).tolist() == [(-4) & 0xFF, 0, 3, (-4) & 0xFF]
    np.testing.assert_array_equal(got, want)


def test_shift_clamp_semantics():
    widths = {"a": 8, "s": 8}
    env = {"a": np.array([1, 1, 0xFF, 0x80], dtype=np.int64),
           "s": np.array([3, 200, 1, 0xFF], dtype=np.int64)}
    for op in ("<<", ">>"):
        got, want = _both(lambda r: r.Binop(op, r.Ref("a"), r.Ref("s"), width=8), widths, env, 4)
        np.testing.assert_array_equal(got, want)
    got, _ = _both(lambda r: r.Binop("<<", r.Ref("a"), r.Ref("s"), width=8), widths, env, 4)
    assert (got & 0xFF).tolist()[:3] == [8, 0, 0xFE]
    # a negative count: 0 to the left, the sign to the right, on both
    for op in ("<<", ">>"):
        got, want = _both(lambda r: r.Binop(op, r.Signed(r.Ref("a")), r.Signed(r.Ref("s")),
                                            width=8), widths, env, 4)
        np.testing.assert_array_equal(got, want)


def test_constant_sub_expressions_stay_scalars_on_both():
    """Sub-expressions of constants come back as Python ints on both tapes,
    and ``where``/``b2i``/``minimum`` take them."""
    ops = port_sim._TorchOps(3, CPU)
    assert ops.where(True, 5, torch.zeros(3, dtype=torch.int64)) == 5
    assert ops.b2i(3 > 2) == 1 and ops.minimum(70, 63) == 63
    fn, w = port_sim._compile_expr(port_rtl.Binop("/", port_rtl.Const(7, 4),
                                                   port_rtl.Const(0, 4)), {})
    assert fn({}, ops) == 0 and w == 4
    assert ops.stack([1, torch.tensor([0, 1, 0])]).tolist() == [[1, 0], [1, 1], [1, 0]]


def test_wide_nets_rejected():
    with pytest.raises(port_sim.RTLSimError):
        port_sim._mask_of(64)
    assert port_sim._mask_of(63) == ref_sim._mask_of(63)


def test_unbatched_run_lifts_to_single_lane():
    mod, entry = port_gallery.array_add.build(n=8)
    sim, prepared = port_sim.simulator_for(mod, entry, device="cpu")
    args = port_gallery.array_add.make_inputs(n=8, seed=9)
    res = sim.run(args, port_sim.probe_cycles(prepared, entry, args))
    assert res.batch == 1
    np.testing.assert_array_equal(res.arrays[2][0], port_gallery.array_add.oracle(*args[:2]))


def test_a_cuda_backend_on_the_cpu_is_refused():
    mod, entry = port_gallery.array_add.build(n=8)
    with pytest.raises(port_sim.RTLSimError, match="cuda backend requested"):
        port_sim.simulator_for(mod, entry, backend="cuda", device="cpu")
    sim, _ = port_sim.simulator_for(mod, entry, backend="numpy")
    assert sim.device is None and sim.backend == "numpy"


# -- stimulus and the DSE oracle -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_fold_in_stimulus_equals_the_reference(seed):
    """The reference runs its SeedSequence streams where its JAX backend
    does not import (ROADMAP R8), as here."""
    if ref_sim.HAVE_JAX:
        pytest.skip("the reference draws jax fold_in streams where its jax backend imports")
    widths = [1, 8, 16, 33, 63, 64]
    got = port_sim.fold_in_stimulus(widths, 33, seed=seed)
    want = ref_sim.fold_in_stimulus(widths, 33, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a lane's values do not depend on how many lanes are drawn
    np.testing.assert_array_equal(port_sim.fold_in_stimulus(widths, 5, seed=seed)[3], got[3][:5])


def test_stack_stimulus_equals_the_reference():
    got = port_sim.stack_stimulus(port_gallery.array_add.make_inputs, 5, base_seed=1, n=8)
    want = ref_sim.stack_stimulus(ref_gallery.array_add.make_inputs, 5, base_seed=1, n=8)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.fixture
def fresh_oracle_caches():
    for dse in (port_dse, ref_dse):
        dse.clear_oracle_cache()
    yield
    for dse in (port_dse, ref_dse):
        dse.clear_oracle_cache()


@pytest.mark.parametrize("kernel", sorted(k for k in port_gallery.GALLERY
                                           if k != "mac" and not k.startswith("frontend_")))
def test_oracle_expected_equals_the_reference(kernel, fresh_oracle_caches):
    """The port's DSE oracle (the functional PyTorch lowering) against the
    reference's (the JAX lowering) on each array design of the gallery, at
    the sizes of the reference's simulator test."""
    bkw, ikw = RTL_KERNELS[kernel][:2]
    pm, entry = port_gallery.GALLERY[kernel].build(**bkw)
    rm, _ = ref_gallery.GALLERY[kernel].build(**bkw)
    inputs = port_gallery.GALLERY[kernel].make_inputs(seed=4, **ikw)
    got = port_dse.oracle_expected(pm, entry, inputs, device="cpu")
    want = ref_dse.oracle_expected(rm, entry, inputs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64))
    again = port_dse.oracle_expected(pm, entry, inputs, device="cpu")   # memoized, a private copy
    assert port_dse.ORACLE_STATS["out_hits"] >= 1 and again is not got


def test_dse_oracle_without_a_device_raises_where_there_is_no_cuda(fresh_oracle_caches):
    """The DSE oracle resolves its device as every entry point does: it
    never picks the CPU on the caller's behalf (skips on a machine with a
    card)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device resolves")
    pm, entry = port_gallery.array_add.build(n=8)
    inputs = port_gallery.array_add.make_inputs(n=8, seed=4)
    port_dse.oracle_expected(pm, entry, inputs, device="cpu")      # cached for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_dse.oracle_expected(pm, entry, inputs)
    batch = port_sim.stack_stimulus(port_gallery.array_add.make_inputs, 4, base_seed=50, n=8)
    res = port_dse.explore_design(pm, port_dse.design_space(pipeline=(True,)), entry=entry,
                                  inputs=inputs, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_dse.sim_verify_front(pm, res, entry=entry, args_batch=batch)


def test_explore_and_sim_verify_front_equal_the_reference(fresh_oracle_caches):
    """Twin of the reference's batched front verification
    (``tests/core/test_sim_verify_cache.py``): the port's oracle and
    simulator on the CPU verify the same front on 32 vectors."""
    space = port_dse.design_space(pipeline=(True, False))
    inputs = port_gallery.array_add.make_inputs(n=8, seed=2)
    pm, entry = port_gallery.array_add.build(n=8)
    port_res = port_dse.explore_design(pm, space, entry=entry, inputs=inputs, device="cpu")
    batch = port_sim.stack_stimulus(port_gallery.array_add.make_inputs, 32, base_seed=50, n=8)
    n_port = port_dse.sim_verify_front(pm, port_res, entry=entry, args_batch=batch,
                                       device="cpu")
    rm, _ = ref_gallery.array_add.build(n=8)
    ref_space = ref_dse.design_space(pipeline=(True, False))
    ref_res = ref_dse.explore_design(rm, ref_space, entry=entry, inputs=inputs)
    n_ref = ref_dse.sim_verify_front(rm, ref_res, entry=entry, args_batch=batch)
    assert n_port == n_ref == len(port_res.front) > 0
    assert [p.as_dict() for p in port_res.front] == [p.as_dict() for p in ref_res.front]
    assert all(p.batch_verified is True and p.batch_vectors == 32 for p in port_res.front)


# -- the simulator's kernel, built for the host -------------------------------------------


def _host_library(source, stem, tmp_path):
    """``source`` built with g++ for the host, loaded."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's per-lane body for the host")
    src = tmp_path / f"{stem}.cpp"
    src.write_text(source)
    lib = tmp_path / f"lib{stem}.so"
    out = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[:2000]
    return ctypes.CDLL(str(lib))


def _host_kernel(sim, tmp_path, place=None):
    """S1's source built with g++ for the host: ``run(args, cycles, B,
    trace)`` -> (final, ys), as ``SimKernel.run`` gives them on the card,
    with the state buffers laid out and collected by the same tensor ops
    on the CPU, over blocks of 32 lanes as on the card.  ``place`` forces
    the memories' and rings' placement."""
    kernel = SimKernel(sim, place=place)
    fn = _host_library(kernel.source, kernel.stem, tmp_path).rtlsim_host
    fn.argtypes = [ctypes.c_void_p] * (len(kernel.layout.buffers) + 1) + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int

    def run(args, T, B, trace):
        bufs = kernel.buffers(sim, args, B, torch.device("cpu"))
        tr = torch.zeros((T, len(kernel.trace_names), B), dtype=torch.int64) if trace else None
        rc = fn(*kernel.pointers(bufs), None if tr is None else tr.data_ptr(), B, T)
        assert rc == 0
        ys = {} if tr is None else {n: tr[:, i].numpy() for i, n in enumerate(kernel.trace_names)}
        return kernel.collect(sim, bufs), ys

    return run


def _host_result(sim, run, batch, cycles, trace=True):
    B = int(np.asarray(batch[0]).shape[0])
    final, ys = run(batch, cycles, B, trace)
    return sim._collect(final, ys, B, cycles, False, trace)


@pytest.mark.parametrize("hierarchy", ["inline", "modules"])
@pytest.mark.parametrize("kernel", ["gemm", "conv2d", "histogram"])
def test_kernel_body_on_the_host_equals_the_plain_version(kernel, hierarchy, tmp_path):
    module, entry = rtl_design(kernel)
    batch = rtl_stimulus(kernel, 16)
    sim, prepared = port_sim.simulator_for(module, entry, hierarchy=hierarchy, device="cpu")
    cycles = port_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
    got = _host_result(sim, _host_kernel(sim, tmp_path), batch, cycles)
    assert_same_sim_result(got, sim.run(batch, cycles, batched=True, trace=True,
                                         check_conflicts=False))


def test_kernel_body_on_the_host_counts_conflicts_per_lane(tmp_path):
    sim, cycles = conflict_probe("torch", "cpu")
    batch = rtl_stimulus("mac", 40)
    got = _host_result(sim, _host_kernel(sim, tmp_path), batch, cycles)
    want = sim.run(batch, cycles, batched=True, trace=True, check_conflicts=False)
    assert_same_sim_result(got, want)
    np.testing.assert_array_equal(got.conflicts, batch[0] & 1)


def test_kernel_body_rings_and_untraced_runs(tmp_path):
    """A large design's deep shift registers and memories, no trace: final
    arrays equal the plain version's and the reference's."""
    module, entry = port_gallery.stencil1d.build(n=64)
    batch = port_sim.stack_stimulus(port_gallery.stencil1d.make_inputs, 8, base_seed=3, n=64)
    sim, prepared = port_sim.simulator_for(module, entry, device="cpu")
    assert SimKernel(sim).layout.rings, "stencil1d has shift registers deeper than 1"
    cycles = port_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
    got = _host_result(sim, _host_kernel(sim, tmp_path), batch, cycles, trace=False)
    assert_same_sim_result(got, sim.run(batch, cycles, batched=True))
    np.testing.assert_array_equal(got.arrays[1][3],
                                  port_gallery.stencil1d.oracle(batch[0][3]))


@pytest.mark.parametrize("hierarchy", ["inline", "modules"])
@pytest.mark.parametrize("kernel", sorted(RTL_KERNELS))
def test_kernel_state_buffers_hold_the_initial_state(kernel, hierarchy):
    """The kernel's buffers, laid out by tensor ops, hold at cycle 0 what
    ``RTLSimulator._init_state`` makes (every ``st32``/``st64`` slot, every
    memory's own buffer, every ring word), each word in 4 bytes where its
    largest value is below 2**32 (every word of these designs, whose nets
    are 32 bits wide or narrower), and ``collect`` reads back what
    ``_collect`` needs of it."""
    module, entry = rtl_design(kernel)
    batch = rtl_stimulus(kernel, 12)
    sim, _ = port_sim.simulator_for(module, entry, hierarchy=hierarchy, device="cpu")
    assert max(sim.widths.values()) <= 32
    k = SimKernel(sim)
    bufs = k.buffers(sim, batch, 12, torch.device("cpu"))
    state = sim._init_state(batch, 12)
    lay = k.layout
    assert [name for name, _, _ in lay.buffers] == list(bufs)
    assert all(b.dtype == torch.int32 for b in bufs.values())
    assert all(b.shape == ((12, n) if name in lay.mem_at else (n, 12))
               for (name, n, _), b in zip(lay.buffers, bufs.values()))
    assert set(lay.slot_bytes) == {4} and all(p.nbytes == 4 for p in lay.mems + lay.rings)
    for i, (key, col) in enumerate(lay.slots):
        want = state[key] if col < 0 else state[key][:, col]
        got = bufs[f"st{8 * lay.slot_bytes[i]}"][lay.slot_row[i]].numpy()
        np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF, want, err_msg=key)
    for p in lay.mems:
        np.testing.assert_array_equal(bufs[p.key].numpy().astype(np.int64) & 0xFFFFFFFF,
                                      state[p.key], err_msg=p.key)
    for p in lay.rings:
        assert not bufs["ring32"][p.row:p.row + p.depth].any() and not state[p.key].any()
    final = k.collect(sim, bufs)
    assert final and all(np.array_equal(v, state[key]) for key, v in final.items())


def test_kernel_state_buffers_refuse_a_wrong_stimulus_shape():
    module, entry = rtl_design("array_add")
    sim, _ = port_sim.simulator_for(module, entry, device="cpu")
    batch = rtl_stimulus("array_add", 4)
    with pytest.raises(port_sim.RTLSimError, match="expected batch shape"):
        SimKernel(sim).buffers(sim, [batch[0][:, :-1]] + batch[1:], 4, torch.device("cpu"))


def _alu_design(rtl, ir, ops, w_in=12, w_out=40):
    """A hand-built netlist: two scalar inputs and one output per operator,
    each over the signed inputs (negative shift counts and divisors too)."""
    m = rtl.RTLModule("alu")
    for p in ("clk", "rst", "t_start"):
        m.add_port(p, "input")
    for i in range(2):
        m.add_port(f"in{i}", "input", w_in)
        m.arg_ports[i] = [(f"in{i}", "input", "data", 0)]
    a, b = rtl.Signed(rtl.Ref("in0")), rtl.Signed(rtl.Ref("in1"))
    for k, op in enumerate(ops):
        m.add_port(f"out{k}", "output", w_out)
        if op == "~":
            e = rtl.Unop("~", a)
        elif op == "mux":
            e = rtl.Mux(rtl.Binop("<", a, b), a, rtl.Binop("-", b, a), w_out)
        elif op == "rep":
            e = rtl.Repeat(3, rtl.Ref("in1"))
        else:
            e = rtl.Binop(op, a, b, width=w_out)
        m.add(rtl.CombAssign(f"out{k}", e))
    func = ir.FuncOp("alu", [ir.IntType(w_in, signed=False)] * 2, ["in0", "in1"])
    return rtl.RTLDesign({"alu": m}, entry="alu"), func


ALU_OPS = ["+", "-", "*", "/", "&", "|", "^", "<<", ">>", "<", "<=", ">", ">=", "==", "!=",
           "&&", "||", "~", "mux", "rep"]


def test_kernel_arithmetic_on_edge_values_equals_both_tapes(tmp_path):
    """Every operator of the generated C++ on values around 0, the extremes
    of a 12-bit input and its shift widths, against ``_TorchOps`` and the
    reference's ``_NumpyOps``."""
    vals = np.array([0, 1, 2, 3, 7, 11, 62, 63, 64, 100, 2047, 2048, 2049, 4094, 4095],
                    dtype=np.int64)
    a, b = (x.ravel() for x in np.meshgrid(vals, vals))
    design, func = _alu_design(port_rtl, port_ir, ALU_OPS)
    sim = port_sim.RTLSimulator(design, func, "alu", backend="torch", device="cpu")
    ref_design, ref_func = _alu_design(ref_rtl, ref_ir, ALU_OPS)
    ref = ref_sim.RTLSimulator(ref_design, ref_func, "alu", backend="numpy")
    got = _host_result(sim, _host_kernel(sim, tmp_path), [a, b], 2)
    plain = sim.run([a, b], 2, batched=True, trace=True)
    assert_same_sim_result(got, plain)
    assert_same_sim_result(plain, ref.run([a, b], 2, batched=True, trace=True))
    assert len(got.trace) == len(ALU_OPS)


def test_kernel_source_is_deterministic():
    """Two builds of one design give one source text, so the library built
    ahead is the one the run finds."""
    texts = set()
    for _ in range(2):
        module, entry = rtl_design("gemm_shared")
        sim, _ = port_sim.simulator_for(module, entry, hierarchy="modules", device="cpu")
        texts.add(SimKernel(sim).source)
    assert len(texts) == 1
    (text,) = texts
    assert "__global__" in text and "rtlsim_host" in text and "__host__ __device__" in text


# -- the generator's 32-bit words and nodes, and where it puts the state ------------------

TREE_WIDTHS = [1, 8, 31, 32, 33, 63]
TREE_OPS = ["+", "-", "*", "/", "<<", ">>", "<", "<=", ">", ">=", "==", "!=", "&", "|", "^",
            "signed", "mux", "repeat", "~"]


def _edge_values(w):
    """0, all ones, the sign bit, 2**31, 2**32 - 1 and their neighbours,
    as patterns of width ``w``."""
    m = (1 << w) - 1
    vals = {0, 1, m, m - 1, 1 << (w - 1), (1 << (w - 1)) - 1, 1 << 31, (1 << 31) - 1,
            (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 5, 63, 64}
    return sorted(v & m for v in vals)


def _random_tree(rng, depth):
    """A nested-tuple expression over the inputs ``in0..in5`` (widths
    ``TREE_WIDTHS``), with its static width as ``sim._compile_expr`` gives
    it: (tree, width)."""
    if depth == 0 or rng.random() < 0.15:
        if rng.random() < 0.75:
            i = int(rng.integers(len(TREE_WIDTHS)))
            return ("ref", i), TREE_WIDTHS[i]
        w = int(rng.choice(TREE_WIDTHS))
        return ("const", int(rng.choice(_edge_values(w))), w), w
    op = str(rng.choice(TREE_OPS))
    if op == "/":                      # leaves only: no INT64_MIN / -1 on the tapes
        a, wa = _random_tree(rng, 0)
        b, wb = _random_tree(rng, 0)
        if rng.random() < 0.5:
            b, wb = ("signed", b), wb
        return ("bin", "/", a, b), max(wa, wb)
    if op in ("<<", ">>") and rng.random() < 0.5:
        a, wa = _random_tree(rng, depth - 1)
        return ("bin", op, a, ("const", int(rng.integers(0, 70)), 7)), wa
    if op == "signed":
        a, wa = _random_tree(rng, depth - 1)
        return ("signed", a), wa
    if op == "~":
        a, wa = _random_tree(rng, depth - 1)
        return ("not", a), wa
    if op == "repeat":
        a, wa = _random_tree(rng, depth - 1)
        if wa > 31:
            return a, wa
        n = int(rng.integers(2, 63 // wa + 1))
        return ("repeat", n, a), n * wa
    if op == "mux":
        c, _ = _random_tree(rng, depth - 1)
        a, wa = _random_tree(rng, depth - 1)
        b, wb = _random_tree(rng, depth - 1)
        return ("mux", c, a, b), max(wa, wb)
    a, wa = _random_tree(rng, depth - 1)
    b, wb = _random_tree(rng, depth - 1)
    return ("bin", op, a, b), (1 if op in ("<", "<=", ">", ">=", "==", "!=") else max(wa, wb))


def _tree_expr(rtl, t):
    kind = t[0]
    if kind == "ref":
        return rtl.Ref(f"in{t[1]}")
    if kind == "const":
        return rtl.Const(t[1], t[2])
    if kind == "signed":
        return rtl.Signed(_tree_expr(rtl, t[1]))
    if kind == "not":
        return rtl.Unop("~", _tree_expr(rtl, t[1]))
    if kind == "repeat":
        return rtl.Repeat(t[1], _tree_expr(rtl, t[2]))
    if kind == "mux":
        a, b = _tree_expr(rtl, t[2]), _tree_expr(rtl, t[3])
        return rtl.Mux(_tree_expr(rtl, t[1]), a, b)
    return rtl.Binop(t[1], _tree_expr(rtl, t[2]), _tree_expr(rtl, t[3]))


def _tree_design(rtl, ir, trees):
    """One netlist: an input per width of ``TREE_WIDTHS``, an output per
    tree, each of the width drawn for it."""
    m = rtl.RTLModule("trees")
    for p in ("clk", "rst", "t_start"):
        m.add_port(p, "input")
    for i, w in enumerate(TREE_WIDTHS):
        m.add_port(f"in{i}", "input", w)
        m.arg_ports[i] = [(f"in{i}", "input", "data", 0)]
    for k, (t, w_out) in enumerate(trees):
        m.add_port(f"out{k}", "output", w_out)
        m.add(rtl.CombAssign(f"out{k}", _tree_expr(rtl, t)))
    func = ir.FuncOp("trees", [ir.IntType(w, signed=False) for w in TREE_WIDTHS],
                     [f"in{i}" for i in range(len(TREE_WIDTHS))])
    return rtl.RTLDesign({"trees": m}, entry="trees"), func


def test_narrowed_nodes_equal_both_tapes_on_random_trees(tmp_path):
    """Random expression trees over nets of widths 1 to 63 on edge values
    (0, all ones, the sign bit, 2**31, 2**32 - 1), each output of a width
    drawn from the same set, in one source: the generated C++ (32-bit nodes
    where the ranges or a mask of 32 bits or fewer allow, 64-bit elsewhere)
    against ``_TorchOps`` and the reference's ``_NumpyOps``, bit for bit."""
    rng = np.random.default_rng(24)
    trees = [(_random_tree(rng, 4)[0], int(rng.choice(TREE_WIDTHS))) for _ in range(160)]
    # masks that are not all ones, over values below them
    trees += [(("bin", "&", ("ref", i), ("const", k, 8)), 8)
              for i, k in ((0, 2), (1, 64), (1, 255), (0, 1))]
    design, func = _tree_design(port_rtl, port_ir, trees)
    sim = port_sim.RTLSimulator(design, func, "trees", backend="torch", device="cpu")
    ref_design, ref_func = _tree_design(ref_rtl, ref_ir, trees)
    ref = ref_sim.RTLSimulator(ref_design, ref_func, "trees", backend="numpy")
    lanes = 300
    args = [rng.choice(_edge_values(w), size=lanes).astype(np.int64) for w in TREE_WIDTHS]
    kernel = SimKernel(sim)
    assert "uint32_t e" in kernel.source and "const i64 e" in kernel.source
    got = _host_result(sim, _host_kernel(sim, tmp_path), args, 2)
    plain = sim.run(args, 2, batched=True, trace=True)
    assert_same_sim_result(got, plain)
    assert_same_sim_result(plain, ref.run(args, 2, batched=True, trace=True))
    assert len(got.trace) == len(trees)


@pytest.mark.parametrize("place", ["shared", "global"])
@pytest.mark.parametrize("hierarchy", ["inline", "modules"])
@pytest.mark.parametrize("kernel", sorted(RTL_KERNELS))
def test_kernel_body_with_forced_placement_equals_the_plain_version(kernel, hierarchy, place,
                                                                   tmp_path):
    """Every design of the matrix with every memory and ring forced into
    shared memory, then into global memory, on 40 lanes (two blocks of 32,
    the second ragged): arrays, returns, valid flags, conflict counts and
    traces equal ``_TorchOps``'s.  In global memory a memory the tape never
    writes has a ``const __restrict__`` pointer of its own."""
    module, entry = rtl_design(kernel)
    batch = rtl_stimulus(kernel, 40)
    sim, prepared = port_sim.simulator_for(module, entry, hierarchy=hierarchy, device="cpu")
    cycles = port_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
    k = SimKernel(sim, place=place)
    assert set(k.layout.placement().values()) <= {place, "registers"}
    assert LANES_PER_BLOCK == 32 and f"#define LPB {LANES_PER_BLOCK}" in k.source
    if place == "global":
        for i, p in enumerate(k.layout.mems):
            const = "const " if not p.written else ""
            assert f"{const}uint32_t* __restrict__ m{i}," in k.source
            assert not p.written or f"const uint32_t* __restrict__ m{i}," not in k.source
    got = _host_result(sim, _host_kernel(sim, tmp_path, place=place), batch, cycles)
    assert_same_sim_result(got, sim.run(batch, cycles, batched=True, trace=True,
                                        check_conflicts=False))


LARGE = {"array_add": {"n": 4096}, "transpose": {"n": 64}, "stencil1d": {"n": 4096},
         "histogram": {"n": 4096, "bins": 256}, "conv2d": {"h": 64, "w": 64}}


@pytest.mark.parametrize("kernel", sorted(LARGE))
def test_default_placement_keeps_small_state_on_chip(kernel):
    """At the large sizes the 4096-word arrays stay in global memory;
    histogram's 512 bin words and conv2d's 128 line-buffer words, and every
    ring, go to shared memory; at the test sizes everything fits, within a
    lane's share of two blocks' shared memory an SM."""
    module, entry = port_gallery.GALLERY[kernel].build(**LARGE[kernel])
    lay = SimKernel(port_sim.simulator_for(module, entry, device="cpu")[0]).layout
    for p in lay.mems + lay.rings:
        assert p.place == ("global" if p.depth >= 3844 else "shared"), (p.key, p.depth)
    on_chip = sum(p.depth for p in lay.mems if p.place == "shared")
    assert on_chip == {"histogram": 512, "conv2d": 128}.get(kernel, 0)
    assert lay.smem_lane_bytes <= SMEM_LANE_BYTES
    k = SimKernel(port_sim.simulator_for(*rtl_design(kernel), device="cpu")[0])
    assert set(k.layout.placement().values()) <= {"shared", "registers"}
    assert k.layout.smem_lane_bytes <= SMEM_LANE_BYTES


def test_words_wider_than_32_bits_keep_8_bytes(tmp_path):
    """A design with 40-bit outputs and a 40-bit register: those words are
    8 bytes (``st64``), the rest 4, and the run equals ``_TorchOps``."""
    design, func = _alu_design(port_rtl, port_ir, ["*", "+"], w_in=20, w_out=40)
    top = design.modules["alu"]
    top.nets["acc"] = port_rtl.Net("acc", 40, port_rtl.REG, False, "", "")
    top.add(port_rtl.RegAssign("acc", port_rtl.Binop("+", port_rtl.Ref("acc"),
                                                     port_rtl.Ref("out0"))))
    top.add_port("out2", "output", 40)
    top.add(port_rtl.CombAssign("out2", port_rtl.Ref("acc")))
    sim = port_sim.RTLSimulator(design, func, "alu", backend="torch", device="cpu")
    k = SimKernel(sim)
    lay = k.layout
    assert lay.slot_bytes[lay.slot_of[("acc", -1)]] == 8
    assert lay.slot_bytes[lay.slot_of[("in:in0", -1)]] == 4
    rng = np.random.default_rng(2)
    args = [rng.integers(0, 1 << 20, size=50) for _ in range(2)]
    got = _host_result(sim, _host_kernel(sim, tmp_path), args, 9)
    assert_same_sim_result(got, sim.run(args, 9, batched=True, trace=True))
