"""HIR -> CUDA lowering of the PyTorch port against the HIR -> Pallas lowering
of the reference: the same design and the same seeded stimulus go through
both, and the results are **bit-exact** (integer designs, tolerance 0).

The reference runs as its own tests run it on the CPU: ``lower_to_pallas``
in interpret mode and ``lower_to_jax``.  The port runs the plain version of
``lower_to_cuda`` (``device="cpu"``) and ``lower_to_torch``.  The generated
CUDA C++ cannot be compiled without ``nvcc``; its text is produced and its
structure checked; ``tests/test_torch_gpu.py`` runs it where there is a card.
"""

import re
import warnings

import jax  # noqa: F401  (both frameworks in one process; jax stays on the CPU)
import numpy as np
import pytest
import torch

from repro.core import gallery as ref_gallery
from repro.core.lower import lower_to_jax
from repro.core.lower.common import jnp_arith_table
from repro.core.lower.to_pallas import lower_to_pallas
from repro.core.passes import DEFAULT_PIPELINE_SPEC as REF_PIPELINE_SPEC
from repro.core.passes import PassManager as RefPassManager
from repro.core.printer import print_module as ref_print_module

from repro_torch import compat
from repro_torch.core import gallery as port_gallery
from repro_torch.core import ir as port_ir
from repro_torch.core.builder import Builder as PortBuilder
from repro_torch.core.lower import lower_to_cuda, lower_to_torch, simulate
from repro_torch.core.lower.common import (PrecisionWarning, cuda_dtype,
                                           torch_arith_table, torch_dtype)
from repro_torch.core.lower import to_cuda
from repro_torch.core.lower.to_cuda import generate_cuda_source
from repro_torch.kernels import _build

from test_torch_gpu import EDGE, alu_inputs, build_alu, build_float_add

LOOP_NESTS = ["array_add", "transpose", "stencil1d", "histogram", "conv2d"]
OUT_NAME = {"array_add": "C", "transpose": "Co", "stencil1d": "Bw",
            "histogram": "Out", "conv2d": "Out"}


def _n_in(module, name):
    return sum(1 for a in module.get(name).args if a.type.port == "r")


def _i64(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x, np.int64)


def _both(gal_name, build_kwargs=None, input_kwargs=None):
    """One design through the reference's Pallas lowering (interpret mode)
    and the port's CUDA lowering (plain version on the CPU), same stimulus."""
    kw, ikw = build_kwargs or {}, input_kwargs or build_kwargs or {}
    ref_gal, port_gal = ref_gallery.GALLERY[gal_name], port_gallery.GALLERY[gal_name]
    inputs = ref_gal.make_inputs(**ikw)
    for a, b in zip(inputs, port_gal.make_inputs(**ikw)):
        np.testing.assert_array_equal(a, b)           # same seed, same stimulus
    rmod, rname = ref_gal.build(**kw)
    pmod, pname = port_gal.build(**kw)
    n_in = _n_in(pmod, pname)
    want = lower_to_pallas(rmod, rname)(*inputs[:n_in])
    got = lower_to_cuda(pmod, pname, device="cpu")(*inputs[:n_in])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_i64(got[k]), _i64(want[k]))
    return inputs, got


def test_array_add():
    inputs, outs = _both("array_add")
    want = port_gallery.array_add.oracle(inputs[0], inputs[1])
    np.testing.assert_array_equal(_i64(outs["C"]), want)


def test_transpose():
    inputs, outs = _both("transpose")
    np.testing.assert_array_equal(_i64(outs["Co"]), port_gallery.transpose.oracle(inputs[0]))


def test_stencil1d():
    inputs, outs = _both("stencil1d")
    np.testing.assert_array_equal(_i64(outs["Bw"]), port_gallery.stencil1d.oracle(inputs[0]))


def test_histogram():
    inputs, outs = _both("histogram")
    np.testing.assert_array_equal(_i64(outs["Out"]), port_gallery.histogram.oracle(inputs[0]))


def test_conv2d():
    inputs, outs = _both("conv2d")
    np.testing.assert_array_equal(_i64(outs["Out"]), port_gallery.conv2d.oracle(inputs[0]))


def test_histogram_result_does_not_depend_on_the_main_loop():
    """With n=8, bins=16 the largest-trip loop is the *clear* loop, so the
    read-modify-write loop runs in the epilogue: same answer."""
    inputs, outs = _both("histogram", dict(n=8, bins=16))
    np.testing.assert_array_equal(_i64(outs["Out"]),
                                  port_gallery.histogram.oracle(inputs[0], bins=16))


@pytest.mark.parametrize("gal_name", LOOP_NESTS)
def test_cuda_agrees_with_functional_lowering(gal_name):
    """Same HIR, two lowerings on each side (functional vs phase-split):
    all four identical."""
    ref_gal, port_gal = ref_gallery.GALLERY[gal_name], port_gallery.GALLERY[gal_name]
    inputs = port_gal.make_inputs()
    rmod, rname = ref_gal.build()
    pmod, pname = port_gal.build()
    n_in = _n_in(pmod, pname)
    jout = lower_to_jax(rmod, rname)(*inputs)
    tout = lower_to_torch(pmod, pname, device="cpu")(*inputs)
    cout = lower_to_cuda(pmod, pname, device="cpu")(*inputs[:n_in])
    for k, v in cout.items():
        np.testing.assert_array_equal(_i64(v), _i64(jout[k]))
        np.testing.assert_array_equal(_i64(tout[k]), _i64(jout[k]))
        assert v.dtype == torch.int32 and tout[k].dtype == torch.int32


@pytest.mark.parametrize("gal_name", LOOP_NESTS)
def test_four_lane_batch_matches_reference_lane_by_lane(gal_name):
    """The leading lanes dimension is the written-out ``vmap`` of the
    reference callable: lane s of the batch equals the reference on lane s."""
    ref_gal, port_gal = ref_gallery.GALLERY[gal_name], port_gallery.GALLERY[gal_name]
    rmod, rname = ref_gal.build()
    pmod, pname = port_gal.build()
    n_in = _n_in(pmod, pname)
    lanes = [port_gal.make_inputs(seed=s) for s in range(4)]
    batch = [np.stack([lane[i] for lane in lanes]) for i in range(len(lanes[0]))]
    got = lower_to_cuda(pmod, pname, device="cpu")(*batch[:n_in])
    func = lower_to_torch(pmod, pname, device="cpu")(*batch)
    rfn = lower_to_pallas(rmod, rname)
    out = OUT_NAME[gal_name]
    assert got[out].shape[0] == 4
    for s in range(4):
        want = _i64(rfn(*lanes[s][:n_in])[out])
        np.testing.assert_array_equal(_i64(got[out][s]), want)
        np.testing.assert_array_equal(_i64(func[out][s]), want)
    # one lane without the leading dimension is the reference's own call
    single = lower_to_cuda(pmod, pname, device="cpu")(*lanes[2][:n_in])
    np.testing.assert_array_equal(_i64(single[out]), _i64(got[out][2]))


@pytest.mark.parametrize("gal_name", LOOP_NESTS)
def test_design_carried_over_from_reference(gal_name):
    """A design built by the reference's builder and rewritten by the
    reference's passes travels as text into the port's parser; both sides
    then compute on the same optimized design."""
    ref_gal = ref_gallery.GALLERY[gal_name]
    rmod, rname = ref_gal.build()
    RefPassManager.from_spec(REF_PIPELINE_SPEC).run(rmod)
    pmod = compat.module_from_reference_text(ref_print_module(rmod))
    assert isinstance(pmod, port_ir.Module)
    inputs = ref_gal.make_inputs()
    n_in = _n_in(pmod, rname)
    want = lower_to_pallas(rmod, rname)(*inputs[:n_in])
    tins = [compat.to_tensor(x, a.type.elem, "cpu")
            for x, a in zip(inputs, pmod.get(rname).args)]
    assert all(t.dtype == torch.int32 for t in tins)
    got = lower_to_cuda(pmod, rname, device="cpu")(*tins[:n_in])
    func = lower_to_torch(pmod, rname, device="cpu")(*tins)
    for k in want:
        np.testing.assert_array_equal(_i64(got[k]), _i64(want[k]))
        np.testing.assert_array_equal(_i64(func[k]), _i64(want[k]))


# -- the functional lowering against the port's own simulator -------------------


def _mac_top():
    """``mac`` takes scalars and returns one: wrap it in a function that
    reads the operands from a memref and writes the result to one."""
    module, _ = port_gallery.mac.build()
    b = PortBuilder(module)
    # fully distributed (one bank per element): three reads in one cycle
    rmem = port_ir.MemrefType((3,), port_ir.i32, port_ir.PORT_R, packed=[])
    wmem = port_ir.MemrefType((1,), port_ir.i32, port_ir.PORT_W)
    with b.func("mac_top", [rmem, wmem], ["X", "Y"]) as f:
        X, Y = f.args
        vals = [b.read(X, [i], at=f.t) for i in range(3)]          # valid t+1
        r = b.call("mac", vals, at=f.t + 1)                        # valid t+3
        b.write(r, Y, [0], at=f.t + 3)
        b.ret()
    return module, "mac_top"


@pytest.mark.parametrize("gal_name", sorted(port_gallery.GALLERY))
def test_functional_lowering_matches_simulator(gal_name):
    """``lower_to_torch`` (schedule-free) against the port's cycle-accurate
    ``simulate`` on all twelve designs, the three traced ones included."""
    if gal_name == "mac":
        module, name = _mac_top()
        inputs = [np.array([7, -3, 11], np.int64), np.zeros((1,), np.int64)]
        expect = np.array([port_gallery.mac.oracle(7, -3, 11)])
    else:
        gal = port_gallery.GALLERY[gal_name]
        module, name = gal.build()
        inputs = gal.make_inputs()
        expect = None
    sim_args = [np.array(x, copy=True) for x in inputs]
    simulate(module, name, sim_args)
    outs = lower_to_torch(module, name, device="cpu")(*inputs)
    assert outs
    for a, final in zip(module.get(name).args, sim_args):
        if a.name in outs:
            np.testing.assert_array_equal(_i64(outs[a.name]), final)
    if expect is not None:
        np.testing.assert_array_equal(sim_args[-1], expect)


# -- the arithmetic table, op by op ----------------------------------------------

def _arith_operands(op):
    rng = np.random.default_rng(7)
    a = np.concatenate([EDGE, rng.integers(-2**31, 2**31, 47)])
    b = np.concatenate([rng.permutation(EDGE), rng.integers(-2**31, 2**31, 47)])
    if op == "div":
        b = np.where((b == 0) | (b == -1), 3, b)   # x/0 and INT_MIN/-1: outside the domain
    if op in ("shl", "shr"):
        b = np.concatenate([np.arange(-3, 14), rng.integers(0, 40, 47)])
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("op", sorted(set(torch_arith_table()) - {"select", "not", "trunc",
                                                                  "zext", "sext"}))
def test_arith_table_matches_reference(op):
    """Every binary HIR arith op on int32 edge values: wrap-around, floor
    division, arithmetic shift, shift counts >= 32, compares as int32 0/1."""
    import jax.numpy as jnp

    a, b = _arith_operands(op)
    want = np.asarray(jnp_arith_table()[op](jnp.asarray(a), jnp.asarray(b)))
    got = torch_arith_table()[op](torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a python-int operand folds the same way on both sides
    for c in (3, 31):
        want_c = np.asarray(jnp_arith_table()[op](jnp.asarray(a), c))
        got_c = torch_arith_table()[op](torch.as_tensor(a), c)
        np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_arith_table_unary_and_select_match_reference():
    import jax.numpy as jnp

    a, b = _arith_operands("add")
    c = (a % 3 == 0).astype(np.int32) * a          # zero / non-zero conditions
    jt, tt = jnp_arith_table(), torch_arith_table()
    np.testing.assert_array_equal(tt["not"](torch.as_tensor(a)).numpy(),
                                  np.asarray(jt["not"](jnp.asarray(a))))
    np.testing.assert_array_equal(
        tt["select"](torch.as_tensor(c), torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jt["select"](jnp.asarray(c), jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        tt["select"](torch.as_tensor(c), 5, -9).numpy(),
        np.asarray(jt["select"](jnp.asarray(c), 5, -9)))
    for name in ("trunc", "zext", "sext"):
        assert tt[name](7) == jt[name](7) == 7
    # constants fold in Python before they meet a tensor
    assert tt["div"](-7, 2) == jt["div"](-7, 2) == -4
    assert tt["shr"](-8, 1) == jt["shr"](-8, 1) == -4
    assert tt["cmp_lt"](1, 2) == jt["cmp_lt"](1, 2) == 1


def test_alu_design_matches_reference():
    from repro.core import ir as ref_ir
    from repro.core.builder import Builder as RefBuilder

    rmod, name = build_alu(ref_ir, RefBuilder)
    pmod, _ = build_alu(port_ir, PortBuilder)
    inputs = alu_inputs()
    want = lower_to_pallas(rmod, name)(*inputs)["O"]
    got = lower_to_cuda(pmod, name, device="cpu")(*inputs)["O"]
    np.testing.assert_array_equal(_i64(got), _i64(want))
    src, _ = generate_cuda_source(pmod, name)
    for fn in ("hir_floordiv(", "hir_shl(", "hir_shr(", "hir_mul(", " ? 1 : 0;", "if ("):
        assert fn in src, fn


# -- dtype policy (twins of the reference's three dtype tests) -------------------


def test_cuda_f64_lowers_natively():
    """The TPU policy raises on f64; Hopper computes it, so the port lowers
    it as it is and keeps all 53 bits."""
    module, name = build_float_add(port_ir.FloatType(64))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = lower_to_cuda(module, name, device="cpu")
    a = np.arange(8.0) + 2.0 ** -40
    b = 2.0 * np.arange(8.0)
    out = fn(a, b)["C"]
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), a + b)
    assert "double" in fn.source and "float " not in fn.source.split("hir_fadd(")[1]


def test_cuda_f64_allow_downcast_is_inert_and_silent():
    module, name = build_float_add(port_ir.FloatType(64))
    with warnings.catch_warnings():
        warnings.simplefilter("error", PrecisionWarning)
        fn = lower_to_cuda(module, name, allow_downcast=True, device="cpu")
        assert cuda_dtype(port_ir.FloatType(64), allow_downcast=True) == torch.float64
    a = np.arange(8.0)
    b = 2.0 * np.arange(8.0)
    np.testing.assert_allclose(fn(a, b)["C"].numpy(), a + b, rtol=0, atol=0)


def test_cuda_f16_maps_to_float16_without_warning():
    module, name = build_float_add(port_ir.FloatType(16))
    with warnings.catch_warnings():
        warnings.simplefilter("error", PrecisionWarning)
        fn = lower_to_cuda(module, name, device="cpu")
    assert cuda_dtype(port_ir.FloatType(16)) == torch.float16
    assert torch_dtype(port_ir.FloatType(16)) == torch.float16
    a = np.arange(8.0) / 4
    out = fn(a, a)["C"]
    assert out.dtype == torch.float16
    np.testing.assert_array_equal(out.float().numpy(), 2 * a)
    assert "__half" in fn.source and "#include <cuda_fp16.h>" in fn.source


# -- the generator's text ----------------------------------------------------------


@pytest.mark.parametrize("gal_name", LOOP_NESTS)
def test_generated_source_structure(gal_name):
    """The source is produced without a compiler and has the shape the
    lowering promises: prologue block, main loop over the largest trip
    count, epilogue block, one thread per lane, a C launcher."""
    gal = port_gallery.GALLERY[gal_name]
    module, name = gal.build()
    fn = lower_to_cuda(module, name, device="cpu")
    src = fn.source
    func = module.get(name)
    top_trips = [op.trip_count() for op in func.body.ops if op.opname == "for"]
    # a block runs at most 128 lanes; staged kernels give each a helper thread
    bound = 256 if fn.kernel.staged else 128
    assert f'extern "C" __global__ void __launch_bounds__({bound})\nhir_{name}(' in src
    assert f'extern "C" int launch_hir_{name}(' in src
    assert "return (int)cudaGetLastError();" in src
    assert "const int lane = blockIdx.x * hir_lanes + hir_lane;" in src
    assert f"hir_{name}<<<blocks, {bound // 128} * threads, " in src   # the caller sizes blocks
    main = re.search(r"for \(int32_t pid = (0|k \* \d+); pid < (min\(\(k \+ 1\) \* \d+, )?"
                     + str(max(top_trips)) + r"\)?; \+\+pid\) \{", src)
    pro, epi = src.index("{  // prologue"), src.index("{  // epilogue")
    assert main and pro < main.start() < epi
    assert src.count("{") == src.count("}")
    # every memref argument becomes one pointer parameter, sliced per lane
    for a in func.args:
        size = int(np.prod(a.type.shape))
        lane = "in_lane" if a.type.port == "r" else "lane"
        assert f"g_{a.name} + (size_t){lane} * {size};" in src
    # hir.alloc buffers are zero-initialised: per-thread arrays, or a
    # thread's column of shared memory
    for op in func.body.ops:
        if op.opname == "alloc":
            n = int(np.prod(op.attrs["base"].shape))
            assert (f"[{n}] = {{}};" in src
                    or f"for (int32_t i = 0; i < {n}; ++i) " in src)
    # a separately built module generates the same text, so the same library
    module2, _ = gal.build()
    src2, launcher = generate_cuda_source(module2, name)
    assert src2 == src and launcher == f"launch_hir_{name}"
    assert _build.source_hash(src) == _build.source_hash(src2)


def test_generated_source_scopes_values_per_loop_body():
    """A pure value first needed inside a loop body is declared inside its
    braces; the prologue, main loop and epilogue do not share declarations."""
    module, name = port_gallery.histogram.build(n=8, bins=16)
    src, _ = generate_cuda_source(module, name)
    body = src[src.index("{  // prologue"):]
    decls = [ln.split("=")[0].split()[-1] for ln in body.splitlines()
             if ln.strip().startswith("const int32_t ")]
    assert len(decls) == len(set(decls))              # fresh names throughout
    epilogue = body[body.index("{  // epilogue"):]
    assert epilogue.count("for (int32_t t") == 2      # RMW loop and drain loop
    assert "for (int32_t pid = 0; pid < 16; ++pid)" in body   # the clear loop is main


def test_generated_sources_differ_by_design_and_size():
    hashes = set()
    for gal_name in LOOP_NESTS:
        module, name = port_gallery.GALLERY[gal_name].build()
        hashes.add(_build.source_hash(generate_cuda_source(module, name)[0]))
    small, name = port_gallery.array_add.build(n=32)
    hashes.add(_build.source_hash(generate_cuda_source(small, name)[0]))
    assert len(hashes) == len(LOOP_NESTS) + 1


def test_lowering_rejects_what_it_cannot_take():
    module, name = port_gallery.mac.build()            # scalar arguments, no loop
    with pytest.raises(NotImplementedError):
        lower_to_cuda(module, name, device="cpu")
    module, name = port_gallery.array_add.build(n=8)
    fn = lower_to_cuda(module, name, device="cpu")
    with pytest.raises(ValueError, match="fits neither"):
        fn(np.zeros((9,), np.int64), np.zeros((8,), np.int64))
    with pytest.raises(ValueError, match="disagree on lanes"):
        fn(np.zeros((2, 8), np.int64), np.zeros((3, 8), np.int64))




# -- latency hiding and placement in the generated kernel --------------------------


def _kernel(gal_name, **size):
    module, name = port_gallery.GALLERY[gal_name].build(**size)
    return lower_to_cuda(module, name, device="cpu")


def _helper_part(src):
    start = src.index("  if (hir_helper) {")
    return src[start:src.index("\n  }\n", start)]


@pytest.mark.parametrize("gal_name,size,staged,chunk", [
    ("array_add", {"n": 4096}, ["m_A", "m_B", "m_C"], 128),
    ("transpose", {"n": 64}, ["m_Ai", "m_Co"], 4),
    ("conv2d", {"h": 64, "w": 64}, ["m_Img", "m_Out"], 4),
    ("stencil1d", {"n": 4096}, ["m_Ai", "m_Bw"], 128),
    ("histogram", {"n": 4096, "bins": 256}, ["m_Img"], 128),
])
def test_staged_kernels_copy_the_next_chunk_while_the_warp_computes(gal_name, size, staged, chunk):
    """The memrefs the main loop touches at indices known ahead are staged
    in chunks; a helper warp copies chunk k + 1 in and chunk k - 1 out
    while its compute warp runs chunk k, and the two meet at a barrier of
    their own the same number of times."""
    fn = _kernel(gal_name, **size)
    src = fn.source
    assert fn.kernel.staged == staged and fn.kernel.chunk == chunk
    helper = _helper_part(src)
    compute = src[src.index(helper) + len(helper):src.index('extern "C" int launch_hir')]
    assert helper.count("hir_pair_sync(pair);") == compute.count("hir_pair_sync(pair);") == 4
    assert "    for (int32_t k = 0; k < " in helper and "if (k + 1 < " in helper
    for m in staged:
        name = m[2:]
        assert f"hir_r0_{name}(int32_t k)" in src and f"hir_c0_{name}(int32_t k)" in src
        assert f"b_{name} = s_{name} + (k & 1) * " in compute          # two buffers
        loop = compute[compute.index("// main loop"):compute.index("// epilogue")]
        assert f"m_{name}[" not in loop               # the main loop touches the copies
    assert "cp.async.ca.shared.global" in src and "// Staging: " in src
    assert fn.kernel.stage_per_pair <= to_cuda.STAGE_BYTES_PER_PAIR


def test_boxes_follow_the_main_loop():
    """transpose 64 reads rows of Ai and writes columns of Co: a chunk of 4
    iterations stages 4 rows of one and 4 columns of the other; Co is only
    written, all of each box, so it is copied out and never in."""
    fn = _kernel("transpose", n=64)
    src = fn.source
    assert "hir_r0_Ai(int32_t k) { return 0 + k * 4; }" in src
    assert "hir_c0_Ai(int32_t k) { return 0 + k * 0; }" in src
    assert "hir_r0_Co(int32_t k) { return 0 + k * 0; }" in src
    assert "hir_c0_Co(int32_t k) { return 0 + k * 4; }" in src
    helper = _helper_part(src)
    assert "hir_stage_in(s_Ai" in helper and "hir_stage_out(s_Co" in helper
    assert "hir_stage_in(s_Co" not in helper and "hir_stage_out(s_Ai" not in helper
    assert re.search(r"b_Co\[\(\(\(j_\d+\) - r0_Co\) \* 4 \+ \(i_\d+\) - c0_Co\) \* 33 \+ hir_t\]",
                     src)


def test_boxes_that_meet_the_next_chunks_are_not_staged():
    """A running sum writes X[i + 1] after reading X[i]: over 300
    iterations in chunks of 128 the boxes of X meet, and copying chunk k + 1
    in before chunk k is out would read stale values, so X stays in global
    memory; A is staged."""
    from test_torch_gpu import build_running_sum

    module, name = build_running_sum(port_ir, PortBuilder, n=300)
    fn = lower_to_cuda(module, name, device="cpu")
    assert fn.kernel.staged == ["m_A"] and fn.kernel.chunk == 128
    assert "m_X[" in fn.source and "s_X" not in fn.source
    got = fn(np.arange(300))["X"]
    np.testing.assert_array_equal(got.numpy(), np.concatenate([[0], np.cumsum(np.arange(300))]))


def test_unstaged_reads_are_prefetched_with_their_guards():
    """The ALU design gathers A at a data-dependent index, so A is not
    staged; its reads at the loop's index are prefetched, inside the memref,
    for iteration pid + pf; the gather gets none."""
    module, name = build_alu(port_ir, PortBuilder)
    fn = lower_to_cuda(module, name, device="cpu")
    src = fn.source
    assert "m_A" not in fn.kernel.staged and fn.kernel.prefetch_bytes == 4
    main = src.index("// main loop")
    ahead = src.index("if (pid + pf < 64) {  // prefetch iteration pid + pf", main)
    assert re.search(r"if \((p\d+) >= 0 && \1 < 64\) hir_prefetch\(m_A \+ \1\);", src[ahead:])
    assert re.findall(r"hir_prefetch\((m_\w+) \+", src) == ["m_A"]
    assert "if (((uintptr_t)p & 31u) == 0)" in src and "prefetch.global.L1" in src
    assert "// Prefetch: the unstaged reads of an iteration take 4 bytes" in src


def test_histogram_bins_get_no_prefetch_and_live_in_shared_memory():
    """The bins are indexed by data, so they are neither staged nor
    prefetched; they live element-major in shared memory."""
    fn = _kernel("histogram")
    src = fn.source
    assert "hir_prefetch(m_" not in src and fn.kernel.staged == ["m_Img"]
    assert fn.kernel.shared_allocs == ["a0_Hr"] and fn.kernel.smem_per_thread == 16 * 4
    assert "extern __shared__ __align__(16) unsigned char hir_smem[];" in src
    assert re.search(r"a0_Hr\[\(r\d+\) \* hir_lanes\]", src)           # a data-indexed bin
    assert "reinterpret_cast<int32_t*>(hir_smem + 0 * hir_lanes) + hir_lane;" in src
    assert "// Shared memory, element-major" in src


def test_allocs_placed_by_index_and_size():
    """conv2d's line buffers are indexed by the column and go to shared
    memory; its window, indexed by constants only, stays in registers; bins
    too many for a block's shared memory go to the call's global scratch,
    element-major (a per-thread array that large would be local memory,
    which CUDA reserves for every thread the card holds)."""
    conv = _kernel("conv2d")
    assert conv.kernel.shared_allocs == ["a0_L0r", "a1_L1r"]
    assert "int32_t a2_Pr[6] = {};" in conv.source
    assert conv.kernel.scratch_allocs == [] and "hir_scratch" not in conv.source
    big = _kernel("histogram", n=64, bins=4096)
    assert big.kernel.shared_allocs == [] and big.kernel.smem_per_thread == 0
    assert big.kernel.scratch_allocs == ["a0_Hr"] and big.kernel.scratch_bytes == 4096 * 4
    assert "a0_Hr = reinterpret_cast<int32_t*>(hir_scratch + (size_t)0 * hir_stride) + lane;" \
        in big.source
    assert re.search(r"a0_Hr\[\(size_t\)\(r\d+\) \* hir_stride\]", big.source)   # a data-indexed bin
    assert "void* scratch, int lanes" in big.source and "[4096] = {}" not in big.source
    large = _kernel("histogram", n=4096, bins=256)
    assert large.kernel.shared_allocs == ["a0_Hr"]
    assert "cudaFuncSetAttribute(hir_histogram" in large.source
    assert large.source.count("static bool attr_set = false;") == 1
    assert large.kernel.smem_bytes(32) <= to_cuda.SMEM_BYTES


def test_traced_buffers_past_the_local_limit_go_to_the_global_scratch():
    """A traced softmax row of 4096 chains nine (4096,) buffers: each goes to
    the scratch (16 KB a lane each, laid out one after another), the
    rank-0 registers stay per-thread arrays, and the plain version agrees
    with the oracle."""
    from repro_torch.core.gallery import frontend_softmax_row

    module, name = frontend_softmax_row.build(n=4096)
    fn = lower_to_cuda(module, name, device="cpu")
    assert len(fn.kernel.scratch_allocs) == 9 and fn.kernel.scratch_bytes == 9 * 4096 * 4
    offsets = re.findall(r"hir_scratch \+ \(size_t\)(\d+) \* hir_stride", fn.source)
    assert [int(o) for o in offsets] == [k * 4096 * 4 for k in range(9)]
    assert re.findall(r"int32_t (a\d+_\w+)\[1\] = \{\};", fn.source) == [
        "a2_red2r", "a8_red8r", "a9_b9r"]
    assert all(int(n) <= to_cuda.LOCAL_ALLOC_BYTES // 4
               for n in re.findall(r"int32_t a\d+_\w+\[(\d+)\] = \{\};", fn.source))
    s, mask, _ = frontend_softmax_row.make_inputs(n=4096, seed=1)
    got = fn(s, mask)["out"]
    np.testing.assert_array_equal(got.numpy().astype(np.int64), frontend_softmax_row.oracle(s, mask))


@pytest.mark.parametrize("lanes,threads", [(1, 32), (33, 32), (4096, 32), (4097, 32),
                                           (10_000, 64), (1_000_000, 128)])
def test_block_size_covers_every_sm(lanes, threads):
    """32 lanes a block while the lanes cannot fill 132 SMs with bigger
    blocks, 128 only when they fill the card at that size."""
    assert to_cuda.block_threads(lanes, 132) == threads
    assert -(-lanes // threads) >= min(132, -(-lanes // 32))


def test_prefetch_distance_keeps_16_kb_in_flight_per_sm():
    assert to_cuda.prefetch_distance(4096, 132, 8, 4096) == 64        # 32 lanes an SM
    assert to_cuda.prefetch_distance(4096, 132, 256, 64) == 2
    assert to_cuda.prefetch_distance(1, 132, 8, 4096) == 64           # a block is a warp
    assert to_cuda.prefetch_distance(1, 132, 8, 50) == 50             # never past the loop
    assert to_cuda.prefetch_distance(10 ** 6, 132, 4096, 64, 128) == 1
    assert to_cuda.prefetch_distance(4096, 132, 0, 64) == 1           # nothing to prefetch


@pytest.mark.parametrize("gal_name,size,whole", [
    ("array_add", {"n": 4096}, ["C"]), ("transpose", {"n": 64}, ["Co"]),
    ("stencil1d", {"n": 4096}, ["Bw"]), ("conv2d", {"h": 64, "w": 64}, ["Out"]),
    ("histogram", {"n": 4096, "bins": 256}, []),
])
def test_outputs_the_main_loop_writes_whole_need_no_zeros(gal_name, size, whole):
    """A write-port memref whose every element the main loop writes
    unconditionally starts as ``torch.empty``; histogram's output is written
    in the epilogue, so it starts from zeros as the plain version's does."""
    fn = _kernel(gal_name, **size)
    assert fn.kernel.written_whole == whole
    module, name = build_alu(port_ir, PortBuilder)          # O is a read-write port
    assert lower_to_cuda(module, name, device="cpu").kernel.written_whole == []
