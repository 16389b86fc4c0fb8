"""The port's CUDA kernels on the card, each against its plain PyTorch
version: the generated kernels of ``lower_to_cuda`` bit-exact, the matmul and
attention kernels within the tolerance of the reference's kernel tests.

Every test here is marked ``gpu``: a CUDA kernel has no CPU mode, so the
tests skip where there is no device.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports only ``torch`` and the port, so it runs on a machine that
has neither ``jax`` nor the reference package's dependencies.  It also holds
the small designs and operand makers that the CPU tests share with it.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gallery as port_gallery
from repro_torch.core import ir as port_ir
from repro_torch.core.builder import Builder as PortBuilder
from repro_torch.core.codegen import sim as port_sim
from repro_torch.core.codegen.rtl import Binop, Const, PortConflictAssert, Ref
from repro_torch.core.gallery import gemm
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.lower import lower_to_cuda
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.launch import serve
from repro_torch.models import mlp, ssd, transformer

LOOP_NESTS = ["array_add", "transpose", "stencil1d", "histogram", "conv2d"]

# -- shared designs and operands --------------------------------------------------

EDGE = np.array([0, 1, -1, 2, -2, 7, -7, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1,
                 2**16, -2**16, 46341, -46341, 12345, -54321], np.int64)


# -- an ALU design: every op, a predicated write, a data-dependent index --------

ALU_BINARY = ["add", "sub", "mult", "div", "and", "or", "xor", "shl", "shr",
              "cmp_lt", "cmp_le", "cmp_eq", "cmp_ne", "cmp_gt", "cmp_ge"]


def build_alu(ir, Builder, n=64):
    """Row k of ``O`` holds op k of ``ALU_BINARY`` applied to (A[i], B[i])
    — ``div`` by D[i], shifts by S[i]; then ``not``, ``select``, a write
    predicated on ``A[i] < B[i]`` over a prefilled row, and a gather
    ``A[S[i] & 63]``.  Built with either package's ``ir`` and ``Builder``."""
    b = Builder(ir.Module("alu"))
    r = ir.MemrefType((n,), ir.i32, ir.PORT_R)
    rows = len(ALU_BINARY) + 4
    w = ir.MemrefType((rows, n), ir.i32, ir.PORT_RW)
    with b.func("alu", [r, r, r, r, w], ["A", "B", "D", "S", "O"]) as f:
        A, B, D, S, O = f.args
        with b.for_(0, n, 1, at=f.t + 1, iv_name="i", tv_name="ti") as li:
            b.yield_(at=li.time + 1)
            a = b.read(A, [li.iv], at=li.time)
            v = b.read(B, [li.iv], at=li.time)
            d = b.read(D, [li.iv], at=li.time)
            s = b.read(S, [li.iv], at=li.time)
            i1 = b.delay(li.iv, 1, at=li.time)
            for k, op in enumerate(ALU_BINARY):
                rhs = d if op == "div" else s if op in ("shl", "shr") else v
                b.write(b._arith(op, a, rhs), O, [k, i1], at=li.time + 1)
            k = len(ALU_BINARY)
            b.write(b._arith("not", a), O, [k, i1], at=li.time + 1)
            lt = b.cmp("lt", a, v)
            b.write(b.select(lt, a, b.add(v, 1000)), O, [k + 1, i1], at=li.time + 1)
            b.write(-1, O, [k + 2, i1], at=li.time + 1)
            b.write(a, O, [k + 2, i1], at=li.time + 2, pred=lt)
            g = b.read(A, [b.and_(s, n - 1)], at=li.time + 1)
            b.write(g, O, [k + 3, li.iv], at=li.time + 2)
        b.ret()
    return b.module, "alu"


def alu_inputs(n=64, seed=3):
    rng = np.random.default_rng(seed)
    a = np.concatenate([EDGE, rng.integers(-2**31, 2**31, n - len(EDGE))])
    b = np.concatenate([rng.permutation(EDGE), rng.integers(-2**31, 2**31, n - len(EDGE))])
    d = rng.integers(2, 1000, n) * rng.choice([-1, 1], n)
    s = np.concatenate([np.arange(-3, 37), rng.integers(0, 40, n - 40)])
    return [x.astype(np.int64) for x in (a, b, d, s)]


def build_float_add(elem):
    """8-wide elementwise add over float memrefs (array_add shape)."""
    b = PortBuilder(port_ir.Module("fadd"))
    r = port_ir.MemrefType((8,), elem, port_ir.PORT_R)
    w = port_ir.MemrefType((8,), elem, port_ir.PORT_W)
    with b.func("fadd", [r, r, w], ["A", "B", "C"]) as f:
        A, B, C = f.args
        with b.for_(0, 8, 1, at=f.t + 1, iv_name="i", tv_name="ti") as li:
            b.yield_(at=li.time + 1)
            a = b.read(A, [li.iv], at=li.time)
            v = b.read(B, [li.iv], at=li.time)
            c = b.add(a, v)
            i1 = b.delay(li.iv, 1, at=li.time)
            b.write(c, C, [i1], at=li.time + 1)
        b.ret()
    return b.module, "fadd"


def build_running_sum(ir, Builder, n=64):
    """X[i + 1] = X[i] + A[i] over a read-write X: the main loop reads what
    the iteration before it wrote, so consecutive chunks' boxes of X meet."""
    b = Builder(ir.Module("rsum"))
    r = ir.MemrefType((n,), ir.i32, ir.PORT_R)
    x = ir.MemrefType((n + 1,), ir.i32, ir.PORT_RW)
    with b.func("rsum", [r, x], ["A", "X"]) as f:
        A, X = f.args
        with b.for_(0, n, 1, at=f.t + 1, iv_name="i", tv_name="ti") as li:
            b.yield_(at=li.time + 2)
            a = b.read(A, [li.iv], at=li.time)
            v = b.read(X, [li.iv], at=li.time)
            i1 = b.delay(li.iv, 1, at=li.time)
            b.write(b.add(a, v), X, [b.add(i1, 1)], at=li.time + 1)
        b.ret()
    return b.module, "rsum"


SHAPES = [(128, 128, 128), (256, 384, 128), (100, 130, 70), (8, 8, 8)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(name):
    """The reference kernel tests' ``_tol``."""
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def normal(shape, name, seed):
    """Seeded float32 numpy normals; for bfloat16, rounded so that the hop
    through float32 loses nothing on either side."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if name == "bfloat16":
        x = torch.as_tensor(x).bfloat16().float().numpy()
    return x


def matmul_operands(M, K, N, name):
    return normal((M, K), name, 0), normal((K, N), name, 1)


# -- the RTL simulator's matrix: tests/core/test_rtl_sim.py's designs and sizes ---

# kernel -> (build kwargs, make_inputs kwargs, oracle arguments, oracle kwargs);
# mac takes three scalars (make_inputs None) and returns one
RTL_KERNELS = {
    "array_add": ({"n": 8}, {"n": 8}, 2, {}),
    "transpose": ({"n": 4}, {"n": 4}, 1, {}),
    "gemm": ({"n": 4}, {"n": 4}, 2, {}),
    "gemm_shared": ({"n": 4}, {"n": 4}, 2, {}),
    "stencil1d": ({"n": 8}, {"n": 8}, 1, {}),
    "conv2d": ({"h": 6, "w": 6}, {"h": 6, "w": 6}, 1, {}),
    "histogram": ({"n": 8, "bins": 4}, {"n": 8, "bins": 4}, 1, {"bins": 4}),
    "fifo": ({"depth": 16, "n": 8}, {"n": 8}, 1, {}),
    "mac": ({}, None, 3, {}),
}
HIERARCHIES = ["inline", "modules"]


def rtl_design(kernel):
    """(module, entry) of one design of the matrix at its test size."""
    return port_gallery.GALLERY[kernel].build(**RTL_KERNELS[kernel][0])


def rtl_stimulus(kernel, lanes, base_seed=7):
    """Batch-first stimulus: ``stack_stimulus`` of the design's inputs, or
    for mac three scalar columns drawn as the reference's mac test draws
    them."""
    ikw = RTL_KERNELS[kernel][1]
    if ikw is None:
        rng = np.random.default_rng(11)
        return [rng.integers(0, 1 << 15, size=lanes).astype(np.int64) for _ in range(3)]
    return port_sim.stack_stimulus(port_gallery.GALLERY[kernel].make_inputs, lanes,
                                   base_seed=base_seed, **ikw)


def rtl_oracle(kernel):
    """(oracle, its argument count) as ``run_differential`` takes them."""
    _, _, nargs, okw = RTL_KERNELS[kernel]
    fn = port_gallery.GALLERY[kernel].oracle
    return (lambda *a: fn(*a, **okw)), nargs


def conflict_probe(backend, device):
    """mac's simulator with one more §4.5 assert, over ``a & 1`` and
    ``t_start``: it fires at cycle 0 in the lanes where ``a`` is odd, so the
    conflict count differs from lane to lane.  Returns (sim, cycles)."""
    from repro_torch.core.codegen import generate_verilog

    module, entry = rtl_design("mac")
    prepared = module.clone()
    design = port_sim.design_of(generate_verilog(prepared, entry), entry)
    top = design.modules[entry]
    a_port = top.arg_ports[0][0][0]
    top.items.append(PortConflictAssert("probe", [Binop("&", Ref(a_port), Const(1, 1)),
                                                  Ref("t_start")]))
    sim = port_sim.RTLSimulator(design, prepared.funcs[entry], entry, backend=backend,
                                device=device)
    return sim, port_sim.probe_cycles(prepared, entry, [0, 0, 0])


def assert_same_sim_result(got, want):
    """Arrays, returns, valid flags, conflict counts and traces all equal."""
    assert got.cycles == want.cycles and got.batch == want.batch
    assert sorted(got.arrays) == sorted(want.arrays)
    for i in want.arrays:
        np.testing.assert_array_equal(got.arrays[i], want.arrays[i], err_msg=f"arg {i}")
    for j, (r, v) in enumerate(zip(want.returns, want.returns_valid)):
        np.testing.assert_array_equal(got.returns[j], r, err_msg=f"result {j}")
        np.testing.assert_array_equal(got.returns_valid[j], v, err_msg=f"valid {j}")
    np.testing.assert_array_equal(got.conflicts, want.conflicts)
    assert (got.trace is None) == (want.trace is None)
    if want.trace is not None:
        assert list(got.trace) == list(want.trace)
        for name in want.trace:
            np.testing.assert_array_equal(got.trace[name], want.trace[name], err_msg=name)


# (Sq, Sk, H, KvH, D, window): the reference's test_flash_attention cases
FLASH_CASES = [
    (128, 128, 4, 4, 64, None),
    (128, 128, 4, 2, 64, None),     # GQA
    (256, 256, 2, 1, 32, 64),       # sliding window + MQA
    (64, 64, 2, 2, 128, None),
]
# ... and on the card also the other head dims and ragged lengths, under a
# window up to the last query row that still sees a key (Sq = Sk + window - 1)
FLASH_CASES_CARD = FLASH_CASES + [(100, 100, 4, 2, 16, None), (130, 200, 8, 2, 128, 50),
                                  (179, 130, 8, 2, 128, 50),
                                  # RecurrentGemma's heads: 16 over one KV head of 256
                                  (300, 300, 16, 1, 256, 128), (64, 64, 4, 2, 256, None)]
# (Sq, Sk, window, kv_len) where some query row sees no key: refused
FLASH_NO_KEY_CASES = [(200, 130, 50, None), (180, 130, 50, None), (64, 64, 16, 40)]

# (L, H, KvH, D, length): the reference's test_decode_attention cases
DECODE_CASES = [
    (512, 4, 4, 64, 200),
    (1024, 4, 2, 64, 1024),
    (256, 2, 1, 128, 1),
]
DECODE_CASES_CARD = DECODE_CASES + [(300, 8, 2, 16, 257), (96, 6, 3, 32, 96),
                                    (1024, 16, 1, 256, 513)]


# (S, H, P, N, chunk): the reference's test_ssd_scan cases (a ragged tail, one chunk)
SSD_CASES = [(64, 2, 16, 16, 16), (100, 1, 32, 16, 32), (128, 3, 8, 8, 128)]
# ... and on the card also the smoke config's head (P 24, chunk 8), Mamba-2's
# widths with a ragged tail, two tiles of P, N and P off the mma tiles (N 20
# and 12, P 24 and 72, a chunk of 8 in a tile of 64), and rows off 16 bytes
# (odd P and N, read 4 bytes at a time) in chunks of 100 and of 3
SSD_CASES_CARD = SSD_CASES + [(40, 8, 24, 16, 8), (600, 4, 64, 128, 256), (300, 2, 80, 32, 64),
                              (77, 3, 24, 20, 8), (300, 2, 72, 12, 64), (150, 2, 13, 7, 100),
                              (5, 1, 1, 1, 3)]
# (S, D): the reference's test_rglru_scan cases (ragged both dims, one block)
RGLRU_CASES = [(64, 32), (100, 48), (128, 8)]
# ... and on the card also several rounds of the kernel, ragged, and tiny
RGLRU_CASES_CARD = RGLRU_CASES + [(1000, 4000), (300, 1000), (7, 3)]


def ssd_operands(B, S, H, P, N, seed=5, lo=0.01, hi=0.5):
    """Seeded float32 (xdt, dA, Bc, Cc) as the reference test draws them:
    normal inputs, decay logs uniform in [-hi, -lo] ([-0.5, -0.01] there)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            -rng.uniform(lo, hi, (B, S, H)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


def rglru_operands(B, S, D, lo=0.5, hi=0.99, seed=8):
    """Seeded float32 (a, b): a uniform in [lo, hi], b normal."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (B, S, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


def attention_operands(q_shape, kv_shape, name, seed=1):
    return (normal(q_shape, name, seed), normal(kv_shape, name, seed + 1),
            normal(kv_shape, name, seed + 2))


# -- on the card ---------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("gal_name", LOOP_NESTS)
def test_generated_kernel_matches_plain_on_card(gal_name):
    dev = _cuda_or_skip()
    gal = port_gallery.GALLERY[gal_name]
    module, name = gal.build()
    fn = lower_to_cuda(module, name, device=dev)
    n_in = sum(1 for a in module.get(name).args if a.type.port == "r")
    lanes = [gal.make_inputs(seed=s) for s in range(33)]
    batch = [np.stack([lane[i] for lane in lanes]) for i in range(n_in)]
    got = fn(*batch)
    want = fn.plain(*batch)
    assert fn.launches == 1
    for k in want:
        assert torch.equal(got[k], want[k])


@pytest.mark.gpu
def test_alu_kernel_matches_plain_on_card():
    """C++ semantics of every op (floor division, shifts >= 32, wrap-around,
    predicated write, data-dependent index) against the plain version."""
    dev = _cuda_or_skip()
    module, name = build_alu(port_ir, PortBuilder)
    fn = lower_to_cuda(module, name, device=dev)
    batch = [np.stack([alu_inputs(seed=s)[i] for s in range(5)]) for i in range(4)]
    got, want = fn(*batch)["O"], fn.plain(*batch)["O"]
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [16, 32, 64])
def test_float_kernel_matches_plain_on_card(width):
    dev = _cuda_or_skip()
    module, name = build_float_add(port_ir.FloatType(width))
    fn = lower_to_cuda(module, name, device=dev)
    a = np.arange(8.0) / 4 + 2.0 ** -9
    b = np.arange(8.0) * 3
    got, want = fn(a, b)["C"], fn.plain(a, b)["C"]
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_kernel_matches_plain_on_card(shape, dtype):
    dev = _cuda_or_skip()
    M, K, N = shape
    x, y = matmul_operands(M, K, N, dtype)
    tdt = DTYPES[dtype]
    xt, yt = torch.as_tensor(x).to(dev, tdt), torch.as_tensor(y).to(dev, tdt)
    before = mm.launches
    got = ops.matmul(xt, yt, bm=128, bn=128, bk=128)
    assert mm.launches == before + 1
    want = ref.matmul_ref(xt, yt)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **tol(dtype))


@pytest.mark.gpu
def test_gemm_binding_exact_on_card():
    dev = _cuda_or_skip()
    a, b, _ = gemm.make_inputs()
    got = ops.matmul(torch.as_tensor(a).to(dev, torch.float32),
                     torch.as_tensor(b).to(dev, torch.float32), bm=16, bn=16, bk=16)
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64), gemm.oracle(a, b))


@pytest.mark.gpu
def test_matmul_refuses_an_unschedulable_tile_on_card():
    dev = _cuda_or_skip()
    x = torch.zeros((512, 512), device=dev)
    with pytest.raises(ValueError, match="threads"):
        mm.matmul(x, x, bm=256, bn=256, bk=16)


# the gallery designs at their paper size and at the size chip_smoke.py runs
DESIGN_SIZES = [("array_add", {}), ("array_add", {"n": 4096}), ("transpose", {}),
                ("transpose", {"n": 64}), ("stencil1d", {}), ("stencil1d", {"n": 4096}),
                ("histogram", {}), ("histogram", {"n": 4096, "bins": 256}),
                ("conv2d", {}), ("conv2d", {"h": 64, "w": 64}),
                # bins too many for shared memory: the call's global scratch
                ("histogram", {"n": 64, "bins": 4096})]


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 33, 4097])
@pytest.mark.parametrize("gal_name,size", DESIGN_SIZES)
def test_generated_kernel_bit_exact_at_every_lane_count_on_card(gal_name, size, lanes):
    """One lane, a ragged warp, and 4097 lanes (a last block of one lane
    whose other 31 threads run the last lane's inputs into spare rows)."""
    dev = _cuda_or_skip()
    gal = port_gallery.GALLERY[gal_name]
    module, name = gal.build(**size)
    fn = lower_to_cuda(module, name, device=dev)
    n_in = sum(1 for a in module.get(name).args if a.type.port == "r")
    per = [gal.make_inputs(**size, seed=s) for s in range(8)]
    batch = [torch.as_tensor(np.stack([per[s % 8][i] for s in range(lanes)])).to(dev, torch.int32)
             for i in range(n_in)]
    if lanes == 1:
        batch = [x[0] for x in batch]
    got = fn(*batch)
    want = fn.plain(*batch)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k])


@pytest.mark.gpu
def test_running_sum_with_meeting_boxes_on_card():
    """A read-write memref whose chunks' boxes meet stays in global memory
    and still gives the plain version's results."""
    dev = _cuda_or_skip()
    module, name = build_running_sum(port_ir, PortBuilder, n=300)
    fn = lower_to_cuda(module, name, device=dev)
    a = np.random.default_rng(2).integers(-1000, 1000, (40, 300))
    assert torch.equal(fn(a)["X"], fn.plain(a)["X"])


# a large ragged product, padded by ops.matmul to each dtype's tile
RAGGED_BIG = (4000, 3992, 4104)
MATMUL_BIG_TILES = {"bfloat16": dict(bm=128, bn=256, bk=64), "float32": dict(bm=128, bn=128, bk=32)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_ragged_large_shape_on_card(dtype):
    dev = _cuda_or_skip()
    M, K, N = RAGGED_BIG
    g = torch.Generator().manual_seed(3)
    x = torch.randn((M, K), generator=g).to(dev, DTYPES[dtype])
    y = torch.randn((K, N), generator=g).to(dev, DTYPES[dtype])
    got = ops.matmul(x, y, **MATMUL_BIG_TILES[dtype])
    want = ref.matmul_ref(x, y)
    assert got.shape == (M, N) and got.dtype == x.dtype
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol(dtype)["atol"] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_integer_exact_at_4096_on_card(dtype):
    """Small integers: every product and partial sum is exact in float32, so
    both kernels must match the float64 product exactly."""
    dev = _cuda_or_skip()
    g = torch.Generator().manual_seed(4)
    x, y = (torch.randint(-8, 9, (4096, 4096), generator=g).to(dev, DTYPES[dtype])
            for _ in range(2))
    got = ops.matmul(x, y, **MATMUL_BIG_TILES[dtype])
    assert torch.equal(got, (x.double() @ y.double()).to(x.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(128, 128, 128), (128, 256, 64), (64, 16, 16), (128, 48, 48),
                                  (64, 96, 32), (128, 256, 16), (64, 128, 128)])
def test_matmul_bf16_wgmma_tiles_on_card(tile):
    """Every width of wgmma (16..256), both warpgroup counts and the three
    swizzles of a stage's rows (32, 64 and 128 bytes) against the plain
    version."""
    dev = _cuda_or_skip()
    bm, bn, bk = tile
    M, K, N = 2 * bm, 3 * bk, 2 * bn
    x, y = matmul_operands(M, K, N, "bfloat16")
    xt, yt = (torch.as_tensor(a).to(dev, torch.bfloat16) for a in (x, y))
    got = mm.matmul(xt, yt, bm=bm, bn=bn, bk=bk)
    want = ref.matmul_ref(xt, yt)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **tol("bfloat16"))


@pytest.mark.gpu
def test_matmul_bf16_refuses_a_tile_wgmma_does_not_take_on_card():
    """No fallback: the call raises before any kernel runs."""
    dev = _cuda_or_skip()
    x = torch.zeros((256, 256), device=dev, dtype=torch.bfloat16)
    before = mm.launches
    for tile, message in ((dict(bm=32, bn=128, bk=64), "bm=32"),
                          (dict(bm=128, bn=24, bk=64), "bn=24"),
                          (dict(bm=128, bn=128, bk=8), "bk=8")):
        with pytest.raises(ValueError, match=message):
            ops.matmul(x, x, **tile)
    assert mm.launches == before


def _on(dev, name, *arrays):
    return [torch.as_tensor(a).to(dev, DTYPES[name]) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Sq,Sk,H,KvH,D,window", FLASH_CASES_CARD)
def test_flash_attention_kernel_matches_plain_on_card(Sq, Sk, H, KvH, D, window, dtype):
    dev = _cuda_or_skip()
    q, k, v = _on(dev, dtype, *attention_operands((2, Sq, H, D), (2, Sk, KvH, D), dtype))
    before = fa.launches
    got = ops.mha(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.shape == q.shape and got.dtype == q.dtype
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True, window=window).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kv_len_masks_on_card(causal):
    """Keys at or past ``kv_len`` never attend, whatever they hold."""
    dev = _cuda_or_skip()
    q, k, v = _on(dev, "float32", *attention_operands((1, 2, 80, 32), (1, 2, 64, 32), "float32"))
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=48)
    want = ref.flash_attention_ref(q, k[:, :, :48], v[:, :, :48], causal=causal)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol("float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L,H,KvH,D,length", DECODE_CASES_CARD)
def test_decode_attention_kernel_matches_plain_on_card(L, H, KvH, D, length, dtype):
    dev = _cuda_or_skip()
    q, k, v = _on(dev, dtype, *attention_operands((3, H, D), (3, L, KvH, D), dtype, seed=3))
    lanes = torch.tensor([length, max(1, length // 3), L], dtype=torch.int32, device=dev)
    for n in (length, lanes):
        before = dec.launches
        got = ops.decode(q, k, v, n)
        torch.cuda.synchronize()
        assert dec.launches == before + 1 and got.shape == q.shape and got.dtype == q.dtype
        want = ref.decode_attention_ref(q, k, v, n)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **tol(dtype))


@pytest.mark.gpu
def test_decode_partials_merge_to_the_full_result_on_card():
    dev = _cuda_or_skip()
    B, L, H, KvH, D, S = 4, 1024, 32, 4, 64, 4
    q, k, v = _on(dev, "float32", *attention_operands((B, H, D), (B, L, KvH, D), "float32", 4))
    lengths = torch.tensor([1, 100, 513, 1024], dtype=torch.int32, device=dev)
    full = ops.decode(q, k, v, lengths)
    shard = L // S
    parts = [ops.decode_partial(q, k[:, s * shard:(s + 1) * shard], v[:, s * shard:(s + 1) * shard],
                                (lengths - s * shard).clamp(0, shard)) for s in range(S)]
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    want = ref.decode_attention_ref(q, k, v, lengths, normalize=False)
    # a shard past a lane's length is wholly masked; its weight exp(-1e30 - m) is 0
    merged = ops.merge_partials(acc, m, l)
    np.testing.assert_allclose(merged.cpu().numpy(), full.cpu().numpy(), rtol=1e-5, atol=1e-5)
    got = ops.decode_partial(q, k, v, lengths)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_attention_kernels_refuse_what_they_do_not_take_on_card():
    """Head dims that are not a multiple of 8 up to 256, and half precision,
    are refused; head dim 48 and rows that are not contiguous run, padded or
    copied, and agree with the plain version."""
    dev = _cuda_or_skip()
    q = torch.as_tensor(normal((1, 4, 8, 48), "float32", 0), device=dev)   # head dim 48
    before = fa.launches
    np.testing.assert_allclose(fa.flash_attention(q, q, q).cpu().numpy(),
                               ref.flash_attention_ref(q, q, q).cpu().numpy(), **tol("float32"))
    assert fa.launches == before + 1
    for D in (50, 264):
        odd = torch.zeros((1, 4, 8, D), device=dev)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(odd, odd, odd)
        with pytest.raises(ValueError, match="head dim"):
            dec.decode_attention(odd[:, :, 0], odd.transpose(1, 2), odd.transpose(1, 2), 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    for Sq, Sk, window, kv_len in FLASH_NO_KEY_CASES:
        before = fa.launches
        with pytest.raises(ValueError, match="see no key"):
            fa.flash_attention(torch.zeros((1, 4, Sq, 64), device=dev),
                               *[torch.zeros((1, 2, Sk, 64), device=dev)] * 2,
                               window=window, kv_len=kv_len)
        assert fa.launches == before
    x = torch.as_tensor(normal((1, 4, 64), "float32", 1), device=dev)
    k = torch.as_tensor(normal((1, 8, 64, 4), "float32", 2), device=dev).transpose(2, 3)
    v = torch.as_tensor(normal((1, 8, 4, 64), "float32", 3), device=dev)
    np.testing.assert_allclose(dec.decode_attention(x, k, v, 8).cpu().numpy(),
                               ref.decode_attention_ref(x, k, v, 8).cpu().numpy(),
                               **tol("float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,P,N,chunk", SSD_CASES_CARD)
def test_ssd_scan_kernel_matches_plain_on_card(S, H, P, N, chunk):
    """Within test_ssd_scan's tolerance of the step-by-step recurrence."""
    dev = _cuda_or_skip()
    x, dA, Bc, Cc = _on(dev, "float32", *ssd_operands(2, S, H, P, N))
    before = ssd_k.launches
    got = ops.ssd_scan(x, dA, Bc, Cc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_k.launches == before + 1 and got.shape == x.shape
    want, _ = ref.ssd_scan_ref(x, dA, Bc, Cc)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4)


# Mamba-2's prefill (4 x 2048, H 48, P 64, N 128, chunk 256) and a ragged S,
# with slow decays: decay logs in [-0.02, -0.001], as Mamba-2's dt range of
# 1e-3 to 1e-1 gives them.  There every score tile of a chunk and the state
# carried across chunks move y by far more than the tolerance; at the
# reference test's rates the tiles two below the diagonal do not.
SSD_SLOW_CASES_CARD = [(2048, 48, 64, 128, 256), (2000, 48, 64, 128, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,P,N,chunk", SSD_SLOW_CASES_CARD)
def test_ssd_scan_kernel_far_tiles_count_on_card(S, H, P, N, chunk):
    """Within test_ssd_scan's tolerance of the step-by-step recurrence in
    float64, with slow decays at Mamba-2's widths."""
    dev = _cuda_or_skip()
    x, dA, Bc, Cc = _on(dev, "float32", *ssd_operands(4, S, H, P, N, lo=0.001, hi=0.02))
    got = ops.ssd_scan(x, dA, Bc, Cc, chunk=chunk)
    want, _ = ref.ssd_scan_ref(*(t.double() for t in (x, dA, Bc, Cc)))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_ssd_kernel_matches_model_core_on_card():
    """The model's dispatch on the card equals the chunked core the CPU runs,
    at the reference's test_ssd_kernel_matches_model_core shape.  (At
    Mamba-2's widths the float32 chunked core is itself outside 2e-4 of the
    recurrence: its within-chunk cumsum loses the decays' precision, which
    K5 keeps in double; the kernel is held to the recurrence there.)"""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(6)
    Bb, S, H, P, N, Q = 1, 64, 2, 16, 16, 16
    xh, dt0, a0, Bc, Cc, D = _on(dev, "float32", rng.standard_normal((Bb, S, H, P)),
                                 rng.standard_normal((Bb, S, H)), rng.standard_normal(H),
                                 rng.standard_normal((Bb, S, N)), rng.standard_normal((Bb, S, N)),
                                 rng.standard_normal(H))
    dt, A = torch.nn.functional.softplus(dt0), -torch.exp(a0 * 0.2)
    y = ops.ssd_scan(xh * dt[..., None], dt * A, Bc, Cc, chunk=Q) + xh * D[None, None, :, None]
    want, _ = ssd.ssd_core_chunked(xh, dt, A, Bc, Cc, D, Q)
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S,D", RGLRU_CASES_CARD)
def test_rglru_scan_kernel_matches_plain_on_card(S, D):
    dev = _cuda_or_skip()
    a, b = _on(dev, "float32", *rglru_operands(2, S, D, hi=0.999))
    before = rg.launches
    got = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rg.launches == before + 1 and got.shape == a.shape
    want, _ = ref.rglru_scan_ref(a, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_scan_kernels_refuse_what_they_do_not_take_on_card():
    dev = _cuda_or_skip()
    x, dA, Bc, Cc = (t.to(dev) for t in map(torch.as_tensor, ssd_operands(1, 16, 2, 8, 8)))
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x.bfloat16(), dA, Bc, Cc)
    wide = torch.zeros((1, 16, 129), device=dev)
    with pytest.raises(ValueError, match="state size"):
        ops.ssd_scan(x, dA, wide, wide)
    a = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_recurrent_model_on_card_equals_the_cpu(arch):
    """The prefill step through K5 / K6 (and windowed K3) equals the plain
    CPU forward, and the wave-refilling Engine, through K4 where the model
    has attention, gives the CPU Engine's greedy tokens."""
    dev = _cuda_or_skip()
    cfg = get_smoke_config(arch)
    params = transformer.init_lm(0, cfg, device="cpu")
    on_card = _to(params, dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    before = {"ssd": ssd_k.launches, "rglru": rg.launches, "flash": fa.launches}
    got, _ = transformer.lm_forward(on_card, {"tokens": torch.as_tensor(toks)}, cfg)
    torch.cuda.synchronize()
    kinds = [k for s in cfg.segments for k in s.pattern * s.repeats]
    assert ssd_k.launches - before["ssd"] == kinds.count("ssd")
    assert rg.launches - before["rglru"] == kinds.count("rglru")
    assert fa.launches - before["flash"] == kinds.count("local_attn")
    want, _ = transformer.lm_forward(params, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    done = {}
    for where, p in (("cpu", params), ("card", on_card)):
        eng = serve.Engine(cfg, 3, 32, device=dev if where == "card" else "cpu", params=p)
        assert eng.wave
        before_dec = dec.launches
        out, steps = serve.serve_requests(eng, serve.make_requests(6, 5, 6, cfg.vocab))
        done[where] = [(r.rid, r.out) for r in out]
        if where == "card":
            assert dec.launches - before_dec == kinds.count("local_attn") * eng.decode_calls
    assert done["card"] == done["cpu"]


# -- the Hopper designs of K3 (bf16 on wgmma) and K4 (one split-KV launch) ----------

# (B, Sq, Sk, H, KvH, D, causal, window, kv_len): every head dim, Sq and Sk off
# the tiles (128 query rows, 128 keys; 64 at D 256), GQA groups 1/2/8/16,
# windows that start mid-tile, kv_len short of Sk
FLASH_WGMMA_CASES = [
    (2, 100, 100, 4, 4, 16, True, None, None),
    (1, 64, 64, 2, 2, 16, False, None, 40),
    (2, 130, 200, 4, 2, 32, True, 50, None),
    (1, 300, 300, 8, 1, 64, True, 77, None),
    (2, 1000, 1024, 32, 4, 64, True, None, 1000),
    (2, 257, 257, 16, 1, 128, True, None, 200),
    (1, 190, 190, 4, 2, 128, False, None, None),
    (1, 300, 300, 16, 1, 256, True, 100, None),
    (2, 129, 129, 8, 2, 256, True, None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["model view", "contiguous"])
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D,causal,window,kv_len", FLASH_WGMMA_CASES)
def test_flash_bf16_wgmma_matches_plain_on_card(B, Sq, Sk, H, KvH, D, causal, window, kv_len,
                                               layout):
    """bf16 runs the wgmma kernel at every head dim, held to the reference
    tests' tolerance; on (B,H,S,D) views of (B,S,H,D) tensors, as ops.mha
    passes them, and on contiguous (B,H,S,D) tensors."""
    dev = _cuda_or_skip()
    q, k, v = _on(dev, "bfloat16", *attention_operands((B, Sq, H, D), (B, Sk, KvH, D),
                                                       "bfloat16", seed=D + Sq))
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    if layout == "contiguous":
        q, k, v = (x.contiguous() for x in (q, k, v))
    assert fa.KERNEL[torch.bfloat16] == "flash_bf16_wgmma"
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.shape == q.shape and got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **tol("bfloat16"))


@pytest.mark.gpu
def test_flash_bf16_copies_rows_tma_cannot_read_on_card():
    """TMA reads whole 16 bytes: a bf16 row stride of 68 elements cannot be
    read in place, so the wrapper copies the rows to contiguous ones and the
    kernel runs once on the copy, in agreement with the plain version."""
    dev = _cuda_or_skip()
    wide = torch.as_tensor(normal((1, 2, 64, 68), "bfloat16", 4), device=dev,
                           dtype=torch.bfloat16)[..., :64]
    assert not fa.rows_readable(wide)
    before = fa.launches
    got = fa.flash_attention(wide, wide, wide)
    assert fa.launches == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.flash_attention_ref(wide, wide, wide).float().cpu().numpy(),
                               **tol("bfloat16"))


# (H, KvH, D): groups 1, 2, 8 and 16, every head dim
DECODE_SPLIT_CASES = [(4, 4, 16), (8, 4, 32), (16, 2, 64), (32, 4, 64), (16, 1, 128),
                      (16, 1, 256), (6, 3, 256)]


def _split_lengths(L, chunk):
    """One lane per length of interest: 0, 1, chunk - 1, chunk, chunk + 1, L."""
    return torch.tensor([0, 1, chunk - 1, chunk, chunk + 1, L], dtype=torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,KvH,D", DECODE_SPLIT_CASES)
def test_decode_one_launch_per_lane_lengths_on_card(H, KvH, D, dtype):
    """One launch a call, normalised and not, against the plain version at
    lengths around a chunk's edges (and 0, whose weights are uniform)."""
    dev = _cuda_or_skip()
    B, L = 6, 700
    q, k, v = _on(dev, dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype, seed=D))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, n_chunks = dec.split(L, B * KvH, D, sms)
    assert n_chunks > 1
    n = _split_lengths(L, chunk).to(dev)
    before = dec.launches
    got = ops.decode(q, k, v, n)
    acc, m, l = ops.decode_partial(q, k, v, n)
    torch.cuda.synchronize()
    assert dec.launches == before + 2
    want = ref.decode_attention_ref(q, k, v, n)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol(dtype))
    for g, w in zip((acc, m, l), ref.decode_attention_ref(q, k, v, n, normalize=False)):
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_workspace_grows_and_stays_right_on_card(dtype):
    """Calls of different shapes back to back: a small one, one that needs a
    larger workspace (more lanes, KV heads and chunks), the small one again."""
    dev = _cuda_or_skip()
    shapes = [(2, 128, 8, 2, 64), (8, 4096, 16, 8, 64), (2, 128, 8, 2, 64), (3, 2000, 16, 1, 256)]
    for i, (B, L, H, KvH, D) in enumerate(shapes):
        q, k, v = _on(dev, dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype, seed=i))
        n = torch.tensor([L // (b + 1) for b in range(B)], dtype=torch.int32, device=dev)
        got = ops.decode(q, k, v, n)
        want = ref.decode_attention_ref(q, k, v, n)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_graph_replay_equals_eager_on_card(dtype):
    """A K4 call captured in a CUDA graph and replayed three times gives the
    eager result each time: the merging blocks leave their counters at 0."""
    dev = _cuda_or_skip()
    B, L, H, KvH, D = 4, 1024, 32, 4, 64
    q, k, v = _on(dev, dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype, seed=9))
    n = torch.tensor([1, 100, 513, 1024], dtype=torch.int32, device=dev)
    eager = ops.decode(q, k, v, n).clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        ops.decode(q, k, v, n)                   # warm-up on the capturing stream
        with torch.cuda.graph(graph, stream=stream):
            out = ops.decode(q, k, v, n)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    _, counters = dec._workspaces[q.device.index]
    assert int(counters.abs().sum()) == 0


# -- C4: what the reference takes, the card takes ------------------------------------

# (H, KvH): 32 and 64 query heads a KV head, and 20 (a group of 16 and one of 4)
DECODE_WIDE_GROUPS = [(32, 1), (128, 2), (20, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,KvH", DECODE_WIDE_GROUPS)
def test_decode_takes_any_group_on_card(H, KvH, dtype):
    """More query heads a KV head than the 16 rows of an mma tile: groups of
    16, one launch, the output and the normalize=False partials (acc, m, l)
    as the plain version gives them, at lengths around a chunk's edges."""
    dev = _cuda_or_skip()
    B, L, D = 6, 700, 64
    q, k, v = _on(dev, dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype, seed=H))
    chunk, _ = dec.split(L, B * dec.groups(H, KvH), D,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    n = _split_lengths(L, chunk).to(dev)
    before = dec.launches
    got = ops.decode(q, k, v, n)
    parts = ops.decode_partial(q, k, v, n)
    torch.cuda.synchronize()
    assert dec.launches == before + 2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.decode_attention_ref(q, k, v, n).float().cpu().numpy(),
                               **tol(dtype))
    for g, w in zip(parts, ref.decode_attention_ref(q, k, v, n, normalize=False)):
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [48, 80])
def test_attention_kernels_take_head_dims_between_theirs_on_card(D, dtype):
    """D 48 and 80 run zero-padded to 64 and 128 under the scale of the true
    D, and come back cut to D: K3 (causal, GQA, a window) and K4 (normalised
    and partial) against their plain versions."""
    dev = _cuda_or_skip()
    q, k, v = _on(dev, dtype, *attention_operands((2, 100, 8, D), (2, 100, 2, D), dtype, seed=D))
    for window in (None, 30):
        got = ops.mha(q, k, v, causal=True, window=window)
        assert got.shape == q.shape
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       causal=True, window=window).transpose(1, 2)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **tol(dtype))
    qd = q[:, -1]
    n = torch.tensor([1, 77], dtype=torch.int32, device=dev)
    got = ops.decode(qd, k, v, n)
    assert got.shape == qd.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.decode_attention_ref(qd, k, v, n).float().cpu().numpy(),
                               **tol(dtype))
    for g, w in zip(ops.decode_partial(qd, k, v, n),
                    ref.decode_attention_ref(qd, k, v, n, normalize=False)):
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_kernels_copy_unaligned_rows_on_card(dtype):
    """Tensors whose data starts off 16 bytes: K3 and K4 copy them to
    contiguous rows and agree with the plain version."""
    dev = _cuda_or_skip()
    B, S, H, KvH, D = 2, 70, 4, 2, 64

    def off_by_one(shape, seed):
        x = torch.as_tensor(normal((int(np.prod(shape)) + 1,), dtype, seed), device=dev)
        return x.to(DTYPES[dtype])[1:].view(shape)

    q, k, v = off_by_one((B, H, S, D), 20), off_by_one((B, KvH, S, D), 21), \
        off_by_one((B, KvH, S, D), 22)
    assert not any(fa.rows_readable(t) for t in (q, k, v))
    np.testing.assert_allclose(fa.flash_attention(q, k, v).float().cpu().numpy(),
                               ref.flash_attention_ref(q, k, v).float().cpu().numpy(),
                               **tol(dtype))
    qd, kc = off_by_one((B, H, D), 23), off_by_one((B, S, KvH, D), 24)
    np.testing.assert_allclose(ops.decode(qd, kc, kc, 50).float().cpu().numpy(),
                               ref.decode_attention_ref(qd, kc, kc, 50).float().cpu().numpy(),
                               **tol(dtype))


# -- C5: a captured graph never sees K4's workspace freed ----------------------------


def _fresh_workspace(dev):
    """Start from no workspace; what a test before this one held stays alive."""
    held = dec._workspaces.pop(torch.cuda.current_device(), None)
    if held is not None:
        dec._retired.extend(held)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_graph_replays_right_after_the_workspace_grows_on_card(dtype):
    """Capture a K4 call on a small workspace, grow the workspace by a larger
    eager call, then replay: the graph still writes into the memory it
    captured (kept alive), and gives the eager result."""
    dev = _cuda_or_skip()
    _fresh_workspace(dev)
    B, L, H, KvH, D = 4, 1024, 32, 4, 64
    q, k, v = _on(dev, dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype, seed=12))
    n = torch.tensor([1, 100, 513, 1024], dtype=torch.int32, device=dev)
    eager = ops.decode(q, k, v, n).clone()
    small, _ = dec._workspaces[q.device.index]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = ops.decode(q, k, v, n)
    torch.cuda.current_stream().wait_stream(stream)
    big = _on(dev, dtype, *attention_operands((16, 64, 64), (16, 8192, 4, 64), dtype, seed=13))
    ops.decode(*big, 8192)
    grown, _ = dec._workspaces[q.device.index]
    assert grown.numel() > small.numel() and any(t is small for t in dec._retired)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    np.testing.assert_allclose(ops.decode(q, k, v, n).float().cpu().numpy(),
                               eager.float().cpu().numpy(), **tol(dtype))


@pytest.mark.gpu
def test_decode_workspace_does_not_grow_inside_a_capture_on_card():
    """A call that needs a larger workspace inside a capture raises a
    RuntimeError that names the size, and launches nothing."""
    dev = _cuda_or_skip()
    _fresh_workspace(dev)
    q, k, v = _on(dev, "bfloat16", *attention_operands((2, 8, 64), (2, 256, 2, 64), "bfloat16", 14))
    ops.decode(q, k, v, 256)
    big = _on(dev, "bfloat16", *attention_operands((16, 64, 64), (16, 8192, 4, 64), "bfloat16",
                                                   15))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = dec.launches
    with pytest.raises(RuntimeError, match="must grow to .* inside a CUDA-graph capture"):
        with torch.cuda.stream(stream):
            with torch.cuda.graph(graph, stream=stream):
                ops.decode(*big, 8192)
    torch.cuda.synchronize()
    assert dec.launches == before


# -- K5 on Hopper: several launches a call, scratch from the caching allocator ----------


@pytest.mark.gpu
def test_ssd_scan_graph_replay_equals_eager_on_card():
    """A K5 call (four kernels, its scratch allocated inside the capture)
    captured in a CUDA graph and replayed three times gives the eager result
    each time."""
    dev = _cuda_or_skip()
    x, dA, Bc, Cc = _on(dev, "float32", *ssd_operands(2, 600, 4, 64, 128, lo=0.001, hi=0.02))
    eager = ops.ssd_scan(x, dA, Bc, Cc, chunk=256).clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        ops.ssd_scan(x, dA, Bc, Cc, chunk=256)         # warm-up on the capturing stream
        with torch.cuda.graph(graph, stream=stream):
            out = ops.ssd_scan(x, dA, Bc, Cc, chunk=256)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.gpu
def test_ssd_scan_launcher_refuses_scratch_smaller_than_its_layout_on_card():
    """The launcher holds the scratch it is given to its own layout: each of
    C Bᵀ, the states and the decays one element short of ``scratch_shapes``
    is refused before any kernel runs; the scratch as the wrapper allocates
    it runs, and gives the wrapper's result."""
    dev = _cuda_or_skip()
    xs, dAs, Bc, Cc = _on(dev, "float32", *ssd_operands(1, 600, 2, 24, 20))
    x, dA = xs.transpose(1, 2), dAs.transpose(1, 2)
    y = torch.empty_like(x)
    full = [torch.empty(shape, device=dev)
            for shape in ssd_k.scratch_shapes(1, 2, 600, 24, 20, 256).values()]
    for i in range(3):
        short = list(full)
        short[i] = full[i].flatten()[1:]
        with pytest.raises(RuntimeError, match="cudaError"):
            ssd_k._launch(x, dA, Bc, Cc, y, *short, 256)
    ssd_k._launch(x, dA, Bc, Cc, y, *full, 256)
    assert torch.equal(y, ssd_k.ssd_scan(x, dA, Bc, Cc, chunk=256))


# -- the RTL simulator's kernel ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("hierarchy", HIERARCHIES)
@pytest.mark.parametrize("kernel", sorted(RTL_KERNELS))
def test_rtl_sim_kernel_matches_plain_on_card(kernel, hierarchy):
    """S1 against ``_TorchOps`` on the card, every design of the matrix:
    arrays, returns, valid flags, conflict counts and per-cycle traces."""
    dev = _cuda_or_skip()
    module, entry = rtl_design(kernel)
    batch = rtl_stimulus(kernel, 300)
    sim, prepared = port_sim.simulator_for(module, entry, hierarchy=hierarchy, device=dev)
    plain, _ = port_sim.simulator_for(module, entry, hierarchy=hierarchy, backend="torch",
                                      device=dev)
    assert sim.backend == "cuda" and plain.backend == "torch"
    cycles = port_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
    before = sim.cuda_kernel().launches
    got = sim.run(batch, cycles, batched=True, trace=True)
    assert sim.cuda_kernel().launches == before + 1
    assert_same_sim_result(got, plain.run(batch, cycles, batched=True, trace=True))


@pytest.mark.gpu
def test_rtl_sim_kernel_counts_conflicts_per_lane_on_card():
    """A §4.5 assert that fires in some lanes: the kernel counts it lane by
    lane as the plain version does, and the run raises unless told not to
    check."""
    dev = _cuda_or_skip()
    plain, cycles = conflict_probe("torch", dev)
    kernel, _ = conflict_probe("cuda", dev)
    batch = rtl_stimulus("mac", 300)
    got = kernel.run(batch, cycles, batched=True, check_conflicts=False, trace=True)
    want = plain.run(batch, cycles, batched=True, check_conflicts=False, trace=True)
    assert_same_sim_result(got, want)
    np.testing.assert_array_equal(got.conflicts, batch[0] & 1)
    with pytest.raises(port_sim.RTLSimError, match="port conflict"):
        kernel.run(batch, cycles, batched=True)


@pytest.mark.gpu
def test_rtl_sim_kernel_build_failure_raises_on_card():
    """A source nvcc refuses raises at the run, and nothing runs in its place."""
    from repro_torch.kernels import _build

    dev = _cuda_or_skip()
    module, entry = rtl_design("array_add")
    sim, prepared = port_sim.simulator_for(module, entry, device=dev)
    kernel = sim.cuda_kernel()
    kernel.source += "\n#error refused on purpose\n"
    batch = rtl_stimulus("array_add", 8)
    with pytest.raises(_build.BuildError, match="refused on purpose"):
        sim.run(batch, port_sim.probe_cycles(prepared, entry, [c[0] for c in batch]),
                batched=True)
    assert kernel.launches == 0 and sim.backend == "cuda"


@pytest.mark.gpu
def test_dse_front_verified_on_card():
    """The DSE oracle and the front's batched verification on the card: the
    oracle there gives what it gives on the CPU, and every front point is
    verified on 64 vectors by the simulator's kernel."""
    from repro_torch.core.codegen import sim_cuda
    from repro_torch.core.hls import dse

    dev = _cuda_or_skip()
    dse.clear_oracle_cache()
    module, entry = port_gallery.array_add.build(n=8)
    inputs = port_gallery.array_add.make_inputs(n=8, seed=2)
    np.testing.assert_array_equal(dse.oracle_expected(module, entry, inputs),
                                  dse.oracle_expected(module, entry, inputs, device="cpu"))
    res = dse.explore_design(module, dse.design_space(pipeline=(True, False)), entry=entry,
                             inputs=inputs)
    batch = port_sim.stack_stimulus(port_gallery.array_add.make_inputs, 64, base_seed=50, n=8)
    before = sim_cuda.launches
    n_ok = dse.sim_verify_front(module, res, entry=entry, args_batch=batch, device=dev)
    assert n_ok == len(res.front) > 0
    assert sim_cuda.launches == before + len(res.front)
    assert all(p.batch_verified and p.batch_vectors == 64 for p in res.front)
    dse.clear_oracle_cache()


@pytest.mark.gpu
def test_run_differential_on_card_at_4096_vectors():
    """The designer's check on the card: every leg passes on the kernel."""
    dev = _cuda_or_skip()
    module, entry = rtl_design("gemm")
    oracle, nargs = rtl_oracle("gemm")
    rep = port_sim.run_differential(module, entry, rtl_stimulus("gemm", 4096), kernel="gemm",
                                    oracle=oracle, oracle_nargs=nargs, device=dev)
    assert rep.ok, rep.mismatches[:5]
    assert rep.backend == "cuda" and rep.n_vectors == 4096 and rep.oracle_ok is True


# -- the traced designs of the frontend -------------------------------------------------

TRACED = ["frontend_matmul", "frontend_scan", "frontend_softmax_row"]
# the workloads' own sizes, and the larger ones chip_smoke.py runs
TRACED_SIZES = [("frontend_matmul", {}), ("frontend_matmul", {"m": 16, "k": 16, "n": 16, "tile": 4}),
                ("frontend_softmax_row", {}), ("frontend_softmax_row", {"n": 4096}),
                ("frontend_scan", {}), ("frontend_scan", {"n": 4096})]


def traced_stimulus(gal, size, lanes):
    """``lanes`` seeded input vectors, batch first (``tile`` is build's alone)."""
    kw = {k: v for k, v in size.items() if k != "tile"}
    per_lane = [gal.make_inputs(**kw, seed=s) for s in range(lanes)]
    return [np.stack([lane[i] for lane in per_lane]) for i in range(len(per_lane[0]))]


@pytest.mark.gpu
@pytest.mark.parametrize("gal_name,size", TRACED_SIZES)
def test_traced_design_on_card_equals_its_oracle_on_every_lane(gal_name, size):
    """A PyTorch program traced into HIR, optimized and lowered to the
    generated kernel (K1): 4096 lanes at once, each lane the oracle's."""
    dev = _cuda_or_skip()
    gal = port_gallery.GALLERY[gal_name]
    module, name = gal.build(**size)
    PassManager.from_spec(DEFAULT_PIPELINE_SPEC).run(module)
    fn = lower_to_cuda(module, name, device=dev)
    batch = traced_stimulus(gal, size, 4096)
    ins = [torch.as_tensor(x).to(dev, torch.int32) for x in batch[:2]]
    got = fn(*ins)["out"]
    assert torch.equal(got, fn.plain(*ins)["out"])
    got = got.cpu().numpy().astype(np.int64)
    for s in range(4096):
        np.testing.assert_array_equal(got[s], gal.oracle(batch[0][s], batch[1][s]), err_msg=str(s))


@pytest.mark.gpu
@pytest.mark.parametrize("hierarchy", HIERARCHIES)
@pytest.mark.parametrize("gal_name", TRACED)
def test_traced_design_run_differential_on_card(gal_name, hierarchy):
    """The frontend test's differential matrix on the card's simulator kernel
    at 4096 vectors: every leg, every RTL pass."""
    dev = _cuda_or_skip()
    gal = port_gallery.GALLERY[gal_name]
    module, entry = gal.build()
    batch = port_sim.stack_stimulus(gal.make_inputs, 4096, base_seed=7)
    rep = port_sim.run_differential(module, entry, batch, kernel=gal_name, hierarchy=hierarchy,
                                    oracle=gal.oracle, oracle_nargs=2, device=dev)
    assert rep.ok, rep.mismatches[:5]
    assert rep.backend == "cuda" and rep.n_vectors == 4096 and rep.oracle_ok is True
    assert rep.passes_ok and all(rep.passes_ok.values()), rep.passes_ok


# -- the MoE layer and head dim 128 at one query head a KV head (qwen2-moe) -------------

MOE = "qwen2-moe-a2.7b"


def moe_tokens(cfg, T, seed):
    """T tokens drawn from 256 distinct vectors that share a direction
    (routing skewed), in the config's dtype."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(min(T, 256), cfg.d_model)) + 3 * rng.normal(size=cfg.d_model)
    x = base[rng.permutation(np.arange(T) % len(base))]
    return torch.as_tensor(x[None], dtype=torch.float32).to(
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def top_k_margin(p, x, k):
    """The smallest gap, in router logits computed in float64, between a
    token's k-th and (k+1)-th expert: far above float32's rounding, no
    token's routing can differ between two summation orders."""
    logits = x[0].double() @ p["router"].double()
    top = torch.sort(logits, dim=-1, descending=True).values
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.gpu
@pytest.mark.parametrize("case,T", [("smoke", 37), ("full width", 4), ("full width", 4096)])
def test_moe_layer_on_card_equals_the_cpu(case, T):
    """``moe_forward_local`` on the card (expert products as ``torch.bmm``,
    the gate-weighted sum an atomic ``index_add_``) against its CPU run on
    the same weights and tokens: the smoke config in float32 at 1e-5; one
    full-width layer of qwen2-moe (60 experts of 1408, top-4, shared 5632)
    in bfloat16 at 2e-2 |cpu| + 2e-2 max |cpu|, the reference kernel tests'
    bf16 tolerance scaled by the result's magnitude, as chip_smoke.py holds
    the matmul: the routed and the shared outputs are each rounded to bf16
    before they are added, so where they cancel the sum keeps their
    rounding (half an ulp of values near 10 is 0.03)."""
    dev = _cuda_or_skip()
    cfg = get_smoke_config(MOE) if case == "smoke" else get_config(MOE)
    p = mlp.init_moe(torch.Generator().manual_seed(0), cfg)
    x = moe_tokens(cfg, T, seed=1)
    assert top_k_margin(p, x, cfg.moe.top_k) > 5e-5
    want, want_aux = mlp.moe_forward_local(p, x, cfg)
    got, aux = mlp.moe_forward_local(_to(p, dev), x.to(dev), cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype and got.device.type == "cuda"
    want32 = want.float().numpy()
    t, atol = (1e-5, 1e-5) if case == "smoke" else (2e-2, 2e-2 * np.abs(want32).max())
    np.testing.assert_allclose(got.float().cpu().numpy(), want32, rtol=t, atol=atol)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.gpu
def test_moe_model_on_card_equals_the_cpu():
    """qwen2-moe's smoke model: the forward through K3 (one launch a layer)
    and its aux loss equal the plain CPU forward."""
    dev = _cuda_or_skip()
    cfg = get_smoke_config(MOE)
    params = transformer.init_lm(0, cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    before = fa.launches
    got, aux = transformer.lm_forward(_to(params, dev), {"tokens": torch.as_tensor(toks)}, cfg)
    torch.cuda.synchronize()
    assert fa.launches - before == 2
    want, want_aux = transformer.lm_forward(params, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_kernels_at_head_dim_128_group_1_on_card(dtype):
    """K3 and K4 at qwen2-moe's heads (16 query heads, 16 KV heads of 128):
    a prefill off the tiles and a cache of 1024 with a length per lane."""
    dev = _cuda_or_skip()
    q, k, v = _on(dev, dtype, *attention_operands((2, 300, 16, 128), (2, 300, 16, 128), dtype))
    got = ops.mha(q, k, v, causal=True)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol(dtype))
    q, k, v = _on(dev, dtype, *attention_operands((4, 16, 128), (4, 1024, 16, 128), dtype, seed=9))
    n = torch.tensor([1, 100, 513, 1024], dtype=torch.int32, device=dev)
    got = ops.decode(q, k, v, n)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.decode_attention_ref(q, k, v, n).float().cpu().numpy(),
                               **tol(dtype))


def test_simulator_for_without_a_device_raises_where_there_is_no_cuda():
    """The simulator's entry points never pick the CPU on the caller's
    behalf (the CPU side of the rule; skips on a machine with a card)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device resolves")
    module, entry = rtl_design("array_add")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sim.simulator_for(module, entry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sim.run_differential(module, entry, rtl_stimulus("array_add", 4))
