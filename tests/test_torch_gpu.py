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

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import gallery as port_gallery
from repro_torch.core import ir as port_ir
from repro_torch.core.builder import Builder as PortBuilder
from repro_torch.core.codegen import sim as port_sim
from repro_torch.core.codegen.rtl import Binop, Const, PortConflictAssert, Ref
from repro_torch.core.gallery import gemm
from repro_torch.configs.registry import get_config, get_smoke_config, list_archs
from repro_torch.core.lower import lower_to_cuda
from repro_torch.core.passes import DEFAULT_PIPELINE_SPEC, PassManager
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.launch import serve
from repro_torch.models import mla, mlp, ssd, transformer

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


# (B, S, H, P, N, chunk, decay logs) of S3 against its plain backward: the
# chip rows' shapes — Mamba-2's train step (4 x 2048), one chunk, two chunks
# and a ragged tail at its widths, with Mamba-2's slow decays — then the
# reference test's rates, N and P off the tiles, rows off 16 bytes, a chunk
# of 3
SLOW_RATES = (0.001, 0.02)
SSD_BWD_CASES_CARD = [(4, 2048, 48, 64, 128, 256, SLOW_RATES),
                      (2, 200, 8, 64, 128, 256, SLOW_RATES),
                      (2, 512, 8, 64, 128, 256, SLOW_RATES),
                      (2, 2000, 8, 64, 128, 256, SLOW_RATES),
                      (2, 1000, 4, 64, 128, 256, (0.01, 0.5)),
                      (2, 300, 2, 80, 32, 64, (0.01, 0.5)),
                      (2, 77, 3, 24, 20, 8, (0.01, 0.5)),
                      (2, 150, 2, 13, 7, 100, (0.01, 0.5)),
                      (1, 5, 1, 1, 1, 3, (0.01, 0.5))]
# (B, S, D) of S4: RecurrentGemma's train step (2 x 4096, d_rnn 4096), then
# the forward's cases on the card
RGLRU_BWD_CASES_CARD = [(2, 4096, 4096)] + [(2, S, D) for S, D in RGLRU_CASES_CARD]


def held_to_plain(got, want, tol=2e-4):
    """Each tensor within ``tol`` of its largest |plain| (the chip rows' rule)."""
    for i, (g, w) in enumerate(zip(got, want)):
        err = float((g.double() - w.double()).abs().max())
        assert g.shape == w.shape and err <= tol * float(w.double().abs().max()), (i, err)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,rates", SSD_BWD_CASES_CARD)
def test_ssd_scan_bwd_kernel_matches_plain_on_card(B, S, H, P, N, chunk, rates):
    """S3, through autograd of ``ops.ssd_scan``, against the plain backward
    in float64 on the same inputs: dx, ddA, dB and dC each within 2e-4 of
    its largest |plain|; one launch of K5 and one of S3."""
    dev = _cuda_or_skip()
    lo, hi = rates
    x, dA, Bc, Cc = _on(dev, "float32", *ssd_operands(B, S, H, P, N, lo=lo, hi=hi))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    leaves = [t.requires_grad_() for t in (x, dA, Bc, Cc)]
    before = (ssd_k.launches, ssd_k.bwd_launches)
    ops.ssd_scan(*leaves, chunk=chunk).backward(dy)
    torch.cuda.synchronize()
    assert (ssd_k.launches - before[0], ssd_k.bwd_launches - before[1]) == (1, 1)
    want = ref.ssd_scan_bwd_ref(*(t.detach().double() for t in (x, dA, Bc, Cc, dy)))
    held_to_plain([t.grad for t in leaves], want)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D", RGLRU_BWD_CASES_CARD)
def test_rglru_scan_bwd_kernel_matches_plain_on_card(B, S, D):
    """S4, through autograd of ``ops.rglru_scan``, against the plain backward
    in float64 on the kernel's own h: da and db within 2e-4 of their
    largest |plain|."""
    dev = _cuda_or_skip()
    a, b = _on(dev, "float32", *rglru_operands(B, S, D, hi=0.999))
    dh = torch.randn(a.shape, generator=torch.Generator().manual_seed(4)).to(dev)
    a.requires_grad_(), b.requires_grad_()
    before = (rg.launches, rg.bwd_launches)
    h = ops.rglru_scan(a, b)
    h.backward(dh)
    torch.cuda.synchronize()
    assert (rg.launches - before[0], rg.bwd_launches - before[1]) == (1, 1)
    want = ref.rglru_scan_bwd_ref(a.detach().double(), h.detach().double(), dh.double())
    held_to_plain([a.grad, b.grad], want)


SEG = rg.BWD_SEGMENT
# (B, S, D) of S4 at its segments' edges: S a multiple of the segment, one
# step past one, less than one, and D ragged
RGLRU_SEGMENT_CASES_CARD = [(2, 4 * SEG, 96), (3, SEG + 1, 4000), (2, SEG - 1, 33),
                            (1, 2 * SEG + 17, 1), (2, 40 * SEG, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D", RGLRU_SEGMENT_CASES_CARD)
def test_rglru_scan_bwd_at_segment_edges_on_card(B, S, D):
    """S4 where its tiles' segments end: against the plain backward in
    float64 on the kernel's own h, within 2e-4 of each largest |plain|."""
    dev = _cuda_or_skip()
    a, b = _on(dev, "float32", *rglru_operands(B, S, D, hi=0.999, seed=S))
    dh = torch.randn(a.shape, generator=torch.Generator().manual_seed(D)).to(dev)
    h = rg.rglru_scan(a, b)
    got = rg.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    held_to_plain(got, ref.rglru_scan_bwd_ref(a.double(), h.double(), dh.double()))
    assert not got[0][:, 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D", [(2, 2048, 4096), (2, SEG + 1, 33)])
def test_rglru_scan_bwd_gives_the_same_bits_twice_on_card(B, S, D):
    """S4's look-back finds the segments' maps in an order that changes from
    run to run, but every starting g is the same chain of fmaf's: two calls
    on the same inputs give equal da and db."""
    dev = _cuda_or_skip()
    a, b = _on(dev, "float32", *rglru_operands(B, S, D, hi=0.999))
    dh = torch.randn(a.shape, generator=torch.Generator().manual_seed(4)).to(dev)
    h = rg.rglru_scan(a, b)
    first, second = rg.rglru_scan_bwd(a, h, dh), rg.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    for name, x, y in zip(("da", "db"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.gpu
def test_rglru_scan_bwd_finishes_beside_another_kernel_on_card():
    """S4 launched while products on another stream hold SMs, so that only
    some of its grid is resident at first: it claims its tiles in order
    from a counter, so it still finishes, and gives the bits it gives on
    an idle card."""
    dev = _cuda_or_skip()
    a, b = _on(dev, "float32", *rglru_operands(2, 2048, 4096, hi=0.999))
    dh = torch.randn(a.shape, generator=torch.Generator().manual_seed(4)).to(dev)
    h = rg.rglru_scan(a, b)
    alone = rg.rglru_scan_bwd(a, h, dh)
    x = torch.randn((8192, 8192), device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ys = [x @ x for _ in range(4)]
    beside = [rg.rglru_scan_bwd(a, h, dh) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(y).all()) for y in ys)
    for got in beside:
        for name, x1, y1 in zip(("da", "db"), got, alone):
            assert torch.equal(x1, y1), name


@pytest.mark.gpu
def test_scan_kernels_under_grad_launch_forward_and_backward_on_card():
    """K5 and K6 under grad return a result with a ``grad_fn`` after one
    forward launch; its backward is one launch of S3 or S4 (no plain
    version on the card); without grad there is no ``grad_fn``."""
    dev = _cuda_or_skip()
    xs, dA, bc, _ = _on(dev, "float32", *ssd_operands(1, 40, 2, 8, 8))
    a, b = _on(dev, "float32", *rglru_operands(1, 40, 8))
    for t in (xs, a, b):
        t.requires_grad_()
    counters = (ssd_k, rg)
    before = [(m.launches, m.bwd_launches) for m in counters]
    y, h = ops.ssd_scan(xs, dA, bc, bc, chunk=16), ops.rglru_scan(a, b)
    assert y.grad_fn is not None and h.grad_fn is not None
    assert [(m.launches, m.bwd_launches) for m in counters] == [(n + 1, k) for n, k in before]
    (y.sum() + h.sum()).backward()
    torch.cuda.synchronize()
    assert [(m.launches, m.bwd_launches) for m in counters] == [(n + 1, k + 1) for n, k in before]
    assert all(bool(torch.isfinite(t.grad).all()) for t in (xs, a, b))
    with torch.no_grad():
        assert ops.ssd_scan(xs, dA, bc, bc).grad_fn is None and ops.rglru_scan(a, b).grad_fn is None


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


def _ssd_bwd_inputs(dev, B, S, H, P, N, chunk, rates):
    """(B,H,S,P) views of x and dy, dA, B, C, and K5's y and scratch for them."""
    lo, hi = rates
    xs, dAs, Bc, Cc = _on(dev, "float32", *ssd_operands(B, S, H, P, N, lo=lo, hi=hi))
    dy = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    x, dA, dy = xs.transpose(1, 2), dAs.transpose(1, 2), dy.transpose(1, 2)
    y, scratch = ssd_k._forward(x, dA, Bc, Cc, chunk)
    return x, dA, Bc, Cc, dy, y, scratch


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,rates", [SSD_BWD_CASES_CARD[0], SSD_BWD_CASES_CARD[7]])
def test_ssd_scan_bwd_gives_the_same_bits_twice_on_card(B, S, H, P, N, chunk, rates):
    """S3 sums over heads and positions in a fixed order, with no float
    atomics: two calls on the same inputs give equal dx, ddA, dB and dC, at
    Mamba-2's training shape and at P 13 / N 7 over a ragged chunk."""
    dev = _cuda_or_skip()
    x, dA, Bc, Cc, dy, y, scratch = _ssd_bwd_inputs(dev, B, S, H, P, N, chunk, rates)
    first = ssd_k.ssd_scan_bwd(x, dA, Bc, Cc, y, dy, scratch, chunk=chunk)
    second = ssd_k.ssd_scan_bwd(x, dA, Bc, Cc, y, dy, scratch, chunk=chunk)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "ddA", "dB", "dC"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_ssd_scan_bwd_launcher_refuses_scratch_smaller_than_its_layout_on_card():
    """S3's launcher holds each scratch tensor it is given to its layout:
    each of the forward's C Bᵀ, states and decays and its own gst, W, cum
    and r one element short is refused before any kernel runs, and counts no
    launch; the scratch as the wrapper allocates it runs, and gives the
    wrapper's result."""
    dev = _cuda_or_skip()
    B, S, H, P, N, chunk = 1, 600, 2, 80, 20, 256
    x, dA, Bc, Cc, dy, y, scratch = _ssd_bwd_inputs(dev, B, S, H, P, N, chunk, (0.01, 0.5))
    grads = (torch.empty_like(x), torch.empty_like(dA), torch.empty_like(Bc),
             torch.empty_like(Cc))
    own = [torch.empty(shape, dtype=ssd_k.BWD_SCRATCH_DTYPES[name], device=dev)
           for name, shape in ssd_k.bwd_scratch_shapes(B, H, S, P, N, chunk).items()]
    full = [*scratch, *own]
    before = ssd_k.bwd_launches
    for i in range(len(full)):
        short = list(full)
        short[i] = full[i].flatten()[1:]
        with pytest.raises(RuntimeError, match="cudaError"):
            ssd_k._launch_bwd(x, dA, Bc, Cc, y, dy, short[:3], grads, short[3:], chunk)
    assert ssd_k.bwd_launches == before
    ssd_k._launch_bwd(x, dA, Bc, Cc, y, dy, scratch, grads, own, chunk)
    want = ssd_k.ssd_scan_bwd(x, dA, Bc, Cc, y, dy, scratch, chunk=chunk)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "ddA", "dB", "dC"), grads, want):
        assert torch.equal(a, b), name


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
@pytest.mark.parametrize("kernel,size", [("histogram", {"n": 4096, "bins": 256}),
                                         ("conv2d", {"h": 64, "w": 64})])
def test_rtl_sim_kernel_with_state_on_and_off_chip_matches_plain_on_card(kernel, size):
    """S1 at the large sizes, where the 4096-word arrays stay in global
    memory and the bins or line buffers go to shared memory: against
    ``_TorchOps`` on the card on 256 lanes, traces too."""
    dev = _cuda_or_skip()
    module, entry = port_gallery.GALLERY[kernel].build(**size)
    batch = port_sim.stack_stimulus(port_gallery.GALLERY[kernel].make_inputs, 256,
                                    base_seed=7, **size)
    sim, prepared = port_sim.simulator_for(module, entry, device=dev)
    plain, _ = port_sim.simulator_for(module, entry, backend="torch", device=dev)
    assert set(sim.cuda_kernel().layout.placement().values()) >= {"shared", "global"}
    cycles = port_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
    got = sim.run(batch, cycles, batched=True, trace=True)
    assert_same_sim_result(got, plain.run(batch, cycles, batched=True, trace=True))


@pytest.mark.gpu
def test_rtl_sim_kernel_at_65536_lanes_matches_plain_on_card():
    """gemm at its test size on 65,536 lanes (2,048 blocks of 32): against
    ``_TorchOps`` on the card."""
    dev = _cuda_or_skip()
    module, entry = rtl_design("gemm")
    batch = rtl_stimulus("gemm", 65536)
    sim, prepared = port_sim.simulator_for(module, entry, device=dev)
    plain, _ = port_sim.simulator_for(module, entry, backend="torch", device=dev)
    cycles = port_sim.probe_cycles(prepared, entry, [c[0] for c in batch])
    got = sim.run(batch, cycles, batched=True, trace=True)
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
DEEPSEEK = "deepseek-v2-lite-16b"


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
@pytest.mark.parametrize("case,T", [("smoke", 37), ("full width", 4), ("full width", 4096),
                                    ("deepseek full width", 4096)])
def test_moe_layer_on_card_equals_the_cpu(case, T):
    """``moe_forward_local`` on the card (expert products as ``torch.bmm``,
    the gate-weighted sum an atomic ``index_add_``) against its CPU run on
    the same weights and tokens: the smoke config in float32 at 1e-5; one
    full-width layer of qwen2-moe (60 experts of 1408, top-4, shared 5632)
    or of deepseek-v2-lite (64 of 1408, top-6, shared 2816) in bfloat16 at
    2e-2 |cpu| + 2e-2 max |cpu|, the reference kernel tests' bf16 tolerance
    scaled by the result's magnitude, as chip_smoke.py holds the matmul:
    the routed and the shared outputs are each rounded to bf16 before they
    are added, so where they cancel the sum keeps their rounding (half an
    ulp of values near 10 is 0.03)."""
    dev = _cuda_or_skip()
    cfg = (get_smoke_config(MOE) if case == "smoke"
           else get_config(DEEPSEEK if case.startswith("deepseek") else MOE))
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


# -- slice 9: K3 with Dqk != Dv (MLA), cross-attention shapes, the three new archs ----

# MLA at full width: 16 heads, queries and keys of nope 128 + rope 64, values of 128
MLA_H, MLA_DQK, MLA_DV = 16, 192, 128
# Queries this many times normal in the slice's tests over a thousand keys
# or more: with unit queries the softmax there is nearly flat and |o| about
# 0.04, half the bfloat16 tolerance's absolute term; sharper, |o| is of
# order 1 and a key tile dropped or counted twice shows (x4 is exact in bf16).
PEAKED_Q = 4.0


def mla_operands(dev, dtype, B, S, seed=11):
    q, k = (normal((B, S, MLA_H, MLA_DQK), dtype, seed + i) for i in range(2))
    q = q * PEAKED_Q
    v = normal((B, S, MLA_H, MLA_DV), dtype, seed + 2)
    return _on(dev, dtype, q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_dqk_192_dv_128_matches_plain_on_card(dtype):
    """K3 at (2, 1024, 16) with queries and keys of 192 dims and values of
    128, causal, under MLA's scale 192^-0.5: bfloat16 on its own
    ``<192, 128>`` instantiation, float32 padded to 256, each within the
    reference kernel tests' tolerance of the plain version; the output has
    the values' head dim."""
    dev = _cuda_or_skip()
    q, k, v = mla_operands(dev, dtype, 2, 1024)
    scale = MLA_DQK ** -0.5
    before = fa.launches
    got = ops.mha(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert fa.launches - before == 1
    assert got.shape == (2, 1024, MLA_H, MLA_DV)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True, scale=scale).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol(dtype))


@pytest.mark.gpu
def test_flash_attention_refuses_a_bf16_pair_it_is_not_built_for_on_card():
    dev = _cuda_or_skip()
    q = torch.zeros((1, 2, 64, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(D 128, Dv 64\)"):
        fa.flash_attention(q, q, q[..., :64].contiguous())


# (B, Sq, Sk, H, KvH, D): llama-3.2-vision's cross prefill (64 tokens against
# 1600 patches, off the key tile) and seamless' encoder / cross prefill
CROSS_CASES = [(4, 64, 1600, 64, 8, 128), (4, 1024, 1024, 16, 16, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D", CROSS_CASES)
def test_flash_attention_non_causal_cross_shapes_on_card(B, Sq, Sk, H, KvH, D, dtype):
    dev = _cuda_or_skip()
    q, k, v = _on(dev, dtype, *attention_operands((B, Sq, H, D), (B, Sk, KvH, D), dtype, seed=21))
    q = q * PEAKED_Q
    got = ops.mha(q, k, v, causal=False)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=False).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Tm,H,KvH,D", [(4, 1600, 64, 8, 128), (4, 1024, 16, 16, 64)])
def test_decode_attention_against_the_whole_memory_on_card(B, Tm, H, KvH, D, dtype):
    """K4 as cross decode runs it: every lane's length the memory's, Tm."""
    dev = _cuda_or_skip()
    q, k, v = _on(dev, dtype, *attention_operands((B, H, D), (B, Tm, KvH, D), dtype, seed=23))
    q = q * PEAKED_Q
    got = ops.decode(q, k, v, Tm)
    want = ref.decode_attention_ref(q, k, v, Tm)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol(dtype))


def _mla_layer(dev, seed=0):
    cfg = get_config(DEEPSEEK)
    return cfg, mla.init_mla(torch.Generator(device=dev).manual_seed(seed), cfg)


@pytest.mark.gpu
def test_mla_layer_graph_replay_equals_eager_on_card():
    """A full-width MLA layer's prefill (2 x 256, bf16) captured in a CUDA
    graph and replayed gives the eager result, K3 launched once a call."""
    dev = _cuda_or_skip()
    cfg, p = _mla_layer(dev)
    x = torch.as_tensor(normal((2, 256, cfg.d_model), "bfloat16", 31)).to(dev, torch.bfloat16)
    eager = mla.mla_forward(p, x, cfg).clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        mla.mla_forward(p, x, cfg)               # warm-up on the capturing stream
        before = fa.launches
        with torch.cuda.graph(graph, stream=stream):
            out = mla.mla_forward(p, x, cfg)
        assert fa.launches - before == 1
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.gpu
def test_mla_layer_at_full_width_equals_its_plain_form_on_card():
    """One full-width MLA layer at T = 4096 in bfloat16: the chunked entry,
    which on the card runs K3 ``<192, 128>`` over decompressed K/V, against
    the reference's absorbed online-softmax form over latent chunks, run on
    the card as plain tensor code, within 2e-2 |plain| + 2e-2 max |plain|
    (the two forms round to bf16 at other places: k_nope against q W_uk)."""
    dev = _cuda_or_skip()
    cfg, p = _mla_layer(dev, seed=1)
    x = torch.as_tensor(normal((1, 4096, cfg.d_model), "bfloat16", 32)).to(dev, torch.bfloat16)
    before = fa.launches
    got = mla.mla_forward_chunked(p, x, cfg)
    torch.cuda.synchronize()
    assert fa.launches - before == 1
    want = mla.mla_forward_chunked_plain(p, x, cfg).float().cpu().numpy()
    assert got.shape == (1, 4096, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


def _open_gates(params, seed):
    """Every cross layer's gates set to seeded non-zero values (a fresh
    model's are 0, which hides cross-attention and the cross block's ffn)."""
    g = torch.Generator().manual_seed(seed)
    for seg in params["segments"]:
        for block in seg:
            for name in ("gate_attn", "gate_ffn"):
                if name in block["mixer"]:
                    t = block["mixer"][name]
                    t.copy_(0.3 + torch.rand(t.shape, generator=g))
    return params


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [DEEPSEEK, "seamless-m4t-medium", "llama-3.2-vision-90b"])
def test_slice9_model_on_card_equals_the_cpu(arch):
    """Each new arch's smoke model (gates open, seeded embeddings): the
    forward through K3 (MLA at head dims 48/32 in float32, padded to 64; the
    encoder and cross-attention non-causal) equals the plain CPU forward,
    and the Engine, through K4 in self- and cross-attention decode, gives the
    CPU Engine's greedy tokens."""
    dev = _cuda_or_skip()
    cfg = get_smoke_config(arch)
    params = _open_gates(transformer.init_lm(0, cfg, device="cpu"), seed=3)
    on_card = _to(params, dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)))}
    if cfg.frontend is not None:
        batch["frontend_embeds"] = torch.as_tensor(
            rng.normal(size=(2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32))
    kinds = [k for s in cfg.encoder_segments + cfg.segments for k in s.pattern * s.repeats]
    before = fa.launches
    got, aux = transformer.lm_forward(on_card, batch, cfg)
    torch.cuda.synchronize()
    assert fa.launches - before == len(kinds)              # every block attends
    want, want_aux = transformer.lm_forward(params, batch, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    done = {}
    for where, p in (("cpu", params), ("card", on_card)):
        eng = serve.Engine(cfg, 3, 32, device=dev if where == "card" else "cpu", params=p)
        if cfg.frontend is not None:
            eng.cache = transformer.lm_prepare_decode_cache(
                p, eng.cache, {"frontend_embeds": batch["frontend_embeds"][[0, 1, 0]]}, cfg)
        before_dec = dec.launches
        out, _ = serve.serve_requests(eng, serve.make_requests(6, 5, 6, cfg.vocab))
        done[where] = [(r.rid, r.out) for r in out]
        if where == "card":
            attends = sum(k in ("attn", "cross_attn") for s in cfg.segments
                          for k in s.pattern * s.repeats)
            assert dec.launches - before_dec == attends * eng.decode_calls
    assert done["card"] == done["cpu"]


# -- training: the flash kernel's backward (S2), the refusals under grad ------------------

# the shapes of chip_smoke.py's S2 rows and more:
# B, Sq, Sk, H, KvH, D, Dv, dtype, causal, window, kv_len
BWD_CASES_CARD = [
    (4, 2048, 2048, 32, 4, 64, 64, "bfloat16", True, None, None),   # tinyllama-1.1b's step
    (4, 128, 128, 10, 5, 64, 64, "float32", True, None, None),      # TINYLM's (the example)
    (2, 2048, 2048, 16, 16, 192, 128, "bfloat16", True, None, None),  # deepseek's MLA step
    (2, 512, 512, 16, 2, 128, 128, "bfloat16", True, None, None),   # D 128
    (2, 512, 512, 16, 1, 256, 256, "bfloat16", True, None, None),   # D 256, group 16: 16 slices
    (2, 2048, 2048, 16, 1, 256, 256, "bfloat16", True, 2048, None),  # RecurrentGemma's step
    (2, 300, 300, 8, 1, 256, 256, "bfloat16", True, None, 260),     # D 256 ragged, kv_len
    (2, 512, 512, 8, 4, 256, 256, "bfloat16", True, None, None),    # D 256, group 2
    (2, 200, 330, 8, 2, 256, 256, "bfloat16", False, None, None),   # D 256 non-causal, Sq != Sk
    (4, 1024, 1024, 16, 8, 256, 256, "bfloat16", True, None, None),  # D 256, one slice
    (2, 512, 512, 16, 16, 64, 64, "bfloat16", True, None, None),    # group 1
    (2, 300, 300, 8, 1, 64, 64, "bfloat16", True, None, None),      # group 8, ragged
    (2, 1024, 1024, 16, 2, 64, 64, "bfloat16", True, 256, None),    # a window
    (2, 1024, 1024, 16, 2, 128, 128, "bfloat16", True, 256, None),  # a window at D 128
    (2, 200, 130, 8, 2, 128, 128, "bfloat16", False, None, None),   # ragged Sq -> Sk, non-causal
    (2, 256, 256, 4, 2, 16, 16, "bfloat16", True, None, None),      # head dims 16 and 32
    (2, 256, 256, 4, 2, 32, 32, "bfloat16", True, None, None),
    (1, 120, 130, 4, 2, 80, 80, "bfloat16", False, None, 100),      # D 80 padded, kv_len
    (2, 384, 640, 8, 2, 64, 64, "float32", False, None, None),      # non-causal, Sq != Sk
    (2, 2, 130, 4, 2, 80, 80, "bfloat16", False, None, None),        # D 80 padded, tiny Sq
    (1, 64, 96, 4, 2, 48, 32, "float32", False, None, None),        # D != Dv in float32, padded
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}             # of each tensor's largest |plain|


def bwd_operands(dev, B, Sq, Sk, H, KvH, D, dtype, seed=0, Dv=None):
    """(q, k, v, dO) in the kernels' (B,H,S,·) layout as views of model-layout
    tensors, v and dO of ``Dv`` head dims (D unless given); the queries 4x
    normal, so that |o| is of order 1."""
    Dv = D if Dv is None else Dv
    g = torch.Generator().manual_seed(seed)
    mk = lambda shape, s=1.0: (torch.randn(shape, generator=g) * s).to(dev, DTYPES[dtype])
    q = mk((B, Sq, H, D), 4.0).transpose(1, 2)
    k, v = mk((B, Sk, KvH, D)).transpose(1, 2), mk((B, Sk, KvH, Dv)).transpose(1, 2)
    return q, k, v, mk((B, Sq, H, Dv)).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D,Dv,dtype,causal,window,kv_len", BWD_CASES_CARD)
def test_flash_attention_bwd_kernel_matches_plain_on_card(B, Sq, Sk, H, KvH, D, Dv, dtype,
                                                         causal, window, kv_len):
    """S2 against the plain backward, one call on the route ``bwd_route``
    names (bfloat16 on the tensor cores at every head dim)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = _cuda_or_skip()
    q, k, v, do = bwd_operands(dev, B, Sq, Sk, H, KvH, D, dtype, Dv=Dv)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    o, lse = fa._forward(q, k, v, causal, window, D ** -0.5, kv_len, with_lse=True)
    route = fa.bwd_route(D, Dv, DTYPES[dtype])[0]
    before = fab.launches
    got = fab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fab.launches == before + 1
    assert route == ("wgmma" if dtype == "bfloat16" else "cuda_cores")
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max()), (name, err)


# a fresh process whose first CUDA work in the autograd engine's worker
# thread is S2 (the graph's first node): its tensor maps need a context bound
# to that thread (hopper.cuh, context_bound)
_FRESH_AUTOGRAD = """
import sys, torch
from repro_torch.kernels import ops
g = torch.Generator().manual_seed(0)
mk = lambda *s: torch.randn(s, generator=g).to("cuda", torch.bfloat16).requires_grad_()
q, k, v = mk(2, 256, 8, int(sys.argv[1])), mk(2, 256, 2, int(sys.argv[1])), mk(2, 256, 2, int(sys.argv[1]))
out = ops.mha(q, k, v, softcap=float(sys.argv[2]) or None)
grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
torch.cuda.synchronize()
assert all(bool(torch.isfinite(t).all()) for t in grads)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("D, softcap", [(64, 0.0), (64, 50.0), (256, 0.0)])
def test_flash_attention_bwd_runs_first_in_the_autograd_thread_on_card(D, softcap):
    """S2 launched before any other CUDA work of the autograd engine's
    worker thread, in a process of its own."""
    _cuda_or_skip()
    src = str(Path(fa.__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", _FRESH_AUTOGRAD, str(D), str(softcap)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]


@pytest.mark.gpu
def test_flash_attention_bwd_gives_the_same_bits_twice_on_card():
    """At RecurrentGemma's training shape S2 splits the group's heads in
    slices and adds their sums in a fixed order: two calls give the same
    bits."""
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = _cuda_or_skip()
    B, S, H, KvH, D = 2, 2048, 16, 1, 256
    assert fab.head_slices(B, KvH, H // KvH, S, D) > 1
    q, k, v, do = bwd_operands(dev, B, S, S, H, KvH, D, "bfloat16", seed=4)
    o, lse = fa._forward(q, k, v, True, 2048, D ** -0.5, None, with_lse=True)
    first = fab.flash_attention_bwd(q, k, v, o, lse, do, window=2048)
    second = fab.flash_attention_bwd(q, k, v, o, lse, do, window=2048)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Sq,Sk,H,KvH,D,window", FLASH_CASES_CARD)
def test_flash_attention_lse_equals_plain_on_card(Sq, Sk, H, KvH, D, window, dtype):
    """K3's row statistics, m + log l, against the plain forward's."""
    dev = _cuda_or_skip()
    q, k, v = (t.transpose(1, 2) for t in _on(dev, dtype, *attention_operands(
        (2, Sq, H, D), (2, Sk, KvH, D), dtype)))
    out, lse = fa._forward(q, k, v, True, window, D ** -0.5, None, with_lse=True)
    plain, want = ref.flash_attention_ref(q, k, v, window=window, return_lse=True)
    assert lse.shape == (2, H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().cpu().numpy(),
                               **tol(dtype))


@pytest.mark.gpu
def test_flash_attention_grads_through_ops_mha_on_card():
    """Under grad ``ops.mha`` runs K3 with its lse and S2 in the backward;
    the gradients equal autograd of the plain forward on the card."""
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = _cuda_or_skip()
    q, k, v, do = (t.transpose(1, 2).contiguous().requires_grad_()
                   for t in bwd_operands(dev, 2, 200, 200, 8, 2, 64, "float32", seed=3))
    before = (fa.launches, fab.launches)
    out = ops.mha(q, k, v)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do.detach())
    assert (fa.launches, fab.launches) == (before[0] + 1, before[1] + 1)
    plain = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
    want = torch.autograd.grad(plain, (q, k, v), do.detach())
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.gpu
def test_mla_pair_trains_through_ops_mha_on_card():
    """Under grad ``ops.mha`` at MLA's (192, 128) in bfloat16 launches K3 and
    S2 once each (S2 on the tensor cores), and its gradients equal autograd
    of the plain forward on the card, each within 2e-2 of its largest
    magnitude."""
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = _cuda_or_skip()
    q, k, v, do = (t.transpose(1, 2).contiguous() for t in bwd_operands(
        dev, 2, 384, 384, 16, 16, 192, "bfloat16", seed=5, Dv=128))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    scale = 192 ** -0.5
    before = (fa.launches, fab.launches)
    out = ops.mha(q, k, v, scale=scale)
    assert out.grad_fn is not None and out.shape == (2, 384, 16, 128)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.launches, fab.launches) == (before[0] + 1, before[1] + 1)
    assert fa.bwd_route(192, 128, torch.bfloat16)[0] == "wgmma"
    plain = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    scale=scale).transpose(1, 2)
    want = torch.autograd.grad(plain, (q, k, v), do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL["bfloat16"] * float(w.float().abs().max()), (name, err)


@pytest.mark.gpu
def test_kernels_without_a_backward_refuse_grad_on_card():
    """K2 and K4, which no training path runs, raise under grad before any
    launch; without grad (or with no input that requires it) they run."""
    dev = _cuda_or_skip()
    counters = (mm, dec)
    before = [m.launches for m in counters]
    x = torch.randn(64, 64, device=dev, requires_grad=True)
    q1 = torch.randn(2, 8, 64, device=dev, requires_grad=True)
    cache = torch.randn(2, 32, 2, 64, device=dev)
    calls = {
        "matmul": lambda: ops.matmul(x, x),
        "decode_attention": lambda: ops.decode(q1, cache, cache, 16),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            call()
    assert [m.launches for m in counters] == before
    with torch.no_grad():
        for call in calls.values():
            assert call().grad_fn is None
    torch.cuda.synchronize()


def train_launches(cfg) -> dict:
    """Launches of one gradient of ``cfg`` (remat "none"), by kernel: K3 and
    S2 once per self-attention, MLA, cross-attention and encoder layer; K5
    and S3 once per SSD layer; K6 and S4 once per RG-LRU layer."""
    kinds = [k for seg in cfg.segments for k in seg.pattern * seg.repeats]
    attn = (sum(k in ("attn", "local_attn", "mla", "cross_attn") for k in kinds)
            + sum(len(seg.pattern) * seg.repeats for seg in cfg.encoder_segments))
    ssd_n, rg_n = kinds.count("ssd"), kinds.count("rglru")
    return {"K3": attn, "S2": attn, "K5": ssd_n, "S3": ssd_n, "K6": rg_n, "S4": rg_n}


def train_counts() -> dict:
    from repro_torch.kernels import flash_attention_bwd as fab
    return {"K3": fa.launches, "S2": fab.launches, "K5": ssd_k.launches,
            "S3": ssd_k.bwd_launches, "K6": rg.launches, "S4": rg.bwd_launches}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list_archs())
def test_smoke_train_step_on_card_equals_the_cpu(arch):
    """Each arch's smoke config (float32: K3 ``flash_f32`` and S2 in float32,
    K5 and S3, K6 and S4, by its layers) on the card against the CPU from
    one state, every leaf float32 (a bfloat16 weight would round apart by
    one unit where the float32 gradients straddle a boundary): the launches
    by kernel, the loss (rtol 1e-5), the gradients, each leaf within 1e-5 of
    its largest magnitude, then one train step as ``chip_smoke.py`` takes it
    (lr 3e-4, warmup 2), each side from its own gradients: each parameter
    leaf within 1e-4 of its largest magnitude at every element whose step
    the gradient check fixes (``adamw.fixed_by_gradients``, which leaves out
    at most 1 % of the elements)."""
    from repro_torch import _tree
    from repro_torch.train.steps import init_train_state
    dev = _cuda_or_skip()
    cfg = get_smoke_config(arch)
    state = _tree.map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                      init_train_state(0, cfg, device="cpu"))
    train_step_card_vs_cpu(cfg, state, dev)


def train_step_card_vs_cpu(cfg, state, dev):
    """The gradients and one train step of ``cfg`` from the float32 ``state``
    on the card against the CPU, as ``test_smoke_train_step_on_card_equals_the_cpu``
    states them."""
    from repro_torch import _tree
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim.adamw import OptCfg, fixed_by_gradients
    from repro_torch.train.steps import make_grad_fn, make_train_step
    batch = make_batch(cfg, ShapeCfg("t", seq_len=64, global_batch=4, kind="train"))
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    before = train_counts()
    loss_card, _, g_card = make_grad_fn(cfg)(_to(state["params"], dev), _to(tensors, dev))
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in train_counts().items()} == train_launches(cfg)
    loss_cpu, _, g_cpu = make_grad_fn(cfg)(state["params"], tensors)
    np.testing.assert_allclose(float(loss_card), float(loss_cpu), rtol=1e-5)
    for key, got in _tree.with_paths(g_card).items():
        want = _tree.with_paths(g_cpu)[key]
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (key, err, float(want.abs().max()))
    opt = OptCfg(lr=3e-4, warmup_steps=2, decay_steps=8)
    card, m_card = make_train_step(cfg, opt, device=dev)(_to(state, dev), batch)
    cpu, m_cpu = make_train_step(cfg, opt, device="cpu")(state, batch)
    np.testing.assert_allclose(float(m_card["loss"]), float(m_cpu["loss"]), rtol=1e-5)
    fixed = _tree.with_paths(fixed_by_gradients(g_cpu, state["opt"], state["params"], opt))
    assert sum(int((~m).sum()) for m in fixed.values()) <= 0.01 * sum(
        m.numel() for m in fixed.values())
    for key, got in _tree.with_paths(card["params"]).items():
        want = _tree.with_paths(cpu["params"])[key]
        err = float(((got.cpu() - want).abs() * fixed[key]).max())
        assert err <= 1e-4 * float(want.abs().max()), (key, err, float(want.abs().max()))


# -- attention logit soft-capping: K3, K4 and S2 with a cap ---------------------------------

SOFTCAP = 50.0                   # Gemma-2's attention cap
# (B, Sq, Sk, H, KvH, D, causal, window): the head dims 64, 128 and 256 (RecurrentGemma's
# 16 heads over one KV head, under a window), GQA, non-causal with Sq != Sk, head dim 16
CAPPED_FLASH_CASES = [
    (2, 256, 256, 8, 2, 64, True, None),
    (2, 300, 300, 8, 2, 128, True, 64),
    (2, 300, 300, 16, 1, 256, True, 128),
    (2, 130, 200, 4, 4, 64, False, None),
    (2, 100, 100, 4, 2, 16, True, None),
]
# the same for S2: wgmma (bf16; at 256 the heads in slices), the CUDA cores (float32)
CAPPED_BWD_CASES = [
    (2, 512, 512, 16, 2, 64, True, None),
    (2, 300, 300, 8, 2, 128, True, 64),
    (2, 512, 512, 16, 1, 256, True, 128),
    (2, 200, 130, 8, 2, 64, False, None),
]


def _held(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **tol(dtype))


def _moved(got, uncapped, dtype):
    """The cap moved the result past the tolerance somewhere."""
    t = tol(dtype)
    g, u = got.float().cpu(), uncapped.float().cpu()
    return bool(((g - u).abs() > t["atol"] + t["rtol"] * u.abs()).any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D,causal,window", CAPPED_FLASH_CASES)
def test_capped_flash_attention_matches_plain_on_card(B, Sq, Sk, H, KvH, D, causal, window,
                                                      dtype):
    """K3 with a cap: one launch of the capped kernel (counted under the cap
    in ``by_shape``), its output and its rows' lse against the capped plain
    version, and the cap moves the output."""
    dev = _cuda_or_skip()
    q, k, v, _ = bwd_operands(dev, B, Sq, Sk, H, KvH, D, dtype)   # scores the cap bends
    kw = dict(causal=causal, window=window)
    before, shaped = fa.launches, fa.by_shape[(B, H, KvH, Sq, Sk, D, D, causal, SOFTCAP)]
    out, lse = fa._forward(q, k, v, causal, window, D ** -0.5, None, SOFTCAP, with_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert fa.by_shape[(B, H, KvH, Sq, Sk, D, D, causal, SOFTCAP)] == shaped + 1
    plain, want_lse = ref.flash_attention_ref(q, k, v, softcap=SOFTCAP, return_lse=True, **kw)
    _held(out, plain, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert _moved(out, ref.flash_attention_ref(q, k, v, **kw), dtype)
    got = ops.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), softcap=SOFTCAP, **kw)
    _held(got.transpose(1, 2), plain, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L,H,KvH,D,length", DECODE_CASES_CARD)
def test_capped_decode_attention_matches_plain_on_card(L, H, KvH, D, length, dtype):
    """K4 with a cap, a scalar length and one per lane: one launch each,
    against the capped plain version; the cap moves the output."""
    dev = _cuda_or_skip()
    q, k, v = _on(dev, dtype, *attention_operands((3, H, D), (3, L, KvH, D), dtype, seed=3))
    q = q * 4
    lanes = torch.tensor([length, max(1, length // 3), L], dtype=torch.int32, device=dev)
    for n in (length, lanes):
        before = dec.launches
        got = ops.decode(q, k, v, n, softcap=SOFTCAP)
        torch.cuda.synchronize()
        assert dec.launches == before + 1 and got.shape == q.shape
        _held(got, ref.decode_attention_ref(q, k, v, n, softcap=SOFTCAP), dtype)
        if int(torch.as_tensor(n).max()) > 1:     # over one key the softmax is 1, capped or not
            assert _moved(got, ref.decode_attention_ref(q, k, v, n), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_capped_decode_partials_merge_to_the_full_result_on_card(dtype):
    """The capped partials against their plain version (``normalize=False``),
    and over 4 sequence shards, merged, equal to the capped full decode.  The
    statistics (m, l) are held to 2e-5 in float32; in bfloat16 to the
    bfloat16 tolerance, as the output (the special-function tanh moves a
    capped score by about 2^-11 of itself)."""
    dev = _cuda_or_skip()
    B, L, H, KvH, D, S = 4, 1024, 32, 4, 64, 4
    q, k, v = _on(dev, dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype, 4))
    q = q * 4
    lengths = torch.tensor([1, 100, 513, 1024], dtype=torch.int32, device=dev)
    full = ops.decode(q, k, v, lengths, softcap=SOFTCAP)
    shard = L // S
    parts = [ops.decode_partial(q, k[:, s * shard:(s + 1) * shard], v[:, s * shard:(s + 1) * shard],
                                (lengths - s * shard).clamp(0, shard), softcap=SOFTCAP)
             for s in range(S)]
    merged = ops.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    _held(merged, full, dtype)
    got = ops.decode_partial(q, k, v, lengths, softcap=SOFTCAP)
    want = ref.decode_attention_ref(q, k, v, lengths, normalize=False, softcap=SOFTCAP)
    _held(got[0], want[0], dtype)
    for g, w in zip(got[1:], want[1:]):
        _held(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,D,causal,window", CAPPED_BWD_CASES)
def test_capped_flash_attention_bwd_matches_plain_on_card(B, Sq, Sk, H, KvH, D, causal, window,
                                                          dtype):
    """S2 under the forward's cap on the route ``bwd_route`` names, against
    the capped plain backward from the same forward (each output within
    ``BWD_TOL`` of its largest magnitude); then under grad through
    ``ops.mha``: one capped K3 and one capped S2 launch."""
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = _cuda_or_skip()
    q, k, v, do = bwd_operands(dev, B, Sq, Sk, H, KvH, D, dtype, seed=2)
    kw = dict(causal=causal, window=window, softcap=SOFTCAP)
    o, lse = fa._forward(q, k, v, causal, window, D ** -0.5, None, SOFTCAP, with_lse=True)
    before = fab.launches
    got = fab.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fab.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max()), (name, err)
    # the uncapped kernels from the uncapped forward fall outside the limit
    o0, lse0 = fa._forward(q, k, v, causal, window, D ** -0.5, None, with_lse=True)
    uncapped = fab.flash_attention_bwd(q, k, v, o0, lse0, do, causal=causal, window=window)
    assert any(float((g.float() - w.float()).abs().max())
               > BWD_TOL[dtype] * float(w.float().abs().max()) for g, w in zip(uncapped, want))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    before = (fa.launches, fab.launches)
    out = ops.mha(ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2), **kw)
    grads = torch.autograd.grad(out, (ql, kl, vl), do.transpose(1, 2))
    torch.cuda.synchronize()
    assert (fa.launches, fab.launches) == (before[0] + 1, before[1] + 1)
    assert fab.by_shape[(B, H, KvH, Sq, Sk, D, D, causal, SOFTCAP)] >= 2
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max()), (name, err)


@pytest.mark.gpu
def test_capped_mla_pair_raises_before_any_launch_on_card():
    """No capped ``<192, 128>`` is built (the reference's MLA ignores the
    cap): K3 and S2 raise ``ValueError`` for a cap there and launch nothing;
    float32, padded to 256, runs it."""
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = _cuda_or_skip()
    q, k, v = (t.transpose(1, 2) for t in mla_operands(dev, "bfloat16", 1, 128))
    do, lse = torch.zeros_like(q[..., :MLA_DV]), torch.zeros(q.shape[:3], device=dev)
    before = (fa.launches, fab.launches)
    with pytest.raises(ValueError, match="logit cap"):
        fa.flash_attention(q, k, v, softcap=SOFTCAP)
    with pytest.raises(ValueError, match="logit cap"):
        fab.flash_attention_bwd(q, k, v, do, lse, do, softcap=SOFTCAP)
    assert (fa.launches, fab.launches) == before
    q, k, v = (t.float() for t in (q, k, v))
    _held(fa.flash_attention(q, k, v, softcap=SOFTCAP),
          ref.flash_attention_ref(q, k, v, softcap=SOFTCAP), "float32")


@pytest.mark.gpu
def test_capped_smoke_train_step_on_card_equals_the_cpu():
    """tinyllama's smoke config under the attention cap, on the card against
    the CPU as ``test_smoke_train_step_on_card_equals_the_cpu`` holds each
    arch: capped K3 and S2 in float32.  Its query and key weights are 4
    times larger, so that the cap moves the gradients (by 2e-3 of a leaf's
    largest, on the CPU) while float32 still gives them to 1e-6 of it (at
    16 times the softmax is so sharp that the CPU's own float32 gradients
    are 3e-5 from float64's)."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.train.steps import init_train_state
    dev = _cuda_or_skip()
    cfg = get_smoke_config("tinyllama-1.1b")
    cfg = cfg.scaled(attn=dataclasses.replace(cfg.attn, logit_softcap=SOFTCAP))
    state = _tree.map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                      init_train_state(0, cfg, device="cpu"))
    for block in state["params"]["segments"][0]:
        for name in ("wq", "wk"):
            block["mixer"][name] = block["mixer"][name] * 4
    before = dict(fa.by_shape)
    train_step_card_vs_cpu(cfg, state, dev)
    capped = {key: n - before.get(key, 0) for key, n in fa.by_shape.items() if key[-1] == SOFTCAP}
    assert sum(capped.values()) >= 2 * cfg.n_layers      # the gradient's and the step's


@pytest.mark.gpu
def test_one_rank_nccl_mesh_paths_on_card():
    """The mesh's explicit paths on a one-rank NCCL mesh ``("pod", "data",
    "model") = (1, 1, 1)`` (NCCL takes one rank a card; the multi-rank cases
    run over gloo on the CPU): the smoke tinyllama's decode under
    ``_flash_decode`` rules goes through K4's partials (one a layer and a
    step, ``partial_by_shape``) and equals the unsharded decode to 2e-5 in
    float32; qwen2-moe's MoE under ``_moe_ep`` equals the local dispatch;
    the int8 train step is AdamW on the gradients through the int8 round
    trip, with the plain step's loss."""
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import OptCfg, adamw_update
    from repro_torch.parallel import compression
    from repro_torch.parallel.api import use_rules
    from repro_torch.parallel.rules import rules_for
    from repro_torch.train.steps import init_train_state, make_grad_fn, make_train_step
    dev = _cuda_or_skip()
    made = not dist.is_initialized()
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device_type="cuda")
        cfg = get_smoke_config("tinyllama-1.1b")
        params = transformer.init_lm(0, cfg, device=dev)
        B, L, steps = 4, 64, 12
        g = torch.Generator().manual_seed(3)
        toks = torch.randint(1, cfg.vocab, (steps, B, 1), generator=g)
        plain = transformer.init_lm_cache(cfg, B, L, device=dev)
        rules = rules_for(cfg, mesh, "decode", batch=B, flash_decode=True)
        with use_rules(rules, mesh):
            sharded = transformer.init_lm_cache(cfg, B, L, device=dev)
        for t in range(steps):
            idx = torch.tensor([t, 2 * t, 0, t + 5], dtype=torch.int32, device=dev)
            want, _ = transformer.lm_decode_step(params, plain, toks[t], idx, cfg)
            before = sum(dec.partial_by_shape.values())
            with use_rules(rules, mesh):
                got, _ = transformer.lm_decode_step(params, sharded, toks[t], idx, cfg)
            assert sum(dec.partial_by_shape.values()) - before == cfg.n_layers
            assert float((got - want).abs().max()) <= 2e-5 + 2e-5 * float(want.abs().max())
        mcfg = get_smoke_config("qwen2-moe-a2.7b")
        p = mlp.init_moe(torch.Generator(device=dev).manual_seed(0), mcfg)
        x = torch.randn((4, 8, mcfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
        y0, a0 = mlp.moe_forward_local(p, x, mcfg)
        with use_rules(rules_for(mcfg, mesh, "train", batch=4, moe_ep=True), mesh):
            y1, a1 = mlp.moe_forward(p, x, mcfg)
        assert torch.allclose(y1, y0, rtol=1e-5, atol=1e-6) and torch.allclose(a1, a0)
        state = init_train_state(0, cfg, device=dev)
        batch = {k: torch.randint(1, cfg.vocab, (4, 32), generator=g).to(dev)
                 for k in ("tokens", "labels")}
        new, metrics = make_train_step(cfg, OptCfg(), grad_compression="int8", mesh=mesh,
                                       device=dev)(state, batch)
        loss, _, grads = make_grad_fn(cfg)(state["params"], batch)
        trip = _tree.map(lambda t: compression.dequantize(*compression.quantize_int8(t)), grads)
        want, _, _ = adamw_update(trip, state["opt"], state["params"], OptCfg())
        for a, b in zip(_tree.leaves(want), _tree.leaves(new["params"])):
            assert torch.allclose(a, b, rtol=0, atol=1e-6)
        assert abs(float(metrics["loss"]) - float(loss)) <= 1e-6 * abs(float(loss))
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
