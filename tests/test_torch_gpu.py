"""The port's CUDA kernels on the card, each against its plain PyTorch
version: the generated kernels of ``lower_to_cuda`` bit-exact, the matmul
kernel within the tolerance of the reference's kernel tests.

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
from repro_torch.core.gallery import gemm
from repro_torch.core.lower import lower_to_cuda
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref

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


SHAPES = [(128, 128, 128), (256, 384, 128), (100, 130, 70), (8, 8, 8)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def matmul_tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def matmul_operands(M, K, N, name):
    """float32 numpy operands; for bfloat16, rounded so that the hop through
    float32 loses nothing on either side."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    y = rng.standard_normal((K, N)).astype(np.float32)
    if name == "bfloat16":
        x = torch.as_tensor(x).bfloat16().float().numpy()
        y = torch.as_tensor(y).bfloat16().float().numpy()
    return x, y


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
                               **matmul_tol(dtype))


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
