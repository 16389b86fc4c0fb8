"""The port's matmul against the reference's Pallas matmul: the same seeded
operands go through ``repro.kernels.ops.matmul`` (interpret mode on the CPU)
and ``repro_torch.kernels.ops.matmul`` (plain version on the CPU).

Tolerance as the reference's kernel tests: 2e-5 for float32 (both sum in
float32, in different orders), 2e-2 for bfloat16 (one rounding to 8 bits of
mantissa at the end).  numpy has no bfloat16, so those operands travel as
float32 arrays holding bfloat16-representable values.  The CUDA kernel
itself has no CPU mode; ``tests/test_torch_gpu.py`` runs it where there is a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gallery import gemm as ref_gemm
from repro.kernels import ops as ref_ops

from repro_torch.core.gallery import gemm
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.matmul import check_schedule, micro_tile

from test_torch_gpu import DTYPES, SHAPES, matmul_operands, tol

jax.config.update("jax_enable_x64", False)

JNP_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_matmul(shape, dtype):
    M, K, N = shape
    jdt, tdt = JNP_DTYPE[dtype], DTYPES[dtype]
    x, y = matmul_operands(M, K, N, dtype)
    want = ref_ops.matmul(jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt),
                          bm=128, bn=128, bk=128)
    got = ops.matmul(torch.as_tensor(x).to(tdt), torch.as_tensor(y).to(tdt),
                     bm=128, bn=128, bk=128)
    assert got.shape == (M, N) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol(dtype))
    plain = ref.matmul_ref(torch.as_tensor(x).to(tdt), torch.as_tensor(y).to(tdt))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), **tol(dtype))


def test_matmul_schedule_checker():
    """The Hopper rules: tiles divide the dims, the block fits the thread and
    register limits, the staged ring fits shared memory, rows are 16-byte
    aligned."""
    assert check_schedule(256, 256, 256, 128, 128, 128) == []
    assert check_schedule(4096, 4096, 4096, 128, 128, 16, elem_bytes=4) == []
    assert check_schedule(16, 16, 16, 16, 16, 16, elem_bytes=4) == []
    errs = check_schedule(256, 256, 256, 100, 128, 130)
    assert errs and any("aligned" in e or "tile" in e for e in errs)
    errs = check_schedule(512, 512, 512, 256, 256, 16, elem_bytes=4)
    assert len(errs) == 1 and "threads" in errs[0]
    # float32 stages K in slabs of 16, so a deep bk no longer fills shared
    # memory; a tall tile's ring still can
    assert check_schedule(1024, 1024, 1024, 128, 128, 256, elem_bytes=4) == []
    errs = check_schedule(2048, 8, 16, 2048, 8, 16, elem_bytes=4)
    assert len(errs) == 1 and "shared memory" in errs[0]
    # misaligned rows are refused (beside the wgmma tile rules a 4-wide
    # bfloat16 tile also breaks)
    errs = check_schedule(4, 4, 4, 4, 4, 4, elem_bytes=2)
    aligned = [e for e in errs if "16-byte aligned" in e]
    assert len(aligned) == 3
    assert all("wgmma" in e for e in errs if e not in aligned)


@pytest.mark.parametrize("bm,bn,want", [(128, 128, 8), (64, 64, 8), (32, 32, 4), (16, 16, 2),
                                        (8, 8, 1), (16, 128, 4), (12, 20, 1), (128, 8, 4)])
def test_micro_tile_keeps_a_block_of_useful_size(bm, bn, want):
    t = micro_tile(bm, bn)
    assert t == want and bm % t == 0 and bn % t == 0
    assert (bm // t) * (bn // t) >= min(mm.MIN_THREADS, bm * bn)


def test_gemm_binds_to_matmul_kernel():
    """The systolic GEMM's binding on the card is the matmul kernel: same
    math, integer-exact through float32, equal on both sides."""
    module, name = gemm.build()
    a, b, _ = gemm.make_inputs()
    ra, rb, _ = ref_gemm.make_inputs()
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_array_equal(b, rb)
    want = gemm.oracle(a, b)
    got = ops.matmul(torch.as_tensor(a, dtype=torch.float32),
                     torch.as_tensor(b, dtype=torch.float32), bm=16, bn=16, bk=16)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    ref_got = ref_ops.matmul(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                             bm=16, bn=16, bk=16)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(ref_got, np.int64))


@pytest.mark.parametrize("axis,mult", [(0, 8), (1, 8), (0, 5), (1, 128)])
def test_pad_to_matches_reference(axis, mult):
    x = np.arange(35, dtype=np.float32).reshape(5, 7)
    want = np.asarray(ref_ops._pad_to(jnp.asarray(x), axis, mult))
    got = ops._pad_to(torch.as_tensor(x), axis, mult)
    np.testing.assert_array_equal(got.numpy(), want)


def test_matmul_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mm.matmul(x, x)
    with pytest.raises(TypeError):
        mm.matmul(torch.zeros((8, 8)), torch.zeros((8, 8), dtype=torch.bfloat16))
    before = mm.launches
    mm.matmul(torch.zeros((8, 8)), torch.zeros((8, 8)))
    assert mm.launches == before          # the plain version is not a launch




@pytest.mark.parametrize("tile,message", [
    ((96, 128, 64), "bm=96: a wgmma tile takes 64 or 128 rows"),
    ((256, 128, 64), "bm=256: a wgmma tile takes 64 or 128 rows"),
    ((128, 24, 64), "bn=24: a wgmma tile takes a multiple of 16 columns up to 256"),
    ((128, 512, 64), "bn=512: a wgmma tile takes a multiple of 16 columns up to 256"),
    ((128, 128, 8), "bk=8: a wgmma stage takes a multiple of 16 up to 256"),
    ((128, 128, 512), "bk=512: a wgmma stage takes a multiple of 16 up to 256"),
    ((128, 256, 256), "a ring of 3 stages of 196608 bytes exceeds shared memory 232448"),
])
def test_matmul_schedule_checker_bf16_rules(tile, message):
    """bfloat16 runs on wgmma: each rule it adds, one case per message."""
    bm, bn, bk = tile
    errs = check_schedule(4 * bm, 3 * bn, 5 * bk, bm, bn, bk, elem_bytes=2)
    assert errs == [e for e in errs if e.startswith(message)] and len(errs) == 1


@pytest.mark.parametrize("tile", [(128, 128, 128), (128, 256, 64), (64, 16, 16), (128, 48, 48),
                                  (64, 96, 32), (128, 256, 16)])
def test_matmul_bf16_tiles_that_wgmma_takes(tile):
    """The tiles the tests and the chip run use stay legal, with a ring of at
    least 3 stages and a wgmma width that divides bn."""
    bm, bn, bk = tile
    assert check_schedule(4 * bm, 3 * bn, 5 * bk, bm, bn, bk) == []
    s = mm.schedule(bm, bn, bk, torch.bfloat16)
    assert s["kernel"] == "mm_bf16_wgmma" and s["stages"] >= 3 and bn % s["wgmma_n"] == 0
    assert s["stages"] * mm.stage_bytes(bm, bn, bk) + 1024 + 128 <= mm.SMEM_BYTES


def test_matmul_schedule_names_the_kernel_per_dtype():
    """float32 never reaches the tensor cores, bfloat16 never the CUDA cores."""
    assert mm.schedule(128, 128, 16, torch.float32)["kernel"] == "mm_f32"
    assert mm.schedule(128, 128, 16, torch.bfloat16)["kernel"] == "mm_bf16_wgmma"
    assert mm.schedule(16, 16, 16, torch.float32) == {
        "kernel": "mm_f32", "launcher": "launch_matmul_f32", "bm": 16, "bn": 16, "bk": 16,
        "micro": 2, "slab": 16}
    assert mm.schedule(128, 256, 64, torch.bfloat16)["stages"] == 4
