"""The arithmetic of K5's Hopper design (``csrc/ssd_scan.cu``) emulated on
the CPU, before any card runs it: the four stages of the chunk-parallel SSD
scan (C Bᵀ once for all heads; each chunk's state increment and decay; the
sequential pass over the states; the outputs), every product in TF32 as the
tensor cores take it — operands rounded to TF32 by bit masking, as
``cvt.rna.tf32.f32`` does, and products summed in float32 — in three passes
(hi·lo + lo·hi, then hi·hi) or one, the decay logs summed and differenced in
double.

Held to test_ssd_scan's tolerance, 2e-4 + 2e-4·|y|: against the step-by-step
recurrence in float64 (``ref.ssd_scan_ref``) and against the reference's
Pallas kernel in interpret mode.  At Mamba-2's widths one TF32 pass falls
outside that tolerance by two orders of magnitude; that case stays here so
that nobody cuts the kernel to one pass.  The kernels themselves are held to
the same plain versions on the card by ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as ref_ops

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_k

from test_torch_gpu import SSD_CASES, ssd_operands

TOL = 2e-4
FAST, SLOW = (0.01, 0.5), (0.001, 0.02)    # the reference test's decay logs; Mamba-2's dt range
MAMBA2 = (1024, 2, 64, 128, 256)           # (S, H, P, N, chunk): Mamba-2's head at 4 chunks
TILE = 64                                  # the kernels' query and source tiles


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: add half of the 13 dropped bits' unit, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernel's mma.sync forms it: TF32 operands, float32 sums;
    with three passes each operand is hi + lo and the sum takes
    lo·hi + hi·lo, then hi·hi."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def emulate(x, dA, Bc, Cc, Q: int, passes: int = 3) -> torch.Tensor:
    """K5 in the model layout: x (B,S,H,P), dA (B,S,H), Bc, Cc (B,S,N) float32.
    A ragged tail counts as zero inputs, as the kernels' masked loads make it."""
    Bn, S, H, P = x.shape
    N = Bc.shape[-1]
    nc = -(-S // Q)

    def chunks(t):                        # pad S to nc * Q, then (B, nc, Q, ...)
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, nc * Q - S))
        return t.reshape(Bn, nc, Q, *t.shape[2:])

    xk = chunks(x).permute(0, 3, 1, 2, 4)                        # (B,H,nc,Q,P)
    dk = chunks(dA).permute(0, 3, 1, 2)                          # (B,H,nc,Q)
    bk, ck = chunks(Bc), chunks(Cc)                              # (B,nc,Q,N)
    cum = torch.cumsum(dk.double(), -1)                          # in double
    last = cum[..., -1:]

    # 1. ssd_chunk_cb: C Bᵀ once for all heads
    cb = product(ck, bk.transpose(-1, -2), passes)               # (B,nc,Q,Q)
    # 2. ssd_chunk_state: (B o exp(last - cum))ᵀ x and exp(last) per chunk
    w = torch.exp(last - cum).float()
    dh = product((bk[:, None] * w[..., None]).transpose(-1, -2), xk, passes)  # (B,H,nc,N,P)
    decay = torch.exp(last[..., 0]).float()
    # 3. ssd_state_pass: h_0 = 0, h_{c+1} = exp(last_c) h_c + dH_c, in float32
    h = torch.zeros_like(dh[:, :, 0])
    entering = []
    for c in range(nc):
        entering.append(h)
        h = decay[:, :, c, None, None] * h + dh[:, :, c]
    hs = torch.stack(entering, 2)
    # 4. ssd_chunk_scan, per 64-row query tile from row r: exp(cum_q) (C_q h_c);
    # the diagonal tile's ((C Bᵀ) o L) x, L from double differences; the
    # tiles before it as exp(cum_q - cum_r) ((C Bᵀ o exp(cum_r - cum_s)) x)
    y = product(ck[:, None], hs, passes) * torch.exp(cum).float()[..., None]
    for r in range(0, Q, TILE):
        rows = slice(r, min(r + TILE, Q))
        q = torch.arange(rows.start, rows.stop, device=x.device)
        s = torch.arange(rows.start, device=x.device)
        diag = torch.where(q[:, None] >= q[None, :],
                           torch.exp((cum[..., rows, None] - cum[..., None, rows]).float()), 0.0)
        y[..., rows, :] += product(cb[:, None, :, rows, rows] * diag, xk[..., rows, :], passes)
        if r:
            before = torch.exp(cum[..., r:r + 1] - cum[..., :r]).float()            # (...,1, r)
            inside = torch.exp(cum[..., rows] - cum[..., r:r + 1]).float()[..., None]
            y[..., rows, :] += inside * product(cb[:, None, :, rows, :r] * before[..., None, :],
                                                xk[..., :r, :], passes)
    return y.permute(0, 2, 3, 1, 4).reshape(Bn, nc * Q, H, P)[:, :S]


def worst_over_limit(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (TOL + TOL·|want|): at most 1 within the tolerance."""
    return float(((got.double() - want.double()).abs() / (TOL + TOL * want.double().abs())).max())


def operands(B, S, H, P, N, rates):
    return [torch.as_tensor(a) for a in ssd_operands(B, S, H, P, N, lo=rates[0], hi=rates[1])]


def exact(x, dA, Bc, Cc) -> torch.Tensor:
    return ref.ssd_scan_ref(*(t.double() for t in (x, dA, Bc, Cc)))[0]


@pytest.mark.parametrize("rates", [FAST, SLOW], ids=["reference decays", "slow decays"])
@pytest.mark.parametrize("S,H,P,N,chunk", SSD_CASES + [MAMBA2])
def test_three_tf32_passes_match_the_float64_recurrence(S, H, P, N, chunk, rates):
    x, dA, Bc, Cc = operands(2 if S < 1024 else 1, S, H, P, N, rates)
    got = emulate(x, dA, Bc, Cc, min(chunk, S))
    assert worst_over_limit(got, exact(x, dA, Bc, Cc)) <= 1.0


@pytest.mark.parametrize("S,H,P,N,chunk", SSD_CASES)
def test_three_tf32_passes_match_the_pallas_kernel(S, H, P, N, chunk):
    arrays = ssd_operands(2, S, H, P, N)
    want = np.asarray(ref_ops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk))
    got = emulate(*map(torch.as_tensor, arrays), min(chunk, S))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("rates", [FAST, SLOW], ids=["reference decays", "slow decays"])
def test_one_tf32_pass_misses_the_tolerance_at_mamba2_widths(rates, passes):
    """Why the kernel pays for three passes: at S 1024, P 64, N 128, Q 256
    one pass lands some hundred times outside the limit, three inside it."""
    S, H, P, N, chunk = MAMBA2
    x, dA, Bc, Cc = operands(1, S, H, P, N, rates)
    worst = worst_over_limit(emulate(x, dA, Bc, Cc, chunk, passes), exact(x, dA, Bc, Cc))
    if passes == 3:
        assert worst <= 1.0
    else:
        assert worst > 50.0


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                              # a TF32 value: kept
    half_up = 1.0 + 2.0 ** -11                          # halfway: away from zero
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23               # under halfway: down
    got = tf32(torch.tensor([one, half_up, below, -half_up], dtype=torch.float32))
    assert got.tolist() == [one, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]
    a = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(a)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((a - hi).abs() / a.abs()).max()) <= 2.0 ** -11
    assert float(((a - hi - tf32(a - hi)).abs() / a.abs()).max()) <= 2.0 ** -22


def test_scratch_and_launches_per_call():
    """At Mamba-2's prefill (4 x 2048, H 48, P 64, N 128, chunk 256) a call
    makes 8.4 MB of C Bᵀ and 50 MB of states, and launches one kernel a
    stage; a call of one chunk has no states or decays.  The backward (S3)
    adds 50 MB of the states' gradients, 8.4 MB of W (the heads' sum, laid
    out as C Bᵀ) and 3.1 MB each of cum and r: no per-head parts of dB and
    dC, and no kernel to sum them."""
    shapes = ssd_k.scratch_shapes(4, 48, 2048, 64, 128, 256)
    size = {k: 4 * int(np.prod(v)) for k, v in shapes.items()}
    assert shapes["cb"] == (4, 8, 256, 256) and size["cb"] == 8_388_608
    assert shapes["states"] == (4, 48, 8, 128, 64) and size["states"] == 50_331_648
    assert shapes["decays"] == (4, 48, 8)
    ragged = ssd_k.scratch_shapes(2, 8, 40, 24, 16, 8)          # the smoke config's head
    assert ragged["cb"] == (2, 5, 64, 64) and ragged["states"] == (2, 8, 5, 16, 24)
    assert ssd_k.scratch_shapes(1, 2, 100, 18, 8, 128)["states"] == (0,)
    assert ssd_k.scratch_shapes(1, 1, 300, 18, 8, 256)["states"] == (1, 1, 2, 8, 20)
    assert ssd_k.CUDA_LAUNCHES_PER_CALL == len(ssd_k.STAGES) == 4
    bwd = ssd_k.bwd_scratch_shapes(4, 48, 2048, 64, 128, 256)
    size = {k: int(np.prod(v)) * ssd_k.BWD_SCRATCH_DTYPES[k].itemsize for k, v in bwd.items()}
    assert sorted(bwd) == sorted(ssd_k.BWD_SCRATCH_DTYPES) == ["cum", "gst", "r", "w"]
    assert bwd["w"] == shapes["cb"] == (4, 8, 256, 256) and size["w"] == 8_388_608
    assert bwd["gst"] == shapes["states"] and size["gst"] == 50_331_648
    assert bwd["cum"] == (4, 48, 8, 256) and bwd["r"] == (4, 48, 1, 2048)
    assert size["cum"] == size["r"] == 3_145_728
    assert ssd_k.bwd_scratch_shapes(2, 2, 150, 13, 7, 100) == {
        "gst": (2, 2, 2, 7, 16), "w": (2, 2, 128, 128), "cum": (2, 2, 2, 128), "r": (2, 2, 1, 150)}
    assert ssd_k.bwd_scratch_shapes(1, 2, 100, 80, 8, 128)["gst"] == (0,)
    assert ssd_k.bwd_scratch_shapes(1, 2, 100, 80, 8, 128)["r"] == (1, 2, 2, 100)
    assert ssd_k.BWD_STAGES == ("ssd_chunk_state", "ssd_bwd_state_pass", "ssd_bwd_dx",
                                "ssd_bwd_w", "ssd_bwd_dbc", "ssd_bwd_ddA")


if __name__ == "__main__":
    # the worst error over the limit at Mamba-2's widths, one TF32 pass and three:
    #   PYTHONPATH=src:tests python tests/test_torch_ssd_hopper.py
    S, H, P, N, chunk = MAMBA2
    for name, rates in (("reference decays", FAST), ("slow decays", SLOW)):
        x, dA, Bc, Cc = operands(1, S, H, P, N, rates)
        want = exact(x, dA, Bc, Cc)
        print(name, {f"{p} pass{'es' if p > 1 else ''}":
                     round(worst_over_limit(emulate(x, dA, Bc, Cc, chunk, p), want), 3)
                     for p in (1, 3)})
