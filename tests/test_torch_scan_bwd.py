"""The backwards of the SSD and RG-LRU scans on the CPU, before any card
runs them.

* ``ref.ssd_scan_bwd_ref`` and ``ref.rglru_scan_bwd_ref``, the plain
  backwards (the oracles of S3 and S4, and what the CPU takes under grad),
  against ``jax.vjp`` of the reference's step-by-step scans, each gradient
  within 1e-5 of its largest |want|, over one chunk, two chunks, many chunks
  and a ragged S;
* S3's chunked formulas (``csrc/ssd_scan_bwd.cu``: the heads summed before
  the products with B and C) emulated in float64 against the plain
  backward, and in 3xTF32 as the tensor cores take them against the float64
  plain backward at Mamba-2's widths and with heads whose decays differ by
  orders of magnitude, within the kernel rows' 2e-4 of the largest |want|;
* S4's order (``rglru_bwd_kernel``: segments of ``BWD_SEGMENT`` steps, each
  composed into one map, the maps applied from the end of the sequence)
  emulated in float32 against the plain backward and ``jax.vjp``;
* ``SsdScan`` and ``RglruScan`` under ``torch.autograd.gradcheck`` in
  float64, and the routing of ``ssd_scan`` / ``rglru_scan`` through them,
  with no launch counted on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref

from repro_torch.kernels import _build, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd_k

from test_torch_ssd_hopper import emulate, product

TOL = 1e-5                 # of each gradient's largest |want|, against jax.vjp
KERNEL_TOL = 2e-4          # the chip rows' SCAN_TOL, of each output's largest |plain|
SLOW = (0.001, 0.02)       # Mamba-2's decay logs
SPREAD = (0.001, 0.5)      # from Mamba-2's slowest to the reference test's fastest

# (S, H, P, N, chunk): one chunk, two chunks, many chunks, a ragged S
SSD_SHAPES = [(16, 2, 8, 6, 16), (32, 2, 8, 6, 16), (96, 3, 8, 5, 16), (77, 2, 12, 6, 16)]
RGLRU_SHAPES = [(16, 8), (64, 32), (200, 48), (77, 5)]


def ssd_inputs(B, S, H, P, N, seed=0, rates=(0.01, 0.5), per_head=False):
    """x (B,S,H,P), dA (B,S,H) in [-rates[1], -rates[0]], B, C (B,S,N) and
    dy (B,S,H,P), float32 numpy from ``seed``.  ``per_head``: head h draws
    its decay logs from the h-th of H slices of that range, equal in log
    scale, so that the heads' decays differ by orders of magnitude."""
    rng = np.random.default_rng(seed)
    lo, hi = rates
    x = rng.standard_normal((B, S, H, P), np.float32)
    if per_head:
        edges = np.geomspace(lo, hi, H + 1)
        dA = -rng.uniform(edges[:-1], edges[1:], (B, S, H)).astype(np.float32)
    else:
        dA = -rng.uniform(lo, hi, (B, S, H)).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, S, N), np.float32) for _ in range(2))
    dy = rng.standard_normal((B, S, H, P), np.float32)
    return x, dA, Bc, Cc, dy


def rglru_inputs(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32)
    b, dh = (rng.standard_normal((B, S, D), np.float32) for _ in range(2))
    return a, b, dh


def assert_close(got, want, tol, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, i)
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (what, i, err, np.abs(w).max())


@pytest.mark.parametrize("S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_bwd_ref_matches_reference_vjp(S, H, P, N, chunk):
    x, dA, Bc, Cc, dy = ssd_inputs(2, S, H, P, N)
    _, vjp = jax.vjp(lambda *a: jref.ssd_scan_ref(*a)[0], *map(jnp.asarray, (x, dA, Bc, Cc)))
    want = vjp(jnp.asarray(dy))
    got = ref.ssd_scan_bwd_ref(*map(torch.from_numpy, (x, dA, Bc, Cc, dy)))
    assert_close([g.numpy() for g in got], want, TOL)


@pytest.mark.parametrize("S,D", RGLRU_SHAPES)
def test_rglru_scan_bwd_ref_matches_reference_vjp(S, D):
    a, b, dh = rglru_inputs(2, S, D)
    h, vjp = jax.vjp(lambda a, b: jref.rglru_scan_ref(a, b)[0], jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(dh))
    got = ref.rglru_scan_bwd_ref(torch.from_numpy(a), torch.from_numpy(np.array(h)),
                                 torch.from_numpy(dh))
    assert_close([g.numpy() for g in got], want, TOL)


# -- S3's chunked formulas ------------------------------------------------------------


def emulate_bwd(x, dA, Bc, Cc, dy, y, Q, prod):
    """S3 in the model layout: x, dy, y (B,S,H,P), dA (B,S,H), Bc, Cc (B,S,N);
    ``prod`` forms each product.  Stage by stage as ``csrc/ssd_scan_bwd.cu``
    computes: the states' gradients G_c (a reverse pass over chunks); dx and
    r = dy.y - dx.x in double; W = sum_h (dy_h x_h^T) o L_h, the heads added
    in order; dB = W^T C and dC = W B, then the long products over (h, p),
    each head's slice formed apart, weighted by w_h (or exp(cum_h)) and added
    in head order; and ddA as r summed from the end of the sequence in
    double.  cum and its differences in double, exp only where t >= s; a
    ragged tail counts as zero inputs."""
    Bn, S, H, P = x.shape
    nc = -(-S // Q)
    f = x.dtype

    def chunks(t):                        # pad S to nc * Q, then (B, nc, Q, ...)
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, nc * Q - S))
        return t.reshape(Bn, nc, Q, *t.shape[2:])

    xk, gk, yk = (chunks(t).permute(0, 3, 1, 2, 4) for t in (x, dy, y))    # (B,H,nc,Q,P)
    dk = chunks(dA).permute(0, 3, 1, 2)                                     # (B,H,nc,Q)
    bk, ck = chunks(Bc), chunks(Cc)                                         # (B,nc,Q,N)
    cum = torch.cumsum(dk.double(), -1)
    last = cum[..., -1:]
    w, ecum = torch.exp(last - cum).to(f), torch.exp(cum).to(f)
    decay = torch.exp(last[..., 0]).to(f)                                   # (B,H,nc)
    # the forward's states h_c (K5's stages 2 and 3)
    dH = prod((bk[:, None] * w[..., None]).transpose(-1, -2), xk)           # (B,H,nc,N,P)
    h, hs = torch.zeros_like(dH[:, :, 0]), []
    for c in range(nc):
        hs.append(h)
        h = decay[:, :, c, None, None] * h + dH[:, :, c]
    hs = torch.stack(hs, 2)
    # stages 1 and 2: G_c = (C o exp(cum))^T dy + exp(last_c) G_{c+1}, G_nc = 0
    dG = prod((ck[:, None] * ecum[..., None]).transpose(-1, -2), gk)
    G, nxt = torch.zeros_like(dG[:, :, 0]), [None] * nc    # nxt[c] = G_{c+1}
    for c in reversed(range(nc)):
        nxt[c] = G
        G = dG[:, :, c] + decay[:, :, c, None, None] * G
    nxt = torch.stack(nxt, 2)
    q = torch.arange(Q)
    on = q[:, None] >= q[None, :]                                           # [t, s]
    L = torch.where(on, torch.exp(torch.where(on, cum[..., :, None] - cum[..., None, :], 0.0)),
                    0.0).to(f)
    # stage 3: dx, and r from its epilogue
    cb = prod(ck, bk.transpose(-1, -2))                                     # (B,nc,Q,Q) [t, s]
    dx = prod((cb[:, None] * L).transpose(-1, -2), gk) + w[..., None] * prod(bk[:, None], nxt)
    r = ((gk * yk).double().sum(-1) - (dx * xk).double().sum(-1)).reshape(Bn, H, nc * Q)
    # stage 4: W, each head's E = dy x^T weighted, the heads added in order
    EL = prod(gk, xk.transpose(-1, -2)) * L                                 # (B,H,nc,Q,Q) [t, s]
    W = torch.zeros_like(EL[:, 0])
    for h in range(H):
        W = W + EL[:, h]
    # stage 5: the N products after the head sum, then each head's slice of
    # the products over (h, p), weighted per row, in head order
    dB, dC = prod(W.transpose(-1, -2), ck), prod(W, bk)                     # (B,nc,Q,N)
    xg = w[..., None] * prod(xk, nxt.transpose(-1, -2))                     # (B,H,nc,Q,N)
    gh = ecum[..., None] * prod(gk, hs.transpose(-1, -2))
    for h in range(H):
        dB, dC = dB + xg[:, h], dC + gh[:, h]
    # stage 6: ddA, r summed from the end of the sequence
    ddA = torch.flip(torch.cumsum(torch.flip(r[..., :S], [-1]), -1), [-1])

    def unchunk(t):
        return t.reshape(Bn, nc * Q, *t.shape[3:])[:, :S]

    return unchunk(dx.permute(0, 2, 3, 1, 4)), ddA.transpose(1, 2).to(f), unchunk(dB), unchunk(dC)


@pytest.mark.parametrize("S,H,P,N,chunk", SSD_SHAPES + [(40, 2, 8, 6, 8), (64, 6, 8, 6, 16)])
@pytest.mark.parametrize("rates", [(0.01, 0.5), SLOW, SPREAD])
def test_chunked_formulas_equal_the_plain_backward_in_float64(S, H, P, N, chunk, rates):
    args = [torch.from_numpy(a).double()
            for a in ssd_inputs(2, S, H, P, N, 1, rates, per_head=rates == SPREAD)]
    y, _ = ref.ssd_scan_ref(*args[:4])
    got = emulate_bwd(*args, y, chunk, torch.matmul)
    assert_close([g.numpy() for g in got], [w.numpy() for w in ref.ssd_scan_bwd_ref(*args)],
                 1e-12)


@pytest.mark.parametrize("rates", [(0.01, 0.5), SLOW])
def test_three_tf32_passes_match_the_float64_backward_at_mamba2_widths(rates):
    """S (512) of two chunks of 256 at Mamba-2's head (P 64, N 128), y from
    K5's emulated arithmetic, every product in three TF32 passes."""
    x, dA, Bc, Cc, dy = map(torch.from_numpy, ssd_inputs(1, 512, 2, 64, 128, 2, rates))
    y = emulate(x, dA, Bc, Cc, 256)
    got = emulate_bwd(x, dA, Bc, Cc, dy, y, 256, lambda a, b: product(a, b, 3))
    want = ref.ssd_scan_bwd_ref(*(t.double() for t in (x, dA, Bc, Cc, dy)))
    assert_close([g.numpy() for g in got], [w.numpy() for w in want], KERNEL_TOL)


# (B, S, H, P, N, chunk): several heads at a small S, four and two chunks,
# then Mamba-2's head width over eight heads and two chunks
SPREAD_SHAPES = [(2, 64, 6, 8, 6, 16), (2, 64, 6, 64, 128, 32), (1, 512, 8, 64, 128, 256)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SPREAD_SHAPES)
def test_three_tf32_passes_hold_when_the_heads_are_summed_before_the_n_products(B, S, H, P, N,
                                                                                chunk):
    """Each head draws its decay logs from its own slice of [-0.5, -0.001]:
    W adds heads whose weights exp(cum_t - cum_s) differ by orders of
    magnitude before one product with B (or C), and the long products add
    each head's slice in head order.  In 3xTF32, y from K5's emulated
    arithmetic, every gradient within the kernel rows' 2e-4."""
    x, dA, Bc, Cc, dy = map(torch.from_numpy, ssd_inputs(B, S, H, P, N, 4, SPREAD, per_head=True))
    y = emulate(x, dA, Bc, Cc, chunk)
    got = emulate_bwd(x, dA, Bc, Cc, dy, y, chunk, lambda a, b: product(a, b, 3))
    want = ref.ssd_scan_bwd_ref(*(t.double() for t in (x, dA, Bc, Cc, dy)))
    assert_close([g.numpy() for g in got], [w.numpy() for w in want], KERNEL_TOL)


# -- the Functions --------------------------------------------------------------------


# -- S4's order: segments composed from the end --------------------------------------------


def emulate_rglru_bwd(a, h, dh, steps=rg.BWD_STEPS, warps=8):
    """S4 (``rglru_bwd_kernel``) in float32, in the kernel's order: the
    sequence cut into segments of ``warps`` x ``steps`` steps; in each, each
    warp's steps composed into one map g -> A g + B from its latest step, the
    warps' maps into the segment's; each segment's starting g from the end
    (0 after the last), as the look-back finds it; then each warp replays its
    steps from the g its predecessors' maps give.  a, h, dh (B,S,D) numpy."""
    f32 = np.float32
    B, S, D = a.shape
    seg = warps * steps
    nseg = -(-S // seg)
    pad = nseg * seg - S
    an = np.concatenate([a[:, 1:], np.zeros((B, 1, D), f32)], 1)       # a_{t+1}; a_S = 0
    hp = np.concatenate([np.zeros((B, 1, D), f32), h[:, :-1]], 1)      # h_{t-1}; h_{-1} = 0
    an, g_in, hp = (np.concatenate([x, np.full((B, pad, D), fill, f32)], 1)
                    for x, fill in ((an, 1.0), (dh, 0.0), (hp, 0.0)))
    # (B, segment, warp, step, D), warp 0 and step 0 the latest
    an, g_in, hp = (x.reshape(B, nseg, warps, steps, D)[:, :, ::-1, ::-1] for x in (an, g_in, hp))
    A = np.ones((B, nseg, warps, D), f32)
    Bw = np.zeros((B, nseg, warps, D), f32)
    for i in range(steps):
        Bw = an[:, :, :, i] * Bw + g_in[:, :, :, i]
        A = A * an[:, :, :, i]
    At = np.ones((B, nseg, D), f32)
    Bt = np.zeros((B, nseg, D), f32)
    for w in range(warps):
        Bt = A[:, :, w] * Bt + Bw[:, :, w]
        At = At * A[:, :, w]
    carry = np.zeros((B, nseg, D), f32)
    g = np.zeros((B, D), f32)
    for k in reversed(range(nseg)):
        carry[:, k] = g
        g = At[:, k] * g + Bt[:, k]
    db = np.zeros((B, nseg, warps, steps, D), f32)
    gw = carry
    for w in range(warps):
        gv = gw
        for i in range(steps):
            gv = an[:, :, w, i] * gv + g_in[:, :, w, i]
            db[:, :, w, i] = gv
        gw = A[:, :, w] * gw + Bw[:, :, w]
    da = db * hp
    db, da = (x[:, :, ::-1, ::-1].reshape(B, nseg * seg, D)[:, :S] for x in (db, da))
    return da, db


@pytest.mark.parametrize("S,D", [(2 * rg.BWD_SEGMENT, 40), (rg.BWD_SEGMENT + 1, 33),
                                 (rg.BWD_SEGMENT - 7, 5), (3 * rg.BWD_SEGMENT + 100, 64)])
def test_segments_composed_from_the_end_equal_the_plain_backward(S, D):
    """S4's order in float32 (segments of ``BWD_SEGMENT`` steps, a multiple
    of it, one step past one, less than one, and a ragged tail; D not a
    multiple of 32) against the plain backward and ``jax.vjp`` of the
    reference scan, within the plain backward's 1e-5 of the largest |want|."""
    a, b, dh = rglru_inputs(2, S, D, seed=S)
    h, vjp = jax.vjp(lambda a, b: jref.rglru_scan_ref(a, b)[0], jnp.asarray(a), jnp.asarray(b))
    h = np.array(h)
    got = emulate_rglru_bwd(a, h, dh)
    plain = ref.rglru_scan_bwd_ref(*(torch.from_numpy(t).double() for t in (a, h, dh)))
    assert_close(got, [t.numpy() for t in plain], TOL)
    assert_close(got, vjp(jnp.asarray(dh)), TOL)
    assert got[0].dtype == np.float32 and not got[0][:, 0].any()


def test_bwd_segment_is_the_kernels():
    """``rglru_scan.BWD_STEPS``, which the emulation and the card tests cut
    segments by, is the depth ``csrc/rglru_scan.cu`` builds S4 with."""
    text = (_build.CSRC_DIR / "rglru_scan.cu").read_text()
    assert f"constexpr int BWD_STEPS = {rg.BWD_STEPS};" in text
    assert "constexpr int WARPS = 8;" in text and rg.BWD_SEGMENT == 8 * rg.BWD_STEPS


def test_ssd_scan_function_passes_gradcheck_in_float64():
    x, dA, Bc, Cc, _ = ssd_inputs(1, 20, 2, 3, 4, 3)
    x = torch.from_numpy(x).double().transpose(1, 2).requires_grad_()
    dA = torch.from_numpy(dA).double().transpose(1, 2).requires_grad_()
    Bc, Cc = (torch.from_numpy(t).double().requires_grad_() for t in (Bc, Cc))
    assert torch.autograd.gradcheck(lambda *a: ssd_k.SsdScan.apply(*a, 8), (x, dA, Bc, Cc))


def test_rglru_scan_function_passes_gradcheck_in_float64():
    a, b, _ = (torch.from_numpy(t).double().requires_grad_() for t in rglru_inputs(2, 19, 3, 4))
    assert torch.autograd.gradcheck(rg.RglruScan.apply, (a, b))


def test_scans_route_through_their_functions_on_the_cpu_and_count_no_launch():
    """Under grad each scan returns its Function's output, whose backward is
    the plain one (the gradients equal the plain backwards' on the same
    inputs); without grad there is no ``grad_fn``.  No launch is counted."""
    counts = (ssd_k.launches, ssd_k.bwd_launches, rg.launches, rg.bwd_launches)
    x, dA, Bc, Cc, dy = map(torch.from_numpy, ssd_inputs(2, 24, 2, 4, 3, 5))
    leaves = [t.clone().requires_grad_() for t in (x, dA, Bc, Cc)]
    y = ssd_k.ssd_scan(leaves[0].transpose(1, 2), leaves[1].transpose(1, 2), *leaves[2:],
                       chunk=8)
    assert type(y.grad_fn).__name__ == "SsdScanBackward"
    y.transpose(1, 2).backward(dy)
    assert_close([t.grad for t in leaves], ref.ssd_scan_bwd_ref(x, dA, Bc, Cc, dy), 0.0)
    a, b, dh = map(torch.from_numpy, rglru_inputs(2, 17, 6, 6))
    la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = rg.rglru_scan(la, lb)
    assert type(h.grad_fn).__name__ == "RglruScanBackward"
    h.backward(dh)
    assert_close([la.grad, lb.grad], ref.rglru_scan_bwd_ref(a, h.detach(), dh), 0.0)
    with torch.no_grad():
        assert ssd_k.ssd_scan(leaves[0].transpose(1, 2), leaves[1].transpose(1, 2), *leaves[2:],
                              chunk=8).grad_fn is None
        assert rg.rglru_scan(la, lb).grad_fn is None
    assert (ssd_k.launches, ssd_k.bwd_launches, rg.launches, rg.bwd_launches) == counts
