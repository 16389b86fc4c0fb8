"""What the Hopper designs of K3 and K4 change, checked on the CPU.

K3's bfloat16 kernel (``flash_bf16_wgmma``) keeps bf16 Q, K and V, forms
float32 scores on the tensor cores, rounds P to bf16 before P·V and keeps O
in float32; the one rounding beyond the Pallas body's is that of P.  A
test-only emulation of that arithmetic, tile by tile in the kernel's order,
stays within the reference tests' bf16 tolerance (2e-2 + 2e-2·|ref|) of the
Pallas ``flash_attention`` run in interpret mode — before the card shows it.

K4 splits the cache into chunks in Python (``decode_attention.split``): the
chunks cover [0, L) once, none below a lane's length is empty, and the grid
fills the card at the serving shape.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels.ref import flash_attention_ref

from test_torch_gpu import FLASH_CASES, attention_operands, tol

LOG2E = 1.4426950408889634
MASKED = -1e30


def flash_bf16_emulated(q, k, v, *, causal=True, window=None, kv_len=None):
    """The bf16 kernel's arithmetic in float32 torch: q (B,H,Sq,D), k, v
    (B,KvH,Sk,D) holding bf16 values.  Scores are (q . k) * scale * log2(e)
    in float32, masked at -1e30, keys past Sk absent; an online softmax on
    exp2 over tiles of 128 keys (64 at D 256), with P rounded to bf16 before
    P·V and the sums in float32; the output acc / max(l, 1e-30) in bf16."""
    B, H, Sq, D = q.shape
    KvH, Sk = k.shape[1], k.shape[2]
    G = H // KvH
    bk = 64 if D == 256 else 128
    n_keys = kv_len or Sk
    qf = q.float().reshape(B, KvH, G, Sq, D)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, KvH, G, Sq, 1), MASKED)
    l = torch.zeros((B, KvH, G, Sq, 1))
    acc = torch.zeros((B, KvH, G, Sq, D))
    for k0 in range(0, Sk, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * (D ** -0.5 * LOG2E)
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = k_pos < n_keys
        if causal:
            ok = ok & (k_pos <= q_pos)
        if window is not None:
            ok = ok & (k_pos > q_pos - window)
        s = torch.where(ok, s, MASKED)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16().float(), vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, Sq, D).bfloat16()


def pallas_flash(q, k, v, *, window=None):
    """The reference's ``ops.mha`` (the Pallas kernel in interpret mode) on
    (B,S,H,D) numpy operands, as float32 numpy."""
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    out = ref_ops.mha(jq, jk, jv, causal=True, window=window, bq=64, bk=64)
    return np.asarray(out.astype(jnp.float32))


# the reference test's shapes, a ragged one under GQA, and RecurrentGemma's
# heads (16 over one KV head of 256) under a window that starts mid-tile
EMULATION_CASES = FLASH_CASES + [(200, 200, 8, 2, 64, None), (300, 300, 16, 1, 256, 100)]


@pytest.mark.parametrize("Sq,Sk,H,KvH,D,window", EMULATION_CASES)
def test_bf16_kernel_rounding_within_tolerance_of_pallas(Sq, Sk, H, KvH, D, window):
    B = 1 if D == 256 else 2
    q, k, v = attention_operands((B, Sq, H, D), (B, Sk, KvH, D), "bfloat16", seed=21)
    want = pallas_flash(q, k, v, window=window)
    got = flash_bf16_emulated(*(torch.as_tensor(x).transpose(1, 2) for x in (q, k, v)),
                              window=window).transpose(1, 2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol("bfloat16"))


def test_the_emulation_rounds_p_where_the_kernel_does():
    """The emulation is not the plain version under another name: with P
    kept in float32 it moves by about bf16's rounding of P, no more."""
    q, k, v = (torch.as_tensor(x).transpose(1, 2) for x in
               attention_operands((1, 128, 2, 64), (1, 128, 2, 64), "bfloat16", seed=22))
    rounded = flash_bf16_emulated(q, k, v).float()
    exact = flash_attention_ref(q.float(), k.float(), v.float())
    gap = float((rounded - exact).abs().max())
    assert 0 < gap < 2e-2


# -- K4's split of the cache ------------------------------------------------------

SPLIT_CASES = [(1024, 16, 64), (1024, 4, 256), (1024, 16, 16), (64, 1, 128), (100, 3, 32),
               (4096, 8, 128), (32768, 4, 64), (1, 1, 64), (1000, 132, 64), (8192, 64, 256)]


def active_chunks(n, L, chunk, n_chunks):
    """The chunks the kernel reads for a lane of length ``n`` (its rule in
    ``decode_attention.cu``): those below the length; every chunk for a
    length of 0, whose weights are uniform over the whole cache."""
    return min(-(-min(n, L) // chunk), n_chunks) if n > 0 else n_chunks


@pytest.mark.parametrize("L,pairs,D", SPLIT_CASES)
def test_split_covers_the_cache_once(L, pairs, D):
    chunk, n_chunks = dec.split(L, pairs, D)
    assert chunk % dec.CHUNK == 0 and chunk >= dec.CHUNK
    assert n_chunks == math.ceil(L / chunk)
    starts = [c * chunk for c in range(n_chunks)]
    covered = [p for s in starts for p in range(s, min(s + chunk, L))]
    assert covered == list(range(L))             # each position once, in order
    # what a block stages in bf16 (K and V) stays within 64 KB above the least chunk
    assert chunk == dec.CHUNK or 2 * chunk * D * 2 <= 64 * 1024


@pytest.mark.parametrize("L,pairs,D", SPLIT_CASES)
def test_no_active_chunk_is_empty_below_a_lanes_length(L, pairs, D):
    chunk, n_chunks = dec.split(L, pairs, D)
    for n in sorted({1, chunk - 1, chunk, chunk + 1, L - 1, L, L + 5}):
        if n <= 0:
            continue
        active = active_chunks(n, L, chunk, n_chunks)
        assert all(c * chunk < min(n, L) for c in range(active))
        assert active == n_chunks or active * chunk >= min(n, L)
    # a length of 0 masks every position: all chunks count, weights uniform
    assert active_chunks(0, L, chunk, n_chunks) == n_chunks


def test_the_serving_grid_fills_the_card():
    """At 4 lanes of a 1024-position cache and 4 KV heads (tinyllama's
    serving shape) the one launch has at least a block for each of the
    H100's 132 SMs; at RecurrentGemma's one KV head of 256 it is still
    more than one chunk a lane."""
    chunk, n_chunks = dec.split(1024, 4 * 4, 64, sms=132)
    assert n_chunks * 4 * 4 >= 132
    chunk, n_chunks = dec.split(1024, 4 * 1, 256, sms=132)
    assert n_chunks > 1 and chunk * 256 * 2 * 2 <= 64 * 1024
