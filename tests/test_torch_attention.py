"""The port's attention kernels (K3 flash attention, K4 decode attention)
against the reference's Pallas kernels: the same seeded operands go through
``repro.kernels.ops`` (interpret mode on the CPU) and
``repro_torch.kernels.ops`` (the plain versions on the CPU).

Tolerance as the reference's kernel tests (``_tol``): 2e-5 for float32 (both
sum in float32, in different orders), 2e-2 for bfloat16 (one rounding to 8
bits of mantissa at the end).  bfloat16 operands travel as float32 arrays
holding bfloat16-representable values.  The CUDA kernels themselves have no
CPU mode; ``tests/test_torch_gpu.py`` holds them to these plain versions
where there is a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models import attention as ref_attention
from repro.models.attention import flash_attention as ref_model_flash

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

from test_torch_gpu import DECODE_CASES, DTYPES, FLASH_CASES, attention_operands, normal, tol

jax.config.update("jax_enable_x64", False)

JNP_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def both(name, *arrays):
    """The same numpy arrays as (jax arrays, torch tensors) of dtype ``name``."""
    return ([jnp.asarray(a).astype(JNP_DTYPE[name]) for a in arrays],
            [torch.as_tensor(a).to(DTYPES[name]) for a in arrays])


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# -- K3 flash attention -----------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Sq,Sk,H,KvH,D,window", FLASH_CASES)
def test_flash_attention(Sq, Sk, H, KvH, D, window, dtype):
    B = 2
    (jq, jk, jv), (q, k, v) = both(dtype, *attention_operands((B, Sq, H, D), (B, Sk, KvH, D), dtype))
    want = ref_ops.mha(jq, jk, jv, causal=True, window=window, bq=64, bk=64)
    before = fa.launches
    got = ops.mha(q, k, v, causal=True, window=window)
    assert fa.launches == before                # the plain version is not a launch
    assert got.shape == (B, Sq, H, D) and got.dtype == DTYPES[dtype]
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def test_flash_vs_model_oracle():
    """Kernel agrees with the model-layer chunked flash oracle, the port's
    and the reference's."""
    B, S, H, D = 1, 256, 2, 32
    (jq, jk, jv), (q, k, v) = both("float32", *attention_operands((B, S, H, D), (B, S, H, D),
                                                                  "float32", seed=7))
    out = ops.mha(q, k, v)
    port_model = attention.flash_attention(q, k, v, causal=True, kv_chunk=64)
    want = ref_model_flash(jq, jk, jv, causal=True, kv_chunk=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(port_model.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    dense = attention.dense_attention(q, k, v, causal=True)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [
    (80, 48),    # Sq != Sk, both ragged: causal admits k_pos in [48, 64) once padded
    (48, 48),    # ragged keys only
])
def test_mha_padded_kv_is_masked(causal, Sq, Sk):
    """Keys past Sk never attend: the reference pads and passes ``kv_len``;
    the port's kernel masks its ragged edge itself.  And ``kv_len`` keeps
    keys appended to the cache out, whatever they hold."""
    B, H, D = 1, 2, 32
    (jq, jk, jv), (q, k, v) = both("float32", *attention_operands((B, Sq, H, D), (B, Sk, H, D),
                                                                  "float32", seed=11))
    got = ops.mha(q, k, v, causal=causal)
    want = ref_ops.mha(jq, jk, jv, causal=causal, bq=32, bk=32)
    oracle = ref_oracles.flash_attention_ref(jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
                                             jnp.swapaxes(jv, 1, 2), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.swapaxes(oracle, 1, 2)),
                               rtol=2e-5, atol=2e-5)
    junk = torch.as_tensor(normal((B, 16, H, D), "float32", 12)) * 100
    kp, vp = (torch.cat([x, junk], 1).transpose(1, 2) for x in (k, v))
    padded = fa.flash_attention(q.transpose(1, 2), kp, vp, causal=causal, kv_len=Sk)
    np.testing.assert_allclose(padded.transpose(1, 2).numpy(), got.numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,Sk,window", [(179, 130, 50), (100, 40, 61)])
def test_flash_attention_window_up_to_the_last_row_with_a_key(Sq, Sk, window):
    """Under a window, row ``Sk + window - 2`` is the last that sees a key.
    Up to it the port agrees with the reference; one row more, or a
    ``kv_len`` that leaves a row without keys, is a ValueError."""
    B, H, KvH, D = 1, 4, 2, 32
    (jq, jk, jv), (q, k, v) = both("float32", *attention_operands((B, Sq, H, D), (B, Sk, KvH, D),
                                                                  "float32", seed=13))
    want = ref_ops.mha(jq, jk, jv, causal=True, window=window, bq=64, bk=64)
    got = ops.mha(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("float32"))
    more = torch.cat([q, q[:, :1]], 1)
    with pytest.raises(ValueError, match="see no key"):
        ops.mha(more, k, v, causal=True, window=window)
    with pytest.raises(ValueError, match="see no key"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           window=window, kv_len=Sk - 1)


def test_flash_attention_contract_errors():
    """The shape contracts are ValueErrors, on both sides, and are checked
    before the dispatch on the device."""
    q, kv = torch.zeros((1, 3, 64, 16)), torch.zeros((1, 2, 64, 16))    # KvH=2 does not divide H=3
    with pytest.raises(ValueError, match="multiple of KvH"):
        fa.flash_attention(q, kv, kv)
    from repro.kernels import flash_attention as ref_fa
    with pytest.raises(ValueError, match="multiple of KvH"):
        ref_fa.flash_attention(jnp.zeros((1, 3, 64, 16)), jnp.zeros((1, 2, 64, 16)),
                               jnp.zeros((1, 2, 64, 16)), interpret=True)
    q = torch.zeros((1, 2, 64, 16))
    for bad in (65, 0):
        with pytest.raises(ValueError, match="kv_len"):
            fa.flash_attention(q, q, q, kv_len=bad)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, q, torch.zeros((1, 2, 32, 16)))
    with pytest.raises(ValueError, match="multiple of KvH"):
        ref.flash_attention_ref(torch.zeros((1, 3, 8, 16)), q, q)


# -- K4 decode attention ----------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("L,H,KvH,D,length", DECODE_CASES)
def test_decode_attention(L, H, KvH, D, length, dtype):
    B = 2
    (jq, jk, jv), (q, k, v) = both(dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype,
                                                              seed=3))
    want = ref_ops.decode(jq, jk, jv, length, bk=128)
    before = dec.launches
    got = ops.decode(q, k, v, length)
    assert dec.launches == before
    assert got.shape == (B, H, D) and got.dtype == DTYPES[dtype]
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_per_lane_length_equals_reference_lane_by_lane(dtype):
    """The reference kernel takes one scalar length for the batch; the port's
    takes one per lane: lane b of the port equals the reference run on lane
    b alone with that lane's length."""
    B, L, H, KvH, D = 4, 256, 4, 2, 32
    lengths = [1, 100, 129, 256]
    (jq, jk, jv), (q, k, v) = both(dtype, *attention_operands((B, H, D), (B, L, KvH, D), dtype,
                                                              seed=5))
    got = ops.decode(q, k, v, torch.tensor(lengths, dtype=torch.int32))
    for b, n in enumerate(lengths):
        want = ref_ops.decode(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], n, bk=128)
        np.testing.assert_allclose(f32(got[b:b + 1]), f32(want), **tol(dtype))
        alone = ops.decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], n)
        np.testing.assert_array_equal(f32(got[b:b + 1]), f32(alone))


def test_decode_partial_merge_equals_full():
    """Sequence-sharded flash-decode: merging per-shard partials reproduces
    the unsharded result, on the port's side as on the reference's."""
    B, L, H, D, S = 2, 512, 4, 64, 4
    (jq, jk, jv), (q, k, v) = both("float32", *attention_operands((B, H, D), (B, L, H, D),
                                                                  "float32", seed=4))
    full = ops.decode(q, k, v, L)
    shard = L // S
    parts = [ops.decode_partial(q, k[:, s * shard:(s + 1) * shard],
                                v[:, s * shard:(s + 1) * shard], shard) for s in range(S)]
    merged = ops.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(merged.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)
    ref_parts = [ref_ops.decode_partial(jq, jk[:, s * shard:(s + 1) * shard],
                                        jv[:, s * shard:(s + 1) * shard], shard, bk=128,
                                        interpret=True) for s in range(S)]
    for got, want in zip(parts, ref_parts):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
    ref_merged = ref_ops.merge_partials(*(jnp.stack(x) for x in zip(*ref_parts)))
    np.testing.assert_allclose(merged.numpy(), np.asarray(ref_merged), rtol=1e-5, atol=1e-5)


def test_decode_attention_contract_errors():
    """H % KvH is a ValueError in the port (the reference asserts), and a
    length tensor must hold one value or one per lane."""
    q, kv = torch.zeros((2, 3, 16)), torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="multiple of KvH"):
        dec.decode_attention(q, kv, kv, 8)
    with pytest.raises(ValueError, match="multiple of KvH"):
        dec.partial_decode_attention(q, kv, kv, 8)
    with pytest.raises(AssertionError):
        ref_ops.decode(jnp.zeros((2, 3, 16)), jnp.zeros((2, 8, 2, 16)), jnp.zeros((2, 8, 2, 16)), 8)
    q = torch.zeros((2, 4, 16))
    with pytest.raises(ValueError, match="lanes"):
        dec.decode_attention(q, kv, kv, torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError, match="do not match"):
        dec.decode_attention(q, kv, torch.zeros((2, 9, 2, 16)), 8)


# -- the model's attention ------------------------------------------------------------


def test_model_attention_raises_for_what_the_dense_slice_leaves_out():
    """No silent plain path for the sequence-sharded decode.  Windows are
    ported (a windowed cache is a ring of ``min(window, seq_len)`` slots), and
    so is cross-attention (tests/test_torch_cross.py): its parameters are the
    self-attention's, and a memory of another length gives the query's shape
    back.  Logit soft-capping runs: a capped self- and cross-attention equal
    the reference's ``attn_forward`` under the same cap, with queries and
    keys 16 times larger so that the cap moves the result."""
    cfg = get_smoke_config("tinyllama-1.1b")
    gen = torch.Generator().manual_seed(0)
    p = attention.init_attn(gen, cfg)
    x = torch.zeros((1, 4, cfg.d_model))
    cache = attention.init_attn_cache(1, 8, cfg, window=2, device="cpu")
    assert cache["k"].shape[1] == 2
    assert attention.attn_forward(p, x, cfg, window=2).shape == x.shape
    out, _ = attention.attn_decode_step(p, x[:, :1], cache, 0, cfg, window=2)
    assert out.shape == (1, 1, cfg.d_model)
    memory = torch.ones((1, 7, cfg.d_model))
    assert attention.attn_forward(p, x, cfg, kv=memory).shape == x.shape
    capped = cfg.scaled(attn=cfg.attn.__class__(**{**cfg.attn.__dict__, "logit_softcap": 30.0}))
    ref_capped = ref_registry.get_smoke_config("tinyllama-1.1b")
    ref_capped = ref_capped.scaled(attn=dataclasses.replace(ref_capped.attn, logit_softcap=30.0))
    sharp = dict(p, wq=p["wq"] * 16, wk=p["wk"] * 16)
    jp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in sharp.items()}
    xs = torch.as_tensor(normal((1, 4, cfg.d_model), "float32", 3))
    ms = torch.as_tensor(normal((1, 7, cfg.d_model), "float32", 4))
    for kv, jkv in ((None, None), (ms, jnp.asarray(ms.numpy()))):
        got = attention.attn_forward(sharp, xs, capped, kv=kv)
        want = ref_attention.attn_forward(jp, jnp.asarray(xs.numpy()), ref_capped, kv=jkv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        assert float((got - attention.attn_forward(sharp, xs, cfg, kv=kv)).abs().max()) > 1e-4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention._sharded_flash_decode(None, None, None, None, cfg, None)
    cross = attention.init_attn(gen, cfg, cross=True)
    assert {k: v.shape for k, v in cross.items()} == {k: v.shape for k, v in p.items()}
