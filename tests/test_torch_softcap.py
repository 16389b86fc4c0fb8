"""Attention logit soft-capping in the port against the reference on the CPU.

Under a cap c the reference turns each scaled score s into ``tanh(s / c) * c``
(``repro.models.common.softcap``) before the masks, in its dense and chunked
attention, its cache and cross decode, and trains through it with
``jax.value_and_grad``.  The port caps inside its kernels (K3, K4 and S2 on
the card); on the CPU their plain versions run, and those are what is held
here:

* K3's plain version (``ops.mha``) and the port's own oracle pair against the
  reference's ``dense_attention(logit_cap=)`` and ``flash_attention(logit_cap=,
  kv_chunk=16)``: causal, windowed, GQA, non-causal with Sq != Sk;
* S2's plain version (``FlashAttention``'s backward) against ``jax.vjp`` of the
  reference's ``dense_attention(logit_cap=)``;
* K4's plain version inside ``attn_decode_step`` (a full cache and a ring, an
  index per lane) and ``cross_attn_decode``;
* capped smoke configs of tinyllama, recurrentgemma (its local attention
  beside its final-logit cap), seamless (the encoder and cross-attention) and
  deepseek (MLA, which ignores the cap on both sides): ``lm_forward``, the
  prefill step, teacher-forced decode steps, and (tinyllama, recurrentgemma)
  ``make_grad_fn`` against ``jax.value_and_grad`` of the reference's loss.

Weights are the reference's ``init_lm`` draws carried over by
``compat.params_from_reference``, with every attention query and key weight
(``wq``, ``wk``) 16 times larger on both sides (exact in bfloat16): at a smoke
model's own scale the scores are far below any cap and a cap that was never
applied would pass.  Every capped model but deepseek's is checked to differ
from the same model uncapped.  Operands are numpy draws from a seed, float32,
queries 8 times normal (4 in the backward).  Tolerance 1e-5 (rtol and atol) throughout: the same
float32 arithmetic in another order.  The reference side is jitted once per
function and config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import attention as ref_attention
from repro.models import transformer as ref_transformer
from repro.train import steps as ref_steps

from repro_torch import _tree, compat
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention, transformer
from repro_torch.train import steps

CAPS = (30.0, 50.0)
TOL = dict(rtol=1e-5, atol=1e-5)
SHARP = 16.0                   # wq and wk scaled by it (a power of 2: exact in bf16)
Q_SCALE = 8.0                  # queries of the kernel cases, times normal
B = 2

# (B, Sq, Sk, H, KvH, D, causal, window)
FLASH_CASES = {
    "causal": (B, 40, 40, 4, 4, 16, True, None),
    "window": (B, 40, 40, 4, 4, 16, True, 7),
    "gqa": (B, 33, 33, 8, 2, 16, True, None),
    "non-causal Sq != Sk": (B, 24, 37, 4, 2, 16, False, None),
}


def capped(cfg, cap):
    return cfg.scaled(attn=dataclasses.replace(cfg.attn, logit_softcap=cap))


def operands(shapes, seed, q_scale=Q_SCALE):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    arrays[0] *= q_scale
    return arrays


# -- K3 and S2: the plain versions ------------------------------------------------------


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_attention_matches_reference(case, cap):
    """``ops.mha`` (K3's plain version on the CPU) against the reference's
    dense and chunked attention under the cap; the port's own chunked and
    dense oracles likewise where they take the case (no window).  The cap
    moves the result: it differs from the uncapped one."""
    b, Sq, Sk, H, KvH, D, causal, window = FLASH_CASES[case]
    q, k, v = operands(((b, Sq, H, D), (b, Sk, KvH, D), (b, Sk, KvH, D)), seed=len(case))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    dense = np.asarray(ref_attention.dense_attention(jq, jk, jv, **kw))
    chunked = np.asarray(ref_attention.flash_attention(jq, jk, jv, kv_chunk=16, **kw))
    got = ops.mha(tq, tk, tv, causal=causal, window=window, softcap=cap)
    assert got.shape == (b, Sq, H, D)
    np.testing.assert_allclose(got.numpy(), dense, **TOL)
    np.testing.assert_allclose(got.numpy(), chunked, **TOL)
    if window is None:
        oracles = (attention.dense_attention(tq, tk, tv, causal=causal, softcap=cap),
                   attention.flash_attention(tq, tk, tv, causal=causal, kv_chunk=16,
                                             softcap=cap))
        for o in oracles:
            np.testing.assert_allclose(o.numpy(), dense, **TOL)
    uncapped = ops.mha(tq, tk, tv, causal=causal, window=window)
    assert float((got - uncapped).abs().max()) > 1e-2


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_backward_matches_reference_vjp(case, cap):
    """Under grad ``ops.mha`` goes through ``FlashAttention``, whose backward
    on the CPU is S2's plain version (``ref.flash_attention_bwd_ref``) with
    the forward's cap: dq, dk and dv against ``jax.vjp`` of the reference's
    capped ``dense_attention``.  Queries 4 times normal (scores up to about
    15, which both caps bend): dk sums a group's query heads' terms, each of
    the queries' size, so at 8 times its float32 rounding alone reaches 1e-5
    (about 1e-6 of dk's largest, 12)."""
    b, Sq, Sk, H, KvH, D, causal, window = FLASH_CASES[case]
    q, k, v, do = operands(((b, Sq, H, D), (b, Sk, KvH, D), (b, Sk, KvH, D), (b, Sq, H, D)),
                           seed=10 + len(case), q_scale=Q_SCALE / 2)
    _, vjp = jax.vjp(lambda a, bb, c: ref_attention.dense_attention(
        a, bb, c, causal=causal, window=window, logit_cap=cap),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = ops.mha(*t, causal=causal, window=window, softcap=cap)
    function = out.grad_fn.next_functions[0][0]          # under ops.mha's transpose
    assert isinstance(function, torch.autograd.function.BackwardCFunction)
    got = torch.autograd.grad(out, t, torch.as_tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_a_cap_must_be_positive():
    q = torch.zeros((1, 2, 4, 16))
    for bad in (0.0, -1.0, float("inf")):
        with pytest.raises(ValueError, match="softcap"):
            fa.flash_attention(q, q, q, softcap=bad)


# -- K4 inside the decode steps -----------------------------------------------------------


_layers: dict = {}


def attention_layer(arch, kind):
    """(port cfg, reference cfg, reference mixer params of repeat 0 of the
    first ``kind`` block, the port's copy), wq and wk sharpened."""
    if (arch, kind) not in _layers:
        ref_cfg = ref_registry.get_smoke_config(arch)
        params = sharpened(jax.device_get(ref_transformer.init_lm(jax.random.key(0), ref_cfg)))
        seg = next(i for i, s in enumerate(ref_cfg.segments) if kind in s.pattern)
        pos = ref_cfg.segments[seg].pattern.index(kind)
        mixer = {k: v[0] for k, v in params["segments"][seg][pos]["mixer"].items()}
        _layers[(arch, kind)] = (registry.get_smoke_config(arch), ref_cfg, mixer,
                                 compat.params_from_reference(mixer, "cpu"))
    return _layers[(arch, kind)]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("ring", [False, True])
def test_attn_decode_step_matches_reference(ring, cap):
    """One token a lane against a cache already holding seeded K/V, each lane
    at its own index: a full cache (slot = index, the lanes at 3 and 13 of
    16), and a ring of 6 slots under a window of 6 (one lane before it wraps,
    one after).  The output and the updated cache."""
    cfg, ref_cfg, mixer, pp = attention_layer("tinyllama-1.1b", "attn")
    cfg, ref_cfg = capped(cfg, cap), capped(ref_cfg, cap)
    a = cfg.attn
    L, window = (6, 6) if ring else (16, None)
    rng = np.random.default_rng(20 + int(ring))
    k, v = (rng.standard_normal((B, L, a.n_kv_heads, a.d_head)).astype(np.float32)
            for _ in range(2))
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32) * 3
    index = np.array([3, 13], np.int32)
    got, cache = attention.attn_decode_step(
        pp, torch.as_tensor(x1), {"k": torch.as_tensor(k), "v": torch.as_tensor(v)},
        torch.as_tensor(index), cfg, window=window)
    want, ref_cache = jax.jit(lambda p, x, c, i: ref_attention.attn_decode_step(
        p, x, c, i, ref_cfg, window=window))(
        mixer, jnp.asarray(x1), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(index))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]), **TOL)
    plain, _ = attention.attn_decode_step(
        pp, torch.as_tensor(x1), {"k": torch.as_tensor(k), "v": torch.as_tensor(v)},
        torch.as_tensor(index), capped(cfg, None), window=window)
    assert float((got - plain).abs().max()) > 1e-4


@pytest.mark.parametrize("cap", CAPS)
def test_cross_attn_decode_matches_reference(cap):
    """seamless-m4t's cross layer: one token a lane against a memory of 16
    frames, every lane's length the whole memory."""
    cfg, ref_cfg, mixer, pp = attention_layer("seamless-m4t-medium", "cross_attn")
    cfg, ref_cfg = capped(cfg, cap), capped(ref_cfg, cap)
    a = cfg.attn
    rng = np.random.default_rng(30)
    k, v = (rng.standard_normal((B, cfg.frontend_tokens, a.n_kv_heads, a.d_head))
            .astype(np.float32) for _ in range(2))
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32) * 3
    cross = {n: t for n, t in pp.items() if not n.startswith("gate")}
    got = attention.cross_attn_decode(cross, torch.as_tensor(x1), torch.as_tensor(k),
                                      torch.as_tensor(v), cfg)
    want = jax.jit(lambda p, x, kk, vv: ref_attention.cross_attn_decode(p, x, kk, vv, ref_cfg))(
        mixer, jnp.asarray(x1), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = attention.cross_attn_decode(cross, torch.as_tensor(x1), torch.as_tensor(k),
                                        torch.as_tensor(v), capped(cfg, None))
    assert float((got - plain).abs().max()) > 1e-4


# -- the models ---------------------------------------------------------------------------

ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b", "seamless-m4t-medium", "deepseek-v2-lite-16b"]
TRAINED = ["tinyllama-1.1b", "recurrentgemma-9b"]
MODEL_CAP = 30.0
S = 20                          # past recurrentgemma's window of 16: the ring wraps

_models: dict = {}


def sharpened(tree):
    """The reference tree with every ``wq`` and ``wk`` leaf SHARP times
    larger, and every cross layer's gates opened to values drawn from a seed
    (a fresh model's are 0, which hides cross-attention)."""
    rng = np.random.default_rng(5)

    def visit(node):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if key in ("wq", "wk"):
                    out[key] = (np.asarray(val, np.float32) * SHARP).astype(val.dtype)
                elif key in ("gate_attn", "gate_ffn"):
                    out[key] = rng.uniform(0.3, 1.2, val.shape).astype(val.dtype)
                else:
                    out[key] = visit(val)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return node

    return visit(tree)


def capped_model(arch):
    """(port cfg, reference cfg, both capped; reference params, sharpened;
    the port's copy; the reference's jitted forward, decode step and cache
    preparation), once per arch."""
    if arch not in _models:
        ref_cfg = capped(ref_registry.get_smoke_config(arch), MODEL_CAP)
        params = sharpened(jax.device_get(ref_transformer.init_lm(jax.random.key(0), ref_cfg)))
        jitted = {
            "forward": jax.jit(lambda p, b: ref_transformer.lm_forward(p, b, ref_cfg)[0]),
            "step": jax.jit(lambda p, c, t, i: ref_transformer.lm_decode_step(p, c, t, i,
                                                                              ref_cfg)),
            "prepare": jax.jit(lambda p, c, b: ref_transformer.lm_prepare_decode_cache(
                p, c, b, ref_cfg)),
        }
        _models[arch] = (capped(registry.get_smoke_config(arch), MODEL_CAP), ref_cfg, params,
                         compat.params_from_reference(params, "cpu"), jitted)
    return _models[arch]


def model_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend is not None:
        batch["frontend_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_capped_lm_forward_matches_reference(arch):
    """The logits, and the prefill step's (the same forward).  Uncapped, the
    port's logits move (deepseek's MLA ignores the cap: they do not)."""
    cfg, ref_cfg, params, pp, jitted = capped_model(arch)
    batch = model_batch(cfg, 0)
    got, _ = transformer.lm_forward(pp, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    want = jitted["forward"](params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    prefill = steps.make_prefill_step(cfg, device="cpu")(pp, batch)
    np.testing.assert_array_equal(prefill.numpy(), got.numpy())
    plain, _ = transformer.lm_forward(pp, {k: torch.as_tensor(v) for k, v in batch.items()},
                                      capped(cfg, None))
    moved = float((got - plain).abs().max())
    if arch == "deepseek-v2-lite-16b":
        assert moved == 0.0
    else:
        assert moved > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_capped_decode_matches_reference(arch):
    """Teacher-forced ``lm_decode_step`` over every position from an empty
    cache (the engine's prefill, then its decode steps), the cross caches
    filled from the seeded memory first: each step's logits."""
    cfg, ref_cfg, params, pp, jitted = capped_model(arch)
    batch = model_batch(cfg, 1)
    toks = batch["tokens"]
    ref_cache = ref_transformer.init_lm_cache(ref_cfg, B, S)
    cache = transformer.init_lm_cache(cfg, B, S, device="cpu")
    if "frontend_embeds" in batch:
        fe = batch["frontend_embeds"]
        ref_cache = jitted["prepare"](params, ref_cache, {"frontend_embeds": jnp.asarray(fe)})
        cache = transformer.lm_prepare_decode_cache(pp, cache,
                                                    {"frontend_embeds": torch.as_tensor(fe)}, cfg)
    for t in range(S):
        want, ref_cache = jitted["step"](params, ref_cache, jnp.asarray(toks[:, t:t + 1]),
                                         jnp.asarray(t, jnp.int32))
        got, cache = transformer.lm_decode_step(pp, cache, torch.as_tensor(toks[:, t:t + 1]),
                                                t, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", TRAINED)
def test_capped_gradients_match_reference(arch):
    """``make_grad_fn`` against ``jax.value_and_grad`` of the reference's
    ``make_loss_fn`` under the cap, from float32 copies of the sharpened
    weights: the loss and every gradient leaf."""
    cfg, ref_cfg, params, _, _ = capped_model(arch)
    params32 = jax.tree.map(lambda x: np.asarray(x, np.float32)
                            if x.dtype == jnp.bfloat16 else x, params)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, _), grads = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(ref_cfg),
                                                  has_aux=True))(
        jax.tree.map(jnp.asarray, params32), {k: jnp.asarray(v) for k, v in batch.items()})
    p_loss, _, p_grads = steps.make_grad_fn(cfg)(
        compat.params_from_reference(params32, "cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(p_loss), float(loss), **TOL)
    want = _tree.with_paths(compat.params_from_reference(jax.device_get(grads), "cpu"))
    got = _tree.with_paths(p_grads)
    assert set(want) == set(got)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), **TOL, err_msg=key)
