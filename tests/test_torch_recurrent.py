"""The recurrent slice of the port against the reference on the CPU: the scan
kernels' wrappers (K5 SSD scan, K6 RG-LRU scan) against the reference's
Pallas kernels in interpret mode and its plain oracles; the Mamba-2 and
RG-LRU mixers and windowed attention with its ring-buffer cache; the
``mamba2-smoke`` and ``rg-smoke`` language models; and the wave-refilling
``Engine``.  Weights are the reference's ``init_*`` draws carried over by
``compat.params_from_reference``; other inputs are numpy draws from a seed.

Tolerances: the reference kernel tests' own (2e-4 for the scans against the
step-by-step oracles, 1e-5 for the RG-LRU scan against the model's
associative scan); 1e-5 between the two packages' models (the same float32
arithmetic summed in another order); 2e-3 for the port's teacher-forced
decode against its own forward, as in
``tests/models/test_decode_consistency.py``.  The CUDA kernels have no CPU
mode; ``tests/test_torch_gpu.py`` holds them to these plain versions on a card.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.launch.serve import Engine as RefEngine
from repro.models import attention as ref_attention
from repro.models import rglru as ref_rglru
from repro.models import ssd as ref_ssd
from repro.models import transformer as ref_transformer

from repro_torch import _tree, compat
from repro_torch.configs import registry
from repro_torch.configs.base import Segment
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.launch import serve
from repro_torch.models import attention, rglru, ssd, transformer

from test_torch_gpu import RGLRU_CASES, SSD_CASES, rglru_operands, ssd_operands

jax.config.update("jax_enable_x64", False)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["mamba2-780m", "recurrentgemma-9b"]
B, S = 2, 40            # S > rg-smoke's window of 16 and > 4 mamba2-smoke chunks of 8
TIGHT = dict(rtol=1e-5, atol=1e-5)

_cache: dict = {}


def reference_model(arch):
    """(cfg, reference params, the port's copy of them on the CPU), once per arch."""
    if arch not in _cache:
        params = ref_transformer.init_lm(jax.random.key(0), ref_registry.get_smoke_config(arch))
        _cache[arch] = (registry.get_smoke_config(arch), params,
                        compat.params_from_reference(jax.device_get(params), "cpu"))
    return _cache[arch]


def tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def block_params(arch, kind):
    """(cfg, reference params of one ``kind`` mixer, the port's copy)."""
    cfg = ref_registry.get_smoke_config(arch)
    init = {"ssd": ref_ssd.init_ssd, "rglru": ref_rglru.init_rglru,
            "local_attn": ref_attention.init_attn}[kind]
    params = init(jax.random.key(3), cfg)
    return registry.get_smoke_config(arch), params, \
        compat.params_from_reference(jax.device_get(params), "cpu")


def activations(cfg, seed=4):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


# -- K5 SSD scan ---------------------------------------------------------------------


@pytest.mark.parametrize("S_,H,P,N,chunk", SSD_CASES)
def test_ssd_scan(S_, H, P, N, chunk):
    arrays = ssd_operands(2, S_, H, P, N)
    want = ref_ops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk)
    oracle, _ = ref_oracles.ssd_scan_ref(*map(jnp.asarray, arrays))
    before = ssd_k.launches
    got = ops.ssd_scan(*map(torch.as_tensor, arrays), chunk=chunk)
    assert ssd_k.launches == before                 # the plain version is not a launch
    assert got.shape == (2, S_, H, P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TIGHT)


@pytest.mark.parametrize("S_,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_slow_decays(S_, H, P, N, chunk):
    """test_ssd_scan with decay logs in [-0.02, -0.001], where every pair
    of a chunk and the carried state count: the port against the Pallas
    kernel and against the recurrence in float64."""
    arrays = ssd_operands(2, S_, H, P, N, lo=0.001, hi=0.02)
    want = ref_ops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk)
    got = ops.ssd_scan(*map(torch.as_tensor, arrays), chunk=chunk)
    exact, _ = ref.ssd_scan_ref(*(torch.as_tensor(a).double() for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rates,far_tiles_count", [((0.01, 0.5), False), ((0.001, 0.02), True)])
def test_slow_decays_make_every_tile_count(rates, far_tiles_count):
    """Why the card checks K5 with slow decays too: with the reference
    test's decay logs, pairs two 64-row tiles or more apart in a chunk of
    256 move y by less than test_ssd_scan's tolerance, so a kernel that
    dropped them would pass; with logs in [-0.02, -0.001] they move most of
    y outside it.  Float64, the recurrence written as one causal product."""
    B, S, H, P, N = 1, 256, 2, 16, 32
    x, dA, Bc, Cc = (torch.as_tensor(a).double()
                     for a in ssd_operands(B, S, H, P, N, lo=rates[0], hi=rates[1]))
    cum = torch.cumsum(dA, 1)
    t = torch.arange(S)
    causal = (t[:, None] >= t[None, :])[None, :, :, None]
    decay = torch.where(causal, torch.exp((cum[:, :, None] - cum[:, None]).clamp(max=0)), 0.0)
    scores = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None] * decay
    y = torch.einsum("btsh,bshp->bthp", scores, x)
    exact, _ = ref.ssd_scan_ref(x, dA, Bc, Cc)
    np.testing.assert_allclose(y.numpy(), exact.numpy(), rtol=1e-9, atol=1e-9)
    far = ((t[:, None] // 64 - t[None, :] // 64) >= 2)[None, :, :, None]
    moved = (torch.einsum("btsh,bshp->bthp", scores * far, x)).abs()
    outside = (moved > 2e-4 + 2e-4 * y.abs()).double().mean()
    assert (outside > 0.25) if far_tiles_count else (outside == 0)


def test_ssd_kernel_matches_model_core():
    """The scan on dt-weighted inputs plus the skip ``x * D`` equals the
    model's chunked SSD core, the port's and the reference's."""
    rng = np.random.default_rng(6)
    Bb, S_, H, P, N = 1, 64, 2, 16, 16
    xh = rng.standard_normal((Bb, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S_, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.2).astype(np.float32)
    Bc, Cc = (rng.standard_normal((Bb, S_, N)).astype(np.float32) for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    want, want_h = ref_ssd.ssd_core_chunked(*map(jnp.asarray, (xh, dt, A, Bc, Cc, D)), chunk=16)
    t = [torch.as_tensor(a) for a in (xh, dt, A, Bc, Cc, D)]
    core, core_h = ssd.ssd_core_chunked(*t, chunk=16)
    np.testing.assert_allclose(core.numpy(), np.asarray(want), **TIGHT)
    np.testing.assert_allclose(core_h.numpy(), np.asarray(want_h), **TIGHT)
    xh_t, dt_t, A_t, Bc_t, Cc_t, D_t = t
    y = ops.ssd_scan(xh_t * dt_t[..., None], dt_t * A_t, Bc_t, Cc_t, chunk=16)
    y = y + xh_t * D_t[None, None, :, None]
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_ssd_scan_contract_errors():
    x, dA, Bc, Cc = map(torch.as_tensor, ssd_operands(1, 16, 2, 8, 8))
    with pytest.raises(ValueError, match="do not match"):
        ops.ssd_scan(x, dA[:, :8], Bc, Cc)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dA, Bc, Cc, chunk=0)


# -- K6 RG-LRU scan -------------------------------------------------------------------


@pytest.mark.parametrize("S_,D", RGLRU_CASES)
def test_rglru_scan(S_, D):
    a, b = rglru_operands(2, S_, D)
    bs, bd = {(64, 32): (16, 32), (100, 48): (32, 16), (128, 8): (128, 8)}[(S_, D)]
    want = ref_ops.rglru_scan(jnp.asarray(a), jnp.asarray(b), bs=bs, bd=bd)
    oracle, _ = ref_oracles.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    before = rg.launches
    got = ops.rglru_scan(torch.as_tensor(a), torch.as_tensor(b), bs=bs, bd=bd)
    assert rg.launches == before
    assert got.shape == (2, S_, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TIGHT)


def test_rglru_kernel_matches_model_scan():
    """Against the reference model's associative scan, to 1e-5."""
    a, b = rglru_operands(1, 64, 16, lo=0.8, hi=0.999, seed=9)

    def comb(x, y):
        a1, b1 = x
        a2, b2 = y
        return a1 * a2, a2 * b1 + b2

    _, want = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    h = ops.rglru_scan(torch.as_tensor(a), torch.as_tensor(b), bs=16, bd=16)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), **TIGHT)


@given(st.integers(min_value=1, max_value=48), st.integers(min_value=1, max_value=24))
@settings(max_examples=10, deadline=None)
def test_rglru_kernel_any_shape(S_, D):
    a, b = rglru_operands(2, S_, D, hi=0.999, seed=S_ * 100 + D)
    h = ops.rglru_scan(torch.as_tensor(a), torch.as_tensor(b), bs=16, bd=16)
    want, _ = ref_oracles.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_rglru_scan_contract_errors():
    a = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="one \\(B,S,D\\) shape"):
        ops.rglru_scan(a, a[:, :2])
    with pytest.raises(ValueError, match="one \\(B,S,D\\) shape"):
        ops.rglru_scan(a[0], a[0])


# -- the mixers ----------------------------------------------------------------------------


def _decode_each(step, cache, x):
    """Step a mixer's decode over every position of x: (B, S, D) outputs."""
    outs = []
    for t in range(x.shape[1]):
        o, cache = step(x[:, t:t + 1], cache, t)
        outs.append(np.asarray(o)[:, 0])
    return np.stack(outs, 1)


def test_ssd_mixer_matches_reference():
    cfg, rp, pp = block_params("mamba2-780m", "ssd")
    x = activations(cfg)
    want = jax.jit(lambda x_: ref_ssd.ssd_forward(rp, x_, cfg))(jnp.asarray(x))
    got = ssd.ssd_forward(pp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    step = jax.jit(lambda x1, c: ref_ssd.ssd_decode_step(rp, x1, c, cfg))
    want_dec = _decode_each(lambda x1, c, t: step(x1, c), ref_ssd.init_ssd_cache(B, cfg),
                            jnp.asarray(x))
    got_dec = _decode_each(lambda x1, c, t: ssd.ssd_decode_step(pp, x1, c, cfg),
                           ssd.init_ssd_cache(B, cfg, device="cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(got_dec, want_dec, **TIGHT)
    np.testing.assert_allclose(got_dec, got.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_mixer_matches_reference(with_h0):
    cfg, rp, pp = block_params("recurrentgemma-9b", "rglru")
    x = activations(cfg)
    h0 = np.random.default_rng(5).standard_normal((B, cfg.rglru.d_rnn)).astype(np.float32) \
        if with_h0 else None
    want = ref_rglru.rglru_forward(rp, jnp.asarray(x), cfg,
                                   h0=None if h0 is None else jnp.asarray(h0))
    got = rglru.rglru_forward(pp, torch.as_tensor(x), cfg,
                              h0=None if h0 is None else torch.as_tensor(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    if with_h0:
        return
    step = jax.jit(lambda x1, c: ref_rglru.rglru_decode_step(rp, x1, c, cfg))
    want_dec = _decode_each(lambda x1, c, t: step(x1, c), ref_rglru.init_rglru_cache(B, cfg),
                            jnp.asarray(x))
    got_dec = _decode_each(lambda x1, c, t: rglru.rglru_decode_step(pp, x1, c, cfg),
                           rglru.init_rglru_cache(B, cfg, device="cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(got_dec, want_dec, **TIGHT)
    np.testing.assert_allclose(got_dec, got.numpy(), rtol=2e-3, atol=2e-3)


def test_windowed_attention_matches_reference():
    """S 40 against a window of 16: the forward masks by the window, and the
    decode's ring of 16 slots wraps twice."""
    cfg, rp, pp = block_params("recurrentgemma-9b", "local_attn")
    w = cfg.attn.window
    x = activations(cfg, seed=7)
    want = jax.jit(lambda x_: ref_attention.attn_forward(rp, x_, cfg, window=w))(jnp.asarray(x))
    got = attention.attn_forward(pp, torch.as_tensor(x), cfg, window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    ref_cache = ref_attention.init_attn_cache(B, S, cfg, window=w)
    cache = attention.init_attn_cache(B, S, cfg, window=w, device="cpu")
    assert tuple(cache["k"].shape) == ref_cache["k"].shape == (B, w, 1, cfg.attn.d_head)
    step = jax.jit(lambda x1, c, t: ref_attention.attn_decode_step(rp, x1, c, t, cfg, window=w))
    want_dec = _decode_each(lambda x1, c, t: step(x1, c, jnp.asarray(t, jnp.int32)),
                            ref_cache, jnp.asarray(x))
    got_dec = _decode_each(
        lambda x1, c, t: attention.attn_decode_step(pp, x1, c, t, cfg, window=w),
        cache, torch.as_tensor(x))
    np.testing.assert_allclose(got_dec, want_dec, **TIGHT)
    np.testing.assert_allclose(got_dec, got.numpy(), rtol=2e-3, atol=2e-3)


# -- the language models ----------------------------------------------------------------


def port_decode(arch, toks):
    """Teacher-forced ``lm_decode_step`` over every position: (B, S, V)."""
    cfg, _, pp = reference_model(arch)
    cache = transformer.init_lm_cache(cfg, B, S, device="cpu")
    out = []
    for t in range(S):
        logits, cache = transformer.lm_decode_step(pp, cache, torch.as_tensor(toks[:, t:t + 1]),
                                                   t, cfg)
        out.append(logits[:, 0])
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference(arch):
    cfg, params, pp = reference_model(arch)
    ref_cfg = ref_registry.get_smoke_config(arch)
    toks = tokens(cfg)
    want, _ = jax.jit(lambda p, b: ref_transformer.lm_forward(p, b, ref_cfg))(
        params, {"tokens": jnp.asarray(toks)})
    got, aux = transformer.lm_forward(pp, {"tokens": torch.as_tensor(toks)}, cfg)
    assert got.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch):
    cfg, params, _ = reference_model(arch)
    ref_cfg = ref_registry.get_smoke_config(arch)
    toks = tokens(cfg, seed=1)
    cache = ref_transformer.init_lm_cache(ref_cfg, B, S)
    step = jax.jit(lambda p, c, t, i: ref_transformer.lm_decode_step(p, c, t, i, ref_cfg))
    want = []
    for t in range(S):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(t, jnp.int32))
        want.append(np.asarray(logits)[:, 0])
    np.testing.assert_allclose(port_decode(arch, toks), np.stack(want, 1), **TIGHT)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_is_consistent_with_its_forward(arch):
    """The reference's invariant, on the port: recurrent states, conv windows
    and the ring-buffer cache reproduce the forward's logits step by step."""
    cfg, _, pp = reference_model(arch)
    toks = tokens(cfg, seed=2)
    fwd, _ = transformer.lm_forward(pp, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(port_decode(arch, toks), fwd.numpy(), rtol=2e-3, atol=2e-3)


def test_params_carry_over_the_recurrent_trees():
    """``compat`` carries every leaf of both families, float32 gates and SSD
    scalars included, and the port's own ``init_lm`` draws the same tree."""
    for arch in ARCHS:
        cfg, params, pp = reference_model(arch)
        ref_leaves = jax.tree.leaves(jax.device_get(params))
        port_leaves = jax.tree.leaves(pp)
        assert len(port_leaves) == len(ref_leaves)
        for r, p in zip(ref_leaves, port_leaves):
            assert tuple(p.shape) == r.shape and str(p.dtype).split(".")[-1] == r.dtype.name
            np.testing.assert_array_equal(p.float().numpy(), np.asarray(r, np.float32))
        own = transformer.init_lm(0, cfg, device="cpu")
        assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
            jax.tree.structure(jax.tree.map(lambda x: 0, pp))
        for a, b in zip(jax.tree.leaves(own), port_leaves):
            assert a.shape == b.shape and a.dtype == b.dtype
    mixer = reference_model("mamba2-780m")[2]["segments"][0][0]["mixer"]
    assert all(mixer[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias", "norm_w"))
    assert "ln2" not in reference_model("mamba2-780m")[2]["segments"][0][0]
    gates = reference_model("recurrentgemma-9b")[2]["segments"][0][0]["mixer"]
    assert gates["w_a"].dtype == gates["w_i"].dtype == torch.float32
    assert gates["w_x"].dtype == torch.bfloat16


def test_unported_kinds_still_raise():
    """Every block kind is ported (the MoE ffn: tests/test_torch_moe.py; mla,
    enc_attn and cross_attn: tests/test_torch_mla.py, test_torch_cross.py),
    and so is attention logit soft-capping: a capped config of every kind
    builds the uncapped one's parameters, and where the kind runs without a
    frontend (mla, which ignores the cap, and ssd) its ``lm_forward`` equals
    the reference's under the cap (the capped cross and encoder models:
    tests/test_torch_softcap.py).  What still raises is the sequence-sharded
    decode.  An unknown kind is a ValueError."""
    cfg = registry.get_smoke_config("mamba2-780m")
    ref_cfg = ref_registry.get_smoke_config("mamba2-780m")
    capped = dataclasses.replace(cfg.attn, logit_softcap=30.0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    for pattern, ffn in ((("mla",), "none"), (("cross_attn",), "mlp"), (("enc_attn",), "mlp"),
                         (("ssd",), "none")):
        ok = cfg.scaled(segments=(Segment(pattern, 1, ffn),))
        plain = transformer.init_lm(0, ok, device="cpu")
        assert transformer.param_count(plain) > 0
        capped_params = transformer.init_lm(0, ok.scaled(attn=capped), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(capped_params),
                                                     _tree.leaves(plain)))
        if pattern[0] in ("mla", "ssd"):
            rc = ref_cfg.scaled(segments=(ref_base.Segment(pattern, 1, ffn),),
                                attn=dataclasses.replace(ref_cfg.attn, logit_softcap=30.0))
            params = ref_transformer.init_lm(jax.random.key(0), rc)
            got, _ = transformer.lm_forward(compat.params_from_reference(
                jax.device_get(params), "cpu"), {"tokens": torch.as_tensor(toks)},
                ok.scaled(attn=capped))
            want, _ = ref_transformer.lm_forward(params, {"tokens": jnp.asarray(toks)}, rc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="sequence-sharded.*ROADMAP"):
        attention._sharded_flash_decode(None, None, None, None, cfg, None)
    with pytest.raises(ValueError, match="kind 'conv'"):
        transformer.init_lm(0, cfg.scaled(segments=(Segment(("conv",), 1, "mlp"),)),
                            device="cpu")


# -- serving ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_the_reference_engine(arch):
    """Six requests over three slots, refilled in waves: the port's Engine
    gives the reference Engine's greedy tokens, token for token."""
    cfg, _, _ = reference_model(arch)
    ref_eng = RefEngine(ref_registry.get_smoke_config(arch), 3, 32)
    # wait for each reference step: its prefill bumps the positions it reads (ROADMAP.md, C1)
    decode_one = ref_eng._decode_one
    ref_eng._decode_one = lambda *a: jax.block_until_ready(decode_one(*a))
    eng = serve.Engine(cfg, 3, 32, device="cpu",
                       params=compat.params_from_reference(jax.device_get(ref_eng.params), "cpu"))
    assert eng.wave and ref_eng.wave
    ref_done, ref_steps = serve.serve_requests(ref_eng, serve.make_requests(6, 5, 6, cfg.vocab))
    done, steps = serve.serve_requests(eng, serve.make_requests(6, 5, 6, cfg.vocab))
    assert steps == ref_steps == 2 * 6              # two waves of six decode steps
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in ref_done]
    assert len(done) == 6 and all(len(r.out) == 6 for r in done)
    assert eng.decode_calls == steps + 2 * 5        # two prefills of five prompt positions


def test_wave_refill_starts_from_a_fresh_state():
    """A request served in the second wave gets the tokens it gets alone."""
    cfg, _, pp = reference_model("mamba2-780m")
    reqs = serve.make_requests(4, 5, 4, cfg.vocab, seed=3)
    done, _ = serve.serve_requests(serve.Engine(cfg, 2, 32, device="cpu", params=pp), reqs)
    alone, _ = serve.serve_requests(serve.Engine(cfg, 2, 32, device="cpu", params=pp),
                                    serve.make_requests(4, 5, 4, cfg.vocab, seed=3)[2:])
    assert [r.out for r in done[2:]] == [r.out for r in alone]


def test_serve_main_runs_a_recurrent_arch_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-780m", "--smoke",
         "--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "3",
         "--prompt-len", "4", "--max-len", "32"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served 3 requests, 9 tokens, 6 decode steps")


@pytest.mark.parametrize("entry", ["Engine", "init_lm_cache", "init_ssd_cache",
                                   "init_rglru_cache", "init_attn_cache"])
def test_recurrent_entry_point_without_device_raises_where_there_is_no_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device resolves")
    mamba, rgemma = (registry.get_smoke_config(a) for a in ARCHS)
    calls = {
        "Engine": lambda: serve.Engine(mamba, 2, 16),
        "init_lm_cache": lambda: transformer.init_lm_cache(rgemma, 1, 8),
        "init_ssd_cache": lambda: ssd.init_ssd_cache(1, mamba),
        "init_rglru_cache": lambda: rglru.init_rglru_cache(1, rgemma),
        "init_attn_cache": lambda: attention.init_attn_cache(1, 8, rgemma,
                                                             window=rgemma.attn.window),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
