"""Cross-attention, the encoder stack and the modality-frontend stub in the
port against the reference on the CPU: seamless-m4t's smoke config (an
encoder of 2 bidirectional layers over 16 audio frames of 64, a decoder of 2
(attn, cross_attn) layers whose only ffn follows the cross block; 4/4 heads
of 16) and llama-3.2-vision's (two (attn, attn, cross_attn) groups over 16
patches of 48 projected to 128; 4/2 heads of 32), float32 activations over
bfloat16 weights, with the reference's own ``init_lm`` parameters carried
over by ``compat.params_from_reference``.

A fresh model's cross blocks are gated shut: ``gate_attn`` and
``gate_ffn`` start at 0 and tanh(0) = 0 hides cross-attention and the
cross block's ffn.  Every test of the cross path therefore sets both gates
of every cross layer to non-zero values drawn from a seed, on both sides,
and feeds seeded, non-zero ``frontend_embeds``.  Inputs are made with numpy.

Tolerances: 1e-5 between the two packages (the same float32 arithmetic in
another order); 2e-3 for the port's teacher-forced decode against its own
forward (``tests/models/test_decode_consistency.py``'s); 2e-2 of the largest
magnitude between the two in bfloat16, where the port's memory is bfloat16
and the reference's float32.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch.serve import Engine as RefEngine
from repro.models import attention as ref_attention
from repro.models import transformer as ref_transformer

from repro_torch import compat
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import attention, transformer

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["seamless-m4t-medium", "llama-3.2-vision-90b"]
B, S = 2, 12

_cache: dict = {}


def with_gates(tree, seed):
    """The reference tree (numpy leaves) with every cross layer's two gates
    drawn from ``seed``, in [0.3, 1.2) with a random sign."""
    rng = np.random.default_rng(seed)
    for seg in tree["segments"]:
        for block in seg:
            mixer = block["mixer"]
            for name in ("gate_attn", "gate_ffn"):
                if name in mixer:
                    g = mixer[name]
                    mixer[name] = (rng.uniform(0.3, 1.2, g.shape)
                                   * rng.choice([-1.0, 1.0], g.shape)).astype(g.dtype)
    return tree


def reference_model(arch):
    """(port cfg, reference cfg, reference params with open gates, the port's
    copy of them), once per arch."""
    if arch not in _cache:
        cfg, ref_cfg = registry.get_smoke_config(arch), ref_registry.get_smoke_config(arch)
        params = with_gates(jax.device_get(ref_transformer.init_lm(jax.random.key(0), ref_cfg)),
                            seed=5)
        _cache[arch] = (cfg, ref_cfg, params, compat.params_from_reference(params, "cpu"))
    return _cache[arch]


def tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def embeds(cfg, seed=0, batch=B):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def cross_layer(tree, arch):
    """Repeat 0 of the arch's cross_attn block (its mixer's parameters)."""
    pos = ref_registry.get_smoke_config(arch).segments[0].pattern.index("cross_attn")
    return {k: v[0] for k, v in tree["segments"][0][pos]["mixer"].items()}


# -- cross-attention ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attn_forward_matches_reference(arch):
    """``attn_forward(kv=memory)``: queries from x (no RoPE), keys and values
    from a memory of another length, every query seeing the whole memory."""
    cfg, ref_cfg, params, pp = reference_model(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, cfg.frontend_tokens + 3, cfg.d_model)).astype(np.float32)
    got = attention.attn_forward(cross_layer(pp, arch), torch.as_tensor(x), cfg,
                                 kv=torch.as_tensor(mem))
    want = jax.jit(lambda p, a, m: ref_attention.attn_forward(p, a, ref_cfg, kv=m))(
        cross_layer(params, arch), jnp.asarray(x), jnp.asarray(mem))
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attn_kv_and_decode_match_reference(arch):
    cfg, ref_cfg, params, pp = reference_model(arch)
    rng = np.random.default_rng(2)
    mem = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    k, v = attention.cross_attn_kv(cross_layer(pp, arch), torch.as_tensor(mem), cfg)
    rk, rv = ref_attention.cross_attn_kv(cross_layer(params, arch), jnp.asarray(mem), ref_cfg)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-5)
    got = attention.cross_attn_decode(cross_layer(pp, arch), torch.as_tensor(x1), k, v, cfg)
    want = jax.jit(lambda p, a, kk, vv: ref_attention.cross_attn_decode(p, a, kk, vv, ref_cfg))(
        cross_layer(params, arch), jnp.asarray(x1), rk, rv)
    assert got.shape == (B, 1, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_decode_cache_fills_the_cross_caches_as_the_reference(arch):
    cfg, ref_cfg, params, pp = reference_model(arch)
    fe = embeds(cfg, seed=3)
    cache = transformer.init_lm_cache(cfg, B, S, device="cpu")
    cache = transformer.lm_prepare_decode_cache(pp, cache, {"frontend_embeds": torch.as_tensor(fe)},
                                                cfg)
    ref_cache = jax.jit(lambda p, c, b: ref_transformer.lm_prepare_decode_cache(p, c, b, ref_cfg))(
        params, ref_transformer.init_lm_cache(ref_cfg, B, S), {"frontend_embeds": jnp.asarray(fe)})
    n_cross = 0
    for seg, ref_seg, s in zip(cache["segments"], ref_cache["segments"], cfg.segments):
        for c, rc, kind in zip(seg, ref_seg, s.pattern):
            assert set(c) == set(rc)
            for name in c:
                want = np.asarray(rc[name])
                assert tuple(c[name].shape) == want.shape
                np.testing.assert_allclose(c[name].numpy(), want, rtol=1e-5, atol=1e-5)
            if kind == "cross_attn":
                n_cross += 1
                assert float(c["k"].abs().max()) > 0
    assert n_cross == 1
    memory = transformer.lm_prefill_memory(pp, {"frontend_embeds": torch.as_tensor(fe)}, cfg)
    want = ref_transformer.lm_prefill_memory(params, {"frontend_embeds": jnp.asarray(fe)}, ref_cfg)
    assert tuple(memory.shape) == (B, cfg.frontend_tokens, cfg.d_model)
    np.testing.assert_allclose(memory.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the models ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_with_encoder_gates_and_frontend_projection(arch):
    cfg, _, params, pp = reference_model(arch)
    ref_leaves = jax.tree.leaves(params)
    port_leaves = jax.tree.leaves(pp)
    assert len(port_leaves) == len(ref_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape and str(p.dtype).split(".")[-1] == r.dtype.name
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(r, np.float32))
    assert ("encoder" in pp) == bool(cfg.encoder_segments)
    assert ("frontend_proj" in pp) == (cfg.frontend_dim != cfg.d_model)
    mixer = cross_layer(pp, arch)
    assert mixer["gate_attn"].dtype == torch.float32 and mixer["gate_attn"].shape == ()
    own = transformer.init_lm(0, cfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, pp))
    for x, y in zip(jax.tree.leaves(own), port_leaves):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert float(cross_layer(own, arch)["gate_ffn"]) == 0.0      # the reference's zero init
    assert transformer.param_count(pp) == ref_transformer.param_count(params)


def test_a_zero_dim_leaf_carries_over():
    """A 0-d array (an unstacked gate) becomes a 0-d tensor of its dtype."""
    tree = {"gate": np.float32(0.75), "g": jnp.zeros((), jnp.bfloat16)}
    got = compat.params_from_reference(jax.device_get(tree), "cpu")
    assert got["gate"].shape == () and got["gate"].dtype == torch.float32
    assert float(got["gate"]) == 0.75 and got["g"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference(arch):
    cfg, ref_cfg, params, pp = reference_model(arch)
    toks, fe = tokens(cfg), embeds(cfg, seed=4)
    got, aux = transformer.lm_forward(
        pp, {"tokens": torch.as_tensor(toks), "frontend_embeds": torch.as_tensor(fe)}, cfg)
    want, _ = jax.jit(lambda p, b: ref_transformer.lm_forward(p, b, ref_cfg))(
        params, {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)})
    assert got.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the memory moves the logits: other embeds give other logits
    other, _ = transformer.lm_forward(
        pp, {"tokens": torch.as_tensor(toks), "frontend_embeds": torch.as_tensor(fe[::-1].copy())},
        cfg)
    assert float((other - got).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_memory_and_logits_stay_near_the_reference(arch):
    """In bfloat16, as the card serves them, the port computes the memory in
    bfloat16 (K3 takes one dtype for q, k and v) where the reference promotes
    the float32 embeddings to a float32 memory.  The divergence this makes
    is measured here: the memory and the logits within 2e-2 of their largest
    magnitude (about 0.3-0.9 % at this size and seed)."""
    cfg = registry.get_smoke_config(arch).scaled(dtype="bfloat16")
    ref_cfg = ref_registry.get_smoke_config(arch).scaled(dtype="bfloat16")
    params = with_gates(jax.device_get(ref_transformer.init_lm(jax.random.key(0), ref_cfg)),
                        seed=5)
    pp = compat.params_from_reference(params, "cpu")
    toks, fe = tokens(cfg, seed=1), embeds(cfg, seed=7)
    batch = {"tokens": torch.as_tensor(toks), "frontend_embeds": torch.as_tensor(fe)}
    ref_batch = {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)}
    mem = transformer._memory_states(pp, batch, cfg)
    ref_mem = jax.jit(lambda p, b: ref_transformer._memory_states(p, b, ref_cfg))(
        params, ref_batch)
    assert mem.dtype == torch.bfloat16 and ref_mem.dtype == jnp.float32
    got, _ = transformer.lm_forward(pp, batch, cfg)
    want, _ = jax.jit(lambda p, b: ref_transformer.lm_forward(p, b, ref_cfg))(params, ref_batch)
    for g, w in ((mem, ref_mem), (got, want)):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=2e-2 * np.abs(w).max())


def port_decode(cfg, pp, toks, fe):
    cache = transformer.init_lm_cache(cfg, B, S, device="cpu")
    cache = transformer.lm_prepare_decode_cache(pp, cache, {"frontend_embeds": torch.as_tensor(fe)},
                                                cfg)
    out = []
    for t in range(S):
        logits, cache = transformer.lm_decode_step(pp, cache, torch.as_tensor(toks[:, t:t + 1]),
                                                   t, cfg)
        out.append(logits[:, 0])
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch):
    cfg, ref_cfg, params, pp = reference_model(arch)
    toks, fe = tokens(cfg, seed=1), embeds(cfg, seed=6)
    cache = jax.jit(lambda p, c, b: ref_transformer.lm_prepare_decode_cache(p, c, b, ref_cfg))(
        params, ref_transformer.init_lm_cache(ref_cfg, B, S), {"frontend_embeds": jnp.asarray(fe)})
    step = jax.jit(lambda p, c, t, i: ref_transformer.lm_decode_step(p, c, t, i, ref_cfg))
    want = []
    for t in range(S):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        want.append(np.asarray(logits)[:, 0])
    np.testing.assert_allclose(port_decode(cfg, pp, toks, fe), np.stack(want, 1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_is_consistent_with_its_forward(arch):
    """The reference's invariant with a memory: teacher-forced decode steps
    against the cross caches reproduce the forward over the same tokens."""
    cfg, _, _, pp = reference_model(arch)
    toks, fe = tokens(cfg, seed=2), embeds(cfg, seed=7)
    fwd, _ = transformer.lm_forward(
        pp, {"tokens": torch.as_tensor(toks), "frontend_embeds": torch.as_tensor(fe)}, cfg)
    np.testing.assert_allclose(port_decode(cfg, pp, toks, fe), fwd.numpy(), rtol=2e-3, atol=2e-3)


def test_encoder_decoder_needs_its_inputs():
    cfg, _, _, pp = reference_model("seamless-m4t-medium")
    with pytest.raises(ValueError, match="frontend_embeds"):
        transformer.lm_forward(pp, {"tokens": torch.as_tensor(tokens(cfg))}, cfg)


# -- serving ------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_the_reference_engine(arch):
    """Six requests over three slots, refilled as lanes finish, token for
    token.  Both engines fill their cross caches from zero embeddings, as
    the reference's demo engine does; each is then given caches filled from
    the same seeded embeddings, and the same open gates."""
    cfg, ref_cfg, params, pp = reference_model(arch)
    ref_eng = RefEngine(ref_cfg, 3, 32)
    decode_one = ref_eng._decode_one                 # wait for each step (ROADMAP.md C1)
    ref_eng._decode_one = lambda *a: jax.block_until_ready(decode_one(*a))
    eng = serve.Engine(cfg, 3, 32, device="cpu", params=pp)
    assert not eng.wave
    pos = cfg.segments[0].pattern.index("cross_attn")
    assert float(eng.cache["segments"][0][pos]["k"].abs().max()) == 0.0    # zero memory
    fe = embeds(cfg, seed=8, batch=3)
    ref_eng.params = params
    ref_eng.cache = ref_transformer.lm_prepare_decode_cache(
        params, ref_eng.cache, {"frontend_embeds": jnp.asarray(fe)}, ref_cfg)
    eng.cache = transformer.lm_prepare_decode_cache(
        pp, eng.cache, {"frontend_embeds": torch.as_tensor(fe)}, cfg)
    ref_done, ref_steps = serve.serve_requests(ref_eng, serve.make_requests(6, 5, 6, cfg.vocab))
    done, steps = serve.serve_requests(eng, serve.make_requests(6, 5, 6, cfg.vocab))
    assert steps == ref_steps and len(done) == 6
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in ref_done]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_the_cross_archs_on_the_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "3"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served 3 requests, 9 tokens")
