"""Multi-head latent attention and deepseek-v2-lite in the port against the
reference on the CPU: the MLA layer (``mla_forward``, its absorbed chunked
form, the latent decode step with a position per lane), K3's plain version
with a query/key head dim other than the value's, and deepseek's smoke
config (3 layers of MLA, the first with a dense MLP and two with an MoE of
8 routed experts top-2 and 2 shared; 4 heads of nope 32 + rope 16 against
v 32; float32 activations over bfloat16 weights) through ``lm_forward``,
``lm_decode_step`` and the ``Engine``, with the reference's own ``init_lm``
parameters carried over by ``compat.params_from_reference``.  Inputs are
made with numpy from a seed.

Tolerances: 1e-5 between the two packages (the same float32 arithmetic in
another order); 2e-5 for K3's plain version against the reference's layer
(the reference kernel tests' float32 tolerance); 2e-3 for the port's
teacher-forced decode against its own forward, at capacity factor 64 as
``tests/models/test_decode_consistency.py`` runs it (no capacity drops in
either pass).
"""

import dataclasses
import re
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
from repro.models import mla as ref_mla
from repro.models import transformer as ref_transformer

from repro_torch import compat
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import mla, transformer

ROOT = Path(__file__).resolve().parent.parent
ARCH = "deepseek-v2-lite-16b"
B, S = 2, 12

_cache: dict = {}


def reference_model(cf=None):
    """(port cfg, reference cfg, reference params, the port's copy of them)
    at the smoke config, its capacity factor replaced by ``cf`` if given."""
    if cf not in _cache:
        cfg, ref_cfg = registry.get_smoke_config(ARCH), ref_registry.get_smoke_config(ARCH)
        if cf is not None:
            cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
            ref_cfg = ref_cfg.scaled(moe=dataclasses.replace(ref_cfg.moe, capacity_factor=cf))
        params = ref_transformer.init_lm(jax.random.key(0), ref_cfg)
        _cache[cf] = (cfg, ref_cfg, params,
                      compat.params_from_reference(jax.device_get(params), "cpu"))
    return _cache[cf]


def tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def layer(tree, seg=1, r=0):
    """The MLA mixer of repeat ``r`` of segment ``seg`` (a reference tree of
    jax arrays, or the port's of tensors)."""
    mixer = tree["segments"][seg][0]["mixer"]
    return {k: v[r] for k, v in mixer.items()}


def hidden(cfg, seed, n=S):
    return np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)).astype(np.float32)


# -- the MLA layer ----------------------------------------------------------------------


def test_mla_forward_matches_reference():
    cfg, ref_cfg, params, pp = reference_model()
    x = hidden(cfg, 0)
    got = mla.mla_forward(layer(pp), torch.as_tensor(x), cfg)
    want = jax.jit(lambda p, v: ref_mla.mla_forward(p, v, ref_cfg))(layer(params), jnp.asarray(x))
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_chunk", [4, 5, 1024])
def test_mla_forward_chunked_matches_reference(kv_chunk):
    """The absorbed online-softmax form over latent chunks, a ragged last
    chunk at 5 (12 = 2 x 5 + 2); on the CPU ``mla_forward_chunked`` is it,
    and it equals ``mla_forward``."""
    cfg, ref_cfg, params, pp = reference_model()
    x = hidden(cfg, 1)
    pos = np.random.default_rng(2).permutation(np.arange(S))[None, :].repeat(B, 0)
    got = mla.mla_forward_chunked(layer(pp), torch.as_tensor(x), cfg,
                                  positions=torch.as_tensor(pos), kv_chunk=kv_chunk)
    want = jax.jit(lambda p, v, q: ref_mla.mla_forward_chunked(p, v, ref_cfg, positions=q,
                                                               kv_chunk=kv_chunk))(
        layer(params), jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = mla.mla_forward_chunked_plain(layer(pp), torch.as_tensor(x), cfg,
                                          positions=torch.as_tensor(pos), kv_chunk=kv_chunk)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    eager = mla.mla_forward(layer(pp), torch.as_tensor(x), cfg, positions=torch.as_tensor(pos))
    np.testing.assert_allclose(eager.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_block_forward_takes_the_chunked_form_from_4096_positions():
    """At S >= 4096 the reference's block switches to its chunked form; on
    the CPU the port's does too (the absorbed form over chunks of 1024), and
    the block (norm, MLA, the first layer's dense MLP) matches at 1e-5."""
    cfg, ref_cfg, params, pp = reference_model()
    x = np.random.default_rng(9).normal(size=(1, 4096, cfg.d_model)).astype(np.float32)
    got, _ = transformer.block_forward(transformer._take(pp["segments"][0][0], 0),
                                       torch.as_tensor(x), "mla", "mlp", cfg)
    ref_block = jax.tree.map(lambda t: t[0], params["segments"][0][0])
    want, _ = jax.jit(lambda p, v: ref_transformer.block_forward(p, v, "mla", "mlp", ref_cfg))(
        ref_block, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mla_decode_step_per_lane_matches_reference():
    """Three decode steps over a cache prefilled to different positions per
    lane: outputs and the (c_kv, k_pe) cache at 1e-5, each lane's new latents
    written at its own index."""
    cfg, ref_cfg, params, pp = reference_model()
    L = 16
    rng = np.random.default_rng(3)
    c_kv = rng.normal(size=(B, L, cfg.attn.kv_lora_rank)).astype(np.float32)
    k_pe = rng.normal(size=(B, L, cfg.attn.rope_head_dim)).astype(np.float32)
    cache = {"c_kv": torch.as_tensor(c_kv.copy()), "k_pe": torch.as_tensor(k_pe.copy())}
    ref_cache = {"c_kv": jnp.asarray(c_kv), "k_pe": jnp.asarray(k_pe)}
    step = jax.jit(lambda p, x, c, i: ref_mla.mla_decode_step(p, x, c, i, ref_cfg))
    index = np.array([5, 11], np.int32)
    for t in range(3):
        x1 = hidden(cfg, 10 + t, n=1)
        got, cache = mla.mla_decode_step(layer(pp), torch.as_tensor(x1), cache,
                                         torch.as_tensor(index + t), cfg)
        want, ref_cache = step(layer(params), jnp.asarray(x1), ref_cache, jnp.asarray(index + t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for k in ("c_kv", "k_pe"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(ref_cache[k]),
                                       rtol=1e-5, atol=1e-5)
    untouched = np.ones(L, bool)
    untouched[5:8] = False
    np.testing.assert_array_equal(cache["c_kv"][0].numpy()[untouched], c_kv[0][untouched])


def test_flash_attention_ref_with_a_value_dim_of_its_own_is_the_reference_layer():
    """K3's plain version on MLA's operands (q and k of nope + rope dims, v
    of v dims, the scale of nope + rope) reproduces the reference's
    ``mla_forward`` to 2e-5, with the output of v's head dim."""
    cfg, ref_cfg, params, _ = reference_model()
    a = cfg.attn
    p = jax.device_get(layer(params))
    f = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = hidden(cfg, 4)
    pos = np.arange(S)
    # the reference's own projections, RoPE and norm
    xj = jnp.asarray(x)
    q_nope, q_pe = ref_mla._queries(p, xj, ref_cfg, jnp.asarray(pos)[None].repeat(B, 0))
    c_kv = ref_mla._rms(jnp.einsum("bsd,dr->bsr", xj, p["w_dkv"]), p["kv_norm"])
    from repro.models.common import apply_rope
    k_pe = apply_rope(jnp.einsum("bsd,de->bse", xj, p["w_kpe"]), jnp.asarray(pos)[None],
                      a.rope_theta)
    k_nope = np.einsum("bsr,rhe->bshe", np.asarray(c_kv), f["w_uk"])
    v = np.einsum("bsr,rhe->bshe", np.asarray(c_kv), f["w_uv"])
    q = np.concatenate([np.asarray(q_nope), np.asarray(q_pe)], -1)
    k = np.concatenate([k_nope, np.broadcast_to(np.asarray(k_pe)[:, :, None],
                                                (B, S, a.n_heads, a.rope_head_dim))], -1)
    Dqk = a.nope_head_dim + a.rope_head_dim
    assert q.shape[-1] == k.shape[-1] == Dqk != v.shape[-1] == a.v_head_dim
    o = ref.flash_attention_ref(*(torch.as_tensor(np.ascontiguousarray(t)).transpose(1, 2)
                                  for t in (q, k, v)), causal=True, scale=Dqk ** -0.5)
    assert o.shape == (B, a.n_heads, S, a.v_head_dim)
    got = np.einsum("bhse,hed->bsd", o.numpy(), f["wo"])
    want = jax.jit(lambda p, v: ref_mla.mla_forward(p, v, ref_cfg))(p, xj)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    mha = ops.mha(*(torch.as_tensor(np.ascontiguousarray(t)) for t in (q, k, v)),
                  scale=Dqk ** -0.5)
    np.testing.assert_array_equal(mha.numpy(), o.transpose(1, 2).numpy())


def test_mla_forward_gradients_match_reference_vjp():
    """The MLA layer under grad (``ops.mha`` with q and k of nope + rope dims
    against v of v dims, through ``FlashAttention`` and the plain backward on
    the CPU) against ``jax.vjp`` of the reference's ``mla_forward``: the
    gradients of the hidden input and of every projection, from float32
    copies of the reference's weights, to 2e-5 (the forward's tolerance
    above)."""
    cfg, ref_cfg, params, _ = reference_model()
    p = {k: jnp.asarray(v, jnp.float32) for k, v in jax.device_get(layer(params)).items()}
    x = hidden(cfg, 5)
    do = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda p, x: ref_mla.mla_forward(p, x, ref_cfg), p, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(do))
    tp = {k: torch.tensor(np.asarray(v)).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    got = mla.mla_forward(tp, tx, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=2e-5, atol=2e-5)
    names = sorted(tp)
    grads = torch.autograd.grad(got, [tx] + [tp[k] for k in names], torch.as_tensor(do))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x), rtol=2e-5, atol=2e-5)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[name]), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("D, Dv, dtype, want", [
    (192, 128, torch.bfloat16, (192, 128)),     # MLA at full width: its own instantiation
    (192, 128, torch.float32, (256, 256)),      # float32: both padded to one head dim
    (48, 32, torch.float32, (64, 64)),          # the smoke config's, in float32
    (80, 80, torch.bfloat16, (128, 128)),       # one head dim: padded as before (C4)
])
def test_kernel_dims_of_each_pair(D, Dv, dtype, want):
    assert fa.kernel_dims(D, Dv, dtype) == want


@pytest.mark.parametrize("D, Dv", [(48, 32), (128, 192), (256, 128), (192, 64)])
def test_kernel_dims_refuse_a_bf16_pair_the_kernel_is_not_built_for(D, Dv):
    with pytest.raises(ValueError, match=rf"\(D {D}, Dv {Dv}\)"):
        fa.kernel_dims(D, Dv, torch.bfloat16)


def test_bf16_pairs_are_the_pairs_the_source_instantiates():
    """The kernel's C++ dispatch and ``BF16_PAIRS`` list the same pairs; a
    pair is instantiated without the logit cap only (a capped call raises)."""
    src = (Path(fa.__file__).parent.parent / "csrc" / "flash_attention.cu").read_text()
    inst = re.findall(r"launch_bf16_d<(\d+), (\d+), (CAP|false)>\(q", src)
    built = {(int(d), int(dv)) for d, dv, _ in inst}
    assert {pair for pair in built if pair[0] != pair[1]} == set(fa.BF16_PAIRS)
    assert {d for d, dv in built if d == dv} == set(fa.HEAD_DIMS)
    assert all(cap == "false" for d, dv, cap in inst if d != dv)


def test_flash_attention_keeps_its_shape_checks_with_a_value_dim_of_its_own():
    q = torch.zeros((1, 2, 8, 48))
    v = torch.zeros((1, 2, 8, 32))
    assert fa.flash_attention(q, q, v).shape == (1, 2, 8, 32)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, q[..., :40], v)              # q and k differ in head dim
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, q, v[:, :, :7])              # k and v differ in length


# -- the model ----------------------------------------------------------------------


def test_params_carry_over_with_the_latent_projections():
    cfg, _, params, pp = reference_model()
    ref_leaves = jax.tree.leaves(jax.device_get(params))
    port_leaves = jax.tree.leaves(pp)
    assert len(port_leaves) == len(ref_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape and str(p.dtype).split(".")[-1] == r.dtype.name
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(r, np.float32))
    a = cfg.attn
    m = pp["segments"][1][0]["mixer"]
    assert tuple(m["w_uk"].shape) == (2, a.kv_lora_rank, a.n_heads, a.nope_head_dim)
    assert m["kv_norm"].dtype == torch.float32 and "wq" in m and "w_dq" not in m
    own = transformer.init_lm(0, cfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, pp))
    for x, y in zip(jax.tree.leaves(own), port_leaves):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert transformer.param_count(pp) == ref_transformer.param_count(params)


def test_lm_forward_logits_and_aux_match_reference():
    cfg, ref_cfg, params, pp = reference_model()
    toks = tokens(cfg)
    got, aux = transformer.lm_forward(pp, {"tokens": torch.as_tensor(toks)}, cfg)
    want, want_aux = jax.jit(lambda p, b: ref_transformer.lm_forward(p, b, ref_cfg))(
        params, {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, S, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)


def port_decode(cfg, pp, toks):
    cache = transformer.init_lm_cache(cfg, B, S, device="cpu")
    out = []
    for t in range(S):
        logits, cache = transformer.lm_decode_step(pp, cache, torch.as_tensor(toks[:, t:t + 1]),
                                                   t, cfg)
        out.append(logits[:, 0])
    return torch.stack(out, 1).numpy()


def test_teacher_forced_decode_matches_reference():
    cfg, ref_cfg, params, pp = reference_model()
    toks = tokens(cfg, seed=1)
    cache = ref_transformer.init_lm_cache(ref_cfg, B, S)
    step = jax.jit(lambda p, c, t, i: ref_transformer.lm_decode_step(p, c, t, i, ref_cfg))
    want = []
    for t in range(S):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        want.append(np.asarray(logits)[:, 0])
    np.testing.assert_allclose(port_decode(cfg, pp, toks), np.stack(want, 1), rtol=1e-5, atol=1e-5)


def test_port_decode_is_consistent_with_its_forward():
    """The reference's invariant at capacity factor 64 (no drops either way):
    the latent decode reproduces the decompressed forward."""
    cfg, _, _, pp = reference_model(cf=64.0)
    toks = tokens(cfg, seed=2)
    fwd, _ = transformer.lm_forward(pp, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(port_decode(cfg, pp, toks), fwd.numpy(), rtol=2e-3, atol=2e-3)


# -- serving ------------------------------------------------------------------------


def test_engine_greedy_tokens_equal_the_reference_engine():
    """Six requests over three slots, refilled as lanes finish: token for token."""
    cfg, ref_cfg, _, _ = reference_model()
    ref_eng = RefEngine(ref_cfg, 3, 32)
    # wait for each reference step (ROADMAP.md queue C, C1)
    decode_one = ref_eng._decode_one
    ref_eng._decode_one = lambda *a: jax.block_until_ready(decode_one(*a))
    eng = serve.Engine(cfg, 3, 32, device="cpu",
                       params=compat.params_from_reference(jax.device_get(ref_eng.params), "cpu"))
    assert not eng.wave
    assert set(eng.cache["segments"][0][0]) == {"c_kv", "k_pe"}
    ref_done, ref_steps = serve.serve_requests(ref_eng, serve.make_requests(6, 5, 6, cfg.vocab))
    done, steps = serve.serve_requests(eng, serve.make_requests(6, 5, 6, cfg.vocab))
    assert steps == ref_steps and len(done) == 6
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in ref_done]


def test_serve_main_serves_deepseek_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "3"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served 3 requests, 9 tokens")
