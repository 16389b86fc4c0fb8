"""The MoE family of the port against the reference on the CPU: qwen2-moe's
smoke config (2 layers, 6 routed experts top-2, 2 shared experts in one
gated MLP of 128, float32 activations over bfloat16 expert weights and a
float32 router), with the reference's own ``init_lm`` parameters carried
over by ``compat.params_from_reference``.

Tolerances: 1e-5 between the two packages (the same float32 arithmetic in
another order); 2e-3 for the port's teacher-forced decode against its own
forward, with the capacity factor raised to 64 as
``tests/models/test_decode_consistency.py`` raises it (capacity drops
depend on the queue: the whole sequence in a forward, one token a step in
a decode).  The routing is checked free of ties at the top-k boundary, where
``jax.lax.top_k`` and ``torch.topk`` may order equal values differently.
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

from repro.configs import registry as ref_registry
from repro.launch.serve import Engine as RefEngine
from repro.models import mlp as ref_mlp
from repro.models import transformer as ref_transformer

from repro_torch import compat
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import mlp, transformer

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen2-moe-a2.7b"
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


def first_layer_ffn(tree):
    return jax.tree.map(lambda a: a[0], tree["segments"][0][0]["ffn"])


def assert_no_top_k_tie(probs, k):
    top = np.sort(probs, axis=-1)[:, ::-1]
    assert np.all(top[:, k - 1] > top[:, k]), "a tie at the top-k boundary"


# -- the MoE layer ------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 4, 37])
def test_moe_forward_local_matches_reference(T):
    """Output and aux loss at 1e-5, one sequence of T tokens; at T=37 the
    capacity (16 slots an expert) drops token-slots."""
    cfg, ref_cfg, params, pp = reference_model()
    m = cfg.moe
    rp = first_layer_ffn(params)
    pl = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in pp["segments"][0][0]["ffn"].items()}
    # tokens that share a direction, so that routing is skewed and T=37 overflows
    rng = np.random.default_rng(T)
    x = (rng.normal(size=(1, T, cfg.d_model)) + 3 * rng.normal(size=cfg.d_model)).astype(np.float32)

    probs = torch.softmax(torch.as_tensor(x[0]) @ pl["router"], -1).numpy()
    assert_no_top_k_tie(probs, m.top_k)
    cap = max(1, int(-(-T * m.top_k * m.capacity_factor // m.n_routed)))
    load = np.bincount(np.argsort(-probs, -1)[:, :m.top_k].ravel(), minlength=m.n_routed)
    if T == 37:
        assert load.max() > cap, (load, cap)

    got, aux = mlp.moe_forward_local(pl, torch.as_tensor(x), cfg)
    want, want_aux = jax.jit(lambda p, v: ref_mlp.moe_forward_local(p, v, ref_cfg))(
        rp, jnp.asarray(x))
    assert got.shape == (1, T, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    assert float(aux) > 0
    again, _ = mlp.moe_forward(pl, torch.as_tensor(x), cfg)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_moe_params_carry_over_with_the_router_in_float32():
    cfg, _, params, pp = reference_model()
    ref_leaves = jax.tree.leaves(jax.device_get(params))
    port_leaves = jax.tree.leaves(pp)
    assert len(port_leaves) == len(ref_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape and str(p.dtype).split(".")[-1] == r.dtype.name
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(r, np.float32))
    ffn = pp["segments"][0][0]["ffn"]
    assert ffn["router"].dtype == torch.float32 and ffn["w_gate"].dtype == torch.bfloat16
    E, D, F = cfg.moe.n_routed, cfg.d_model, cfg.moe.d_ff_expert
    assert tuple(ffn["w_gate"].shape) == (2, E, D, F) and tuple(ffn["w_down"].shape) == (2, E, F, D)
    assert tuple(ffn["shared"]["w_up"].shape) == (2, D, cfg.moe.d_ff_shared)
    own = transformer.init_lm(0, cfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, pp))
    for a, b in zip(jax.tree.leaves(own), port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert transformer.param_count(pp) == ref_transformer.param_count(params)


# -- the model ----------------------------------------------------------------------


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
    """The reference's invariant at capacity factor 64 (no drops either way)."""
    cfg, _, _, pp = reference_model(cf=64.0)
    toks = tokens(cfg, seed=2)
    fwd, _ = transformer.lm_forward(pp, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(port_decode(cfg, pp, toks), fwd.numpy(), rtol=2e-3, atol=2e-3)


# -- serving ------------------------------------------------------------------------


def test_engine_greedy_tokens_equal_the_reference_engine():
    """Six requests over three slots, refilled as lanes finish (capacity 1
    an expert at decode, so lanes compete for experts, as in the reference):
    token for token."""
    cfg, ref_cfg, _, _ = reference_model()
    ref_eng = RefEngine(ref_cfg, 3, 32)
    # wait for each reference step (ROADMAP.md queue C, C1)
    decode_one = ref_eng._decode_one
    ref_eng._decode_one = lambda *a: jax.block_until_ready(decode_one(*a))
    eng = serve.Engine(cfg, 3, 32, device="cpu",
                       params=compat.params_from_reference(jax.device_get(ref_eng.params), "cpu"))
    assert not eng.wave
    ref_done, ref_steps = serve.serve_requests(ref_eng, serve.make_requests(6, 5, 6, cfg.vocab))
    done, steps = serve.serve_requests(eng, serve.make_requests(6, 5, 6, cfg.vocab))
    assert steps == ref_steps and len(done) == 6
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in ref_done]


def test_serve_main_serves_the_moe_arch_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "3"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served 3 requests, 9 tokens")
