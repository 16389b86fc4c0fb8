"""The serving slice of the port against the reference on the CPU: configs,
the dense language model (``lm_forward``, ``lm_decode_step``), the step
factories and the continuous-batching ``Engine``, with the reference's own
``init_lm`` parameters carried over by ``compat.params_from_reference``.

Smoke configs in float32 (their attention and MLP weights are bfloat16, as
in the reference, and meet float32 activations exactly).  Tolerances: 1e-5
between the two packages (the same float32 arithmetic summed in another
order); 2e-3 for the port's teacher-forced decode against its own forward,
as in ``tests/models/test_decode_consistency.py``.
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
from repro.models import transformer as ref_transformer

from repro_torch import compat
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.train.steps import make_prefill_step, make_serve_step

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["tinyllama-1.1b", "qwen2-7b"]
PORTED = ["tinyllama-1.1b", "qwen2-7b", "smollm-360m", "qwen2.5-14b", "mamba2-780m",
          "recurrentgemma-9b", "qwen2-moe-a2.7b"]
B, S = 2, 12

_cache: dict = {}


def reference_model(arch):
    """(cfg, reference params, the port's copy of them on the CPU), once per arch."""
    if arch not in _cache:
        cfg = registry.get_smoke_config(arch)
        params = ref_transformer.init_lm(jax.random.key(0), ref_registry.get_smoke_config(arch))
        _cache[arch] = (cfg, params,
                        compat.params_from_reference(jax.device_get(params), "cpu"))
    return _cache[arch]


def tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def reference_forward(arch, toks):
    cfg, params, _ = reference_model(arch)
    ref_cfg = ref_registry.get_smoke_config(arch)
    logits, _ = jax.jit(lambda p, b: ref_transformer.lm_forward(p, b, ref_cfg))(
        params, {"tokens": jnp.asarray(toks)})
    return np.asarray(logits)


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


# -- configs ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_the_reference(arch):
    assert repr(registry.get_config(arch)) == repr(ref_registry.get_config(arch))
    assert repr(registry.get_smoke_config(arch)) == repr(ref_registry.get_smoke_config(arch))


def test_registry_lists_only_the_ported_archs():
    assert registry.list_archs() == sorted(PORTED)
    for arch in set(ref_registry.list_archs()) - set(PORTED):
        with pytest.raises(KeyError, match="not ported yet"):
            registry.get_config(arch)


# -- the model ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference(arch):
    cfg, _, pp = reference_model(arch)
    toks = tokens(cfg)
    got, aux = transformer.lm_forward(pp, {"tokens": torch.as_tensor(toks)}, cfg)
    want = reference_forward(arch, toks)
    assert got.shape == (B, S, cfg.padded_vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    prefill = make_prefill_step(cfg, device="cpu")(pp, {"tokens": toks})
    np.testing.assert_array_equal(prefill.numpy(), got.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch):
    cfg, params, _ = reference_model(arch)
    ref_cfg = ref_registry.get_smoke_config(arch)
    toks = tokens(cfg, seed=1)
    cache = ref_transformer.init_lm_cache(ref_cfg, B, S)
    step = jax.jit(lambda p, c, t, i: ref_transformer.lm_decode_step(p, c, t, i, ref_cfg))
    want = []
    for t in range(S):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        want.append(np.asarray(logits)[:, 0])
    np.testing.assert_allclose(port_decode(arch, toks), np.stack(want, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_is_consistent_with_its_forward(arch):
    """The reference's own invariant, on the port: teacher-forced decode
    reproduces the forward pass's logits at every position."""
    cfg, _, pp = reference_model(arch)
    toks = tokens(cfg, seed=2)
    fwd, _ = transformer.lm_forward(pp, {"tokens": torch.as_tensor(toks)}, cfg)
    np.testing.assert_allclose(port_decode(arch, toks), fwd.numpy(), rtol=2e-3, atol=2e-3)


def test_per_lane_positions_equal_separate_runs():
    """One decode step with lanes at different positions equals each lane
    stepped alone: the per-lane length hides the rest of the cache."""
    cfg, _, pp = reference_model("tinyllama-1.1b")
    toks = tokens(cfg, seed=3)
    cache = transformer.init_lm_cache(cfg, B, S, device="cpu")
    for t in range(5):
        _, cache = transformer.lm_decode_step(pp, cache, torch.as_tensor(toks[:, t:t + 1]), t, cfg)
    index = torch.tensor([5, 2], dtype=torch.int32)           # lane 1 restarts at position 2
    both, _ = transformer.lm_decode_step(pp, cache, torch.as_tensor(toks[:, 5:6]), index, cfg)
    for lane in range(B):
        alone = {"segments": [[{k: t[:, lane:lane + 1].clone() for k, t in c.items()}
                               for c in seg] for seg in cache["segments"]]}
        one, _ = transformer.lm_decode_step(pp, alone, torch.as_tensor(toks[lane:lane + 1, 5:6]),
                                            int(index[lane]), cfg)
        np.testing.assert_allclose(both[lane:lane + 1].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_params_carry_over_leaf_for_leaf():
    cfg = registry.get_config("tinyllama-1.1b").scaled(
        d_model=64, d_ff=96, vocab=300, dtype="bfloat16",
        segments=(registry.get_config("tinyllama-1.1b").segments[0].__class__(("attn",), 2),))
    params = jax.device_get(ref_transformer.init_lm(jax.random.key(1), cfg))
    pp = compat.params_from_reference(params, "cpu")
    ref_leaves = jax.tree.leaves(params)
    port_leaves = jax.tree.leaves(pp)
    assert len(port_leaves) == len(ref_leaves) == 12
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape and str(p.dtype).split(".")[-1] == r.dtype.name
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(r, np.float32))
    assert transformer.param_count(pp) == ref_transformer.param_count(params)
    own = transformer.init_lm(0, cfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, pp))
    for a, b in zip(jax.tree.leaves(own), port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype


# -- serving -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_the_reference_engine(arch):
    """Six requests over three slots, refilled as lanes finish: the port's
    Engine gives the reference Engine's greedy tokens, token for token."""
    cfg, _, _ = reference_model(arch)
    ref_eng = RefEngine(ref_registry.get_smoke_config(arch), 3, 32)
    # The reference's prefill bumps its numpy ``pos`` in place right after
    # dispatching a step that reads it, and on the CPU ``jnp.asarray`` may
    # share that memory: wait for each step, so that it reads the positions
    # it was given (ROADMAP.md, queue C).
    decode_one = ref_eng._decode_one
    ref_eng._decode_one = lambda *a: jax.block_until_ready(decode_one(*a))
    eng = serve.Engine(cfg, 3, 32, device="cpu",
                       params=compat.params_from_reference(jax.device_get(ref_eng.params), "cpu"))
    ref_done, ref_steps = serve.serve_requests(ref_eng, serve.make_requests(6, 5, 6, cfg.vocab))
    done, steps = serve.serve_requests(eng, serve.make_requests(6, 5, 6, cfg.vocab))
    assert steps == ref_steps and len(done) == 6
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in ref_done]
    assert all(len(r.out) == 6 for r in done)
    assert eng.decode_calls == steps + 2 * 5        # two prefills of five prompt positions


def test_sampled_serve_step_follows_its_generator():
    cfg, _, pp = reference_model("tinyllama-1.1b")
    step = make_serve_step(cfg, temperature=1.0, device="cpu")
    toks = torch.as_tensor(tokens(cfg)[:, :1])
    draws = []
    for _ in range(2):
        cache = transformer.init_lm_cache(cfg, B, S, device="cpu")
        nxt, _ = step(pp, cache, toks, 0, rng=torch.Generator().manual_seed(5))
        draws.append(nxt)
    assert draws[0].shape == (B, 1) and draws[0].dtype == torch.int32
    assert torch.equal(draws[0], draws[1]) and int(draws[0].max()) < cfg.padded_vocab


def test_serve_main_runs_on_the_cpu_when_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-360m", "--smoke",
         "--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "3",
         "--prompt-len", "4", "--max-len", "32"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served 3 requests, 9 tokens")


def _no_cuda_or_skip():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device resolves")


@pytest.mark.parametrize("entry", ["init_lm", "init_lm_cache", "make_prefill_step",
                                   "make_serve_step", "Engine", "params_from_reference"])
def test_entry_point_without_device_raises_where_there_is_no_cuda(entry):
    _no_cuda_or_skip()
    cfg = registry.get_smoke_config("tinyllama-1.1b")
    calls = {
        "init_lm": lambda: transformer.init_lm(0, cfg),
        "init_lm_cache": lambda: transformer.init_lm_cache(cfg, 1, 8),
        "make_prefill_step": lambda: make_prefill_step(cfg),
        "make_serve_step": lambda: make_serve_step(cfg),
        "Engine": lambda: serve.Engine(cfg, 2, 16),
        "params_from_reference": lambda: compat.params_from_reference({"w": np.zeros(2)}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m", "recurrentgemma-9b"])
def test_init_segment_cache_builds_every_leaf_on_the_device_asked_for(arch):
    """Called directly with ``device="cpu"``, every leaf (the block caches
    and the stacked zeros around them) lies on the CPU."""
    cfg = registry.get_smoke_config(arch)
    for seg in cfg.segments:
        caches = transformer.init_segment_cache(seg, B, S, cfg, device="cpu")
        leaves = [t for c in caches for t in c.values()]
        assert leaves and all(t.device.type == "cpu" for t in leaves)
        assert all(t.shape[0] == seg.repeats for t in leaves)
