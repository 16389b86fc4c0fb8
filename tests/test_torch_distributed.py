"""Multi-rank twins of ``tests/parallel/test_distributed.py``: the
expert-parallel MoE (both routes), the int8-compressed cross-pod gradient
all-reduce, the sequence-sharded decode (a rank with no valid key for some
lanes, and a capped case), the int8 train step and the sharded restore, each
on the mesh ``("pod", "data", "model") = (2, 2, 2)``; and the DTensor
regions of the dry-run on values, against plain torch.

One world of 8 gloo ranks on the CPU (``tests/torch_dist_worker.py``, one
process a rank over a ``FileStore`` in a temporary directory) runs every
case; the ranks import neither jax nor the reference package.  This process
computes the reference's results on one JAX device and hands the inputs over
as ``.npz`` files and a checkpoint in the reference's format; the ranks'
results come back the same way.  The world has 300 s: a hang fails the
tests rather than stalling the run.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import store as ref_store
from repro.configs.base import MoECfg as RefMoECfg
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import attention as ref_attention
from repro.models import mlp as ref_mlp
from repro.models import transformer as ref_transformer
from repro.parallel.compression import quantize_int8 as ref_quantize
from repro.parallel.rules import rules_for as ref_rules_for
from repro.train import steps as ref_steps

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
WORLD = 8
SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
WORLD_SECONDS = 300
MOE_CASES = {"experts": ("deepseek-v2-lite-16b", 8), "ff": ("qwen2-moe-a2.7b", 3)}
DECODE_CAP = 1.0          # the worker's cap; the capped case's query weights are 16x
DECODE_IDX = [5, 31, 0, 17]   # over two shards of 16: lanes 0 and 2 see nothing on shard 1


class _Shape:
    """A stand-in for a JAX mesh: the rules read only these two."""
    axis_names = AXES
    shape = dict(zip(AXES, SHAPE))


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _flat(tree) -> dict:
    """``{checkpoint key: numpy}`` of a jax tree."""
    return {k: np.asarray(v) for k, v in ref_store._flatten(jax.device_get(tree)).items()}


def _spec_paths(tree, prefix=""):
    """``{key: spec tuple}`` of a spec tree, keyed as the checkpoint is."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, list):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, t in items:
        out.update(_spec_paths(t, f"{prefix}/{k}" if prefix else k))
    return out


def _coords():
    """Rank -> {axis: index}: the mesh is ranks 0..7 in row-major order."""
    return [dict(zip(AXES, np.unravel_index(r, SHAPE))) for r in range(WORLD)]


def _expected_slice(x: np.ndarray, spec, coord: dict) -> np.ndarray:
    """The slice of ``x`` a rank at ``coord`` holds under ``spec`` (JAX's
    layout: a dim's axes major to minor)."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        n, i = 1, 0
        for a in axes:
            n, i = n * _Shape.shape[a], i * _Shape.shape[a] + int(coord[a])
        w = x.shape[dim] // n
        x = np.take(x, np.arange(i * w, (i + 1) * w), axis=dim)
    return x


def _moe_reference(name):
    arch, n_routed = MOE_CASES[name]
    cfg = ref_smoke(arch).scaled(moe=RefMoECfg(n_routed=n_routed, n_shared=2, top_k=2,
                                               d_ff_expert=64, d_ff_shared=128,
                                               capacity_factor=8.0))
    p = _f32(ref_mlp.init_moe(jax.random.key(0), cfg))
    x = jax.random.normal(jax.random.key(1), (8, 4, cfg.d_model), jnp.float32)
    y, aux = ref_mlp.moe_forward_local(p, x, cfg)

    def loss(p, x):
        y, aux = ref_mlp.moe_forward_local(p, x, cfg)
        return (y.astype(jnp.float32) ** 2).mean() + aux

    def loss_ep(p, x):
        # the EP path's own objective: its aux is the mean of the four dp
        # shards' statistics (two sequences each), a different estimator
        y, _ = ref_mlp.moe_forward_local(p, x, cfg)
        aux = sum(ref_mlp.moe_forward_local(p, x[2 * i:2 * i + 2], cfg)[1] for i in range(4))
        return (y.astype(jnp.float32) ** 2).mean() + aux / 4

    return {"p": _flat(p), "x": np.asarray(x), "y": np.asarray(y), "aux": float(aux),
            "grad": _flat(jax.grad(loss)(p, x)), "grad_ep": _flat(jax.grad(loss_ep)(p, x))}


def _compress_reference():
    w = jax.random.normal(jax.random.key(0), (64, 64)) * 0.1
    x = jax.random.normal(jax.random.key(1), (16, 64))

    def loss(w, xb):
        return ((xb @ w) ** 2).mean()

    g_ref = (jax.grad(loss)(w, x[:8]) + jax.grad(loss)(w, x[8:])) / 2
    return {"w": np.asarray(w), "x": np.asarray(x), "g": np.asarray(g_ref),
            "loss": float(loss(w, x))}


def _decode_reference(capped: bool):
    cfg = ref_smoke("tinyllama-1.1b")
    p = _f32(ref_attention.init_attn(jax.random.key(0), cfg))
    if capped:
        cfg = cfg.scaled(attn=dataclasses.replace(cfg.attn, logit_softcap=DECODE_CAP))
        p = dict(p, wq=p["wq"] * 16)
    B, L = 4, 32
    shape = ref_attention.init_attn_cache(B, L, cfg)["k"].shape
    ks = jax.random.split(jax.random.key(1), 3)
    cache = {"k": jax.random.normal(ks[0], shape, jnp.float32),
             "v": jax.random.normal(ks[1], shape, jnp.float32)}
    x1 = jax.random.normal(ks[2], (B, 1, cfg.d_model), jnp.float32)
    idx = jnp.array(DECODE_IDX, jnp.int32)
    out, new = ref_attention.attn_decode_step(p, x1, cache, idx, cfg)
    return {"p": _flat(p), "k": np.asarray(cache["k"]), "v": np.asarray(cache["v"]),
            "x1": np.asarray(x1), "idx": np.asarray(idx), "out": np.asarray(out),
            "new_k": np.asarray(new["k"]), "new_v": np.asarray(new["v"])}


def _train_reference(directory: Path):
    cfg = ref_smoke("tinyllama-1.1b")
    state = _f32(ref_steps.init_train_state(jax.random.key(0), cfg))
    ref_store.save(directory / "ckpt", 0, state)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(1, cfg.vocab, (8, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    (loss, _), g = jax.value_and_grad(ref_steps.make_loss_fn(cfg), has_aux=True)(
        state["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    rules = ref_rules_for(cfg, _Shape(), "train", batch=8)
    specs = {k: rules.resolve(s) for k, s in _spec_paths(ref_transformer.specs_lm(cfg)).items()}
    return {"batch": batch, "loss": float(loss), "grad": _flat(g),
            "params": _flat(state["params"]), "specs": specs}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's results, and each rank's ``rank<r>.npz``."""
    d = tmp_path_factory.mktemp("gloo_world")
    ref = {f"moe_{n}": _moe_reference(n) for n in MOE_CASES}
    ref["compress"] = _compress_reference()
    ref["decode"] = _decode_reference(capped=False)
    ref["decode_capped"] = _decode_reference(capped=True)
    ref["train"] = _train_reference(d)
    inputs = {}
    for n in MOE_CASES:
        inputs[f"moe_{n}/x"] = ref[f"moe_{n}"]["x"]
        inputs.update({f"moe_{n}/p/{k}": v for k, v in ref[f"moe_{n}"]["p"].items()})
    inputs.update({f"compress/{k}": ref["compress"][k] for k in ("w", "x")})
    for tag in ("decode", "decode_capped"):
        inputs.update({f"{tag}/{k}": ref[tag][k] for k in ("k", "v", "x1", "idx")})
        inputs.update({f"{tag}/p/{k}": v for k, v in ref[tag]["p"].items()})
    inputs.update({f"train/{k}": v for k, v in ref["train"]["batch"].items()})
    np.savez(d / "inputs.npz", **inputs)

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(d)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_SECONDS)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {WORLD}-rank world did not finish within {WORLD_SECONDS} s")
    failed = [(r, p.returncode, log[-4000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode]
    assert not failed, failed[0]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    for r, out in enumerate(ranks):
        assert list(out["coord"]) == [_coords()[r][a] for a in AXES]
    return ref, ranks


def _rank_at(ranks, **coord):
    return next(out for r, out in enumerate(ranks)
                if all(_coords()[r][a] == i for a, i in coord.items()))


def test_ranks_import_neither_jax_nor_the_reference(world):
    _, ranks = world
    assert all(bool(out["imports_clean"]) for out in ranks)


def _check_moe(world, name):
    ref, ranks = world
    want = ref[f"moe_{name}"]
    for key in ("y", "y_ep"):
        got = np.zeros_like(want["y"])
        for r, out in enumerate(ranks):
            c = _coords()[r]
            i = c["pod"] * 2 + c["data"]
            got[2 * i:2 * i + 2] = out[f"moe_{name}/{key}"]   # each model rank's the same
            np.testing.assert_array_equal(out[f"moe_{name}/{key}"],
                                          _rank_at(ranks, pod=c["pod"], data=c["data"],
                                                   model=0)[f"moe_{name}/{key}"])
        np.testing.assert_allclose(got, want["y"], rtol=2e-4, atol=2e-4, err_msg=key)
    # aux under EP is the mean of per-dp-shard load-balance stats: the same
    # scale as the global statistic, not equal to it
    for out in ranks:
        assert 0.5 * want["aux"] < float(out[f"moe_{name}/aux"]) < 2.0 * want["aux"]
    for key, g_ref in want["grad"].items():
        # whole parameters: every rank's gradient, summed
        whole = sum(out[f"moe_{name}/grad_whole/{key}"] for out in ranks)
        # the shards: summed over the ranks that hold the same one
        sharded = np.zeros_like(g_ref)
        for out in ranks:
            g = out[f"moe_{name}/grad_shard/{key}"]
            idx = tuple(slice(o, o + n) for o, n in zip(out[f"moe_{name}/offset/{key}"],
                                                         g.shape))
            sharded[idx] += g
        g_ep = want["grad_ep"][key]
        for got in (whole, sharded):
            # the reference test's tolerance against the local path's
            # gradients; these lie far below its atol, so also the same rtol
            # against the leaf's scale, of the gradients of the EP path's own
            # loss (its aux differs, and with it the router's gradient)
            np.testing.assert_allclose(got, g_ref, rtol=2e-3, atol=2e-4, err_msg=key)
            np.testing.assert_allclose(got, g_ep, rtol=2e-3,
                                       atol=2e-3 * np.abs(g_ep).max(), err_msg=key)


def test_moe_ep_expert_sharded_matches_local(world):
    """E=8 divides model=2: expert-partitioned path.  Drop-free capacity so
    global and per-shard dispatch keep identical token sets."""
    _check_moe(world, "experts")
    ranks = world[1]
    # each model rank holds half the experts
    assert ranks[0]["moe_experts/grad_shard/w_gate"].shape[0] == 4


def test_moe_ep_ff_sharded_matches_local(world):
    """E=3 does not divide model=2: TP-inside-expert path."""
    _check_moe(world, "ff")
    ranks = world[1]
    assert ranks[0]["moe_ff/grad_shard/w_gate"].shape[0] == 3
    assert ranks[0]["moe_ff/grad_shard/w_gate"].shape[2] == 32


def test_compressed_pod_grads_close_to_exact(world):
    ref, ranks = world
    want = ref["compress"]
    for r, out in enumerate(ranks):
        # the int8 payload is the reference's quantisation of the same
        # pod gradient, bit for bit
        q, scale = ref_quantize(jnp.asarray(out["compress/g_pod"]))
        np.testing.assert_array_equal(out["compress/q"], np.asarray(q))
        assert out["compress/scale"].tobytes() == np.asarray(scale, np.float32).tobytes()
        err = np.abs(out["compress/g"] - want["g"]).max()
        assert err <= np.abs(want["g"]).max() * 2 / 127, (err, r)  # int8 quantization bound
        c = _coords()[r]
        pods = [_rank_at(ranks, pod=i, data=c["data"], model=c["model"]) for i in range(2)]
        deq = sum(p["compress/scale"] * p["compress/q"].astype(np.float32) for p in pods) / 2
        np.testing.assert_allclose(out["compress/g"], deq, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(out["compress/loss"]), want["loss"], rtol=1e-5)
        assert float(out["compress/metric_l"]) == float(out["compress/loss"])


@pytest.mark.parametrize("tag", ["decode", "decode_capped"])
def test_sharded_flash_decode_matches_reference(world, tag):
    """Each rank's output equals the single-device decode step; the ranks'
    caches, gathered over ``model``, equal the reference's new cache
    exactly.  On the second shard lanes 0 and 2 have no valid key."""
    ref, ranks = world
    want = ref[tag]
    assert min(DECODE_IDX) < 16 and [i for i in DECODE_IDX if i < 16] != DECODE_IDX
    for out in ranks:
        np.testing.assert_allclose(out[f"{tag}/out"], want["out"], rtol=2e-5, atol=2e-5)
        assert tuple(out[f"{tag}/made_shape"]) == (4, 16) + want["k"].shape[2:]
        assert bool(out[f"{tag}/odd_length_raises"])
    for pod in range(2):
        for data in range(2):
            for name in ("k", "v"):
                got = np.concatenate([_rank_at(ranks, pod=pod, data=data, model=m)[f"{tag}/{name}"]
                                      for m in range(2)], axis=1)
                np.testing.assert_array_equal(got, want[f"new_{name}"])


def test_int8_train_step_within_the_int8_bound_of_the_plain_step(world):
    """``make_train_step(grad_compression="int8")`` over the mesh: each
    gradient leaf within 2/127 of its largest magnitude of the reference's
    plain single-process gradient, the loss the plain loss, and the step
    AdamW on exactly those gradients, the same on every rank."""
    ref, ranks = world
    want = ref["train"]
    for out in ranks:
        assert bool(out["train/step_is_adamw_of_the_grads"])
        np.testing.assert_allclose(float(out["train/loss"]), want["loss"], rtol=1e-5)
        assert float(out["train/step_loss"]) == float(out["train/loss"])
        for key, g_ref in want["grad"].items():
            g = out[f"train/grad/{key}"]
            np.testing.assert_array_equal(g, ranks[0][f"train/grad/{key}"])
            assert np.abs(g - g_ref).max() <= np.abs(g_ref).max() * 2 / 127, key


def test_restore_onto_the_mesh_gives_each_rank_its_slices(world):
    """``restore(..., shardings=...)`` under the train rules: every rank's
    leaves equal its slices of the saved arrays (the dims' axes major to
    minor, as JAX lays them out), and DTensor's own slices."""
    ref, ranks = world
    want = ref["train"]
    sharded = 0
    for r, out in enumerate(ranks):
        assert bool(out["restore/dtensor_agrees"])
        for key, spec in want["specs"].items():
            saved = want["params"][key]
            exp = _expected_slice(saved, spec, _coords()[r])
            np.testing.assert_array_equal(out[f"restore/leaf/{key}"], exp, err_msg=key)
            sharded += exp.shape != saved.shape
    assert sharded > 0


def test_dtensor_local_regions_match_plain_torch(world):
    """The DTensor regions that only a dry-run takes (the sharded argmax and
    target logit, the vocab-parallel lookup, the in-place cache write), run
    on values on every rank, equal plain torch on the whole tensors."""
    _, ranks = world
    for out in ranks:
        np.testing.assert_array_equal(out["local_indexing/errors"], 0.0)
