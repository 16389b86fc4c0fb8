"""The mesh's pure parts in one process, against the reference: the sharding
rules (``rules_for``) for every arch, mode, mesh and flag — the 256- and
512-chip production shapes included, through a shape-only stand-in on both
sides — the parameter, cache and optimizer-state specs, the twin of
``test_seq_shard_fallback_rules``, the int8 quantisation bit for bit, and a
rank's slices against JAX's own layout of a sharded array.  The multi-rank
paths are in ``tests/test_torch_distributed.py``.
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.optim.adamw import opt_state_specs as ref_opt_state_specs
from repro.parallel import compression as ref_compression
from repro.parallel.rules import describe as ref_describe
from repro.parallel.rules import rules_for as ref_rules_for

from repro_torch import _tree
from repro_torch.configs import registry
from repro_torch.launch.mesh import host_device_mesh, make_mesh, production_shape
from repro_torch.models import transformer
from repro_torch.optim.adamw import init_opt_state, opt_state_specs
from repro_torch.parallel import api, compression
from repro_torch.parallel.api import MeshShape, P, Replicate, Shard
from repro_torch.parallel.rules import describe, rules_for

ROOT = Path(__file__).resolve().parent.parent
ARCHS = registry.list_archs()
MESHES = [((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MODES = ("train", "prefill", "decode")
FLAGS = [{}, {"moe_ep": True}, {"seq_shard_fallback": True}, {"embed_fsdp": False},
         {"flash_decode": True}, {"pod_in_batch": False}]


class _RefMesh:
    """A stand-in for a JAX mesh: the reference's rules read only these."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _is_spec(t) -> bool:
    return isinstance(t, tuple) and all(e is None or isinstance(e, str) for e in t)


def _spec_leaves(tree) -> list:
    if _is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _spec_leaves(tree[k])]
    return [leaf for t in tree for leaf in _spec_leaves(t)]


def _configs(arch):
    return [(registry.get_config(arch), ref_registry.get_config(arch)),
            (registry.get_smoke_config(arch), ref_registry.get_smoke_config(arch))]


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_equals_the_reference(arch):
    """Every mesh (the production shapes too) x mode x flag x batch, the
    full and the smoke config: the same rules as a dict, the same
    ``describe``, and each parameter's and cache's spec resolved alike."""
    for (cfg, ref_cfg), (shape, axes), mode, flags, batch in itertools.product(
            _configs(arch), MESHES, MODES, FLAGS, (None, 8, 6)):
        got = rules_for(cfg, MeshShape(shape, axes), mode, batch=batch, **flags)
        want = ref_rules_for(ref_cfg, _RefMesh(shape, axes), mode, batch=batch, **flags)
        where = (arch, cfg.name, shape, mode, flags, batch)
        assert got.rules == want.rules, where
        assert describe(got) == ref_describe(want), where
        for spec in _spec_leaves(ref_transformer.specs_lm(ref_cfg)) + \
                _spec_leaves(ref_transformer.specs_lm_cache(ref_cfg)):
            assert tuple(got.resolve(spec)) == tuple(want.resolve(spec)), (where, spec)


def test_production_shapes_are_the_reference_meshes():
    assert production_shape().shape == {"data": 16, "model": 16}
    assert production_shape(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert production_shape(multi_pod=True).size == 512


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference_and_fit_the_trees(arch):
    """``specs_lm``, ``specs_lm_cache`` and ``opt_state_specs`` equal the
    reference's trees; at the smoke size each spec has one entry a dim of
    the port's parameter, cache and optimizer-state leaf, tree for tree."""
    for cfg, ref_cfg in _configs(arch):
        specs = transformer.specs_lm(cfg)
        assert specs == ref_transformer.specs_lm(ref_cfg)
        assert transformer.specs_lm_cache(cfg) == ref_transformer.specs_lm_cache(ref_cfg)
        assert opt_state_specs(specs) == ref_opt_state_specs(ref_transformer.specs_lm(ref_cfg))
    cfg = registry.get_smoke_config(arch)
    params = transformer.init_lm(0, cfg, device="cpu")
    trees = [(transformer.specs_lm(cfg), params),
             (transformer.specs_lm_cache(cfg), transformer.init_lm_cache(cfg, 2, 16, device="cpu")),
             (opt_state_specs(transformer.specs_lm(cfg)), init_opt_state(params))]
    for spec_tree, tree in trees:
        specs, leaves = _spec_leaves(spec_tree), _tree.leaves(tree)
        assert len(specs) == len(leaves)
        assert list(_tree.with_paths(tree)) == list(_tree.with_paths(
            _tree.unflatten(tree, list(range(len(leaves))))))
        for spec, leaf in zip(specs, leaves):
            assert len(spec) == leaf.ndim, (spec, tuple(leaf.shape))


def test_seq_shard_fallback_rules():
    """40 heads on a 16-way model axis cannot head-shard: the fallback rules
    must shard the sequence instead (and only then)."""
    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    # qwen2.5-14b: 40 heads, model=2 divides -> no fallback even if enabled
    r = rules_for(registry.get_config("qwen2.5-14b"), mesh, "prefill", seq_shard_fallback=True)
    assert r.rules["heads"] == "model" and r.rules["seq"] is None
    # smollm: 15 heads, model=2 does not divide -> seq fallback kicks in
    r2 = rules_for(registry.get_config("smollm-360m"), mesh, "prefill", seq_shard_fallback=True)
    assert r2.rules["heads"] is None and r2.rules["seq"] == "model"


# -- int8 quantisation ----------------------------------------------------------------


def _ties(scale: float) -> np.ndarray:
    """Values whose quotient by the scale lands on .5 (round half to even),
    with 127 x scale as the largest magnitude."""
    return (np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5], np.float32)
            * np.float32(scale))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 300),
       log_scale=st.floats(-30.0, 10.0), ties=st.booleans())
def test_quantize_int8_equals_the_reference_bit_for_bit(seed, n, log_scale, ties):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(log_scale)).astype(np.float32)
    if ties:
        x = np.concatenate([x * 0, _ties(np.exp(log_scale) / 127.0)])
    q, scale = compression.quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_compression.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    assert scale.numpy().tobytes() == np.asarray(rscale, np.float32).tobytes()
    deq = compression.dequantize(q, scale).numpy()
    assert deq.tobytes() == np.asarray(ref_compression.dequantize(rq, rscale)).tobytes()


def test_quantize_int8_of_zeros_and_a_bfloat16_tensor():
    q, scale = compression.quantize_int8(torch.zeros(5))
    rq, rscale = ref_compression.quantize_int8(jnp.zeros(5))
    assert not q.any() and float(scale) == float(rscale)
    x = torch.linspace(-3, 5, 77).to(torch.bfloat16)
    q, scale = compression.quantize_int8(x)
    rq, rscale = ref_compression.quantize_int8(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)


# -- a rank's slices and placements -------------------------------------------------


LAYOUT_SPECS = [(("pod", "data"), None), (("pod", "data"), "model"), ("data", None),
                (None, ("data", "model")), (("pod", "data", "model"), None), ("model", "pod")]


def test_local_slices_follow_the_reference_layout():
    """On 8 host devices, JAX's own index map of an (8, 8) array under each
    spec equals the port's ``local_slice`` at every coordinate: a dim over
    ``("pod", "data")`` splits major to minor, pod first, as the mesh's
    order reads."""
    code = textwrap.dedent("""
        import json
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        specs = %s
        out = []
        for spec in specs:
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map((8, 8))
            rows = {}
            for dev, sl in idx.items():
                coord = [int(c[0]) for c in (mesh.devices == dev).nonzero()]
                rows[str(coord)] = [[s.start or 0, s.stop or 8] for s in sl]
            out.append(rows)
        print(json.dumps(out))
    """) % repr(LAYOUT_SPECS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_layout = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(64).reshape(8, 8)
    for spec, rows in zip(LAYOUT_SPECS, jax_layout):
        for coord in itertools.product(range(2), repeat=3):
            got = api.local_slice(x, spec, mesh, dict(zip(mesh.axis_names, coord)))
            (r0, r1), (c0, c1) = rows[str(list(coord))]
            assert torch.equal(got, x[r0:r1, c0:c1]), (spec, coord)


def test_placements_of_specs():
    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert api.placements(P(("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert api.placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert api.placements(P(), mesh) == (Replicate(),) * 3
    for bad in (P(("data", "pod")), P("data", "data"), P("expert")):
        with pytest.raises(ValueError):
            api.placements(bad, mesh)
    rules = rules_for(registry.get_config("tinyllama-1.1b"), mesh, "train", batch=8)
    assert api.named_sharding(mesh, ("batch", None), rules) == (Shard(0), Shard(0), Replicate())
    assert repr(P(("pod", "data"), None)) == "PartitionSpec(('pod', 'data'), None)"


@contextlib.contextmanager
def _one_rank_world():
    """A one-rank gloo world for the duration (none is left behind)."""
    made = not dist.is_initialized()
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def test_a_one_rank_device_mesh_takes_the_same_rules_and_redistributes_dtensors():
    """``host_device_mesh`` makes its own one-rank world; ``rules_for``
    reads a DeviceMesh as it reads the shape stand-in; ``shard`` leaves a
    plain tensor as it is and redistributes a DTensor; the collectives run
    over a one-rank group."""
    from torch.distributed.tensor import distribute_tensor

    with _one_rank_world():
        host = host_device_mesh("cpu")
        assert api.mesh_axis_names(host) == ("data", "model")
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device_type="cpu")
        cfg = registry.get_config("qwen2-moe-a2.7b")
        for mode, flags in itertools.product(MODES, FLAGS):
            assert rules_for(cfg, mesh, mode, **flags).rules == rules_for(
                cfg, MeshShape((1, 1, 1), ("pod", "data", "model")), mode, **flags).rules
        x = torch.arange(12.0).reshape(4, 3)
        rules = rules_for(cfg, mesh, "train")
        with api.use_rules(rules, mesh):
            assert api.shard(x, "batch", None) is x
            d = api.shard(distribute_tensor(x, mesh, (Replicate(),) * 3), "batch", None)
            assert d.placements == (Shard(0), Shard(0), Replicate())
            assert torch.equal(d.full_tensor(), x)
            assert torch.equal(api.all_gather(x, "model", axis=1, tiled=True), x)
            assert torch.equal(api.psum(x, "pod"), x) and torch.equal(api.pmean(x, "data"), x)
            assert api.axis_index("model") == 0 and api.coordinate(mesh) == {
                "pod": 0, "data": 0, "model": 0}
        assert api.current_rules() is None and api.current_mesh() is None
        with pytest.raises(RuntimeError, match="needs a world of 8 ranks"):
            make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")


def test_a_mesh_without_a_device_type_is_the_cards():
    """``device_type=None`` means the card, as every entry point's device
    does: without one it raises in ``resolve_device``'s words, and the CPU is
    taken only by name."""
    from repro_torch.launch import mesh as mesh_mod

    if torch.cuda.is_available():
        assert mesh_mod._device_type(None) == "cuda"
        return
    for make in (lambda: make_mesh((1, 1), ("data", "model")), host_device_mesh,
                 mesh_mod.make_production_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device available"):
            make()
    assert not dist.is_initialized()
