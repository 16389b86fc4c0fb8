"""The port's dry-run at full width held to the reference's, on the
single-pod mesh of 256 chips.

For each cell, one rank's FLOPs (the whole step, on a ``(1, 1)`` mesh, with
the 256-chip mesh's microbatches) must equal the reference's one-device HLO
count within 2 %, or differ by exactly a gap judged in ROADMAP.md's queue C
(``PINNED``); and each chip's FLOPs on the 256-chip mesh must lie
between 0.98 of the even share of that count and 1.25× the reference's own
per-chip count: DTensor and XLA's partitioner may place a product differently, but a
step that replicated a layer's work over a mesh axis (a gathered cache, a
gradient computed whole) would not pass.  The cells take the paths where the
two partitioners differ: a dense train step, the sequence-split decode of a
dense and of an MoE model, the SSD's train step, a multi-query decode
whose one KV head cannot split, and an MoE train step.

The port's side runs in one subprocess (``tests/torch_dryrun_worker.py ...
prod``), and the reference's in another with 256 XLA CPU devices, both at
once.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dryrun_worker.py"
CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "decode_32k"),
         ("mamba2-780m", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
         ("recurrentgemma-9b", "decode_32k"), ("qwen2-moe-a2.7b", "train_4k"),
         ("qwen2-7b", "decode_32k"))
#: one-rank gaps judged structural (ROADMAP.md queue C): block remat
#: recomputes the shared experts' down projection, whose output the backward
#: never reads and XLA drops; the port counts it, as it runs it
PINNED = {("qwen2-moe-a2.7b", "train_4k"): "C11"}

REFERENCE = """
import json, sys
import jax
from repro.configs.base import SHAPES
from repro.configs.registry import get_config
from repro.launch import hlo_analysis
from repro.launch.dryrun import build_step, microbatches_for
from repro.launch.mesh import make_mesh, make_production_mesh
from repro.launch.specs import cell_abstract_inputs
from repro.parallel.api import use_rules
from repro.parallel.rules import rules_for

def count(cfg, shape, mesh, mb):
    rules = rules_for(cfg, mesh, shape.kind, batch=shape.global_batch // mb)
    with use_rules(rules, mesh):
        args, in_sh, out_sh = cell_abstract_inputs(cfg, shape, rules, mesh, num_microbatches=mb)
        step = build_step(cfg, shape, mesh, mb, {})
        with mesh:
            compiled = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh).lower(
                *args).compile()
    return hlo_analysis.analyze(compiled.as_text()).flops

out = {}
for arch, name in json.loads(sys.argv[2]):
    cfg, shape = get_config(arch), SHAPES[name]
    mesh = make_production_mesh(multi_pod=False)
    mb = microbatches_for(cfg, shape, mesh)
    out[f"{arch}|{name}"] = {"per_chip": count(cfg, shape, mesh, mb),
                             "one_device": count(cfg, shape, make_mesh((1, 1), ("data", "model")), mb),
                             "microbatches": mb}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_prod")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = subprocess.Popen([sys.executable, str(WORKER), str(d / "port.json"), "prod"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(d / "ref.json"),
                            json.dumps(CELLS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, cwd=ROOT,
                           env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=256"))
    for p in (port, ref):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            port.kill(), ref.kill()
            raise
        assert p.returncode == 0, f"stdout:\n{out[-3000:]}\nstderr:\n{err[-3000:]}"
    return (json.loads((d / "port.json").read_text()),
            json.loads((d / "ref.json").read_text()))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_production_one_rank_flops_equal_reference(counts, arch, shape):
    port, ref = counts
    got, want = port[f"{arch}|{shape}"], ref[f"{arch}|{shape}"]
    assert got["microbatches"] == want["microbatches"]
    print(f"{arch} x {shape} on one rank: port {got['one_rank']:.6e} FLOPs, "
          f"reference {want['one_device']:.6e}")
    if (arch, shape) in PINNED:
        cfg, sh = get_config(arch), SHAPES[shape]
        moe_layers = sum(s.repeats * len(s.pattern) for s in cfg.segments if s.ffn == "moe")
        extra = 2 * sh.global_batch * sh.seq_len * cfg.moe.d_ff_shared * cfg.d_model * moe_layers
        assert got["one_rank"] == pytest.approx(want["one_device"] + extra, rel=1e-9), (got, want)
    else:
        assert abs(got["one_rank"] - want["one_device"]) <= 0.02 * want["one_device"], (got, want)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_production_flops_per_chip_within_the_reference_placement(counts, arch, shape):
    port, ref = counts
    got, want = port[f"{arch}|{shape}"], ref[f"{arch}|{shape}"]
    even = got["one_rank"] / 256
    print(f"{arch} x {shape} on 256 chips: port {got['per_chip']:.4e} FLOPs a chip "
          f"({got['per_chip'] / even:.3f}x the even share), reference {want['per_chip']:.4e} "
          f"({want['per_chip'] / even:.3f}x)")
    assert 0.98 * even <= got["per_chip"] <= 1.25 * max(want["per_chip"], even), (got, want)
