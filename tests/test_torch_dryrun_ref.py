"""The port's one-rank dry-run counts held to the reference's HLO analysis.

On a ``(1, 1)`` mesh one rank runs the whole step, so its FLOPs must equal
``hlo_analysis.analyze(compiled.as_text()).flops`` of the reference's jitted
step within 2 %: the smoke config's train cell (``ShapeCfg("mini", 16, 8)``)
for every arch, and prefill and decode for four.  On the mini mesh
``(2, 2, 2)`` each chip's FLOPs must equal the reference's per-chip count
within 2 % for tinyllama's train and decode and qwen2-moe's train, where
DTensor's placements, partial sums and collectives all take part; a gap
judged structural is pinned by name (``PINNED``, ROADMAP.md queue C).  And
tinyllama's per-chip FLOPs times 8 must stay within 1.25× its one-rank
count: a step that replicated its work would not.

The port's side runs in one subprocess (``tests/torch_dryrun_worker.py ...
ref``), and the reference's in another with 8 XLA CPU devices, both at once.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dryrun_worker.py"
CELLS = ([(a, "train") for a in (
    "deepseek-v2-lite-16b", "llama-3.2-vision-90b", "mamba2-780m", "qwen2-7b",
    "qwen2-moe-a2.7b", "qwen2.5-14b", "recurrentgemma-9b", "seamless-m4t-medium",
    "smollm-360m", "tinyllama-1.1b")]
         + [(a, k) for a in ("tinyllama-1.1b", "qwen2-moe-a2.7b", "mamba2-780m",
                             "seamless-m4t-medium") for k in ("prefill", "decode")])
#: the (2, 2, 2) cells held to the reference's per-chip count
MINI_CELLS = (("tinyllama-1.1b", "train"), ("qwen2-moe-a2.7b", "train"),
              ("tinyllama-1.1b", "decode"))
#: mini cells whose per-chip gap to the reference is structural (queue C):
#: the reference's XLA partitioner splits qwen2-moe's routed-expert products
#: over the model axis only (4x the even share forward, 2x backward); the
#: port splits them over all 8 chips.  Held instead to the reference's own
#: one-rank count over 8 chips, and the reference's gap must persist.
PINNED = {("qwen2-moe-a2.7b", "train"): "C11"}

REFERENCE = """
import json, sys
import jax
from repro.configs.base import ShapeCfg
from repro.configs.registry import get_smoke_config
from repro.launch import hlo_analysis
from repro.launch.mesh import make_mesh
from repro.launch.specs import cell_abstract_inputs
from repro.optim.adamw import OptCfg
from repro.parallel.api import use_rules
from repro.parallel.rules import rules_for
from repro.train.steps import make_prefill_step, make_serve_step, make_train_step

def count(arch, kind, dims, axes):
    cfg = get_smoke_config(arch)
    shape = ShapeCfg("mini", seq_len=16, global_batch=8, kind=kind)
    mesh = make_mesh(dims, axes)
    rules = rules_for(cfg, mesh, kind, batch=8)
    with use_rules(rules, mesh):
        args, in_sh, out_sh = cell_abstract_inputs(cfg, shape, rules, mesh)
        step = (make_train_step(cfg, OptCfg(), mesh=mesh) if kind == "train"
                else make_prefill_step(cfg) if kind == "prefill" else make_serve_step(cfg))
        with mesh:
            compiled = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh).lower(
                *args).compile()
    return hlo_analysis.analyze(compiled.as_text()).flops

cells, mini = json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {f"{a}|{k}": count(a, k, (1, 1), ("data", "model")) for a, k in cells}
out.update({f"{a}|{k}|mini": count(a, k, (2, 2, 2), ("pod", "data", "model"))
            for a, k in mini})
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = subprocess.Popen([sys.executable, str(WORKER), str(d / "port.json"), "ref"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(d / "ref.json"),
                            json.dumps(CELLS), json.dumps(MINI_CELLS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, cwd=ROOT,
                           env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    for p in (port, ref):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            port.kill(), ref.kill()
            raise
        assert p.returncode == 0, f"stdout:\n{out[-3000:]}\nstderr:\n{err[-3000:]}"
    return (json.loads((d / "port.json").read_text()),
            json.loads((d / "ref.json").read_text()))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_one_rank_flops_equal_reference(counts, arch, kind):
    port, ref = counts
    got, want = port[f"{arch}|{kind}"]["flops"], ref[f"{arch}|{kind}"]
    assert abs(got - want) <= 0.02 * want, (got, want)


@pytest.mark.parametrize("arch,kind", MINI_CELLS)
def test_mini_mesh_flops_per_chip_equal_reference(counts, arch, kind):
    port, ref = counts
    got, want = port[f"{arch}|{kind}|mini"]["flops"], ref[f"{arch}|{kind}|mini"]
    print(f"{arch} {kind} on (2, 2, 2): port {got:.0f} FLOPs a chip, reference {want:.0f}")
    if (arch, kind) in PINNED:
        even = ref[f"{arch}|{kind}"] / 8
        print(f"the reference's one-device count over 8 chips: {even:.0f}")
        assert abs(got - even) <= 0.02 * even, (got, even)
        assert want > 1.25 * even, (want, even)     # the reference's gap, as judged
    else:
        assert abs(got - want) <= 0.02 * want, (got, want)


def test_mini_mesh_flops_per_chip_are_not_replicated(counts):
    port, ref = counts
    per_chip = port["tinyllama-1.1b|train|mini"]["flops"]
    one_rank = port["tinyllama-1.1b|train"]["flops"]
    print(f"tinyllama-1.1b smoke train on (2, 2, 2): port {per_chip:.0f} FLOPs a chip "
          f"(x8 = {8 * per_chip:.0f}), one rank {one_rank:.0f}; the reference "
          f"{ref['tinyllama-1.1b|train|mini']:.0f} a chip")
    assert per_chip * 8 <= 1.25 * one_rank
