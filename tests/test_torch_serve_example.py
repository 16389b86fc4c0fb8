"""``examples/serve_batched_torch.py`` against ``examples/serve_batched.py``,
each run as a user runs it, in a subprocess on the CPU.

The two examples draw the same requests (one numpy generator from seed 0) and
serve them with the same defaults, so their ``served N requests, M tokens, K
decode steps in ...`` lines agree but for the seconds, and so do the request
ids and prompts of their three ``req`` lines.  The tokens a model emits depend
on its weights, which each package draws from its own generator; served the
reference's weights (the port's ``init_lm`` patched, in a ``-c`` wrapper, to
carry over the reference's ``init_lm`` from ``jax.random.key(0)``), the twin
prints the JAX example's ``req`` lines token for token.  There the JAX example runs
with each of its engine's prefill steps waited on: its ``Engine.prefill``
bumps its numpy positions in place right after dispatching a step that reads
them, and on the CPU the step may read the bumped ones (ROADMAP.md C1; the
port is right), which moves the tokens of a model with positions (RoPE).
tinyllama-1.1b (lanes refilled one by one) and mamba2-780m (refilled in
waves).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["tinyllama-1.1b", "mamba2-780m"]
SERVED = re.compile(r"^served (\d+) requests, (\d+) tokens, (\d+) decode steps in [\d.]+s "
                    r"\([\d.]+ tok/s\)$")


# examples/serve_batched.py with each prefill step of its engine waited on (C1)
WAITED = """
import runpy, sys
import jax
from repro.launch import serve
init = serve.Engine.__init__
def waited(self, *args, **kwargs):
    init(self, *args, **kwargs)
    one = self._decode_one
    self._decode_one = lambda *a: jax.block_until_ready(one(*a))
serve.Engine.__init__ = waited
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""

# examples/serve_batched_torch.py serving the reference's weights for the arch
# of its --arch: the port's init_lm returns them, carried over by compat
ON_REFERENCE_WEIGHTS = """
import runpy, sys
import jax
from repro.configs import registry
from repro.models import transformer as ref
from repro_torch import compat
from repro_torch.models import transformer
arch = sys.argv[sys.argv.index("--arch") + 1]
def init_lm(seed, cfg, *, device=None):
    tree = ref.init_lm(jax.random.key(seed), registry.get_smoke_config(arch))
    return compat.params_from_reference(jax.device_get(tree), device)
transformer.init_lm = init_lm
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def start(example, *args, env=None, wrapper=None):
    cmd = [sys.executable, *(["-c", wrapper] if wrapper else []),
           str(ROOT / "examples" / example), *args]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=str(ROOT))


def finish(proc) -> subprocess.CompletedProcess:
    out, err = proc.communicate(timeout=300)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run(example, *args, env=None, wrapper=None):
    return finish(start(example, *args, env=env, wrapper=wrapper))


def served(out: str):
    """(requests, tokens, decode steps) and the ``req`` lines of a run's output."""
    lines = out.strip().splitlines()
    m = SERVED.match(lines[-4])
    assert m, lines
    reqs = lines[-3:]
    assert all(line.startswith("  req ") for line in reqs), reqs
    return tuple(int(g) for g in m.groups()), reqs


_reference: dict = {}


def reference_run(arch):
    """The JAX example's (counts, req lines) as a user runs it, and the same
    with its prefill steps waited on (the two runs side by side), once per
    arch."""
    if arch not in _reference:
        procs = [start("serve_batched.py", "--arch", arch, wrapper=w) for w in (None, WAITED)]
        outs = [finish(p) for p in procs]
        for out in outs:
            assert out.returncode == 0, out.stderr[-2000:]
        _reference[arch] = (*served(outs[0].stdout), served(outs[1].stdout))
    return _reference[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_twin_serves_what_the_jax_example_serves(arch):
    """With its own weights: the same requests, tokens and decode steps, and
    the same request ids and prompts in its ``req`` lines."""
    counts, reqs, _ = reference_run(arch)
    out = run("serve_batched_torch.py", "--arch", arch, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    got_counts, got_reqs = served(out.stdout)
    assert got_counts == counts == (10, 120, counts[2])
    assert [r.split(" -> ")[0] for r in got_reqs] == [r.split(" -> ")[0] for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_twin_on_the_reference_weights_prints_the_same_lines(arch):
    """Served the reference's weights, the twin's lines equal the JAX
    example's with its prefill steps waited on, token for token (bar the
    seconds); its counts equal those of the example as a user runs it."""
    counts, _, waited = reference_run(arch)
    out = run("serve_batched_torch.py", "--arch", arch, "--device", "cpu",
              wrapper=ON_REFERENCE_WEIGHTS)
    assert out.returncode == 0, out.stderr[-2000:]
    assert served(out.stdout) == waited and waited[0] == counts


def test_twin_without_a_device_needs_cuda():
    """No ``--device`` means the card: where there is none the twin exits
    non-zero and says so."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run("serve_batched_torch.py", env=env)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
