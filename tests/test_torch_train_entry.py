"""The port's training entry points on the CPU: ``python -m
repro_torch.launch.train --smoke --device cpu`` and the
``examples/train_tinylm_torch.py`` twin, each through a restart, with the
loss falling."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(*argv):
    out = subprocess.run([sys.executable, *argv], capture_output=True, text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


def first_and_last_loss(line: str) -> tuple[float, float]:
    a, b = line.split("loss ", 1)[1].split("->")[:2]
    return float(a), float(b.split()[0])


def test_launch_train_smoke_on_the_cpu_with_a_restart():
    out = run("-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b", "--smoke",
              "--device", "cpu", "--steps", "20", "--ckpt-every", "5", "--fail-at", "7",
              "--log-every", "5")
    lines = out.splitlines()
    assert lines[0].startswith("arch=tinyllama-smoke layers=2 d=128 device=cpu steps=20")
    assert any(l.startswith("step    15  loss") and "gnorm" in l and "med_step" in l
               for l in lines)
    assert "done: 20 steps" in out and "1 restarts" in out
    first, last = first_and_last_loss(lines[-1])
    assert last < first - 1.0, lines[-1]


def test_train_example_twin_on_the_cpu():
    # a checkpoint after step 9, the failure at 11: steps 10 and 11 run again
    out = run(str(ROOT / "examples" / "train_tinylm_torch.py"), "--device", "cpu",
              "--steps", "12", "--fail-at", "11")
    assert "params=81.9M" in out and "completed 12 steps, 1 restarts" in out
    first, last = first_and_last_loss(out.splitlines()[-1])
    assert last < first
