"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --device cpu --steps 20

Wires every subsystem: config registry -> synthetic data pipeline -> train
step (forward and backward; on the card the attention's through the flash
kernel K3 and its backward S2) -> AdamW -> async checkpointing ->
fault-tolerant restart driver (``--fail-at`` injects failures to drill the
restart path).  ``--smoke`` selects the reduced config; omit it to train the
full architecture (on the card).  Without ``--device`` it runs on the CUDA
device and raises where there is none.  It runs on one rank: the
one-rank ``("data", "model")`` mesh of ``launch.mesh.host_device_mesh``,
under the training sharding rules (``parallel.rules.rules_for``).
``--ckpt-dir`` defaults to a fresh directory under the checkout's ``build/``,
removed at the end; a directory given keeps its checkpoints, and a later run
on it resumes from the newest.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import torch

from .._device import resolve_device
from ..configs.base import ModelCfg, ShapeCfg
from ..configs.registry import get_config, get_smoke_config, list_archs
from ..data.pipeline import make_batch
from ..ft.runtime import RunReport, StepMonitor, inject_failures, run_with_restarts
from ..launch.mesh import host_device_mesh
from ..optim.adamw import OptCfg
from ..parallel.api import use_rules
from ..parallel.rules import rules_for
from ..train.steps import init_train_state, make_train_step

#: where a run without ``--ckpt-dir`` keeps its checkpoints while it runs
SCRATCH = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


@dataclass
class TrainRun:
    """What a run leaves: the driver's report, each step's metrics as floats
    (a step re-run after a restart appears again), the live state after the
    last step, and the step monitor (seconds a step, the device's included)."""

    report: RunReport
    metrics: list[dict] = field(default_factory=list)
    state: Optional[dict] = None
    monitor: StepMonitor = field(default_factory=StepMonitor)
    seconds: float = 0.0

    @property
    def losses(self) -> list[float]:
        return [m["loss"] for m in self.metrics]


def train(cfg: ModelCfg, opt: OptCfg, *, steps: int, batch: int, seq: int,
          ckpt_dir, ckpt_every: int, microbatches: int = 1, fail_at=(), seed: int = 0,
          device=None, monitor: Optional[StepMonitor] = None,
          on_step: Optional[Callable[[int, dict], None]] = None) -> TrainRun:
    """``steps`` train steps of ``cfg`` on the synthetic stream (``batch``
    sequences of ``seq`` tokens a step) from ``init_train_state(seed)``,
    under ``run_with_restarts``: checkpoints every ``ckpt_every`` steps in
    ``ckpt_dir``, failures injected at the steps of ``fail_at``.
    ``on_step(i, metrics)`` follows each step with its metrics as floats."""
    dev = resolve_device(device)
    shape = ShapeCfg("cli", seq_len=seq, global_batch=batch, kind="train")
    base_step = make_train_step(cfg, opt, num_microbatches=microbatches, device=dev)
    run = TrainRun(report=RunReport(), monitor=monitor or StepMonitor())

    def step(state, b):
        state, metrics = base_step(state, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)    # the monitor times the step, not its dispatch
        run.state = state
        return state, metrics

    step_fn = (inject_failures(step, set(fail_at)) if fail_at else
               (lambda state, b, _step=None: step(state, b)))

    def on_metrics(i, m):
        floats = {k: float(v) for k, v in m.items()}
        run.metrics.append(floats)
        if on_step is not None:
            on_step(i, floats)

    t0 = time.time()
    run.report = run_with_restarts(
        init_state=lambda: init_train_state(seed, cfg, device=dev),
        step_fn=step_fn,
        batch_at=lambda i: make_batch(cfg, shape, step=i),
        num_steps=steps,
        ckpt_dir=str(ckpt_dir),
        ckpt_every=ckpt_every,
        monitor=run.monitor,
        on_metrics=on_metrics,
    )
    run.seconds = time.time() - t0
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh one under build/, "
                         "removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (restart drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    mesh = host_device_mesh(dev.type)
    rules = rules_for(cfg, mesh, "train", batch=args.batch // args.microbatches)
    opt = OptCfg(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                 decay_steps=args.steps)

    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"device={dev} steps={args.steps}")

    monitor = StepMonitor()

    def on_step(i, m):
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  "
                  f"lr {m['lr']:.2e}  "
                  f"med_step {monitor.median:.3f}s")

    scratch = None
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None:
        SCRATCH.mkdir(parents=True, exist_ok=True)
        ckpt_dir = scratch = tempfile.mkdtemp(prefix="train-", dir=SCRATCH)
    try:
        with use_rules(rules, mesh):
            run = train(cfg, opt, steps=args.steps, batch=args.batch, seq=args.seq,
                        microbatches=args.microbatches, ckpt_dir=ckpt_dir,
                        ckpt_every=args.ckpt_every, fail_at=args.fail_at, device=dev,
                        monitor=monitor, on_step=on_step)
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)

    report, losses = run.report, run.losses
    print(f"done: {report.steps_completed} steps in {run.seconds:.1f}s, "
          f"{report.restarts} restarts, {report.straggler_events} straggler events")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
