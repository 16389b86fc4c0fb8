"""Fault-tolerance runtime: step monitor, straggler detection, failure
injection, and the checkpoint-restart driver.

On a real multi-pod deployment the coordinator-side loop below wraps the
per-host train loop; node failure surfaces as an exception from the step
function (collective timeout / heartbeat loss), the driver tears down,
re-forms the mesh over the surviving hosts (elastic), restores the newest
complete checkpoint and resumes — the data pipeline is seekable so no batch
is skipped or repeated.  Everything except the actual multi-host teardown is
exercised by tests here (failure injection + restart + exact-resume).
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..checkpoint.store import AsyncCheckpointer, latest_step, restore


# ---------------------------------------------------------------------------
# step monitoring / straggler detection
# ---------------------------------------------------------------------------


@dataclass
class StepMonitor:
    """Tracks per-step wall time; flags stragglers.

    On real hardware each host reports its step time; a host whose time
    exceeds ``threshold`` x running-median is flagged (ahead of hard
    failure) so the coordinator can pre-emptively checkpoint or evict."""

    threshold: float = 2.5
    window: int = 50
    times: list[float] = field(default_factory=list)
    stragglers: list[tuple[int, float]] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        med = statistics.median(self.times[-self.window:]) if self.times else dt
        self.times.append(dt)
        if len(self.times) > 5 and dt > self.threshold * med:
            self.stragglers.append((step, dt / med))
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.times[-self.window:]) if self.times else 0.0


# ---------------------------------------------------------------------------
# failure injection (tests / chaos drills)
# ---------------------------------------------------------------------------


class InjectedFailure(RuntimeError):
    pass


def inject_failures(step_fn: Callable, fail_at: set[int]):
    """Wrap a step function to raise at the given global steps — models a
    node loss mid-run.  Each step index fires once."""
    remaining = set(fail_at)

    def wrapped(state, batch, *, _step: int, **kw):
        if _step in remaining:
            remaining.discard(_step)
            raise InjectedFailure(f"injected node failure at step {_step}")
        return step_fn(state, batch, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# restart driver
# ---------------------------------------------------------------------------


@dataclass
class RunReport:
    steps_completed: int = 0
    restarts: int = 0
    straggler_events: int = 0
    history: list[dict] = field(default_factory=list)


def run_with_restarts(
    *,
    init_state: Callable[[], Any],
    step_fn: Callable,                       # (state, batch, _step=i) -> (state, metrics)
    batch_at: Callable[[int], Any],
    num_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    keep: int = 3,
    monitor: Optional[StepMonitor] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
) -> RunReport:
    """Checkpoint/restart training driver (single-host harness of the
    coordinator logic).  Guarantees: exactly-once batch consumption (the
    stream is seekable by step), restart from the newest complete
    checkpoint, bounded restart count."""
    report = RunReport()
    monitor = monitor or StepMonitor()
    ckpt = AsyncCheckpointer(ckpt_dir, keep=keep)

    attempts = 0
    while True:
        # -- (re)start: restore or init ---------------------------------
        start = latest_step(ckpt_dir)
        if start is not None:
            like = init_state()
            state, start = restore(ckpt_dir, like)
            step = start + 1
        else:
            state = init_state()
            step = 0

        try:
            while step < num_steps:
                monitor.start()
                state, metrics = step_fn(state, batch_at(step), _step=step)
                monitor.stop(step)
                if on_metrics is not None:
                    on_metrics(step, metrics)
                report.history.append({"step": step, "restart": report.restarts})
                if (step + 1) % ckpt_every == 0 or step + 1 == num_steps:
                    ckpt.save(step, state, metadata={"num_steps": num_steps})
                step += 1
            ckpt.wait()
            report.steps_completed = num_steps
            report.straggler_events = len(monitor.stragglers)
            return report
        except Exception:
            ckpt.wait()
            attempts += 1
            report.restarts += 1
            if attempts > max_restarts:
                raise
            # loop re-forms state from the last complete checkpoint
