"""One run of a training cell.

Set-up: the cell's configuration read by the port (``port/<config>.py``), the
weights drawn from the seed on the device by the benchmark (``weights``) and laid
into the port's parameter tree, a fresh AdamW state, and the port's
``train.steps.make_train_step``.  The first ``checked_steps`` steps run through
that same step on the benchmark's stream; they warm up every shape and are the
steps the reference follows.

The window: the same state and step, one batch made on the host and one step
after another, each ending in ``torch.cuda.synchronize()``, until ``seconds``
have passed; the peak of allocated device memory is taken over it.  With a
trace, ``traced_steps`` more steps run under the profiler.

Then the port's state is released and the configuration's float32 reference
(``reference/<config>.py``) follows the checked steps from the same weights,
drawn again from the seed, on the same batches; ``check`` compares the two.
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import check, plain, spec, synthetic, trace, weights

#: top-level modules that nothing the benchmark runs may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole (so
    ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_of(cell: spec.Cell, seed: int) -> synthetic.Stream:
    t = cell.traffic
    return synthetic.Stream(seed, t["batch"], t["seq_len"], cell.conf["vocab_size"],
                            t["stream"]["active_vocab"], t["stream"]["noise"])


def _check_params(specs: dict, port: dict) -> None:
    """The reference's parameter list and the port's tree must name the same
    leaves, of the same shapes and dtypes."""
    bad = sorted(set(specs) ^ set(port))
    bad += [k for k in sorted(set(specs) & set(port))
            if tuple(port[k].shape) != tuple(specs[k][0])
            or port[k].dtype != weights.DTYPES[specs[k][1]]]
    if bad:
        raise ValueError(f"the reference's parameters and the port's differ at {bad[:8]}")


class Training:
    """The port's training state on the benchmark's weights and its train step.
    ``advance`` replaces the state with the step's new one, so that no caller
    keeps an old state alive beside it (it would add a whole state to the peak)."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device):
        from repro_torch import _tree
        from repro_torch.launch.specs import params_shapes
        from repro_torch.optim.adamw import OptCfg, init_opt_state
        from repro_torch.train import steps

        cfg = spec.module("port", cell.config).model_cfg(cell.conf)
        specs = spec.module("reference", cell.config).param_specs(cell.conf)
        shapes = params_shapes(cfg)
        port = _tree.with_paths(shapes)
        _check_params(specs, port)
        made = weights.make(specs, seed, device)
        params = _tree.unflatten(shapes, [made.pop(k) for k in port])
        self.state = {"params": params, "opt": init_opt_state(params)}
        del params
        self.step = steps.make_train_step(cfg, OptCfg(**cell.traffic["optimizer"]),
                                          device=device)
        self.device = device

    def advance(self, batch: dict) -> dict:
        """One step, ended by a synchronize; returns the step's metrics."""
        self.state, m = self.step(self.state, batch)
        sync(self.device)
        return m


def checked_steps(cell: spec.Cell, seed: int, run: Training, stream) -> dict:
    """The first steps, and the program's readings of them: each step's loss,
    each leaf's norm of the first gradient (from AdamW's first moment after
    one step: m = (1 - b1) g) and its values at the leaf's
    ``plain.sample_indices``, and each leaf's norm of change over the steps
    (against the weights drawn again from the seed: a copy kept through the
    steps would raise their peak)."""
    from repro_torch import _tree

    b1 = cell.traffic["optimizer"]["b1"]
    losses, grads, samples = [], {}, {}
    for i in range(cell.traffic["checked_steps"]):
        losses.append(float(run.advance(stream.batch_at(i))["loss"]))
        if i == 0:
            for k, v in _tree.with_paths(run.state["opt"]["m"]).items():
                idx = plain.sample_indices(k, v.numel(), seed).to(v.device)
                grads[k] = float(v.float().norm()) / (1 - b1)
                samples[k] = (v.flatten()[idx].float() / (1 - b1)).cpu()
    now = _tree.with_paths(run.state["params"])
    start = weights.make(spec.module("reference", cell.config).param_specs(cell.conf), seed,
                         run.device)
    change = {k: float((now[k].float() - start.pop(k).float()).norm()) for k in now}
    return {"loss": losses, "grad_norms": grads, "grad_samples": samples,
            "change_norms": change}


def window(run: Training, stream, first: int, seconds: float) -> dict:
    """Steps from batch ``first`` on until ``seconds`` have passed: {"steps",
    "seconds", "failed", "peak_bytes", "step_s"}; ``seconds`` runs to the end of
    the last step, a step is failed where its loss is not finite, ``step_s``
    holds each step's seconds."""
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    n = failed = 0
    ends = []
    t0 = time.perf_counter()
    while True:
        m = run.advance(stream.batch_at(first + n))
        n += 1
        failed += not math.isfinite(float(m["loss"]))
        ends.append(time.perf_counter())
        elapsed = ends[-1] - t0
        if elapsed >= seconds:
            break
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    step_s = [b - a for a, b in zip([t0] + ends, ends)]
    return {"steps": n, "seconds": elapsed, "failed": failed, "peak_bytes": peak,
            "step_s": step_s}


def card_state() -> str:
    """The card's SM clock, temperature and power draw as ``nvidia-smi`` reads
    them (a card that runs slow under load shows here)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                              "temperature.gpu,power.draw", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip() if out.returncode == 0 else f"not read: exit {out.returncode}"


def step_times(step_s: list) -> str:
    """The window's step times in a line: the median and the extremes, and the
    medians of its first and last quarter (a window that warms up or slows
    down shows them apart)."""
    q = max(1, len(step_s) // 4)
    med = statistics.median
    return (f"steps {len(step_s)}, s a step: median {med(step_s):.4f}, min {min(step_s):.4f}, "
            f"max {max(step_s):.4f}, first quarter {med(step_s[:q]):.4f}, "
            f"last quarter {med(step_s[-q:]):.4f}, first three "
            f"{[round(s, 4) for s in step_s[:3]]}")


def traced(run: Training, stream, first: int, steps: int, tmp_dir: str) -> trace.Stretch:
    """``steps`` more steps under the profiler."""
    from torch.profiler import record_function

    def steps_from(k):
        for i in range(k):
            with record_function(trace.BATCH):
                batch = stream.batch_at(first + i)
            with record_function(trace.STEP):
                run.advance(batch)

    return trace.profile_steps(steps_from, steps, tmp_dir)


def half_masked(batch: dict) -> dict:
    """The batch with the loss taken over the first half of its positions only
    (the mean over the rest): the fault of a step that leaves half the batch out."""
    mask = (torch.arange(batch["labels"].size) < batch["labels"].size // 2).float()
    return dict(batch, loss_mask=mask.reshape(batch["labels"].shape).numpy())


def reference(cell: spec.Cell, seed: int, device: torch.device, precision: str = "fp32",
              half_batch: bool = False) -> dict:
    """The reference's readings of the checked steps, from the seed's weights
    drawn again on ``device``."""
    ref = spec.module("reference", cell.config)
    stream = stream_of(cell, seed)
    batches = [stream.batch_at(i) for i in range(cell.traffic["checked_steps"])]
    if half_batch:
        batches = [half_masked(b) for b in batches]
    made = weights.make(ref.param_specs(cell.conf), seed, device)
    return ref.train(cell.conf, made, batches, cell.traffic["optimizer"], seed, precision)


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, with_trace: bool,
             device, tmp_dir: str, t_start: float) -> dict:
    """One run; the result line's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and ``checks`` last).
    ``t_start``: the process's start on ``time.perf_counter``'s clock."""
    device = torch.device(device)
    run = Training(cell, seed, device)
    stream = stream_of(cell, seed)
    prog = checked_steps(cell, seed, run, stream)
    release(device)           # set-up's freed blocks, so that they fragment nothing after
    setup_s = time.perf_counter() - t_start
    first = cell.traffic["checked_steps"]
    load = os.getloadavg() if hasattr(os, "getloadavg") else None
    win = window(run, stream, first, seconds)
    print(f"onchip_bench: window {step_times(win['step_s'])}; host load average "
          f"{load} before it, {os.getloadavg() if load else None} after; the card at its "
          f"close: {card_state() if device.type == 'cuda' else None}", file=sys.stderr,
          flush=True)
    stretch = None
    if with_trace:
        stretch = traced(run, stream, first + win["steps"], cell.traffic["traced_steps"],
                         tmp_dir)
    del run
    release(device)

    t = cell.traffic
    ctx = SimpleNamespace(
        conf=cell.conf, traffic=t, work=spec.module("work", cell.config), stretch=stretch,
        setup_s=setup_s, window=dict(win, tokens=win["steps"] * t["batch"] * t["seq_len"]))
    names = cell.per_layer if with_trace else cell.end_to_end
    metrics = {}
    for name in names:
        value = spec.module("metrics", name).read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}

    t_ref = time.perf_counter()
    ref = reference(cell, seed, device)
    found = check.gaps(prog, ref)
    correct, checks = check.judge(found, cell.limits)
    release(device)
    print(f"onchip_bench: reference {time.perf_counter() - t_ref:.1f} s; worst leaves: "
          f"gradient norm {found['grad_norm_leaf']}, gradient {found['grad_dist_leaf']}, "
          f"change {found['update_norm_leaf']}; "
          f"losses {prog['loss']} against {ref['loss']} (later steps' gaps "
          f"{found['loss_gaps'][1:]}, not held)", file=sys.stderr, flush=True)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": win["peak_bytes"]}
    result = {"correct": correct and win["failed"] == 0, "attempted": win["steps"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if stretch is not None:
        dev.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        result["breakdown"] = {"device_ops": stretch.device_ops, "idle_gaps": stretch.idle_gaps}
    result["checks"] = checks
    return result
