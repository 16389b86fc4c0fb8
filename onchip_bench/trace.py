"""The traced stretch of a ``--trace 1`` run: a few training steps under
``torch.profiler`` (CPU and CUDA activity), read back from its Chrome trace.

What is kept: each device kernel's name and duration inside the stretch, the
union of device activity (``busy_s``) against the stretch's wall time
(``window_s``, the span of the benchmark's own ``onchip_bench.stretch``
annotation), the kernels that took most time, and the idle gaps by what the host
was doing in them (the innermost host operation running at a gap's middle, on
any thread; the benchmark's own spans ``onchip_bench.step`` and
``onchip_bench.batch`` where no operation of the program runs).

The kernel families are a frozen copy of ``chip_smoke.step_shares``' name
patterns for the kernels a cell runs (K3, S2, K5, S3) (a template argument as the profiler may spell it: ``<true>`` or
``<(bool)1>``); ``CALL_MARKER`` names the one launch of each call of a family.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field

_S2 = ("flash_bwd_delta", "flash_bwd_dkdv_wgmma", "flash_bwd_dkdv_sum", "flash_bwd_dq_wgmma",
       "flash_bwd_dkdv", "flash_bwd_dq")
FAMILY_NAMES = {
    "s2": _S2,
    "k3": ("flash_bf16_wgmma", "flash_f32"),
    "k5": ("ssd_chunk_cb", r"ssd_chunk_state<(false|\(bool\)0)>", "ssd_state_pass",
           "ssd_chunk_scan"),
    "s3": (r"ssd_chunk_state<(true|\(bool\)1)>", r"ssd_bwd_\w+"),
}


def family_pattern(names) -> re.Pattern:
    return re.compile(rf"(?<!\w)(?:{'|'.join(names)})(?!\w)")


FAMILIES = {fam: family_pattern(names) for fam, names in FAMILY_NAMES.items()}
#: the launch that each call of a family makes exactly once
CALL_MARKER = {"k3": FAMILIES["k3"], "s2": family_pattern(("flash_bwd_delta",)),
               "k5": family_pattern(("ssd_chunk_cb",)), "s3": family_pattern(("ssd_bwd_ddA",))}

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH, STEP, BATCH = "onchip_bench.stretch", "onchip_bench.step", "onchip_bench.batch"
TOP = 10              # entries of each list of the breakdown


@dataclass
class Stretch:
    steps: int
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)       # (name, seconds) of each launch
    device_ops: list = field(default_factory=list)    # [name, seconds], most time first
    idle_gaps: list = field(default_factory=list)     # [host activity, seconds]


def profile_steps(run_steps, steps: int, tmp_dir: str) -> Stretch:
    """``run_steps(steps)`` under the profiler; ``run_steps`` synchronizes the
    device after each step.  The trace goes to a file in ``tmp_dir`` and is
    removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            run_steps(steps)
    fd, path = tempfile.mkstemp(prefix="onchip_bench_trace_", suffix=".json", dir=tmp_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return read_events(events, steps)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, points):
    """For each of the sorted ``points`` (µs), the name of the host event with the
    latest start among those running at it, or None."""
    bounds = sorted([(e["ts"], 1, i) for i, e in enumerate(host)]
                    + [(e["ts"] + e["dur"], 0, i) for i, e in enumerate(host)])
    active, k, out = set(), 0, []
    for p in points:
        while k < len(bounds) and bounds[k][0] <= p:
            _, opening, i = bounds[k]
            (active.add if opening else active.discard)(i)
            k += 1
        out.append(host[max(active, key=lambda i: host[i]["ts"])]["name"] if active else None)
    return out


def read_events(events: list, steps: int) -> Stretch:
    """The stretch's numbers from Chrome trace events (``ph`` "X")."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH]
    if not spans:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    t0 = spans[0]["ts"]
    t1 = t0 + spans[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in the traced stretch: "
                           "no device metric can be read from it")
    busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    kernels = [(e["name"], e["dur"] * 1e-6) for e in dev if e["cat"] == "kernel"]
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    device_ops = sorted(([n[:160], s] for n, s in by_name.items()), key=lambda x: -x[1])[:TOP]
    gaps = [(a, b) for a, b in zip([t0] + [b for _, b in busy], [a for a, _ in busy] + [t1])
            if b > a]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != STRETCH and "dur" in e]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    labels = _innermost(host, [m for m, _ in mids])
    by_label: dict = {}
    for (_, length), label in zip(mids, labels):
        label = (label or "host: outside any operation")[:160]
        by_label[label] = by_label.get(label, 0.0) + length * 1e-6
    idle = sorted(([n, s] for n, s in by_label.items()), key=lambda x: -x[1])[:TOP]
    return Stretch(steps=steps, window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
                   kernels=kernels, device_ops=device_ops, idle_gaps=idle)


def roofline_pct(stretch: Stretch, work: dict, families, flops_per_s: float,
                 bytes_per_s: float):
    """100 x the bound of the families' calls in the stretch over their device
    time: each call's bound is the larger of its operations at ``flops_per_s``
    and its bytes at ``bytes_per_s``, from ``work`` ({family: (operations,
    bytes)} of one call).  A reader calls it only in the cells whose path runs
    the families, so a family with no launch in the stretch, or none that marks
    a call, raises: a kernel renamed or taken off the path, whose share would
    otherwise drop out of sight or be read over the other family alone."""
    bound = seconds = 0.0
    for fam in families:
        launches = [(n, s) for n, s in stretch.kernels if FAMILIES[fam].search(n)]
        calls = sum(1 for n, _ in launches if CALL_MARKER[fam].search(n))
        if not calls:
            raise RuntimeError(
                f"the traced stretch holds {len(launches)} launches of {fam.upper()} "
                f"({FAMILIES[fam].pattern}) and no call ({CALL_MARKER[fam].pattern}): "
                f"its roofline cannot be read")
        ops, nbytes = work[fam]
        bound += calls * max(ops / flops_per_s, nbytes / bytes_per_s)
        seconds += sum(s for _, s in launches)
    return 100.0 * bound / seconds
