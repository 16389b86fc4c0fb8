"""The readings that a cell's limits of correctness are set from, on the chip
(the benchmark's own runs never run this).

    python3 onchip_bench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2 \
        --out <file.json>

For each seed of ``--seeds``: the program's checked steps against the float32
reference (the lower readings).  For each seed of ``--control-seeds`` besides:
the control, the reference computed in fp8 in the program's place, and the
fault of a step that leaves half the batch out (the reference with its loss
over half the positions), each against the float32 reference (the upper
readings).  A state left unchanged reads 1 on ``update_norm_gap`` and needs no
run.  Each seed's row is written to ``--out`` as it is done.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _small(readings: dict) -> dict:
    """The readings without the gradient samples (too many numbers to keep)."""
    return {k: v for k, v in readings.items() if k != "grad_samples"}


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from onchip_bench import check, harness, spec

    if device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device(device)
    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        row = {"seed": seed}
        ref = harness.reference(cell, seed, dev)
        harness.release(dev)
        if seed in seeds:
            run = harness.Training(cell, seed, dev)
            prog = harness.checked_steps(cell, seed, run, harness.stream_of(cell, seed))
            del run
            harness.release(dev)
            row["program"] = check.gaps(prog, ref)
            row["readings"] = {"reference": _small(ref), "program": _small(prog)}
        if seed in controls:
            ctl = harness.reference(cell, seed, dev, "fp8")
            harness.release(dev)
            half = harness.reference(cell, seed, dev, half_batch=True)
            harness.release(dev)
            row["control_fp8"], row["half_batch"] = check.gaps(ctl, ref), check.gaps(half, ref)
            row.setdefault("readings", {"reference": _small(ref)}).update(
                control_fp8=_small(ctl), half_batch=_small(half))
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "readings"}), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": cell.name, "rows": rows}, indent=1))
    summary = {}
    for n in check.NUMBERS:
        summary[n] = {
            "program_max": max((r["program"][n] for r in rows if "program" in r), default=None),
            "control_min": min((r["control_fp8"][n] for r in rows if "control_fp8" in r),
                               default=None),
            "half_batch_min": min((r["half_batch"][n] for r in rows if "half_batch" in r),
                                  default=None)}
    Path(args.out).write_text(json.dumps({"workload": cell.name, "rows": rows,
                                          "summary": summary}, indent=1))
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
