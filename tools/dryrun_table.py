"""The dry-run's records as one Markdown table: a row an (arch x shape), the
single-pod (256 ranks) and multi-pod (512) figures side by side.

Reads the JSON records that ``python -m repro_torch.launch.dryrun --all
--mesh both`` writes (``artifacts/dryrun_torch/`` by default) and prints,
per chip: FLOPs, bytes, collective bytes, the bottleneck and the H100 bound
in seconds, ``useful_flops_frac`` and ``peak_bytes`` (GB), with each cell's
trace seconds summed at the end.  With ``--reference DIR``, the records of
the JAX package's own dry-run (``python -m repro.launch.dryrun --all --mesh
both --out DIR``; JSON only, nothing of it is imported) add a column: each
chip's FLOPs, the port's over the reference's, single and multi-pod.

Run:  PYTHONPATH=src python tools/dryrun_table.py [records_dir] [--reference DIR]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import ARTIFACTS


def cell(rec: dict) -> str:
    if rec["status"] != "ok":
        return rec["status"]
    c, r = rec["cost"], rec["roofline"]
    return (f"{c['flops_per_chip']:.3g} / {c['bytes_per_chip']:.3g} / "
            f"{rec['collectives']['operand_bytes']:.3g} / {r['bottleneck'][:4]} "
            f"{r['bound_step_time_s']:.3g} s / {rec['useful_flops_frac']:.2f} / "
            f"{rec['memory']['peak_bytes'] / 1e9:.1f}")


def records(root: Path) -> dict:
    """The plain (no ``--opt``) records under ``root``, by (arch, shape, mesh)."""
    recs = {}
    for f in sorted(root.glob("*.json")):
        rec = json.loads(f.read_text())
        if "opts" not in rec:
            recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return recs


def ratio(port: dict, ref: dict) -> str:
    if not port or not ref or port["status"] != "ok" or ref["status"] != "ok":
        return "–"
    return f"{port['cost']['flops_per_chip'] / ref['cost']['flops_per_chip']:.3f}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ref_root = None
    if "--reference" in argv:
        i = argv.index("--reference")
        ref_root, argv = Path(argv[i + 1]), argv[:i] + argv[i + 2:]
    root = Path(argv[0]) if argv else ARTIFACTS
    recs = records(root)
    refs = records(ref_root) if ref_root else None
    head = ("| arch × shape | single pod, 256: FLOPs / bytes / coll. bytes / bound / useful / "
            "peak GB | multi-pod, 512: the same |")
    print(head + (" FLOPs a chip, port / reference |" if refs else ""))
    print("|---|---|---|" + ("---|" if refs else ""))
    seconds, n_ok, n_err = 0.0, 0, 0
    for arch in sorted({k[0] for k in recs}):
        for shape in SHAPES:
            pair = [recs.get((arch, shape, m)) for m in ("single", "multi")]
            if all(p is None or p["status"] == "skipped" for p in pair):
                continue
            for p in pair:
                if p is not None:
                    seconds += p.get("trace_s", 0.0)
                    n_ok += p["status"] == "ok"
                    n_err += p["status"] == "error"
            row = f"| {arch} × {shape} | " + " | ".join(cell(p) if p else "not run"
                                                       for p in pair) + " |"
            if refs is not None:
                row += " " + ", ".join(ratio(p, refs.get((arch, shape, m)))
                                       for p, m in zip(pair, ("single", "multi"))) + " |"
            print(row)
    print(f"\n{n_ok} cells ok, {n_err} errors; {seconds:.1f} s of traces")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
