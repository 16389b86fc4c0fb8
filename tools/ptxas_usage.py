"""Registers, shared memory and spills of each kernel in the port's CUDA
sources, as ``ptxas -v`` reports them for the flags the port builds with.

Needs ``nvcc`` (the machine with the card).  Compiles each source (headers
spliced, as the build does) to a throwaway object under ``build/`` and prints
one JSON line per kernel:
``{"source", "kernel", "registers", "spill_stores", "spill_loads", "stack",
"shared"}``.

A name is a source in ``csrc/``; a path to an existing file is taken as it
is, such as a generated source the build left in ``build/repro_torch/``
(``rtlsim_*.cu``, ``hir_*.cu``).

Run:  PYTHONPATH=src python tools/ptxas_usage.py [flash_attention.cu ...]
      PYTHONPATH=src python tools/ptxas_usage.py build/repro_torch/rtlsim_gemm_*.cu
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build

DEFAULT = ["flash_attention.cu", "decode_attention.cu"]


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return out.stdout.splitlines() if out.returncode == 0 else names


def usage(filename: str) -> list[dict]:
    path = Path(filename)
    stem, text = (path.stem, path.read_text()) if path.is_file() else _build.csrc_source(filename)
    out = _build.build_dir() / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{stem}.cu"
    cu.write_text(text)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",)]
    proc = subprocess.run([_build.find_nvcc(), *flags, "-c", "-Xptxas", "-v", "-o",
                           str(out / f"{stem}.o"), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {filename}:\n{proc.stdout}{proc.stderr}")
    rows, current = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = {"source": filename, "kernel": m.group(1)}
            rows.append(current)
        elif current is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
                s = re.search(r"(\d+) bytes smem", line)
                current["shared"] = int(s.group(1)) if s else 0
    for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def main() -> None:
    for filename in sys.argv[1:] or DEFAULT:
        for row in usage(filename):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
