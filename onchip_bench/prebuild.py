"""Build the port's hand-written CUDA libraries ahead of a run, in a process of
their own.

    python3 onchip_bench/prebuild.py

``run.py`` runs this before its own process imports torch, so that the process
whose window is timed finds every library of ``src/repro_torch/csrc/*.cu``
built and only loads it.  The port's own builder does the work
(``repro_torch/kernels/_build.py``, loaded by its path: it needs the standard
library alone, and the package's ``__init__`` would import torch): the same
source text, flags and hash, into the same ``build/repro_torch/`` of the
checkout.  All libraries build side by side; a library already built is found
and not built again.  Prints one line: each library with its seconds in nvcc
(0.0 where it was found built).
"""

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILDER = ROOT / "src" / "repro_torch" / "kernels" / "_build.py"


def builder():
    """The port's ``_build`` module, loaded from its file."""
    spec = importlib.util.spec_from_file_location("onchip_bench_port_build", BUILDER)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclass looks its module up by name
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not BUILDER.is_file():
        print(f"prebuild: no {BUILDER.relative_to(ROOT)}", file=sys.stderr)
        return 4
    b = builder()
    pending = [b.start_build(*b.csrc_source(cu.name)) for cu in sorted(b.CSRC_DIR.glob("*.cu"))]
    for p in pending:
        b.finish_build(p)
    print(json.dumps({k: round(v, 3) for k, v in sorted(b.build_seconds.items())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
