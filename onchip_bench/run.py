"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 onchip_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).  Runs on
the CUDA device and on nothing else: without one, or with fewer than the cell
asks for, it exits with a code other than 0 and prints no result.  So it does
where the port is missing, and where a module of JAX or of the JAX package
(``repro``) is loaded once the run is over.  The numbers that decide
``correct`` are printed beside their limits as the last lines of standard error
and under ``checks``, the result's last key.  The port's kernels are built
first, in a process of their own (``prebuild.py``); builds and caches go to
``build/`` inside the checkout, at fixed paths.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(code: int, msg: str) -> int:
    print(f"onchip_bench: {msg}", file=sys.stderr, flush=True)
    return code


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"not read: nvidia-smi exit {out.returncode}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build" / "onchip_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from onchip_bench import harness, spec

    torch.set_num_threads(1)        # one process with few threads: a steadier host

    try:
        cell = spec.resolve(spec.load_benchmark(ROOT), args.workload)
    except spec.MissingPiece as e:
        return _fail(2, str(e))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(3, f"{args.workload} needs {cell.chips} CUDA device(s), found {n}")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return _fail(4, f"the port is not in this checkout: {e}")
    # the kernels build in a process of their own, so that the timed one only
    # loads them (its set-up still counts the build's seconds)
    built = subprocess.run([sys.executable, str(ROOT / "onchip_bench" / "prebuild.py")],
                           cwd=ROOT, capture_output=True, text=True)
    if built.returncode != 0:
        sys.stderr.write(built.stderr[-4000:])
        return _fail(6, f"the port's kernels did not build (exit {built.returncode})")
    print(f"onchip_bench: prebuild {built.stdout.strip()}", file=sys.stderr, flush=True)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), tempfile.gettempdir(), T_START)
    from repro_torch.kernels import _build
    late = {k: v for k, v in _build.build_seconds.items() if v > 0}
    if late:
        print(f"onchip_bench: built in the timed process: {late}", file=sys.stderr)
    loaded = harness.forbidden_modules()
    if loaded:
        return _fail(5, f"modules of JAX or of the JAX package were loaded: {loaded}")
    result["device"]["power_limit"] = power_limit()
    print(f"onchip_bench: {result['device']['power_limit']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
