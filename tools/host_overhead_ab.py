"""Seconds a train step and tokens/s of the serving loop, on the card, for
the ``repro_torch`` of a given checkout: run it on two checkouts in turn
(A, B, B, A ...) inside one call to the card, so that both share its host,
to compare their per-call host work.

    python tools/host_overhead_ab.py [--src DIR] [--label NAME]

``DIR`` is the ``src`` directory to import ``repro_torch`` from (default:
this checkout's).  The work is ``chip_smoke.py``'s ``train`` and ``serve``
lines without their checks: tinyllama-1.1b whole in bfloat16 with remat,
8 AdamW steps of 4 x 2048 tokens, each timed on the host clock up to a
synchronize (the median of steps 2-7 is kept); then the ``Engine`` at full
width, 4 slots x 1024, serving 8 requests of 64 + 32 tokens, twice, each
on a fresh engine (the second is kept: K4 is built and warm).  Prints one
JSON line with the card's name and power limit.  Imports neither jax nor the reference.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import Engine, make_requests, serve_requests
    from repro_torch.optim.adamw import OptCfg
    from repro_torch.train.steps import init_train_state, make_train_step

    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(Path(args.src).resolve())
    dev = torch.device("cuda", 0)
    cfg = get_config("tinyllama-1.1b")

    step = make_train_step(cfg, OptCfg(lr=3e-4, warmup_steps=2, decay_steps=8), device=dev)
    state = init_train_state(0, cfg, device=dev)
    shape = ShapeCfg("train", 2048, 4, "train")
    times = []
    for i in range(8):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in make_batch(cfg, shape, step=i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del state, step
    torch.cuda.empty_cache()

    serves = []
    for _ in range(2):
        eng = Engine(cfg, 4, 1024, device=dev)
        queue = make_requests(8, 64, 32, cfg.vocab, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, _ = serve_requests(eng, queue)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tokens = sum(len(r.out) for r in done)
        serves.append({"seconds": secs, "tokens_per_s": tokens / secs,
                       "ms_per_decode_call": secs * 1e3 / eng.decode_calls})
        del eng
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"label": args.label, "card": smi.strip(),
                      "step_seconds": times,
                      "step_seconds_median_2_7": statistics.median(times[2:]),
                      "serve": serves}), flush=True)


if __name__ == "__main__":
    main()
