"""Batched serving example of the PyTorch/CUDA port: continuous batching
over decode slots, the twin of ``examples/serve_batched.py``.

Serves synthetic requests against a smoke-scale model using the port's
serving engine (per-lane cache positions; wave refill for recurrent archs),
with the same defaults as the JAX example.  Without ``--device`` it runs on
the CUDA device (every decode step through the decode-attention kernel) and
raises where there is none; ``--device cpu`` runs the kernels' plain
versions.

    PYTHONPATH=src python examples/serve_batched_torch.py              (on the card)
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
    PYTHONPATH=src python examples/serve_batched_torch.py --arch mamba2-780m --device cpu
"""

import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    defaults = ["--smoke", "--requests", "10", "--slots", "4",
                "--max-new", "12", "--prompt-len", "6", "--max-len", "96"]
    if not any(a.startswith("--arch") for a in argv):
        defaults = ["--arch", "tinyllama-1.1b"] + defaults
    return serve_main(defaults + argv)


if __name__ == "__main__":
    raise SystemExit(main())
