"""End-to-end driver: train a ~100M-parameter LM on the synthetic stream —
the PyTorch port's twin of ``examples/train_tinylm.py``.

Exercises the full training path on one device: config -> train step (on the
card the attention's forward and backward through the flash kernels K3 and
S2, in float32) -> AdamW + cosine -> async checkpointing -> fault-tolerant
restart (``--fail-at`` injects failures) -> seekable data pipeline.

Quick demo on the card (without ``--device`` it runs on the CUDA device and
raises where there is none):
    PYTHONPATH=src python examples/train_tinylm_torch.py --steps 40
On the CPU (a few minutes):
    PYTHONPATH=src python examples/train_tinylm_torch.py --steps 40 --device cpu
"""

import argparse
import math
import shutil
import tempfile

from repro_torch.configs.base import AttentionCfg, ModelCfg, Segment
from repro_torch.launch.train import SCRATCH, train
from repro_torch.models.transformer import param_count
from repro_torch.optim.adamw import OptCfg
from repro_torch.train.steps import init_train_state

# ~100M params: 10 layers, d=640, ff=2560, tied 32k vocab
TINYLM = ModelCfg(
    name="tinylm-100m",
    family="dense",
    d_model=640,
    vocab=32000,
    d_ff=2560,
    segments=(Segment(pattern=("attn",), repeats=10, ffn="mlp"),),
    attn=AttentionCfg(n_heads=10, n_kv_heads=5, d_head=64),
    tie_embeddings=True,
    dtype="float32",
    remat="none",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh one under build/, "
                         "removed at the end)")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (restart drill)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = TINYLM
    n = param_count(init_train_state(0, cfg, device=args.device)["params"])
    print(f"model: {cfg.name}  params={n / 1e6:.1f}M  device={args.device or 'cuda'}")
    losses = []

    def on_step(i, m):
        losses.append(m["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  acc {m['accuracy']:.3f}")

    scratch = None
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None:
        SCRATCH.mkdir(parents=True, exist_ok=True)
        ckpt_dir = scratch = tempfile.mkdtemp(prefix="tinylm-", dir=SCRATCH)
    try:
        run = train(cfg, OptCfg(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                                decay_steps=args.steps),
                    steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=ckpt_dir,
                    ckpt_every=max(10, args.steps // 5), fail_at=args.fail_at,
                    device=args.device, on_step=on_step)
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)

    report = run.report
    print(f"\ncompleted {report.steps_completed} steps, {report.restarts} restarts, "
          f"median step {run.monitor.median:.3f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(ppl {math.exp(min(20, losses[0])):.0f} -> {math.exp(min(20, losses[-1])):.0f})")
    assert losses[-1] < losses[0], "loss must decrease"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
