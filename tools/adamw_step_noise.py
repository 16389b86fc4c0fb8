"""Which elements of AdamW's first step a 1e-5 gradient check fixes, on the CPU.

For each arch's smoke config (every leaf float32, seed 0, 4 x 64 tokens) the
gradients are taken in float32 and in float64 (rounded to float32), and AdamW's
first step (lr 3e-4, warmup 2) is taken on each.  The two steps are compared,
each parameter leaf at 1e-4 of its largest magnitude, over three sets of
elements: all of them; those whose gradient's sign the check fixes (|g| above
1e-5 of the leaf's largest |g|); and those ``adamw.fixed_by_gradients`` keeps.
One line an arch: the worst error over the leaf's largest magnitude in each
set, with its leaf, and the count each rule leaves out.  An arch whose model
does not run in float64 is named and skipped.

    PYTHONPATH=src python tools/adamw_step_noise.py [arch ...]
"""

from __future__ import annotations

import sys

import torch

from repro_torch import _tree
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.data.pipeline import make_batch
from repro_torch.optim.adamw import OptCfg, adamw_update, fixed_by_gradients
from repro_torch.train.steps import init_train_state, make_grad_fn

OPT = OptCfg(lr=3e-4, warmup_steps=2, decay_steps=8)


def study(arch: str) -> str:
    cfg = get_smoke_config(arch)
    state = _tree.map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                      init_train_state(0, cfg, device="cpu"))
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch(cfg, ShapeCfg("t", seq_len=64, global_batch=4, kind="train")).items()}
    grad_fn = make_grad_fn(cfg)
    _, _, g32 = grad_fn(state["params"], batch)
    try:
        _, _, g64 = grad_fn(_tree.map(lambda t: t.double() if t.is_floating_point() else t,
                                      state["params"]), batch)
    except RuntimeError as e:
        return f"{arch}: skipped, its model does not run in float64 ({str(e)[:60]})"
    a, b = (adamw_update(g, state["opt"], state["params"], OPT)[0]
            for g in (g32, _tree.map(lambda t: t.float(), g64)))
    fixed = _tree.with_paths(fixed_by_gradients(g32, state["opt"], state["params"], OPT))
    worst = {rule: (0.0, "") for rule in ("all", "sign", "fixed")}
    out = {"sign": 0, "fixed": 0}
    n_all = 0
    g32, b = _tree.with_paths(g32), _tree.with_paths(b)
    for key, pa in _tree.with_paths(a).items():
        scale = float(pa.abs().max())
        if not scale:
            continue
        err = (pa - b[key]).abs() / scale
        g = g32[key]
        keep = {"all": torch.ones_like(g, dtype=torch.bool),
                "sign": g.abs() > 1e-5 * g.abs().max(), "fixed": fixed[key]}
        for rule, mask in keep.items():
            e = float((err * mask).max())
            if e > worst[rule][0]:
                worst[rule] = (e, key)
        out["sign"] += int((~keep["sign"]).sum())
        out["fixed"] += int((~keep["fixed"]).sum())
        n_all += g.numel()
    return (f"{arch}: {n_all} elements; worst step error over max: all {worst['all'][0]:.3e} "
            f"({worst['all'][1]}); sign rule {worst['sign'][0]:.3e} ({worst['sign'][1]}, "
            f"{out['sign']} left out); fixed_by_gradients {worst['fixed'][0]:.3e} "
            f"({worst['fixed'][1]}, {out['fixed']} left out)")


def main() -> None:
    for arch in sys.argv[1:] or list_archs():
        print(study(arch), flush=True)


if __name__ == "__main__":
    main()
