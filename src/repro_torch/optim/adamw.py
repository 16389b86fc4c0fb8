"""AdamW with a cosine schedule and global-norm clipping — the reference's
``optim/adamw.py`` in torch, on one device.

The state mirrors the parameter tree: m and v in float32, and a step count
(int32).  The math is float32 whatever the parameters' dtype.  Weight decay
applies to leaves of two dims or more, as the reference decides it: on the
stacked leaves, so a norm scale stacked to (repeats, d) is decayed too (the
reference does the same; this is parity, not a choice).  These are plain torch
ops: the reference has no kernel here.  ``opt_state_specs`` gives the
state's logical axes: the parameters', so that under the production rules the
state inherits their FSDP split over ``data`` (ZeRO-1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from .. import _tree


@dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptCfg, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``, float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params) -> dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = _tree.leaves(params)[0].device
    return {"m": _tree.map(zeros, params), "v": _tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs) -> dict[str, Any]:
    """Optimizer-state logical specs = parameter specs (ZeRO-1 via FSDP axes)."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum() for x in _tree.leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree.map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(grads, opt_state, params, cfg: OptCfg):
    """One AdamW step.  Grads may be any dtype; math in float32.  Returns
    (new_params, new_opt_state, metrics); nothing is updated in place."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"]
    lr = schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(p, g, m, v):
        gf = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if p.ndim >= 2:                    # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = _tree.map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "step": step + 1}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def fixed_by_gradients(grads, opt_state, params, cfg: OptCfg, grad_tol: float = 1e-5,
                       step_tol: float = 1e-4):
    """The tree of masks of the elements whose new value ``adamw_update``
    fixes to within ``step_tol`` of its leaf's largest new magnitude for
    every gradient within ``grad_tol`` of its leaf's largest |g|: moving
    every gradient to either end of that band moves such an element by no
    more.  An element whose gradient is exactly 0 is always kept.  Two
    devices whose gradients agree to ``grad_tol`` take one step at these
    elements.  Elsewhere the step is not fixed: the first step moves an
    element by lr g / (|g| + eps), so the band leaves its sign free where |g|
    lies within it, and near |g| = eps a small change of g moves it far."""
    new, lo, hi = (adamw_update(_tree.map(lambda g: g + end * grad_tol * g.abs().max(), grads),
                                opt_state, params, cfg)[0] for end in (0, -1, 1))
    return _tree.map(lambda g, p, a, b: ((b.float() - a.float()).abs()
                                         <= step_tol * p.float().abs().max()) | (g == 0),
                     grads, new, lo, hi)


def _pick(tree, i: int):
    """Item ``i`` of each (param, m, v) triple at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
