"""Gated MLP (SwiGLU/GeGLU).  The MoE layer is not ported yet (ROADMAP.md
queue A, item 6).  The projections are plain matmuls, as the reference
leaves its einsums to XLA."""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelCfg
from .common import act_fn, dense, ninit


def init_mlp(gen: torch.Generator, cfg: ModelCfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ninit(gen, (d, f)),
        "w_up": ninit(gen, (d, f)),
        "w_down": ninit(gen, (f, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def mlp_forward(p, x, cfg: ModelCfg):
    act = act_fn(cfg.act)
    h = act(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    return dense(h, p["w_down"])
