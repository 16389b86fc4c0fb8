"""Gated MLP (SwiGLU/GeGLU) and the MoE layer (shared + routed experts,
sort-based capacity dispatch).  The projections and the expert products are
plain (batched) matmuls, as the reference leaves its einsums to XLA.  The
expert-parallel ``moe_forward_ep`` comes with the mesh (ROADMAP.md queue A,
item 9); on one device ``moe_forward`` is the local dispatch."""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelCfg
from .common import act_fn, dense, ninit


# -- dense gated MLP ----------------------------------------------------------


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


# -- MoE -----------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelCfg):
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": ninit(gen, (d, m.n_routed), dtype=torch.float32),
        "w_gate": ninit(gen, (m.n_routed, d, m.d_ff_expert)),
        "w_up": ninit(gen, (m.n_routed, d, m.d_ff_expert)),
        "w_down": ninit(gen, (m.n_routed, m.d_ff_expert, d)),
    }
    if m.n_shared:
        f_sh = m.d_ff_shared or m.n_shared * m.d_ff_expert
        p["shared"] = {
            "w_gate": ninit(gen, (d, f_sh)),
            "w_up": ninit(gen, (d, f_sh)),
            "w_down": ninit(gen, (f_sh, d)),
        }
    return p


def moe_forward(p, x, cfg: ModelCfg):
    """Returns (y, aux_loss): the single-device dispatch below (the
    reference's expert-parallel path needs a mesh, ROADMAP.md queue A, item 9)."""
    return moe_forward_local(p, x, cfg)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("ecd,edf->ecf")`` with ``jnp.einsum``'s type promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.to(dt), b.to(dt))


def moe_forward_local(p, x, cfg: ModelCfg):
    """Sort-based dispatch (Megablocks-style, O(T·k) gathers + an (E,C,D)
    buffer — no (T,E,C) one-hot tensor): token-slots are sorted by expert id,
    each expert keeps its first C arrivals (capacity ``cf·T·k/E``), dropped
    slots fall through on the residual path.  Dropped slots all write the
    buffer's last (dump) row, which no read sees; the gate-weighted sum over
    tokens is an ``index_add_`` in float32 (atomic on the card, so its sums
    are not bitwise repeatable there)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    K = m.top_k
    E = m.n_routed
    xt = x.reshape(T, D)

    logits = dense(xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, K, dim=-1)                   # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    cap = max(1, int(-(-T * K * m.capacity_factor // E)))

    e_flat = idx.reshape(T * K)                                     # expert of each slot
    tok_flat = torch.arange(T, device=x.device).repeat_interleave(K)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = tok_flat[order]
    # position within the expert's queue: the slot's rank after its expert's
    # first (counts by index_add_: bincount would wait on the card for its size)
    counts = torch.zeros(E, dtype=e_sorted.dtype, device=x.device).index_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    seg_pos = torch.arange(T * K, device=x.device) - (torch.cumsum(counts, 0) - counts)[e_sorted]
    keep = seg_pos < cap
    slot = torch.where(keep, e_sorted * cap + seg_pos, E * cap)     # overflow -> dump row

    # scatter tokens into the expert buffer
    buf = xt.new_zeros((E * cap + 1, D))
    buf[slot] = xt[tok_sorted]
    xe = buf[:-1].reshape(E, cap, D)

    act = act_fn(cfg.act)
    h = act(_bmm(xe, p["w_gate"])) * _bmm(xe, p["w_up"])
    ye = _bmm(h, p["w_down"]).reshape(E * cap, D)
    ye = torch.cat([ye, ye.new_zeros((1, D))], dim=0)

    # combine: gather each slot's output back to its token, gate-weighted
    out_sorted = ye[slot]                                           # (T*K, D)
    gates_sorted = (gate_vals.reshape(T * K)[order] * keep).float()
    contrib = out_sorted.float() * gates_sorted[:, None]
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device).index_add_(
        0, tok_sorted, contrib).to(x.dtype)

    if m.n_shared:
        sh = p["shared"]
        hs = act(dense(xt, sh["w_gate"])) * dense(xt, sh["w_up"])
        y = y + dense(hs, sh["w_down"])

    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, e_flat, torch.full((T * K,), 1.0 / (T * K), device=x.device))
    aux = m.router_aux_coef * E * torch.sum(me * ce)
    return y.reshape(B, S, D), aux
