"""Gated MLP (SwiGLU/GeGLU) and the MoE layer (shared + routed experts,
sort-based capacity dispatch — EP-shardable: the expert dim maps to the
``experts`` logical axis).  The projections and the expert products are
plain (batched) matmuls, as the reference leaves its einsums to XLA.  Under
sharding rules with ``_moe_ep`` on a mesh, ``moe_forward`` runs the
expert-parallel ``moe_forward_ep`` on each rank; otherwise the local
dispatch."""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelCfg
from ..parallel.api import (all_gather, axis_index, current_mesh, current_rules, local_slice,
                            mesh_axis_names, mesh_shape, pmean, psum)
from .common import act_fn, dense, ninit


# -- dense gated MLP ----------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelCfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ninit(gen, (d, f)),
        "w_up": ninit(gen, (d, f)),
        "w_down": ninit(gen, (f, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def specs_mlp():
    return {"w_gate": ("embed_tp", "ff"), "w_up": ("embed_tp", "ff"), "w_down": ("ff", "embed_tp")}


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


def specs_moe(cfg: ModelCfg):
    p = {
        "router": ("embed_tp", None),
        "w_gate": ("experts", "embed_tp", "ff_expert"),
        "w_up": ("experts", "embed_tp", "ff_expert"),
        "w_down": ("experts", "ff_expert", "embed_tp"),
    }
    if cfg.moe.n_shared:
        p["shared"] = {"w_gate": ("embed_tp", "ff"), "w_up": ("embed_tp", "ff"),
                       "w_down": ("ff", "embed_tp")}
    return p


def moe_forward(p, x, cfg: ModelCfg):
    """Returns (y, aux_loss).  Dispatches to the expert-parallel path when
    the active sharding rules enable it (``_moe_ep``); otherwise runs the
    single-shard sort-based dispatch below.

    On a mesh, ``x`` is this rank's slice of the batch over the dp axes (a
    rank holds local tensors) and ``p`` the whole parameters, as the port's
    model holds them: each rank takes its shard of ``p`` (``moe_ep_params``)
    and runs ``moe_forward_ep``, whose FSDP gathers restore what the slice
    over ``data`` took.  The reference's condition that the dp axes divide
    the global batch holds of a batch already split over them."""
    rules = current_rules()
    mesh = current_mesh()
    if rules is not None and mesh is not None and rules.rules.get("_moe_ep"):
        dp = tuple(a for a in ("pod", "data") if a in mesh_axis_names(mesh))
        _, shard_experts, shard_ff, mdl = _ep_layout(cfg, mesh)
        if dp and (mdl is None or shard_experts or shard_ff):
            return moe_forward_ep(moe_ep_params(p, cfg, mesh), x, cfg, mesh, dp)
    return moe_forward_local(p, x, cfg)


def _map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a tree whose leaves are spec tuples."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    return fn(specs, *rest)


def _ep_layout(cfg: ModelCfg, mesh):
    """(specs, shard_experts, shard_ff, model axis) of the EP path: the
    expert dim over ``model`` when it divides, else the expert FF dim."""
    m = cfg.moe
    mdl = "model" if "model" in mesh_axis_names(mesh) else None
    n_model = mesh_shape(mesh).get("model", 1)
    shard_experts = mdl is not None and m.n_routed % n_model == 0
    shard_ff = mdl is not None and not shard_experts and m.d_ff_expert % n_model == 0
    specs = specs_moe(cfg)
    if not shard_experts:
        # expert dim replicates; TP moves inside each expert (ff_expert)
        specs = _map_specs(lambda t: tuple((None if ax == "experts" else ax) for ax in t), specs)
    return specs, shard_experts, shard_ff, mdl


def moe_ep_specs(cfg: ModelCfg, mesh):
    """The mesh axes each MoE parameter is split over on the EP path under
    the current rules (the reference's ``in_specs`` of its full-manual
    shard_map)."""
    rules = current_rules()
    specs, shard_experts, shard_ff, mdl = _ep_layout(cfg, mesh)
    manual = set(mesh_axis_names(mesh))

    def resolve_manual(t):
        axes = []
        for ax in t:
            mm = rules.rules.get(ax) if ax else None
            if ax == "experts" and shard_experts:
                mm = mdl
            if ax == "ff_expert" and shard_ff:
                mm = mdl
            if isinstance(mm, str):
                mm = (mm,)
            keep = tuple(a for a in (mm or ()) if a in manual)
            axes.append(keep if len(keep) > 1 else (keep[0] if keep else None))
        return tuple(axes)

    return _map_specs(resolve_manual, specs)


def moe_ep_params(p, cfg: ModelCfg, mesh):
    """This rank's shard of whole MoE parameters under ``moe_ep_specs``
    (views: the gradient reaches the whole tensors)."""
    return _map_specs(lambda t, w: local_slice(w, t, mesh), moe_ep_specs(cfg, mesh), p)


def moe_forward_ep(p, x, cfg: ModelCfg, mesh, dp_axes):
    """Expert-parallel MoE, the body of the reference's *full-manual*
    shard_map, on each rank over its shards (``p`` split by
    ``moe_ep_specs``, ``x`` this rank's tokens):

      * tokens stay sharded over the dp axes — each rank routes only its
        local tokens;
      * experts shard over ``model`` (E % model == 0: each rank dispatches
        into its own expert range and the per-token outputs combine with one
        sum); otherwise the expert FF dim shards over ``model`` (TP inside
        every expert, same single sum);
      * FSDP weight gathering is explicit (all_gather over ``data``; the
        backward reduce-scatters).
    The collectives' backwards are their transposes, so the gradient of the
    sum of every rank's loss reaches each rank's shards.  The aux loss is
    the mean over the dp axes of each rank's statistics."""
    m = cfg.moe
    rules = current_rules()
    specs, shard_experts, shard_ff, mdl = _ep_layout(cfg, mesh)

    def gather_fsdp(t, w):
        for dim, ax in enumerate(t):
            mm = rules.rules.get(ax) if ax else None
            if isinstance(mm, str):
                mm = (mm,)
            for a in (mm or ()):
                if a in ("data", "pod"):
                    w = all_gather(w, a, axis=dim, tiled=True, mesh=mesh)
        return w

    pl = _map_specs(gather_fsdp, specs, p)
    if shard_experts:
        e_local = m.n_routed // mesh_shape(mesh)["model"]
        e_off = axis_index(mdl, mesh) * e_local
        y, aux = _moe_compute(pl, x, cfg, e_off=e_off, e_local=e_local)
    else:
        y, aux = _moe_compute(pl, x, cfg, e_off=0, e_local=m.n_routed)
    if mdl is not None and (shard_experts or shard_ff):
        y = psum(y, mdl, mesh)
    for a in dp_axes:
        aux = pmean(aux, a, mesh)
    return y, aux


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
    return _moe_compute(p, x, cfg, e_off=0, e_local=cfg.moe.n_routed)


def _moe_compute(p, x, cfg: ModelCfg, *, e_off, e_local: int):
    """Sort-based dispatch restricted to the local expert range
    [e_off, e_off + e_local); expert weights ``p`` hold only that range (or
    an ff-slice of all experts, whose partial outputs the caller sums over
    the model axis).  Shared experts are ff-sharded alongside.  Over all E
    experts it is ``moe_forward_local``."""
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
    e_rel = e_sorted - e_off
    keep = (seg_pos < cap) & (e_rel >= 0) & (e_rel < e_local)
    slot = torch.where(keep, e_rel * cap + seg_pos, e_local * cap)  # overflow -> dump row

    # scatter tokens into the expert buffer
    buf = xt.new_zeros((e_local * cap + 1, D))
    buf[slot] = xt[tok_sorted]
    xe = buf[:-1].reshape(e_local, cap, D)

    act = act_fn(cfg.act)
    h = act(_bmm(xe, p["w_gate"])) * _bmm(xe, p["w_up"])
    ye = _bmm(h, p["w_down"]).reshape(e_local * cap, D)
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
