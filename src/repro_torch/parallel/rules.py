"""Divisibility-aware logical-axis -> mesh-axis rule assignment.

The production mesh is ``("data","model")=(16,16)`` per pod and
``("pod","data","model")=(2,16,16)`` across pods.  Policies:

  train    batch over (pod,data);  weights FSDP over data (embed dim) x TP
           over model (ff/heads/experts dims); optimizer state inherits
           (ZeRO-1).
  prefill  same activation sharding, no optimizer.
  decode   batch over (pod,data); KV caches sequence-sharded over model
           (flash-decode); small recurrent states batch-sharded.

Every mapping is validated against the actual dimension sizes of the config:
a logical axis whose dims do not divide the mesh-axis product falls back one
step (e.g. heads -> None for 28-head models on a 16-way model axis) instead
of failing at lowering time.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from ..configs.base import ModelCfg, ShapeCfg
from .api import Mesh, ShardingRules, mesh_axis_names, mesh_shape


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def _mesh_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return _prod(mesh_shape(mesh)[a] for a in axes)


def _fit(mesh: Mesh, axes, *dims: int):
    """axes if every dim divides the mesh-axis product, else None."""
    n = _mesh_size(mesh, axes)
    if all(d % n == 0 and d >= n for d in dims):
        return axes
    return None


def _head_dims(cfg: ModelCfg) -> list[int]:
    dims = []
    kinds = {k for s in cfg.segments for k in s.pattern} | {
        k for s in cfg.encoder_segments for k in s.pattern}
    if kinds & {"attn", "local_attn", "enc_attn", "cross_attn", "mla"}:
        dims.append(cfg.attn.n_heads)
    if "ssd" in kinds:
        dims.append(cfg.ssd.expand * cfg.d_model // cfg.ssd.headdim)
    if "rglru" in kinds and cfg.rglru.n_heads:
        dims.append(cfg.rglru.n_heads)
    return dims or [1]


def _ff_dims(cfg: ModelCfg) -> list[int]:
    dims = []
    if cfg.d_ff:
        dims.append(cfg.d_ff)
    if cfg.moe is not None and cfg.moe.n_shared:
        dims.append(cfg.moe.d_ff_shared or cfg.moe.n_shared * cfg.moe.d_ff_expert)
    kinds = {k for s in cfg.segments for k in s.pattern}
    if "rglru" in kinds:
        dr = cfg.rglru.d_rnn or cfg.d_model
        dims.append(dr)
    if "ssd" in kinds:
        d_inner = cfg.ssd.expand * cfg.d_model
        H = d_inner // cfg.ssd.headdim
        dims += [d_inner, d_inner + 2 * cfg.ssd.d_state,
                 2 * d_inner + 2 * cfg.ssd.d_state + H]
    return dims or [1]


def padded_vocab(cfg: ModelCfg) -> int:
    return cfg.padded_vocab


def rules_for(
    cfg: ModelCfg,
    mesh: Mesh,
    mode: str,                     # train | prefill | decode
    *,
    batch: Optional[int] = None,   # per-step batch (post-microbatching)
    pod_in_batch: bool = True,     # False under manual-pod shard_map
    moe_ep: bool = False,          # expert-parallel shard_map MoE dispatch
    seq_shard_fallback: bool = False,  # context-parallel attention when the
                                       # head count cannot shard over model
    embed_fsdp: bool = True,       # FSDP-shard the embed table's d dim
    flash_decode: bool = False,    # shard_map partial-softmax decode over
                                   # the sequence-sharded KV cache
) -> ShardingRules:
    names = mesh_axis_names(mesh)
    dp: tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
    if not pod_in_batch:
        dp = tuple(a for a in dp if a != "pod")
    mdl = "model" if "model" in names else None

    batch_ax = dp if (batch is None or _fit(mesh, dp, batch)) else (
        _fit(mesh, ("data",), batch) if "data" in names else None)

    heads_ax = _fit(mesh, mdl, *_head_dims(cfg)) if mdl else None
    kv_ax = _fit(mesh, mdl, cfg.attn.n_kv_heads) if mdl else None
    ff_ax = _fit(mesh, mdl, *_ff_dims(cfg)) if mdl else None
    vocab_ax = _fit(mesh, mdl, padded_vocab(cfg)) if mdl else None
    embed_ax = None
    if "data" in names:
        embed_ax = _fit(mesh, ("data",), cfg.d_model)   # FSDP shard of weights

    experts_ax = None
    ff_exp_ax = None
    if cfg.moe is not None and mdl:
        experts_ax = _fit(mesh, mdl, cfg.moe.n_routed)
        if experts_ax is None:
            ff_exp_ax = _fit(mesh, mdl, cfg.moe.d_ff_expert)  # TP inside experts

    # context parallelism: when attention heads cannot shard over the model
    # axis (e.g. 40 heads on a 16-way axis), shard the *sequence* dim of the
    # attention activations instead — otherwise attention replicates its
    # compute across the whole model axis.
    seq_ax = None
    if seq_shard_fallback and mdl and heads_ax is None and mode in ("train", "prefill"):
        seq_ax = mdl
        vocab_ax = None   # logits shard over seq instead (one axis per spec)

    rules = dict(
        batch=batch_ax,
        seq=seq_ax,
        act_embed=None,
        act_ff=None if seq_ax is not None else ff_ax,
        embed_tp=embed_ax,
        embed_gather=embed_ax if embed_fsdp else None,
        vocab=vocab_ax,
        heads=heads_ax,
        kv_heads=kv_ax,
        ff=ff_ax,
        ff2=None,
        ff_expert=ff_exp_ax,
        experts=experts_ax,
        layers=None,
        kv_seq=None,
        kv_heads_decode=None,
    )

    if mode == "decode":
        # sequence-sharded KV cache (flash-decode); the model axis holds the
        # long context, heads replicated for the (B,1,·) matmuls.
        rules.update(kv_seq=mdl, kv_heads_decode=None)

    if moe_ep and cfg.moe is not None:
        rules["_moe_ep"] = True
    if flash_decode and mode == "decode":
        rules["_flash_decode"] = True

    return ShardingRules(**rules)


def describe(rules: ShardingRules) -> str:
    return ", ".join(f"{k}->{v}" for k, v in sorted(rules.rules.items()) if v is not None)
