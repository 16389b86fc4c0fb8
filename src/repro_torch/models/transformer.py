"""Layer stacks and the unified language model.

A model is ``embed -> [segments] -> final norm -> lm head``.  Each segment is
a *pattern* of block kinds repeated ``repeats`` times.  Parameters keep the
reference's tree: ``segments[i][pos]`` leaves have a leading ``repeats`` dim,
and the reference's ``lax.scan`` over the repeats is a Python loop over it.

Block kinds (configs.base.Segment.pattern):
    attn        causal GQA self-attention (+RoPE)
    local_attn  sliding-window GQA (window = cfg.attn.window), ring-buffer cache
    enc_attn    bidirectional GQA (encoder stacks)
    cross_attn  gated cross-attention to a memory (VLM image layers /
                enc-dec decoder)
    mla         multi-head latent attention (DeepSeek-V2)
    rglru       RG-LRU recurrent block (Griffin)
    ssd         Mamba-2 SSD mixer
each pre-norm residual, followed by an ``mlp`` or ``moe`` ffn with its own
pre-norm residual, or by none (``"none"``: no ``ln2``).  A ``moe`` ffn adds
its load-balancing loss to the forward's aux sum; a decode step drops it.
A ``cross_attn`` block scales its attention and its ffn by tanh of its own
scalar gates.  The memory of cross-attention is the modality frontend's
embeddings (``batch["frontend_embeds"]``, projected to d_model where their
width differs), run through the encoder stack where the model has one.
``cfg.attn.logit_softcap`` caps the attention scores of every kind that
attends but MLA, which ignores it as the reference's does.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils.checkpoint

from .._device import resolve_device
from ..configs.base import ModelCfg, Segment
from . import attention, mla, mlp, rglru, ssd
from ..parallel.api import (DTensor, Partial, Replicate, from_local, local_positions, on_split,
                            shard)
from .common import dense, dtype_of, init_norm, ninit, rms_norm, softcap, specs_norm

MIXER_KINDS = ("attn", "local_attn", "enc_attn", "cross_attn", "mla", "rglru", "ssd")
FFN_KINDS = ("mlp", "moe", "none")


def _check_kind(kind: str, ffn: str) -> None:
    if kind not in MIXER_KINDS or ffn not in FFN_KINDS:
        raise ValueError(f"block kind {kind!r} with ffn {ffn!r}: the kinds are {MIXER_KINDS}, "
                         f"the ffns {FFN_KINDS}")


def _check_cfg(cfg: ModelCfg) -> None:
    """Refuses a block kind or ffn the port does not know."""
    for seg in cfg.segments + cfg.encoder_segments:
        for pos, kind in enumerate(seg.pattern):
            _check_kind(kind, seg.ffn_at(pos))


def _stack(trees: list):
    """One tree whose leaves stack the trees' leaves.  Each leaf leaves its
    tree as it is stacked, so the layers' own copies are freed leaf by leaf
    (peak memory: the model and one stacked leaf, not the model twice)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    return torch.stack(trees)


def _layers(params: list, repeats: int) -> list:
    """Each repeat's parameters of a segment's stacked tree: views
    (``_take``), or for ``DTensor`` leaves (a dry-run's) the leaves unbound
    once, whose backward stacks the layers' gradients, where a view's
    backward would zero a tensor of the whole stack for each layer."""
    def unbind(tree):
        if isinstance(tree, dict):
            parts = {k: unbind(v) for k, v in tree.items()}
            return [{k: v[r] for k, v in parts.items()} for r in range(repeats)]
        return tree.unbind(0)

    first = params[0]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    if not isinstance(first, DTensor):
        return [[_take(p, r) for p in params] for r in range(repeats)]
    per_pos = [unbind(p) for p in params]
    return [[pos[r] for pos in per_pos] for r in range(repeats)]


def _take(tree, r: int):
    """Layer ``r`` of a stacked tree: views, so in-place writes reach the stack."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# single block (mixer + ffn)
# ---------------------------------------------------------------------------


def _window(kind: str, cfg: ModelCfg):
    return cfg.attn.window if kind == "local_attn" else None


def _init_mixer(gen: torch.Generator, kind: str, cfg: ModelCfg):
    if kind in ("attn", "local_attn", "enc_attn"):
        return attention.init_attn(gen, cfg)
    if kind == "cross_attn":
        p = attention.init_attn(gen, cfg, cross=True)
        # tanh-gated (llama3.2-v): zero at init, as the reference makes them
        p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=gen.device)
        p["gate_ffn"] = torch.zeros((), dtype=torch.float32, device=gen.device)
        return p
    if kind == "mla":
        return mla.init_mla(gen, cfg)
    if kind == "rglru":
        return rglru.init_rglru(gen, cfg)
    return ssd.init_ssd(gen, cfg)


def init_block(gen: torch.Generator, kind: str, ffn: str, cfg: ModelCfg):
    _check_kind(kind, ffn)
    p: dict[str, Any] = {"ln1": init_norm(cfg.d_model, gen.device),
                         "mixer": _init_mixer(gen, kind, cfg)}
    if ffn == "mlp":
        p["ln2"] = init_norm(cfg.d_model, gen.device)
        p["ffn"] = mlp.init_mlp(gen, cfg)
    elif ffn == "moe":
        p["ln2"] = init_norm(cfg.d_model, gen.device)
        p["ffn"] = mlp.init_moe(gen, cfg)
    return p


def _specs_mixer(kind: str, cfg: ModelCfg):
    if kind in ("attn", "local_attn", "enc_attn"):
        return attention.specs_attn(cfg)
    if kind == "cross_attn":
        p = attention.specs_attn(cfg, cross=True)
        p["gate_attn"] = ()
        p["gate_ffn"] = ()
        return p
    if kind == "mla":
        return mla.specs_mla(cfg)
    if kind == "rglru":
        return rglru.specs_rglru(cfg)
    if kind == "ssd":
        return ssd.specs_ssd(cfg)
    raise ValueError(kind)


def specs_block(kind: str, ffn: str, cfg: ModelCfg):
    """The logical axes of each of the block's parameters (one per dim)."""
    p: dict[str, Any] = {"ln1": specs_norm(), "mixer": _specs_mixer(kind, cfg)}
    if ffn == "mlp":
        p["ln2"] = specs_norm()
        p["ffn"] = mlp.specs_mlp()
    elif ffn == "moe":
        p["ln2"] = specs_norm()
        p["ffn"] = mlp.specs_moe(cfg)
    return p


def _gate(p, kind: str, name: str, y):
    """A cross block scales its attention and its ffn by tanh of its gates."""
    if kind != "cross_attn":
        return y
    return torch.tanh(p["mixer"][name]).to(y.dtype) * y


def _residual(y):
    """A branch's output as the residual stream holds it (``act_embed``):
    on a mesh, the sum over the model axis of a row-parallel product's
    partials happens here, where the branch joins the stream."""
    return shard(y, "batch", "seq", "act_embed")


def _ffn(p, x, kind: str, ffn: str, cfg: ModelCfg):
    """The ffn's pre-norm residual.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, aux
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    if ffn == "mlp":
        f = mlp.mlp_forward(p["ffn"], h, cfg)
    else:
        f, aux = mlp.moe_forward(p["ffn"], h, cfg)
    return x + _residual(_gate(p, kind, "gate_ffn", f)), aux


def block_forward(p, x, kind: str, ffn: str, cfg: ModelCfg, *, positions=None, memory=None,
                  causal=True):
    """One block forward.  Returns (x, aux_loss)."""
    _check_kind(kind, ffn)
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    if kind in ("attn", "local_attn"):
        m = attention.attn_forward(p["mixer"], h, cfg, positions=positions,
                                   window=_window(kind, cfg), causal=causal)
    elif kind == "enc_attn":
        m = attention.attn_forward(p["mixer"], h, cfg, positions=positions, causal=False)
    elif kind == "cross_attn":
        m = _gate(p, kind, "gate_attn", attention.attn_forward(p["mixer"], h, cfg, kv=memory))
    elif kind == "mla":
        # the reference's switch to its absorbed, chunked form; on the card
        # both branches run K3 (mla_forward_chunked calls mla_forward there)
        if x.shape[1] >= 4096:
            m = mla.mla_forward_chunked(p["mixer"], h, cfg, positions=positions)
        else:
            m = mla.mla_forward(p["mixer"], h, cfg, positions=positions)
    elif kind == "rglru":
        m = rglru.rglru_forward(p["mixer"], h, cfg)
    else:
        m = ssd.ssd_forward(p["mixer"], h, cfg)
    return _ffn(p, x + _residual(m), kind, ffn, cfg)


def init_block_cache(kind: str, batch: int, seq_len: int, cfg: ModelCfg, device=None):
    if kind in ("attn", "local_attn", "enc_attn"):
        return attention.init_attn_cache(batch, seq_len, cfg, window=_window(kind, cfg),
                                         device=device)
    if kind == "cross_attn":
        # precomputed memory K/V of cfg.frontend_tokens positions (filled by
        # lm_prepare_decode_cache)
        a = cfg.attn
        shape = (batch, cfg.frontend_tokens, a.n_kv_heads, a.d_head)
        dt = dtype_of(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "mla":
        return mla.init_mla_cache(batch, seq_len, cfg, device=device)
    if kind == "rglru":
        return rglru.init_rglru_cache(batch, cfg, device=device)
    return ssd.init_ssd_cache(batch, cfg, device=device)


def specs_block_cache(kind: str, cfg: ModelCfg):
    if kind in ("attn", "enc_attn"):
        return attention.specs_attn_cache()
    if kind == "local_attn":
        return attention.specs_attn_cache(window=cfg.attn.window)
    if kind == "cross_attn":
        return {"k": ("batch", None, "kv_heads_decode", None),
                "v": ("batch", None, "kv_heads_decode", None)}
    if kind == "mla":
        return mla.specs_mla_cache()
    if kind == "rglru":
        return rglru.specs_rglru_cache()
    if kind == "ssd":
        return ssd.specs_ssd_cache()
    raise ValueError(kind)


def block_decode_step(p, x1, cache, index, kind: str, ffn: str, cfg: ModelCfg):
    _check_kind(kind, ffn)
    h = rms_norm(x1, p["ln1"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    if kind in ("attn", "local_attn", "enc_attn"):
        m, cache = attention.attn_decode_step(p["mixer"], h, cache, index, cfg,
                                              window=_window(kind, cfg))
    elif kind == "cross_attn":
        m = _gate(p, kind, "gate_attn",
                  attention.cross_attn_decode(p["mixer"], h, cache["k"], cache["v"], cfg))
    elif kind == "mla":
        m, cache = mla.mla_decode_step(p["mixer"], h, cache, index, cfg)
    elif kind == "rglru":
        m, cache = rglru.rglru_decode_step(p["mixer"], h, cache, cfg)
    else:
        m, cache = ssd.ssd_decode_step(p["mixer"], h, cache, cfg)
    x1, _ = _ffn(p, x1 + _residual(m), kind, ffn, cfg)
    return x1, cache


# ---------------------------------------------------------------------------
# segment = pattern x repeats, looped over stacked params
# ---------------------------------------------------------------------------


def init_segment(gen: torch.Generator, seg: Segment, cfg: ModelCfg):
    """Params for one segment: per pattern-position, a tree whose leaves
    have a leading ``repeats`` dim."""
    return [_stack([init_block(gen, kind, seg.ffn_at(pos), cfg) for _ in range(seg.repeats)])
            for pos, kind in enumerate(seg.pattern)]


def _with_layers(specs):
    """Every spec of the tree with the stacked ``layers`` axis in front."""
    if isinstance(specs, dict):
        return {k: _with_layers(v) for k, v in specs.items()}
    return ("layers",) + specs


def specs_segment(seg: Segment, cfg: ModelCfg):
    return [_with_layers(specs_block(kind, seg.ffn_at(pos), cfg))
            for pos, kind in enumerate(seg.pattern)]


def segment_forward(params, x, seg: Segment, cfg: ModelCfg, *, positions=None, memory=None,
                    causal=True):
    """Loop over the segment's repeats.  Returns (x, aux_sum).

    Under ``cfg.remat == "block"``, where autograd records the forward, each
    repeat of the pattern (the reference's scanned body) runs under
    ``torch.utils.checkpoint``: only its input is kept, and its forward runs
    again in the backward.  The result is the same either way."""

    def body(x, aux, layer_params):
        for pos, kind in enumerate(seg.pattern):
            x, a = block_forward(layer_params[pos], x, kind, seg.ffn_at(pos), cfg,
                                 positions=positions, memory=memory, causal=causal)
            aux = aux + a
        return x, aux

    remat = cfg.remat == "block" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _layers(params, seg.repeats)
    for r in range(seg.repeats):
        layer_params = layers[r]
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(body, x, aux, layer_params,
                                                       use_reentrant=False)
        else:
            x, aux = body(x, aux, layer_params)
    return x, aux


def init_segment_cache(seg: Segment, batch: int, seq_len: int, cfg: ModelCfg, device=None):
    dev = resolve_device(device)
    out = []
    for pos, kind in enumerate(seg.pattern):
        _check_kind(kind, seg.ffn_at(pos))
        c = init_block_cache(kind, batch, seq_len, cfg, device=dev)
        out.append({k: torch.zeros((seg.repeats, *t.shape), dtype=t.dtype, device=dev)
                    for k, t in c.items()})
    return out


def specs_segment_cache(seg: Segment, cfg: ModelCfg):
    return [_with_layers(specs_block_cache(kind, cfg)) for kind in seg.pattern]


def segment_decode_step(params, x1, caches, index, seg: Segment, cfg: ModelCfg):
    for r in range(seg.repeats):
        for pos, kind in enumerate(seg.pattern):
            x1, _ = block_decode_step(_take(params[pos], r), x1, _take(caches[pos], r), index,
                                      kind, seg.ffn_at(pos), cfg)
    return x1, caches


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_lm(seed: int, cfg: ModelCfg, *, device=None):
    """Parameters on ``device`` (``None``: the CUDA device; raises where
    there is none), drawn from a ``torch.Generator`` on that device seeded
    with ``seed``.  The numbers are not the reference's: a test that compares
    the two carries the reference's parameters over (``compat``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _check_cfg(cfg)
    dt = dtype_of(cfg.dtype)
    p: dict[str, Any] = {
        "embed": ninit(gen, (cfg.padded_vocab, cfg.d_model), dtype=dt),
        "ln_f": init_norm(cfg.d_model, dev),
        "segments": [init_segment(gen, s, cfg) for s in cfg.segments],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ninit(gen, (cfg.d_model, cfg.padded_vocab), dtype=dt)
    if cfg.encoder_segments:
        p["encoder"] = {"segments": [init_segment(gen, s, cfg) for s in cfg.encoder_segments],
                        "ln_f": init_norm(cfg.d_model, dev)}
    if cfg.frontend is not None and cfg.frontend_dim != cfg.d_model:
        p["frontend_proj"] = ninit(gen, (cfg.frontend_dim, cfg.d_model), dtype=dt)
    return p


def specs_lm(cfg: ModelCfg):
    """The logical axes of every parameter of ``init_lm``'s tree."""
    p: dict[str, Any] = {
        # the embed table's d dim uses its own logical axis, so the rules can
        # relax its FSDP split independently (see parallel.rules embed_fsdp)
        "embed": ("vocab", "embed_gather"),
        "ln_f": specs_norm(),
        "segments": [specs_segment(s, cfg) for s in cfg.segments],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ("embed_tp", "vocab")
    if cfg.encoder_segments:
        p["encoder"] = {
            "segments": [specs_segment(s, cfg) for s in cfg.encoder_segments],
            "ln_f": specs_norm(),
        }
    if cfg.frontend is not None and cfg.frontend_dim != cfg.d_model:
        p["frontend_proj"] = ("embed_tp", None)
    return p


def _embed_sharded(table, tokens):
    """A ``DTensor`` table's rows for ``tokens`` (a dry-run's), the vocab-
    parallel way: the table's embed dim gathered (its FSDP split), each rank
    looks up the tokens that fall in its vocab slice and leaves the sum over
    the slices partial.  DTensor's own lookup would build its backward in a
    zeroed table of the global shape (and some torch versions refuse it)."""
    mesh = table.device_mesh
    table = table.redistribute(mesh, on_split(table, 1, table.placements, Replicate()))
    tok_pl = on_split(table, 0, tokens.placements, Replicate())
    t_l, i, inside = local_positions(table, 0, tokens, tok_pl)
    x = t_l[i] * inside[..., None].to(t_l.dtype)
    return from_local(x, mesh, on_split(table, 0, tok_pl, Partial()),
                      (*tokens.shape, table.shape[1]))


def _embed(p, tokens, cfg: ModelCfg):
    if isinstance(p["embed"], DTensor):
        x = _embed_sharded(p["embed"], tokens)
    else:
        x = p["embed"][torch.as_tensor(tokens, device=p["embed"].device).long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return shard(x, "batch", "seq", "act_embed")


def _head(p, x, cfg: ModelCfg):
    x = rms_norm(x, p["ln_f"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return shard(softcap(dense(x, head), cfg.logit_softcap), "batch", "seq", "vocab")


def _memory_states(p, batch, cfg: ModelCfg):
    """Encoder / modality-frontend memory for cross-attention, or None.

    ``batch["frontend_embeds"]``: (B, Tm, frontend_dim) precomputed patch or
    audio-frame embeddings (the frontend itself is a stub, as in the
    reference), on the parameters' device or the host."""
    mem = None
    fe = batch.get("frontend_embeds")
    if fe is not None:
        # in the activations' dtype (the embedding table's): K3 takes one dtype
        # for q, k and v, where the reference would promote float32 embeddings
        # against bfloat16 weights to a float32 memory (the divergence is held
        # to 2e-2 of the largest magnitude by tests/test_torch_cross.py)
        mem = torch.as_tensor(fe).to(device=p["embed"].device, dtype=p["embed"].dtype)
        if "frontend_proj" in p:
            mem = dense(mem, p["frontend_proj"])
        mem = shard(mem, "batch", None, "act_embed")
    if cfg.encoder_segments:
        if mem is None:
            raise ValueError("an encoder-decoder model needs batch['frontend_embeds']")
        x = mem
        for seg_p, seg in zip(p["encoder"]["segments"], cfg.encoder_segments):
            x, _ = segment_forward(seg_p, x, seg, cfg, causal=False)
        mem = rms_norm(x, p["encoder"]["ln_f"]["scale"], cfg.norm_eps,
                       plus_one=cfg.norm == "rmsnorm_p1")
    return mem


def lm_forward(p, batch, cfg: ModelCfg):
    """batch: {"tokens": (B,S) int, optional "positions", optional
    "frontend_embeds": (B,Tm,Fd)}.  Returns (logits (B,S,padded_vocab), aux)."""
    x = _embed(p, batch["tokens"], cfg)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
    else:
        positions = torch.as_tensor(positions, device=x.device)
    memory = _memory_states(p, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_p, seg in zip(p["segments"], cfg.segments):
        x, a = segment_forward(seg_p, x, seg, cfg, positions=positions, memory=memory)
        aux = aux + a
    return _head(p, x, cfg), aux


# -- decode -------------------------------------------------------------------


def init_lm_cache(cfg: ModelCfg, batch: int, seq_len: int, *, device=None):
    """Zeroed caches on ``device`` (``None``: the CUDA device); a cross block's
    holds ``cfg.frontend_tokens`` positions of memory K/V."""
    dev = resolve_device(device)
    _check_cfg(cfg)
    return {"segments": [init_segment_cache(s, batch, seq_len, cfg, dev)
                         for s in cfg.segments]}


def specs_lm_cache(cfg: ModelCfg):
    return {"segments": [specs_segment_cache(s, cfg) for s in cfg.segments]}


def lm_prefill_memory(p, batch, cfg: ModelCfg):
    """Compute the cross-attention memory once before decoding."""
    return _memory_states(p, batch, cfg)


def lm_prepare_decode_cache(p, cache, batch, cfg: ModelCfg):
    """Fill the per-layer cross-attention K/V caches from the (frontend /
    encoder) memory — one pass at prefill instead of reprojecting the memory
    every decode step.  The caches are written in place (the reference
    returns a new tree) and the cache is returned."""
    memory = _memory_states(p, batch, cfg)
    if memory is None:
        return cache
    for seg_p, seg_c, seg in zip(p["segments"], cache["segments"], cfg.segments):
        for pos, kind in enumerate(seg.pattern):
            if kind != "cross_attn":
                continue
            c = seg_c[pos]
            for r in range(seg.repeats):
                k, v = attention.cross_attn_kv(_take(seg_p[pos]["mixer"], r), memory, cfg)
                c["k"][r] = k
                c["v"][r] = v
    return cache


def lm_decode_step(p, cache, tokens1, index, cfg: ModelCfg):
    """tokens1: (B,1) current token; index: scalar or per-lane (B,) position.
    Returns (logits (B,1,V), cache): the cache is updated in place and
    returned, where the reference returns a new one."""
    x1 = _embed(p, tokens1, cfg)
    index = torch.as_tensor(index, dtype=torch.int32, device=x1.device)
    for seg_p, seg_c, seg in zip(p["segments"], cache["segments"], cfg.segments):
        x1, _ = segment_decode_step(seg_p, x1, seg_c, index, seg, cfg)
    return _head(p, x1, cfg), cache


def param_count(p) -> int:
    if isinstance(p, dict):
        return sum(param_count(v) for v in p.values())
    if isinstance(p, (list, tuple)):
        return sum(param_count(v) for v in p)
    return p.numel()
