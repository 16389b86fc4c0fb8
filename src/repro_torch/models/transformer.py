"""Layer stacks and the unified language model.

A model is ``embed -> [segments] -> final norm -> lm head``.  Each segment is
a *pattern* of block kinds repeated ``repeats`` times.  Parameters keep the
reference's tree: ``segments[i][pos]`` leaves have a leading ``repeats`` dim,
and the reference's ``lax.scan`` over the repeats is a Python loop over it.

Block kinds ported:
    attn        causal GQA self-attention (+RoPE)
    local_attn  sliding-window GQA (window = cfg.attn.window), ring-buffer cache
    rglru       RG-LRU recurrent block (Griffin)
    ssd         Mamba-2 SSD mixer
each pre-norm residual, followed by an ``mlp`` or ``moe`` ffn with its own
pre-norm residual, or by none (``"none"``: no ``ln2``).  A ``moe`` ffn adds
its load-balancing loss to the forward's aux sum; a decode step drops it.
Every other kind (enc_attn, cross_attn, mla), encoders and modality
frontends raise ``NotImplementedError`` (ROADMAP.md queue A, item 6).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .._device import resolve_device
from ..configs.base import ModelCfg, Segment
from . import attention, mlp, rglru, ssd
from .common import dense, dtype_of, init_norm, ninit, rms_norm, softcap

MIXER_KINDS = ("attn", "local_attn", "rglru", "ssd")
FFN_KINDS = ("mlp", "moe", "none")


def _check_kind(kind: str, ffn: str) -> None:
    if kind not in MIXER_KINDS or ffn not in FFN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} with ffn {ffn!r} is not ported yet: "
                                  f"the port runs {MIXER_KINDS} blocks with an ffn of "
                                  f"{FFN_KINDS} (ROADMAP.md queue A, item 6: enc_attn, "
                                  f"cross_attn and mla)")


def _check_cfg(cfg: ModelCfg) -> None:
    if cfg.encoder_segments or cfg.frontend is not None:
        raise NotImplementedError("encoders and modality frontends are not ported yet "
                                  "(ROADMAP.md queue A, item 6)")
    for seg in cfg.segments:
        for pos, kind in enumerate(seg.pattern):
            _check_kind(kind, seg.ffn_at(pos))


def _stack(trees: list):
    """One tree whose leaves stack the trees' leaves.  Each leaf leaves its
    tree as it is stacked, so the layers' own copies are freed leaf by leaf
    (peak memory: the model and one stacked leaf, not the model twice)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    return torch.stack(trees)


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
    if kind in ("attn", "local_attn"):
        return attention.init_attn(gen, cfg)
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


def _ffn(p, x, ffn: str, cfg: ModelCfg):
    """The ffn's pre-norm residual.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, aux
    h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    if ffn == "mlp":
        f = mlp.mlp_forward(p["ffn"], h, cfg)
    else:
        f, aux = mlp.moe_forward(p["ffn"], h, cfg)
    return x + f, aux


def block_forward(p, x, kind: str, ffn: str, cfg: ModelCfg, *, positions=None, causal=True):
    """One block forward.  Returns (x, aux_loss)."""
    _check_kind(kind, ffn)
    h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    if kind in ("attn", "local_attn"):
        m = attention.attn_forward(p["mixer"], h, cfg, positions=positions,
                                   window=_window(kind, cfg), causal=causal)
    elif kind == "rglru":
        m = rglru.rglru_forward(p["mixer"], h, cfg)
    else:
        m = ssd.ssd_forward(p["mixer"], h, cfg)
    return _ffn(p, x + m, ffn, cfg)


def init_block_cache(kind: str, batch: int, seq_len: int, cfg: ModelCfg, device=None):
    if kind in ("attn", "local_attn"):
        return attention.init_attn_cache(batch, seq_len, cfg, window=_window(kind, cfg),
                                         device=device)
    if kind == "rglru":
        return rglru.init_rglru_cache(batch, cfg, device=device)
    return ssd.init_ssd_cache(batch, cfg, device=device)


def block_decode_step(p, x1, cache, index, kind: str, ffn: str, cfg: ModelCfg):
    _check_kind(kind, ffn)
    h = rms_norm(x1, p["ln1"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    if kind in ("attn", "local_attn"):
        m, cache = attention.attn_decode_step(p["mixer"], h, cache, index, cfg,
                                              window=_window(kind, cfg))
    elif kind == "rglru":
        m, cache = rglru.rglru_decode_step(p["mixer"], h, cache, cfg)
    else:
        m, cache = ssd.ssd_decode_step(p["mixer"], h, cache, cfg)
    x1, _ = _ffn(p, x1 + m, ffn, cfg)
    return x1, cache


# ---------------------------------------------------------------------------
# segment = pattern x repeats, looped over stacked params
# ---------------------------------------------------------------------------


def init_segment(gen: torch.Generator, seg: Segment, cfg: ModelCfg):
    """Params for one segment: per pattern-position, a tree whose leaves
    have a leading ``repeats`` dim."""
    return [_stack([init_block(gen, kind, seg.ffn_at(pos), cfg) for _ in range(seg.repeats)])
            for pos, kind in enumerate(seg.pattern)]


def segment_forward(params, x, seg: Segment, cfg: ModelCfg, *, positions=None, causal=True):
    """Loop over the segment's repeats.  Returns (x, aux_sum)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(seg.repeats):
        for pos, kind in enumerate(seg.pattern):
            x, a = block_forward(_take(params[pos], r), x, kind, seg.ffn_at(pos), cfg,
                                 positions=positions, causal=causal)
            aux = aux + a
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
    return p


def _embed(p, tokens, cfg: ModelCfg):
    x = p["embed"][torch.as_tensor(tokens, device=p["embed"].device).long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(p, x, cfg: ModelCfg):
    x = rms_norm(x, p["ln_f"]["scale"], cfg.norm_eps, plus_one=cfg.norm == "rmsnorm_p1")
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return softcap(dense(x, head), cfg.logit_softcap)


def lm_forward(p, batch, cfg: ModelCfg):
    """batch: {"tokens": (B,S) int, optional "positions"}.  Returns
    (logits (B,S,padded_vocab), aux)."""
    if batch.get("frontend_embeds") is not None:
        raise NotImplementedError("modality frontends are not ported yet "
                                  "(ROADMAP.md queue A, item 6)")
    x = _embed(p, batch["tokens"], cfg)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
    else:
        positions = torch.as_tensor(positions, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_p, seg in zip(p["segments"], cfg.segments):
        x, a = segment_forward(seg_p, x, seg, cfg, positions=positions)
        aux = aux + a
    return _head(p, x, cfg), aux


# -- decode -------------------------------------------------------------------


def init_lm_cache(cfg: ModelCfg, batch: int, seq_len: int, *, device=None):
    """Zeroed KV caches on ``device`` (``None``: the CUDA device)."""
    dev = resolve_device(device)
    _check_cfg(cfg)
    return {"segments": [init_segment_cache(s, batch, seq_len, cfg, dev) for s in cfg.segments]}


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
