"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

K/V are compressed into a rank-``kv_lora_rank`` latent ``c_kv`` plus a shared
rotary key ``k_pe`` (rope_head_dim); per-head keys/values are decompressed on
the fly.  The decode cache stores only (c_kv, k_pe) — the paper's 93% KV-cache
reduction — and decompression folds into the attention einsum ("weight
absorption") so decode never materialises per-head K/V.

Prefill (``mla_forward``) decompresses K and V and runs ``ops.mha`` with a
query/key head dim of nope + rope (192 at full width) against a value head
dim of ``v_head_dim`` (128): K3's ``<192, 128>`` kernel on the card, its
plain version on the CPU.  ``mla_forward_chunked`` is the reference's
absorbed online-softmax form; the reference names it a kernel region
(``pallas_kernel.mla_flash``, plain jnp behind it), so on the card it runs
K3 through ``mla_forward`` and on the CPU the absorbed form itself, which is
also the plain oracle of the same function.  Decode stays eager torch, as
the reference computes it in XLA with no kernel region.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..configs.base import ModelCfg
from ..kernels import ops, regions
from ..parallel.api import DTensor, shard
from .attention import NEG_INF, write_slot
from .common import apply_rope, dense, dtype_of, ninit


def init_mla(gen: torch.Generator, cfg: ModelCfg):
    a = cfg.attn
    d = cfg.d_model
    H = a.n_heads
    qd = a.nope_head_dim + a.rope_head_dim
    p = {
        "w_dkv": ninit(gen, (d, a.kv_lora_rank)),             # down-proj to latent
        "w_kpe": ninit(gen, (d, a.rope_head_dim)),            # shared rotary key
        "w_uk": ninit(gen, (a.kv_lora_rank, H, a.nope_head_dim)),
        "w_uv": ninit(gen, (a.kv_lora_rank, H, a.v_head_dim)),
        "wo": ninit(gen, (H, a.v_head_dim, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5),
        "kv_norm": torch.ones((a.kv_lora_rank,), dtype=torch.float32, device=gen.device),
    }
    if a.q_lora_rank:
        p["w_dq"] = ninit(gen, (d, a.q_lora_rank))
        p["w_uq"] = ninit(gen, (a.q_lora_rank, H, qd))
        p["q_norm"] = torch.ones((a.q_lora_rank,), dtype=torch.float32, device=gen.device)
    else:
        p["wq"] = ninit(gen, (d, H, qd))
    return p


def specs_mla(cfg: ModelCfg):
    a = cfg.attn
    p = {
        "w_dkv": ("embed_tp", None),
        "w_kpe": ("embed_tp", None),
        "w_uk": (None, "heads", None),
        "w_uv": (None, "heads", None),
        "wo": ("heads", None, "embed_tp"),
        "kv_norm": (None,),
    }
    if a.q_lora_rank:
        p["w_dq"] = ("embed_tp", None)
        p["w_uq"] = (None, "heads", None)
        p["q_norm"] = (None,)
    else:
        p["wq"] = ("embed_tp", "heads", None)
    return p


def _rms(x, w, eps=1e-6):
    """MLA's own norm: eps 1e-6, the weight as it is (no plus one), cast back."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)


def _queries(p, x, cfg: ModelCfg, positions):
    a = cfg.attn
    if a.q_lora_rank:
        cq = _rms(dense(x, p["w_dq"]), p["q_norm"])
        q = dense(cq, p["w_uq"])
    else:
        q = dense(x, p["wq"])
    q_nope, q_pe = q[..., :a.nope_head_dim], q[..., a.nope_head_dim:]
    q_pe = apply_rope(q_pe, positions, a.rope_theta)
    return q_nope, q_pe


def _latents(p, x, cfg: ModelCfg, positions):
    """The compressed K/V: c_kv (B,S,r) after its norm, k_pe (B,S,rope) after RoPE."""
    c_kv = _rms(dense(x, p["w_dkv"]), p["kv_norm"])
    k_pe = apply_rope(dense(x, p["w_kpe"]), positions, cfg.attn.rope_theta)
    return c_kv, k_pe


def _positions(x, positions):
    B, S = x.shape[:2]
    if positions is not None:
        return positions
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def _scale(cfg: ModelCfg) -> float:
    return (cfg.attn.nope_head_dim + cfg.attn.rope_head_dim) ** -0.5


def mla_forward(p, x, cfg: ModelCfg, positions=None, *, absorbed: bool = False):
    """Training/prefill path: decompress K/V and run causal MHA, ``ops.mha``
    with queries and keys of nope + rope dims against values of v dims.
    ``absorbed`` says only how a dry-run counts the attention: as the
    reference's absorbed chunked form (dots over the latent rank, keys in
    1024-key chunks), where ``mla_forward_chunked`` stands for it; else as
    its dense form."""
    a = cfg.attn
    pos = _positions(x, positions)
    q_nope, q_pe = _queries(p, x, cfg, pos)
    c_kv, k_pe = _latents(p, x, cfg, pos)
    k_nope = dense(c_kv, p["w_uk"])                               # (B,S,H,nope)
    v = dense(c_kv, p["w_uv"])                                    # (B,S,H,v)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(-1, -1, a.n_heads, -1)], dim=-1)
    if regions.traced(q):
        o = regions.mha(q, k, v, causal=True, window=None, scale=_scale(cfg), softcap=None,
                        form="chunked" if absorbed else "dense",
                        dims=(a.kv_lora_rank + a.rope_head_dim, a.kv_lora_rank)
                        if absorbed else None)
    else:
        o = ops.mha(q, k, v, causal=True, scale=_scale(cfg))
    o = shard(o, "batch", "seq", "heads", None)
    return dense(o.to(x.dtype), p["wo"], 2)


def mla_forward_chunked(p, x, cfg: ModelCfg, positions=None, kv_chunk: int = 1024):
    """Flash-style MLA for long sequences: online softmax over latent chunks,
    with queries absorbed into the latent space (q~ = q W_uk) so the chunk
    working set is rank-r, not H*Dh.  On the card, and on a dry-run's meta
    or fake tensors: K3 (``mla_forward``)."""
    if x.device.type == "cuda" or regions.traced(x):
        return mla_forward(p, x, cfg, positions, absorbed=True)
    return mla_forward_chunked_plain(p, x, cfg, positions, kv_chunk)


def mla_forward_chunked_plain(p, x, cfg: ModelCfg, positions=None, kv_chunk: int = 1024):
    """The reference's absorbed online-softmax form, on any device (the plain
    oracle of ``mla_forward``)."""
    a = cfg.attn
    B, S, _ = x.shape
    pos = _positions(x, positions)
    q_nope, q_pe = _queries(p, x, cfg, pos)
    c_kv, k_pe = _latents(p, x, cfg, pos)

    # absorb: q~ (B,S,H,r) = q_nope @ w_uk^T
    dt = torch.promote_types(q_nope.dtype, p["w_uk"].dtype)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope.to(dt), p["w_uk"].to(dt)).float()
    qpe = q_pe.float()
    scale = _scale(cfg)
    H, r = a.n_heads, a.kv_lora_rank
    acc = torch.zeros((B, S, H, r), dtype=torch.float32, device=x.device)
    m = torch.full((B, S, H), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=x.device)
    q_pos = torch.arange(S, device=x.device)
    for c0 in range(0, S, kv_chunk):
        cb = c_kv[:, c0:c0 + kv_chunk].float()
        kb = k_pe[:, c0:c0 + kv_chunk].float()
        pad = kv_chunk - cb.shape[1]                           # the reference pads the last chunk
        if pad:
            cb = torch.nn.functional.pad(cb, (0, 0, 0, pad))
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
        s = torch.einsum("bshr,bkr->bshk", q_abs, cb)
        s = s + torch.einsum("bshe,bke->bshk", qpe, kb)
        s = s * scale
        kv_pos = c0 + torch.arange(kv_chunk, device=x.device)
        valid = (kv_pos < S)[None, :] & (kv_pos[None, :] <= q_pos[:, None])     # (S, C)
        s = torch.where(valid[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bshk,bkr->bshr", pr, cb)
        m = m_new
    o_lat = acc / torch.clamp(l[..., None], min=1e-30)          # (B,S,H,r)
    dt = torch.promote_types(x.dtype, p["w_uv"].dtype)
    o = torch.einsum("bshr,rhe->bshe", o_lat.to(x.dtype).to(dt), p["w_uv"].to(dt))
    return dense(o, p["wo"], 2)


# -- decode -----------------------------------------------------------------


def init_mla_cache(batch: int, seq_len: int, cfg: ModelCfg, device=None):
    """The compressed cache, c_kv (B,L,r) and k_pe (B,L,rope), zeroed on
    ``device`` (``None``: the CUDA device; raises where there is none)."""
    device = resolve_device(device)
    a = cfg.attn
    dt = dtype_of(cfg.dtype)
    return {
        "c_kv": torch.zeros((batch, seq_len, a.kv_lora_rank), dtype=dt, device=device),
        "k_pe": torch.zeros((batch, seq_len, a.rope_head_dim), dtype=dt, device=device),
    }


def specs_mla_cache():
    return {"c_kv": ("batch", "kv_seq", None), "k_pe": ("batch", "kv_seq", None)}


def mla_decode_step(p, x1, cache, index, cfg: ModelCfg):
    """Weight-absorbed MLA decode: attention runs entirely in the latent
    space against the compressed cache.  ``index``: scalar or per-lane (B,).
    The new token's latents go into the cache in place, at ``[lane,
    index[lane]]`` (``index_put_``; the reference builds a new array with
    ``.at[lane, idx].set``); the returned cache holds the same tensors."""
    a = cfg.attn
    B = x1.shape[0]
    idx = torch.broadcast_to(torch.as_tensor(index, dtype=torch.int32, device=x1.device), (B,))
    pos = idx[:, None]
    q_nope, q_pe = _queries(p, x1, cfg, pos)
    c1, kpe1 = _latents(p, x1, cfg, pos)
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    lane = torch.arange(B, device=x1.device)
    if isinstance(c_kv, DTensor):
        write_slot(c_kv, idx.long(), c1[:, 0])
        write_slot(k_pe, idx.long(), kpe1[:, 0])
    else:
        c_kv.index_put_((lane, idx.long()), c1[:, 0].to(c_kv.dtype))
        k_pe.index_put_((lane, idx.long()), kpe1[:, 0].to(k_pe.dtype))

    dt = torch.promote_types(q_nope.dtype, p["w_uk"].dtype)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope.to(dt), p["w_uk"].to(dt)).float()
    s = torch.einsum("bshr,bkr->bshk", q_abs, c_kv.float())
    s = s + torch.einsum("bshe,bke->bshk", q_pe.float(), k_pe.float())
    s = s * _scale(cfg)
    valid = torch.arange(c_kv.shape[1], device=x1.device)[None, :] <= idx[:, None]   # (B,L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bshk,bkr->bshr", prob, c_kv.float())
    dt = torch.promote_types(x1.dtype, p["w_uv"].dtype)
    o = torch.einsum("bshr,rhe->bshe", o_lat.to(x1.dtype).to(dt), p["w_uv"].to(dt))
    return dense(o, p["wo"], 2), {"c_kv": c_kv, "k_pe": k_pe}
