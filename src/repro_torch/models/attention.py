"""Attention: GQA with RoPE (full / sliding-window / cross), flash-style
chunked computation in plain torch (the oracle of the flash kernel), and
single-token decode over a KV cache — a full cache, or a ring buffer of
``min(window, seq_len)`` slots under a window — or, for cross-attention,
against memory K/V computed once at prefill.

The reference's kernel-eligible regions run the kernels' wrappers on every
device: ``attn_forward``'s attention is ``ops.mha`` (K3 on the card, its
plain version on the CPU; non-causal with Sq != Sk for cross-attention),
and ``attn_decode_step``'s and ``cross_attn_decode``'s softmax is
``ops.decode`` (K4; against the whole memory, ``length = Tm``, in cross
decode).  ``cfg.attn.logit_softcap`` caps the scaled scores inside those
kernels (``softcap``), as the reference caps them in its plain attention
and decode.  Under sharding rules with ``_flash_decode`` on a mesh with a
``model`` axis, a full cache is sequence-sharded over ``model`` and the
decode is ``_sharded_flash_decode``: K4's partials (``ops.decode_partial``)
merged across the ranks.  Nothing falls back to a plain path on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import resolve_device
from ..configs.base import ModelCfg
from ..kernels import ops
from ..parallel.api import (all_gather, axis_index, current_mesh, current_rules,
                            mesh_axis_names, mesh_shape)
from .common import apply_rope, dense, dtype_of, ninit, softcap as softcap_scores

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_attn(gen: torch.Generator, cfg: ModelCfg, cross: bool = False):
    """The projections; ``cross`` makes the same ones (queries from the
    decoder, keys and values from the memory), as the reference does."""
    a = cfg.attn
    d = cfg.d_model
    p = {
        "wq": ninit(gen, (d, a.n_heads, a.d_head)),
        "wk": ninit(gen, (d, a.n_kv_heads, a.d_head)),
        "wv": ninit(gen, (d, a.n_kv_heads, a.d_head)),
        "wo": ninit(gen, (a.n_heads, a.d_head, d), scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }
    if a.qkv_bias:
        for name, heads in (("bq", a.n_heads), ("bk", a.n_kv_heads), ("bv", a.n_kv_heads)):
            p[name] = torch.zeros((heads, a.d_head), dtype=torch.bfloat16, device=gen.device)
    return p


def specs_attn(cfg: ModelCfg, cross: bool = False):
    a = cfg.attn
    p = {
        "wq": ("embed_tp", "heads", None),
        "wk": ("embed_tp", "kv_heads", None),
        "wv": ("embed_tp", "kv_heads", None),
        "wo": ("heads", None, "embed_tp"),
    }
    if a.qkv_bias:
        p["bq"] = ("heads", None)
        p["bk"] = ("kv_heads", None)
        p["bv"] = ("kv_heads", None)
    return p


# ---------------------------------------------------------------------------
# flash-style chunked attention (plain torch oracle)
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, kv_chunk: int = 1024,
                    softcap: Optional[float] = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KvH, D).  Online-softmax over KV chunks:
    O(Sq * kv_chunk) live memory instead of O(Sq * Sk); ``softcap`` caps the
    scaled scores.  An oracle of the flash kernel in the tests; the model
    calls ``ops.mha``."""
    B, Sq, H, D = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = D ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, KvH, G, D)
    q_pos = torch.arange(Sq, device=q.device)

    acc = torch.zeros((B, Sq, KvH, G, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, KvH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, KvH, G), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].float()                   # (B, C, KvH, D)
        vb = v[:, c0:c0 + kv_chunk].float()
        pad = kv_chunk - kb.shape[1]                          # the reference pads the last chunk
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        s = softcap_scores(torch.einsum("bqhgd,bkhd->bqhgk", qf, kb), softcap)
        kv_pos = c0 + torch.arange(kv_chunk, device=q.device)
        valid = (kv_pos < Sk)[None, :]
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def dense_attention(q, k, v, *, causal=True, softcap: Optional[float] = None):
    """Reference O(Sq*Sk) attention (an oracle of the flash kernel in the
    tests); ``softcap`` caps the scaled scores."""
    B, Sq, H, D = q.shape
    KvH = k.shape[2]
    G = H // KvH
    qf = (q.float() * D ** -0.5).reshape(B, Sq, KvH, G, D)
    s = softcap_scores(torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float()), softcap)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        kv_pos = torch.arange(k.shape[1], device=q.device)
        valid = kv_pos[None, :] <= q_pos[:, None]
        s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------


def _project_qkv(p, x, cfg: ModelCfg):
    a = cfg.attn
    q, k, v = dense(x, p["wq"]), dense(x, p["wk"]), dense(x, p["wv"])
    if a.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def attn_forward(p, x, cfg: ModelCfg, *, positions=None, window=None, kv=None,
                 causal: bool = True):
    """Self-attention over x (B,S,D), sliding-window when ``window`` is set
    (a query sees the ``window`` positions up to its own); cross-attention
    if ``kv`` (memory hidden states (B,Sm,D)) is given: no RoPE, no bias,
    every query sees the whole memory.  ``causal=False`` gives bidirectional
    self-attention (encoder stacks).  The attention is ``ops.mha`` on every
    device: K3 on the card, its plain version on the CPU, under the config's
    logit cap."""
    a = cfg.attn
    B, S, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg)
        pos = positions if positions is not None else \
            torch.arange(S, device=x.device)[None, :].expand(B, S)
        q = apply_rope(q, pos, a.rope_theta, a.rope_dim)
        k = apply_rope(k, pos, a.rope_theta, a.rope_dim)
    else:
        q = dense(x, p["wq"])
        k, v = cross_attn_kv(p, kv, cfg)
        causal = False  # cross-attention attends to the full memory
    o = ops.mha(q, k, v, causal=causal, window=window, softcap=a.logit_softcap)
    return dense(o, p["wo"], 2)


def cross_attn_decode(p, x1, k, v, cfg: ModelCfg):
    """Cross-attention decode against *precomputed* memory K/V (filled once
    at prefill by ``transformer.lm_prepare_decode_cache``).  x1: (B,1,D);
    k,v: (B,Tm,KvH,Dh).  The softmax over the memory is K4 (``ops.decode``)
    with every lane's length the whole memory, Tm, under the config's logit cap."""
    a = cfg.attn
    B = x1.shape[0]
    q = dense(x1, p["wq"])
    o = ops.decode(q[:, 0], k, v, k.shape[1], softcap=a.logit_softcap)   # (B, H, Dh)
    o = o.reshape(B, 1, a.n_heads, a.d_head).to(x1.dtype)
    return dense(o, p["wo"], 2)


def cross_attn_kv(p, memory, cfg: ModelCfg):
    """Memory K/V for one cross-attention layer; memory: (B,Tm,D)."""
    return dense(memory, p["wk"]), dense(memory, p["wv"])


# ---------------------------------------------------------------------------
# decode (single new token against a cache)
# ---------------------------------------------------------------------------


def _decode_shards(window) -> int:
    """Ranks over which a decode cache's length is sharded: the ``model``
    axis's size under ``_flash_decode`` rules on a mesh with that axis, for
    a full (unwindowed) cache; else 0 (the cache is whole)."""
    rules, mesh = current_rules(), current_mesh()
    if (rules is None or mesh is None or not rules.rules.get("_flash_decode") or window
            or "model" not in mesh_axis_names(mesh)):
        return 0
    return mesh_shape(mesh)["model"]


def init_attn_cache(batch: int, seq_len: int, cfg: ModelCfg, window: Optional[int] = None,
                    device=None):
    """Zeroed K/V caches of ``L = min(window, seq_len)`` slots under a window
    (a ring buffer), else ``seq_len``, on ``device`` (``None``: the CUDA
    device; raises where there is none).  Under ``_flash_decode`` rules a
    full cache is this rank's ``seq_len / n_model`` slots of the length
    (``kv_seq`` over ``model``); a length ``n_model`` does not divide raises
    ``ValueError``, where the reference would decode it unsharded: the
    decode step, given a rank's slots, could not tell the two apart."""
    device = resolve_device(device)
    a = cfg.attn
    L = min(window, seq_len) if window else seq_len
    n = _decode_shards(window)
    if n:
        if L % n or L < n:
            raise ValueError(f"init_attn_cache: a sequence-sharded cache of {L} positions "
                             f"does not split over {n} ranks of the model axis")
        L //= n
    shape = (batch, L, a.n_kv_heads, a.d_head)
    dt = dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def specs_attn_cache(window: Optional[int] = None):
    # full caches shard the sequence dim over the model axis (flash-decode
    # with partial-softmax reduction); windowed caches are small — replicate
    # the window dim and keep batch sharded.
    seq_ax = None if window else "kv_seq"
    return {"k": ("batch", seq_ax, "kv_heads_decode", None),
            "v": ("batch", seq_ax, "kv_heads_decode", None)}


def _sharded_flash_decode(q, k, v, idx, cfg: ModelCfg, mesh):
    """Sequence-sharded flash-decode (the distributed realisation of
    ``kernels.decode_attention``): the cache stays sharded over ``model`` on
    its length dim; each rank computes a partial online-softmax and the
    ranks merge with one tiny all-gather of (acc, m, l), packed in float32 —
    O(B·H·D) on the wire instead of O(B·L·KvH·D) for gathering the cache.

    q: (B, 1, H, Dh) post-RoPE; k/v: this rank's (B, L/n_model, KvH, Dh),
    positions ``lo = i · L/n_model`` on for rank i of ``model``; idx: (B,).
    The partial is K4 with ``normalize=False`` (``ops.decode_partial``) at a
    local length ``clamp(idx + 1 - lo, 0, L/n_model)`` per lane.  A rank
    whose every slot lies past a lane's index has length 0 there: K4 (and
    its plain version) mask every score at -1e30, so m = -1e30 and l the
    slot count, finite, and ``merge_partials`` weighs that partial by
    exp(-1e30 - m) = 0 against the rank that holds position 0 — the
    reference's masked shard, which never forms -inf - (-inf)."""
    a = cfg.attn
    B, _, H, Dh = q.shape
    Ll = k.shape[1]
    lo = axis_index("model", mesh) * Ll
    length = torch.clamp(idx + 1 - lo, 0, Ll).to(torch.int32)
    acc, m, l = ops.decode_partial(q[:, 0], k, v, length, softcap=a.logit_softcap)
    # one all-gather of the three, packed in float32 (m and l are float32;
    # merge_partials sums in float32 whatever the accumulator's dtype)
    packed = torch.cat([acc.float(), m[..., None], l[..., None]], dim=-1)   # (B, H, Dh + 2)
    parts = all_gather(packed, "model", mesh=mesh)                        # (S, B, H, Dh + 2)
    o = ops.merge_partials(parts[..., :Dh], parts[..., Dh], parts[..., Dh + 1])
    return o.to(q.dtype).reshape(B, 1, H, Dh)


def attn_decode_step(p, x1, cache, index, cfg: ModelCfg, *, window=None):
    """x1: (B, 1, D); cache k/v: (B, L, KvH, Dh); index: scalar or per-lane
    (B,) current positions (continuous batching).  Returns
    (out (B,1,D), cache).

    The new token's K/V go into the cache **in place** (``index_put_`` at
    ``[lane, slot]``, where the reference builds a new array with
    ``.at[lane, slot].set``); the returned cache holds the same tensors.  The
    softmax over the cache is K4 (``ops.decode``) with a length per lane.
    Without a window the slot is ``index`` and the length ``index + 1``: the
    kernel attends to positions ``< length`` where the reference's mask reads
    ``<= index``.  Under a window the cache is a ring of L slots: the slot is
    ``index mod L`` and the length ``min(index + 1, L)``.  That selects the
    reference's set, ``age < min(index + 1, L)``: slots are written in order
    from position 0, so before the ring wraps the valid slots are
    ``0..index``, and after it all L are; RoPE is applied before the cache and
    attention does not depend on the order of its keys.  The scores take the
    config's logit cap, as the reference's do.

    Under ``_flash_decode`` rules on a mesh with a ``model`` axis, without a
    window, the cache is this rank's slots of a sequence-sharded one
    (``init_attn_cache``) and the step is ``_sharded_flash_decode``."""
    a = cfg.attn
    B = x1.shape[0]
    idx = torch.broadcast_to(torch.as_tensor(index, dtype=torch.int32, device=x1.device), (B,))
    q, k1, v1 = _project_qkv(p, x1, cfg)
    pos = idx[:, None]
    q = apply_rope(q, pos, a.rope_theta, a.rope_dim)
    k1 = apply_rope(k1, pos, a.rope_theta, a.rope_dim)
    k, v = cache["k"], cache["v"]
    L = k.shape[1]
    lane = torch.arange(B, device=x1.device)
    if _decode_shards(window):
        # this rank's L slots of the sequence-sharded cache: the rank that
        # holds position idx writes it at idx - lo; the others write back
        # what they hold (no host sync to pick the lanes)
        mesh = current_mesh()
        lo = axis_index("model", mesh) * L
        own = (idx >= lo) & (idx < lo + L)
        slot = torch.clamp(idx - lo, 0, L - 1).long()
        for c, new in ((k, k1), (v, v1)):
            c[lane, slot] = torch.where(own[:, None, None], new[:, 0].to(c.dtype), c[lane, slot])
        o = _sharded_flash_decode(q, k, v, idx, cfg, mesh).to(x1.dtype)
        return dense(o, p["wo"], 2), {"k": k, "v": v}
    slot = torch.remainder(idx, L).long() if window else idx.long()
    k[lane, slot] = k1[:, 0].to(k.dtype)
    v[lane, slot] = v1[:, 0].to(v.dtype)

    length = torch.clamp(idx + 1, max=L) if window else idx + 1
    o = ops.decode(q[:, 0], k, v, length, softcap=a.logit_softcap)   # (B, H, Dh)
    o = o.reshape(B, 1, a.n_heads, a.d_head).to(x1.dtype)
    out = dense(o, p["wo"], 2)
    return out, {"k": k, "v": v}
