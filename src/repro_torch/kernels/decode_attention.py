"""Flash-decode: single-token attention against a long KV cache — kernel K4.

The Pallas kernel runs a grid (B, H, L/bk) with the cache length sequential
and the online-softmax state in VMEM scratch, and takes one scalar
``length`` for the whole batch.  On the card (``csrc/decode_attention.cu``)
the cache length is split into chunks of 64 positions: one block per (chunk,
KV head, lane) reads its K/V rows once for all the query heads of that KV
head and writes a partial (acc, m, l); a second pass of the same launch
merges the chunks by log-sum-exp.  ``length`` is a scalar or one int per
lane — the serving engine refills lanes independently, so each lane has its
own — and chunks past a lane's length are not read.

``normalize=False`` (``partial_decode_attention``) is the same kernel
returning the unnormalised accumulator and (m, l), so that sequence shards
merge with ``merge_partials``, which stays plain tensor math as in the
reference.

CUDA tensors launch the kernel or raise; CPU tensors take the plain version
(``ref.decode_attention_ref``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from . import _build
from .flash_attention import HEAD_DIMS, check_rows
from .ref import decode_attention_ref

CHUNK = 64          # cache positions per block of the kernel's first pass (checked there)

#: kernel launches made by ``decode_attention`` and ``partial_decode_attention``
launches = 0

_SYMBOL = {torch.float32: "launch_decode_attention_f32",
           torch.bfloat16: "launch_decode_attention_bf16"}
_launchers: dict = {}


def _launcher(dtype: torch.dtype):
    if dtype not in _launchers:
        lib = _build.load_library(*_build.csrc_source("decode_attention.cu"))
        _launchers[dtype] = _build.bind(
            lib, _SYMBOL[dtype],
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float,
                                                           ctypes.c_int]
            + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p])
    return _launchers[dtype]


def _lengths(length, B: int, device: torch.device) -> tuple[Optional[torch.Tensor], int]:
    """``(per-lane int32 tensor on the device, None)`` or ``(None, scalar)``."""
    if isinstance(length, torch.Tensor):
        if length.ndim == 0 and length.device.type == "cpu":
            return None, int(length)
        per_lane = torch.broadcast_to(length.to(device=device, dtype=torch.int32), (B,))
        return per_lane.contiguous(), 0
    return None, int(length)


def _call(q, k, v, length, scale, normalize):
    B, H, D = q.shape
    _, L, KvH, _ = k.shape
    if H % KvH != 0:
        raise ValueError(f"decode_attention: H={H} must be a multiple of KvH={KvH}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if isinstance(length, torch.Tensor) and length.numel() not in (1, B):
        raise ValueError(f"decode_attention: length has {length.numel()} values for {B} lanes")
    sc = scale if scale is not None else D ** -0.5
    if q.device.type != "cuda":
        return decode_attention_ref(q, k, v, length, scale=sc, normalize=normalize)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SYMBOL:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: {q.device}, {k.device}, {v.device}")
    check_rows(q, k, v)
    per_lane, scalar = _lengths(length, B, q.device)
    n_chunks = -(-L // CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    pacc = torch.empty((n_chunks, B, H, D), **f32)
    pm = torch.empty((n_chunks, B, H), **f32)
    pl = torch.empty((n_chunks, B, H), **f32)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H), **f32)
    l = torch.empty((B, H), **f32)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            per_lane.data_ptr() if per_lane is not None else None, scalar,
            B, H, KvH, L, D, strides, sc, CHUNK, pacc.data_ptr(), pm.data_ptr(), pl.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), int(normalize), stream)
    _build.check_launch(rc, _SYMBOL[q.dtype])
    launches += 1
    return out if normalize else (out, m, l)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,D); k,v: (B,L,KvH,D); positions >= length are masked, with
    ``length`` a scalar or one per lane (B,)."""
    return _call(q, k, v, length, scale, True)


def partial_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             length: Union[int, torch.Tensor], *,
                             scale: Optional[float] = None):
    """Unnormalised partial result + (m, l) for cross-shard merging."""
    return _call(q, k, v, length, scale, False)


def merge_partials(outs: torch.Tensor, ms: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Merge per-shard partial attention (stacked on axis 0):
    outs (S,B,H,D) unnormalised, ms/ls (S,B,H).  Standard flash-decode
    log-sum-exp combination."""
    m = ms.amax(0)
    corr = torch.exp(ms - m[None])                       # (S,B,H)
    l = (ls * corr).sum(0)
    o = (outs.float() * corr[..., None]).sum(0)
    return (o / torch.clamp(l[..., None], min=1e-30)).to(outs.dtype)
