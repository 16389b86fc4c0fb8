"""Public wrappers around the hand-written kernels.

Handles (a) padding arbitrary shapes to kernel tile multiples where a kernel
needs it (the matmul; the attention and scan kernels mask their ragged edges
themselves), (b) layout adaptation from model conventions ((B,S,H,D)) to
kernel conventions ((B,H,S,D)), as strided views, not copies.  Dispatch is by
where the tensors lie: CUDA tensors launch the kernel, CPU tensors run the
kernel's plain version (``ref``), and meta or fake tensors (the dry-run's,
``DTensor`` shards included) trace the kernel's region (``regions``), which
computes nothing and carries the reference region's FLOPs.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from . import decode_attention as _dec
from . import flash_attention as _fa
from . import matmul as _mm
from . import regions
from . import rglru_scan as _rg
from . import ssd_scan as _ssd


def _pad_to(x: torch.Tensor, axis: int, mult: int, value=0.0) -> torch.Tensor:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim          # F.pad counts from the last axis back
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths, value=value)


# -- matmul -------------------------------------------------------------------


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128, bn: int = 128,
           bk: int = 16) -> torch.Tensor:
    M, K = x.shape
    _, N = y.shape
    xp = _pad_to(_pad_to(x, 0, bm), 1, bk)
    yp = _pad_to(_pad_to(y, 0, bk), 1, bn)
    out = _mm.matmul(xp, yp, bm=bm, bn=bn, bk=bk)
    return out[:M, :N]


# -- attention ----------------------------------------------------------------


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
        window: Optional[int] = None, scale: Optional[float] = None,
        softcap: Optional[float] = None) -> torch.Tensor:
    """Model layout: q (B,Sq,H,D); k (B,Sk,KvH,D); v (B,Sk,KvH,Dv).  Returns
    (B,Sq,H,Dv).  ``scale`` defaults to D ** -0.5; ``softcap`` caps the
    scaled scores (``tanh(s / c) * c``).

    The kernel tiles by its own block sizes and masks keys past Sk itself, so
    nothing is padded: the true key length is the kernel's ``kv_len``."""
    if regions.traced(q):
        return regions.mha(q, k, v, causal=causal, window=window,
                           scale=scale if scale is not None else q.shape[-1] ** -0.5,
                           softcap=softcap)
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, scale=scale, softcap=softcap)
    return out.transpose(1, 2)


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: Union[int, torch.Tensor], *,
           softcap: Optional[float] = None) -> torch.Tensor:
    """q (B,H,D) single position; k,v (B,L,KvH,D); length: valid entries, a
    scalar or one per lane (B,); ``softcap`` caps the scaled scores."""
    if regions.traced(q):
        return regions.decode(q, k, v, length, scale=q.shape[-1] ** -0.5, softcap=softcap,
                              normalize=True)
    return _dec.decode_attention(q, k, v, length, softcap=softcap)


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length: Union[int, torch.Tensor], *, scale: Optional[float] = None,
                   softcap: Optional[float] = None):
    """K4's unnormalised partial (acc, m, l) for a cross-shard merge."""
    if regions.traced(q):
        return regions.decode(q, k, v, length, scale=scale or q.shape[-1] ** -0.5,
                              softcap=softcap, normalize=False)
    return _dec.partial_decode_attention(q, k, v, length, scale=scale, softcap=softcap)


merge_partials = _dec.merge_partials


# -- ssd ----------------------------------------------------------------------


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Model layout: xdt (B,S,H,P); dA (B,S,H); Bc, Cc (B,S,N).  Returns
    y (B,S,H,P), the SSD recurrence's outputs.

    The kernel reads the (B,H,S,P) views as the reference's (B,H,nc,Q,P)
    chunk layout, ``Q = min(chunk, S)``, and masks a ragged last chunk
    itself: the result is the reference's on the zero-padded inputs."""
    if regions.traced(xdt):
        return regions.ssd_scan(xdt, dA, Bc, Cc, chunk=chunk)
    Q = min(chunk, xdt.shape[1])
    y = _ssd.ssd_scan(xdt.transpose(1, 2), dA.transpose(1, 2), Bc, Cc, chunk=Q)
    return y.transpose(1, 2)


# -- rglru --------------------------------------------------------------------


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *, bs: int = 256, bd: int = 512) -> torch.Tensor:
    """a, b (B,S,D): ``h_t = a_t h_{t-1} + b_t``; returns h (B,S,D).  ``bs``
    and ``bd``, the reference's block sizes, are accepted and not used: the
    kernel has its own blocks and masks ragged S and D itself."""
    if regions.traced(a):
        return regions.rglru_scan(a, b)
    return _rg.rglru_scan(a, b)
