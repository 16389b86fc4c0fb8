"""Public wrappers around the hand-written kernels.

Handles (a) padding arbitrary shapes to kernel tile multiples where a kernel
needs it (the matmul; the attention kernels mask their ragged edges
themselves), (b) layout adaptation from model conventions ((B,S,H,D)) to
kernel conventions ((B,H,S,D)), as strided views, not copies.  Dispatch is by
where the tensors lie: CUDA tensors launch the kernel, CPU tensors run the
kernel's plain version (``ref``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from . import decode_attention as _dec
from . import flash_attention as _fa
from . import matmul as _mm


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
        window: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B,S,H,D); k,v (B,S,KvH,D).  Returns (B,S,H,D).

    The kernel tiles by its own block sizes and masks keys past Sk itself, so
    nothing is padded: the true key length is the kernel's ``kv_len``."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window)
    return out.transpose(1, 2)


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B,H,D) single position; k,v (B,L,KvH,D); length: valid entries, a
    scalar or one per lane (B,)."""
    return _dec.decode_attention(q, k, v, length)


decode_partial = _dec.partial_decode_attention
merge_partials = _dec.merge_partials
