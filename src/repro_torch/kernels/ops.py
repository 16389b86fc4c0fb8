"""Public wrappers around the hand-written kernels.

Handles padding arbitrary shapes to kernel tile multiples.  Dispatch is by
where the tensors lie: CUDA tensors launch the kernel, CPU tensors run the
kernel's plain version (``ref``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
