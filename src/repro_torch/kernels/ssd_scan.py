"""Mamba-2 SSD chunked scan — kernel K5.

The Pallas kernel runs a grid (B, H, nc) over a (B,H,nc,Q,P) layout with the
chunk dim sequential and the state h (N,P) in VMEM scratch.  On the card
(``csrc/ssd_scan.cu``) one block per (tile of 64 columns of P, head, lane)
loops over the chunks with h in shared memory, cuts each chunk in tiles of 64
positions and never holds the (Q,Q) score matrix whole.  The kernel reads the
chunk view of any strided (B,H,S,P) tensor — position ``c*Q + q`` of chunk
``c`` — so ``ops.ssd_scan`` hands it the model's (B,S,H,P) tensors as views,
and a ragged tail (S not a multiple of Q) is masked inside the kernel rather
than padded by a copy: the result is the reference's on the zero-padded
inputs, cut back to S.

CUDA tensors launch the kernel or raise; CPU tensors take the plain version
(``ref.ssd_scan_ref``, the recurrence one position at a time).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_scan_ref

MAX_STATE = 128         # N: the kernel keeps 8 state rows per thread row (checked there)

#: kernel launches made by ``ssd_scan``
launches = 0

_SYMBOL = "launch_ssd_scan_f32"
_launchers: dict = {}


def _launcher():
    if _SYMBOL not in _launchers:
        lib = _build.load_library(*_build.csrc_source("ssd_scan.cu"))
        _launchers[_SYMBOL] = _build.bind(lib, _SYMBOL, [ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    return _launchers[_SYMBOL]


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, *,
             chunk: int) -> torch.Tensor:
    """x (B,H,S,P) dt-weighted inputs; dA (B,H,S) decay logs; Bc, Cc (B,S,N),
    shared by the heads; the positions cut in chunks of ``chunk``.  Returns
    y (B,H,S,P) in x's dtype — on the card a (B,H,S,P) view of a contiguous
    (B,S,H,P) tensor, the model's layout."""
    B, H, S, P = x.shape
    N = Bc.shape[-1]
    if dA.shape != (B, H, S) or Bc.shape != (B, S, N) or Cc.shape != Bc.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dA {tuple(dA.shape)}, "
                         f"B {tuple(Bc.shape)}, C {tuple(Cc.shape)} do not match")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk={chunk} must be at least 1")
    if x.device.type != "cuda":
        y, _ = ssd_scan_ref(x.transpose(1, 2), dA.transpose(1, 2), Bc, Cc)
        return y.transpose(1, 2)
    if not all(t.dtype == torch.float32 for t in (x, dA, Bc, Cc)):
        raise TypeError(f"ssd_scan takes float32, got {x.dtype}, {dA.dtype}, "
                        f"{Bc.dtype}, {Cc.dtype}")
    if N > MAX_STATE:
        raise ValueError(f"ssd_scan: state size {N} above {MAX_STATE}")
    if not all(t.device == x.device for t in (dA, Bc, Cc)):
        raise ValueError("ssd_scan: operands on different devices")
    if any(t.stride(-1) != 1 for t in (x, Bc, Cc)):
        raise ValueError("ssd_scan: the last dim of x, B and C must be contiguous")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 13)(*x.stride()[:3], *dA.stride(), *Bc.stride()[:2],
                                       *Cc.stride()[:2], *y.stride()[:3])
    global launches
    rc = _build.on_device(x.device, _launcher(), x.data_ptr(), dA.data_ptr(), Bc.data_ptr(),
                          Cc.data_ptr(), y.data_ptr(), B, H, S, P, N, chunk, strides)
    _build.check_launch(rc, _SYMBOL)
    launches += 1
    return y
