"""RG-LRU diagonal linear recurrence — kernel K6.

The Pallas kernel runs a grid (B, D/bd, S/bs) with the sequence dim
sequential, the carry in VMEM scratch, and a log2(bs)-step doubling inside a
block.  On the card (``csrc/rglru_scan.cu``) one block of 8 warps per (32
channels, lane) walks the sequence in rounds of 8 x 32 steps: each warp
composes its steps into one affine map, the maps are combined across warps
in shared memory, and each warp replays its steps from its incoming carry.
Ragged S and D are masked inside the kernel; nothing is padded.

CUDA tensors launch the kernel or raise; CPU tensors take the plain version
(``ref.rglru_scan_ref``, one step at a time).  There is no backward kernel yet: on
the card, under grad with an input that requires it, the call raises
``NotImplementedError`` before any launch (ROADMAP queue A, item 8b); the
CPU's plain version is differentiable.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rglru_scan_ref

#: kernel launches made by ``rglru_scan``
launches = 0

_SYMBOL = "launch_rglru_scan_f32"
_launchers: dict = {}


def _launcher():
    if _SYMBOL not in _launchers:
        lib = _build.load_library(*_build.csrc_source("rglru_scan.cu"))
        _launchers[_SYMBOL] = _build.bind(lib, _SYMBOL, [ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    return _launchers[_SYMBOL]


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B,S,D): ``h_t = a_t h_{t-1} + b_t`` from h = 0.  Returns h
    (B,S,D) in a's dtype."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         "must be one (B,S,D) shape")
    if a.device.type != "cuda":
        return rglru_scan_ref(a, b)[0]
    _build.refuse_grad("rglru_scan", a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan takes float32, got {a.dtype}, {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan: the channel dim of a and b must be contiguous")
    B, S, D = a.shape
    h = torch.empty((B, S, D), dtype=a.dtype, device=a.device)
    strides = (ctypes.c_longlong * 6)(*a.stride()[:2], *b.stride()[:2], *h.stride()[:2])
    global launches
    rc = _build.on_device(a.device, _launcher(), a.data_ptr(), b.data_ptr(), h.data_ptr(),
                          B, S, D, strides)
    _build.check_launch(rc, _SYMBOL)
    launches += 1
    return h
