"""RG-LRU diagonal linear recurrence — kernel K6.

The Pallas kernel runs a grid (B, D/bd, S/bs) with the sequence dim
sequential, the carry in VMEM scratch, and a log2(bs)-step doubling inside a
block.  On the card (``csrc/rglru_scan.cu``) one block of 8 warps per (32
channels, lane) walks the sequence in rounds of 8 x 32 steps: each warp
composes its steps into one affine map, the maps are combined across warps
in shared memory, and each warp replays its steps from its incoming carry.
Ragged S and D are masked inside the kernel; nothing is padded.

CUDA tensors launch the kernel or raise; CPU tensors take the plain version
(``ref.rglru_scan_ref``, one step at a time).

Gradients.  Where autograd needs them (grad enabled, an input that requires
grad), the call goes through ``RglruScan``, a ``torch.autograd.Function``: its
forward is the same launch and keeps a and h; its backward is S4
(``rglru_bwd_kernel`` in the same source: the recurrence of the gradient
from the end of the sequence in (segment of ``BWD_SEGMENT`` steps, lane, 32
channels) tiles, which a persistent grid claims in order from a counter,
each segment's starting value found by a decoupled look-back over the
segments after it through a workspace the wrapper allocates; counted by
``bwd_launches``) on the card and the plain backward
(``ref.rglru_scan_bwd_ref``) on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

#: kernel launches made by ``rglru_scan``
launches = 0
#: launches of the backward kernel
bwd_launches = 0

#: steps a warp takes in one tile of S4, and a tile's steps (a segment of
#: the sequence; ``csrc/rglru_scan.cu``'s ``BWD_STEPS`` and ``BWD_SEG``)
BWD_STEPS = 16
BWD_SEGMENT = 8 * BWD_STEPS

_SYMBOL = "launch_rglru_scan_f32"
_BWD_SYMBOL = "launch_rglru_scan_bwd_f32"
_WORK_SYMBOL = "rglru_scan_bwd_workspace_bytes"
_launchers: dict = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each launcher's argument types
_ARGTYPES = {
    _SYMBOL: [_P] * 3 + [_I] * 3 + [_P] * 2,
    _BWD_SYMBOL: [_P] * 5 + [_I] * 3 + [_P] * 2 + [_L, _P],
    _WORK_SYMBOL: [_I] * 3,
}


def _launcher(symbol: str = _SYMBOL):
    if symbol not in _launchers:
        lib = _build.load_library(*_build.csrc_source("rglru_scan.cu"))
        _launchers[symbol] = _build.bind(lib, symbol, _ARGTYPES[symbol])
        if symbol == _WORK_SYMBOL:
            _launchers[symbol].restype = _L
    return _launchers[symbol]


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B,S,D): ``h_t = a_t h_{t-1} + b_t`` from h = 0.  Returns h
    (B,S,D) in a's dtype."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         "must be one (B,S,D) shape")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RglruScan.apply(a, b)
    return _forward(a, b)


def _check_card(*tensors) -> None:
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("rglru_scan takes float32, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if not all(t.device == tensors[0].device for t in tensors):
        raise ValueError("rglru_scan: operands on different devices: "
                         + ", ".join(str(t.device) for t in tensors))
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("rglru_scan: the channel dim of every operand must be contiguous")


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type != "cuda":
        return rglru_scan_ref(a, b)[0]
    _check_card(a, b)
    B, S, D = a.shape
    h = torch.empty((B, S, D), dtype=a.dtype, device=a.device)
    strides = (ctypes.c_longlong * 6)(*a.stride()[:2], *b.stride()[:2], *h.stride()[:2])
    global launches
    rc = _build.on_device(a.device, _launcher(), a.data_ptr(), b.data_ptr(), h.data_ptr(),
                          B, S, D, strides)
    _build.check_launch(rc, _SYMBOL)
    launches += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The gradients (da, db) of ``rglru_scan``'s inputs from dh (B,S,D),
    given a and the forward's output h.  S4 on the card, the plain backward
    on the CPU."""
    if a.device.type != "cuda":
        return rglru_scan_bwd_ref(a, h, dh)
    if dh.stride(-1) != 1:
        dh = dh.contiguous()
    _check_card(a, h, dh)
    B, S, D = a.shape
    da, db = (torch.empty((B, S, D), dtype=a.dtype, device=a.device) for _ in range(2))
    strides = (ctypes.c_longlong * 10)(*(s for t in (a, h, dh, da, db) for s in t.stride()[:2]))
    nbytes = _launcher(_WORK_SYMBOL)(B, S, D)
    work = torch.empty(nbytes, dtype=torch.uint8, device=a.device)
    global bwd_launches
    rc = _build.on_device(a.device, _launcher(_BWD_SYMBOL), a.data_ptr(), h.data_ptr(),
                          dh.data_ptr(), da.data_ptr(), db.data_ptr(), B, S, D, strides,
                          work.data_ptr(), nbytes)
    _build.check_launch(rc, _BWD_SYMBOL)
    bwd_launches += 1
    return da, db


class RglruScan(torch.autograd.Function):
    """K6 with its gradient: the forward keeps a and h; the backward is
    ``rglru_scan_bwd`` (S4 on the card, the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dh)
