"""Mamba-2 SSD chunked scan — kernel K5.

The Pallas kernel runs a grid (B, H, nc) over a (B,H,nc,Q,P) layout with the
chunk dim sequential and the state h (N,P) in VMEM scratch.  On the card
(``csrc/ssd_scan.cu``) a call is the chunk-parallel form of the SSD
algorithm, four launches on the current stream (``CUDA_LAUNCHES_PER_CALL``;
a call of one chunk skips the second and third, of two chunks the third): C Bᵀ once for all
heads, each chunk's state increment and decay, a sequential element-wise pass
that turns the increments into the state entering each chunk, and the
outputs.  Every product runs on the tensor cores in 3xTF32 (``mma.sync``,
each operand split into two TF32 halves, three passes), which keeps float32's
accuracy where one TF32 pass misses the tolerance by two orders of magnitude
(``tests/test_torch_ssd_hopper.py`` emulates both).  The kernels read the
chunk view of any strided (B,H,S,P) tensor — position ``c*Q + q`` of chunk
``c`` — so ``ops.ssd_scan`` hands them the model's (B,S,H,P) tensors as
views, and a ragged tail (S not a multiple of Q) is masked inside them rather
than padded by a copy: the result is the reference's on the zero-padded
inputs, cut back to S.

The scratch (``scratch_shapes``) comes from ``torch.empty`` on every call,
from PyTorch's caching allocator: there is no workspace kept between calls,
and a CUDA graph that captures a call captures its own.  The launcher is
given each scratch tensor's element count and refuses (cudaErrorInvalidValue)
a call whose scratch is smaller than its own layout needs.

CUDA tensors launch the kernels or raise; CPU tensors take the plain version
(``ref.ssd_scan_ref``, the recurrence one position at a time).  There is no backward kernel yet: on
the card, under grad with an input that requires it, the call raises
``NotImplementedError`` before any launch (ROADMAP queue A, item 8b); the
CPU's plain version is differentiable.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_scan_ref

MAX_STATE = 128         # N: ssd_chunk_state keeps 8 warps of 16 state rows (checked there)
TILE = 64               # rows and columns of the kernels' tiles

#: the card's kernels, in launch order
STAGES = ("ssd_chunk_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")

#: kernels a call launches on the card when it spans three chunks or more
CUDA_LAUNCHES_PER_CALL = len(STAGES)

#: calls of ``ssd_scan`` that reached the card (one a call, whatever the stages)
launches = 0

_SYMBOL = "launch_ssd_scan_f32"
_launchers: dict = {}


def _launcher():
    if _SYMBOL not in _launchers:
        lib = _build.load_library(*_build.csrc_source("ssd_scan.cu"))
        _launchers[_SYMBOL] = _build.bind(lib, _SYMBOL, [ctypes.c_void_p] * 8
                                          + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    return _launchers[_SYMBOL]


def scratch_shapes(B: int, H: int, S: int, P: int, N: int, Q: int) -> dict:
    """float32 scratch of one call: C Bᵀ (B, nc, QP, QP) with QP = Q rounded
    up to the tile; the states (B, H, nc, N, PS) with PS = P rounded up to 4,
    and the decays (B, H, nc), both only where there are two chunks or more."""
    nc = -(-S // Q)
    QP, PS = -(-Q // TILE) * TILE, -(-P // 4) * 4
    return {"cb": (B, nc, QP, QP),
            "states": (B, H, nc, N, PS) if nc > 1 else (0,),
            "decays": (B, H, nc) if nc > 1 else (0,)}


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
    _build.refuse_grad("ssd_scan", x, dA, Bc, Cc)
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
    cb, states, decays = (torch.empty(shape, dtype=torch.float32, device=x.device)
                          for shape in scratch_shapes(B, H, S, P, N, chunk).values())
    _launch(x, dA, Bc, Cc, y, cb, states, decays, chunk)
    return y


def _launch(x, dA, Bc, Cc, y, cb, states, decays, chunk: int) -> None:
    """One call of the card's kernels into ``y`` with the scratch given."""
    B, H, S, P = x.shape
    strides = (ctypes.c_longlong * 13)(*x.stride()[:3], *dA.stride(), *Bc.stride()[:2],
                                       *Cc.stride()[:2], *y.stride()[:3])
    sizes = (ctypes.c_longlong * 3)(cb.numel(), states.numel(), decays.numel())
    global launches
    rc = _build.on_device(x.device, _launcher(), x.data_ptr(), dA.data_ptr(), Bc.data_ptr(),
                          Cc.data_ptr(), y.data_ptr(), cb.data_ptr(), states.data_ptr(),
                          decays.data_ptr(), B, H, S, P, Bc.shape[-1], chunk, strides, sizes)
    _build.check_launch(rc, _SYMBOL)
    launches += 1
