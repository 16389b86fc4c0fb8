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
(``ref.ssd_scan_ref``, the recurrence one position at a time).

Gradients.  Where autograd needs them (grad enabled, an input that requires
grad), the call goes through ``SsdScan``, a ``torch.autograd.Function``: its
forward is the same launch, which keeps its output and its scratch (C Bᵀ, the
states entering each chunk, the chunks' decays), and its backward is S3
(``csrc/ssd_scan_bwd.cu``: ``BWD_STAGES``, six launches from three chunks on,
one count of ``bwd_launches`` a call) on the card and the plain backward
(``ref.ssd_scan_bwd_ref``) on the CPU.  S3 takes K5's scratch as the forward
left it; its own (``bwd_scratch_shapes``, in ``BWD_SCRATCH_DTYPES``) comes
from ``torch.empty``.  S3 sums the heads before its products with B and C,
which the heads share: the (B, nc, QP, QP) ``w`` holds that sum, laid out as
C Bᵀ.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

MAX_STATE = 128         # N: ssd_chunk_state keeps 8 warps of 16 state rows (checked there)
TILE = 64               # rows and columns of the kernels' tiles

#: the card's kernels, in launch order
STAGES = ("ssd_chunk_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")

#: kernels a call launches on the card when it spans three chunks or more
CUDA_LAUNCHES_PER_CALL = len(STAGES)

#: the backward's kernels (S3), in launch order; a call of one chunk skips
#: the first two, of two chunks the second
BWD_STAGES = ("ssd_chunk_state", "ssd_bwd_state_pass", "ssd_bwd_dx", "ssd_bwd_w", "ssd_bwd_dbc",
              "ssd_bwd_ddA")

#: calls of ``ssd_scan`` that reached the card (one a call, whatever the stages)
launches = 0
#: calls of the backward that reached the card (one a call)
bwd_launches = 0

_SYMBOL = "launch_ssd_scan_f32"
_BWD_SYMBOL = "launch_ssd_scan_bwd_f32"
_launchers: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: each launcher's source and argument types
_BINDINGS = {
    _SYMBOL: ("ssd_scan.cu", [_P] * 8 + [_I] * 6 + [_P] * 3),
    _BWD_SYMBOL: ("ssd_scan_bwd.cu", [_P] * 17 + [_I] * 6 + [_P] * 3),
}


def _launcher(symbol: str = _SYMBOL):
    if symbol not in _launchers:
        source, argtypes = _BINDINGS[symbol]
        lib = _build.load_library(*_build.csrc_source(source))
        _launchers[symbol] = _build.bind(lib, symbol, argtypes)
    return _launchers[symbol]


def scratch_shapes(B: int, H: int, S: int, P: int, N: int, Q: int) -> dict:
    """float32 scratch of one call: C Bᵀ (B, nc, QP, QP) with QP = Q rounded
    up to the tile; the states (B, H, nc, N, PS) with PS = P rounded up to 4,
    and the decays (B, H, nc), both only where there are two chunks or more."""
    nc = -(-S // Q)
    QP, PS = -(-Q // TILE) * TILE, -(-P // 4) * 4
    return {"cb": (B, nc, QP, QP),
            "states": (B, H, nc, N, PS) if nc > 1 else (0,),
            "decays": (B, H, nc) if nc > 1 else (0,)}


#: the dtype of each tensor of ``bwd_scratch_shapes``
BWD_SCRATCH_DTYPES = {"gst": torch.float32, "w": torch.float32, "cum": torch.float64,
                      "r": torch.float64}


def bwd_scratch_shapes(B: int, H: int, S: int, P: int, N: int, Q: int) -> dict:
    """Scratch of the backward beside the forward's: the states' gradients
    (B, H, nc, N, PS), only where there are two chunks or more; W, the heads'
    weighted dy xᵀ summed, (B, nc, QP, QP) as C Bᵀ; each chunk's cumulative
    decay logs (B, H, nc, QP); and dy·y − dx·x per position, one partial per
    64 columns of P, (B, H, nP, S)."""
    nc = -(-S // Q)
    QP, nP = -(-Q // TILE) * TILE, -(-P // TILE)
    return {"gst": scratch_shapes(B, H, S, P, N, Q)["states"], "w": (B, nc, QP, QP),
            "cum": (B, H, nc, QP), "r": (B, H, nP, S)}


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dA, Bc, Cc)):
        return SsdScan.apply(x, dA, Bc, Cc, chunk)
    return _forward(x, dA, Bc, Cc, chunk)[0]


def _forward(x, dA, Bc, Cc, chunk: int):
    """(y, the card's scratch as the kernels left it: cb, states, decays; none
    on the CPU)."""
    if x.device.type != "cuda":
        y, _ = ssd_scan_ref(x.transpose(1, 2), dA.transpose(1, 2), Bc, Cc)
        return y.transpose(1, 2), ()
    _check_card(x, dA, Bc, Cc)
    B, H, S, P = x.shape
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device).transpose(1, 2)
    scratch = tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                    for shape in scratch_shapes(B, H, S, P, Bc.shape[-1], chunk).values())
    _launch(x, dA, Bc, Cc, y, *scratch, chunk)
    return y, scratch


def _check_card(x, dA, Bc, Cc, *more) -> None:
    """What the card's kernels take: float32 on one device, N up to
    ``MAX_STATE``, the last dim of x, B and C contiguous."""
    every = (x, dA, Bc, Cc, *more)
    if not all(t.dtype == torch.float32 for t in every):
        raise TypeError("ssd_scan takes float32, got " + ", ".join(str(t.dtype) for t in every))
    if Bc.shape[-1] > MAX_STATE:
        raise ValueError(f"ssd_scan: state size {Bc.shape[-1]} above {MAX_STATE}")
    if not all(t.device == x.device for t in every):
        raise ValueError("ssd_scan: operands on different devices")
    if any(t.stride(-1) != 1 for t in (x, Bc, Cc)):
        raise ValueError("ssd_scan: the last dim of x, B and C must be contiguous")


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


def ssd_scan_bwd(x, dA, Bc, Cc, y, dy, scratch, *, chunk: int):
    """The gradients (dx, ddA, dB, dC) of ``ssd_scan``'s inputs, in their
    shapes, from dy (B,H,S,P).  ``y`` and ``scratch`` are what ``_forward``
    returned for the same inputs and chunk.  S3 on the card, the plain
    backward on the CPU."""
    if x.device.type != "cuda":
        dx, ddA, dB, dC = ssd_scan_bwd_ref(x.transpose(1, 2), dA.transpose(1, 2), Bc, Cc,
                                           dy.transpose(1, 2))
        return dx.transpose(1, 2), ddA.transpose(1, 2), dB, dC
    _check_card(x, dA, Bc, Cc, dy)
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    B, H, S, P = x.shape
    N = Bc.shape[-1]
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device).transpose(1, 2)
    ddA = torch.empty((B, S, H), dtype=dA.dtype, device=x.device).transpose(1, 2)
    dB, dC = (torch.empty((B, S, N), dtype=torch.float32, device=x.device) for _ in range(2))
    own = [torch.empty(shape, dtype=BWD_SCRATCH_DTYPES[name], device=x.device)
           for name, shape in bwd_scratch_shapes(B, H, S, P, N, chunk).items()]
    _launch_bwd(x, dA, Bc, Cc, y, dy, scratch, (dx, ddA, dB, dC), own, chunk)
    return dx, ddA, dB, dC


def _launch_bwd(x, dA, Bc, Cc, y, dy, scratch, grads, own, chunk: int) -> None:
    """One call of S3 into ``grads`` (dx, ddA, dB, dC), with the forward's
    ``scratch`` (cb, states, decays) and its own (gst, w, cum, r) as given."""
    B, H, S, P = x.shape
    dx, ddA, dB, dC = grads
    cb, states, decays = scratch
    strides = (ctypes.c_longlong * 22)(*x.stride()[:3], *dA.stride(), *Bc.stride()[:2],
                                       *Cc.stride()[:2], *y.stride()[:3], *dy.stride()[:3],
                                       *dx.stride()[:3], *ddA.stride())
    sizes = (ctypes.c_longlong * 7)(*(t.numel() for t in (cb, states, decays, *own)))
    global bwd_launches
    rc = _build.on_device(x.device, _launcher(_BWD_SYMBOL), *(t.data_ptr() for t in (
        x, dA, Bc, Cc, y, dy, cb, states, decays, dx, ddA, dB, dC, *own)),
        B, H, S, P, Bc.shape[-1], chunk, strides, sizes)
    _build.check_launch(rc, _BWD_SYMBOL)
    bwd_launches += 1


class SsdScan(torch.autograd.Function):
    """K5 with its gradient: the forward keeps its inputs, its output and the
    card's scratch; the backward is ``ssd_scan_bwd`` (S3 on the card, the
    plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, x, dA, Bc, Cc, chunk):
        y, scratch = _forward(x, dA, Bc, Cc, chunk)
        ctx.save_for_backward(x, dA, Bc, Cc, y, *scratch)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dA, Bc, Cc, y, *scratch = ctx.saved_tensors
        return (*ssd_scan_bwd(x, dA, Bc, Cc, y, dy, scratch, chunk=ctx.chunk), None)
