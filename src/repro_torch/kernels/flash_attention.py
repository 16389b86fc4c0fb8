"""Flash attention (causal / sliding-window / ``kv_len``, GQA) — kernel K3.

The Pallas kernel runs a grid (B, H, Sq/bq, Sk/bk) with the KV dim
sequential and the online-softmax state in VMEM scratch.  On the card
(``csrc/flash_attention.cu``) one block takes a tile of query rows of one
head and loops over tiles of keys; the state stays in registers.  Under a
causal mask the loop stops at the block's diagonal.  The kernel depends on
the dtype alone (``KERNEL``): bfloat16 runs ``flash_bf16_wgmma`` (both
products on the tensor cores, K/V tiles by TMA into a ring of stages, P in
registers; its one rounding beyond the Pallas body's is P to bf16 before
P·V), float32 runs ``flash_f32`` on the CUDA cores (held to 2e-5, which
TF32 could not meet).  Both read any strided layout whose head dim is
contiguous, so ``ops.mha`` hands them the model's (B,S,H,D) tensors as
(B,H,S,D) views without copying, and they mask the ragged edges
themselves: Sq and Sk need not tile, and the caller never pads.  The kernels
are built for the head dims of ``HEAD_DIMS``; any other D up to 256 that is a
multiple of 8 is zero-padded to the next of them by ``kernel_operands`` (exact:
zero columns add nothing to q·k, and V's are cut from the output, which is
then a (B,H,Sq,D) slice of the padded result), under the scale of the true D.
Rows the kernels cannot read 16 bytes at a time (a stride or an address off
16 bytes, a last dim that is not contiguous) are copied to contiguous ones
first.  Both copies cost time only for shapes no ported arch runs.  Skipping the
tiles outside a block's causal and window bounds is exact only for a row
that sees at least one key; a row that sees none (possible only under a
window, from row ``kv_len + window - 1`` on) would average V over whatever
tiles a design visits, so ``flash_attention`` refuses such inputs with a
``ValueError`` on every device.

V may have a head dim Dv other than Q's and K's D (multi-head latent
attention: D 192, Dv 128).  The bfloat16 kernel is built for the pairs of
``BF16_PAIRS`` beside its D = Dv ones and takes those exactly: any other
pair with D != Dv raises ``ValueError`` naming it, and is never padded into
a pair it is built for.  The float32 kernel, which runs only in float32
checks, takes such a pair padded to one head dim, the least of ``HEAD_DIMS``
that holds both (256 for MLA's), by the same zero columns, under the scale
of the true D, with the output cut back to Dv.

Logit soft-capping (``softcap``, a cap c > 0): each scaled score s becomes
``tanh(s / c) * c`` before the masks, and the softmax and each row's lse are
taken over the capped scores, as the reference's ``softcap`` in its plain
attention.  Both kernels are templates on a compile-time cap (``CAP``), so
the uncapped instantiations are the code they were; bfloat16 takes the tanh
of the special-function unit (``tanh.approx.f32``, relative error about
2^-11, below P's rounding to bf16), float32 an accurate ``tanhf``.  A capped
call at MLA's (192, 128), which no capped model reaches (the reference's MLA
ignores the cap), raises ``ValueError`` before any launch.

CUDA tensors launch the kernel or raise; CPU tensors take the plain version
(``ref.flash_attention_ref``).

Gradients.  Where autograd needs them (grad enabled, an input that requires
grad), the call goes through ``FlashAttention``, a ``torch.autograd.Function``:
its forward is the same launch with each row's log-sum-exp written beside the
output (``lse``), and its backward is the backward kernel S2
(``flash_attention_bwd``) on the card, the plain backward
(``ref.flash_attention_bwd_ref``) on the CPU.  ``bwd_route`` names the
backward kernels a call takes: bfloat16 runs on the tensor cores at every
head dim of the forward (MLA's (192, 128) among them; at 256 a group's query
heads are split across blocks, ``flash_attention_bwd.head_slices``), float32
(padded to one head dim where D != Dv) on the CUDA cores.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from . import flash_attention_bwd as _bwd
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
#: (D, Dv) pairs with D != Dv that the bfloat16 kernel is built for
BF16_PAIRS = ((192, 128),)

#: kernel launches made by ``flash_attention`` (a run resets it to 0, drives
#: its path, and reads it to show the path used the kernel)
launches = 0
#: the same launches by the call's shape: (B, H, KvH, Sq, Sk, D, Dv, causal,
#: softcap), the cap None where there is none
by_shape: collections.Counter = collections.Counter()

#: the kernel each dtype runs (no other is tried: a call it refuses raises)
KERNEL = {torch.float32: "flash_f32", torch.bfloat16: "flash_bf16_wgmma"}

_SYMBOL = {torch.float32: "launch_flash_attention_f32",
           torch.bfloat16: "launch_flash_attention_bf16_wgmma"}
_launchers: dict = {}


def _launcher(dtype: torch.dtype):
    if dtype not in _launchers:
        lib = _build.load_library(*_build.csrc_source("flash_attention.cu"))
        _launchers[dtype] = _build.bind(
            lib, _SYMBOL[dtype],
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    return _launchers[dtype]


def check_softcap(softcap: Optional[float], who: str) -> Optional[float]:
    """The cap as a float, or None for none; a cap must be finite and > 0."""
    if softcap is None:
        return None
    cap = float(softcap)
    if not 0.0 < cap < float("inf"):
        raise ValueError(f"{who}: softcap={softcap} must be a finite number above 0, or None")
    return cap


def kernel_head_dim(D: int, who: str) -> int:
    """The member of ``HEAD_DIMS`` a head dim D runs at: the least one >= D.
    D must be a multiple of 8, at most 256."""
    if D % 8 or not 0 < D <= HEAD_DIMS[-1]:
        raise ValueError(f"{who}: head dim {D} is not a multiple of 8 up to {HEAD_DIMS[-1]}")
    return next(d for d in HEAD_DIMS if d >= D)


def kernel_dims(D: int, Dv: int, dtype: torch.dtype,
                capped: bool = False) -> tuple[int, int]:
    """The head dims (of Q and K, of V) the kernel of ``dtype`` runs a call of
    head dims (D, Dv) at: one member of ``HEAD_DIMS`` for both where D == Dv
    or the dtype is float32; the pair itself where it is one of
    ``BF16_PAIRS`` and the call is not ``capped`` (no capped instantiation
    of a pair is built).  Any other bfloat16 pair raises ``ValueError``."""
    if D == Dv:
        return (kernel_head_dim(D, "flash_attention"),) * 2
    if dtype == torch.float32:
        return (kernel_head_dim(max(D, Dv), "flash_attention"),) * 2
    if (D, Dv) in BF16_PAIRS:
        if capped:
            raise ValueError(f"flash_attention: the bfloat16 kernel at head dims (D {D}, "
                             f"Dv {Dv}) is built without a logit cap (no capped model runs "
                             "that pair: the reference's MLA ignores the cap)")
        return D, Dv
    raise ValueError(f"flash_attention: the bfloat16 kernel is not built for head dims "
                     f"(D {D}, Dv {Dv}); its pairs with D != Dv are {BF16_PAIRS}")


#: the backward kernels of each route, in launch order (``bwd_route``);
#: ``flash_bwd_dkdv_sum`` runs only where a group's heads are split in slices
BWD_KERNELS = {"wgmma": ("flash_bwd_delta", "flash_bwd_dkdv_wgmma", "flash_bwd_dkdv_sum",
                         "flash_bwd_dq_wgmma"),
               "cuda_cores": ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")}
#: the head dims (D = Dv) the tensor-core backward is built for, beside BF16_PAIRS
BWD_WGMMA_HEAD_DIMS = (16, 32, 64, 128, 256)


def bwd_route(D: int, Dv: int, dtype: torch.dtype,
              capped: bool = False) -> tuple[str, int, int]:
    """``(route, Dk, Dvk)``: the backward kernels (a key of ``BWD_KERNELS``)
    that a call of head dims (D, Dv) in ``dtype`` takes, and the head dims
    they run it at (``kernel_dims``, whose ``ValueError`` a bfloat16 pair that
    is not built, or a ``capped`` call at one, raises).  bfloat16 takes the
    tensor cores, at the dims of ``BWD_WGMMA_HEAD_DIMS`` and ``BF16_PAIRS``;
    float32 takes the CUDA cores."""
    if dtype not in _SYMBOL:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16, got {dtype}")
    Dk, Dvk = kernel_dims(D, Dv, dtype, capped)
    if dtype == torch.bfloat16 and (Dk in BWD_WGMMA_HEAD_DIMS or (Dk, Dvk) in BF16_PAIRS):
        return "wgmma", Dk, Dvk
    return "cuda_cores", Dk, Dvk


def rows_readable(t: torch.Tensor) -> bool:
    """The kernels read rows 16 bytes at a time: the last dim contiguous,
    every other stride a whole number of 16 bytes, the data 16-byte aligned."""
    *outer, last = t.stride()
    bits = 0
    for s in outer:                         # a power of two divides each iff it divides their OR
        bits |= s
    return last == 1 and bits % (16 // t.element_size()) == 0 and t.data_ptr() % 16 == 0


def kernel_operands(Dk: int, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor as the kernels read it: its last dim zero-padded to Dk (a
    new contiguous tensor), else itself where its rows are readable, else a
    contiguous copy."""
    out = []
    for t in tensors:
        if t.shape[-1] != Dk:
            t = F.pad(t, (0, Dk - t.shape[-1]))
        elif not rows_readable(t):
            t = torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
        out.append(t)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, kv_len: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k: (B, KvH, Sk, D); v: (B, KvH, Sk, Dv) with
    H % KvH == 0.  Keys at positions >= ``kv_len`` (default Sk) are masked
    out of the softmax; every query row must see at least one key.  ``scale``
    defaults to D ** -0.5; ``softcap`` caps the scaled scores.
    Returns (B, H, Sq, Dv) in q's dtype — on the card a (B,H,Sq,Dv) view of
    a contiguous (B,Sq,H,Dv) tensor, the model's layout (of a (B,Sq,H,Dk)
    one where the head dims are padded to the kernel's Dk) — differentiable
    where autograd needs it (``FlashAttention``)."""
    B, H, Sq, D = q.shape
    _, KvH, Sk, _ = k.shape
    Dv = v.shape[-1]
    if H % KvH != 0:
        raise ValueError(f"flash_attention: H={H} must be a multiple of KvH={KvH}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if kv_len is not None and not 0 < kv_len <= Sk:
        raise ValueError(f"flash_attention: kv_len={kv_len} outside (0, {Sk}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be at least 1")
    n_keys = kv_len or Sk
    if window is not None and Sq >= n_keys + window:
        # row q sees keys (q - window, min(q, kv_len - 1)]: none once q >= kv_len + window - 1
        raise ValueError(f"flash_attention: with window={window} and kv_len={n_keys}, query "
                         f"rows {n_keys + window - 1}..{Sq - 1} see no key")
    sc = scale if scale is not None else D ** -0.5
    cap = check_softcap(softcap, "flash_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, sc, kv_len, cap)
    return _forward(q, k, v, causal, window, sc, kv_len, cap, with_lse=False)[0]


def _forward(q, k, v, causal, window, sc, kv_len, cap=None, *, with_lse: bool):
    """(out, lse or None): the plain version on the CPU, else one launch."""
    if q.device.type != "cuda":
        kw = dict(causal=causal, window=window, scale=sc, kv_len=kv_len, softcap=cap)
        if with_lse:
            return flash_attention_ref(q, k, v, return_lse=True, **kw)
        return flash_attention_ref(q, k, v, **kw), None
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SYMBOL:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: {q.device}, {k.device}, {v.device}")
    B, H, Sq, D = q.shape
    _, KvH, Sk, _ = k.shape
    Dv = v.shape[-1]
    Dk, Dvk = kernel_dims(D, Dv, q.dtype, cap is not None)
    q, k = kernel_operands(Dk, q, k)
    v, = kernel_operands(Dvk, v)
    out = torch.empty((B, Sq, H, Dvk), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse
           else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    global launches
    rc = _build.on_device(q.device, _launcher(q.dtype), q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
                          B, H, KvH, Sq, Sk, Dk, Dvk, strides, sc, int(causal), window or 0,
                          kv_len or Sk, cap or 0.0)
    _build.check_launch(rc, KERNEL[q.dtype])
    launches += 1
    by_shape[(B, H, KvH, Sq, Sk, D, Dv, bool(causal), cap)] += 1
    return out[..., :Dv], lse


class FlashAttention(torch.autograd.Function):
    """K3 with its gradient: the forward keeps q, k, v, the output and each
    row's log-sum-exp; the backward is ``flash_attention_bwd`` (S2 on the
    card, the plain backward on the CPU) under the same masks and cap."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_len, softcap=None):
        out, lse = _forward(q, k, v, causal, window, scale, kv_len, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, scale=scale, kv_len=kv_len,
                         softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd.flash_attention_bwd(q, k, v, out, lse, dout, **ctx.masks)
        return dq, dk, dv, None, None, None, None, None
